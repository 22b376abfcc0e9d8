"""repro_torch.launch: the training driver (``python -m
repro_torch.launch.train``, sharded on a device mesh with ``--nproc``),
the meshes (``mesh``: axis-size dicts and their ``DeviceMesh``;
``meshctx``: the active mesh and the placements the model code asks
for), the dry run on meta tensors (``dryrun``), the roofline
(``roofline``) and its report (``report``)."""
