"""repro_torch.launch: the training driver (``python -m
repro_torch.launch.train``), and the launch tooling that needs no process
group: the meshes as axis-size dicts (``mesh``, ``meshctx``), the dry run
on meta tensors (``dryrun``), the roofline (``roofline``) and its report
(``report``).  A mesh over ``torch.distributed`` waits for ROADMAP queue 1,
item 8b."""
