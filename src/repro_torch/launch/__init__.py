"""repro_torch.launch: the training driver (``python -m
repro_torch.launch.train``).  The mesh, the dry run and the report wait
for ROADMAP queue 1, item 8."""
