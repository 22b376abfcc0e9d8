"""The benchmark of the PyTorch and CUDA port (``repro_torch``): the coded
sparse product on H100 cards, driven by ``BENCHMARK.json`` and the files
of this folder.  ``python3 portbench/run.py --help`` runs one cell.

Importing the package sets the CUDA allocator's expandable segments for
the process, unless its environment sets an allocator already: the
staging stacks 28 outputs of 1 GiB into one block, which the caching
allocator's fixed segments cannot find once set-up has split them."""

import os

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
