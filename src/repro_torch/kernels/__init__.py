"""The port's kernels: hand-written CUDA for Hopper, each with its plain
PyTorch version.  Submodules are imported by name; this file loads nothing."""
