"""The paper's (P, S)-sparse codes and the device path of the coded matmul.

Submodules are imported by name (``repro_torch.core.coded_matmul`` and so
on); this package file loads nothing.
"""
