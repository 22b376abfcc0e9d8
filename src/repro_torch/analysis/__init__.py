"""Static checks of the port: its coded schemes and its staged programs.

* ``repro_torch.analysis.schemes`` -- generator-matrix math over the
  port's registry, plans and packs: recovery thresholds vs the paper's
  bounds, degree/weight sanity, chunk-expand exactness, decode
  conditioning, tile-pack consistency (``run_scheme_checks``,
  ``validate_scheme``, ``validate_pack``);
* ``repro_torch.analysis.contracts`` -- the structural contracts of the
  staged coded matmul (nnz-proportional staging, the decode in the
  kernel's epilogue, the worker sum -- or, in a rank of a worker group,
  one collective over that group --, f32 only, a byte budget) on programs
  captured with a ``TorchDispatchMode`` (``run_contract_checks``);
* ``repro_torch.analysis.findings`` -- the ``Finding``/``Report`` model.

``python -m repro_torch.analysis`` runs both layers.  The JAX package's
lint rules are about JAX and have no counterpart here.
"""

from repro_torch.analysis.findings import ERROR, WARNING, Finding, Report

__all__ = ["ERROR", "WARNING", "Finding", "Report"]
