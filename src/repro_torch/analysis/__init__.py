"""Static checks of the port's coded schemes.

* ``repro_torch.analysis.schemes`` -- generator-matrix math over the
  port's registry, plans and packs: recovery thresholds vs the paper's
  bounds, degree/weight sanity, chunk-expand exactness, decode
  conditioning, tile-pack consistency (``run_scheme_checks``,
  ``validate_scheme``, ``validate_pack``);
* ``repro_torch.analysis.findings`` -- the ``Finding``/``Report`` model.

The JAX package's lint and jaxpr passes check JAX programs and have no
counterpart here.
"""

from repro_torch.analysis.findings import ERROR, WARNING, Finding, Report

__all__ = ["ERROR", "WARNING", "Finding", "Report"]
