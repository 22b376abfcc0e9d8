"""repro_torch.coded: the public entry point for the coded matmul.

* **scheme registry** (``register_scheme`` / ``get_scheme`` /
  ``scheme_names``) -- every code design by name;
* **CodedMatmulConfig** -- frozen execution config, validated once;
* **CodedOp** (``plan`` / ``from_plan`` -> ``bind`` -> apply) -- backend
  dispatch, BlockELL packing, the pack cache, and survivor rebinding;
* **convert** -- ``plan_from_numpy`` / ``pack_from_numpy``: a plan and a
  pack carried across from plain arrays.

Quick tour::

    from repro_torch.coded import CodedMatmulConfig, plan

    cfg = CodedMatmulConfig(scheme="sparse_code", backend="block_sparse")
    op = plan(cfg, m=2, n=2, num_workers=8).bind()   # the CUDA card
    C = op(A, B, a_sparse=ell)                       # all workers
    C = op.with_survivors(mask)(A, B, a_sparse=ell)  # straggler rebind

Exports resolve lazily (PEP 562).
"""

__all__ = [
    "CodeDesign",
    "CodedMatmulConfig",
    "CodedOp",
    "Scheme",
    "from_plan",
    "get_scheme",
    "pack_from_numpy",
    "plan",
    "plan_from_numpy",
    "register_scheme",
    "scheme_names",
]

_HOMES = {
    "CodedMatmulConfig": "repro_torch.coded.config",
    "CodeDesign": "repro_torch.coded.registry",
    "Scheme": "repro_torch.coded.registry",
    "get_scheme": "repro_torch.coded.registry",
    "register_scheme": "repro_torch.coded.registry",
    "scheme_names": "repro_torch.coded.registry",
    "CodedOp": "repro_torch.coded.op",
    "plan": "repro_torch.coded.op",
    "from_plan": "repro_torch.coded.op",
    "plan_from_numpy": "repro_torch.coded.convert",
    "pack_from_numpy": "repro_torch.coded.convert",
}


def __getattr__(name):
    if name in _HOMES:
        import importlib

        return getattr(importlib.import_module(_HOMES[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
