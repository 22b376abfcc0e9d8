"""repro_torch: the coded sparse matmul on PyTorch and CUDA (NVIDIA Hopper).

The port of ``repro`` (JAX on a TPU), module for module.  It imports
neither jax nor anything under ``repro``: what it needs of the JAX
package's numpy modules it keeps in its own copy.

The main path is plan -> bind -> apply::

    from repro_torch import CodedMatmulConfig, plan

    cfg = CodedMatmulConfig(scheme="sparse_code", backend="block_sparse")
    op = plan(cfg, m=2, n=2, num_workers=8, seed=0).bind()   # the CUDA card
    C = op(A, B, a_sparse=ell)

``bind()`` with no argument binds the CUDA card and raises where there is
none; ``bind("cpu")`` runs the same path through the kernels' plain
PyTorch versions.

``run_device_job(A, B, plan, device=None, backend=...)`` times that apply
(warm-up outside, CUDA events per repeat) and returns an
``ExecutionReport``.  The paper's master/worker straggler runtime --
``run_coded_job``, ``run_live_job`` and ``JobMux`` in
``repro_torch.runtime``, decoding with the hybrid peeling/rooting decoder
of ``repro_torch.core.decoder`` -- follows the same device rule: ``None``
is the card, ``"cpu"`` must be asked for.

Exports resolve lazily (PEP 562), so importing the package loads nothing
until a name is touched.
"""

__all__ = [
    "CodedMatmulConfig",
    "CodedOp",
    "from_plan",
    "get_scheme",
    "plan",
    "run_device_job",
    "scheme_names",
]

_HOMES = {
    "CodedMatmulConfig": "repro_torch.coded.config",
    "CodedOp": "repro_torch.coded.op",
    "from_plan": "repro_torch.coded.op",
    "plan": "repro_torch.coded.op",
    "run_device_job": "repro_torch.runtime.executor",
    "get_scheme": "repro_torch.coded.registry",
    "scheme_names": "repro_torch.coded.registry",
}


def __getattr__(name):
    if name in _HOMES:
        import importlib

        return getattr(importlib.import_module(_HOMES[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
