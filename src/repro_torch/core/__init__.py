"""The paper's (P, S)-sparse codes and the device path of the coded matmul.

Exports what the JAX package's core package exports -- the degree
distributions, the encoder (tasks, chunking, ``encode_blocks``), the
hybrid peeling/rooting decoder, the matching probability and the LP
design -- resolved lazily (PEP 562), so importing the package loads
nothing.  The device path's modules (``coded_matmul`` and its backends)
are imported by name.
"""

_EXPORTS = {
    "repro_torch.core.degree": (
        "wave_soliton", "robust_soliton", "ideal_soliton",
        "optimized_distribution", "sample_degrees", "average_degree"),
    "repro_torch.core.encoder": (
        "SparseCodeSpec", "CodedTask", "generate_coefficient_matrix",
        "make_tasks", "encode_blocks", "block_col", "col_block",
        "chunk_slices", "chunk_expand"),
    "repro_torch.core.decoder": (
        "DecodeStats", "IncrementalRankTracker", "peel_schedule",
        "hybrid_decode", "gaussian_decode", "apply_schedule"),
    "repro_torch.core.matching": ("perfect_matching_prob", "degree_evolution"),
    "repro_torch.core.lp_design": ("optimize_degree_distribution",),
}

_HOMES = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = list(_HOMES)


def __getattr__(name):
    if name in _HOMES:
        import importlib

        return getattr(importlib.import_module(_HOMES[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
