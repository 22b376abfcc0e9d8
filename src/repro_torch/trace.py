"""Named spans of the coded apply and the rebind, on the profiler's timeline.

Run an op under ``torch.profiler`` and its host work appears as
``user_annotation`` events, on the same clock as the card's kernels and
copies, nested in this order::

    coded.rebind             CodedOp.with_survivors, whole
      coded.decode_matrix      the survivors' decode matrix (the plan's
                               with_survivors / with_chunk_progress)
    coded.apply              CodedOp.apply, whole
      coded.pack_for           the pack cache's lookup, or the pack's build
      coded.resolve_pack       the pack's checks against the operands
      coded.device_pack        the pack's device copy (cached, or made)
      coded.stage              stage_coded_matmul, whole
        coded.decode_weights     the survivor mask, the decode matrix and
                                 the tiles' weights, on the device
        coded.worker             one a worker: its host work and launch
          kernel.check_indices     the pack's index range check: one
                                   reduction and one wait for the card
          kernel.slot_order        the launch's slot sort
        coded.combine            the sum over workers into C, or the
                                 group's collective

For example::

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        C = op.with_survivors(mask).apply(A, B, a_sparse=ell)
    print(prof.key_averages().table(sort_by="cpu_time_total"))

The ``kernel.*`` spans come from the CUDA wrappers (``kernels/spmm_block``),
so the CPU lane has none of them inside ``coded.worker``.  The count of
``kernel.check_indices`` is the count of the apply's host synchronisations.

With no profiler recording, ``span`` hands back one shared null context:
the cost is one attribute read.  A span makes no copy, allocation or
synchronisation of its own, and changes no result.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

REBIND = "coded.rebind"
DECODE_MATRIX = "coded.decode_matrix"
APPLY = "coded.apply"
PACK_FOR = "coded.pack_for"
RESOLVE_PACK = "coded.resolve_pack"
DEVICE_PACK = "coded.device_pack"
STAGE = "coded.stage"
DECODE_WEIGHTS = "coded.decode_weights"
WORKER = "coded.worker"
CHECK_INDICES = "kernel.check_indices"
SLOT_ORDER = "kernel.slot_order"
COMBINE = "coded.combine"

_OFF = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler records, else a null
    context."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF
