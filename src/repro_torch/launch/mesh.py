"""The deployment meshes the dry run prices, and the card's peak rates.

A mesh is a plain ordered dict of axis sizes; no process group stands
behind it (the port's meshes over ``torch.distributed`` are ROADMAP queue
1, item 8b).  The shapes are the JAX package's production meshes, so the
two packages' dry runs describe the same deployments.
"""

from __future__ import annotations

import math


def make_production_mesh(*, multi_pod: bool = False) -> dict:
    """The target deployment mesh.

    single pod: {"data": 16, "model": 16}, 256 devices;
    multi pod: {"pod": 2, "data": 16, "model": 16}, 512 devices, where
    "pod" is pure data parallelism across pods, which is also the
    granularity of the coded fault-tolerance story (decode a step from K
    of N pods).
    """
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_mesh_for_devices(n: int, model_parallel: int | None = None) -> dict:
    """Elastic variant: whatever devices survive, keep the model axis fixed
    and shrink the data axis."""
    tp = model_parallel or min(16, n)
    if n % tp:
        raise ValueError(f"{n} devices not divisible by model_parallel={tp}")
    return {"data": n // tp, "model": tp}


def mesh_devices(mesh: dict) -> int:
    return math.prod(mesh.values())


# Peak rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at a power
# limit of 700 W): the roofline prices a step with these.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, tensor cores
PEAK_FLOPS_TF32 = 495e12        # FLOP/s, tensor cores
PEAK_FLOPS_F32 = 67e12          # FLOP/s, CUDA cores
HBM_BW = 3.35e12                # bytes/s, HBM3
# The bandwidth between cards has no value until the port has a mesh over
# a process group (ROADMAP queue 1, item 8b): the roofline's collective
# term is absent, not priced.
ICI_BW = None
