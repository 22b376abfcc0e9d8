"""The deployment meshes, and the card's peak rates.

A mesh is a plain ordered dict of axis sizes, which the dry run prices;
``device_mesh`` makes the ``DeviceMesh`` over an initialized process group
that the sharded train step runs on, its dim names the dict's keys in
order.  The shapes are the JAX package's production meshes, so the two
packages' dry runs describe the same deployments.
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


def device_mesh(mesh: dict, device):
    """The ``DeviceMesh`` of ``mesh`` (axis sizes in order) over the
    initialized default process group, on ``device``'s type.  Raises
    where no group is initialized or its world size is not the product of
    the sizes."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("device_mesh needs an initialized process group "
                           "(runtime.workergroup.init_worker_group)")
    if dist.get_world_size() != mesh_devices(mesh):
        raise ValueError(f"mesh {mesh} needs {mesh_devices(mesh)} ranks, the group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(torch.device(device).type, tuple(mesh.values()),
                            mesh_dim_names=tuple(mesh))


# Peak rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at a power
# limit of 700 W): the roofline prices a step with these.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, tensor cores
PEAK_FLOPS_TF32 = 495e12        # FLOP/s, tensor cores
PEAK_FLOPS_F32 = 67e12          # FLOP/s, CUDA cores
HBM_BW = 3.35e12                # bytes/s, HBM3
# The bandwidth between cards is not priced yet: the roofline's collective
# term is absent (ROADMAP queue 1, item 8b; chip_mesh.py measures the bus
# bandwidth for it).
ICI_BW = None
