"""The deployment meshes, and the card's peak rates.

A mesh is a plain ordered dict of axis sizes, which the dry run prices;
``device_mesh`` makes the ``DeviceMesh`` over an initialized process group
that the sharded train step runs on, its dim names the dict's keys in
order; ``fake_device_mesh`` makes one over a fake process group of the
whole mesh's size in this one process (the dry run).  The shapes are the
JAX package's production meshes, so the two packages' dry runs describe
the same deployments.
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def fake_device_mesh(mesh: dict, device="cuda"):
    """The ``DeviceMesh`` of ``mesh`` over a fake process group of
    ``mesh_devices(mesh)`` ranks, this process being rank 0: its
    collectives complete at once and move nothing, so one process runs
    rank 0's share of a sharded program (on meta tensors: no storage) and
    sees every collective it would issue.  ``device`` is the mesh's device
    type, which picks DTensor's collectives: "cuda" (the default, the card's
    deployment: a shard moved to another dim is one all-to-all) or "cpu"
    (gloo's: an all-gather and a local chunk), as the real group would.
    Raises where a process group is already initialized (a real group is
    never replaced); the fake one is destroyed on leaving.

    DTensor picks an op's placements by a cost model that prices a mesh
    dim spanning more devices than a host holds as slower: for "cuda" the
    mesh is priced as on hosts of ``DEVICES_PER_HOST`` cards, not by the
    cards this process sees (none where the dry run runs)."""
    import torch
    import torch.distributed as dist
    from torch.distributed import device_mesh as dm
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_device_mesh: a process group is already initialized")
    env = getattr(dm, "_mesh_resources", None)
    hosted = (torch.device(device).type == "cuda"
              and hasattr(env, "num_devices_per_host"))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh_devices(mesh))
    if hosted:
        env.num_devices_per_host = lambda _type: DEVICES_PER_HOST
    try:
        yield device_mesh(mesh, torch.device(device).type)
    finally:
        if hosted:
            del env.num_devices_per_host
        dist.destroy_process_group()


# Peak rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at a power
# limit of 700 W): the roofline prices a step with these.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, tensor cores
PEAK_FLOPS_TF32 = 495e12        # FLOP/s, tensor cores
PEAK_FLOPS_F32 = 67e12          # FLOP/s, CUDA cores
HBM_BW = 3.35e12                # bytes/s, HBM3
# The cards a host of the deployment holds (an H100 SXM HGX board: 8), as
# DTensor's cost model reads it on a fake mesh (``fake_device_mesh``).
DEVICES_PER_HOST = 8
# NVLink 4 between H100 SXM cards (the same data sheet): 900 GB/s both
# ways, 450e9 bytes/s a direction, which the roofline's collective term
# divides a card's collective bytes by.  chip_mesh.py prints the bus
# bandwidth it measures beside it.
ICI_BW = 450e9
