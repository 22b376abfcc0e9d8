"""The worker axis as a ``torch.distributed`` process group: one worker a process.

The JAX package runs one coded worker per device of a mesh axis
(``compat.make_mesh`` and ``shard_map`` over ``axis_name``) and combines
their decode contributions with one collective over that axis.  Here the
axis is a process group: ``spawn_group`` starts ``world_size`` rank
processes, each joins the group (``init_worker_group``) and runs a
function, and ``stage_coded_matmul(..., group=...)`` runs one worker a rank
(``repro_torch.core.coded_matmul``).

Backends, named by the caller:

* ``"gloo"`` -- on the CPU, or with every rank on one card: CUDA tensors
  cross through host memory, so several ranks can share one GPU;
* ``"nccl"`` -- one card a rank (rank k on ``cuda:k``): refused where
  there are fewer cards than ranks, before any group is made.

Ranks are forked from ``procpool``'s fork server (``procpool._context``),
which imported torch once and never opened a device, so no rank inherits
a CUDA context.  Each rank sets its device before it makes a tensor.

Large operands reach the ranks once, through one file in shared memory
(``SharedArrays``, under ``/dev/shm``) that every rank maps; only its
name and layout cross the pipes.  A rank's function returns plain data
(numpy arrays, numbers): a torch tensor would travel as a handle to its
sender's memory.

A launch has one wall limit, which is also the group's timeout: past it
the launcher kills every rank, waits for them, and raises.  No rank
outlives its launch.  ``group_of_one`` makes the calling process the one
rank of a group of its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import socket
import tempfile
import time
import traceback
from multiprocessing import connection as mp_connection

import numpy as np
import torch

from repro_torch.core.blocks import resolve_device

BACKENDS = ("gloo", "nccl")

#: where ``SharedArrays`` puts its file: a tmpfs every rank can map
SHM_DIR = "/dev/shm"

#: operand offsets in the shared file are multiples of this many bytes
_ALIGN = 64

#: after a rank fails, how long the launcher still reads the others' reports
_FAILURE_GRACE_S = 2.0


def rank_device(rank: int, world_size: int, backend: str, device=None) -> torch.device:
    """The device rank ``rank`` of a ``world_size`` group computes on.

    gloo: ``device`` for every rank (None = the CUDA card, raising where
    there is none; ``"cpu"`` for the tests).  nccl: ``cuda:rank``, and only
    where there are at least ``world_size`` cards."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "gloo":
        return resolve_device(device)
    if device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"nccl runs on CUDA devices only, not {device}: use backend='gloo'")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < world_size:
        raise RuntimeError(
            f"nccl needs one CUDA device a rank: {world_size} ranks, {cards} device(s); "
            "use backend='gloo' to share one card (or the CPU) between the ranks")
    return torch.device("cuda", rank)


def init_worker_group(rank: int, world_size: int, *, backend: str, init_method: str,
                      device=None, timeout: float = 300.0) -> torch.device:
    """Join this process to the worker group as ``rank`` and return its device.

    The device is set (``torch.cuda.set_device``) before the group is made;
    a CPU rank computes on one thread, since the ranks share the host's
    cores.  ``timeout`` (seconds) bounds every collective of the group."""
    import torch.distributed as dist

    dev = rank_device(rank, world_size, backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    return dev


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world_size, backend, init_method, device, timeout, args, mesh,
               conn):
    """A rank's process: join the group, run ``fn(device, *args)`` (or
    ``fn(device, device_mesh, *args)`` with a ``mesh``), send ``("ok", rank,
    result)`` or ``("error", rank, traceback)``."""
    import torch.distributed as dist

    try:
        dev = init_worker_group(rank, world_size, backend=backend, init_method=init_method,
                                device=device, timeout=timeout)
        if mesh is not None:
            from repro_torch.launch.mesh import device_mesh
            args = (device_mesh(mesh, dev),) + tuple(args)
        out = fn(dev, *args)
        dist.barrier()  # rank 0 holds the group's store: nobody leaves early
        dist.destroy_process_group()
        conn.send(("ok", rank, out))
    except Exception:  # reported to the launcher, which fails the launch
        conn.send(("error", rank, traceback.format_exc()))
    finally:
        conn.close()


@contextlib.contextmanager
def group_of_one(*, backend: str, device=None, mesh: dict | None = None):
    """This process as the one rank of a group of its own: a world of one
    needs no rank process.  Yields its device, and its ``DeviceMesh`` with
    ``mesh`` (every axis of size 1; else None).  The group is destroyed on
    leaving the block."""
    import torch.distributed as dist

    dev = init_worker_group(0, 1, backend=backend, device=device,
                            init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        if mesh is None:
            yield dev, None
        else:
            from repro_torch.launch.mesh import device_mesh
            yield dev, device_mesh(mesh, dev)
    finally:
        dist.destroy_process_group()


def _reap(procs, grace: float = 5.0) -> None:
    """Kill every rank still running and wait until each has ended."""
    for p in procs:
        if p.is_alive():
            p.kill()
    deadline = time.monotonic() + grace
    for p in procs:
        p.join(timeout=max(0.1, deadline - time.monotonic()))
    alive = [p.name for p in procs if p.is_alive()]
    if alive:  # pragma: no cover - a SIGKILLed process always ends
        raise RuntimeError(f"ranks still running after SIGKILL: {alive}")


def spawn_group(fn, world_size: int, *, backend: str, device=None, timeout: float = 300.0,
                args: tuple = (), mesh: dict | None = None) -> list:
    """Run ``fn(device, *args)`` in ``world_size`` ranks of one process group
    and return their results in rank order.  With ``mesh`` (axis sizes
    whose product is ``world_size``, ``launch.mesh``), each rank gets its
    group's ``DeviceMesh`` too: ``fn(device, device_mesh, *args)``.

    ``fn`` is a module-level function (it is pickled by name).  ``device``
    is as in ``rank_device``; it is resolved here first, so a launch with
    no card to run on raises before any process starts.  ``timeout``
    (seconds) is the launch's wall limit, start-up included, and the
    group's timeout: past it, or as soon as a rank fails or dies, every
    rank is killed and this raises (``TimeoutError``, ``RuntimeError``)."""
    from repro_torch.runtime.procpool import _context

    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if mesh is not None and math.prod(mesh.values()) != world_size:
        raise ValueError(f"mesh {mesh} does not have {world_size} devices")
    dev = rank_device(0, world_size, backend, device)
    ctx = _context()
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    procs, conns = [], {}
    deadline = time.monotonic() + timeout
    try:
        for rank in range(world_size):
            recv_end, send_end = ctx.Pipe(duplex=False)
            proc = ctx.Process(
                target=_rank_main,
                args=(fn, rank, world_size, backend, init_method,
                      None if backend == "nccl" else str(dev), timeout, args, mesh,
                      send_end),
                daemon=True, name=f"group-rank-{rank}")
            proc.start()
            send_end.close()  # keep only the child's copy: EOF tracks its end
            procs.append(proc)
            conns[recv_end] = rank
        results, failures = {}, {}
        while conns:
            left = deadline - time.monotonic()
            if failures:  # the others' reports, briefly: a peer's error may follow
                left = min(left, failed_at + _FAILURE_GRACE_S - time.monotonic())
                if left <= 0:
                    break
            elif left <= 0:
                raise TimeoutError(
                    f"worker group of {world_size} ({backend}) passed its {timeout} s wall "
                    f"limit; ranks {sorted(conns.values())} had not finished")
            for conn in mp_connection.wait(list(conns), timeout=left):
                rank = conns.pop(conn)
                try:
                    status, _, payload = conn.recv()
                except EOFError:
                    procs[rank].join(1.0)
                    status, payload = "error", (f"ended without a result (exit code "
                                                f"{procs[rank].exitcode})")
                finally:
                    conn.close()
                if status == "ok":
                    results[rank] = payload
                else:
                    if not failures:
                        failed_at = time.monotonic()
                    failures[rank] = payload
        if failures:
            raise RuntimeError("\n".join(f"rank {rank} failed:\n{failures[rank]}"
                                         for rank in sorted(failures)))
        for p in procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
        return [results[r] for r in range(world_size)]
    finally:
        for conn in conns:
            conn.close()
        _reap(procs)


# ------------------------- operands in shared memory --------------------------

@dataclasses.dataclass(frozen=True)
class SharedArrays:
    """Named host arrays in one file under ``SHM_DIR``, mapped by every rank.

    ``create`` writes the inputs and zero-fills the outputs; the object
    (its path and layout, no data) is what crosses to the ranks, and
    ``open`` maps the file there as CPU tensors that view it, so a rank
    reads its operands without a copy and writes an output in place.
    ``close`` unlinks the file; the memory goes when the last mapping
    does.  Use it as a context manager in the launcher."""

    path: str
    #: name -> (dtype name, shape, byte offset)
    layout: dict
    nbytes: int

    @classmethod
    def create(cls, inputs: dict, outputs: dict | None = None) -> "SharedArrays":
        """``inputs``: name -> numpy array or CPU tensor; ``outputs``: name ->
        (shape, torch dtype), zero-filled."""
        tensors = {name: (torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray)
                          else a.detach().contiguous()) for name, a in inputs.items()}
        entries = {name: (t.dtype, tuple(t.shape)) for name, t in tensors.items()}
        for name, (shape, dtype) in (outputs or {}).items():
            entries[name] = (dtype, tuple(shape))
        layout, offset = {}, 0
        for name, (dtype, shape) in entries.items():
            layout[name] = (str(dtype).removeprefix("torch."), shape, offset)
            size = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            offset += -(-size // _ALIGN) * _ALIGN
        fd, path = tempfile.mkstemp(prefix="repro_torch-group-", suffix=".bin", dir=SHM_DIR)
        try:
            os.ftruncate(fd, max(offset, 1))
        finally:
            os.close(fd)
        shared = cls(path=path, layout=layout, nbytes=max(offset, 1))
        try:
            views = shared.open()
            for name, t in tensors.items():
                views[name].copy_(t)
        except BaseException:
            shared.close()
            raise
        return shared

    def open(self) -> dict[str, torch.Tensor]:
        """Every entry as a CPU tensor over the mapped file."""
        buf = torch.from_file(self.path, shared=True, size=self.nbytes, dtype=torch.uint8)
        out = {}
        for name, (dtype, shape, offset) in self.layout.items():
            dt = getattr(torch, dtype)
            size = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            out[name] = buf[offset:offset + size].view(dt).view(shape)
        return out

    def close(self) -> None:
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass

    def __enter__(self) -> "SharedArrays":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
