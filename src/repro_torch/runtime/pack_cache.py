"""LRU caches for worker tile packs: host packs and their device copies.

``pack_worker_tiles`` is pure in its two inputs, both reused heavily: a loop
packs the same BlockELL against the same plan on every step, and survivor
rebinds (``plan.with_survivors``) never change the pack.  The cache key is
the identity of the objects (``id(ell), id(plan)``): BlockELL holds mutable
ndarrays, so value-hashing would be slow and unsound under in-place
mutation.  Keying on identity is safe because each entry pins strong
references to its keyed objects, so a live key id is never recycled.

The device copy of a pack (``DeviceTilePack``: vals, src, wslot, slot_of,
tile_scale) is cached the same way, keyed on (pack, device, worker set),
so a pack crosses to the card once and not on every apply; a rank of a
worker group copies only its own worker's tiles.  Entries pin device
memory until evicted or ``clear()``-ed.

The consumer is ``repro_torch.coded.CodedOp`` (``op.pack_for`` and
``op.apply``), keyed on the op's BASE plan so survivor rebinds share packs.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from repro_torch.core.coded_matmul import (
    CodedMatmulPlan,
    DeviceTilePack,
    WorkerTilePack,
    pack_worker_tiles,
)
from repro_torch.sparse.blocksparse import BlockELL

_MAX_ENTRIES = 16


class PackCache:
    """Identity-keyed LRUs of (BlockELL, plan, compute_dtype) -> pack and
    (pack, device, workers) -> device pack."""

    def __init__(self, max_entries: int = _MAX_ENTRIES):
        self.max_entries = max_entries
        # key -> (pinned key objects..., value)
        self._packs: OrderedDict[tuple, tuple] = OrderedDict()
        self._device: OrderedDict[tuple, tuple] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _lookup(self, table: OrderedDict, key: tuple, pinned: tuple, make):
        hit = table.get(key)
        if hit is not None:
            table.move_to_end(key)
            self.hits += 1
            return hit[-1]
        value = make()
        table[key] = (*pinned, value)
        if len(table) > self.max_entries:
            table.popitem(last=False)
            self.evictions += 1
        self.misses += 1
        return value

    def get_pack(self, ell: BlockELL, plan: CodedMatmulPlan,
                 compute_dtype: str = "float32") -> WorkerTilePack:
        """The pack for (ell, plan), computed at most once while both are
        alive.  compute_dtype is part of the key: an f32 pack and an int8
        pack of the same operands are different artifacts."""
        return self._lookup(
            self._packs, (id(ell), id(plan), compute_dtype), (ell, plan),
            lambda: pack_worker_tiles(ell, plan, compute_dtype=compute_dtype))

    def device_pack(self, pack: WorkerTilePack, device: torch.device,
                    workers=None) -> DeviceTilePack:
        """``pack`` on ``device`` (only the tiles of ``workers``, a sequence
        of worker ids, where given), copied at most once while pack is
        alive."""
        workers = None if workers is None else tuple(int(k) for k in workers)
        return self._lookup(
            self._device, (id(pack), str(device), workers), (pack,),
            lambda: DeviceTilePack.from_pack(pack, device, workers))

    def stats(self) -> dict:
        return {"entries": len(self._packs), "device_entries": len(self._device),
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}

    def clear(self) -> None:
        self._packs.clear()
        self._device.clear()
        self.hits = 0
        self.misses = 0
        self.evictions = 0


#: the process-wide cache every ``CodedOp`` shares
GLOBAL = PackCache()


def get_pack(ell: BlockELL, plan: CodedMatmulPlan,
             compute_dtype: str = "float32") -> WorkerTilePack:
    return GLOBAL.get_pack(ell, plan, compute_dtype=compute_dtype)


def device_pack(pack: WorkerTilePack, device: torch.device,
                workers=None) -> DeviceTilePack:
    return GLOBAL.device_pack(pack, device, workers)


def cache_stats() -> dict:
    return GLOBAL.stats()


def clear() -> None:
    GLOBAL.clear()
