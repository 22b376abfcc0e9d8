"""Carry a plan and a tile pack across from plain arrays.

In this system the "weights" are the host plan and the tile pack.  These
two functions build the port's objects from the numpy fields of the JAX
package's ``CodedMatmulPlan`` and ``WorkerTilePack`` (or of any plan and
pack written to an ``.npz``), so both packages can run on the very same
plan and pack.  Only plain arrays cross: nothing of the JAX package is
imported.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.coded.registry import CodeDesign
from repro_torch.core.coded_matmul import CodedMatmulPlan, WorkerTilePack

PLAN_FIELDS = ("cols", "weights", "decode", "max_degree", "m", "n",
               "num_workers")
PACK_FIELDS = ("vals", "src", "wslot", "block_size", "live_tiles")


def _require(fields: dict, names: tuple[str, ...], what: str) -> None:
    missing = [f for f in names if f not in fields]
    if missing:
        raise ValueError(f"{what} fields missing: {missing}")


def plan_from_numpy(fields: dict) -> CodedMatmulPlan:
    """The port's plan from ``cols`` (N, L) int32, ``weights`` (N, L) f32,
    ``decode`` (mn, N) f32, ``max_degree``, ``m``, ``n``, ``num_workers``
    (and, optionally, the provenance ``scheme`` and ``seed``)."""
    _require(fields, PLAN_FIELDS, "plan")
    m, n, N = int(fields["m"]), int(fields["n"]), int(fields["num_workers"])
    cols = np.array(fields["cols"], dtype=np.int32)
    weights = np.array(fields["weights"], dtype=np.float32)
    decode = np.array(fields["decode"], dtype=np.float32)
    if cols.shape != weights.shape or cols.shape[0] != N:
        raise ValueError(
            f"cols {cols.shape} / weights {weights.shape} do not match "
            f"{N} workers")
    if decode.shape != (m * n, N):
        raise ValueError(f"decode {decode.shape} != (mn, N) = {(m * n, N)}")
    design = CodeDesign(m=m, n=n, num_workers=N,
                        scheme=str(fields.get("scheme", "")),
                        seed=int(fields.get("seed", 0)))
    return CodedMatmulPlan(spec=design, cols=cols, weights=weights,
                           decode=decode, max_degree=int(fields["max_degree"]))


def pack_from_numpy(fields: dict) -> WorkerTilePack:
    """The port's tile pack from ``vals``, ``src``, ``wslot``,
    ``block_size``, ``live_tiles`` and, where present, ``slot_of``,
    ``compute_dtype`` and ``tile_scale``.

    numpy has no bfloat16, so a bf16 pack's ``vals`` come as float32 (the
    exact upcast) with ``compute_dtype="bfloat16"``; they are rounded back
    and must survive that unchanged.
    """
    _require(fields, PACK_FIELDS, "pack")
    compute_dtype = str(fields.get("compute_dtype", "float32"))
    vals = torch.from_numpy(np.array(fields["vals"]))
    if compute_dtype == "bfloat16":
        rounded = vals.to(torch.bfloat16)
        if not torch.equal(rounded.to(vals.dtype), vals):
            raise ValueError("bfloat16 pack vals are not bfloat16 values")
        vals = rounded
    elif compute_dtype == "int8" and vals.dtype != torch.int8:
        raise ValueError(f"int8 pack vals have dtype {vals.dtype}")
    elif compute_dtype == "float32" and vals.dtype != torch.float32:
        raise ValueError(f"float32 pack vals have dtype {vals.dtype}")
    slot_of = fields.get("slot_of")
    tile_scale = fields.get("tile_scale")
    return WorkerTilePack(
        vals=vals,
        src=np.array(fields["src"], dtype=np.int32),
        wslot=np.array(fields["wslot"], dtype=np.float32),
        block_size=int(fields["block_size"]),
        live_tiles=np.array(fields["live_tiles"], dtype=np.int64),
        slot_of=None if slot_of is None else np.array(slot_of, dtype=np.int32),
        compute_dtype=compute_dtype,
        tile_scale=(None if tile_scale is None
                    else np.array(tile_scale, dtype=np.float32)))
