"""Coded distributed matmul on one CUDA device: plans, packs and staging.

The public entry point is ``repro_torch.coded`` (scheme registry +
``CodedMatmulConfig`` + ``CodedOp`` plan->bind->apply); this module holds
the machinery it runs -- ``CodedMatmulPlan``/``make_plan``, tile packing,
the backend local-product factories, and ``stage_coded_matmul`` -- and the
deprecated flat-argument ``coded_matmul`` over the same staging.

The paper's master/worker protocol, with every worker on one card:

* worker k  = row k of the coefficient matrix M (sampled on the host);
* local compute = sum_{l} w_kl * A_{i_l}^T B_{j_l}, via a pluggable backend
  (registered in ``repro_torch.core.coded_backends``);
* decode    = blocks = D @ C~ with D = pinv(M) precomputed on the host.
  Decoding a full-rank linear code is linear, so each worker's decode
  column rides in its local product's epilogue and a sum over the workers
  finishes the product.

The JAX package runs one worker per mesh device and sums with a psum
(or a psum_scatter for ``out_sharded``).  Here the N workers run one after
the other on one device and their (mn, br, bt) contributions are summed in
worker order; both decode layouts are then the same sum and give the same C.

Local-compute backends:

* ``"dense_scan"``   -- a loop of dense block products over the (padded)
  task slots: exactly ``max_degree`` products per worker, whatever the
  sparsity.
* ``"block_sparse"`` -- A is packed on the host into per-worker
  fused-gather tiles (``pack_worker_tiles``: tile values + the address of
  the B tile each multiplies + per-slot weights) and the local product is
  one launch of the fused SpMM kernel (``kernels.ops``), which reads its B
  tiles straight out of the untouched (s, t) B.  Compute and traffic scale
  with the number of LIVE tiles.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import scipy.sparse as sp
import torch

from repro_torch.core import coded_backends
from repro_torch.core.decoder import DecodingError, decode_matrix
from repro_torch.core.encoder import (
    SparseCodeSpec,
    chunk_slices,
    generate_coefficient_matrix,
)
from repro_torch.kernels import ops
from repro_torch.sparse.blocksparse import BlockELL, dense_to_block_ell


def chunk_mask_progress(mask: np.ndarray, num_workers: int) -> np.ndarray:
    """(N, q) per-chunk completion mask -> (N,) completed-prefix counts.

    Sub-task streams are ordered, so only prefix-form rows (all True then
    all False) describe a physical state; a True after a False means the
    caller skipped a chunk and is rejected rather than silently reread.
    """
    mask = np.asarray(mask, dtype=bool)
    if mask.ndim != 2:
        raise ValueError(f"chunk mask must be 2-D (N, q), got shape {mask.shape}")
    if mask.shape[0] != num_workers:
        raise ValueError(
            f"chunk mask has {mask.shape[0]} rows for {num_workers} workers")
    progress = mask.sum(axis=1)
    prefix = np.take_along_axis(
        np.cumsum(mask, axis=1),
        np.maximum(progress[:, None] - 1, 0), axis=1).reshape(-1)
    bad = np.flatnonzero((progress > 0) & (prefix != progress))
    if bad.size:
        raise ValueError(
            f"chunk mask rows {bad.tolist()} are not prefix-form: ordered "
            "sub-task streams complete chunk c only after chunks 0..c-1")
    return progress.astype(np.int64)


@dataclasses.dataclass(frozen=True)
class CodedMatmulPlan:
    """Host-side static plan: tasks + decode matrix, ready to stage."""

    spec: SparseCodeSpec
    cols: np.ndarray      # (N, Lmax) int32 block ids, padded with 0
    weights: np.ndarray   # (N, Lmax) f32, padded with 0.0
    decode: np.ndarray    # (mn, N) f32: D s.t. blocks = D @ C~
    max_degree: int

    @property
    def m(self) -> int:
        return self.spec.m

    @property
    def n(self) -> int:
        return self.spec.n

    @property
    def num_workers(self) -> int:
        return self.spec.num_workers

    def coefficient_matrix(self) -> np.ndarray:
        """Dense M (N, mn) reconstructed from the padded task table.

        Padded slots carry weight 0.0 and contribute nothing (they land on
        block id 0 but add zero).
        """
        M = np.zeros((self.num_workers, self.m * self.n), dtype=np.float64)
        rows = np.repeat(np.arange(self.num_workers), self.cols.shape[1])
        np.add.at(M, (rows, self.cols.reshape(-1).astype(np.int64)),
                  self.weights.reshape(-1).astype(np.float64))
        return M

    def with_survivors(self, survivors: np.ndarray) -> "CodedMatmulPlan":
        """Re-derive the decode matrix using only surviving workers' rows.

        survivors: boolean mask (N,) -- worker liveness -- or (N, q) -- the
        per-chunk completion mask of the chunked protocol, dispatched to
        ``with_chunk_progress``.  Requires the surviving submatrix to be
        full column rank; raises ``DecodingError`` (a ValueError subclass)
        otherwise.
        """
        survivors = np.asarray(survivors, dtype=bool)
        if survivors.ndim == 2:
            return self.with_chunk_progress(
                chunk_mask_progress(survivors, self.num_workers),
                survivors.shape[1])
        survivors = survivors.reshape(-1)
        if survivors.shape[0] != self.num_workers:
            raise ValueError(
                f"survivors mask has {survivors.shape[0]} entries for "
                f"{self.num_workers} workers")
        if survivors.all():
            return self
        d = self.m * self.n
        M_surv = self.coefficient_matrix() * survivors[:, None]
        rank = int(np.linalg.matrix_rank(M_surv))
        if rank < d:
            raise DecodingError(
                f"only {int(survivors.sum())}/{self.num_workers} survivors: "
                f"surviving coefficient rows have rank {rank} < {d} -- cannot "
                "decode; any full-column-rank subset would do (Theorem 2)")
        D = np.linalg.pinv(M_surv)
        return dataclasses.replace(self, decode=D.astype(np.float32))

    def with_chunk_progress(
        self, progress: np.ndarray, num_chunks: int
    ) -> "CodedMatmulPlan":
        """Partial-straggler rebind: keep each worker's completed slot prefix.

        Chunk boundaries follow ``chunk_slices`` over each worker's actual
        degree (its live slots occupy a prefix of the padded table).
        ``progress[k]`` = chunks worker k completed; slots beyond its
        completed prefix get weight 0, and the decode matrix is the
        pseudo-inverse of the prefix-truncated coefficient matrix.  Raises
        ``DecodingError`` when the completed prefixes lose column rank.
        Tile packs stay valid: the block_sparse local product re-reads
        weights from the staged plan.
        """
        progress = np.asarray(progress, dtype=np.int64).reshape(-1)
        if progress.shape[0] != self.num_workers:
            raise ValueError(
                f"progress has {progress.shape[0]} entries for "
                f"{self.num_workers} workers")
        if progress.min() < 0 or progress.max() > num_chunks:
            raise ValueError(
                f"progress must lie in [0, {num_chunks}], got {progress}")
        if (progress == num_chunks).all():
            return self
        L = self.cols.shape[1]
        degrees = np.count_nonzero(self.weights, axis=1)
        keep = np.zeros((self.num_workers, L), dtype=bool)
        for k, (deg, p) in enumerate(zip(degrees, progress)):
            if p > 0:
                keep[k, :chunk_slices(int(deg), num_chunks)[p - 1].stop] = True
        weights = np.where(keep, self.weights, 0.0).astype(np.float32)
        masked = dataclasses.replace(self, weights=weights)
        d = self.m * self.n
        M_eff = masked.coefficient_matrix()
        rank = int(np.linalg.matrix_rank(M_eff))
        if rank < d:
            raise DecodingError(
                f"completed chunk prefixes (progress={progress.tolist()}, "
                f"q={num_chunks}) have rank {rank} < {d} -- cannot decode; "
                "more chunks must finish")
        D = np.linalg.pinv(M_eff)
        return dataclasses.replace(masked, decode=D.astype(np.float32))


def make_plan(
    m: int,
    n: int,
    num_workers: int,
    distribution: str = "wave_soliton",
    weight_kind: str = "symmetric",
    max_degree: int | None = None,
    seed: int = 0,
    max_resample: int = 50,
) -> CodedMatmulPlan:
    """Sample a (P,S)-sparse code and build the plan.

    The degree distribution is truncated at max_degree (every worker pays
    for the max anyway); resamples until M is full rank (Theorem 2:
    succeeds immediately w.h.p.).
    """
    d = m * n
    max_degree = max_degree or max(1, min(d, int(np.ceil(2 * np.log(max(d, 2)) + 1))))
    for attempt in range(max_resample):
        spec = SparseCodeSpec(m=m, n=n, num_workers=num_workers,
                              distribution=distribution,
                              weight_kind=weight_kind, seed=seed + attempt)
        M = generate_coefficient_matrix(spec)
        # truncate: rows with degree > max_degree keep their first max_degree
        cols = np.zeros((num_workers, max_degree), dtype=np.int32)
        weights = np.zeros((num_workers, max_degree), dtype=np.float32)
        Mt = sp.lil_matrix((num_workers, d))
        for k in range(num_workers):
            lo, hi = M.indptr[k], M.indptr[k + 1]
            take = min(hi - lo, max_degree)
            cs = M.indices[lo:lo + take]
            ws = M.data[lo:lo + take]
            cols[k, :take] = cs
            weights[k, :take] = ws
            Mt[k, cs] = ws
        Mt = Mt.tocsr()
        if np.linalg.matrix_rank(Mt.toarray()) >= d:
            D = decode_matrix(Mt).astype(np.float32)
            return CodedMatmulPlan(spec=spec, cols=cols, weights=weights,
                                   decode=D, max_degree=max_degree)
    raise RuntimeError(f"no full-rank coefficient matrix after {max_resample} tries")


# ------------------------------ tile packing --------------------------------

@dataclasses.dataclass(frozen=True)
class WorkerTilePack:
    """Per-worker fused-gather tiles of the sparse operand (host side).

      vals : (N, br/bs, Lw, bs, bs)  live tiles, zero-padded to Lw slots --
             a CPU torch tensor (numpy has no bfloat16)
      src  : (N, br/bs, Lw, 2) int32 [row-block of B in s/bs, column group
             j in n]
      wslot: (N, br/bs, Lw) f32      the slot's code weight w_kl (0 on pads)
      slot_of: (N, br/bs, Lw) int32  originating task slot l of each tile
             (0 on pads -- gate on wslot != 0)

    The pack depends only on the BASE task table, never on the decode
    matrix or the staged weights, so one pack serves every survivor mask:
    the local product gathers the *staged plan's* weight for each tile
    through ``slot_of``.

    Quantized coded compute: with ``compute_dtype`` "bfloat16" the tile
    values are stored rounded to bf16 (the kernels upcast to f32); with
    "int8" each tile is symmetric-quantized with its own scale
    ``amax(|tile|)/127`` recorded in ``tile_scale`` and folded into the
    per-tile weight at staging time.
    """

    vals: torch.Tensor
    src: np.ndarray
    wslot: np.ndarray
    block_size: int
    live_tiles: np.ndarray  # (N,) total live tiles per worker (cost proxy)
    slot_of: np.ndarray | None = None
    compute_dtype: str = "float32"
    #: (N, CBl, Lw) f32 per-tile dequant scale; None unless compute_dtype
    #: is "int8"
    tile_scale: np.ndarray | None = None


QUANT_EPS = coded_backends.QUANT_EPS


def pack_worker_tiles(a_sparse: BlockELL, plan: CodedMatmulPlan,
                      compute_dtype: str = "float32") -> WorkerTilePack:
    """Re-stripe A's global block-ELL into per-worker fused-gather tiles.

    Vectorized (bucketed NumPy, no Python loop over N x L x CB): entries
    are laid out slot-major (l ascending, then the BlockELL tile order
    within the slot).  ``compute_dtype`` quantizes the packed tile values;
    coding weights and addresses stay exact f32/int32.
    """
    if compute_dtype not in QUANT_EPS:
        raise ValueError(
            f"compute_dtype {compute_dtype!r} not in {sorted(QUANT_EPS)}")
    s, r = a_sparse.shape
    bs = a_sparse.block_size
    m, n = plan.m, plan.n
    if r % m:
        raise ValueError(f"A cols {r} not divisible by m={m}")
    br = r // m
    if br % bs or s % bs:
        raise ValueError(
            f"block partition ({br} x {s}) not divisible by block_size {bs}")
    CBl = br // bs            # column blocks per worker output row-block
    N, L = plan.cols.shape

    live_slot = plan.weights != 0.0                     # (N, L)
    i_blk = (plan.cols // n).astype(np.int64)           # (N, L) source A column group
    j_blk = (plan.cols % n).astype(np.int32)            # (N, L) source B column group
    # global BlockELL stripe feeding (k, l, cb):  g = i * CBl + cb
    g = i_blk[:, :, None] * CBl + np.arange(CBl)[None, None, :]   # (N, L, CBl)
    cnt = np.where(live_slot[:, :, None], a_sparse.nnzb[g], 0)    # (N, L, CBl)
    per_kcb = cnt.transpose(0, 2, 1)                    # (N, CBl, L)
    Lw = max(1, int(per_kcb.sum(axis=-1).max(initial=0)))
    # destination slot of each stripe's first tile: exclusive cumsum over l
    off = np.cumsum(per_kcb, axis=-1) - per_kcb         # (N, CBl, L)

    E = a_sparse.slots
    valid = np.arange(E)[None, None, None, :] < per_kcb[..., None]  # (N,CBl,L,E)
    kk, cc, ll, ee = np.nonzero(valid)
    gg = g[kk, ll, cc]
    dst = off[kk, cc, ll] + ee

    vals = np.zeros((N, CBl, Lw, bs, bs), dtype=np.float32)
    src = np.zeros((N, CBl, Lw, 2), dtype=np.int32)
    wslot = np.zeros((N, CBl, Lw), dtype=np.float32)
    slot_of = np.zeros((N, CBl, Lw), dtype=np.int32)
    vals[kk, cc, dst] = a_sparse.vals[gg, ee]
    src[kk, cc, dst, 0] = a_sparse.idx[gg, ee]
    src[kk, cc, dst, 1] = j_blk[kk, ll]
    wslot[kk, cc, dst] = plan.weights[kk, ll]
    slot_of[kk, cc, dst] = ll
    live = per_kcb.sum(axis=(1, 2)).astype(np.int64)

    tile_scale = None
    vals_t = torch.from_numpy(vals)
    if compute_dtype == "bfloat16":
        vals_t = vals_t.to(torch.bfloat16)   # round to nearest even
    elif compute_dtype == "int8":
        amax = np.abs(vals).max(axis=(-2, -1))              # (N, CBl, Lw)
        tile_scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        vals_t = torch.from_numpy(
            np.rint(vals / tile_scale[..., None, None]).astype(np.int8))
    return WorkerTilePack(vals=vals_t, src=src, wslot=wslot, block_size=bs,
                          live_tiles=live, slot_of=slot_of,
                          compute_dtype=compute_dtype, tile_scale=tile_scale)


@dataclasses.dataclass(frozen=True)
class DeviceTilePack:
    """A ``WorkerTilePack``'s arrays on one device: what the kernels read.

    Made once per (pack, device) (``repro_torch.runtime.pack_cache``), the
    eager counterpart of the JAX package capturing the pack as constants
    of the staged program.
    """

    vals: torch.Tensor                 # (N, CBl, Lw, bs, bs)
    src: torch.Tensor                  # (N, CBl, Lw, 2) int32
    wslot: torch.Tensor                # (N, CBl, Lw) f32
    slot_of: torch.Tensor              # (N, CBl, Lw) int64
    tile_scale: torch.Tensor | None    # (N, CBl, Lw) f32, int8 packs only
    block_size: int

    @classmethod
    def from_pack(cls, pack: WorkerTilePack,
                  device: torch.device) -> "DeviceTilePack":
        if pack.slot_of is None:
            # a pack without the tile->slot map cannot follow a chunk-masked
            # plan's weights; its baked-in base weights would be silently
            # wrong under with_chunk_progress, so refuse outright
            raise ValueError(
                "WorkerTilePack has no slot_of map; rebuild it with "
                "pack_worker_tiles")

        def put(a, dtype=None):
            return torch.as_tensor(a, dtype=dtype).to(device).contiguous()

        return cls(vals=put(pack.vals), src=put(pack.src),
                   wslot=put(pack.wslot),
                   slot_of=put(pack.slot_of, torch.int64),
                   tile_scale=(None if pack.tile_scale is None
                               else put(pack.tile_scale)),
                   block_size=pack.block_size)


def _host_f32(A) -> np.ndarray:
    if isinstance(A, torch.Tensor):
        return A.detach().to("cpu", torch.float32).numpy()
    return np.asarray(A, dtype=np.float32)


def resolve_pack(
    A,
    plan: CodedMatmulPlan,
    *,
    pack: WorkerTilePack | None = None,
    a_sparse: BlockELL | None = None,
    block_size: int = 8,
    compute_dtype: str = "float32",
    num_workers: int,
    s: int,
    r: int,
    br: int,
) -> WorkerTilePack:
    """Obtain-and-validate the worker tile pack for the block_sparse backend.

    Accepts a prebuilt ``pack``, an ``a_sparse`` host BlockELL of A (packed
    here), or A itself (packed with ``block_size``).  The result is always
    validated against the operand geometry, including its
    ``compute_dtype``: a pack built against other operands would gather
    out of range.
    """
    n = plan.n
    if pack is None:
        ell = a_sparse if a_sparse is not None else dense_to_block_ell(
            _host_f32(A), block_size=block_size)
        if ell.shape != (s, r):
            raise ValueError(f"a_sparse shape {ell.shape} != A shape {(s, r)}")
        pack = pack_worker_tiles(ell, plan, compute_dtype=compute_dtype)
    if pack.compute_dtype != compute_dtype:
        raise ValueError(
            f"pack was quantized as {pack.compute_dtype!r} but the config "
            f"asks for compute_dtype={compute_dtype!r}; rebuild the pack")
    if pack.vals.shape[0] != num_workers:
        raise ValueError(
            f"pack built for {pack.vals.shape[0]} workers, plan has {num_workers}")
    bs_p = pack.block_size
    if s % bs_p or pack.vals.shape[1] * bs_p != br:
        raise ValueError(
            f"pack (block_size={bs_p}, {pack.vals.shape[1]} column "
            f"blocks) does not tile operands with s={s}, br={br}")
    if int(pack.src[..., 0].max(initial=0)) >= s // bs_p:
        raise ValueError(
            f"pack row-block indices exceed s//bs={s // bs_p}: the pack "
            "was built for a different A")
    if int(pack.src[..., 1].max(initial=0)) >= n:
        raise ValueError(
            f"pack column-group indices exceed n={n}: the pack was "
            "built for a different plan")
    return pack


# ------------------------- local-compute backends ---------------------------

def _local_dense_scan(A: torch.Tensor, B: torch.Tensor, cols_k: np.ndarray,
                      w_k: np.ndarray, m: int, n: int) -> torch.Tensor:
    """One worker's combination: sum_l w_l A_{i_l}^T B_{j_l} (loop over slots)."""
    s, r = A.shape
    _, t = B.shape
    br, bt = r // m, t // n
    acc = torch.zeros((br, bt), dtype=torch.float32, device=B.device)
    for col, w in zip(cols_k.tolist(), w_k.tolist()):
        i, j = divmod(col, n)
        prod = A[:, i * br:(i + 1) * br].T @ B[:, j * bt:(j + 1) * bt]
        acc = acc + w * prod
    return acc


def _make_dense_scan_local_product(plan: CodedMatmulPlan, pack):
    def local_product(k, A_, B_):
        return _local_dense_scan(A_, B_, plan.cols[k], plan.weights[k],
                                 plan.m, plan.n)

    return local_product


def _block_sparse_operands(plan: CodedMatmulPlan, pack: DeviceTilePack):
    """The per-tile weights of the staged plan, on the pack's device.

    The pack carries the BASE task table's weights; the staged plan may
    have zeroed some (chunk-prefix masking).  Each live tile's weight is
    re-read from the *current* plan through slot_of, so one pack serves
    every rebind; for an unmasked plan this reproduces pack.wslot bit for
    bit.  An int8 pack's per-tile scale is folded in here:
    w * (scale * tile_q) == (w * scale) * tile_q, so dequantizing is free.
    """
    w_cur = torch.as_tensor(plan.weights).to(pack.vals.device)     # (N, L)
    k_idx = torch.arange(w_cur.shape[0], device=w_cur.device)[:, None, None]
    wsl_all = torch.where(pack.wslot != 0.0, w_cur[k_idx, pack.slot_of], 0.0)
    if pack.tile_scale is not None:
        wsl_all = wsl_all * pack.tile_scale
    return wsl_all.contiguous()


def _make_block_sparse_local_product(plan: CodedMatmulPlan, pack: DeviceTilePack):
    wsl_all = _block_sparse_operands(plan, pack)

    def local_product(k, A_, B_):
        # fused gather: tiles address the original B directly
        return ops.spmm_block_fused(pack.vals[k], pack.src[k], wsl_all[k], B_,
                                    bt=B_.shape[1] // plan.n)

    return local_product


def _make_block_sparse_fused_decode(plan: CodedMatmulPlan, pack: DeviceTilePack):
    """The one-launch local product: decode combine fused into the epilogue.

    Returns ``(k, A, B, dvec) -> (mn, br, bt)`` where dvec is this worker's
    survivor decode column ``D[:, k] * alive_k``; the output is already the
    stack of decode-weighted copies, ready for the sum over workers.
    """
    wsl_all = _block_sparse_operands(plan, pack)

    def local_product_decode(k, A_, B_, dvec):
        return ops.spmm_block_fused_decode(pack.vals[k], pack.src[k],
                                           wsl_all[k], dvec, B_,
                                           bt=B_.shape[1] // plan.n)

    return local_product_decode


coded_backends.get_backend("dense_scan").local_product_factory = (
    _make_dense_scan_local_product)
coded_backends.get_backend("block_sparse").local_product_factory = (
    _make_block_sparse_local_product)
coded_backends.get_backend("block_sparse").fused_local_product_factory = (
    _make_block_sparse_fused_decode)


# ------------------------------- entry point --------------------------------

def check_operands(A: torch.Tensor, B: torch.Tensor, plan: CodedMatmulPlan):
    """Shared shape validation; returns (N, s, r, t, br, bt)."""
    m, n = plan.m, plan.n
    if A.dim() != 2 or B.dim() != 2 or A.shape[0] != B.shape[0]:
        raise ValueError(
            f"A {tuple(A.shape)} and B {tuple(B.shape)} must be (s, r), (s, t)")
    s, r = A.shape
    _, t = B.shape
    if r % m or t % n:
        raise ValueError(f"A cols {r} % m={m} or B cols {t} % n={n} nonzero")
    return plan.num_workers, s, r, t, r // m, t // n


def stage_coded_matmul(
    A: torch.Tensor,
    B: torch.Tensor,
    plan: CodedMatmulPlan,
    *,
    alive: np.ndarray | None = None,
    out_dtype: torch.dtype = torch.float32,
    backend: str = "dense_scan",
    pack: DeviceTilePack | None = None,
) -> torch.Tensor:
    """Run one coded matmul on the operands' device: C = A^T B, (r, t).

    ``plan`` must already be survivor-adjusted (``with_survivors``) and
    ``alive`` is the matching worker-liveness mask (None = all alive).  For
    backends with ``needs_pack``, ``pack`` is the device copy of a resolved
    pack (``resolve_pack`` then ``DeviceTilePack.from_pack``).
    """
    entry = coded_backends.get_backend(backend)
    if entry.virtual:
        raise ValueError(
            f"backend {backend!r} is a dispatch pseudo-backend: resolve it "
            "to a concrete backend (CodedOp does this) before staging")
    N, s, r, t, br, bt = check_operands(A, B, plan)
    m, n = plan.m, plan.n
    dev = B.device
    if entry.needs_pack and pack is None:
        raise ValueError(
            f"backend {backend!r} needs a resolved WorkerTilePack on the "
            "device (see resolve_pack)")
    if entry.local_product_factory is None:
        raise ValueError(
            f"backend {backend!r} is registered but has no "
            "local_product_factory attached")

    alive_t = (torch.ones(N, dtype=torch.float32, device=dev) if alive is None
               else torch.as_tensor(np.asarray(alive, dtype=np.float32)).to(dev))
    D_t = torch.as_tensor(plan.decode).to(dev)          # (mn, N)
    fuse = entry.fused_decode and entry.fused_local_product_factory is not None
    if fuse:
        local_product_decode = entry.fused_local_product_factory(plan, pack)
    else:
        local_product = entry.local_product_factory(plan, pack)

    contribs = []
    for k in range(N):
        dvec = D_t[:, k] * alive_t[k]      # survivor decode column, (mn,)
        if fuse:
            # one launch: the decode combine happens in the kernel epilogue
            contribs.append(local_product_decode(k, A, B, dvec))
        else:
            Ct = local_product(k, A, B)
            contribs.append(dvec[:, None, None] * Ct[None])
    blocks = torch.stack(contribs).sum(dim=0)              # (mn, br, bt)
    C = blocks.reshape(m, n, br, bt).permute(0, 2, 1, 3).reshape(m * br, n * bt)
    return C.to(out_dtype)


def coded_matmul(A, B, plan: CodedMatmulPlan, device=None,
                 survivors: np.ndarray | None = None,
                 out_dtype: torch.dtype = torch.float32,
                 backend: str = "dense_scan", a_sparse: BlockELL | None = None,
                 block_size: int = 8, pack: WorkerTilePack | None = None,
                 out_sharded: bool = False) -> torch.Tensor:
    """DEPRECATED flat-kwarg entry point; use ``repro_torch.coded`` instead.

    C = A^T B computed with the (P,S)-sparse code on ``device`` (None = the
    CUDA card, raising where there is none; or ``"cpu"``).  A: (s, r),
    B: (s, t); returns C (r, t).  r % m == 0 and t % n == 0 are required.

    The replacement is the plan->bind->apply object API::

        from repro_torch.coded import CodedMatmulConfig, from_plan
        op = from_plan(CodedMatmulConfig(backend=...), plan).bind(device)
        C = op(A, B)                     # bit-identical to this function

    This function makes that call (after ``with_survivors(survivors)``), so
    the two are bit-identical.
    """
    warnings.warn(
        "coded_matmul(...) is deprecated: use repro_torch.coded "
        "(CodedMatmulConfig + plan/from_plan -> bind -> apply)",
        DeprecationWarning, stacklevel=2)
    from repro_torch.coded import CodedMatmulConfig, from_plan

    entry = coded_backends.get_backend(backend)
    if not (entry.needs_pack or entry.virtual):
        a_sparse = pack = None  # ignored here, as the JAX package ignores them
    op = from_plan(CodedMatmulConfig(backend=backend, block_size=block_size,
                                     out_sharded=out_sharded,
                                     out_dtype=out_dtype), plan).bind(device)
    return op.with_survivors(survivors).apply(A, B, a_sparse=a_sparse,
                                              pack=pack)


def uncoded_matmul_reference(A, B) -> torch.Tensor:
    """The plain product A^T B in f32, on the operands' device, for tests
    and overhead comparisons."""
    A = torch.as_tensor(A).to(torch.float32)
    B = torch.as_tensor(B).to(torch.float32)
    return A.T @ B
