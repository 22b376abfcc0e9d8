"""Time the design choices of the port's CUDA kernels on one NVIDIA card.

    python3 chip_variants.py [spmm | probe | coded_accum]
                                     (spmm and coded_accum when no argument)

Builds a kernel source as it is and in variants that each change one
choice of its design (into ``build/variants/``), runs every build at the
main path's width, and prints one JSON line per run, in turns (each
variant, then each again in reverse order).  Only the source as it is
(``kernel``) is ever used by the port.

``spmm`` -- ``csrc/spmm_block.cu``, the fused-decode launch of the main
path's heaviest worker (s = 16384, r = t = 8192, m = n = 2, 8 workers,
8x8 tiles at 10% block density, seed 0: worker 5, bt = 4096):

* ``G=8`` / ``G=20``     -- 8 or 20 consumer warps of one column block each
                            (the kernel: 16, so G = 16 column blocks a block);
* ``G=30`` / ``G=32``    -- 15 or 16 consumer warps of two column blocks
                            each, merged by chunk (carries its own consumer
                            code: a block holds at most 31 consumer warps);
* ``cols=64``            -- 2 columns a lane, a 64-column tile (the kernel: 4,
                            128 columns);
* ``cols=256,G=15`` / ``cols=256,G=12`` -- 8 columns a lane (4 adjacent ones
                            in each 128), a 256-column tile, 32 rows a chunk,
                            15 or 12 consumer warps;
* ``stages=2`` / ``stages=4`` -- the ring of staged B chunks (the kernel: 6 of
                            64 rows);
* ``stages=12,rows=32``  -- the same bytes in twice as many chunks;
* ``a_depth=8``          -- A tiles a warp has in flight (the kernel: 4);
* ``w_after_dot``        -- w applied to each slot's dot, not folded into
                            the A tile;
* ``no_compute``         -- every FMA left out (its result is not checked):
                            the time of the rest, B's stream and the walk;
* ``grid_tiles_first``   -- the column tiles of one group in flight
                            together, not the groups of one column tile;
* ``a_depth=2``          -- two A tiles a warp in flight;
* ``stages=3,rows=128``  -- the kernel's bytes in half as many chunks.

An edit is (old text, new text), or ((first line, next text), new
text): the source from its first line up to the next text, replaced.

Before them, one launch of the kernel with clock64() probes (``probe``
alone runs only this): each consumer warp's cycles in the parts of its
slot loop, and the producer's cycles waiting for a free stage; and the
wrapper's time around the same launch (its checks, and the slot order it
makes each launch).

Each line has the time (CUDA events, median of 5 after a warm-up), the
error against the plain version and ``chip_smoke.py``'s tolerance, and
ptxas's registers and spills of the timed instance.

``coded_accum`` -- ``csrc/coded_accum.cu`` at s = 16384, r = t = 8192,
m = n = 2, one worker with 4 live slots, f32:

* ``cvt_split``    -- the TF32 split by ``cvt.rna.tf32.f32`` (big and small)
                      in place of the integer rounding;
* ``one_pass``     -- one TF32 MMA a step (1xTF32): the cost of one pass,
                      and the error the kernel's three passes avoid;
* ``no_promotion`` -- the MMA sum over all of s, never promoted into the
                      round-to-nearest total.

Each line has the time, the error against the plain version (f32) and
against an f64 product, and the tolerance ``chip_smoke.py`` holds the
kernel to.  Then the kernel itself with bf16 x bf16 and f32 x bf16
operands (one and two MMAs a step), and the cuBLAS f32 yardstick of
``chip_smoke.py`` (the port's ``_local_dense_scan``).

It exits nonzero where no CUDA device is present or a build fails.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

#: the consumer warp of the G=30 / G=32 variants: two column blocks (one at
#: bs = 16) a warp, their slots merged in (chunk, column block, position) order
_TWO_CB_CONSUMER = r"""  // ---- consumer warp: CPW column blocks, all bs rows, LANE_COLS columns
  constexpr int CPW = Geo::CPW;
  const int cb0 = group * Geo::G + warp * CPW;
  unsigned char* araw = smem + Geo::OFF_ARAW + warp * (AD * RAW);
  const uint32_t araw_s = smem_addr(araw);
  float* afin = reinterpret_cast<float*>(smem + Geo::OFF_AF) + warp * (2 * TILE);
  int4* meta = reinterpret_cast<int4*>(smem + Geo::OFF_META) + warp * AD;

  float acc[CPW][BS][LANE_COLS];
#pragma unroll
  for (int j = 0; j < CPW; ++j)
#pragma unroll
    for (int o = 0; o < BS; ++o)
#pragma unroll
      for (int v = 0; v < LANE_COLS; ++v) acc[j][o][v] = 0.0f;

  int wk[CPW], wl[CPW], base[CPW], lim[CPW], hk[CPW], hc[CPW];
  float ww[CPW];
  unsigned live[CPW];
#pragma unroll
  for (int j = 0; j < CPW; ++j) {
    lim[j] = cb0 + j < CB ? L : 0;
    base[j] = -32;
    live[j] = 0;
    wk[j] = wl[j] = 0;
    ww[j] = 0.0f;
  }
  auto head = [&](const int j) {
    while (live[j] == 0 && base[j] + 32 < lim[j]) {
      base[j] += 32;
      window_entry<PLAIN>(order, src, wslot, static_cast<int64_t>(cb0 + j) * L,
                          base[j] + lane, lim[j], nrb, wk[j], wl[j], ww[j]);
      live[j] = __ballot_sync(0xffffffffu, base[j] + lane < lim[j] &&
                                               (PLAIN || ww[j] != 0.0f));
    }
    hk[j] = __shfl_sync(0xffffffffu, wk[j], live[j] ? __ffs(live[j]) - 1 : 0);
    hc[j] = live[j] ? hk[j] / CK : nchunks;
  };
#pragma unroll
  for (int j = 0; j < CPW; ++j) head(j);
  int issued = 0, taken = 0, buf = 0;
  int chunk = -1, cst = STAGES - 1;
  uint32_t cph = 1;

  for (int step = 0;; ++step) {
    int jn = 0, cn = hc[0];  // the head of least chunk, the lower cb first
#pragma unroll
    for (int j = 1; j < CPW; ++j)
      if (hc[j] < cn) {
        jn = j;
        cn = hc[j];
      }
    if (cn < nchunks) {
#pragma unroll
      for (int j = 0; j < CPW; ++j) {
        if (j != jn) continue;
        const int sel = __ffs(live[j]) - 1;
        const int l = __shfl_sync(0xffffffffu, wl[j], sel);
        const float w = __shfl_sync(0xffffffffu, ww[j], sel);
        const int q = issued % AD;
        const unsigned char* tile = reinterpret_cast<const unsigned char*>(
            vals + (static_cast<int64_t>(cb0 + j) * L + l) * TILE);
        for (int x = lane; x < RAW / 16; x += 32)
          cp_async_16(araw_s + q * RAW + 16 * x, tile + 16 * x);
        if (lane == 0) meta[q] = make_int4(hc[j], hk[j] - hc[j] * CK, __float_as_int(w), j);
        ++issued;
        live[j] &= live[j] - 1;
        head(j);
      }
    }
    cp_async_commit();
    if (step < AD - 1) continue;
    if (taken >= issued) break;

    const int q = taken % AD;
    cp_async_wait<AD - 1>();
    __syncwarp();
    const int4 m = meta[q];
    while (chunk < m.x) {
      if (chunk >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * cst);
      }
      ++chunk;
      if (++cst == STAGES) {
        cst = 0;
        cph ^= 1;
      }
      mbar_wait(full + 8 * cst, cph);
    }
    const float w = __int_as_float(m.z);
    const TV* raw = reinterpret_cast<const TV*>(araw + q * RAW);
    float* af = afin + buf * TILE;
    for (int x = lane; x < TILE; x += 32) {
      const float a = to_f32(raw[x]);
      af[x] = PLAIN ? a : __fmul_rn(w, a);
    }
    __syncwarp();
    const float* brow = bring + cst * (CHUNK_ROWS * COLS) + m.y * (BS * COLS) +
                        col_of(lane, 0);
#pragma unroll
    for (int j = 0; j < CPW; ++j) {
      if (j != m.w) continue;
#pragma unroll
      for (int i = 0; i < BS; ++i) {
        float b[LANE_COLS];
        load_cols(b, brow + i * COLS);
#pragma unroll
        for (int o4 = 0; o4 < BS / 4; ++o4) {
          const float4 a4 = reinterpret_cast<const float4*>(af + i * BS)[o4];
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < LANE_COLS; ++v)
              acc[j][4 * o4 + u][v] = __fmaf_rn(a[u], b[v], acc[j][4 * o4 + u][v]);
        }
      }
    }
    ++taken;
    buf ^= 1;
  }
  cp_async_wait<0>();

  for (;;) {
    if (chunk >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * cst);
    }
    if (++chunk == nchunks) break;
    if (++cst == STAGES) {
      cst = 0;
      cph ^= 1;
    }
    mbar_wait(full + 8 * cst, cph);
  }

  const int64_t rows = static_cast<int64_t>(CB) * BS;
  const int colx = col0 + col_of(lane, 0);
#pragma unroll
  for (int j = 0; j < CPW; ++j) {
    if (cb0 + j >= CB) continue;
    const int64_t row0 = static_cast<int64_t>(cb0 + j) * BS;
    if constexpr (DECODE) {
      for (int c = 0; c < mn; ++c) {
        const float d = dvec[c];
        float* o_c = out + (c * rows + row0) * bt;
#pragma unroll
        for (int o = 0; o < BS; ++o)
#pragma unroll
          for (int v = 0; v < LANE_COLS; ++v)
            if (colx + col_of(0, v) < bt)
              o_c[static_cast<int64_t>(o) * bt + colx + col_of(0, v)] =
                  __fmul_rn(d, acc[j][o][v]);
      }
    } else {
      float* o_0 = out + row0 * bt;
#pragma unroll
      for (int o = 0; o < BS; ++o)
#pragma unroll
        for (int v = 0; v < LANE_COLS; ++v)
          if (colx + col_of(0, v) < bt)
            o_0[static_cast<int64_t>(o) * bt + colx + col_of(0, v)] = acc[j][o][v];
    }
  }
}

"""
_TWO_CB = [
    ("  static constexpr int G = WARPS;",
     "  static constexpr int CPW = BS == 8 ? 2 : 1;  // column blocks a warp\n"
     "  static constexpr int G = WARPS * CPW;"),
    (("  // ---- consumer warp: one column block", "// cuTensorMapEncodeTiled"),
     _TWO_CB_CONSUMER)]
#: the lane's columns as 4 adjacent ones in each 128 (cols=256), so a
#: warp's 16-byte shared loads read 512 contiguous bytes
_SPREAD_COLS = [
    ("constexpr int LANE_COLS = 4;", "constexpr int LANE_COLS = 8;"),
    ("  return lane * LANE_COLS + v;", "  return (v / 4) * 128 + lane * 4 + v % 4;"),
    (("  const float4 x = *reinterpret_cast<const float4*>(p);", "}\n"),
     "#pragma unroll\n  for (int k = 0; k < 2; ++k) {\n"
     "    const float4 x = *reinterpret_cast<const float4*>(p + 128 * k);\n"
     "    b[4 * k] = x.x;\n    b[4 * k + 1] = x.y;\n"
     "    b[4 * k + 2] = x.z;\n    b[4 * k + 3] = x.w;\n  }\n"),
    ("constexpr int CHUNK_ROWS = 64;", "constexpr int CHUNK_ROWS = 32;")]
_FMA_LOOP = "#pragma unroll\n    for (int i = 0; i < BS; ++i) {  // the slot's FMAs\n"
#: variant -> the edits of spmm_block.cu that make it
SPMM_VARIANTS = {
    "kernel": [],
    "G=8": [("constexpr int WARPS = 16;", "constexpr int WARPS = 8;")],
    "G=30": [("constexpr int WARPS = 16;", "constexpr int WARPS = 15;"), *_TWO_CB],
    "G=32": _TWO_CB,
    "G=20": [("constexpr int WARPS = 16;", "constexpr int WARPS = 20;")],
    "cols=64": [
        ("constexpr int LANE_COLS = 4;", "constexpr int LANE_COLS = 2;"),
        (("  const float4 x = *reinterpret_cast<const float4*>(p);", "}\n"),
         "  const float2 x = *reinterpret_cast<const float2*>(p);\n"
         "  b[0] = x.x;\n  b[1] = x.y;\n")],
    "cols=256,G=15": [("constexpr int WARPS = 16;", "constexpr int WARPS = 15;"),
                      *_SPREAD_COLS],
    "cols=256,G=12": [("constexpr int WARPS = 16;", "constexpr int WARPS = 12;"),
                      *_SPREAD_COLS],
    "stages=2": [("constexpr int MAX_STAGES = 6;", "constexpr int MAX_STAGES = 2;")],
    "stages=4": [("constexpr int MAX_STAGES = 6;", "constexpr int MAX_STAGES = 4;")],
    "stages=12,rows=32": [("constexpr int MAX_STAGES = 6;", "constexpr int MAX_STAGES = 12;"),
                          ("constexpr int CHUNK_ROWS = 64;", "constexpr int CHUNK_ROWS = 32;")],
    "a_depth=8": [("constexpr int A_DEPTH = 4;", "constexpr int A_DEPTH = 8;")],
    "w_after_dot": [
        ("      af[x] = PLAIN ? a : __fmul_rn(w, a);", "      af[x] = a;"),
        ((_FMA_LOOP, "    ++taken;\n"),
         "    {  // w applied to the slot's dot, as the first design did\n"
         "      float dot[BS][LANE_COLS];\n"
         "#pragma unroll\n"
         "      for (int o = 0; o < BS; ++o)\n"
         "#pragma unroll\n"
         "        for (int v = 0; v < LANE_COLS; ++v) dot[o][v] = 0.0f;\n"
         "#pragma unroll\n"
         "      for (int i = 0; i < BS; ++i) {\n"
         "        float b[LANE_COLS];\n"
         "        load_cols(b, brow + i * COLS);\n"
         "#pragma unroll\n"
         "        for (int o = 0; o < BS; ++o)\n"
         "#pragma unroll\n"
         "          for (int v = 0; v < LANE_COLS; ++v)\n"
         "            dot[o][v] = __fmaf_rn(af[i * BS + o], b[v], dot[o][v]);\n"
         "      }\n"
         "#pragma unroll\n"
         "      for (int o = 0; o < BS; ++o)\n"
         "#pragma unroll\n"
         "        for (int v = 0; v < LANE_COLS; ++v)\n"
         "          acc[o][v] = __fadd_rn(acc[o][v], __fmul_rn(w, dot[o][v]));\n"
         "    }\n")],
    "no_compute": [(_FMA_LOOP, _FMA_LOOP.replace("i < BS;", "i < 0;"))],
    "grid_tiles_first": [
        ("  const int group = blockIdx.x;", "  const int group = blockIdx.y;"),
        ("  const int col0 = blockIdx.y * COLS;", "  const int col0 = blockIdx.x * COLS;"),
        ("const dim3 grid((CB + Geo::G - 1) / Geo::G, (bt + COLS - 1) / COLS);",
         "const dim3 grid((bt + COLS - 1) / COLS, (CB + Geo::G - 1) / Geo::G);")],
    "a_depth=2": [("constexpr int A_DEPTH = 4;", "constexpr int A_DEPTH = 2;")],
    "stages=3,rows=128": [("constexpr int MAX_STAGES = 6;", "constexpr int MAX_STAGES = 3;"),
                          ("constexpr int CHUNK_ROWS = 64;", "constexpr int CHUNK_ROWS = 128;")],
}
#: variants that do not compute the product: timed, not checked
UNCHECKED = {"no_compute"}
#: the kernel with clock64() probes: each consumer warp's cycles by part of
#: its slot loop, and the producer's cycles waiting for a free stage, summed
#: over the launch into PROBE_PARTS (read by spmm_block_probe)
PROBE_PARTS = ("issue", "await_tile", "acquire_chunk", "upcast", "compute",
               "consumer_total", "producer_wait", "producer_total")
SPMM_PROBE = [
    ("namespace {\n", "namespace {\n__device__ unsigned long long probe_cycles[8];\n"),
    ("  int issued = 0, taken = 0, buf = 0;\n",
     "  int issued = 0, taken = 0, buf = 0;\n"
     "  long long pr[5] = {0, 0, 0, 0, 0}, t0, t1, t2, t3, t4;\n"
     "  const long long t_start = clock64();\n"),
    ("  for (int step = 0;; ++step) {\n",
     "  for (int step = 0;; ++step) {\n    t0 = clock64();\n"),
    ("    cp_async_commit();  // one group a step, empty or not\n",
     "    cp_async_commit();  // one group a step, empty or not\n"
     "    t1 = clock64(); pr[0] += t1 - t0;\n"),
    ("    const int4 m = meta[q];  // its chunk, its tile's place in the chunk, w\n",
     "    const int4 m = meta[q];\n    t2 = clock64(); pr[1] += t2 - t1;\n"),
    ("    const float w = __int_as_float(m.z);\n",
     "    t3 = clock64(); pr[2] += t3 - t2;\n    const float w = __int_as_float(m.z);\n"),
    ("    const float* brow = bring",
     "    t4 = clock64(); pr[3] += t4 - t3;\n    const float* brow = bring"),
    ("    ++taken;\n", "    pr[4] += clock64() - t4;\n    ++taken;\n"),
    ("  // ---- epilogue: each lane its columns of its column block\n",
     "  if (lane == 0) {\n"
     "    for (int x = 0; x < 5; ++x) atomicAdd(&probe_cycles[x], (unsigned long long)pr[x]);\n"
     "    atomicAdd(&probe_cycles[5], (unsigned long long)(clock64() - t_start));\n"
     "  }\n"
     "  // ---- epilogue: each lane its columns of its column block\n"),
    ("    const int live_cols = min(COLS, bt - col0);\n",
     "    const int live_cols = min(COLS, bt - col0);\n"
     "    long long p_wait = 0; const long long p_start = clock64();\n"),
    ("      if (c >= STAGES) mbar_wait(empty + 8 * st, ((c / STAGES) - 1) & 1);\n",
     "      const long long pw = clock64();\n"
     "      if (c >= STAGES) mbar_wait(empty + 8 * st, ((c / STAGES) - 1) & 1);\n"
     "      p_wait += clock64() - pw;\n"),
    ("    cp_async_wait<0>();\n    return;\n",
     "    cp_async_wait<0>();\n"
     "    if (lane == 0) { atomicAdd(&probe_cycles[6], (unsigned long long)p_wait);\n"
     "      atomicAdd(&probe_cycles[7], (unsigned long long)(clock64() - p_start)); }\n"
     "    return;\n"),
    ('extern "C" {\n',
     'extern "C" {\n\nint spmm_block_probe(unsigned long long* host, int reset) {\n'
     '  if (reset) { unsigned long long z[8] = {0}; return (int)cudaMemcpyToSymbol('
     'probe_cycles, z, sizeof(z)); }\n'
     '  return (int)cudaMemcpyFromSymbol(host, probe_cycles, sizeof(probe_cycles));\n}\n'),
]
_CVT_BIG = "big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
_CVT_SMALL = "small = __float_as_uint(x - __uint_as_float(big));"
#: variant -> the edits of the source that make it
VARIANTS = {
    "kernel": [],
    "cvt_split": [
        (_CVT_BIG, 'asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));'),
        (_CVT_SMALL, 'asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) '
                     ': "f"(x - __uint_as_float(big)));')],
    "one_pass": [
        ("constexpr bool A_SPLIT = sizeof(TA) == 4;", "constexpr bool A_SPLIT = false;"),
        ("constexpr bool B_SPLIT = sizeof(TB) == 4;", "constexpr bool B_SPLIT = false;")],
    "no_promotion": [
        ("constexpr int PROMOTE = 4;", "constexpr int PROMOTE = 1 << 30;")],
}
S, R, T, M, N = 16384, 8192, 8192, 2, 2
COLS, WEIGHTS = [0, 1, 2, 3], [0.5, -1.25, 2.0, 0.75]


def build_variant(source: str, variants: dict, name: str
                  ) -> tuple[str, pathlib.Path, str]:
    """``csrc/<source>.cu`` with the edits of ``variants[name]``, built into
    ``build/variants/``: (name, library, ptxas's log)."""
    from repro_torch.kernels import build

    text = (build.CSRC / f"{source}.cu").read_text()
    for old, new in variants[name]:
        if isinstance(old, tuple):          # a region: first line to next text
            first, after = old
            i = text.find(first)
            j = text.find(after, i + len(first)) if i >= 0 else -1
            if j < 0:
                raise SystemExit(f"chip_variants: {name}: source has no region "
                                 f"{first!r} .. {after!r}")
            old = text[i:j]
        if old not in text:
            raise SystemExit(f"chip_variants: {name}: source has no {old!r}")
        text = text.replace(old, new)
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    stem = f"{source}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    (out / f"{stem}.cu").write_text(text)
    lib = out / f"lib{stem}.so"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(out / f"{stem}.cu")], capture_output=True, text=True,
                          timeout=900)
    if proc.returncode:
        raise SystemExit(f"chip_variants: nvcc failed on {name}:\n{proc.stderr}")
    return name, lib, proc.stdout + proc.stderr


def build_all(source: str, variants: dict) -> list:
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        return list(pool.map(lambda v: build_variant(source, variants, v), variants))


def probe_launch(cs, launcher, k: int) -> None:
    """One launch of the probed build of spmm_block.cu: where the warps'
    cycles go."""
    _, lib, _ = build_variant("spmm_block", {"probe": SPMM_PROBE}, "probe")
    probe = ctypes.CDLL(str(lib)).spmm_block_probe
    probe.argtypes = [ctypes.c_void_p, ctypes.c_int]
    cycles = (ctypes.c_ulonglong * len(PROBE_PARTS))()
    run = launcher(lib)
    run()                                     # warm: the launch's set-up
    cs.check(probe(None, 1) == 0, "probe reset failed")
    run()
    torch.cuda.synchronize()
    cs.check(probe(ctypes.cast(cycles, ctypes.c_void_p), 0) == 0, "probe read failed")
    parts = dict(zip(PROBE_PARTS, (int(c) for c in cycles)))
    cs.emit(kernel="spmm_block_fused_decode", variant="probe", worker=k,
            ms=cs.time_ms(run, reps=3), warp_cycles=parts,
            consumer_share={x: parts[x] / max(parts["consumer_total"], 1)
                            for x in PROBE_PARTS[:5]},
            producer_wait_share=parts["producer_wait"] / max(parts["producer_total"], 1))


def spmm_variants(cs, variants: bool = True, probe: bool = True) -> None:
    """The fused-decode launch of the main path's heaviest worker, in each
    build of spmm_block.cu, and in the probed build."""
    from repro_torch.coded import CodedMatmulConfig, plan
    from repro_torch.core.coded_matmul import DeviceTilePack, _block_sparse_operands
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.spmm_block import VALS_DTYPES, copy_path, slot_order
    from repro_torch.sparse import dense_to_block_ell

    built = build_all("spmm_block", SPMM_VARIANTS) if variants else []
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(cs.SEED)        # the operands of chip_smoke's main path
    mask = rng.random((cs.S // cs.BS, cs.R // cs.BS)) < cs.DENSITY
    A = (rng.standard_normal((cs.S // cs.BS, cs.BS, cs.R // cs.BS, cs.BS),
                             dtype=np.float32) * mask[:, None, :, None]).reshape(cs.S, cs.R)
    B = torch.from_numpy(rng.standard_normal((cs.S, cs.T), dtype=np.float32)).to(dev)
    ell = dense_to_block_ell(A, cs.BS)
    del A
    op = plan(CodedMatmulConfig(scheme="sparse_code", backend="block_sparse",
                                block_size=cs.BS), m=cs.M_BLK, n=cs.N_BLK,
              num_workers=cs.WORKERS, seed=cs.SEED)
    wp = op.pack_for(ell, use_cache=False)
    k = int(np.argmax(wp.live_tiles))
    dpack = DeviceTilePack.from_pack(wp, dev)
    wsl = _block_sparse_operands(op.base_plan, dpack)
    vals, src, w = dpack.vals[k], dpack.src[k], wsl[k]
    order, wide = slot_order(src, cs.S // cs.BS), int(copy_path(B) == "tma")
    dvec = torch.from_numpy(op.base_plan.decode[:, k].copy()).to(dev)
    CB, L = w.shape
    bt, mn = cs.T // cs.N_BLK, cs.M_BLK * cs.N_BLK
    plain = ref.spmm_block_fused_decode_ref(vals, src, w, dvec, B, bt)
    tol = cs.sum_tol(L * cs.BS, float(plain.abs().max()))
    bound = cs.launch_bound(dpack, wsl, k, bt, mn, True)

    def launcher(lib: pathlib.Path):
        fn = ctypes.CDLL(str(lib)).spmm_block_fused_decode
        fn.argtypes = build.SIGNATURES["spmm_block"]["spmm_block_fused_decode"]
        fn.restype = ctypes.c_int

        def run():
            out = torch.empty((mn, CB * cs.BS, bt), dtype=torch.float32, device=dev)
            err = fn(vals.data_ptr(), VALS_DTYPES[vals.dtype], cs.BS, src.data_ptr(),
                     order.data_ptr(), w.data_ptr(), dvec.data_ptr(), B.data_ptr(),
                     out.data_ptr(), CB, L, cs.S, cs.T, bt, mn, wide,
                     torch.cuda.current_stream().cuda_stream)
            cs.check(err == 0, f"launch failed: cudaError_t {err}")
            return out
        return run

    if probe:
        probe_launch(cs, launcher, k)
        # the wrapper around the same launch: its checks and the slot order
        # it makes, beside the bare launch
        from repro_torch.kernels import spmm_block
        cs.emit(kernel="spmm_block_fused_decode", worker=k,
                kernel_ms=cs.time_ms(launcher(build.build("spmm_block"))),
                wrapper_ms=cs.time_ms(lambda: spmm_block.spmm_block_fused_decode(
                    vals, src, w, dvec, B, bt=bt)),
                copy_path=copy_path(B))

    for name, lib, log in built + built[::-1]:
        run = launcher(lib)
        got = run()
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        del got
        cs.check(err <= tol or name in UNCHECKED, f"spmm variant {name}: {err} > {tol}")
        ms = cs.time_ms(run)
        cs.emit(kernel="spmm_block_fused_decode", variant=name, worker=k,
                live_slots=bound["live_slots"], ms=ms, bound_ms=bound["bound_ms"],
                err_vs_plain=err, tol=tol,
                ptxas=cs.spmm_instances(log).get("bs=8 float32 fused_decode"))


def accum_variants(cs, info: dict) -> None:
    """coded_accum at full width, one worker's 4 live slots, in each build."""
    from repro_torch.core.coded_matmul import _local_dense_scan
    from repro_torch.kernels import build, ref

    built = [(name, lib, sorted({ln.split(":", 1)[1].strip() for ln in log.splitlines()
                                 if "Used" in ln and "registers" in ln}
                                | {f"{x} bytes spilled" for x in
                                   re.findall(r"(\d+) bytes spill stores", log)}))
             for name, lib, log in build_all("coded_accum", VARIANTS)]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn(S, R, device=dev, generator=gen)
    B = torch.randn(S, T, device=dev, generator=gen)
    cols = torch.tensor(COLS, dtype=torch.int32, device=dev)
    wts = torch.tensor(WEIGHTS, dtype=torch.float32, device=dev)
    br, bt = R // M, T // N
    plain = ref.coded_accum_ref(A, B, cols, wts, M, N)
    exact = torch.zeros((br, bt), dtype=torch.float64, device=dev)
    for c, w in zip(COLS, WEIGHTS):
        i, j = divmod(c, N)
        exact += w * (A[:, i * br:(i + 1) * br].double().T
                      @ B[:, j * bt:(j + 1) * bt].double())
    tol = cs.sum_tol(S * len(COLS), float(plain.abs().max()))
    flops = len(COLS) * 2 * S * br * bt

    def launcher(lib: pathlib.Path, Ax: torch.Tensor, Bx: torch.Tensor):
        fn = ctypes.CDLL(str(lib)).coded_accum
        fn.argtypes = build.SIGNATURES["coded_accum"]["coded_accum"]
        fn.restype = ctypes.c_int
        codes = {torch.float32: 0, torch.bfloat16: 1}

        def run():
            out = torch.empty((br, bt), dtype=torch.float32, device=dev)
            err = fn(Ax.data_ptr(), codes[Ax.dtype], Bx.data_ptr(), codes[Bx.dtype],
                     cols.data_ptr(), wts.data_ptr(), out.data_ptr(), S, R, T, br, bt,
                     N, len(COLS), 1, torch.cuda.current_stream().cuda_stream)
            cs.check(err == 0, f"launch failed: cudaError_t {err}")
            return out
        return run

    for name, lib, ptxas in built + built[::-1]:
        run = launcher(lib, A, B)
        got = run()
        torch.cuda.synchronize()
        ms = cs.time_ms(run)
        cs.emit(variant=name, operands="f32 x f32", ms=ms, tflops=flops / ms / 1e9,
                err_vs_plain=float((got - plain).abs().max()),
                err_vs_f64=float((got.double() - exact).abs().max()),
                plain_err_vs_f64=float((plain.double() - exact).abs().max()),
                tol=tol, ptxas=ptxas)
    kernel_lib = built[0][1]
    for Ax, Bx, what in ((A.bfloat16(), B.bfloat16(), "bf16 x bf16"),
                         (A, B.bfloat16(), "f32 x bf16")):
        ms = cs.time_ms(launcher(kernel_lib, Ax, Bx))
        cs.emit(variant="kernel", operands=what, ms=ms, tflops=flops / ms / 1e9)
    lib_ms = cs.time_ms(lambda: _local_dense_scan(A, B, cols.cpu().numpy(),
                                                   wts.cpu().numpy(), M, N))
    cs.emit(library="the port's _local_dense_scan: 4 torch.matmul calls, TF32 off",
            library_ms=lib_ms, device=info["nvidia_smi"])


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device; this runs on the card only",
              file=sys.stderr)
        return 2
    which = argv[1:] or ["spmm", "coded_accum"]
    if set(which) - {"spmm", "coded_accum", "probe"}:
        raise SystemExit(f"chip_variants: unknown kernel in {which}")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    info = cs.phase_device()
    if "spmm" in which or "probe" in which:
        spmm_variants(cs, variants="spmm" in which)
    if "coded_accum" in which:
        accum_variants(cs, info)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
