// Fused-gather block-sparse SpMM for the coded matmul, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/spmm_block.py:
//   * _spmm_block_fused_pallas        (body _fused_kernel)        -> DECODE=false
//   * _spmm_block_fused_decode_pallas (body _fused_decode_kernel) -> DECODE=true
//   * spmm_block                      (body _kernel)              -> PLAIN=true
// and, with the first two, the Pallas-Triton lane of
// src/repro/kernels/spmm_block_triton.py (spmm_block_fused_triton,
// spmm_block_fused_decode_triton), which computes the same two functions.
//
// What it computes, for one worker's packed tiles of A:
//   acc[cb] = sum_l wslot[cb,l] * vals[cb,l]^T @ B[src0*bs:+bs, src1*bt:+bt]
//   DECODE=false: out (CB*bs, bt)      = acc
//   DECODE=true:  out (mn, CB*bs, bt)  : out[c] = dvec[c] * acc
// Both forms run the SAME slot loop in the same order, so the decode form is
// dvec[c] * (two-step form), bit for bit.
//   PLAIN=true:   the plain block-ELL C = A^T B, the same loop with w = 1 and
//                 one column group of width t: src is idx (CB, L), read at
//                 stride 1, no weight is read or applied, and pad slots (zero
//                 tiles at idx 0) add exact zeros; out (CB*bs, t).
//
// Design: B streamed through shared memory once per group of column blocks.
//   * A slot's B tile is (row-block rb, column group grp), key = grp * (s/bs)
//     + rb.  `order` (CB, L) lists each column block's slots sorted by key
//     (kernels.spmm_block.slot_order, a stable sort, made by the wrapper),
//     so every column block walks B in address order.
//   * One thread block owns a group of G = WARPS column blocks and a column
//     tile of COLS = 32 * LANE_COLS output columns.  Its producer warp
//     streams every B tile under that column tile, key by key, CHUNK_ROWS
//     rows a chunk, into a ring of up to MAX_STAGES chunks, and the
//     consumers release a stage on its `empty` mbarrier.  Each B tile is
//     thus read once per group, not once per live slot.  Two copy paths,
//     chosen by the caller (`wide`, kernels.spmm_block.copy_path): where
//     B's rows and start lie on 16 bytes, one copy-engine (TMA) copy of a
//     bs x COLS box a tile, its bytes completing the stage's `full`
//     mbarrier; else 4-byte cp.async copies by the producer's lanes.
//   * Each consumer warp owns one column block; a lane owns LANE_COLS = 4
//     adjacent columns and all bs rows, so bs * 4 f32 accumulators in
//     registers.  The warp holds a window of 32 sorted slots in its lanes'
//     registers and takes the live ones with ballots.  Warps carry uneven
//     slot counts per chunk; the ring lets a warp run up to its stage count
//     ahead of the slowest, with no block-wide barrier.
//   * A slot's bs x bs tile of A is read by its warp only: cp.async into a
//     per-warp ring A_DEPTH slots ahead, then upcast (f32, bf16 or int8)
//     and multiplied by w into a per-warp f32 tile (__syncwarp only).
//   * acc[o][v] = fma(w * a[i][o], b[i][v], acc[o][v]) over the slots in key
//     order, then i, in IEEE f32 on the CUDA cores (explicit _rn intrinsics:
//     no TF32, no contraction that could differ between the forms).  No
//     atomics: each output element has one owner thread and a fixed order,
//     so a launch is deterministic.
//   * Slots of weight 0 (pads, slots a partial-straggler rebind masked) are
//     skipped.  The ragged t edge (a prime bt: the copy engine fills past t
//     with zeros, and the columns past bt are not stored) and a CB that is
//     no multiple of G are handled here, so the caller pads nothing.
//   bs = 8 (the default) is below the tensor cores' minimum depth, so this is
//   an FMA kernel.
//
// Bound on an H100 SXM (3.35 TB/s HBM, about 67 TFLOP/s of f32 on the CUDA
// cores): a live slot costs 2*bs^2*bt FLOPs, and the bytes of each input
// read once (the live tiles, each distinct B tile) take far less time, so
// the least time is the FLOPs' (3.28 ms for the main path's heaviest
// worker).  The first design read one B tile per live slot (about 55 GB
// through L2 for that worker) and was bound by it; G = 16 reads each B
// tile once per group and column tile (about 17 GB).  What bounds this one
// (PERF.md, chip_variants.py): the instructions a slot costs beside its
// bs^2 * 4 FMAs (the walk, the A tile's copy and upcast, the shared loads:
// about 160 more than the 256 FMAs at bs = 8), and warps waiting on the
// slowest of the block where their slot counts drift apart by more than
// the ring holds.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ---- design choices (chip_variants.py times alternatives of these lines)
constexpr int WARPS = 16;        // consumer warps (column blocks) of a block,
                                 // plus one producer warp
constexpr int LANE_COLS = 4;     // adjacent output columns a lane owns
constexpr int MAX_STAGES = 6;    // chunks of B in the shared-memory ring, at most
constexpr int CHUNK_ROWS = 64;   // rows of B a chunk holds
constexpr int A_DEPTH = 4;       // slots whose A tile a warp has in flight at bs = 8
constexpr int SMEM_MAX = 232448;   // shared bytes a block can have (227 KB)

constexpr int COLS = 32 * LANE_COLS;   // the column tile of a block
constexpr int THREADS = 32 * (WARPS + 1);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the helpers below take shared-memory addresses (smem_addr), made once
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// arrives on bar, adding `bytes` to the bytes its phase waits for
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes) : "memory");
}

// one B tile by the copy engine: the box of `tmap` (BS rows x COLS columns)
// at column col, row row; its bytes count against bar's phase when they land
__device__ __forceinline__ void tile_copy(uint32_t dst, const CUtensorMap* tmap, int col,
                                          int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// arrives on bar once every cp.async this thread issued so far has landed
__device__ __forceinline__ void mbar_arrive_on_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// waits for the phase of bar of this parity to complete; a wait that cannot
// end (an arrival lost to a fault) fails the launch instead of hanging it
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0; !mbar_try_wait(bar, parity); ++tries)
    if (tries == (1u << 28)) __trap();
}

// one lane's entry of its column block's window of sorted slots: the slot
// at position pos (its B tile's key, its index l, its weight); past L a key
// no chunk reaches and weight 0
template <bool PLAIN>
__device__ __forceinline__ void window_entry(const int32_t* __restrict__ order,
                                             const int32_t* __restrict__ src,
                                             const float* __restrict__ wslot,
                                             int64_t row, int pos, int L, int nrb,
                                             int& key, int& l, float& w) {
  key = 0x7fffffff;
  l = 0;
  w = 0.0f;
  if (pos >= L) return;
  l = min(max(order[row + pos], 0), L - 1);  // any order is safe to read
  if constexpr (PLAIN) {
    key = src[row + l];
    w = 1.0f;
  } else {
    key = src[2 * (row + l) + 1] * nrb + src[2 * (row + l)];
    w = wslot[row + l];
  }
}

// a lane's v-th output column within the column tile
__device__ __forceinline__ constexpr int col_of(int lane, int v) {
  return lane * LANE_COLS + v;
}

// the lane's LANE_COLS columns of a staged row, from its first (p)
__device__ __forceinline__ void load_cols(float (&b)[LANE_COLS], const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  b[0] = x.x;
  b[1] = x.y;
  b[2] = x.z;
  b[3] = x.w;
}

template <int BS, typename TV>
struct Geometry {
  static constexpr int G = WARPS;                // column blocks of a block
  static constexpr int CK = CHUNK_ROWS / BS;     // keys (B tiles) of a chunk
  static constexpr int TILE = BS * BS;
  static constexpr int RAW = TILE * static_cast<int>(sizeof(TV));  // bytes of a tile
  static constexpr int AD = BS == 8 ? A_DEPTH : (A_DEPTH / 4 > 2 ? A_DEPTH / 4 : 2);
  static_assert(CHUNK_ROWS % BS == 0, "a chunk holds whole B tiles");
  static_assert(RAW % 16 == 0, "a tile is whole 16-byte copies");
  // dynamic shared memory, in bytes: barriers, B ring, per-warp A rings,
  // per-warp f32 tiles (two), per-warp slot queue; the ring has as many
  // stages (up to MAX_STAGES) as the rest leaves room for
  static constexpr int STAGE_BYTES = CHUNK_ROWS * COLS * 4;
  static constexpr int OFF_B = 1024;  // the barriers below; TMA wants 128 B
  static constexpr int REST = WARPS * AD * RAW + WARPS * 2 * TILE * 4 + WARPS * AD * 16;
  static constexpr int ST = (SMEM_MAX - OFF_B - REST) / STAGE_BYTES < MAX_STAGES
                                ? (SMEM_MAX - OFF_B - REST) / STAGE_BYTES
                                : MAX_STAGES;
  static_assert(ST >= 2, "room for two stages of B");
  static_assert(2 * ST * 8 <= OFF_B, "the barriers fit below the ring");
  static constexpr int OFF_ARAW = OFF_B + ST * STAGE_BYTES;
  static constexpr int OFF_AF = OFF_ARAW + WARPS * AD * RAW;
  static constexpr int OFF_META = OFF_AF + WARPS * 2 * TILE * 4;
  static constexpr int SMEM = OFF_META + WARPS * AD * 16;
};

template <int BS, typename TV, bool DECODE, bool PLAIN = false>
__global__ void __launch_bounds__(THREADS, 1) spmm_block_fused_kernel(
    const TV* __restrict__ vals,      // (CB, L, BS, BS)
    const int32_t* __restrict__ src,  // (CB, L, 2) [row-block of B, column group];
                                      // PLAIN: (CB, L) row-block of B
    const int32_t* __restrict__ order,  // (CB, L) slots of each cb by key
    const float* __restrict__ wslot,  // (CB, L); unused when PLAIN
    const float* __restrict__ dvec,   // (mn,) when DECODE
    const float* __restrict__ B,      // (s, t) row-major
    float* __restrict__ out,          // (CB*BS, bt) or (mn, CB*BS, bt)
    int CB, int L, int s, int t, int bt, int mn, bool wide,
    const __grid_constant__ CUtensorMap tmap) {  // B, a box of BS x COLS; when wide
  using Geo = Geometry<BS, TV>;
  constexpr int CK = Geo::CK, TILE = Geo::TILE, RAW = Geo::RAW;
  constexpr int AD = Geo::AD, STAGES = Geo::ST;
  extern __shared__ __align__(1024) unsigned char smem[];
  // barriers: full[k] at s0 + 8 k (stage k has landed), empty[k] at
  // s0 + 8 (STAGES + k) (every consumer warp is done with stage k)
  const uint32_t s0 = smem_addr(smem);
  const uint32_t full = s0, empty = s0 + 8 * STAGES;
  float* bring = reinterpret_cast<float*>(smem + Geo::OFF_B);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nrb = s / BS;
  const int nkeys = nrb * (t / bt);
  const int nchunks = (nkeys + CK - 1) / CK;
  const int group = blockIdx.x;         // of column blocks
  const int col0 = blockIdx.y * COLS;   // within the column group

  if (threadIdx.x == 0) {
    for (int k = 0; k < STAGES; ++k) {
      mbar_init(full + 8 * k, wide ? 1 : 32);  // one expect_tx, or each lane's copies
      mbar_init(empty + 8 * k, WARPS);         // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == WARPS) {
    // ---- producer: every B tile under this column tile, key by key,
    // CHUNK_ROWS rows a chunk
    const int live_cols = min(COLS, bt - col0);
    for (int c = 0; c < nchunks; ++c) {
      const int st = c % STAGES;
      if (c >= STAGES) mbar_wait(empty + 8 * st, ((c / STAGES) - 1) & 1);
      float* dst = bring + st * (CHUNK_ROWS * COLS);
      const int tiles = min(CK, nkeys - c * CK);
      if (wide) {  // the copy engine, a B tile a lane
        if (lane == 0) mbar_arrive_expect(full + 8 * st, tiles * BS * COLS * 4);
        __syncwarp();
        if (lane < tiles) {
          const int key = c * CK + lane;
          const int grp = key / nrb, rb = key - grp * nrb;
          tile_copy(smem_addr(dst + lane * BS * COLS), &tmap, grp * bt + col0, rb * BS,
                    full + 8 * st);
        }
      } else {  // 4-byte copies
        for (int kk = 0; kk < tiles; ++kk) {
          const int key = c * CK + kk;
          const int grp = key / nrb, rb = key - grp * nrb;
          const float* srow = B + static_cast<int64_t>(rb) * BS * t +
                              static_cast<int64_t>(grp) * bt + col0;
          float* drow = dst + kk * BS * COLS;
          for (int e = lane; e < BS * live_cols; e += 32) {
            const int i = e / live_cols, cc = e % live_cols;
            cp_async_4(smem_addr(drow + i * COLS + cc),
                       srow + static_cast<int64_t>(i) * t + cc);
          }
        }
        mbar_arrive_on_copies(full + 8 * st);
      }
    }
    cp_async_wait<0>();
    return;
  }

  // ---- consumer warp: one column block, all bs rows, LANE_COLS columns
  const int cb = group * Geo::G + warp;
  const int64_t row = static_cast<int64_t>(cb) * L;
  unsigned char* araw = smem + Geo::OFF_ARAW + warp * (AD * RAW);
  const uint32_t araw_s = smem_addr(araw);
  float* afin = reinterpret_cast<float*>(smem + Geo::OFF_AF) + warp * (2 * TILE);
  int4* meta = reinterpret_cast<int4*>(smem + Geo::OFF_META) + warp * AD;

  float acc[BS][LANE_COLS];
#pragma unroll
  for (int o = 0; o < BS; ++o)
#pragma unroll
    for (int v = 0; v < LANE_COLS; ++v) acc[o][v] = 0.0f;

  // The walk: this lane's entry (wk, wl, ww) of a window of 32 sorted
  // positions from base; live, the window's live slots not yet issued; and
  // the first of them, the head: its key hk and chunk hc (nchunks once the
  // column block has no slot left)
  const int lim = cb < CB ? L : 0;
  int wk = 0, wl = 0, base = -32, hk = 0, hc = 0;
  float ww = 0.0f;
  unsigned live = 0;
  auto head = [&]() {  // past windows with no live slot left
    while (live == 0 && base + 32 < lim) {
      base += 32;
      window_entry<PLAIN>(order, src, wslot, row, base + lane, lim, nrb, wk, wl, ww);
      live = __ballot_sync(0xffffffffu, base + lane < lim && (PLAIN || ww != 0.0f));
    }
    hk = __shfl_sync(0xffffffffu, wk, live ? __ffs(live) - 1 : 0);
    hc = live ? hk / CK : nchunks;
  };
  head();
  int issued = 0, taken = 0, buf = 0;
  // the chunk the warp holds, its stage and that stage's phase parity
  int chunk = -1, cst = STAGES - 1;
  uint32_t cph = 1;

  for (int step = 0;; ++step) {
    // -- issue: the next slot's A tile into the ring, AD - 1 ahead
    if (hc < nchunks) {
      const int sel = __ffs(live) - 1;
      const int l = __shfl_sync(0xffffffffu, wl, sel);
      const float w = __shfl_sync(0xffffffffu, ww, sel);
      const int q = issued % AD;
      const unsigned char* tile =
          reinterpret_cast<const unsigned char*>(vals + (row + l) * TILE);
      for (int x = lane; x < RAW / 16; x += 32)
        cp_async_16(araw_s + q * RAW + 16 * x, tile + 16 * x);
      if (lane == 0) meta[q] = make_int4(hc, hk - hc * CK, __float_as_int(w), 0);
      ++issued;
      live &= live - 1;
      head();
    }
    cp_async_commit();  // one group a step, empty or not
    if (step < AD - 1) continue;
    if (taken >= issued) break;

    // -- consume slot `taken`
    const int q = taken % AD;
    cp_async_wait<AD - 1>();
    __syncwarp();
    const int4 m = meta[q];  // its chunk, its tile's place in the chunk, w
    while (chunk < m.x) {  // release the chunks before it, acquire its own
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
    for (int i = 0; i < BS; ++i) {  // the slot's FMAs
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
            acc[4 * o4 + u][v] = __fmaf_rn(a[u], b[v], acc[4 * o4 + u][v]);
      }
    }
    ++taken;
    buf ^= 1;
  }
  cp_async_wait<0>();

  // every chunk acquired and released once, so the producer never waits on
  // a warp that has finished
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

  // ---- epilogue: each lane its columns of its column block
  if (cb >= CB) return;
  const int64_t rows = static_cast<int64_t>(CB) * BS;
  const int64_t row0 = static_cast<int64_t>(cb) * BS;
  const int colx = col0 + col_of(lane, 0);
  if constexpr (DECODE) {
    // the decode combine, mn decode-weighted copies of acc
    for (int c = 0; c < mn; ++c) {
      const float d = dvec[c];
      float* o_c = out + (c * rows + row0) * bt;
#pragma unroll
      for (int o = 0; o < BS; ++o)
#pragma unroll
        for (int v = 0; v < LANE_COLS; ++v)
          if (colx + col_of(0, v) < bt)
            o_c[static_cast<int64_t>(o) * bt + colx + col_of(0, v)] =
                __fmul_rn(d, acc[o][v]);
    }
  } else {
    float* o_0 = out + row0 * bt;
#pragma unroll
    for (int o = 0; o < BS; ++o)
#pragma unroll
      for (int v = 0; v < LANE_COLS; ++v)
        if (colx + col_of(0, v) < bt)
          o_0[static_cast<int64_t>(o) * bt + colx + col_of(0, v)] = acc[o][v];
  }
}

// cuTensorMapEncodeTiled, looked up at run time (no link against libcuda)
PFN_cuTensorMapEncodeTiled encoder() {
  static PFN_cuTensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p);
  }();
  return fn;
}

// B (s, t) f32 as a tensor map whose box is one B tile: BS rows x COLS
// columns, zeros past the last column
template <int BS>
bool b_tensor_map(CUtensorMap* map, const float* B, int s, int t) {
  const PFN_cuTensorMapEncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(t), static_cast<cuuint64_t>(s)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(t) * 4};
  const cuuint32_t box[2] = {COLS, BS};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(B), dims,
                strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BS, typename TV, bool DECODE, bool PLAIN>
int launch_typed(const void* vals, const int32_t* src, const int32_t* order,
                 const float* wslot, const float* dvec, const float* B, float* out,
                 int CB, int L, int s, int t, int bt, int mn, bool wide,
                 cudaStream_t stream) {
  using Geo = Geometry<BS, TV>;
  const auto kernel = spmm_block_fused_kernel<BS, TV, DECODE, PLAIN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the copy engine takes B only where its rows and start lie on 16 bytes;
  // a tensor map the driver refuses is an error, never another path
  CUtensorMap map{};
  if (wide && (t % 4 != 0 || reinterpret_cast<uintptr_t>(B) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wide && !b_tensor_map<BS>(&map, B, s, t))
    return static_cast<int>(cudaErrorNotSupported);
  // x: the group of column blocks, so the blocks in flight share a column
  // tile of B in L2; y: the column tile
  const dim3 grid((CB + Geo::G - 1) / Geo::G, (bt + COLS - 1) / COLS);
  kernel<<<grid, THREADS, Geo::SMEM, stream>>>(
      static_cast<const TV*>(vals), src, order, wslot, dvec, B, out, CB, L, s, t,
      bt, mn, wide, map);
  return static_cast<int>(cudaGetLastError());
}

// vals_dtype: 0 = float32, 1 = bfloat16, 2 = int8
template <bool DECODE, bool PLAIN = false>
int launch(const void* vals, int vals_dtype, int bs, const int32_t* src,
           const int32_t* order, const float* wslot, const float* dvec,
           const float* B, float* out, int CB, int L, int s, int t, int bt, int mn,
           int wide, cudaStream_t stream) {
#define REPRO_LAUNCH(BS_, TV_)                                                 \
  return launch_typed<BS_, TV_, DECODE, PLAIN>(vals, src, order, wslot, dvec, \
                                               B, out, CB, L, s, t, bt, mn,   \
                                               wide != 0, stream)
  if (bs == 8) {
    if (vals_dtype == 0) REPRO_LAUNCH(8, float);
    if (vals_dtype == 1) REPRO_LAUNCH(8, __nv_bfloat16);
    if (vals_dtype == 2) REPRO_LAUNCH(8, int8_t);
  } else if (bs == 16) {
    if (vals_dtype == 0) REPRO_LAUNCH(16, float);
    if (vals_dtype == 1) REPRO_LAUNCH(16, __nv_bfloat16);
    if (vals_dtype == 2) REPRO_LAUNCH(16, int8_t);
  }
#undef REPRO_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int BS>
void geometry_of(int* g) {
  using Geo = Geometry<BS, float>;
  g[0] = Geo::G;
  g[1] = COLS;
  g[2] = Geo::ST;
  g[3] = CHUNK_ROWS;
  g[4] = Geo::AD;
  g[5] = THREADS;
  g[6] = Geo::SMEM;
}

}  // namespace

extern "C" {

// wide: 1 = B by the copy engine (B's rows and start on 16 bytes), 0 = by
// 4-byte copies
int spmm_block_fused(const void* vals, int vals_dtype, int bs, const int32_t* src,
                     const int32_t* order, const float* wslot, const float* B,
                     float* out, int CB, int L, int s, int t, int bt, int wide,
                     void* stream) {
  return launch<false>(vals, vals_dtype, bs, src, order, wslot, nullptr, B, out,
                       CB, L, s, t, bt, 0, wide, static_cast<cudaStream_t>(stream));
}

int spmm_block_fused_decode(const void* vals, int vals_dtype, int bs,
                            const int32_t* src, const int32_t* order,
                            const float* wslot, const float* dvec, const float* B,
                            float* out, int CB, int L, int s, int t, int bt, int mn,
                            int wide, void* stream) {
  return launch<true>(vals, vals_dtype, bs, src, order, wslot, dvec, B, out, CB, L,
                      s, t, bt, mn, wide, static_cast<cudaStream_t>(stream));
}

int spmm_block(const void* vals, int vals_dtype, int bs, const int32_t* idx,
               const int32_t* order, const float* B, float* out, int CB, int L,
               int s, int t, int wide, void* stream) {
  return launch<false, true>(vals, vals_dtype, bs, idx, order, nullptr, nullptr, B,
                             out, CB, L, s, t, /*bt=*/t, 0, wide,
                             static_cast<cudaStream_t>(stream));
}

// The design the library was built with, for tile edge bs (8 or 16):
// {G, COLS, STAGES, CHUNK_ROWS, A_DEPTH, threads, shared bytes at f32}.
// Returns nonzero for another bs.
int spmm_block_geometry(int bs, int* g) {
  if (bs == 8) geometry_of<8>(g);
  else if (bs == 16) geometry_of<16>(g);
  else return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // extern "C"
