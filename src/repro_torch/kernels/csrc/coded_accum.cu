// Dense coded accumulation for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel of src/repro/kernels/coded_accum.py (coded_accum,
// body _kernel, pallas_call at :75).  What it computes, for one worker's
// task table:
//   out (br, bt) = sum_l weights[l] * A[:, i_l*br:+br]^T @ B[:, j_l*bt:+bt]
// with (i_l, j_l) = divmod(cols[l], n), br = r/m, bt = t/n, A (s, r) and
// B (s, t) row-major, f32 or bf16, accumulated in f32.  A slot's partial
// product runs over all of s, then out += w * partial in slot order; a slot
// of weight 0 is a pad and adds nothing.
//
// Why the tensor cores, and why 3xTF32.  IEEE f32 on the CUDA cores peaks
// at 67 TFLOP/s, which a tiled GEMM does not get near enough to beat cuBLAS
// f32.  The tensor cores run TF32 (10-bit mantissa) at 495 TFLOP/s dense.
// One TF32 product keeps about 3 decimal digits, which fails the f32
// kernel-vs-plain tolerance at s = 16384, so every f32 value
// x is split once, as its fragment is loaded, into big = x rounded to TF32
// (to nearest, ties away from zero, as cvt.rna does) and small = x - big,
// and each k8 step issues three MMAs into one f32 accumulator, small terms
// first: a_small*b_big, a_big*b_small, a_big*b_big.  That keeps f32
// accuracy (big*big and the two cross terms carry about 21 of x's 24
// bits).  A bf16 value is exact in TF32, so its small part is 0 and its
// cross term is not issued: bf16 x bf16 is one MMA a step, f32 x bf16 two.
//
// Why the split is done with integer operations.  The split runs on every
// fragment element a warp loads, and the kernel is bound by the issue of
// these instructions beside its MMAs.  cvt.rna.tf32.f32 does not issue at
// the full rate; adding half of the 13 dropped bits to the bit pattern and
// clearing them gives the same value with two integer operations.  small =
// x - big is exact in f32 and goes to the MMA as it is: the tensor core
// reads the top 19 bits of a TF32 operand, so small is truncated to TF32.
// chip_variants.py times this split against cvt.rna on the card.
//
// Why mma.sync and not wgmma.  out[p, q] = sum_k A[k, p] * B[k, q] reads
// both operands MN-major (A is (s, r), B is (s, t), both row-major).
// wgmma takes MN-major operands only for 16-bit types; for tf32 it needs
// K-major tiles, which would need a transposing copy into shared memory.
// mma.sync fragments are loaded by the threads from shared memory, so any
// layout works.
//
// Why the MMA sum is promoted.  The tensor cores add into their f32
// accumulator with truncation, not round-to-nearest, so the error of a long
// MMA sum is biased and grows with s, not with its square root: summed in
// the MMA accumulator over all of s = 16384, the error reaches about half
// of chip_smoke.py's f32 tolerance (chip_variants.py measures it).  So the
// MMAs sum only PROMOTE chunks of s (128 rows, 48 truncated adds for f32)
// at a time, and each such span is added into a second register total,
// round-to-nearest.
//
// Design:
//   * one block of 256 threads (8 warps, 2 along br x 4 along bt) owns a
//     128 x 128 tile of the output; a warp owns 64 x 32 of it, as 4 x 4
//     m16n8k8 tiles: 64 MMA accumulators and 64 totals a thread, so one
//     block an SM (the registers of two would not fit);
//   * s is walked in chunks of BK = 32 rows through a ring of 3 stages in
//     dynamic shared memory, filled by cp.async (wait_group(1), one barrier
//     a chunk), so two chunks are in flight while one is multiplied;
//     3 x 32 x (136 + 136) x 4 B = 102 KB for f32;
//   * each staged row holds the tile's 128 columns plus 8 of padding, so
//     the row stride is 8 mod 32 words: the fragment read of lane
//     (g, t) = (lane / 4, lane % 4) at [t][g] falls on bank 8t + g, free of
//     conflicts (bf16 rows: 4t + g/2, two lanes a word, a broadcast);
//   * copies: the wide path issues 16-byte cp.async.cg copies (4 f32 or
//     8 bf16 a copy) with the source size 0 past s, br or bt, which fills
//     zeros; it needs every row, block and column offset on 16 bytes.  The
//     narrow path, for other shapes, copies one element at a time
//     (cp.async.ca of 4 bytes for f32, a plain load and store for bf16).
//     The wrapper picks the path from the shapes (coded_accum.py,
//     copy_path); both are instances of this one kernel;
//   * the running sum lives in the output itself: each element is read and
//     written only by the thread whose accumulator holds it (no race), and
//     a block with no live slot writes zeros;
//   * every edge (br, bt, s) is masked, so br = 8, bt = 12 work as they are.
//
// Bound on an H100 SXM: 2*s*br*bt FLOPs per live slot, against reading
// each distinct A and B column block once and writing out once: at full
// width (s = 16384, br = bt = 4096) about 4000 FLOPs a byte, so the bound
// is the operations, three TF32 passes at 495 TFLOP/s (13.3 ms for the
// main path's heaviest worker, 2.2 TFLOP).  What bounds it in practice is
// the issue rate of mma.sync and of the loads and splits beside it: 495
// TFLOP/s is wgmma's rate.  Measured on an NVIDIA H100 80GB HBM3 at a
// 700 W power limit (chip_smoke.py, chip_variants.py): ptxas gives the 8
// instances 233-255 registers and no spills; that worker takes 34.4 ms
// (64 TFLOP/s), against 42.0 ms for cuBLAS f32; one TF32 pass alone takes
// 16.6-18.0 ms and each further pass 8-9 ms.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // output rows (along br) of a block
constexpr int BN = 128;        // output columns (along bt) of a block
constexpr int BK = 32;         // rows of s per stage
constexpr int STAGES = 3;      // the cp.async ring
constexpr int PROMOTE = 4;     // chunks the MMAs sum before an IEEE add (128 rows)
constexpr int THREADS = 256;   // 8 warps: 2 along br x 4 along bt
constexpr int WM = 64;         // a warp's output rows
constexpr int WN = 32;         // a warp's output columns
constexpr int MT = WM / 16;    // m16 tiles of a warp
constexpr int NT = WN / 8;     // n8 tiles of a warp
constexpr int LD = BM + 8;     // staged row stride in elements (BM == BN)
static_assert(BM == BN, "one staged row width for A and B");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// x as a TF32 operand, rounded to nearest with ties away from zero (the
// value cvt.rna.tf32.f32 gives, for finite x); for f32 also the remainder
// x - big, which the MMA truncates to TF32
template <typename T>
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  if constexpr (sizeof(T) == 4) {
    big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(x - __uint_as_float(big));
  } else {
    big = __float_as_uint(x);  // a bf16 value is exact in TF32
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows k0..k0+BK-1 of the 128 columns X[:, col0:+128] into one stage
// [BK][LD]; zeros past row s and past column col0 + live.
template <typename T, bool WIDE>
__device__ __forceinline__ void stage_tile(T* dst, const T* X, int64_t stride,
                                           int64_t col0, int live, int k0, int s,
                                           int tid) {
  if constexpr (WIDE) {
    constexpr int VEC = 16 / sizeof(T);    // elements a copy
    constexpr int CPR = BM / VEC;          // copies a row
#pragma unroll
    for (int u = 0; u < BK * CPR / THREADS; ++u) {
      const int c = tid + u * THREADS;
      const int row = c / CPR, col = (c % CPR) * VEC;
      const int k = k0 + row;
      const bool valid = k < s && col < live;   // whole copies: live % VEC == 0
      const T* src = valid ? X + static_cast<int64_t>(k) * stride + col0 + col : X;
      cp_async_16(dst + row * LD + col, src, valid);
    }
  } else {
#pragma unroll
    for (int u = 0; u < BK * BM / THREADS; ++u) {
      const int c = tid + u * THREADS;
      const int row = c / BM, col = c % BM;
      const int k = k0 + row;
      const bool valid = k < s && col < live;
      const T* src = valid ? X + static_cast<int64_t>(k) * stride + col0 + col : X;
      if constexpr (sizeof(T) == 4) {
        cp_async_4(dst + row * LD + col, src, valid);
      } else {  // cp.async copies 4, 8 or 16 bytes: a bf16 goes by registers
        const uint16_t v = valid ? *reinterpret_cast<const uint16_t*>(src) : 0;
        *reinterpret_cast<uint16_t*>(dst + row * LD + col) = v;
      }
    }
  }
}

template <typename TA, typename TB, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1) coded_accum_kernel(
    const TA* __restrict__ A,            // (s, r)
    const TB* __restrict__ B,            // (s, t)
    const int32_t* __restrict__ cols,    // (L,) block ids in [0, m*n)
    const float* __restrict__ weights,   // (L,)
    float* __restrict__ out,             // (br, bt)
    int s, int r, int t, int br, int bt, int n, int L) {
  constexpr bool A_SPLIT = sizeof(TA) == 4;   // f32: a nonzero small part
  constexpr bool B_SPLIT = sizeof(TB) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  TA* As = reinterpret_cast<TA*>(smem);                                 // [STAGES][BK][LD]
  TB* Bs = reinterpret_cast<TB*>(smem + STAGES * BK * LD * sizeof(TA));  // [STAGES][BK][LD]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tg = lane % 4;
  const int wm = (warp / 4) * WM, wn = (warp % 4) * WN;
  const int p0 = blockIdx.y * BM, q0 = blockIdx.x * BN;
  const int a_live = br - p0, b_live = bt - q0;
  const int nk = (s + BK - 1) / BK;

  float acc[MT][NT][4];   // the MMAs' sum over the current PROMOTE chunks
  float tot[MT][NT][4];   // the slot's partial product, summed round-to-nearest
  bool written = false;
  for (int l = 0; l < L; ++l) {
    const float w = weights[l];
    if (w == 0.0f) continue;  // a pad: the same for every thread of the block
    const int c = cols[l];
    const int i = c / n, j = c - i * n;
    const int64_t a_col0 = static_cast<int64_t>(i) * br + p0;
    const int64_t b_col0 = static_cast<int64_t>(j) * bt + q0;

#pragma unroll
    for (int x = 0; x < MT; ++x)
#pragma unroll
      for (int y = 0; y < NT; ++y)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[x][y][e] = tot[x][y][e] = 0.0f;

    __syncthreads();  // every warp is done with the previous slot's stages
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < nk) {
        stage_tile<TA, WIDE>(As + st * BK * LD, A, r, a_col0, a_live, st * BK, s, tid);
        stage_tile<TB, WIDE>(Bs + st * BK * LD, B, t, b_col0, b_live, st * BK, s, tid);
      }
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of chunk kt landed
      __syncthreads();              // everyone's did; chunk kt-1 is consumed
      const int nxt = kt + STAGES - 1;
      if (nxt < nk) {               // into the stage chunk kt-1 held
        const int st = nxt % STAGES;
        stage_tile<TA, WIDE>(As + st * BK * LD, A, r, a_col0, a_live, nxt * BK, s, tid);
        stage_tile<TB, WIDE>(Bs + st * BK * LD, B, t, b_col0, b_live, nxt * BK, s, tid);
      }
      cp_async_commit();

      const TA* as = As + (kt % STAGES) * BK * LD;
      const TB* bs = Bs + (kt % STAGES) * BK * LD;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t b_big[NT][2], b_small[NT][2];
#pragma unroll
        for (int y = 0; y < NT; ++y) {
          const int q = wn + y * 8 + g;
          split<TB>(to_f32(bs[(kk + tg) * LD + q]), b_big[y][0], b_small[y][0]);
          split<TB>(to_f32(bs[(kk + tg + 4) * LD + q]), b_big[y][1], b_small[y][1]);
        }
#pragma unroll
        for (int x = 0; x < MT; ++x) {
          const int p = wm + x * 16 + g;
          uint32_t a_big[4], a_small[4];
          split<TA>(to_f32(as[(kk + tg) * LD + p]), a_big[0], a_small[0]);
          split<TA>(to_f32(as[(kk + tg) * LD + p + 8]), a_big[1], a_small[1]);
          split<TA>(to_f32(as[(kk + tg + 4) * LD + p]), a_big[2], a_small[2]);
          split<TA>(to_f32(as[(kk + tg + 4) * LD + p + 8]), a_big[3], a_small[3]);
#pragma unroll
          for (int y = 0; y < NT; ++y) {
            if constexpr (A_SPLIT) mma_tf32(acc[x][y], a_small, b_big[y]);
            if constexpr (B_SPLIT) mma_tf32(acc[x][y], a_big, b_small[y]);
            mma_tf32(acc[x][y], a_big, b_big[y]);
          }
        }
      }
      if ((kt + 1) % PROMOTE == 0 || kt + 1 == nk) {
#pragma unroll
        for (int x = 0; x < MT; ++x)
#pragma unroll
          for (int y = 0; y < NT; ++y)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tot[x][y][e] = __fadd_rn(tot[x][y][e], acc[x][y][e]);
              acc[x][y][e] = 0.0f;
            }
      }
    }
    cp_async_wait<0>();  // only empty groups remain; none spills into the next slot

    // out += w * partial, each element by the thread whose accumulator holds it
#pragma unroll
    for (int x = 0; x < MT; ++x) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + wm + x * 16 + g + 8 * h;
        if (p >= br) continue;
        float* orow = out + static_cast<int64_t>(p) * bt;
#pragma unroll
        for (int y = 0; y < NT; ++y) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = q0 + wn + y * 8 + 2 * tg + e;
            if (q >= bt) continue;
            const float term = __fmul_rn(w, tot[x][y][2 * h + e]);
            orow[q] = written ? __fadd_rn(orow[q], term) : term;
          }
        }
      }
    }
    written = true;
  }
  if (written) return;
  // no live slot: the sum is empty
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int p = p0 + e / BN, q = q0 + e % BN;
    if (p < br && q < bt) out[static_cast<int64_t>(p) * bt + q] = 0.0f;
  }
}

template <typename TA, typename TB, bool WIDE>
int launch_typed(const void* A, const void* B, const int32_t* cols,
                 const float* weights, float* out, int s, int r, int t, int br,
                 int bt, int n, int L, cudaStream_t stream) {
  const auto kernel = coded_accum_kernel<TA, TB, WIDE>;
  const int smem = STAGES * BK * LD * static_cast<int>(sizeof(TA) + sizeof(TB));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((bt + BN - 1) / BN, (br + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const TA*>(A), static_cast<const TB*>(B), cols, weights, out,
      s, r, t, br, bt, n, L);
  return static_cast<int>(cudaGetLastError());
}

template <bool WIDE>
int launch_path(const void* A, int a_dtype, const void* B, int b_dtype,
                const int32_t* cols, const float* weights, float* out, int s,
                int r, int t, int br, int bt, int n, int L, cudaStream_t st) {
#define REPRO_LAUNCH(TA_, TB_) \
  return launch_typed<TA_, TB_, WIDE>(A, B, cols, weights, out, s, r, t, br, bt, n, L, st)
  if (a_dtype == 0 && b_dtype == 0) REPRO_LAUNCH(float, float);
  if (a_dtype == 0 && b_dtype == 1) REPRO_LAUNCH(float, __nv_bfloat16);
  if (a_dtype == 1 && b_dtype == 0) REPRO_LAUNCH(__nv_bfloat16, float);
  if (a_dtype == 1 && b_dtype == 1) REPRO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef REPRO_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// a_dtype, b_dtype: 0 = float32, 1 = bfloat16.  wide: 1 = 16-byte copies
// (every row, block and column offset of A and B on 16 bytes), 0 = one
// element a copy.
int coded_accum(const void* A, int a_dtype, const void* B, int b_dtype,
                const int32_t* cols, const float* weights, float* out, int s,
                int r, int t, int br, int bt, int n, int L, int wide,
                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide)
    return launch_path<true>(A, a_dtype, B, b_dtype, cols, weights, out, s, r, t,
                             br, bt, n, L, st);
  return launch_path<false>(A, a_dtype, B, b_dtype, cols, weights, out, s, r, t,
                            br, bt, n, L, st);
}

}  // extern "C"
