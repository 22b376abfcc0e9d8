// Dense coded accumulation for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/coded_accum.py (coded_accum,
// body _kernel).  What it computes, for one worker's task table:
//   out (br, bt) = sum_l weights[l] * A[:, i_l*br:+br]^T @ B[:, j_l*bt:+bt]
// with (i_l, j_l) = divmod(cols[l], n), br = r/m, bt = t/n, A (s, r) and
// B (s, t) row-major, f32 or bf16 (upcast here), accumulated in f32.  A slot
// of weight 0 is a pad and adds nothing.
//
// Design (simple and right first): the classic shared-memory-tiled,
// register-blocked GEMM on the CUDA cores in IEEE f32 (no TF32):
//   * one thread block of 256 threads owns one 128 x 128 tile of the output;
//     each thread owns an 8 x 8 micro-tile, rows and columns in two runs of
//     four 64 apart, so a quarter-warp's float4 reads of shared memory cover
//     128 contiguous bytes;
//   * the block walks the L slots in order and skips a slot of weight 0 (the
//     same for every thread);
//   * per slot it walks s in chunks of 16 rows: A[k0:+16, i*br + tile] and
//     B[k0:+16, j*bt + tile] are contiguous along r and t, so each warp's
//     loads coalesce; they are staged in shared memory (upcast to f32), and
//     the next chunk's loads are issued into registers before the current
//     chunk is multiplied;
//   * per slot, out += w * partial (the order of _kernel, a slot's partial
//     product over all of s first).  The running sum lives in the output
//     itself: each element is read and written only by the thread that owns
//     it, so no second register accumulator is needed and two blocks fit on
//     an SM (at 128 registers ptxas spills a few hundred bytes; one block
//     an SM without spills, and dropping the register prefetch, both ran
//     slower on an H100);
//   * every edge (br, bt, s) is masked, so br = 8, bt = 12 work as they are.
//
// Bound on an H100 SXM: 2*s*br*bt FLOPs per live slot against reading each
// distinct A and B column block once and writing out once: at full width
// (s = 16384, br = bt = 4096) about 4000 FLOPs a byte, far above the f32
// ridge (20 FLOPs a byte), so the bound is the operations at 67 TFLOP/s.
// wgmma, TMA and bf16 tensor cores are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // output rows (along br) of a block
constexpr int BN = 128;       // output columns (along bt) of a block
constexpr int BK = 16;        // rows of s per staged chunk
constexpr int THREADS = 256;  // 16 x 16 threads, an 8 x 8 micro-tile each
constexpr int TM = 8;
constexpr int PASS = THREADS / BM;     // chunk rows one pass of loads covers
constexpr int LOADS = BK * BM / THREADS;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// tile row (or column) of micro-tile entry e of thread coordinate tq
__device__ __forceinline__ int micro(int tq, int e) {
  return (e < 4 ? 0 : 64) + tq * 4 + (e & 3);
}

// rows k0 + lk, k0 + lk + PASS, ... of one column of a chunk, zero past s or
// past the block's live columns
template <typename T>
__device__ __forceinline__ void fetch(float (&reg)[LOADS], const T* col_ptr,
                                      bool live_col, int k0, int lk, int s,
                                      int64_t stride) {
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int k = k0 + lk + PASS * u;
    reg[u] = (live_col && k < s) ? to_f32(col_ptr[static_cast<int64_t>(k) * stride])
                                 : 0.0f;
  }
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(THREADS, 2) coded_accum_kernel(
    const TA* __restrict__ A,            // (s, r)
    const TB* __restrict__ B,            // (s, t)
    const int32_t* __restrict__ cols,    // (L,) block ids in [0, m*n)
    const float* __restrict__ weights,   // (L,)
    float* __restrict__ out,             // (br, bt)
    int s, int r, int t, int br, int bt, int n, int L) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int p0 = blockIdx.y * BM, q0 = blockIdx.x * BN;
  const int lc = tid % BM, lk = tid / BM;   // this thread's loads
  const bool a_live = p0 + lc < br, b_live = q0 + lc < bt;

  bool written = false;
  for (int l = 0; l < L; ++l) {
    const float w = weights[l];
    if (w == 0.0f) continue;  // a pad: the same for every thread of the block
    const int c = cols[l];
    const int i = c / n, j = c - i * n;
    const TA* a_col = A + static_cast<int64_t>(i) * br + p0 + lc;
    const TB* b_col = B + static_cast<int64_t>(j) * bt + q0 + lc;

    float part[TM][TM];
#pragma unroll
    for (int x = 0; x < TM; ++x)
#pragma unroll
      for (int y = 0; y < TM; ++y) part[x][y] = 0.0f;

    float ra[LOADS], rb[LOADS];
    fetch(ra, a_col, a_live, 0, lk, s, r);
    fetch(rb, b_col, b_live, 0, lk, s, t);
    for (int k0 = 0; k0 < s; k0 += BK) {
      __syncthreads();  // every thread is done with the previous chunk
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        As[lk + PASS * u][lc] = ra[u];
        Bs[lk + PASS * u][lc] = rb[u];
      }
      __syncthreads();
      if (k0 + BK < s) {  // the next chunk's loads fly while this one is used
        fetch(ra, a_col, a_live, k0 + BK, lk, s, r);
        fetch(rb, b_col, b_live, k0 + BK, lk, s, t);
      }
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
        const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[TM] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int x = 0; x < TM; ++x)
#pragma unroll
          for (int y = 0; y < TM; ++y) part[x][y] = __fmaf_rn(av[x], bv[y], part[x][y]);
      }
    }

    // out += w * partial, each element by the thread that owns it
#pragma unroll
    for (int x = 0; x < TM; ++x) {
      const int p = p0 + micro(ty, x);
      if (p >= br) continue;
      float* orow = out + static_cast<int64_t>(p) * bt;
#pragma unroll
      for (int y = 0; y < TM; ++y) {
        const int q = q0 + micro(tx, y);
        if (q >= bt) continue;
        const float term = __fmul_rn(w, part[x][y]);
        orow[q] = written ? __fadd_rn(orow[q], term) : term;
      }
    }
    written = true;
  }
  if (written) return;
  // no live slot: the sum is empty
#pragma unroll
  for (int x = 0; x < TM; ++x) {
    const int p = p0 + micro(ty, x);
    if (p >= br) continue;
#pragma unroll
    for (int y = 0; y < TM; ++y) {
      const int q = q0 + micro(tx, y);
      if (q < bt) out[static_cast<int64_t>(p) * bt + q] = 0.0f;
    }
  }
}

template <typename TA, typename TB>
int launch_typed(const void* A, const void* B, const int32_t* cols,
                 const float* weights, float* out, int s, int r, int t, int br,
                 int bt, int n, int L, cudaStream_t stream) {
  const dim3 grid((bt + BN - 1) / BN, (br + BM - 1) / BM);
  coded_accum_kernel<TA, TB><<<grid, THREADS, 0, stream>>>(
      static_cast<const TA*>(A), static_cast<const TB*>(B), cols, weights, out,
      s, r, t, br, bt, n, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a_dtype, b_dtype: 0 = float32, 1 = bfloat16
int coded_accum(const void* A, int a_dtype, const void* B, int b_dtype,
                const int32_t* cols, const float* weights, float* out, int s,
                int r, int t, int br, int bt, int n, int L, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(TA_, TB_) \
  return launch_typed<TA_, TB_>(A, B, cols, weights, out, s, r, t, br, bt, n, L, st)
  if (a_dtype == 0 && b_dtype == 0) REPRO_LAUNCH(float, float);
  if (a_dtype == 0 && b_dtype == 1) REPRO_LAUNCH(float, __nv_bfloat16);
  if (a_dtype == 1 && b_dtype == 0) REPRO_LAUNCH(__nv_bfloat16, float);
  if (a_dtype == 1 && b_dtype == 1) REPRO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef REPRO_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
