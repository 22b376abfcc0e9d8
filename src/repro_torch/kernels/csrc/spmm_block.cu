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
// Design (simple and right first):
//   * one thread block owns one (cb, t-tile) of the output; blockDim.x is the
//     t-tile width and each thread owns one output column and bs f32
//     accumulators in registers;
//   * the block walks the L slots in order.  Each thread reads the slot's
//     src and weight itself (one address for the whole block; this replaces
//     the TPU's scalar prefetch) and a slot of weight 0 (a pad, or a slot a
//     partial-straggler rebind masked) is skipped by the whole block;
//   * the bs x bs tile of A is staged in shared memory, upcast to f32
//     (f32, bf16 or int8 tiles);
//   * each thread reads the bs rows of B of its column: neighbouring threads
//     on neighbouring columns, so a warp reads 128 contiguous bytes a row;
//   * acc[o] += w * (sum_i tile[i][o] * b[i]) in IEEE f32 on the CUDA cores
//     (explicit _rn intrinsics: no TF32, no contraction that could differ
//     between the two forms), the order of _fused_kernel;
//   * the ragged t edge (bt not a multiple of the t-tile, e.g. a prime bt)
//     is masked here, so the caller pads nothing.
//   bs = 8 (the default) is below the tensor cores' minimum depth, so this is
//   an FMA kernel.
//
// Bound on an H100 SXM (3.35 TB/s HBM, about 67 TFLOP/s of f32 on the CUDA
// cores): per live slot the kernel does 2*bs^2*bt FLOPs and, with no reuse
// of B between blocks, moves bs^2*sizeof(vals) + bs*bt*4 bytes, so it moves
//   live_tiles * (bs^2*sizeof(vals) + bs*bt*4) + output bytes
// against live_tiles * 2*bs^2*bt FLOPs: at bs = 8 that is 4 FLOPs a byte,
// far below the f32 ridge (20 FLOPs a byte), so this design is bound by the
// bytes it moves.  The least any kernel must move reads each input once
// (each distinct B tile once), which puts the true bound on the FLOPs; closing
// that gap (B tiles shared across the column blocks that use them, tensor
// cores for bs >= 16, the worker sum in the kernel) waits for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

template <int BS, typename TV, bool DECODE, bool PLAIN = false>
__global__ void spmm_block_fused_kernel(
    const TV* __restrict__ vals,      // (CB, L, BS, BS)
    const int32_t* __restrict__ src,  // (CB, L, 2) [row-block of B, column group];
                                      // PLAIN: (CB, L) row-block of B
    const float* __restrict__ wslot,  // (CB, L); unused when PLAIN
    const float* __restrict__ dvec,   // (mn,) when DECODE
    const float* __restrict__ B,      // (s, t) row-major
    float* __restrict__ out,          // (CB*BS, bt) or (mn, CB*BS, bt)
    int CB, int L, int t, int bt, int mn) {
  __shared__ float tile[BS * BS];
  const int cb = blockIdx.x;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live_col = col < bt;

  float acc[BS];
#pragma unroll
  for (int o = 0; o < BS; ++o) acc[o] = 0.0f;

  for (int l = 0; l < L; ++l) {
    const int64_t slot = static_cast<int64_t>(cb) * L + l;
    float w = 1.0f;
    int64_t rb, grp = 0;
    if constexpr (PLAIN) {
      rb = src[slot];
    } else {
      w = wslot[slot];
      if (w == 0.0f) continue;  // the same for every thread of the block
      rb = src[2 * slot];
      grp = src[2 * slot + 1];
    }
    __syncthreads();  // the previous slot's tile has been consumed
    for (int e = threadIdx.x; e < BS * BS; e += blockDim.x)
      tile[e] = to_f32(vals[slot * (BS * BS) + e]);
    __syncthreads();
    if (live_col) {
      const float* brow = B + rb * BS * static_cast<int64_t>(t) + grp * bt + col;
      float b[BS];
#pragma unroll
      for (int i = 0; i < BS; ++i) b[i] = brow[static_cast<int64_t>(i) * t];
#pragma unroll
      for (int o = 0; o < BS; ++o) {
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < BS; ++i) dot = __fmaf_rn(tile[i * BS + o], b[i], dot);
        if constexpr (PLAIN) {
          acc[o] = __fadd_rn(acc[o], dot);
        } else {
          acc[o] = __fadd_rn(acc[o], __fmul_rn(w, dot));
        }
      }
    }
  }
  if (!live_col) return;

  const int64_t rows = static_cast<int64_t>(CB) * BS;
  const int64_t row0 = static_cast<int64_t>(cb) * BS;
  if constexpr (DECODE) {
    // epilogue: the decode combine, mn decode-weighted copies of acc
    for (int c = 0; c < mn; ++c) {
      const float d = dvec[c];
      float* o_c = out + (c * rows + row0) * bt + col;
#pragma unroll
      for (int o = 0; o < BS; ++o) o_c[static_cast<int64_t>(o) * bt] = __fmul_rn(d, acc[o]);
    }
  } else {
    float* o_0 = out + row0 * bt + col;
#pragma unroll
    for (int o = 0; o < BS; ++o) o_0[static_cast<int64_t>(o) * bt] = acc[o];
  }
}

template <int BS, typename TV, bool DECODE, bool PLAIN>
int launch_typed(const void* vals, const int32_t* src, const float* wslot,
                 const float* dvec, const float* B, float* out, int CB, int L,
                 int t, int bt, int mn, int t_tile, cudaStream_t stream) {
  const dim3 grid(CB, (bt + t_tile - 1) / t_tile);
  spmm_block_fused_kernel<BS, TV, DECODE, PLAIN><<<grid, t_tile, 0, stream>>>(
      static_cast<const TV*>(vals), src, wslot, dvec, B, out, CB, L, t, bt, mn);
  return static_cast<int>(cudaGetLastError());
}

// vals_dtype: 0 = float32, 1 = bfloat16, 2 = int8
template <bool DECODE, bool PLAIN = false>
int launch(const void* vals, int vals_dtype, int bs, const int32_t* src,
           const float* wslot, const float* dvec, const float* B, float* out,
           int CB, int L, int t, int bt, int mn, int t_tile, cudaStream_t stream) {
#define REPRO_LAUNCH(BS_, TV_)                                                  \
  return launch_typed<BS_, TV_, DECODE, PLAIN>(vals, src, wslot, dvec, B, out,  \
                                               CB, L, t, bt, mn, t_tile, stream)
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

}  // namespace

extern "C" {

int spmm_block_fused(const void* vals, int vals_dtype, int bs, const int32_t* src,
                     const float* wslot, const float* B, float* out, int CB, int L,
                     int t, int bt, int t_tile, void* stream) {
  return launch<false>(vals, vals_dtype, bs, src, wslot, nullptr, B, out, CB, L,
                       t, bt, 0, t_tile, static_cast<cudaStream_t>(stream));
}

int spmm_block_fused_decode(const void* vals, int vals_dtype, int bs,
                            const int32_t* src, const float* wslot,
                            const float* dvec, const float* B, float* out, int CB,
                            int L, int t, int bt, int mn, int t_tile, void* stream) {
  return launch<true>(vals, vals_dtype, bs, src, wslot, dvec, B, out, CB, L, t, bt,
                      mn, t_tile, static_cast<cudaStream_t>(stream));
}

int spmm_block(const void* vals, int vals_dtype, int bs, const int32_t* idx,
               const float* B, float* out, int CB, int L, int t, int t_tile,
               void* stream) {
  return launch<false, true>(vals, vals_dtype, bs, idx, nullptr, nullptr, B, out,
                             CB, L, t, /*bt=*/t, 0, t_tile,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
