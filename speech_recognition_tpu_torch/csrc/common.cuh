// Shared device helpers of the port's kernels: type conversion, bf16 rounding,
// the top-k ranking order and warp/block reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace srt {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// x rounded to T's grid (round to nearest even), kept in float
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float bf16_grid(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// lax.top_k's ranking: value descending, then lower index first
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide max or sum of one value per thread; ``red`` holds >= 33 floats
// of shared memory.  Every thread of the block must call it.
__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < n_warps ? red[lane] : (is_max ? -INFINITY : 0.0f);
    t = is_max ? warp_max(t) : warp_sum(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  const float out = red[32];
  __syncthreads();
  return out;
}

}  // namespace srt
