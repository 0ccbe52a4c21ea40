// Kernel K5: vocab projection + top-k + logsumexp.  C interface for ops/vocab_topk.py (ctypes).
// Replaces vocab_topk_pallas (speech_recognition_tpu/ops/pallas/topk_kernel.py:176): the tile pass of
// vocab_topk.cuh, then vocab_merge_kernel, one warp per row, merges each row's partials.
#include "vocab_topk.cuh"

namespace srt {

__global__ void vocab_merge_kernel(int R, int n_tiles, int k, const float* __restrict__ part_val,
                                   const int* __restrict__ part_idx, const float* __restrict__ part_max,
                                   const float* __restrict__ part_sum, float* __restrict__ vals,
                                   int* __restrict__ idx, float* __restrict__ lse) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= R) return;  // whole warps leave together
  const float l = merge_row((size_t)row, n_tiles, k, part_val, part_idx, part_max, part_sum,
                            [&](int q, float v, int i) {
                              if (lane == 0) {
                                vals[(size_t)row * k + q] = v;
                                idx[(size_t)row * k + q] = i;
                              }
                            });
  if (lane == 0) lse[row] = l;
}

template <typename T, typename BT>
cudaError_t vocab_topk_impl(const void* hid, const void* W, const void* bias, int R, int H, int V, int k,
                            int rounding, const TilePlan& plan, float* part_val, int* part_idx, float* part_max,
                            float* part_sum, float* vals, int* idx, float* lse, const int* run_flag,
                            cudaStream_t stream) {
  cudaError_t err = launch_vocab_tiles<T, BT>(static_cast<const T*>(hid), static_cast<const T*>(W),
                                              static_cast<const BT*>(bias), R, H, V, k, rounding, plan, part_val,
                                              part_idx, part_max, part_sum, stream, run_flag);
  if (err != cudaSuccess) return err;
  const int n_tiles = (V + VOCAB_TILE - 1) / VOCAB_TILE;
  const int threads = 256;
  const int blocks = (int)(((size_t)R * 32 + threads - 1) / threads);
  vocab_merge_kernel<<<blocks, threads, 0, stream>>>(R, n_tiles, k, part_val, part_idx, part_max, part_sum, vals,
                                                     idx, lse);
  return cudaGetLastError();
}

}  // namespace srt

extern "C" {

const char* kernels_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// hid [R,H], W [H,V] in bf16 (dtype_bf16) or float32; bias [V] float32 when
// bias_f32, else hid's type.  Outputs vals/idx [R,k], lse [R]; part_* are
// [R, ceil(V/VOCAB_TILE), k] (val/idx) and [R, ceil(V/VOCAB_TILE)] scratch.
// wgs, stage_k, tiles_per_block: the bf16 plan (ops/vocab_topk.py tile_plan).
// run_flag (device int or NULL): the tile pass writes nothing where it is 0.
int vocab_topk(int dtype_bf16, int bias_f32, const void* hid, const void* W, const void* bias, int R, int H, int V,
               int k, int rounding, int wgs, int stage_k, int tiles_per_block, float* part_val, int* part_idx,
               float* part_max, float* part_sum, float* vals, int* idx, float* lse, const int* run_flag,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const srt::TilePlan plan{wgs, stage_k, tiles_per_block};
  cudaError_t err;
  if (dtype_bf16 && bias_f32)
    err = srt::vocab_topk_impl<__nv_bfloat16, float>(hid, W, bias, R, H, V, k, rounding, plan, part_val, part_idx,
                                                     part_max, part_sum, vals, idx, lse, run_flag, st);
  else if (dtype_bf16)
    err = srt::vocab_topk_impl<__nv_bfloat16, __nv_bfloat16>(hid, W, bias, R, H, V, k, rounding, plan, part_val,
                                                             part_idx, part_max, part_sum, vals, idx, lse, run_flag,
                                                             st);
  else
    err = srt::vocab_topk_impl<float, float>(hid, W, bias, R, H, V, k, rounding, plan, part_val, part_idx, part_max,
                                             part_sum, vals, idx, lse, run_flag, st);
  return static_cast<int>(err);
}

}  // extern "C"
