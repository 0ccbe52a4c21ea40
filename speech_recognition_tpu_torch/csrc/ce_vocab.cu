// Kernel K1: the vocab projection fused with masked cross-entropy, forward and
// backward.  C interface for ops/ce_vocab.py (ctypes).
// Replaces fused_ce_vocab (speech_recognition_tpu/ops/pallas/ce_kernel.py:201;
// bodies _fwd_kernel :60 and _bwd_kernel :82).
//
// logits = hid @ W + b in float32 over R = N*B rows; they never reach device
// memory (1 GB in float32 at R=16256, V=16000), which is K1's reason to exist.
//
// Forward: the vocab tile pass (vocab_topk.cuh) with k = 1, no rounding and
// the labels as its gather hook (one id per row): each row's per-tile (max,
// sum-exp, first argmax) and its label's logit, copied out of the tile that
// holds it, so it is the same float the logsumexp saw; ce_merge_kernel merges
// the partials into the logsumexp and the first argmax (ties to the lower
// index, as jnp.argmax).  In bf16 the product runs on wgmma, in float32 on
// the CUDA cores.
//
// Backward: K6's backward (ctc_emissions.cu) with one id per row: ids = y,
// T = 1, K = 1 and emission cotangents -dnll, so that
// dlog = -dnll [v == y] + softmax * dnll = (softmax - onehot) * dnll.
// What bounds it: the forward is a 2*R*H*V = 133 GFLOP product at LAS-small
// (0.13 ms at the bf16 tensor-core peak), the backward three of them.
#include "vocab_topk.cuh"

namespace srt {

__global__ void ce_merge_kernel(int R, int n_tiles, const float* __restrict__ part_val,
                                const int* __restrict__ part_idx, const float* __restrict__ part_max,
                                const float* __restrict__ part_sum, float* __restrict__ lse, int* __restrict__ pred) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const float l = merge_row((size_t)row, n_tiles, 1, part_val, part_idx, part_max, part_sum, [&](int, float, int i) {
    if (lane == 0) pred[row] = i;
  });
  if (lane == 0) lse[row] = l;
}

template <typename T>
cudaError_t ce_fwd_impl(const void* hid, const void* W, const void* b, const int* y, int R, int H, int V,
                        const TilePlan& plan, float* part_val, int* part_idx, float* part_max, float* part_sum,
                        float* lse, float* lab, int* pred, cudaStream_t stream) {
  cudaError_t err = launch_vocab_tiles<T, T>(static_cast<const T*>(hid), static_cast<const T*>(W),
                                             static_cast<const T*>(b), R, H, V, 1, ROUND_NONE, plan, part_val,
                                             part_idx, part_max, part_sum, stream, nullptr, Gather{y, lab, 1, 1});
  if (err != cudaSuccess) return err;
  const int n_tiles = (V + VOCAB_TILE - 1) / VOCAB_TILE;
  const int threads = 256;
  ce_merge_kernel<<<(int)(((size_t)R * 32 + threads - 1) / threads), threads, 0, stream>>>(
      R, n_tiles, part_val, part_idx, part_max, part_sum, lse, pred);
  return cudaGetLastError();
}

}  // namespace srt

extern "C" {

// Forward.  hid [R,H], W [H,V], b [V] in T (bf16 when dtype_bf16, else
// float32); y [R] int32.  Outputs lse, lab [R] float32 and pred [R] int32;
// part_* are [R, ceil(V/VOCAB_TILE)] scratch; wgs, stage_k, tiles_per_block:
// the bf16 plan of the tile pass (ops/vocab_topk.py tile_plan).
int ce_vocab_fwd(int dtype_bf16, const void* hid, const void* W, const void* b, const int* y, int R, int H, int V,
                 int wgs, int stage_k, int tiles_per_block, float* part_val, int* part_idx, float* part_max,
                 float* part_sum, float* lse, float* lab, int* pred, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const srt::TilePlan plan{wgs, stage_k, tiles_per_block};
  cudaError_t err;
  if (dtype_bf16)
    err = srt::ce_fwd_impl<__nv_bfloat16>(hid, W, b, y, R, H, V, plan, part_val, part_idx, part_max, part_sum, lse,
                                          lab, pred, st);
  else
    err = srt::ce_fwd_impl<float>(hid, W, b, y, R, H, V, plan, part_val, part_idx, part_max, part_sum, lse, lab,
                                  pred, st);
  return static_cast<int>(err);
}

}  // extern "C"
