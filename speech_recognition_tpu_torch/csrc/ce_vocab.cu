// Kernel K1: the vocab projection fused with masked cross-entropy, forward and
// backward.  C interface for ops/ce_vocab.py (ctypes).
// Replaces fused_ce_vocab (speech_recognition_tpu/ops/pallas/ce_kernel.py:201;
// bodies _fwd_kernel :60 and _bwd_kernel :82).
//
// logits = hid @ W + b in float32 over R = N*B rows; they never reach device
// memory (1 GB in float32 at R=16256, V=16000), which is K1's reason to exist.
//
// Forward: K5's two passes (vocab_topk.cuh) with k = 1 and no rounding give
// each row's logsumexp and its first argmax (ties to the lower index, as
// jnp.argmax); ce_label_kernel adds the label's logit, summed in the tile
// kernel's order so that it is the same float.
//
// Backward: K6's backward (ctc_emissions.cu) with one id per row: ids = y,
// T = 1, K = 1 and emission cotangents -dnll, so that
// dlog = -dnll [v == y] + softmax * dnll = (softmax - onehot) * dnll.
// What bounds it: the forward is a 2*R*H*V = 133 GFLOP product at LAS-small,
// on the CUDA cores in float32 (67 TFLOP/s peak); tensor-core tiles are later
// work.
#include "vocab_topk.cuh"

namespace srt {

template <typename T>
__global__ void ce_label_kernel(const T* __restrict__ hid, const T* __restrict__ W, const T* __restrict__ b,
                                const int* __restrict__ y, int R, int H, int V, float* __restrict__ lab) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int v = y[r];
  if (v < 0 || v >= V) {
    lab[r] = 0.0f;
    return;
  }
  float acc = 0.0f;
  for (int h = 0; h < H; ++h) acc = fmaf(to_f(hid[(size_t)r * H + h]), to_f(W[(size_t)h * V + v]), acc);
  lab[r] = acc + to_f(b[v]);
}

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
                        float* part_val, int* part_idx, float* part_max, float* part_sum, float* lse, float* lab,
                        int* pred, cudaStream_t stream) {
  cudaError_t err = launch_vocab_tiles<T, T>(static_cast<const T*>(hid), static_cast<const T*>(W),
                                             static_cast<const T*>(b), R, H, V, 1, ROUND_NONE, part_val, part_idx,
                                             part_max, part_sum, stream);
  if (err != cudaSuccess) return err;
  const int n_tiles = (V + VOCAB_TILE - 1) / VOCAB_TILE;
  const int threads = 256;
  ce_merge_kernel<<<(int)(((size_t)R * 32 + threads - 1) / threads), threads, 0, stream>>>(
      R, n_tiles, part_val, part_idx, part_max, part_sum, lse, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_label_kernel<T><<<(R + threads - 1) / threads, threads, 0, stream>>>(
      static_cast<const T*>(hid), static_cast<const T*>(W), static_cast<const T*>(b), y, R, H, V, lab);
  return cudaGetLastError();
}

}  // namespace srt

extern "C" {

// Forward.  hid [R,H], W [H,V], b [V] in T (bf16 when dtype_bf16, else
// float32); y [R] int32.  Outputs lse, lab [R] float32 and pred [R] int32;
// part_* are [R, ceil(V/VOCAB_TILE)] scratch.
int ce_vocab_fwd(int dtype_bf16, const void* hid, const void* W, const void* b, const int* y, int R, int H, int V,
                 float* part_val, int* part_idx, float* part_max, float* part_sum, float* lse, float* lab, int* pred,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_bf16)
    err = srt::ce_fwd_impl<__nv_bfloat16>(hid, W, b, y, R, H, V, part_val, part_idx, part_max, part_sum, lse, lab,
                                          pred, st);
  else
    err = srt::ce_fwd_impl<float>(hid, W, b, y, R, H, V, part_val, part_idx, part_max, part_sum, lse, lab, pred, st);
  return static_cast<int>(err);
}

}  // extern "C"
