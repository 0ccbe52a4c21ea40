// Kernel K5: vocab projection + top-k + logsumexp, streamed over vocab tiles.
// Replaces vocab_topk_pallas (speech_recognition_tpu/ops/pallas/topk_kernel.py:176).
//
// Pass 1, vocab_tile_kernel: grid (vocab tile of VOCAB_TILE columns, block of
// VOCAB_ROWS rows), one thread per column.  The block stages its rows of
// ``hid`` in shared memory as float, transposed so that four rows load as one
// float4 broadcast; each thread accumulates its column's dot products for all
// VOCAB_ROWS rows in registers (float32, no cuBLAS), applies the bias and the
// requested bf16 rounding, and writes the logits tile back into the same
// shared memory.  Then one warp per row reduces the tile to (max, sum-exp)
// and its top-k, rank by rank: each round takes the best candidate ranked
// below the previous winner in the order (value desc, index asc), so no
// "taken" marks are needed (vocab indices are unique).  Columns >= V are
// masked, so any V works without padding.
//
// Pass 2, merge_row: one warp per row merges the n_tiles partials the same
// way into the row's top-k and logsumexp.  The greedy kernel (K4) reuses
// both passes with k = 1 and its own epilogue.
#pragma once

#include "common.cuh"

#define VOCAB_TILE 256  // = kernels.VOCAB_TILE in Python
#define VOCAB_ROWS 32
#define TILE_THREADS VOCAB_TILE

namespace srt {

enum Rounding { ROUND_NONE = 0, ROUND_ONCE = 1, ROUND_TWICE = 2 };

template <typename T, typename BT>
__global__ void __launch_bounds__(TILE_THREADS)
    vocab_tile_kernel(const T* __restrict__ hid, const T* __restrict__ W, const BT* __restrict__ bias, int R, int H,
                      int V, int k, int rounding, float* __restrict__ part_val, int* __restrict__ part_idx,
                      float* __restrict__ part_max, float* __restrict__ part_sum) {
  extern __shared__ __align__(16) float smem[];  // VOCAB_ROWS * max(H, VOCAB_TILE) floats
  const int tile = blockIdx.x, n_tiles = gridDim.x;
  const int r0 = blockIdx.y * VOCAB_ROWS;
  const int rows = min(VOCAB_ROWS, R - r0);
  const int tid = threadIdx.x;

  // stage hid rows transposed: smem[h * VOCAB_ROWS + r]
  for (int e = tid; e < VOCAB_ROWS * H; e += blockDim.x) {
    const int r = e / H, h = e - r * H;
    smem[h * VOCAB_ROWS + r] = r < rows ? to_f(hid[(size_t)(r0 + r) * H + h]) : 0.0f;
  }
  __syncthreads();

  const int v = tile * VOCAB_TILE + tid;
  float acc[VOCAB_ROWS];
#pragma unroll
  for (int r = 0; r < VOCAB_ROWS; ++r) acc[r] = 0.0f;
  if (v < V) {
    const T* wcol = W + v;
    for (int h = 0; h < H; ++h) {
      const float w = to_f(wcol[(size_t)h * V]);
      const float4* hr = reinterpret_cast<const float4*>(smem + h * VOCAB_ROWS);
#pragma unroll
      for (int r4 = 0; r4 < VOCAB_ROWS / 4; ++r4) {
        const float4 x = hr[r4];
        acc[4 * r4 + 0] = fmaf(x.x, w, acc[4 * r4 + 0]);
        acc[4 * r4 + 1] = fmaf(x.y, w, acc[4 * r4 + 1]);
        acc[4 * r4 + 2] = fmaf(x.z, w, acc[4 * r4 + 2]);
        acc[4 * r4 + 3] = fmaf(x.w, w, acc[4 * r4 + 3]);
      }
    }
  }
  const float b = v < V ? to_f(bias[v]) : 0.0f;
  __syncthreads();  // every thread is done reading the staged rows

#pragma unroll
  for (int r = 0; r < VOCAB_ROWS; ++r) {
    float x;
    if (rounding == ROUND_TWICE)
      x = bf16_grid(bf16_grid(acc[r]) + b);
    else if (rounding == ROUND_ONCE)
      x = bf16_grid(acc[r] + b);
    else
      x = acc[r] + b;
    smem[r * VOCAB_TILE + tid] = v < V ? x : -INFINITY;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, n_warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += n_warps) {
    const float* row = smem + r * VOCAB_TILE;
    float m = -INFINITY;
    for (int j = lane; j < VOCAB_TILE; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float s = 0.0f;
    for (int j = lane; j < VOCAB_TILE; j += 32) s += expf(row[j] - m);
    s = warp_sum(s);
    const size_t base = (size_t)(r0 + r) * n_tiles + tile;
    if (lane == 0) {
      part_max[base] = m;
      part_sum[base] = s;
    }
    float pv = INFINITY;
    int pi = -1;  // previous winner; every candidate ranks below (+inf, -1)
    for (int q = 0; q < k; ++q) {
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int j = lane; j < VOCAB_TILE; j += 32) {
        const int gi = tile * VOCAB_TILE + j;
        const float x = row[j];
        if (gi < V && better(pv, pi, x, gi) && better(x, gi, bv, bi)) {
          bv = x;
          bi = gi;
        }
      }
      warp_best(bv, bi);
      if (lane == 0) {
        part_val[base * k + q] = bv;
        part_idx[base * k + q] = bi;
      }
      pv = bv;
      pi = bi;
    }
  }
}

// One warp merges row ``row``'s partials: returns the logsumexp (all lanes)
// and calls emit(q, value, index) for q = 0..k-1 on every lane.
template <typename Emit>
__device__ __forceinline__ float merge_row(size_t row, int n_tiles, int k, const float* __restrict__ part_val,
                                           const int* __restrict__ part_idx, const float* __restrict__ part_max,
                                           const float* __restrict__ part_sum, Emit emit) {
  const int lane = threadIdx.x & 31;
  const float* pm = part_max + row * n_tiles;
  const float* ps = part_sum + row * n_tiles;
  float m = -INFINITY;
  for (int t = lane; t < n_tiles; t += 32) m = fmaxf(m, pm[t]);
  m = warp_max(m);
  float s = 0.0f;
  for (int t = lane; t < n_tiles; t += 32) s += ps[t] * expf(pm[t] - m);
  s = warp_sum(s);

  const int n = n_tiles * k;
  const float* cv = part_val + row * n;
  const int* ci = part_idx + row * n;
  float pv = INFINITY;
  int pi = -1;
  for (int q = 0; q < k; ++q) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int j = lane; j < n; j += 32) {
      const float x = cv[j];
      const int gi = ci[j];
      if (better(pv, pi, x, gi) && better(x, gi, bv, bi)) {
        bv = x;
        bi = gi;
      }
    }
    warp_best(bv, bi);
    emit(q, bv, bi);
    pv = bv;
    pi = bi;
  }
  return m + logf(s);
}

template <typename T, typename BT>
cudaError_t launch_vocab_tiles(const T* hid, const T* W, const BT* bias, int R, int H, int V, int k, int rounding,
                               float* part_val, int* part_idx, float* part_max, float* part_sum, cudaStream_t stream) {
  const int n_tiles = (V + VOCAB_TILE - 1) / VOCAB_TILE;
  const dim3 grid(n_tiles, (R + VOCAB_ROWS - 1) / VOCAB_ROWS);
  const size_t smem = sizeof(float) * VOCAB_ROWS * (H > VOCAB_TILE ? H : VOCAB_TILE);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(vocab_tile_kernel<T, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  vocab_tile_kernel<T, BT><<<grid, TILE_THREADS, smem, stream>>>(hid, W, bias, R, H, V, k, rounding, part_val,
                                                                  part_idx, part_max, part_sum);
  return cudaGetLastError();
}

}  // namespace srt
