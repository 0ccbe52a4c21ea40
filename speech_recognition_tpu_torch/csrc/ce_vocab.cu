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
// Backward, two kernels that each recompute their logits tiles:
//  - ce_dhid_kernel, grid (32-row block, 256-column h chunk): loops over the
//    vocab tiles; per tile, dlog = (exp(l - lse) - onehot) * dnll, rounded to
//    T (dlog_bf on the TPU), goes to shared memory, and each thread adds its
//    h column's share of dlog @ W^T from W^T chunks staged in shared memory.
//    dhid is stored in T.
//  - ce_dw_kernel, grid (64-column vocab tile, 256-row h chunk): loops over
//    all rows in blocks of 32, so each block owns its dW columns and needs no
//    atomics.  dW += hid^T @ rnd(dlog) and db += sum(dlog) in float32.
// What bounds them: 4 products of 2*R*H*V = 133 GFLOP each at LAS-small, on
// the CUDA cores in float32 (67 TFLOP/s peak): a few ms each at best.
// Tensor-core (wgmma / mma) tiles are later work.
#include "vocab_topk.cuh"

#define CE_ROWS 32      // rows per block of the dhid kernel and per chunk of the dW kernel
#define CE_DLS 36       // row stride of the transposed dlog tile (16-byte aligned, conflict-free float4 stores)
#define CE_THREADS 256  // = VOCAB_TILE: one thread per vocab column of a tile
#define CE_HCHUNK 256   // h columns per block (grid.y)
#define CE_WCH 32       // vocab columns per staged chunk of W^T
#define CE_DW_COLS 64   // vocab columns per block of the dW kernel
#define CE_DW_HPT 64    // dW rows per thread: 4 thread groups x 64 = CE_HCHUNK

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

// dlog of one (row, column): (softmax - onehot) * dnll, 0 outside the matrix
__device__ __forceinline__ float ce_dlog(float logit, float lse, float dnll, bool is_label) {
  return (expf(logit - lse) - (is_label ? 1.0f : 0.0f)) * dnll;
}

template <typename T>
__global__ void __launch_bounds__(CE_THREADS)
    ce_dhid_kernel(const T* __restrict__ hid, const T* __restrict__ W, const T* __restrict__ bias,
                   const int* __restrict__ y, const float* __restrict__ lse, const float* __restrict__ dnll, int R,
                   int H, int V, T* __restrict__ dhid) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                    // [H][CE_ROWS] hid rows, transposed
  float* dl = hs + H * CE_ROWS;        // [VOCAB_TILE][CE_DLS] rnd(dlog) tile, transposed
  float* ws = dl + VOCAB_TILE * CE_DLS;  // [CE_WCH][CE_HCHUNK + 1] chunk of W^T
  __shared__ float s_lse[CE_ROWS], s_dnll[CE_ROWS];
  __shared__ int s_y[CE_ROWS];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * CE_ROWS, rows = min(CE_ROWS, R - r0);
  const int h0 = blockIdx.y * CE_HCHUNK, hc = min(CE_HCHUNK, H - h0);

  for (int e = tid; e < CE_ROWS * H; e += CE_THREADS) {
    const int r = e / H, h = e - r * H;
    hs[h * CE_ROWS + r] = r < rows ? to_f(hid[(size_t)(r0 + r) * H + h]) : 0.0f;
  }
  if (tid < CE_ROWS) {
    s_lse[tid] = tid < rows ? lse[r0 + tid] : 0.0f;
    s_dnll[tid] = tid < rows ? dnll[r0 + tid] : 0.0f;
    s_y[tid] = tid < rows ? y[r0 + tid] : -1;
  }
  __syncthreads();

  float acc2[CE_ROWS];  // dhid[r0 + r][h0 + tid]
#pragma unroll
  for (int r = 0; r < CE_ROWS; ++r) acc2[r] = 0.0f;
  const int n_tiles = (V + VOCAB_TILE - 1) / VOCAB_TILE;
  for (int t = 0; t < n_tiles; ++t) {
    const int v = t * VOCAB_TILE + tid;
    float acc[CE_ROWS];
#pragma unroll
    for (int r = 0; r < CE_ROWS; ++r) acc[r] = 0.0f;
    if (v < V) {
      const T* wcol = W + v;
      for (int h = 0; h < H; ++h) {
        const float w = to_f(wcol[(size_t)h * V]);
        const float4* hr = reinterpret_cast<const float4*>(hs + h * CE_ROWS);
#pragma unroll
        for (int r4 = 0; r4 < CE_ROWS / 4; ++r4) {
          const float4 x = hr[r4];
          acc[4 * r4 + 0] = fmaf(x.x, w, acc[4 * r4 + 0]);
          acc[4 * r4 + 1] = fmaf(x.y, w, acc[4 * r4 + 1]);
          acc[4 * r4 + 2] = fmaf(x.z, w, acc[4 * r4 + 2]);
          acc[4 * r4 + 3] = fmaf(x.w, w, acc[4 * r4 + 3]);
        }
      }
    }
    const float bv = v < V ? to_f(bias[v]) : 0.0f;
    float4* dst = reinterpret_cast<float4*>(dl + tid * CE_DLS);
#pragma unroll
    for (int r4 = 0; r4 < CE_ROWS / 4; ++r4) {
      float d[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = 4 * r4 + k;
        d[k] = (v < V && r < rows) ? rnd<T>(ce_dlog(acc[r] + bv, s_lse[r], s_dnll[r], s_y[r] == v)) : 0.0f;
      }
      dst[r4] = make_float4(d[0], d[1], d[2], d[3]);
    }
    __syncthreads();

    for (int c0 = 0; c0 < VOCAB_TILE; c0 += CE_WCH) {
      for (int e = tid; e < CE_WCH * CE_HCHUNK; e += CE_THREADS) {
        const int h = e / CE_WCH, c = e - h * CE_WCH;
        const int vv = t * VOCAB_TILE + c0 + c;
        ws[c * (CE_HCHUNK + 1) + h] = (h < hc && vv < V) ? to_f(W[(size_t)(h0 + h) * V + vv]) : 0.0f;
      }
      __syncthreads();
      if (tid < hc) {
        for (int c = 0; c < CE_WCH; ++c) {
          const float w = ws[c * (CE_HCHUNK + 1) + tid];
          const float4* dr = reinterpret_cast<const float4*>(dl + (c0 + c) * CE_DLS);
#pragma unroll
          for (int r4 = 0; r4 < CE_ROWS / 4; ++r4) {
            const float4 x = dr[r4];
            acc2[4 * r4 + 0] = fmaf(x.x, w, acc2[4 * r4 + 0]);
            acc2[4 * r4 + 1] = fmaf(x.y, w, acc2[4 * r4 + 1]);
            acc2[4 * r4 + 2] = fmaf(x.z, w, acc2[4 * r4 + 2]);
            acc2[4 * r4 + 3] = fmaf(x.w, w, acc2[4 * r4 + 3]);
          }
        }
      }
      __syncthreads();
    }
  }
  if (tid < hc) {
#pragma unroll
    for (int r = 0; r < CE_ROWS; ++r)
      if (r < rows) dhid[(size_t)(r0 + r) * H + h0 + tid] = from_f<T>(acc2[r]);
  }
}

template <typename T>
__global__ void __launch_bounds__(CE_THREADS)
    ce_dw_kernel(const T* __restrict__ hid, const T* __restrict__ W, const T* __restrict__ bias,
                 const int* __restrict__ y, const float* __restrict__ lse, const float* __restrict__ dnll, int R, int H,
                 int V, float* __restrict__ dW, float* __restrict__ db) {
  extern __shared__ __align__(16) float smem[];
  float* hsT = smem;                        // [H][CE_ROWS] (the logits)
  float* hs = hsT + H * CE_ROWS;            // [CE_ROWS][CE_HCHUNK] this block's h columns (dW), zero beyond H
  float* dl = hs + CE_ROWS * CE_HCHUNK;     // [CE_ROWS][CE_DW_COLS] rnd(dlog)
  float* dbp = dl + CE_ROWS * CE_DW_COLS;   // [CE_THREADS] db partials
  __shared__ float s_lse[CE_ROWS], s_dnll[CE_ROWS];
  __shared__ int s_y[CE_ROWS];
  const int tid = threadIdx.x;
  const int c = tid % CE_DW_COLS, g = tid / CE_DW_COLS;  // g: 8 logits rows, then 64 dW rows
  const int v = blockIdx.x * CE_DW_COLS + c;
  const int h0 = blockIdx.y * CE_HCHUNK;
  const int hb = h0 + g * CE_DW_HPT;  // first dW row of this thread
  const float bv = v < V ? to_f(bias[v]) : 0.0f;

  float accw[CE_DW_HPT];
#pragma unroll
  for (int k = 0; k < CE_DW_HPT; ++k) accw[k] = 0.0f;
  float dbacc = 0.0f;
  for (int r0 = 0; r0 < R; r0 += CE_ROWS) {
    const int rows = min(CE_ROWS, R - r0);
    __syncthreads();  // the previous chunk is done with hs / dl
    for (int e = tid; e < CE_ROWS * H; e += CE_THREADS) {
      const int r = e / H, h = e - r * H;
      hsT[h * CE_ROWS + r] = r < rows ? to_f(hid[(size_t)(r0 + r) * H + h]) : 0.0f;
    }
    for (int e = tid; e < CE_ROWS * CE_HCHUNK; e += CE_THREADS) {
      const int r = e / CE_HCHUNK, h = h0 + e - r * CE_HCHUNK;
      hs[e] = (r < rows && h < H) ? to_f(hid[(size_t)(r0 + r) * H + h]) : 0.0f;
    }
    if (tid < CE_ROWS) {
      s_lse[tid] = tid < rows ? lse[r0 + tid] : 0.0f;
      s_dnll[tid] = tid < rows ? dnll[r0 + tid] : 0.0f;
      s_y[tid] = tid < rows ? y[r0 + tid] : -1;
    }
    __syncthreads();

    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
    if (v < V) {
      for (int h = 0; h < H; ++h) {
        const float w = to_f(W[(size_t)h * V + v]);
        const float4* hr = reinterpret_cast<const float4*>(hsT + h * CE_ROWS + g * 8);
        const float4 a = hr[0], bq = hr[1];
        acc[0] = fmaf(a.x, w, acc[0]);
        acc[1] = fmaf(a.y, w, acc[1]);
        acc[2] = fmaf(a.z, w, acc[2]);
        acc[3] = fmaf(a.w, w, acc[3]);
        acc[4] = fmaf(bq.x, w, acc[4]);
        acc[5] = fmaf(bq.y, w, acc[5]);
        acc[6] = fmaf(bq.z, w, acc[6]);
        acc[7] = fmaf(bq.w, w, acc[7]);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int r = g * 8 + k;
      const float d = (v < V && r < rows) ? ce_dlog(acc[k] + bv, s_lse[r], s_dnll[r], s_y[r] == v) : 0.0f;
      dbacc += d;
      dl[r * CE_DW_COLS + c] = rnd<T>(d);
    }
    __syncthreads();

    for (int r = 0; r < rows; ++r) {
      const float d = dl[r * CE_DW_COLS + c];
      const float4* hr = reinterpret_cast<const float4*>(hs + r * CE_HCHUNK + g * CE_DW_HPT);
#pragma unroll
      for (int k4 = 0; k4 < CE_DW_HPT / 4; ++k4) {
        const float4 x = hr[k4];
        accw[4 * k4 + 0] = fmaf(x.x, d, accw[4 * k4 + 0]);
        accw[4 * k4 + 1] = fmaf(x.y, d, accw[4 * k4 + 1]);
        accw[4 * k4 + 2] = fmaf(x.z, d, accw[4 * k4 + 2]);
        accw[4 * k4 + 3] = fmaf(x.w, d, accw[4 * k4 + 3]);
      }
    }
  }
  if (v < V) {
#pragma unroll
    for (int k = 0; k < CE_DW_HPT; ++k)
      if (hb + k < H) dW[(size_t)(hb + k) * V + v] = accw[k];
  }
  dbp[tid] = dbacc;
  __syncthreads();
  if (g == 0 && v < V && blockIdx.y == 0) {
    float s = 0.0f;
    for (int k = 0; k < CE_THREADS / CE_DW_COLS; ++k) s += dbp[k * CE_DW_COLS + c];
    db[v] = s;
  }
}

template <typename Kernel>
cudaError_t ce_set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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

template <typename T>
cudaError_t ce_bwd_impl(const void* hid, const void* W, const void* b, const int* y, const float* lse,
                        const float* dnll, int R, int H, int V, void* dhid, float* dW, float* db,
                        cudaStream_t stream) {
  const int h_chunks = (H + CE_HCHUNK - 1) / CE_HCHUNK;
  const size_t smem1 = sizeof(float) * ((size_t)H * CE_ROWS + VOCAB_TILE * CE_DLS + CE_WCH * (CE_HCHUNK + 1));
  cudaError_t err = ce_set_smem(ce_dhid_kernel<T>, smem1);
  if (err != cudaSuccess) return err;
  ce_dhid_kernel<T><<<dim3((R + CE_ROWS - 1) / CE_ROWS, h_chunks), CE_THREADS, smem1, stream>>>(
      static_cast<const T*>(hid), static_cast<const T*>(W), static_cast<const T*>(b), y, lse, dnll, R, H, V,
      static_cast<T*>(dhid));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // the full hid chunk (for the logits) plus this block's h columns: 173 KB at H=1024
  const size_t smem2 = sizeof(float) * ((size_t)H * CE_ROWS + CE_ROWS * CE_HCHUNK + CE_ROWS * CE_DW_COLS + CE_THREADS);
  err = ce_set_smem(ce_dw_kernel<T>, smem2);
  if (err != cudaSuccess) return err;
  ce_dw_kernel<T><<<dim3((V + CE_DW_COLS - 1) / CE_DW_COLS, h_chunks), CE_THREADS, smem2, stream>>>(
      static_cast<const T*>(hid), static_cast<const T*>(W), static_cast<const T*>(b), y, lse, dnll, R, H, V, dW, db);
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

// Backward.  Same hid/W/b/y, the forward's lse [R] and dnll [R] float32.
// Outputs dhid [R,H] in T, dW [H,V] and db [V] float32 (every element written).
int ce_vocab_bwd(int dtype_bf16, const void* hid, const void* W, const void* b, const int* y, const float* lse,
                 const float* dnll, int R, int H, int V, void* dhid, float* dW, float* db, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_bf16)
    err = srt::ce_bwd_impl<__nv_bfloat16>(hid, W, b, y, lse, dnll, R, H, V, dhid, dW, db, st);
  else
    err = srt::ce_bwd_impl<float>(hid, W, b, y, lse, dnll, R, H, V, dhid, dW, db, st);
  return static_cast<int>(err);
}

}  // extern "C"
