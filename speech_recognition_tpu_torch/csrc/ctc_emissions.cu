// Kernel K6: the vocab projection fused with CTC's emission log-probs, forward
// and backward.  C interface for ops/ctc_emissions.py (ctypes).
// Replaces fused_vocab_emissions (speech_recognition_tpu/ops/pallas/ctc_kernel.py:210;
// bodies _fwd_kernel :64 and _bwd_kernel :82).
//
// logits = hid @ W + b in float32 over R = B*T rows; row r = b*T + t gathers
// the K ids of batch row b (its labels, then the blank).  The logits never
// reach device memory (0.9 GB in float32 at B=128, T=108, V=16000).
//
// Forward: the vocab tile pass (vocab_topk.cuh) with k = 1, no rounding and
// the ids as its gather hook: per-tile (max, sum-exp) and the K logits of
// each row's ids, copied out of the tiles that hold them, so they are the
// same floats the lse saw (id_sort_kernel first lists each batch row's ids in
// (id, k) order; duplicates and the pad id each get their value, an id
// outside [0, V) gets 0); emission_lse_kernel merges the partials into each
// row's logsumexp.  emission = vals - lse is a small PyTorch op, as in the
// TPU wrapper.
//
// Backward: dlog[r, v] = sum_k dvals[r, k] [ids[b, k] == v] + softmax[r, v] dlse[r],
// dlse = -sum_k dvals.  emission_fold_kernel folds duplicate ids (repeated
// labels, the pad id) into their first occurrence, summing in k order, and
// writes dlse; in bf16 it also lists each batch row's distinct ids in
// ascending order with their first k.  Then the logits are recomputed:
//  - bf16: the tensor-core engine of csrc/vocab_bwd.cuh (wgmma, cp.async
//    rings), with EmissionRows as its policy: per row lse and c = dlse; the
//    label terms come from the sorted list (a cursor per row in the row
//    kernel, which walks V in order; a binary search per row block in the
//    column kernel), each cell receiving at most one folded label, added
//    before dlog is rounded; dhid = rnd(dlog) @ W^T is stored in bf16, dW =
//    hid^T @ rnd(dlog) and db = sum dlog (unrounded, ctc_kernel.py:119) in
//    float32.  What bounds it at B=128, T=108, H=256, V=16000: three 113 GFLOP
//    products (recompute, dhid, dW) at the bf16 tensor-core peak; the engine
//    keeps every product on the tensor cores and the logits out of memory.
//  - float32: two kernels on the CUDA cores (tensor cores would mean TF32,
//    and the float32 path is held to 1e-5 x max|ref|):
//    emission_dhid_kernel, grid (32-row block, 256-column h chunk), loops over
//    the vocab tiles; per tile the folded label terms are scattered into a
//    zeroed tile in shared memory (each cell written at most once, so no
//    order between threads matters) and each thread adds its h column's share
//    of dlog @ W^T from staged W^T chunks; emission_dw_kernel, grid (64-column
//    vocab tile, 256-row h chunk), loops over all rows in blocks of 32, so
//    each block owns its dW columns and needs no atomics.
// K1's backward (ops/ce_vocab.py) is this backward with one id per row
// (T = 1, K = 1, dvals = -dnll).
#include "vocab_bwd.cuh"
#include "vocab_topk.cuh"

#define EM_TILE 256     // vocab columns per tile of the float32 dhid kernel
#define EM_ROWS 32      // rows per block of the dhid kernel and per chunk of the dW kernel
#define EM_DLS 36       // row stride of the transposed dlog tile (16-byte aligned, conflict-free float4 stores)
#define EM_THREADS 256  // = EM_TILE: one thread per vocab column of a tile
#define EM_HCHUNK 256   // h columns per block (grid.y)
#define EM_WCH 32       // vocab columns per staged chunk of W^T
#define EM_DW_COLS 64   // vocab columns per block of the dW kernel
#define EM_DW_HPT 64    // dW rows per thread: 4 thread groups x 64 = EM_HCHUNK

namespace srt {

__global__ void emission_lse_kernel(int R, int n_tiles, const float* __restrict__ part_val,
                                    const int* __restrict__ part_idx, const float* __restrict__ part_max,
                                    const float* __restrict__ part_sum, float* __restrict__ lse) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const float l = merge_row((size_t)row, n_tiles, 1, part_val, part_idx, part_max, part_sum, [](int, float, int) {});
  if (lane == 0) lse[row] = l;
}

// grid (B), one block per batch row: ids_first[b, k] = ids[b, k] at an id's
// first occurrence in the row (else -1); merged[r, k] = the sum, in k order,
// of dvals[r, k'] over the k' that share k's id (0 off first occurrences);
// dlse[r] = -sum_k dvals[r, k].
// With ``lab`` (bf16): lab[b][0][i] = the row's i-th smallest distinct id in
// [0, V) (INT_MAX past the last), lab[b][1][i] = its first k.
__global__ void emission_fold_kernel(const int* __restrict__ ids, const float* __restrict__ dvals, int T_rows, int K,
                                     int V, float* __restrict__ merged, int* __restrict__ ids_first,
                                     float* __restrict__ dlse, int* __restrict__ lab) {
  extern __shared__ int s_fold[];  // s_ids[K], s_first[K]
  int* s_ids = s_fold;
  int* s_first = s_fold + K;
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int k = tid; k < K; k += blockDim.x) s_ids[k] = ids[(size_t)b * K + k];
  __syncthreads();
  for (int k = tid; k < K; k += blockDim.x) {
    const int id = s_ids[k];
    int f = k;
    for (int k2 = 0; k2 < k; ++k2)
      if (s_ids[k2] == id) {
        f = k2;
        break;
      }
    s_first[k] = f;
    ids_first[(size_t)b * K + k] = (f == k && id >= 0 && id < V) ? id : -1;
  }
  __syncthreads();
  if (lab) {
    int* lab_ids = lab + (size_t)b * 2 * K;
    int count = 0;
    for (int k = 0; k < K; ++k) count += s_first[k] == k && s_ids[k] >= 0 && s_ids[k] < V;
    for (int k = tid; k < K; k += blockDim.x) {
      const int id = s_ids[k];
      if (s_first[k] == k && id >= 0 && id < V) {
        int rank = 0;
        for (int k2 = 0; k2 < K; ++k2) rank += s_first[k2] == k2 && s_ids[k2] >= 0 && s_ids[k2] < id;
        lab_ids[rank] = id;
        lab_ids[K + rank] = k;
      }
      if (k >= count) lab_ids[k] = INT_MAX;
    }
  }
  for (int t = tid; t < T_rows; t += blockDim.x) {
    const size_t r = (size_t)b * T_rows + t;
    float* m = merged + r * K;
    const float* dv = dvals + r * K;
    for (int k = 0; k < K; ++k) m[k] = 0.0f;
    float sum = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float d = dv[k];
      sum += d;
      m[s_first[k]] += d;
    }
    dlse[r] = -sum;
  }
}

// Writes the folded label cotangents of rows r0 .. r0+rows-1 that fall in vocab
// columns [v0, v0 + ncols) into a zeroed tile, cell (r, c) at
// tile[c * col_stride + r * row_stride].  ids_first holds each distinct id of a
// batch row once, so every cell is written at most once.
__device__ __forceinline__ void scatter_labels(float* tile, int col_stride, int row_stride, int v0, int ncols, int r0,
                                               int rows, int T_rows, int K, const int* __restrict__ ids_first,
                                               const float* __restrict__ merged) {
  for (int e = threadIdx.x; e < rows * K; e += blockDim.x) {
    const int r = e / K, k = e - r * K;
    const int row = r0 + r;
    const int c = ids_first[(size_t)(row / T_rows) * K + k] - v0;
    if (c >= 0 && c < ncols) tile[c * col_stride + r * row_stride] = merged[(size_t)row * K + k];
  }
}

// dlog of one (row, column): the label term plus softmax * dlse
__device__ __forceinline__ float em_dlog(float label, float logit, float lse, float dlse) {
  return label + expf(logit - lse) * dlse;
}

template <typename T>
__global__ void __launch_bounds__(EM_THREADS)
    emission_dhid_kernel(const T* __restrict__ hid, const T* __restrict__ W, const T* __restrict__ bias,
                         const int* __restrict__ ids_first, const float* __restrict__ merged,
                         const float* __restrict__ lse, const float* __restrict__ dlse, int R, int T_rows, int K,
                         int H, int V, T* __restrict__ dhid) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                      // [H][EM_ROWS] hid rows, transposed
  float* dl = hs + H * EM_ROWS;       // [EM_TILE][EM_DLS] rnd(dlog) tile, transposed
  float* ws = dl + EM_TILE * EM_DLS;  // [EM_WCH][EM_HCHUNK + 1] chunk of W^T
  __shared__ float s_lse[EM_ROWS], s_dlse[EM_ROWS];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * EM_ROWS, rows = min(EM_ROWS, R - r0);
  const int h0 = blockIdx.y * EM_HCHUNK, hc = min(EM_HCHUNK, H - h0);

  for (int e = tid; e < EM_ROWS * H; e += EM_THREADS) {
    const int r = e / H, h = e - r * H;
    hs[h * EM_ROWS + r] = r < rows ? to_f(hid[(size_t)(r0 + r) * H + h]) : 0.0f;
  }
  if (tid < EM_ROWS) {
    s_lse[tid] = tid < rows ? lse[r0 + tid] : 0.0f;
    s_dlse[tid] = tid < rows ? dlse[r0 + tid] : 0.0f;
  }
  __syncthreads();

  float acc2[EM_ROWS];  // dhid[r0 + r][h0 + tid]
#pragma unroll
  for (int r = 0; r < EM_ROWS; ++r) acc2[r] = 0.0f;
  const int n_tiles = (V + EM_TILE - 1) / EM_TILE;
  float4* col = reinterpret_cast<float4*>(dl + tid * EM_DLS);  // this thread's column of the tile
  for (int t = 0; t < n_tiles; ++t) {
    const int v0 = t * EM_TILE, v = v0 + tid;
#pragma unroll
    for (int r4 = 0; r4 < EM_ROWS / 4; ++r4) col[r4] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float acc[EM_ROWS];
#pragma unroll
    for (int r = 0; r < EM_ROWS; ++r) acc[r] = 0.0f;
    if (v < V) {
      const T* wcol = W + v;
      for (int h = 0; h < H; ++h) {
        const float w = to_f(wcol[(size_t)h * V]);
        const float4* hr = reinterpret_cast<const float4*>(hs + h * EM_ROWS);
#pragma unroll
        for (int r4 = 0; r4 < EM_ROWS / 4; ++r4) {
          const float4 x = hr[r4];
          acc[4 * r4 + 0] = fmaf(x.x, w, acc[4 * r4 + 0]);
          acc[4 * r4 + 1] = fmaf(x.y, w, acc[4 * r4 + 1]);
          acc[4 * r4 + 2] = fmaf(x.z, w, acc[4 * r4 + 2]);
          acc[4 * r4 + 3] = fmaf(x.w, w, acc[4 * r4 + 3]);
        }
      }
    }
    const float bv = v < V ? to_f(bias[v]) : 0.0f;
    __syncthreads();  // the tile is zeroed
    scatter_labels(dl, EM_DLS, 1, v0, EM_TILE, r0, rows, T_rows, K, ids_first, merged);
    __syncthreads();
#pragma unroll
    for (int r4 = 0; r4 < EM_ROWS / 4; ++r4) {
      const float4 lab = col[r4];
      const float l[4] = {lab.x, lab.y, lab.z, lab.w};
      float d[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = 4 * r4 + k;
        d[k] = (v < V && r < rows) ? rnd<T>(em_dlog(l[k], acc[r] + bv, s_lse[r], s_dlse[r])) : 0.0f;
      }
      col[r4] = make_float4(d[0], d[1], d[2], d[3]);
    }
    __syncthreads();

    for (int c0 = 0; c0 < EM_TILE; c0 += EM_WCH) {
      for (int e = tid; e < EM_WCH * EM_HCHUNK; e += EM_THREADS) {
        const int h = e / EM_WCH, c = e - h * EM_WCH;
        const int vv = v0 + c0 + c;
        ws[c * (EM_HCHUNK + 1) + h] = (h < hc && vv < V) ? to_f(W[(size_t)(h0 + h) * V + vv]) : 0.0f;
      }
      __syncthreads();
      if (tid < hc) {
        for (int c = 0; c < EM_WCH; ++c) {
          const float w = ws[c * (EM_HCHUNK + 1) + tid];
          const float4* dr = reinterpret_cast<const float4*>(dl + (c0 + c) * EM_DLS);
#pragma unroll
          for (int r4 = 0; r4 < EM_ROWS / 4; ++r4) {
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
    for (int r = 0; r < EM_ROWS; ++r)
      if (r < rows) dhid[(size_t)(r0 + r) * H + h0 + tid] = from_f<T>(acc2[r]);
  }
}

template <typename T>
__global__ void __launch_bounds__(EM_THREADS)
    emission_dw_kernel(const T* __restrict__ hid, const T* __restrict__ W, const T* __restrict__ bias,
                       const int* __restrict__ ids_first, const float* __restrict__ merged,
                       const float* __restrict__ lse, const float* __restrict__ dlse, int R, int T_rows, int K, int H,
                       int V, float* __restrict__ dW, float* __restrict__ db) {
  extern __shared__ __align__(16) float smem[];
  float* hsT = smem;                       // [H][EM_ROWS] (the logits)
  float* hs = hsT + H * EM_ROWS;           // [EM_ROWS][EM_HCHUNK] this block's h columns (dW), zero beyond H
  float* dl = hs + EM_ROWS * EM_HCHUNK;    // [EM_ROWS][EM_DW_COLS] label terms, then rnd(dlog)
  float* dbp = dl + EM_ROWS * EM_DW_COLS;  // [EM_THREADS] db partials
  __shared__ float s_lse[EM_ROWS], s_dlse[EM_ROWS];
  const int tid = threadIdx.x;
  const int c = tid % EM_DW_COLS, g = tid / EM_DW_COLS;  // g: 8 logits rows, then 64 dW rows
  const int v0 = blockIdx.x * EM_DW_COLS, v = v0 + c;
  const int h0 = blockIdx.y * EM_HCHUNK;
  const int hb = h0 + g * EM_DW_HPT;  // first dW row of this thread
  const float bv = v < V ? to_f(bias[v]) : 0.0f;

  float accw[EM_DW_HPT];
#pragma unroll
  for (int k = 0; k < EM_DW_HPT; ++k) accw[k] = 0.0f;
  float dbacc = 0.0f;
  for (int r0 = 0; r0 < R; r0 += EM_ROWS) {
    const int rows = min(EM_ROWS, R - r0);
    __syncthreads();  // the previous chunk is done with hs / dl
    for (int e = tid; e < EM_ROWS * H; e += EM_THREADS) {
      const int r = e / H, h = e - r * H;
      hsT[h * EM_ROWS + r] = r < rows ? to_f(hid[(size_t)(r0 + r) * H + h]) : 0.0f;
    }
    for (int e = tid; e < EM_ROWS * EM_HCHUNK; e += EM_THREADS) {
      const int r = e / EM_HCHUNK, h = h0 + e - r * EM_HCHUNK;
      hs[e] = (r < rows && h < H) ? to_f(hid[(size_t)(r0 + r) * H + h]) : 0.0f;
    }
    for (int e = tid; e < EM_ROWS * EM_DW_COLS; e += EM_THREADS) dl[e] = 0.0f;
    if (tid < EM_ROWS) {
      s_lse[tid] = tid < rows ? lse[r0 + tid] : 0.0f;
      s_dlse[tid] = tid < rows ? dlse[r0 + tid] : 0.0f;
    }
    __syncthreads();
    scatter_labels(dl, 1, EM_DW_COLS, v0, EM_DW_COLS, r0, rows, T_rows, K, ids_first, merged);

    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
    if (v < V) {
      for (int h = 0; h < H; ++h) {
        const float w = to_f(W[(size_t)h * V + v]);
        const float4* hr = reinterpret_cast<const float4*>(hsT + h * EM_ROWS + g * 8);
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
    __syncthreads();  // the label terms are in place
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int r = g * 8 + k;
      float* cell = dl + r * EM_DW_COLS + c;
      const float d = (v < V && r < rows) ? em_dlog(*cell, acc[k] + bv, s_lse[r], s_dlse[r]) : 0.0f;
      dbacc += d;
      *cell = rnd<T>(d);
    }
    __syncthreads();

    for (int r = 0; r < rows; ++r) {
      const float d = dl[r * EM_DW_COLS + c];
      const float4* hr = reinterpret_cast<const float4*>(hs + r * EM_HCHUNK + g * EM_DW_HPT);
#pragma unroll
      for (int k4 = 0; k4 < EM_DW_HPT / 4; ++k4) {
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
    for (int k = 0; k < EM_DW_HPT; ++k)
      if (hb + k < H) dW[(size_t)(hb + k) * V + v] = accw[k];
  }
  dbp[tid] = dbacc;
  __syncthreads();
  if (g == 0 && v < V && blockIdx.y == 0) {
    float s = 0.0f;
    for (int k = 0; k < EM_THREADS / EM_DW_COLS; ++k) s += dbp[k * EM_DW_COLS + c];
    db[v] = s;
  }
}

template <typename Kernel>
cudaError_t em_set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
cudaError_t emission_fwd_impl(const void* hid, const void* W, const void* b, const int* ids, int R, int T_rows, int K,
                              int H, int V, const TilePlan& plan, int* id_list, float* part_val, int* part_idx,
                              float* part_max, float* part_sum, float* lse, float* vals, cudaStream_t stream) {
  if (K > 1) {
    id_sort_kernel<<<R / T_rows, 128, 0, stream>>>(ids, K, id_list);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = launch_vocab_tiles<T, T>(static_cast<const T*>(hid), static_cast<const T*>(W),
                                             static_cast<const T*>(b), R, H, V, 1, ROUND_NONE, plan, part_val,
                                             part_idx, part_max, part_sum, stream, nullptr,
                                             Gather{K > 1 ? id_list : ids, vals, T_rows, K});
  if (err != cudaSuccess) return err;
  const int n_tiles = (V + VOCAB_TILE - 1) / VOCAB_TILE;
  emission_lse_kernel<<<(int)(((size_t)R * 32 + 255) / 256), 256, 0, stream>>>(R, n_tiles, part_val, part_idx,
                                                                                part_max, part_sum, lse);
  return cudaGetLastError();
}

// The float32 backward: the fold, then the two CUDA-core kernels.
cudaError_t emission_bwd_f32(const float* hid, const float* W, const float* b, const int* ids, const float* lse,
                             const float* dvals, int R, int T_rows, int K, int H, int V, float* merged, int* ids_first,
                             float* dlse, float* dhid, float* dW, float* db, cudaStream_t stream) {
  emission_fold_kernel<<<R / T_rows, 128, sizeof(int) * 2 * K, stream>>>(ids, dvals, T_rows, K, V, merged,
                                                                          ids_first, dlse, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int h_chunks = (H + EM_HCHUNK - 1) / EM_HCHUNK;
  const size_t smem1 = sizeof(float) * ((size_t)H * EM_ROWS + EM_TILE * EM_DLS + EM_WCH * (EM_HCHUNK + 1));
  err = em_set_smem(emission_dhid_kernel<float>, smem1);
  if (err != cudaSuccess) return err;
  emission_dhid_kernel<float><<<dim3((R + EM_ROWS - 1) / EM_ROWS, h_chunks), EM_THREADS, smem1, stream>>>(
      hid, W, b, ids_first, merged, lse, dlse, R, T_rows, K, H, V, dhid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // the full hid chunk (for the logits) plus this block's h columns: 169 KB at H=1024
  const size_t smem2 = sizeof(float) * ((size_t)H * EM_ROWS + EM_ROWS * EM_HCHUNK + EM_ROWS * EM_DW_COLS + EM_THREADS);
  err = em_set_smem(emission_dw_kernel<float>, smem2);
  if (err != cudaSuccess) return err;
  emission_dw_kernel<float><<<dim3((V + EM_DW_COLS - 1) / EM_DW_COLS, h_chunks), EM_THREADS, smem2, stream>>>(
      hid, W, b, ids_first, merged, lse, dlse, R, T_rows, K, H, V, dW, db);
  return cudaGetLastError();
}

// The engine's policy for K1/K6 (csrc/vocab_bwd.cuh): c = dlse, the folded
// label terms from the sorted list ``lab``, db unrounded, dhid stored in bf16.
struct EmissionRows {
  const float* lse;
  const float* dlse;
  const int* lab;  // [B][2][K]: sorted distinct ids (INT_MAX past the last), their first k
  const float* merged;
  __nv_bfloat16* dhid;
  int T_rows, K, H;
  static constexpr bool kDbRounded = false;

  struct Row {
    float lse, c;
    size_t row, list;
    int pos;
    bool valid;
  };

  // the row's data, and its list position at the first id >= v0
  __device__ __forceinline__ Row row(size_t r, bool valid, int v0) const {
    Row o{0.0f, 0.0f, r, 0, 0, valid};
    if (!valid) return o;
    o.lse = lse[r];
    o.c = dlse[r];
    o.list = r / T_rows * 2 * K;
    int lo = 0, hi = K;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (lab[o.list + mid] < v0) lo = mid + 1;
      else hi = mid;
    }
    o.pos = lo;
    return o;
  }

  // adds the labels of columns v0 .. v0 + 63 to the thread's cells, and moves the row's cursor past them
  __device__ __forceinline__ void add_labels(Row& r, int v0, int q, float (&d)[16]) const {
    if (!r.valid) return;
    for (; r.pos < K; ++r.pos) {
      const int id = lab[r.list + r.pos];
      if (id >= v0 + vb::PANEL) break;
      const int idx = vb::cell_of(id - v0, q);
      if (idx >= 0) vb::add_at(d, idx, merged[r.row * K + lab[r.list + K + r.pos]]);
    }
  }

  __device__ __forceinline__ void store_dh(size_t r, int col, float v) const {
    dhid[r * H + col] = __float2bfloat16_rn(v);
  }
};

// The bf16 backward: the fold with the sorted label lists, then the engine.
cudaError_t emission_bwd_bf16(const __nv_bfloat16* hid, const __nv_bfloat16* W, const __nv_bfloat16* b, const int* ids,
                              const float* lse, const float* dvals, int R, int T_rows, int K, int H, int V,
                              const vb::Plan& plan, float* merged, int* ids_first, float* dlse, int* lab,
                              float* dW_part, float* db_part, __nv_bfloat16* dhid, float* dW, float* db,
                              cudaStream_t stream) {
  emission_fold_kernel<<<R / T_rows, 128, sizeof(int) * 2 * K, stream>>>(ids, dvals, T_rows, K, V, merged,
                                                                          ids_first, dlse, lab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const EmissionRows pol{lse, dlse, lab, merged, dhid, T_rows, K, H};
  return vb::launch(pol, hid, (size_t)H, H, W, V, b, R, plan, dW_part, db_part, dW, db, stream);
}

}  // namespace srt

extern "C" {

// Forward.  hid [R,H] (R = B*T rows, batch-major), W [H,V], b [V] in T (bf16
// when dtype_bf16, else float32); ids [B,K] int32.  Outputs lse [R] and
// vals [R,K] float32; part_* are [R, ceil(V/VOCAB_TILE)] scratch, id_list
// [B,2,K] int32 scratch; wgs, stage_k, tiles_per_block: the bf16 plan of the
// tile pass (ops/vocab_topk.py tile_plan).
int ctc_emissions_fwd(int dtype_bf16, const void* hid, const void* W, const void* b, const int* ids, int R, int T_rows,
                      int K, int H, int V, int wgs, int stage_k, int tiles_per_block, int* id_list, float* part_val,
                      int* part_idx, float* part_max, float* part_sum, float* lse, float* vals, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const srt::TilePlan plan{wgs, stage_k, tiles_per_block};
  cudaError_t err;
  if (dtype_bf16)
    err = srt::emission_fwd_impl<__nv_bfloat16>(hid, W, b, ids, R, T_rows, K, H, V, plan, id_list, part_val,
                                                part_idx, part_max, part_sum, lse, vals, st);
  else
    err = srt::emission_fwd_impl<float>(hid, W, b, ids, R, T_rows, K, H, V, plan, id_list, part_val, part_idx,
                                        part_max, part_sum, lse, vals, st);
  return static_cast<int>(err);
}

// Backward.  Same hid/W/b/ids, the forward's lse [R] and the emission
// cotangents dvals [R,K] float32.  Scratch: merged [R,K] float32, ids_first
// [B,K] int32, dlse [R] float32.  Outputs dhid [R,H] in T, dW [H,V] and db
// [V] float32 (every element written).  bf16 only: the engine's plan
// (n_split, row_wgs, tile, chunk_panels, rows_per_split
// from ops/vocab_bwd.py bwd_plan) and scratch lab [B,2,K] int32, dW_part
// [2 n_split,H,V], db_part [2 n_split,V] float32 (float32 ignores them).
int ctc_emissions_bwd(int dtype_bf16, const void* hid, const void* W, const void* b, const int* ids, const float* lse,
                      const float* dvals, int R, int T_rows, int K, int H, int V, int n_split, int row_wgs,
                      int tile, int chunk_panels, int rows_per_split, float* merged,
                      int* ids_first, float* dlse, int* lab, float* dW_part, float* db_part, void* dhid, float* dW,
                      float* db, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_bf16)
    err = srt::emission_bwd_bf16(static_cast<const __nv_bfloat16*>(hid), static_cast<const __nv_bfloat16*>(W),
                                 static_cast<const __nv_bfloat16*>(b), ids, lse, dvals, R, T_rows, K, H, V,
                                 {row_wgs, tile, chunk_panels, n_split, rows_per_split}, merged,
                                 ids_first, dlse, lab, dW_part, db_part, static_cast<__nv_bfloat16*>(dhid), dW, db,
                                 st);
  else
    err = srt::emission_bwd_f32(static_cast<const float*>(hid), static_cast<const float*>(W),
                                static_cast<const float*>(b), ids, lse, dvals, R, T_rows, K, H, V, merged, ids_first,
                                dlse, static_cast<float*>(dhid), dW, db, st);
  return static_cast<int>(err);
}

}  // extern "C"
