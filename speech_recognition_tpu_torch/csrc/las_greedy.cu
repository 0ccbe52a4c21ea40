// Kernel K4: one LAS greedy decode step.  C interface for ops/greedy_search.py (ctypes).
// Replaces greedy_search_pallas (speech_recognition_tpu/ops/pallas/search_kernel.py:237).
//
// Three launches per step:
//  1. las_step_kernel: one block of STEP_THREADS per batch row.  Embedding
//     gather, q = h @ qw + qb, masked attention scores (a warp per key frame),
//     float32 softmax, the context (a thread per value column), then the
//     threaded LSTM cell stack with pad gating (a thread per gate column).
//     Every vector lives in shared memory; every matvec is the block's own
//     loop, float32 accumulation.  Values are rounded to T where the TPU
//     kernel rounds them; h and c stay float32 across steps.  The step's
//     device code is in las_step.cuh, shared with the decoder forward (K2).
//  2. K5's vocab_tile_kernel over the step's hidden rows, k = 1, one bf16
//     rounding of (dot + float32 bias) under bf16, none under float32.
//  3. greedy_merge_kernel: K5's merge (top-1 and logsumexp) plus the EOS
//     bookkeeping: a row that has ended emits pad and stops adding logP.
#include "las_step.cuh"
#include "vocab_topk.cuh"

#define STEP_THREADS 1024
#define MAX_CELLS 8  // = ops/greedy_search.py MAX_CELLS

namespace srt {

template <typename T>
struct Cells {
  const T* kernel[MAX_CELLS];     // [in, 4H]
  const T* recurrent[MAX_CELLS];  // [H, 4H]
  const T* bias[MAX_CELLS];       // [4H]
  int n;
};

template <typename T>
__global__ void __launch_bounds__(STEP_THREADS)
    las_step_kernel(const T* __restrict__ pk, const T* __restrict__ value, const float* __restrict__ attn_bias,
                    const T* __restrict__ qw, const T* __restrict__ qb, const T* __restrict__ emb, Cells<T> cells,
                    float* __restrict__ h_state, float* __restrict__ c_state, const int* __restrict__ prev_tok,
                    T* __restrict__ hidden, int S, int H, int He, int Dv, int pad_id) {
  extern __shared__ float sm[];
  float* hq = sm;           // [H]  h rounded to T (the recurrent / query input)
  float* q = hq + H;        // [H]
  float* x = q + H;         // [He + Dv]  cell input
  float* z = x + He + Dv;   // [4H] gate pre-activations
  float* hc = z + 4 * H;    // [H]  h, float32
  float* cc = hc + H;       // [H]  c, float32
  float* sc = cc + H;       // [S]  scores, then probabilities
  float* red = sc + S;      // [33] reduction scratch

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int tok = prev_tok[b];
  const bool m = tok != pad_id;  // pad-token gating: state frozen, output zero

  for (int j = tid; j < H; j += nt) {
    hc[j] = h_state[(size_t)b * H + j];
    cc[j] = c_state[(size_t)b * H + j];
    hq[j] = rnd<T>(hc[j]);
  }
  for (int j = tid; j < He; j += nt) x[j] = to_f(emb[(size_t)tok * He + j]);
  __syncthreads();

  attend<T>(hq, qw, qb, pk + (size_t)b * S * H, value + (size_t)b * S * Dv, attn_bias + (size_t)b * S, S, H, Dv, q,
            sc, red, x + He);

  // threaded LSTM cell stack
  int in_dim = He + Dv;
  for (int ci = 0; ci < cells.n; ++ci) {
    cell_gates<T>(x, in_dim, hq, cells.kernel[ci], cells.recurrent[ci], cells.bias[ci], H, z);
    cell_update<T>(z, hc, cc, hq, x, H, m, nullptr, nullptr);
    in_dim = H;
  }

  for (int j = tid; j < H; j += nt) {
    hidden[(size_t)b * H + j] = from_f<T>(x[j]);
    h_state[(size_t)b * H + j] = hc[j];
    c_state[(size_t)b * H + j] = cc[j];
  }
}

__global__ void greedy_merge_kernel(int B, int n_tiles, const float* __restrict__ part_val,
                                    const int* __restrict__ part_idx, const float* __restrict__ part_max,
                                    const float* __restrict__ part_sum, int* __restrict__ prev_tok,
                                    int* __restrict__ ended, float* __restrict__ logp_sum, int* __restrict__ tokens,
                                    int step, int L, int eos_id, int pad_id) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= B) return;
  float top_v = 0.0f;
  int top_i = 0;
  const float lse = merge_row((size_t)row, n_tiles, 1, part_val, part_idx, part_max, part_sum,
                              [&](int, float v, int i) {
                                top_v = v;
                                top_i = i;
                              });
  if (lane == 0) {
    const bool was_ended = ended[row] != 0;
    const int tok = was_ended ? pad_id : top_i;
    if (!was_ended) logp_sum[row] += top_v - lse;
    tokens[(size_t)row * L + step] = tok;
    prev_tok[row] = tok;
    ended[row] = (was_ended || tok == eos_id) ? 1 : 0;
  }
}

template <typename T>
cudaError_t greedy_step_impl(const void* pk, const void* value, const float* attn_bias, const void* qw,
                             const void* qb, const void* emb, const void* vw, const float* vb, int n_cells,
                             void** ks, void** rs, void** bs, float* h, float* c, int* prev_tok, int* ended,
                             float* logp_sum, int* tokens, int step, int L, void* hidden, float* part_val,
                             int* part_idx, float* part_max, float* part_sum, int B, int S, int H, int He, int Dv,
                             int V, int eos_id, int pad_id, cudaStream_t stream) {
  if (n_cells < 1 || n_cells > MAX_CELLS) return cudaErrorInvalidValue;
  Cells<T> cells;
  cells.n = n_cells;
  for (int i = 0; i < n_cells; ++i) {
    cells.kernel[i] = static_cast<const T*>(ks[i]);
    cells.recurrent[i] = static_cast<const T*>(rs[i]);
    cells.bias[i] = static_cast<const T*>(bs[i]);
  }
  const size_t smem = sizeof(float) * ((size_t)H * 8 + He + Dv + S + 33);
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(las_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  las_step_kernel<T><<<B, STEP_THREADS, smem, stream>>>(
      static_cast<const T*>(pk), static_cast<const T*>(value), attn_bias, static_cast<const T*>(qw),
      static_cast<const T*>(qb), static_cast<const T*>(emb), cells, h, c, prev_tok, static_cast<T*>(hidden), S, H,
      He, Dv, pad_id);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const bool is_bf16 = sizeof(T) == 2;
  err = launch_vocab_tiles<T, float>(static_cast<const T*>(hidden), static_cast<const T*>(vw), vb, B, H, V, 1,
                                     is_bf16 ? ROUND_ONCE : ROUND_NONE, part_val, part_idx, part_max, part_sum,
                                     stream);
  if (err != cudaSuccess) return err;

  const int n_tiles = (V + VOCAB_TILE - 1) / VOCAB_TILE;
  const int threads = 256;
  const int blocks = (int)(((size_t)B * 32 + threads - 1) / threads);
  greedy_merge_kernel<<<blocks, threads, 0, stream>>>(B, n_tiles, part_val, part_idx, part_max, part_sum, prev_tok,
                                                      ended, logp_sum, tokens, step, L, eos_id, pad_id);
  return cudaGetLastError();
}

}  // namespace srt

extern "C" int las_greedy_step(int dtype_bf16, const void* pk, const void* value, const float* attn_bias,
                               const void* qw, const void* qb, const void* emb, const void* vw, const float* vb,
                               int n_cells, void** ks, void** rs, void** bs, float* h, float* c, int* prev_tok,
                               int* ended, float* logp_sum, int* tokens, int step, int L, void* hidden,
                               float* part_val, int* part_idx, float* part_max, float* part_sum, int B, int S, int H,
                               int He, int Dv, int V, int eos_id, int pad_id, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_bf16)
    err = srt::greedy_step_impl<__nv_bfloat16>(pk, value, attn_bias, qw, qb, emb, vw, vb, n_cells, ks, rs, bs, h, c,
                                               prev_tok, ended, logp_sum, tokens, step, L, hidden, part_val, part_idx,
                                               part_max, part_sum, B, S, H, He, Dv, V, eos_id, pad_id, st);
  else
    err = srt::greedy_step_impl<float>(pk, value, attn_bias, qw, qb, emb, vw, vb, n_cells, ks, rs, bs, h, c,
                                       prev_tok, ended, logp_sum, tokens, step, L, hidden, part_val, part_idx,
                                       part_max, part_sum, B, S, H, He, Dv, V, eos_id, pad_id, st);
  return static_cast<int>(err);
}
