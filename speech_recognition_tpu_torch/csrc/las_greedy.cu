// Kernel K4: one LAS greedy decode step.  C interface for ops/greedy_search.py (ctypes).
// Replaces greedy_search_pallas (speech_recognition_tpu/ops/pallas/search_kernel.py:237).
//
// Two routes, chosen by ops/las_step.py step_plan:
//  - bf16 (las_greedy_step_split): the split step of las_split.cu over the B rows (the query product, the
//    attention's scores and context kernels, one wgmma product per cell with the cell update as its epilogue),
//    then the vocab tile pass and the merge.  Each weight is read once for each 64-row tile of the batch (at B = 128,
//    twice) instead of once per batch row.  What bounds it at LAS-large: the attention's 200.5 MB of pk +
//    value a step from device memory (60 us at 3.35 TB/s), then the cells' 48 MB of weights;
//  - float32 (las_greedy_step), the checks' path, three launches a step:
//    1. las_step_kernel: one block of STEP_THREADS per batch row.  Embedding
//       gather, q = h @ qw + qb, masked attention scores (a warp per key frame),
//       float32 softmax, the context (a thread per value column), then the
//       threaded LSTM cell stack with pad gating (a thread per gate column).
//       Every vector lives in shared memory; every matvec is the block's own
//       loop, float32 accumulation.  h and c stay float32 across steps.  The
//       step's device code is in las_step.cuh, shared with the decoder forward (K2).
//       Each block reads every weight of the step.
//    2. the vocab tile pass (vocab_topk.cuh) over the step's hidden rows, k = 1
//       (CUDA-core FMAs in float32; wgmma and one bf16 rounding of (dot + float32
//       bias) on the bf16 route).
//    3. greedy_merge_kernel: K5's merge (top-1 and logsumexp) plus the EOS
//       bookkeeping: a row that has ended emits pad and stops adding logP.
#include "las_split.cuh"
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

// The step's vocab tile pass over the hidden rows (one bf16 rounding of dot + float32 bias in bf16) and the merge
template <typename T>
cudaError_t greedy_tail(const void* hidden, const void* vw, const float* vb, int* prev_tok, int* ended,
                        float* logp_sum, int* tokens, int step, int L, float* part_val, int* part_idx,
                        float* part_max, float* part_sum, int B, int H, int V, int eos_id, int pad_id,
                        const TilePlan& plan, cudaStream_t stream) {
  const bool is_bf16 = sizeof(T) == 2;
  cudaError_t err = launch_vocab_tiles<T, float>(static_cast<const T*>(hidden), static_cast<const T*>(vw), vb, B, H,
                                                 V, 1, is_bf16 ? ROUND_ONCE : ROUND_NONE, plan, part_val, part_idx,
                                                 part_max, part_sum, stream);
  if (err != cudaSuccess) return err;
  const int n_tiles = (V + VOCAB_TILE - 1) / VOCAB_TILE;
  const int threads = 256;
  const int blocks = (int)(((size_t)B * 32 + threads - 1) / threads);
  greedy_merge_kernel<<<blocks, threads, 0, stream>>>(B, n_tiles, part_val, part_idx, part_max, part_sum, prev_tok,
                                                      ended, logp_sum, tokens, step, L, eos_id, pad_id);
  return cudaGetLastError();
}

template <typename T>
cudaError_t greedy_step_impl(const void* pk, const void* value, const float* attn_bias, const void* qw,
                             const void* qb, const void* emb, const void* vw, const float* vb, int n_cells,
                             void** ks, void** rs, void** bs, float* h, float* c, int* prev_tok, int* ended,
                             float* logp_sum, int* tokens, int step, int L, void* hidden, float* part_val,
                             int* part_idx, float* part_max, float* part_sum, int B, int S, int H, int He, int Dv,
                             int V, int eos_id, int pad_id, const TilePlan& plan, cudaStream_t stream) {
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

  return greedy_tail<T>(hidden, vw, vb, prev_tok, ended, logp_sum, tokens, step, L, part_val, part_idx, part_max,
                        part_sum, B, H, V, eos_id, pad_id, plan, stream);
}

}  // namespace srt

// The float32 route's step n: every operand float32; h / c [B,H] in place.
extern "C" int las_greedy_step(const void* pk, const void* value, const float* attn_bias, const void* qw,
                               const void* qb, const void* emb, const void* vw, const float* vb, int n_cells, void** ks,
                               void** rs, void** bs, float* h, float* c, int* prev_tok, int* ended, float* logp_sum,
                               int* tokens, int step, int L, void* hidden, float* part_val, int* part_idx,
                               float* part_max, float* part_sum, int B, int S, int H, int He, int Dv, int V, int eos_id,
                               int pad_id, void* stream) {
  const cudaError_t err = srt::greedy_step_impl<float>(
      pk, value, attn_bias, qw, qb, emb, vw, vb, n_cells, ks, rs, bs, h, c, prev_tok, ended, logp_sum, tokens, step, L,
      hidden, part_val, part_idx, part_max, part_sum, B, S, H, He, Dv, V, eos_id, pad_id, srt::TilePlan{0, 0, 0},
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// The bf16 route's step n (las_split.cuh): h / c [B,H] float32 in place, hq [2,B,H] bf16 with rnd(h) in plane
// ``parity`` (the step leaves it in plane parity ^ (n_cells & 1)), q [B,H] float32, x0 [B, He + Dv] and xs
// [2,B,H] bf16 scratch; ws: each cell's gate-interleaved [Kc; Rc] (ops/las_step.py interleave_cell) with Hu
// units; bs: the cells' biases.  q_*, c_*: the query's and the cells' product plans, wgs, stage_k,
// tiles_per_block: the vocab pass's (ops/las_step.py step_plan).
extern "C" int las_greedy_step_split(const void* pk, const void* value, const float* attn_bias, const void* qw,
                                     const void* qb, const void* emb, const void* vw, const float* vb, int n_cells,
                                     void** ws, void** bs, float* h, float* c, void* hq, float* q, float* scores,
                                     void* x0, void* xs, int parity, int* prev_tok, int* ended, float* logp_sum,
                                     int* tokens, int step, int L, void* hidden, float* part_val, int* part_idx,
                                     float* part_max, float* part_sum, int B, int S, int H, int He, int Dv, int Hu,
                                     int V, int eos_id, int pad_id, int q_wgs, int q_panels, int c_wgs, int c_panels,
                                     int wgs, int stage_k, int tiles_per_block, void* stream) {
  using srt::wg::Bf;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_cells < 1 || n_cells > SPLIT_MAX_CELLS) return static_cast<int>(cudaErrorInvalidValue);
  srt::SplitStep s{};
  s.pk = static_cast<const Bf*>(pk);
  s.value = static_cast<const Bf*>(value);
  s.qw = static_cast<const Bf*>(qw);
  s.qb = static_cast<const Bf*>(qb);
  s.emb = static_cast<const Bf*>(emb);
  s.attn_bias = attn_bias;
  s.n_cells = n_cells;
  for (int i = 0; i < n_cells; ++i) {
    s.w[i] = static_cast<const Bf*>(ws[i]);
    s.bias[i] = static_cast<const Bf*>(bs[i]);
  }
  s.h = h;
  s.c = c;
  s.hq = static_cast<Bf*>(hq);
  s.q = q;
  s.scores = scores;
  s.x0 = static_cast<Bf*>(x0);
  s.xs = static_cast<Bf*>(xs);
  s.hidden = static_cast<Bf*>(hidden);
  s.B = B;
  s.K = 1;
  s.S = S;
  s.H = H;
  s.He = He;
  s.Dv = Dv;
  s.Hu = Hu;
  s.pad_id = pad_id;
  s.qp = srt::ProductPlan{q_wgs, q_panels};
  s.cp = srt::ProductPlan{c_wgs, c_panels};
  srt::SplitMaps maps;
  cudaError_t err = srt::split_prepare(s, &maps);
  if (err == cudaSuccess) err = srt::split_step(s, maps, prev_tok, 1, nullptr, parity, st);
  if (err == cudaSuccess)
    err = srt::greedy_tail<Bf>(hidden, vw, vb, prev_tok, ended, logp_sum, tokens, step, L, part_val, part_idx,
                               part_max, part_sum, B, H, V, eos_id, pad_id,
                               srt::TilePlan{wgs, stage_k, tiles_per_block}, st);
  return static_cast<int>(err);
}
