// Kernel K11: the whole LAS beam loop, steps 2..L-1, in one host call.  C interface for ops/beam_search.py (ctypes).
// Replaces beam_search_pallas (speech_recognition_tpu/ops/pallas/beam_kernel.py:415, step _beam_step_math :122).
//
// Rows are beam-major (row b*K + k).  Two routes, chosen by ops/las_step.py step_plan; each enqueues its
// launches for steps 2..L-1 without any host synchronisation and ends a step with the same two launches:
//  - bf16 (las_beam_search_split): the split step of las_split.cu over all B*K rows: the query product, the
//    attention (scores and context kernels whose blocks each hold all K beams of one batch row, so pk[b] and
//    value[b] are read once a step), one
//    wgmma product per cell with the cell update as its epilogue, each weight read once for every 64 or 128
//    rows instead of once per block of beams;
//  - float32 (las_beam_search), the checks' path: beam_step_kernel, one block of BEAM_THREADS per batch row b,
//    holding its K beams, or, where K beams' vectors exceed a block's shared memory
//    (LAS-large: 320 KB at K = 8, H = 1024, He + Dv = 3072), grid (B, K / KB)
//    of blocks of KB beams each (a beam's step reads no other beam).  Every
//    per-beam vector lives in shared memory beam-minor (element [i][k] at
//    i*KB + k, KB = the block's beams rounded up to a power of two), so
//    one float4 load brings four beams' values for one weight or key
//    element: the embedding gather, q = h @ qw + qb, the scores (a
//    warp per key frame) and the context (a thread per value column) read
//    pk[b] and value[b] once for all K beams; the threaded LSTM stack (a
//    thread per pair of gate columns) reads each weight element once per block.
//    h and c stay float32.
// Then, on both routes:
//  2. the vocab tile pass (vocab_topk.cuh) over the B*K hidden rows with
//     k = K and bf16(bf16(dot) + b) under bf16 (the beam path's bias is bf16):
//     wgmma under bf16, CUDA-core FMAs under float32.
//  3. beam_select_kernel: one block per batch row.  K5's merge of each beam
//     row's partials (a warp per beam), the K*K candidate scores with the
//     length penalty, the top-K in lax.top_k order (rank by rank, value
//     descending then the lower flat index), the new tokens, log-probs and
//     ended / first-EOS-length flags, the histories re-gathered by parent (a
//     thread per column: it reads the K entries of its column, then writes
//     them, so no other thread touches them), and the count of rows that
//     still have a live beam, live[step].
// Every kernel of step n returns at entry when live[n-1] == 0: once every
// beam has ended no later step changes anything, as when the XLA
// while_loop stops.
//
// What bounds the bf16 route at LAS-large's beam-8 (B = 128, K = 8, S = 255, H = 1024, V = 16000): the
// operations, 51.5 GFLOP of cell products and 33.6 of vocab projection a step at the tensor cores' rate, and
// the attention's 200.5 MB of pk + value a step from device memory.
#include "las_split.cuh"
#include "vocab_topk.cuh"

#define BEAM_THREADS 512
#define BEAM_MAX_K 16     // = ops/vocab_topk.py MAX_K
#define BEAM_MAX_CELLS 8  // = ops/greedy_search.py MAX_CELLS

namespace srt {

template <typename T>
struct BeamCells {
  const T* kernel[BEAM_MAX_CELLS];     // [in, 4H]
  const T* recurrent[BEAM_MAX_CELLS];  // [H, 4H]
  const T* bias[BEAM_MAX_CELLS];       // [4H]
  int n;
};

// Two adjacent floats (col even, W 8-byte aligned there)
__device__ __forceinline__ void load_pair(const float* p, float& w0, float& w1) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  w0 = v.x;
  w1 = v.y;
}

// beams_matvec for the two columns col and col + 1 (col even, ld even): one
// load brings both weights, one shared-memory row feeds 2 x KB products.
template <typename T, int KB>
__device__ __forceinline__ void beams_matvec2(const float* __restrict__ rows, const T* __restrict__ W, int n,
                                              size_t ld, int col, float (&acc0)[KB], float (&acc1)[KB]) {
  for (int a0 = 0; a0 < n; a0 += BEAM_LOADS) {
    float w0[BEAM_LOADS], w1[BEAM_LOADS];
#pragma unroll
    for (int u = 0; u < BEAM_LOADS; ++u) {
      w0[u] = w1[u] = 0.0f;
      if (a0 + u < n) load_pair(W + (size_t)(a0 + u) * ld + col, w0[u], w1[u]);
    }
#pragma unroll
    for (int u = 0; u < BEAM_LOADS; ++u) {
      if (a0 + u < n) {
        float r[KB];
        load_beams<KB>(rows + (a0 + u) * KB, r);
#pragma unroll
        for (int k = 0; k < KB; ++k) {
          acc0[k] = fmaf(r[k], w0[u], acc0[k]);
          acc1[k] = fmaf(r[k], w1[u], acc1[k]);
        }
      }
    }
  }
}

// Shared memory of beam_step_kernel, in floats per beam slot (x KB); ops/beam_search.py step_smem_bytes mirrors it.
__host__ __device__ __forceinline__ int step_smem_floats(int S, int H, int He, int Dv) {
  const int xw = He + Dv > H ? He + Dv : H;
  const int work = H + S > 4 * H ? H + S : 4 * H;
  return 3 * H + xw + work;
}

template <typename T, int KB>
__global__ void __launch_bounds__(BEAM_THREADS)
    beam_step_kernel(const T* __restrict__ pk, const T* __restrict__ value, const float* __restrict__ attn_bias,
                     const T* __restrict__ qw, const T* __restrict__ qb, const T* __restrict__ emb, BeamCells<T> cells,
                     float* __restrict__ h_state, float* __restrict__ c_state, const int* __restrict__ tokens,
                     const int* __restrict__ live, T* __restrict__ hidden, int K, int S, int H, int He, int Dv, int L,
                     int step, int pad_id) {
  if (live[step - 1] == 0) return;  // every beam has ended
  // this block's beams of batch row blockIdx.x: k0 .. k0 + Kl - 1
  const int k0 = blockIdx.y * KB, Kl = min(KB, K - k0);
  extern __shared__ __align__(16) float sm[];
  const int xw = He + Dv > H ? He + Dv : H;
  float* hc = sm;            // [H][KB]  h, float32
  float* cc = hc + H * KB;   // [H][KB]  c, float32
  float* hq = cc + H * KB;   // [H][KB]  h rounded to T (recurrent and query input)
  float* x = hq + H * KB;    // [xw][KB] cell input: [emb | ctx], then each cell's output
  float* work = x + xw * KB;
  float* q = work;           // [H][KB]  queries, then
  float* p = q + H * KB;     // [S][KB]  scores, then probabilities
  float* z = work;           // [4H][KB] gate pre-activations (after the attention)
  __shared__ int toks[KB];

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const size_t row0 = (size_t)b * K + k0;
  if (tid < KB) toks[tid] = tid < Kl ? tokens[(row0 + tid) * L + step - 1] : pad_id;  // slots >= Kl idle on pad
  for (int e = tid; e < H * KB; e += nt) {
    const int j = e / KB, k = e - j * KB;
    const float hv = k < Kl ? h_state[(row0 + k) * H + j] : 0.0f;
    hc[e] = hv;
    cc[e] = k < Kl ? c_state[(row0 + k) * H + j] : 0.0f;
    hq[e] = rnd<T>(hv);
  }
  __syncthreads();
  for (int e = tid; e < He * KB; e += nt) {
    const int j = e / KB, k = e - j * KB;
    x[e] = to_f(emb[(size_t)toks[k] * He + j]);  // exact table rows
  }

  // q = hq @ qw + qb (a thread per query column, all beams at once)
  for (int j = tid; j < H; j += nt) {
    float acc[KB] = {};
    beams_matvec<T, KB>(hq, qw, H, H, j, acc);
    const float bj = to_f(qb[j]);
#pragma unroll
    for (int k = 0; k < KB; ++k) q[j * KB + k] = acc[k] + bj;
  }
  __syncthreads();

  // scores[s][k] = q[k] . pk[b, s] + bias[b, s] (a warp per key frame)
  const T* pkb = pk + (size_t)b * S * H;
  const float* biasb = attn_bias + (size_t)b * S;
  for (int s = warp; s < S; s += n_warps) {
    float acc[KB] = {};
    for (int i = lane; i < H; i += 32) {
      const float kv = to_f(pkb[(size_t)s * H + i]);
      float r[KB];
      load_beams<KB>(q + i * KB, r);
#pragma unroll
      for (int k = 0; k < KB; ++k) acc[k] = fmaf(r[k], kv, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < KB; ++k) acc[k] = warp_sum(acc[k]);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < KB; ++k) p[s * KB + k] = acc[k] + biasb[s];
    }
  }
  __syncthreads();

  // float32 softmax over the S frames, a warp per beam slot
  for (int k = warp; k < KB; k += n_warps) {
    float mx = -INFINITY;
    for (int s = lane; s < S; s += 32) mx = fmaxf(mx, p[s * KB + k]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int s = lane; s < S; s += 32) {
      const float e = expf(p[s * KB + k] - mx);
      p[s * KB + k] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int s = lane; s < S; s += 32) p[s * KB + k] = p[s * KB + k] / sum;
  }
  __syncthreads();

  // ctx[d][k] = rnd(sum_s p[s][k] value[b, s, d]) (a thread per value column)
  const T* vb = value + (size_t)b * S * Dv;
  for (int d = tid; d < Dv; d += nt) {
    float acc[KB] = {};
    beams_matvec<T, KB>(p, vb, S, Dv, d, acc);
#pragma unroll
    for (int k = 0; k < KB; ++k) x[(He + d) * KB + k] = rnd<T>(acc[k]);
  }
  __syncthreads();

  // threaded LSTM stack: z = (x @ K + b) + hq @ R (a thread per pair of gate
  // columns; G = 4H is even), then the gated update
  const int G = 4 * H;
  int in_dim = He + Dv;
  for (int ci = 0; ci < cells.n; ++ci) {
    for (int j = 2 * tid; j < G; j += 2 * nt) {
      float a0[KB] = {}, a1[KB] = {};
      beams_matvec2<T, KB>(x, cells.kernel[ci], in_dim, G, j, a0, a1);
      const float b0 = to_f(cells.bias[ci][j]), b1 = to_f(cells.bias[ci][j + 1]);
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        z[j * KB + k] = a0[k] + b0;
        z[(j + 1) * KB + k] = a1[k] + b1;
        a0[k] = a1[k] = 0.0f;
      }
      beams_matvec2<T, KB>(hq, cells.recurrent[ci], H, G, j, a0, a1);
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        z[j * KB + k] += a0[k];
        z[(j + 1) * KB + k] += a1[k];
      }
    }
    __syncthreads();
    for (int e = tid; e < H * KB; e += nt) {
      const int j = e / KB, k = e - j * KB;
      const bool m = toks[k] != pad_id;  // pad-token gating: state frozen, output zero
      const float gi = sigmoidf(z[j * KB + k]), gf = sigmoidf(z[(H + j) * KB + k]);
      const float gg = tanhf(z[(2 * H + j) * KB + k]), go = sigmoidf(z[(3 * H + j) * KB + k]);
      const float cp = gf * cc[e] + gi * gg;
      const float hp = go * tanhf(cp);
      if (m) {
        hc[e] = hp;
        cc[e] = cp;
      }
      hq[e] = rnd<T>(hc[e]);
      x[e] = m ? rnd<T>(hp) : 0.0f;
    }
    __syncthreads();
    in_dim = H;
  }

  for (int e = tid; e < H * KB; e += nt) {
    const int j = e / KB, k = e - j * KB;
    if (k < Kl) {
      const size_t r = (row0 + k) * H + j;
      hidden[r] = from_f<T>(x[e]);
      h_state[r] = hc[e];
      c_state[r] = cc[e];
    }
  }
}

template <int KB>
__global__ void __launch_bounds__(BEAM_THREADS)
    beam_select_kernel(int K, int n_tiles, const float* __restrict__ part_val, const int* __restrict__ part_idx,
                       const float* __restrict__ part_max, const float* __restrict__ part_sum, int* __restrict__ tokens,
                       float* __restrict__ logp, int* __restrict__ ended, float* __restrict__ eoslen,
                       int* __restrict__ live, int L, int step, int eos_id, int pad_id, float alpha, float beta_den) {
  if (live[step - 1] == 0) return;  // every beam has ended
  __shared__ float top_v[KB * KB], cand_lp[KB * KB], score[KB * KB], lse[KB], old_logp[KB], old_eoslen[KB];
  __shared__ int top_i[KB * KB], old_ended[KB], sel[KB], parent[KB], new_tok[KB], new_ended[KB];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row0 = (size_t)b * K;
  const int KK = K * K;

  if (tid < K) {
    old_logp[tid] = logp[row0 + tid];
    old_ended[tid] = ended[row0 + tid];
    old_eoslen[tid] = eoslen[row0 + tid];
  }
  if (warp < K) {  // beam row b*K + warp: its top-K and logsumexp over the vocab tiles
    const float l = merge_row(row0 + warp, n_tiles, K, part_val, part_idx, part_max, part_sum,
                              [&](int q, float v, int i) {
                                if (lane == 0) {
                                  top_v[warp * K + q] = v;
                                  top_i[warp * K + q] = i;
                                }
                              });
    if (lane == 0) lse[warp] = l;
  }
  __syncthreads();

  const float cur_len = (float)(step + 1);  // a token written at position step makes length step + 1
  for (int f = tid; f < KK; f += nt) {
    const int pp = f / K;
    const bool e = old_ended[pp] != 0;
    const float c = old_logp[pp] + (e ? 0.0f : top_v[f] - lse[pp]);
    const float len = e ? old_eoslen[pp] : cur_len;
    cand_lp[f] = c;
    score[f] = c * powf((1.0f + len) / beta_den, alpha);
  }
  __syncthreads();

  if (warp == 0) {  // top-K of the K*K scores, rank by rank
    float pv = INFINITY;
    int pi = -1;
    for (int q = 0; q < K; ++q) {
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int f = lane; f < KK; f += 32) {
        const float x = score[f];
        if (better(pv, pi, x, f) && better(x, f, bv, bi)) {
          bv = x;
          bi = f;
        }
      }
      warp_best(bv, bi);
      if (lane == 0) sel[q] = bi < KK ? bi : 0;  // only a NaN score leaves no candidate
      pv = bv;
      pi = bi;
    }
  }
  __syncthreads();

  if (tid < K) {
    const int f = sel[tid], pp = f / K;
    const bool e = old_ended[pp] != 0;
    const int tok = e ? pad_id : top_i[f];
    parent[tid] = pp;
    new_tok[tid] = tok;
    new_ended[tid] = (e || tok == eos_id) ? 1 : 0;
    logp[row0 + tid] = cand_lp[f];
    ended[row0 + tid] = new_ended[tid];
    eoslen[row0 + tid] = e ? old_eoslen[pp] : cur_len;
  }
  __syncthreads();

  int* hist = tokens + row0 * L;
  for (int l = tid; l < L; l += nt) {
    int old[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k) old[k] = k < K ? hist[(size_t)k * L + l] : 0;
    for (int j = 0; j < K; ++j) {
      int v = 0;
#pragma unroll
      for (int k = 0; k < KB; ++k) v = k == parent[j] ? old[k] : v;
      hist[(size_t)j * L + l] = l == step ? new_tok[j] : v;
    }
  }
  if (tid == 0) {
    bool any_live = false;
    for (int k = 0; k < K; ++k) any_live |= new_ended[k] == 0;
    if (any_live) atomicAdd(live + step, 1);
  }
}

// The step kernel for kbs beams a block (a power of two up to BEAM_MAX_K)
template <typename T>
decltype(&beam_step_kernel<T, 1>) step_kernel_for(int kbs) {
  switch (kbs) {
    case 1: return beam_step_kernel<T, 1>;
    case 2: return beam_step_kernel<T, 2>;
    case 4: return beam_step_kernel<T, 4>;
    case 8: return beam_step_kernel<T, 8>;
    default: return beam_step_kernel<T, 16>;
  }
}

// The select kernel for K beams: its slots are K rounded up to a power of two
inline decltype(&beam_select_kernel<1>) select_kernel_for(int K) {
  return K <= 1 ? beam_select_kernel<1> : K <= 2 ? beam_select_kernel<2> : K <= 4 ? beam_select_kernel<4>
         : K <= 8 ? beam_select_kernel<8> : beam_select_kernel<16>;
}

// The end of step ``step`` on both routes: the vocab tile pass over the B*K hidden rows (top-K, bf16(bf16(dot) + b)
// in bf16) and the select kernel, each returning at entry once live[step - 1] == 0
template <typename T>
cudaError_t beam_tail(const T* hid, const void* vw, const void* vb, int* tokens, float* logp, int* ended,
                      float* eoslen, int* live, float* part_val, int* part_idx, float* part_max, float* part_sum, int B,
                      int K, int H, int V, int L, int step, int eos_id, int pad_id, float alpha, float beta_den,
                      const TilePlan& plan, cudaStream_t stream) {
  const int n_tiles = (V + VOCAB_TILE - 1) / VOCAB_TILE;
  const int rounding = sizeof(T) == 2 ? ROUND_TWICE : ROUND_NONE;
  cudaError_t err = launch_vocab_tiles<T, T>(hid, static_cast<const T*>(vw), static_cast<const T*>(vb), B * K, H, V,
                                             K, rounding, plan, part_val, part_idx, part_max, part_sum, stream,
                                             live + step - 1);
  if (err != cudaSuccess) return err;
  select_kernel_for(K)<<<B, BEAM_THREADS, 0, stream>>>(K, n_tiles, part_val, part_idx, part_max, part_sum, tokens,
                                                       logp, ended, eoslen, live, L, step, eos_id, pad_id, alpha,
                                                       beta_den);
  return cudaGetLastError();
}

template <typename T>
cudaError_t beam_search_impl(const void* pk, const void* value, const float* attn_bias, const void* qw,
                             const void* qb, const void* emb, const void* vw, const void* vb, int n_cells, void** ks,
                             void** rs, void** bs, float* h, float* c, int* tokens, float* logp, int* ended,
                             float* eoslen, int* live, void* hidden, float* part_val, int* part_idx, float* part_max,
                             float* part_sum, int B, int K, int S, int H, int He, int Dv, int V, int L, int step0,
                             int n_steps, int eos_id, int pad_id, float alpha, float beta_den, int kbs,
                             const TilePlan& plan, cudaStream_t stream) {
  // kbs: the beams of one step block, a power of two below 2K
  if (n_cells < 1 || n_cells > BEAM_MAX_CELLS || K < 1 || K > BEAM_MAX_K || step0 < 2 || n_steps < 0 ||
      step0 + n_steps > L || kbs < 1 || kbs > BEAM_MAX_K || (kbs & (kbs - 1)) != 0 || kbs >= 2 * K)
    return cudaErrorInvalidValue;
  BeamCells<T> cells;
  cells.n = n_cells;
  for (int i = 0; i < n_cells; ++i) {
    cells.kernel[i] = static_cast<const T*>(ks[i]);
    cells.recurrent[i] = static_cast<const T*>(rs[i]);
    cells.bias[i] = static_cast<const T*>(bs[i]);
  }
  const auto step_kernel = step_kernel_for<T>(kbs);
  const size_t smem = sizeof(float) * kbs * (size_t)step_smem_floats(S, H, He, Dv);
  cudaError_t err = cudaFuncSetAttribute(step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  T* hid = static_cast<T*>(hidden);
  for (int step = step0; step < step0 + n_steps; ++step) {
    step_kernel<<<dim3(B, (K + kbs - 1) / kbs), BEAM_THREADS, smem, stream>>>(
        static_cast<const T*>(pk), static_cast<const T*>(value), attn_bias, static_cast<const T*>(qw),
        static_cast<const T*>(qb), static_cast<const T*>(emb), cells, h, c, tokens, live, hid, K, S, H, He, Dv, L,
        step, pad_id);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = beam_tail<T>(hid, vw, vb, tokens, logp, ended, eoslen, live, part_val, part_idx, part_max, part_sum, B, K,
                       H, V, L, step, eos_id, pad_id, alpha, beta_den, plan, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace srt

// Steps step0 .. step0 + n_steps - 1 (the whole loop: 2 .. L-1).  Histories
// tokens [B, K, L] int32, log-probs logp [B, K], ended [B, K] int32 and eoslen
// [B, K] float32 (first EOS position + 1) are updated in place, as are h / c
// [B*K, H] float32.  live [L] int32 holds live[step0 - 1] = (any beam live at
// the start) and zeros.  hidden [B*K, H] and part_* ([B*K, ceil(V/VOCAB_TILE),
// K] and [B*K, ceil(V/VOCAB_TILE)]) are scratch.  beams_per_block: the step
// kernel's beams a block, a power of two below 2K (ops/beam_search.py
// beams_per_block).  beta_den = 1 + beta.  Every operand float32 (the float32 route).
extern "C" int las_beam_search(const void* pk, const void* value, const float* attn_bias, const void* qw,
                               const void* qb, const void* emb, const void* vw, const void* vb, int n_cells, void** ks,
                               void** rs, void** bs, float* h, float* c, int* tokens, float* logp, int* ended,
                               float* eoslen, int* live, void* hidden, float* part_val, int* part_idx, float* part_max,
                               float* part_sum, int B, int K, int S, int H, int He, int Dv, int V, int L, int step0,
                               int n_steps, int eos_id, int pad_id, float alpha, float beta_den, int beams_per_block,
                               void* stream) {
  const cudaError_t err = srt::beam_search_impl<float>(
      pk, value, attn_bias, qw, qb, emb, vw, vb, n_cells, ks, rs, bs, h, c, tokens, logp, ended, eoslen, live, hidden,
      part_val, part_idx, part_max, part_sum, B, K, S, H, He, Dv, V, L, step0, n_steps, eos_id, pad_id, alpha,
      beta_den, beams_per_block, srt::TilePlan{0, 0, 0}, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// The bf16 route (las_split.cuh) of steps step0 .. step0 + n_steps - 1, with the float32 route's state and
// scratch (above) and: hq [2, B*K, H] and xs [2, B*K, H] bf16 and q [B*K, H] float32 and x0 [B*K, He + Dv] bf16
// scratch; ws: each cell's gate-interleaved [Kc; Rc] (ops/las_step.py interleave_cell) with Hu units; bs: the
// cells' biases.  q_*, c_*: the query's and the cells' product plans; wgs, stage_k, tiles_per_block: the vocab
// pass's (ops/las_step.py step_plan).
extern "C" int las_beam_search_split(const void* pk, const void* value, const float* attn_bias, const void* qw,
                                     const void* qb, const void* emb, const void* vw, const void* vb, int n_cells,
                                     void** ws, void** bs, float* h, float* c, void* hq, float* q, float* scores,
                                     void* x0, void* xs, int* tokens, float* logp, int* ended, float* eoslen,
                                     int* live, void* hidden, float* part_val, int* part_idx, float* part_max,
                                     float* part_sum, int B, int K, int S, int H, int He, int Dv, int Hu, int V, int L,
                                     int step0, int n_steps, int eos_id, int pad_id, float alpha, float beta_den,
                                     int q_wgs, int q_panels, int c_wgs, int c_panels, int wgs, int stage_k,
                                     int tiles_per_block, void* stream) {
  using srt::wg::Bf;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_cells < 1 || n_cells > SPLIT_MAX_CELLS || K < 1 || K > BEAM_MAX_K || step0 < 2 || n_steps < 0 ||
      step0 + n_steps > L)
    return static_cast<int>(cudaErrorInvalidValue);
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
  s.K = K;
  s.S = S;
  s.H = H;
  s.He = He;
  s.Dv = Dv;
  s.Hu = Hu;
  s.pad_id = pad_id;
  s.qp = srt::ProductPlan{q_wgs, q_panels};
  s.cp = srt::ProductPlan{c_wgs, c_panels};
  const srt::TilePlan plan{wgs, stage_k, tiles_per_block};
  srt::SplitMaps maps;
  cudaError_t err = srt::split_prepare(s, &maps);
  if (err == cudaSuccess) err = srt::split_hq_init(s, st);
  int parity = 0;
  for (int step = step0; step < step0 + n_steps && err == cudaSuccess; ++step) {
    err = srt::split_step(s, maps, tokens + step - 1, L, live + step - 1, parity, st);
    if (err == cudaSuccess)
      err = srt::beam_tail<Bf>(s.hidden, vw, vb, tokens, logp, ended, eoslen, live, part_val, part_idx, part_max,
                               part_sum, B, K, H, V, L, step, eos_id, pad_id, alpha, beta_den, plan, st);
    parity ^= n_cells & 1;
  }
  return static_cast<int>(err);
}
