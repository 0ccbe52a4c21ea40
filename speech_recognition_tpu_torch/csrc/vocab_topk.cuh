// The vocab tile pass: the vocab projection reduced, tile by tile, to softmax
// statistics and a top-k, without writing the logits.  Pass 1 of kernel K5,
// and the vocab step of K1's and K6's forward, of K4 and of K11.  It serves
// vocab_topk_pallas (speech_recognition_tpu/ops/pallas/topk_kernel.py:176), the
// forward bodies of fused_ce_vocab (ce_kernel.py:60) and fused_vocab_emissions
// (ctc_kernel.py:64), and the vocab steps of greedy_search_pallas
// (search_kernel.py:237) and beam_search_pallas (beam_kernel.py:415).
//
// For rows hid [R, H], W [H, V] and a bias [V] (hid's type or float32) it
// writes, for each row and each tile of VOCAB_TILE vocab columns, the max of
// the tile's logits, the sum of exp(logit - max) and the top-k in lax.top_k's
// order (value descending, then the lower index), the logits rounded as asked
// (ROUND_NONE: dot + b; ROUND_ONCE: bf16(dot + b); ROUND_TWICE:
// bf16(bf16(dot) + b)) and columns >= V masked to -inf.  An optional hook
// (Gather: K1's labels, K6's ids) copies the logits of chosen columns out of
// the tile, so they are the very floats the max and the sum saw.  merge_row
// (pass 2) merges a row's partials; each caller has its own merge kernel.  A
// run flag (K11) ends a launch at its entry once the beam loop has ended.
//
// What bounds it: the 2 R H V operations at the bf16 tensor-core peak at K1,
// K6 and K5 (133 GFLOP at K1's R = 16,256, H = 256, V = 16000: 0.13 ms), and
// W's 8-10 MB read from L2 at K4's R = 128.  Design (bf16):
//  - a block of one, two or four warpgroups owns 64 rows each; its rows of
//    hid stay resident as K-major 128-byte-swizzled panels (csrc/wgmma.cuh),
//    and the block walks a range of vocab tiles, each W tile [H x 128]
//    arriving through a ring of four stages of stage_k 64-row k-panels (two
//    in flight while one is multiplied), read MN-major by every warpgroup.
//    The tensor memory accelerator (TMA) fills the ring: one thread issues a
//    [64 x 64] box per panel and an mbarrier per stage counts its bytes (a W
//    whose rows are not 16-byte aligned, V % 8 != 0, takes a staged copy);
//  - the product is wgmma m64n128k16 (bf16 in, float32 accumulators);
//  - the epilogue stays in registers: each thread holds 32 columns of two
//    rows, a row's 128 columns lie in one quad of lanes, and the bias,
//    rounding, mask, top-1 (whose value is the max), sum-exp and each further
//    top-k round reduce in four interleaved chains and then across the quad
//    by shuffles.  The epilogue is what bounds the pass: it is latency-bound,
//    so a block takes as many warpgroups as its rows allow (the registers are
//    capped at 128 a thread for four), which took K1 from ~0.82 to ~0.66 ms
//    on an H100 (tools/vocab_tiles_profile.py).  With the epilogue taken out,
//    the TMA ring and the products alone run K1 about three times as fast;
//  - the launch plan (warpgroups, stage_k, the vocab range a block walks so
//    that the grid fills the card at every caller's R) is plain Python,
//    ops/vocab_topk.py tile_plan.
// The kernel is a template on its pass: TopkPass (the above: rows read from
// hid, per-tile partials) or a caller's own, which builds the rows in the
// block's panels and reduces the tiles in registers (the RNN-T joint's
// forward, JointPass in csrc/transducer_joint.cu: h = tanh(enc + pred) built
// in the prologue, a running max and sum-exp per row across all the tiles,
// the blank and target logits read from the tile).
// float32 operands keep a CUDA-core FMA product (TF32 would not hold the
// float32 paths to 1e-5): a block of VOCAB_ROWS rows and one VOCAB_TILE tile,
// a thread per column, then one warp per row reduces the tile from shared
// memory.  The partials and their order are the same in both.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

#define VOCAB_TILE 128  // vocab columns of a partial = kernels.VOCAB_TILE in Python
#define VOCAB_ROWS 32   // rows of a float32 block

namespace srt {

enum Rounding { ROUND_NONE = 0, ROUND_ONCE = 1, ROUND_TWICE = 2 };

// The label / gather hook (K1, K6).  Row r reads ids row r / T_rows: ``list``
// holds each ids row's K ids sorted by (id, k), then their k ([rows][2][K],
// from id_sort_kernel), or for K == 1 the ids themselves ([rows]).  Output
// vals [R, K] float32: vals[r, k] = the logit of column id_k, 0 for an id
// outside [0, V).  list == nullptr: no hook.
struct Gather {
  const int* list;
  float* vals;
  int T_rows, K;
};

// The launch plan of the bf16 pass, from ops/vocab_topk.py tile_plan.
struct TilePlan {
  int wgs, stage_k, tiles_per_block;
};

// The ids of one batch row in (id, k) order for the hook: grid (rows of ids),
// list[b][0][p] = the p-th id of ids[b, :K], list[b][1][p] = its k.
static __global__ void id_sort_kernel(const int* __restrict__ ids, int K, int* __restrict__ list) {
  const int* row = ids + (size_t)blockIdx.x * K;
  int* out = list + (size_t)blockIdx.x * 2 * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int id = row[k];
    int rank = 0;
    for (int k2 = 0; k2 < K; ++k2) {
      const int o = row[k2];
      rank += o < id || (o == id && k2 < k);
    }
    out[rank] = id;
    out[K + rank] = k;
  }
}

// row r's sorted ids (pointer to list position 0) and the k of position p
__device__ __forceinline__ const int* gather_ids(const Gather& g, size_t r) {
  return g.K == 1 ? g.list + r / g.T_rows : g.list + r / g.T_rows * 2 * g.K;
}
__device__ __forceinline__ int gather_k(const Gather& g, const int* ids, int p) { return g.K == 1 ? 0 : ids[g.K + p]; }

template <int RND>
__device__ __forceinline__ float round_logit(float dot, float b) {
  if (RND == ROUND_TWICE) return bf16_grid(bf16_grid(dot) + b);
  if (RND == ROUND_ONCE) return bf16_grid(dot + b);
  return dot + b;
}

__device__ __forceinline__ float round_logit(float dot, float b, int rounding) {
  if (rounding == ROUND_TWICE) return round_logit<ROUND_TWICE>(dot, b);
  if (rounding == ROUND_ONCE) return round_logit<ROUND_ONCE>(dot, b);
  return round_logit<ROUND_NONE>(dot, b);
}

// ---------------------------------------------------------------- float32: CUDA-core FMAs
// grid (vocab tile, block of VOCAB_ROWS rows), VOCAB_TILE threads.  The block
// stages its rows of hid in shared memory as float, transposed so that four
// rows load as one float4 broadcast; each thread accumulates its column for
// all rows, applies bias and rounding and writes the tile back into the same
// shared memory; one warp per row reduces it rank by rank.
static __global__ void __launch_bounds__(VOCAB_TILE)
    vocab_tile_f32_kernel(const float* __restrict__ hid, const float* __restrict__ W, const float* __restrict__ bias,
                          int R, int H, int V, int k, int rounding, float* __restrict__ part_val,
                          int* __restrict__ part_idx, float* __restrict__ part_max, float* __restrict__ part_sum,
                          const int* __restrict__ run_flag, const Gather g) {
  if (run_flag != nullptr && *run_flag == 0) return;  // the beam loop (K11) has ended
  extern __shared__ __align__(16) float smem[];  // VOCAB_ROWS * max(H, VOCAB_TILE) floats
  const int tile = blockIdx.x, n_tiles = gridDim.x;
  const int r0 = blockIdx.y * VOCAB_ROWS;
  const int rows = min(VOCAB_ROWS, R - r0);
  const int tid = threadIdx.x, v0 = tile * VOCAB_TILE;

  for (int e = tid; e < VOCAB_ROWS * H; e += blockDim.x) {
    const int r = e / H, h = e - r * H;
    smem[h * VOCAB_ROWS + r] = r < rows ? hid[(size_t)(r0 + r) * H + h] : 0.0f;
  }
  __syncthreads();

  const int v = v0 + tid;
  float acc[VOCAB_ROWS];
#pragma unroll
  for (int r = 0; r < VOCAB_ROWS; ++r) acc[r] = 0.0f;
  if (v < V) {
    const float* wcol = W + v;
    for (int h = 0; h < H; ++h) {
      const float w = wcol[(size_t)h * V];
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
  const float b = v < V ? bias[v] : 0.0f;
  __syncthreads();  // every thread is done reading the staged rows

#pragma unroll
  for (int r = 0; r < VOCAB_ROWS; ++r)
    smem[r * VOCAB_TILE + tid] = v < V ? round_logit(acc[r], b, rounding) : -INFINITY;
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
        const int gi = v0 + j;
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
    if (g.list != nullptr) {
      const size_t rr = (size_t)(r0 + r);
      const int* ids = gather_ids(g, rr);
      for (int p = lane; p < g.K; p += 32) {
        const int id = ids[p];
        if (id >= v0 && id < min(V, v0 + VOCAB_TILE))
          g.vals[rr * g.K + gather_k(g, ids, p)] = row[id - v0];
        else if (tile == 0 && (id < 0 || id >= V))
          g.vals[rr * g.K + gather_k(g, ids, p)] = 0.0f;
      }
    }
  }
}

// ---------------------------------------------------------------- bf16: wgmma
namespace vt {

using namespace wg;  // PANEL, ROW_BYTES, WG_ROWS, W_PANEL, ALIGN and the PTX helpers

constexpr int COLS = VOCAB_TILE;       // columns of a W tile: the wgmma N
constexpr int KP_BYTES = 2 * W_PANEL;  // one 64-row k-panel of a W tile: its two [64 x 64] column panels
// Ring stages: a stage holds stage_k k-panels of a W tile; two are in flight
// while one is multiplied, with one wgmma group running on.
constexpr int STAGES = 4, IN_FLIGHT = STAGES - 2;
constexpr int MAX_WGS = 4;         // warpgroups of a block: the epilogue is latency-bound, more warps hide more
constexpr int MAX_SMEM = 232448;   // dynamic shared memory one block may use on the H100

// Dynamic shared memory of the pass (ops/vocab_topk.py mirrors it): the rows of hid, then the ring.
inline size_t smem_bytes(int n_k, int wgs, int stage_k) {
  return ALIGN + (size_t)n_k * wgs * WG_ROWS * ROW_BYTES + (size_t)STAGES * stage_k * KP_BYTES;
}

// The thread's cells of a 64 x 128 accumulator: z[4j + 2 half + e] is row
// 16 warp + lane / 4 + 8 half, column 8j + 2 (lane % 4) + e, j < 16.  Cell c
// (0..31) of a half is (j, e) = (c / 2, c % 2), in increasing column order.
__device__ __forceinline__ int cell(int c, int half) { return 4 * (c >> 1) + 2 * half + (c & 1); }
__device__ __forceinline__ int cell_col(int c) { return 8 * (c >> 1) + (c & 1); }

// column col (0..127, one of this thread's) of row half ``half``
__device__ __forceinline__ float pick(const float (&z)[64], int half, int col) {
  const int j = col >> 3, e = col & 1;
  float x = 0.0f;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int ee = 0; ee < 2; ++ee) x = (jj == j && ee == e) ? z[4 * jj + 2 * half + ee] : x;
  return x;
}

// the bias of columns v, v + 1 (v even), 0 past V; one load where the pair is aligned
__device__ __forceinline__ float2 bias_pair(const float* __restrict__ bias, int v, int V) {
  if (v + 1 < V && (reinterpret_cast<uintptr_t>(bias + v) & 7) == 0) return *reinterpret_cast<const float2*>(bias + v);
  return make_float2(v < V ? bias[v] : 0.0f, v + 1 < V ? bias[v + 1] : 0.0f);
}
__device__ __forceinline__ float2 bias_pair(const Bf* __restrict__ bias, int v, int V) {
  if (v + 1 < V && (reinterpret_cast<uintptr_t>(bias + v) & 3) == 0)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + v));
  return make_float2(v < V ? __bfloat162float(bias[v]) : 0.0f, v + 1 < V ? __bfloat162float(bias[v + 1]) : 0.0f);
}

// bias, rounding and the mask of columns >= V, for both rows of the thread
template <int RND, typename BT>
__device__ __forceinline__ void bias_round_mask(float (&z)[64], const BT* __restrict__ bias, int vq, int V) {
#pragma unroll
  for (int c = 0; c < 32; c += 2) {  // cells c, c + 1: columns vq + 8 (c / 2) and the next one
    const int v = vq + cell_col(c);
    const float2 b = bias_pair(bias, v, V);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float& x0 = z[cell(c, hf)];
      float& x1 = z[cell(c + 1, hf)];
      x0 = v < V ? round_logit<RND>(x0, b.x) : -INFINITY;
      x1 = v + 1 < V ? round_logit<RND>(x1, b.y) : -INFINITY;
    }
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ void quad_best(float& v, int& i) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// What a tile's epilogue reads besides the accumulators.
struct Epilogue {
  int R, V, k, rounding, n_tiles, q;
  size_t row_a;  // this thread's rows: row_a (half 0) and row_a + 8 (half 1)
  float* part_val;
  int* part_idx;
  float* part_max;
  float* part_sum;
  Gather g;
};

// z += this warpgroup's rows (A at a_rows, panels a_stride bytes apart) x k-panels kp0 .. kp0 + nkp - 1 of
// the W stage at st, as one committed wgmma group, not waited for
__device__ __forceinline__ void mma_stage(float (&z)[64], uint32_t a_rows, int a_stride, int kp0, uint32_t st,
                                          int nkp) {
  wg_arrive();
  for (int kp = 0; kp < nkp; ++kp)
#pragma unroll
    for (int s = 0; s < 4; ++s)
      mma_ss_n128(z, kmajor(a_rows + (kp0 + kp) * a_stride + 32 * s), mnmajor(st + kp * KP_BYTES + 2048 * s, W_PANEL));
  wg_commit();
}

__device__ __forceinline__ void zero(float (&z)[64]) {
#pragma unroll
  for (int c = 0; c < 64; ++c) z[c] = 0.0f;
}

// The thread's best cell of row half ``half``, in lax.top_k's order (value
// descending, then the lower index), among the cells ranked below (pv, pi)
// (every valid one when FIRST), as (value, vocab index); (-inf, INT_MAX) when
// there is none.  Four chains of interleaved cells run side by side (a
// single chain of 32 dependent compares left the epilogue latency-bound),
// then merge.
template <bool FIRST>
__device__ __forceinline__ void best_cell(const float (&z)[64], int half, int vq, int V, float pv, int pi, float& bv,
                                          int& bi) {
  float cv[4];
  int ci[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    cv[j] = -INFINITY;
    ci[j] = INT_MAX;
  }
#pragma unroll
  for (int c = 0; c < 32; ++c) {  // a chain visits its cells in increasing index: ties keep the first
    const float x = z[cell(c, half)];
    const int gi = vq + cell_col(c);
    const bool ok = FIRST || (gi < V && better(pv, pi, x, gi));  // masked cells hold -inf: never > -inf
    if (ok && x > cv[c & 3]) {
      cv[c & 3] = x;
      ci[c & 3] = gi;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; j += 2)
    if (better(cv[j + 1], ci[j + 1], cv[j], ci[j])) {
      cv[j] = cv[j + 1];
      ci[j] = ci[j + 1];
    }
  const bool hi = better(cv[2], ci[2], cv[0], ci[0]);
  bv = hi ? cv[2] : cv[0];
  bi = hi ? ci[2] : ci[0];
}

// Tile t's epilogue on its finished accumulators: bias, rounding, mask, then per row half the partials
// (the top-1, whose value is the max, the sum-exp, the other top-k ranks) and the gather hook, whose
// cursors pos[] walk the sorted ids.
template <typename BT>
__device__ __forceinline__ void tile_epilogue(float (&z)[64], int t, const Epilogue& e, const BT* __restrict__ bias,
                                              int (&pos)[2]) {
  const int q = e.q, V = e.V, k = e.k;
  const int v0 = t * COLS, vq = v0 + 2 * q;
  if (e.rounding == ROUND_TWICE) bias_round_mask<ROUND_TWICE>(z, bias, vq, V);
  else if (e.rounding == ROUND_ONCE) bias_round_mask<ROUND_ONCE>(z, bias, vq, V);
  else bias_round_mask<ROUND_NONE>(z, bias, vq, V);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const size_t row = e.row_a + 8 * hf;
    const bool valid = row < (size_t)e.R;
    float bv;
    int bi;
    best_cell<true>(z, hf, vq, V, 0.0f, 0, bv, bi);
    quad_best(bv, bi);
    const float m = bv;  // the tile's max: its first top-k value (columns >= V hold -inf)
    float sp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 32; ++c) sp[c & 3] += __expf(z[cell(c, hf)] - m);
    const float s = quad_sum((sp[0] + sp[1]) + (sp[2] + sp[3]));
    const size_t part = row * e.n_tiles + t;
    if (valid && q == 0) {
      e.part_max[part] = m;
      e.part_sum[part] = s;
      e.part_val[part * k] = bv;
      e.part_idx[part * k] = bi;
    }
    for (int r = 1; r < k; ++r) {
      best_cell<false>(z, hf, vq, V, bv, bi, bv, bi);
      quad_best(bv, bi);
      if (valid && q == 0) {
        e.part_val[part * k + r] = bv;
        e.part_idx[part * k + r] = bi;
      }
    }
    if (e.g.list != nullptr && valid) {  // the hook: every k whose id is one of this thread's columns
      const Gather& g = e.g;
      const int* ids = gather_ids(g, row);
      const int v_end = min(V, v0 + COLS);
      int last_id = -1;
      float last = 0.0f;
      for (; pos[hf] < g.K; ++pos[hf]) {
        const int id = ids[pos[hf]];
        if (id >= v_end) break;
        const int col = id - v0;
        if (((col >> 1) & 3) == q) {
          if (id != last_id) {
            last = pick(z, hf, col);
            last_id = id;
          }
          g.vals[row * g.K + gather_k(g, ids, pos[hf])] = last;
        }
      }
    }
  }
}

// The top-k pass of K5, K1, K6, K4 and K11: the block's rows of hid [R, H] copied into its panels, each
// tile's partials (max, sum-exp, top-k) written out, and the gather hook.
struct TopkPass {
  const Bf* hid;
  int h_al;  // hid's rows start 16-byte aligned: cp.async, else staged copies
  int k, rounding;
  float* part_val;
  int* part_idx;
  float* part_max;
  float* part_sum;
  Gather g;

  struct State {
    Epilogue epi;
    int pos[2];  // the hook's cursor in each row's sorted ids
  };

  __device__ __forceinline__ void load_rows(uint32_t hs, int bm, size_t r0, int R, int H, int n_k, int tid,
                                            int nthr) const {
    for (int kp = 0; kp < n_k; ++kp)
      load_panel(hs + kp * bm * ROW_BYTES, bm, hid, H, h_al, r0, (long long)R - (long long)r0, kp * PANEL,
                 H - kp * PANEL, tid, nthr);
  }

  // this thread's rows: row_a (half 0) and row_a + 8 (half 1); the block walks tiles from t0
  __device__ __forceinline__ void begin(State& st, size_t row_a, int q, int t0, int R, int V, int n_tiles) const {
    st.epi = Epilogue{R, V, k, rounding, n_tiles, q, row_a, part_val, part_idx, part_max, part_sum, g};
    st.pos[0] = st.pos[1] = 0;
    if (g.list == nullptr) return;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const size_t row = row_a + 8 * hf;
      if (row >= (size_t)R) continue;
      const int* ids = gather_ids(g, row);
      int lo = 0, hi = g.K;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ids[mid] < t0 * COLS) lo = mid + 1;
        else hi = mid;
      }
      st.pos[hf] = lo;
      if (t0 == 0 && q == 0)  // ids outside [0, V) never meet a tile: their value is 0
        for (int p = 0; p < g.K; ++p)
          if (ids[p] < 0 || ids[p] >= V) g.vals[row * g.K + gather_k(g, ids, p)] = 0.0f;
    }
  }

  template <typename BT>
  __device__ __forceinline__ void tile(float (&z)[64], int t, State& st, const BT* __restrict__ bias) const {
    tile_epilogue(z, t, st.epi, bias, st.pos);
  }

  __device__ __forceinline__ void finish(State&) const {}
};

// grid (row block, vocab range), 128 wgs threads.  Shared memory: the block's
// rows (n_k panels of [64 wgs x 64], filled by the pass), then the ring of W.
// The block walks tiles t0 .. t1 - 1; unit i of the stream is tile t0 + i / upt's
// k-panels [sk (i % upt), sk (i % upt + 1)).  A stage is refilled once every
// product that read it is done: one wgmma group stays in flight while the
// next stage is waited for, none across a tile's epilogue.
template <typename BT, typename Pass>
__global__ void __launch_bounds__(128 * MAX_WGS, 1)
    vocab_tile_mma_kernel(const Bf* __restrict__ W, int w_al, const __grid_constant__ CUtensorMap w_map,
                          const BT* __restrict__ bias, int R, int H, int V, int stage_k, int tiles_per_block,
                          const int* __restrict__ run_flag, const Pass pass) {
  if (run_flag != nullptr && *run_flag == 0) return;  // the beam loop (K11) has ended
  constexpr int S = STAGES, D = IN_FLIGHT;
  extern __shared__ uint8_t vt_smem[];
  __shared__ __align__(8) uint64_t vt_bars[STAGES];  // TMA: stage s has landed (one phase a fill)
  const bool tma = w_al;  // W's rows are 16-byte aligned: the tensor memory accelerator streams it
  const uint32_t base = (smem_addr(vt_smem) + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const int tid = threadIdx.x, nthr = blockDim.x, wgi = tid >> 7;
  const int warp = (tid & 127) >> 5, lane = tid & 31, q = lane & 3;
  const int bm = nthr / 2;  // 64 rows per warpgroup
  const int n_k = (H + PANEL - 1) / PANEL, n_tiles = (V + COLS - 1) / COLS;
  const size_t r0 = (size_t)blockIdx.x * bm;
  const int t0 = blockIdx.y * tiles_per_block, t1 = min(n_tiles, t0 + tiles_per_block);
  const int sk = stage_k, upt = (n_k + sk - 1) / sk, n_units = (t1 - t0) * upt;
  const uint32_t hs = base, ring = base + n_k * bm * ROW_BYTES;
  const int stage_bytes = sk * KP_BYTES;

  const uint32_t bars = smem_addr(vt_bars);

  // unit i: TMA boxes issued by thread 0 onto the stage's mbarrier, or (W's rows not 16-byte aligned) staged
  // copies by every thread
  auto issue = [&](int i) {
    if (i < n_units) {
      const int t = t0 + i / upt, kp0 = (i % upt) * sk, nkp = min(sk, n_k - kp0);
      const uint32_t st = ring + (i % S) * stage_bytes, bar = bars + (i % S) * 8;
      if (tma) {
        if (tid == 0) {
          mbar_expect_tx(bar, nkp * KP_BYTES);
          for (int kp = 0; kp < nkp; ++kp)
            for (int np = 0; np < 2; ++np)
              tma_load_2d(st + kp * KP_BYTES + np * W_PANEL, &w_map, t * COLS + np * PANEL, (kp0 + kp) * PANEL, bar);
        }
      } else {
        for (int kp = 0; kp < nkp; ++kp)
          for (int np = 0; np < 2; ++np) {
            const int kr = (kp0 + kp) * PANEL, c0 = t * COLS + np * PANEL;
            load_panel(st + kp * KP_BYTES + np * W_PANEL, PANEL, W, V, 0, kr, H - kr, c0, V - c0, tid, nthr);
          }
      }
    }
  };
  pass.load_rows(hs, bm, r0, R, H, n_k, tid, nthr);
  cp_async_commit();
  if (tma && tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + 8 * s, 1);
    fence_mbar_init();
  }
  __syncthreads();
  for (int i = 0; i < D; ++i) issue(i);  // the first W units in flight while the rows land
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();

  // this thread's rows: row_a (half 0) and row_a + 8 (half 1)
  const size_t row_a = r0 + 64 * wgi + 16 * warp + (lane >> 2);
  typename Pass::State state;
  pass.begin(state, row_a, q, t0, R, V, n_tiles);

  int i = 0;
  // unit i has landed for every thread and the stage of unit i + D is free: start its copy
  auto next = [&]() {
    if (tma) mbar_wait(bars + (i % S) * 8, (i / S) & 1);
    fence_async_smem();
    __syncthreads();
    issue(i + D);
    return ring + (i % S) * stage_bytes;
  };
  const uint32_t a_rows = hs + WG_ROWS * wgi * ROW_BYTES;
  const int a_stride = bm * ROW_BYTES;
  for (int t = t0; t < t1; ++t) {
    float z[64];
    zero(z);
    for (int u = 0; u < upt; ++u, ++i) {
      const uint32_t st = next();
      mma_stage(z, a_rows, a_stride, u * sk, st, min(sk, n_k - u * sk));
      wg_wait<1>();
    }
    wg_wait<0>();
    reg_fence(z);
    pass.tile(z, t, state, bias);
  }
  pass.finish(state);
}

}  // namespace vt

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

// The bf16 pass over R rows of width H (the pass's own rows) against W [H, V]: launch plan ``plan``
// (ops/vocab_topk.py tile_plan).
template <typename BT, typename Pass>
cudaError_t launch_tile_pass(const wg::Bf* W, const BT* bias, int R, int H, int V, const TilePlan& plan,
                             const Pass& pass, cudaStream_t stream, const int* run_flag = nullptr) {
  const int n_tiles = (V + VOCAB_TILE - 1) / VOCAB_TILE;
  const int n_k = (H + wg::PANEL - 1) / wg::PANEL;
  if (plan.wgs < 1 || plan.wgs > vt::MAX_WGS || plan.stage_k < 1 || plan.stage_k > n_k || plan.tiles_per_block < 1)
    return cudaErrorInvalidValue;
  const size_t smem = vt::smem_bytes(n_k, plan.wgs, plan.stage_k);
  if (smem > (size_t)vt::MAX_SMEM) return cudaErrorInvalidValue;
  const int bm = wg::WG_ROWS * plan.wgs;
  const dim3 grid((R + bm - 1) / bm, (n_tiles + plan.tiles_per_block - 1) / plan.tiles_per_block);
  auto kernel = vt::vocab_tile_mma_kernel<BT, Pass>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int w_al = wg::aligned16(W, (size_t)V);
  CUtensorMap w_map{};
  if (w_al && (err = wg::panel_map(&w_map, W, H, V)) != cudaSuccess) return err;
  kernel<<<grid, 2 * bm, smem, stream>>>(W, w_al, w_map, bias, R, H, V, plan.stage_k, plan.tiles_per_block, run_flag,
                                         pass);
  return cudaGetLastError();
}

// Pass 1 over rows hid [R, H]: float32 operands on the CUDA cores, bf16 on
// wgmma with ``plan``.  Partials: part_val / part_idx [R, n_tiles, k],
// part_max / part_sum [R, n_tiles], n_tiles = ceil(V / VOCAB_TILE).
template <typename T, typename BT>
cudaError_t launch_vocab_tiles(const T* hid, const T* W, const BT* bias, int R, int H, int V, int k, int rounding,
                               const TilePlan& plan, float* part_val, int* part_idx, float* part_max, float* part_sum,
                               cudaStream_t stream, const int* run_flag = nullptr, const Gather& g = Gather{}) {
  const int n_tiles = (V + VOCAB_TILE - 1) / VOCAB_TILE;
  if constexpr (std::is_same<T, float>::value) {
    static_assert(std::is_same<BT, float>::value, "float32 operands take a float32 bias");
    const dim3 grid(n_tiles, (R + VOCAB_ROWS - 1) / VOCAB_ROWS);
    const size_t smem = sizeof(float) * VOCAB_ROWS * (H > VOCAB_TILE ? H : VOCAB_TILE);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(vocab_tile_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
      if (err != cudaSuccess) return err;
    }
    vocab_tile_f32_kernel<<<grid, VOCAB_TILE, smem, stream>>>(hid, W, bias, R, H, V, k, rounding, part_val, part_idx,
                                                              part_max, part_sum, run_flag, g);
    return cudaGetLastError();
  } else {
    const vt::TopkPass pass{hid, wg::aligned16(hid, (size_t)H), k, rounding, part_val, part_idx, part_max, part_sum,
                            g};
    return launch_tile_pass(W, bias, R, H, V, plan, pass, stream, run_flag);
  }
}

}  // namespace srt
