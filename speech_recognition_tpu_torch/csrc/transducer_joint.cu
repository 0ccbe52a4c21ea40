// Kernels K8 and K9: the RNN-Transducer joint network fused with the
// log-softmax planes the lattice loss reads, forward and backward.  C
// interface for ops/joint_planes.py (ctypes).
// Replaces fused_banded_planes (K8, speech_recognition_tpu/ops/pallas/band_kernel.py:354;
// bodies _fwd_kernel :168 and _bwd_kernel :260) and fused_joint_planes (K9,
// speech_recognition_tpu/ops/pallas/transducer_kernel.py:326; bodies :162 and :251).
//
// Both compute one function over a different set of lattice nodes, the slot
// map: row r = (b*T + t)*S + s is node (t, u) with u = p[b*T + t] + s (K8, the
// pruned band; S = s_range) or u = s (K9, p = NULL, S = U+1).  The prediction
// row is read at u clipped to [0, U]; the target id is ids[b, u] for u < U,
// else V, which is never gathered (its logit counts as 0, as in the Pallas
// kernels).  Per row: h = tanh(enc[b, t] + pred[b, u]) rounded to the compute
// type T after the add and after the tanh, logits z = h @ W + b in float32,
// and the planes lp_blank = z[blank] - lse, lp_emit = z[id] - lse.
//
// Forward, bf16: a pass of the vocab tile pass (csrc/vocab_topk.cuh,
// JointPass below): a block of one, two or four warpgroups of 64 rows builds
// their h straight into its resident K-major panels in the prologue (tanh
// once per row and column; h never reaches device memory), then walks all of
// V: each 128-column W tile arrives by TMA through the pass's ring and is
// multiplied by wgmma m64n128k16 into float32 accumulators, and each thread
// folds its two rows' 32 columns of the tile into a running max and sum-exp
// in registers, and copies the blank and target logits out of the tile when
// they are its columns (the floats the sums saw).  After the last tile the
// four lanes of a row's quad merge their sums; lse, lp_blank and lp_emit [R]
// float32 are written once.  What bounds it: the 2 R J V product operations
// at the bf16 tensor-core peak (1.34 TFLOP at K8's R = 130,560: 1.35 ms);
// like every caller of the pass it is held back by its epilogue (an exp, a
// max and an add per logit).  The plan is plain Python
// (ops/joint_planes.py joint_fwd_plan).
// Forward, float32: joint_fwd_kernel on the CUDA cores: a block owns 32 rows;
// it builds their h in shared memory and walks V in tiles of 256 columns, one
// column per thread; each tile of logits goes to shared memory, where one
// warp per row merges the tile's (max, sum-exp) into the row's running pair
// and picks the blank and target logits.  lse is the backward's residual.
//
// Backward, dz = -softmax (dlpb + dlpe) + onehot(blank) dlpb + onehot(id) dlpe,
// rounded to T before every product and before the bias sum, as the Pallas
// kernels round it.  No atomics: every sum has a fixed order, so a run
// repeats bit for bit.
//  - bf16: joint_h_kernel writes h [R, pad64(J)] (zero past J) once; then the
//    tensor-core engine of csrc/vocab_bwd.cuh (wgmma, cp.async rings) with
//    JointRows as its policy: per row lse, c = -(dlpb + dlpe) and the blank
//    and target columns, compared in registers; its row kernel writes dpre =
//    (rnd(dz) @ W^T)(1 - h^2) [R, J] float32, its column kernel dW = h^T
//    rnd(dz) and db = sum rnd(dz) as partials summed in order.  What bounds
//    it at B=128, T'=255, S=4, J=320, V=16000 (K8, R = 130,560 rows): three
//    1.34 TFLOP products (recompute, dh, dW) against ~43 MB of inputs, the
//    bf16 tensor-core peak; the engine keeps all three on the tensor cores,
//    J=320 in one block (no recompute per J chunk), and the logits out of
//    memory.
//  - float32, on the CUDA cores (tensor cores would mean TF32, and the float32
//    path is held to 1e-5 x max|ref|): joint_dpre_kernel (row kernel), grid
//    (32-row block, 320-column chunk of J), recomputes the logits tile by tile
//    from lse, forms dz in a transposed shared tile, accumulates dh = dz @ W^T
//    from staged chunks of W^T, and writes dpre and h [R, J]; joint_dw_kernel
//    (column kernel), grid (64-column vocab tile, J chunk, row split): each
//    block owns its dW columns over its rows, recomputing their logits; the
//    row splits' partials are summed in order.
//  - then joint_denc_kernel: denc[b, t] = sum over s of dpre, in s order;
//    joint_dpred_kernel: dpred[b, u] = sum over the (t, s) whose clipped node
//    is u, walking t in order (p is monotone in t, but the walk does not rely
//    on it).  Both round once to T.
#include <type_traits>

#include "common.cuh"
#include "vocab_bwd.cuh"
#include "vocab_topk.cuh"

#define TJ_ROWS 32       // rows per block of the row kernels and per chunk of the dW kernel
#define TJ_THREADS 256   // = TJ_TILE: one thread per vocab column of a tile
#define TJ_TILE 256      // vocab columns per tile of the row kernels
#define TJ_JCH 320       // J columns per block of the dpre and dW kernels (J = 320 on the main path)
#define TJ_JPT 5         // dh columns per thread of the dpre kernel: 64 x 5 = TJ_JCH
#define TJ_DLS 36        // row stride of the transposed dz tile (16-byte aligned, conflict-free float4 stores)
#define TJ_WCH 16        // vocab columns per staged chunk of W^T
#define TJ_DW_COLS 64    // vocab columns per block of the dW kernel
#define TJ_DW_HPT 80     // dW rows per thread: 4 thread groups x 80 = TJ_JCH

namespace srt {

// The slot map.  p == nullptr: u = s (every node, K9).
struct Slots {
  const int* p;
  int n_frames, S, U1, U;
};

// Row ``row``'s encoder row (b*T + t), its batch row b and label slot u, and its prediction row
// (b*(U+1) + clipped u)
__device__ __forceinline__ void rows_of(int row, const Slots& sl, int& erow, int& b, int& u, int& prow) {
  erow = row / sl.S;
  const int s = row - erow * sl.S;
  b = erow / sl.n_frames;
  u = (sl.p ? sl.p[erow] : 0) + s;
  prow = b * sl.U1 + min(max(u, 0), sl.U1 - 1);
}

// rows_of's encoder and prediction rows, and the row's target id (V when the slot has none)
__device__ __forceinline__ void node_of(int row, const Slots& sl, const int* __restrict__ ids, int V, int& erow,
                                        int& prow, int& id) {
  int b, u;
  rows_of(row, sl, erow, b, u, prow);
  id = (u >= 0 && u < sl.U) ? ids[(size_t)b * sl.U + u] : V;
}

// node_of for each row of the block
__device__ __forceinline__ void stage_nodes(int r0, int rows, const Slots& sl, const int* __restrict__ ids, int V,
                                            int* s_erow, int* s_prow, int* s_id) {
  const int r = threadIdx.x;
  if (r >= TJ_ROWS) return;
  int erow = 0, prow = 0, id = V;
  if (r < rows) node_of(r0 + r, sl, ids, V, erow, prow, id);
  s_erow[r] = erow;
  s_prow[r] = prow;
  s_id[r] = id;
}

// h of the block's rows, transposed: hs[j * TJ_ROWS + r] (0 beyond ``rows``)
template <typename T>
__device__ __forceinline__ float joint_h(const T* __restrict__ enc, const T* __restrict__ pred, int erow, int prow,
                                         int J, int j) {
  const float x = rnd<T>(to_f(enc[(size_t)erow * J + j]) + to_f(pred[(size_t)prow * J + j]));
  return rnd<T>(tanhf(x));
}

// acc[r] += sum_j hs[j][r] * W[j][v] over the block's 32 rows (K5's inner loop)
template <typename T>
__device__ __forceinline__ void column_dots(const float* hs, const T* __restrict__ W, int J, int V, int v,
                                            float (&acc)[TJ_ROWS]) {
#pragma unroll
  for (int r = 0; r < TJ_ROWS; ++r) acc[r] = 0.0f;
  if (v >= V) return;
  const T* wcol = W + v;
  for (int j = 0; j < J; ++j) {
    const float w = to_f(wcol[(size_t)j * V]);
    const float4* hr = reinterpret_cast<const float4*>(hs + j * TJ_ROWS);
#pragma unroll
    for (int r4 = 0; r4 < TJ_ROWS / 4; ++r4) {
      const float4 x = hr[r4];
      acc[4 * r4 + 0] = fmaf(x.x, w, acc[4 * r4 + 0]);
      acc[4 * r4 + 1] = fmaf(x.y, w, acc[4 * r4 + 1]);
      acc[4 * r4 + 2] = fmaf(x.z, w, acc[4 * r4 + 2]);
      acc[4 * r4 + 3] = fmaf(x.w, w, acc[4 * r4 + 3]);
    }
  }
}

// dz of one (row, column), before the rounding: the Pallas kernels' order of terms
__device__ __forceinline__ float joint_dz(float z, float lse, float gb, float ge, int v, int blank, int id) {
  float d = expf(z - lse) * (-(gb + ge));
  if (v == blank) d += gb;
  if (v == id) d += ge;
  return d;
}

constexpr int RPW = TJ_ROWS / (TJ_THREADS / 32);  // rows reduced per warp: warp, warp + 8, ...

// Merges a finished logits tile zt [TJ_ROWS][TJ_TILE] (bias added, -inf past V)
// into the running (max, sum-exp) of the rows warp + 8k, and picks their blank
// and target logits: the same floats the sums saw.
__device__ __forceinline__ void merge_tile(const float* zt, int v0, int V, int blank, const int* s_id, float* s_zb,
                                           float* s_zt, float (&run_m)[RPW], float (&run_s)[RPW]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int r = warp + k * (TJ_THREADS / 32);
    const float* row = zt + r * TJ_TILE;
    float m = -INFINITY;
    for (int j = lane; j < TJ_TILE; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float s = 0.0f;
    for (int j = lane; j < TJ_TILE; j += 32) s += expf(row[j] - m);
    s = warp_sum(s);
    const float mn = fmaxf(run_m[k], m);
    run_s[k] = run_s[k] * expf(run_m[k] - mn) + s * expf(m - mn);
    run_m[k] = mn;
    if (lane == 0) {
      if (blank >= v0 && blank < v0 + TJ_TILE) s_zb[r] = row[blank - v0];
      const int id = s_id[r];
      if (id >= v0 && id < v0 + TJ_TILE && id < V) s_zt[r] = row[id - v0];
    }
  }
}

using Bf = __nv_bfloat16;

template <typename T>
constexpr bool kTensorCores = std::is_same<T, Bf>::value;

// The bf16 forward as a pass of the vocab tile pass (vocab_topk.cuh vocab_tile_mma_kernel): rows are the
// joint rows, H = J, the bias bf16 added in float32 after the product (no rounding of the logits).
struct JointPass {
  const Bf* enc;   // [B, T, J]
  const Bf* pred;  // [B, U+1, J]
  const int* ids;  // [B, U]
  Slots sl;
  int R, J, V, blank;
  int vec;  // J % 8 == 0 and enc, pred 16-byte aligned: a 16-byte chunk of h from one load of each
  float* lpb;
  float* lpe;
  float* lse;

  struct State {
    size_t row_a;  // this thread's rows: row_a (half 0) and row_a + 8 (half 1)
    int q;
    float m[2], s[2];    // the running max of the thread's columns and their sum of exp(z - m)
    float zb[2], ze[2];  // the blank and target logits where they are the thread's columns, else 0
    int id[2];           // the target id, -1 where the slot has none or it lies outside [0, V)
  };

  // h = bf16(tanh(bf16(enc + pred))) of the block's rows into the K-major swizzled panels (zero past J and R),
  // one 16-byte chunk (8 columns of one row) per thread and step
  __device__ __forceinline__ void load_rows(uint32_t hs, int bm, size_t r0, int, int, int n_k, int tid,
                                            int nthr) const {
    const int chunks = n_k * 8;
    for (int e = tid; e < bm * chunks; e += nthr) {
      const int r = e / chunks, c = e - r * chunks, j0 = 8 * c;
      const size_t row = r0 + r;
      float h[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] = 0.0f;
      if (row < (size_t)R && j0 < J) {
        int erow, b, u, prow;
        rows_of((int)row, sl, erow, b, u, prow);
        const Bf* ep = enc + (size_t)erow * J + j0;
        const Bf* pp = pred + (size_t)prow * J + j0;
        float ev[8], pv[8];
        if (vec) {
          const uint4 e4 = *reinterpret_cast<const uint4*>(ep), p4 = *reinterpret_cast<const uint4*>(pp);
          const Bf* eb = reinterpret_cast<const Bf*>(&e4);
          const Bf* pb = reinterpret_cast<const Bf*>(&p4);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            ev[i] = __bfloat162float(eb[i]);
            pv[i] = __bfloat162float(pb[i]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            ev[i] = j0 + i < J ? __bfloat162float(ep[i]) : 0.0f;
            pv[i] = j0 + i < J ? __bfloat162float(pp[i]) : 0.0f;
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) h[i] = j0 + i < J ? rnd<Bf>(tanhf(rnd<Bf>(ev[i] + pv[i]))) : 0.0f;
      }
      wg::st_shared_v4(hs + (c >> 3) * bm * wg::ROW_BYTES + wg::swz(r, c & 7), wg::pack_bf16(h[0], h[1]),
                       wg::pack_bf16(h[2], h[3]), wg::pack_bf16(h[4], h[5]), wg::pack_bf16(h[6], h[7]));
    }
  }

  __device__ __forceinline__ void begin(State& st, size_t row_a, int q, int, int, int, int) const {
    st.row_a = row_a;
    st.q = q;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      st.m[hf] = -INFINITY;
      st.s[hf] = st.zb[hf] = st.ze[hf] = 0.0f;
      st.id[hf] = -1;
      const size_t row = row_a + 8 * hf;
      if (row < (size_t)R) {
        int erow, prow, id;
        node_of((int)row, sl, ids, V, erow, prow, id);
        st.id[hf] = id >= 0 && id < V ? id : -1;  // an id outside [0, V) never meets a tile: its logit counts as 0
      }
    }
  }

  // tile t's logits (bias added, -inf past V) folded into the running max and sum-exp of both rows
  template <typename BT>
  __device__ __forceinline__ void tile(float (&z)[64], int t, State& st, const BT* __restrict__ bias) const {
    const int v0 = t * vt::COLS;
    vt::bias_round_mask<ROUND_NONE>(z, bias, v0 + 2 * st.q, V);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float cm[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int c = 0; c < 32; ++c) cm[c & 3] = fmaxf(cm[c & 3], z[vt::cell(c, hf)]);
      const float mt = fmaxf(fmaxf(cm[0], cm[1]), fmaxf(cm[2], cm[3]));
      if (mt > st.m[hf]) {  // a new running max: rescale the sum (0 while the max is -inf)
        st.s[hf] *= expf(st.m[hf] - mt);
        st.m[hf] = mt;
      }
      if (st.m[hf] != -INFINITY) {  // else every column so far lies past V
        float sp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int c = 0; c < 32; ++c) sp[c & 3] += __expf(z[vt::cell(c, hf)] - st.m[hf]);
        st.s[hf] += (sp[0] + sp[1]) + (sp[2] + sp[3]);
      }
      const int cb = blank - v0, ct = st.id[hf] - v0;  // columns of the tile: this thread's when (col / 2) % 4 == q
      if (cb >= 0 && cb < vt::COLS && ((cb >> 1) & 3) == st.q) st.zb[hf] = vt::pick(z, hf, cb);
      if (st.id[hf] >= 0 && ct >= 0 && ct < vt::COLS && ((ct >> 1) & 3) == st.q) st.ze[hf] = vt::pick(z, hf, ct);
    }
  }

  // the quad's four running pairs merged into each row's lse; one lane writes the row
  __device__ __forceinline__ void finish(State& st) const {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float m = fmaxf(st.m[hf], __shfl_xor_sync(0xffffffffu, st.m[hf], 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const float s = vt::quad_sum(st.m[hf] == -INFINITY ? 0.0f : st.s[hf] * expf(st.m[hf] - m));
      const float zb = vt::quad_sum(st.zb[hf]), ze = vt::quad_sum(st.ze[hf]);  // one lane holds each, the rest 0
      const size_t row = st.row_a + 8 * hf;
      if (st.q == 0 && row < (size_t)R) {
        const float l = m + logf(s);
        lse[row] = l;
        lpb[row] = zb - l;
        lpe[row] = ze - l;
      }
    }
  }
};

// Shared memory of the float32 forward: the logits tile, then h transposed [J][TJ_ROWS]
inline size_t fwd_smem(int J) { return sizeof(float) * ((size_t)J * TJ_ROWS + TJ_ROWS * TJ_TILE); }

__global__ void __launch_bounds__(TJ_THREADS)
    joint_fwd_kernel(const float* __restrict__ enc, const float* __restrict__ pred, const float* __restrict__ W,
                     const float* __restrict__ bias, const int* __restrict__ ids, Slots sl, int R, int J, int V,
                     int blank, float* __restrict__ lpb, float* __restrict__ lpe, float* __restrict__ lse) {
  extern __shared__ __align__(16) float smem[];
  float* zt = smem;                    // [TJ_ROWS][TJ_TILE] logits tile
  float* hs = zt + TJ_ROWS * TJ_TILE;  // [J][TJ_ROWS]
  __shared__ int s_erow[TJ_ROWS], s_prow[TJ_ROWS], s_id[TJ_ROWS];
  __shared__ float s_zb[TJ_ROWS], s_zt[TJ_ROWS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * TJ_ROWS, rows = min(TJ_ROWS, R - r0);
  stage_nodes(r0, rows, sl, ids, V, s_erow, s_prow, s_id);
  if (tid < TJ_ROWS) s_zb[tid] = s_zt[tid] = 0.0f;
  __syncthreads();
  for (int e = tid; e < TJ_ROWS * J; e += TJ_THREADS) {
    const int r = e / J, j = e - r * J;
    hs[j * TJ_ROWS + r] = r < rows ? joint_h(enc, pred, s_erow[r], s_prow[r], J, j) : 0.0f;
  }
  __syncthreads();

  float run_m[RPW], run_s[RPW];
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    run_m[k] = -INFINITY;
    run_s[k] = 0.0f;
  }
  const int n_tiles = (V + TJ_TILE - 1) / TJ_TILE;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int v0 = tile * TJ_TILE, v = v0 + tid;
    const float bv = v < V ? bias[v] : 0.0f;
    float acc[TJ_ROWS];
    column_dots(hs, W, J, V, v, acc);
#pragma unroll
    for (int r = 0; r < TJ_ROWS; ++r) zt[r * TJ_TILE + tid] = v < V ? acc[r] + bv : -INFINITY;
    __syncthreads();
    merge_tile(zt, v0, V, blank, s_id, s_zb, s_zt, run_m, run_s);
    __syncthreads();  // every warp is done with the tile
  }
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int r = warp + k * (TJ_THREADS / 32);
    if (lane == 0 && r < rows) {
      const float l = run_m[k] + logf(run_s[k]);
      lse[r0 + r] = l;
      lpb[r0 + r] = s_zb[r] - l;
      lpe[r0 + r] = s_zt[r] - l;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(TJ_THREADS)
    joint_dpre_kernel(const T* __restrict__ enc, const T* __restrict__ pred, const T* __restrict__ W,
                      const T* __restrict__ bias, const int* __restrict__ ids, Slots sl, int R, int J, int V,
                      int blank, const float* __restrict__ lse, const float* __restrict__ dlpb,
                      const float* __restrict__ dlpe, float* __restrict__ dpre, T* __restrict__ hbuf) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                      // [J][TJ_ROWS] h, transposed
  float* dl = hs + J * TJ_ROWS;          // [TJ_TILE][TJ_DLS] rnd(dz) tile, transposed
  float* ws = dl + TJ_TILE * TJ_DLS;     // [TJ_WCH][TJ_JCH] chunk of W^T
  __shared__ int s_erow[TJ_ROWS], s_prow[TJ_ROWS], s_id[TJ_ROWS];
  __shared__ float s_lse[TJ_ROWS], s_gb[TJ_ROWS], s_ge[TJ_ROWS];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * TJ_ROWS, rows = min(TJ_ROWS, R - r0);
  const int j0 = blockIdx.y * TJ_JCH, jc = min(TJ_JCH, J - j0);
  stage_nodes(r0, rows, sl, ids, V, s_erow, s_prow, s_id);
  if (tid < TJ_ROWS) {
    const bool ok = tid < rows;
    s_lse[tid] = ok ? lse[r0 + tid] : 0.0f;
    s_gb[tid] = ok ? dlpb[r0 + tid] : 0.0f;
    s_ge[tid] = ok ? dlpe[r0 + tid] : 0.0f;
  }
  __syncthreads();
  for (int e = tid; e < TJ_ROWS * J; e += TJ_THREADS) {
    const int r = e / J, j = e - r * J;
    const float h = r < rows ? joint_h(enc, pred, s_erow[r], s_prow[r], J, j) : 0.0f;
    hs[j * TJ_ROWS + r] = h;
    if (blockIdx.y == 0 && r < rows) hbuf[(size_t)(r0 + r) * J + j] = from_f<T>(h);
  }
  __syncthreads();

  const int rg = tid >> 6, jl = tid & 63;  // dh: rows rg*8 .. rg*8+7, columns j0 + jl + 64 k
  float acc2[8][TJ_JPT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < TJ_JPT; ++k) acc2[i][k] = 0.0f;
  float4* col = reinterpret_cast<float4*>(dl + tid * TJ_DLS);  // this thread's column of the tile
  const int n_tiles = (V + TJ_TILE - 1) / TJ_TILE;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int v0 = tile * TJ_TILE, v = v0 + tid;
    float acc[TJ_ROWS];
    column_dots(hs, W, J, V, v, acc);
    const float bv = v < V ? to_f(bias[v]) : 0.0f;
#pragma unroll
    for (int r4 = 0; r4 < TJ_ROWS / 4; ++r4) {
      float d[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = 4 * r4 + k;
        d[k] = (v < V && r < rows) ? rnd<T>(joint_dz(acc[r] + bv, s_lse[r], s_gb[r], s_ge[r], v, blank, s_id[r]))
                                   : 0.0f;
      }
      col[r4] = make_float4(d[0], d[1], d[2], d[3]);
    }
    __syncthreads();  // the dz tile is complete

    for (int c0 = 0; c0 < TJ_TILE; c0 += TJ_WCH) {
      for (int e = tid; e < TJ_WCH * TJ_JCH; e += TJ_THREADS) {
        const int jj = e / TJ_WCH, c = e - jj * TJ_WCH;
        const int vv = v0 + c0 + c;
        ws[c * TJ_JCH + jj] = (jj < jc && vv < V) ? to_f(W[(size_t)(j0 + jj) * V + vv]) : 0.0f;
      }
      __syncthreads();
      for (int c = 0; c < TJ_WCH; ++c) {
        const float4* dr = reinterpret_cast<const float4*>(dl + (c0 + c) * TJ_DLS + rg * 8);
        const float4 a = dr[0], bq = dr[1];
        const float d[8] = {a.x, a.y, a.z, a.w, bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int k = 0; k < TJ_JPT; ++k) {
          const float w = ws[c * TJ_JCH + jl + 64 * k];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc2[i][k] = fmaf(d[i], w, acc2[i][k]);
        }
      }
      __syncthreads();  // done with this chunk of W^T (and, after the last, with the dz tile)
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rg * 8 + i;
#pragma unroll
    for (int k = 0; k < TJ_JPT; ++k) {
      const int jj = jl + 64 * k;
      if (r < rows && jj < jc) {
        const float h = hs[(j0 + jj) * TJ_ROWS + r];
        dpre[(size_t)(r0 + r) * J + j0 + jj] = acc2[i][k] * (1.0f - h * h);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(TJ_THREADS)
    joint_dw_kernel(const T* __restrict__ hbuf, const T* __restrict__ W, const T* __restrict__ bias,
                    const int* __restrict__ ids, Slots sl, int R, int rows_per_split, int J, int V, int blank,
                    const float* __restrict__ lse, const float* __restrict__ dlpb, const float* __restrict__ dlpe,
                    float* __restrict__ dW, float* __restrict__ db) {
  extern __shared__ __align__(16) float smem[];
  float* hsT = smem;                       // [J][TJ_ROWS] (the logits)
  float* hs = hsT + J * TJ_ROWS;           // [TJ_ROWS][TJ_JCH] this block's J columns (dW), 0 beyond J
  float* dl = hs + TJ_ROWS * TJ_JCH;       // [TJ_ROWS][TJ_DW_COLS] rnd(dz)
  float* dbp = dl + TJ_ROWS * TJ_DW_COLS;  // [TJ_THREADS] db partials
  __shared__ int s_erow[TJ_ROWS], s_prow[TJ_ROWS], s_id[TJ_ROWS];
  __shared__ float s_lse[TJ_ROWS], s_gb[TJ_ROWS], s_ge[TJ_ROWS];
  const int tid = threadIdx.x;
  const int c = tid % TJ_DW_COLS, g = tid / TJ_DW_COLS;  // g: 8 logits rows, then TJ_DW_HPT dW rows
  const int v0 = blockIdx.x * TJ_DW_COLS, v = v0 + c;
  const int j0 = blockIdx.y * TJ_JCH;
  const int jb = j0 + g * TJ_DW_HPT;  // first dW row of this thread
  const int rb = blockIdx.z * rows_per_split, re = min(R, rb + rows_per_split);
  const float bv = v < V ? to_f(bias[v]) : 0.0f;

  float accw[TJ_DW_HPT];
#pragma unroll
  for (int k = 0; k < TJ_DW_HPT; ++k) accw[k] = 0.0f;
  float dbacc = 0.0f;
  for (int r0 = rb; r0 < re; r0 += TJ_ROWS) {
    const int rows = min(TJ_ROWS, re - r0);
    __syncthreads();  // the previous chunk is done with the shared tiles
    stage_nodes(r0, rows, sl, ids, V, s_erow, s_prow, s_id);
    if (tid < TJ_ROWS) {
      const bool ok = tid < rows;
      s_lse[tid] = ok ? lse[r0 + tid] : 0.0f;
      s_gb[tid] = ok ? dlpb[r0 + tid] : 0.0f;
      s_ge[tid] = ok ? dlpe[r0 + tid] : 0.0f;
    }
    for (int e = tid; e < TJ_ROWS * J; e += TJ_THREADS) {
      const int r = e / J, j = e - r * J;
      hsT[j * TJ_ROWS + r] = r < rows ? to_f(hbuf[(size_t)(r0 + r) * J + j]) : 0.0f;
    }
    for (int e = tid; e < TJ_ROWS * TJ_JCH; e += TJ_THREADS) {
      const int r = e / TJ_JCH, j = j0 + e - r * TJ_JCH;
      hs[e] = (r < rows && j < J) ? to_f(hbuf[(size_t)(r0 + r) * J + j]) : 0.0f;
    }
    __syncthreads();

    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
    if (v < V) {
      for (int j = 0; j < J; ++j) {
        const float w = to_f(W[(size_t)j * V + v]);
        const float4* hr = reinterpret_cast<const float4*>(hsT + j * TJ_ROWS + g * 8);
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
      const float d = (v < V && r < rows)
                          ? rnd<T>(joint_dz(acc[k] + bv, s_lse[r], s_gb[r], s_ge[r], v, blank, s_id[r]))
                          : 0.0f;
      dbacc += d;
      dl[r * TJ_DW_COLS + c] = d;
    }
    __syncthreads();

    for (int r = 0; r < rows; ++r) {
      const float d = dl[r * TJ_DW_COLS + c];
      const float4* hr = reinterpret_cast<const float4*>(hs + r * TJ_JCH + g * TJ_DW_HPT);
#pragma unroll
      for (int k4 = 0; k4 < TJ_DW_HPT / 4; ++k4) {
        const float4 x = hr[k4];
        accw[4 * k4 + 0] = fmaf(x.x, d, accw[4 * k4 + 0]);
        accw[4 * k4 + 1] = fmaf(x.y, d, accw[4 * k4 + 1]);
        accw[4 * k4 + 2] = fmaf(x.z, d, accw[4 * k4 + 2]);
        accw[4 * k4 + 3] = fmaf(x.w, d, accw[4 * k4 + 3]);
      }
    }
  }
  float* dWz = dW + (size_t)blockIdx.z * J * V;
  if (v < V) {
#pragma unroll
    for (int k = 0; k < TJ_DW_HPT; ++k)
      if (jb + k < min(J, j0 + TJ_JCH)) dWz[(size_t)(jb + k) * V + v] = accw[k];
  }
  dbp[tid] = dbacc;
  __syncthreads();
  if (g == 0 && v < V && blockIdx.y == 0) {
    float s = 0.0f;
    for (int k = 0; k < TJ_THREADS / TJ_DW_COLS; ++k) s += dbp[k * TJ_DW_COLS + c];
    db[(size_t)blockIdx.z * V + v] = s;
  }
}

// grid (B*T): denc[b, t, j] = rnd(sum over s of dpre[(b*T + t)*S + s, j])
template <typename T>
__global__ void joint_denc_kernel(const float* __restrict__ dpre, int S, int J, T* __restrict__ denc) {
  const size_t bt = blockIdx.x;
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < S; ++k) s += dpre[(bt * S + k) * J + j];
    denc[bt * J + j] = from_f<T>(s);
  }
}

// grid (B*(U+1)): dpred[b, u, j] = rnd(sum over (t, s) with clip(p + s) == u of dpre), t then s ascending
template <typename T>
__global__ void joint_dpred_kernel(const float* __restrict__ dpre, Slots sl, int J, T* __restrict__ dpred) {
  const int b = blockIdx.x / sl.U1, u = blockIdx.x - b * sl.U1;
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    float acc = 0.0f;
    for (int t = 0; t < sl.n_frames; ++t) {
      const int bt = b * sl.n_frames + t;
      const int p = sl.p ? sl.p[bt] : 0;
      const int s_first = max(u == 0 ? 0 : u - p, 0);
      const int s_last = min(u == sl.U1 - 1 ? sl.S - 1 : u - p, sl.S - 1);
      for (int s = s_first; s <= s_last; ++s) acc += dpre[((size_t)bt * sl.S + s) * J + j];
    }
    dpred[(size_t)blockIdx.x * J + j] = from_f<T>(acc);
  }
}

template <typename Kernel>
cudaError_t tj_set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
cudaError_t joint_fwd_impl(const void* enc, const void* pred, const void* W, const void* b, const int* ids, Slots sl,
                           int R, int J, int V, int blank, const TilePlan& plan, float* lpb, float* lpe, float* lse,
                           cudaStream_t stream) {
  if constexpr (kTensorCores<T>) {  // the vocab tile pass over every tile of V in one block
    if (plan.tiles_per_block < (V + VOCAB_TILE - 1) / VOCAB_TILE) return cudaErrorInvalidValue;
    const Bf *e = static_cast<const Bf*>(enc), *p = static_cast<const Bf*>(pred);
    const int vec = J % 8 == 0 && wg::aligned16(e, (size_t)J) && wg::aligned16(p, (size_t)J);
    const JointPass pass{e, p, ids, sl, R, J, V, blank, vec, lpb, lpe, lse};
    return launch_tile_pass(static_cast<const Bf*>(W), static_cast<const Bf*>(b), R, J, V, plan, pass, stream);
  } else {
    const size_t smem = fwd_smem(J);
    cudaError_t err = tj_set_smem(joint_fwd_kernel, smem);
    if (err != cudaSuccess) return err;
    joint_fwd_kernel<<<(R + TJ_ROWS - 1) / TJ_ROWS, TJ_THREADS, smem, stream>>>(
        static_cast<const float*>(enc), static_cast<const float*>(pred), static_cast<const float*>(W),
        static_cast<const float*>(b), ids, sl, R, J, V, blank, lpb, lpe, lse);
    return cudaGetLastError();
  }
}

// grid (ceil(R / TJ_ROWS)): the bf16 backward's prologue, hbuf[r, j] = h of
// row r for j < J and 0 for J <= j < Jp (the engine's padded width)
__global__ void __launch_bounds__(TJ_THREADS)
    joint_h_kernel(const Bf* __restrict__ enc, const Bf* __restrict__ pred, const int* __restrict__ ids, Slots sl,
                   int R, int J, int Jp, int V, Bf* __restrict__ hbuf) {
  __shared__ int s_erow[TJ_ROWS], s_prow[TJ_ROWS], s_id[TJ_ROWS];
  const int r0 = blockIdx.x * TJ_ROWS, rows = min(TJ_ROWS, R - r0);
  stage_nodes(r0, rows, sl, ids, V, s_erow, s_prow, s_id);
  __syncthreads();
  for (int e = threadIdx.x; e < rows * Jp; e += TJ_THREADS) {
    const int r = e / Jp, j = e - r * Jp;
    hbuf[(size_t)(r0 + r) * Jp + j] =
        __float2bfloat16_rn(j < J ? joint_h(enc, pred, s_erow[r], s_prow[r], J, j) : 0.0f);
  }
}

// The engine's policy for K8/K9 (csrc/vocab_bwd.cuh): c = -(dlpb + dlpe), the
// blank and target columns compared in registers (the Pallas order of terms:
// softmax term, + dlpb at the blank, + dlpe at the target), db of the rounded
// dz, and dpre = dh (1 - h^2) in float32.
struct JointRows {
  const float* lse;
  const float* dlpb;
  const float* dlpe;
  const int* ids;
  Slots sl;
  const Bf* hbuf;  // [R, Jp]
  float* dpre;     // [R, J]
  int V, J, Jp, blank;
  static constexpr bool kDbRounded = true;

  struct Row {
    float lse, c, gb, ge;
    int id;
    bool valid;
  };

  __device__ __forceinline__ Row row(size_t r, bool valid, int) const {
    Row o{0.0f, 0.0f, 0.0f, 0.0f, V, valid};
    if (!valid) return o;
    int erow, prow;
    node_of((int)r, sl, ids, V, erow, prow, o.id);
    o.lse = lse[r];
    o.gb = dlpb[r];
    o.ge = dlpe[r];
    o.c = -(o.gb + o.ge);
    return o;
  }

  __device__ __forceinline__ void add_labels(Row& r, int v0, int q, float (&d)[16]) const {
    if (!r.valid) return;
    const int ib = vb::cell_of(blank - v0, q), it = vb::cell_of(r.id - v0, q);
    if (ib >= 0) vb::add_at(d, ib, r.gb);
    if (it >= 0) vb::add_at(d, it, r.ge);
  }

  __device__ __forceinline__ void store_dh(size_t r, int col, float v) const {
    const float h = __bfloat162float(hbuf[r * Jp + col]);
    dpre[r * J + col] = v * (1.0f - h * h);
  }
};

template <typename T>
cudaError_t joint_bwd_impl(const void* enc, const void* pred, const void* W, const void* b, const int* ids, Slots sl,
                           int B, int R, int J, int V, int blank, const float* lse, const float* dlpb,
                           const float* dlpe, int n_split, const vb::Plan& plan, void* hbuf, float* dpre,
                           float* dW_part, float* db_part, void* denc, void* dpred, float* dW, float* db,
                           cudaStream_t stream) {
  cudaError_t err;
  if constexpr (kTensorCores<T>) {
    const int Jp = (J + vb::PANEL - 1) / vb::PANEL * vb::PANEL;
    Bf* h = static_cast<Bf*>(hbuf);
    joint_h_kernel<<<(R + TJ_ROWS - 1) / TJ_ROWS, TJ_THREADS, 0, stream>>>(
        static_cast<const Bf*>(enc), static_cast<const Bf*>(pred), ids, sl, R, J, Jp, V, h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const JointRows pol{lse, dlpb, dlpe, ids, sl, h, dpre, V, J, Jp, blank};
    err = vb::launch(pol, h, (size_t)Jp, J, static_cast<const Bf*>(W), V, static_cast<const Bf*>(b), R, plan, dW_part,
                     db_part, dW, db, stream);
    if (err != cudaSuccess) return err;
  } else {
    const int j_chunks = (J + TJ_JCH - 1) / TJ_JCH;
    const dim3 row_grid((R + TJ_ROWS - 1) / TJ_ROWS, j_chunks);
    const dim3 col_grid((V + TJ_DW_COLS - 1) / TJ_DW_COLS, j_chunks, n_split);
    const int rows_per_split = (R + n_split - 1) / n_split;
    float* dW_out = n_split > 1 ? dW_part : dW;
    float* db_out = n_split > 1 ? db_part : db;
    const size_t smem1 = sizeof(float) * ((size_t)J * TJ_ROWS + TJ_TILE * TJ_DLS + TJ_WCH * TJ_JCH);
    err = tj_set_smem(joint_dpre_kernel<T>, smem1);
    if (err != cudaSuccess) return err;
    joint_dpre_kernel<T><<<row_grid, TJ_THREADS, smem1, stream>>>(
        static_cast<const T*>(enc), static_cast<const T*>(pred), static_cast<const T*>(W), static_cast<const T*>(b),
        ids, sl, R, J, V, blank, lse, dlpb, dlpe, dpre, static_cast<T*>(hbuf));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t smem2 =
        sizeof(float) * ((size_t)J * TJ_ROWS + TJ_ROWS * TJ_JCH + TJ_ROWS * TJ_DW_COLS + TJ_THREADS);
    err = tj_set_smem(joint_dw_kernel<T>, smem2);
    if (err != cudaSuccess) return err;
    joint_dw_kernel<T><<<col_grid, TJ_THREADS, smem2, stream>>>(
        static_cast<const T*>(hbuf), static_cast<const T*>(W), static_cast<const T*>(b), ids, sl, R, rows_per_split,
        J, V, blank, lse, dlpb, dlpe, dW_out, db_out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (n_split > 1) {
      vb::part_sum_kernel<<<1024, 256, 0, stream>>>(dW_part, n_split, (size_t)J * V, dW);
      vb::part_sum_kernel<<<64, 256, 0, stream>>>(db_part, n_split, (size_t)V, db);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  joint_denc_kernel<T><<<B * sl.n_frames, 128, 0, stream>>>(dpre, sl.S, J, static_cast<T*>(denc));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  joint_dpred_kernel<T><<<B * sl.U1, 128, 0, stream>>>(dpre, sl, J, static_cast<T*>(dpred));
  return cudaGetLastError();
}

}  // namespace srt

extern "C" {

// Forward.  enc [B,T,J], pred [B,U1,J], W [J,V], b [V] in T (bf16 when
// dtype_bf16, else float32); ids [B,U] int32 (U = U1 - 1); p [B,T] int32 band
// starts, or NULL for every node (then S = U1).  Outputs lpb, lpe, lse
// [B,T,S] float32.  bf16: the vocab tile pass's plan (wgs, stage_k and
// tiles_per_block = every tile, from ops/joint_planes.py joint_fwd_plan);
// float32 ignores it.
int transducer_joint_fwd(int dtype_bf16, const void* enc, const void* pred, const void* W, const void* b,
                         const int* ids, const int* p, int B, int T, int U1, int S, int J, int V, int blank,
                         int wgs, int stage_k, int tiles_per_block, float* lpb, float* lpe, float* lse,
                         void* stream) {
  const srt::Slots sl{p, T, S, U1, U1 - 1};
  const int R = B * T * S;
  const srt::TilePlan plan{wgs, stage_k, tiles_per_block};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_bf16)
    err = srt::joint_fwd_impl<__nv_bfloat16>(enc, pred, W, b, ids, sl, R, J, V, blank, plan, lpb, lpe, lse, st);
  else
    err = srt::joint_fwd_impl<float>(enc, pred, W, b, ids, sl, R, J, V, blank, plan, lpb, lpe, lse, st);
  return static_cast<int>(err);
}

// Backward.  The forward's operands and lse, the plane cotangents dlpb, dlpe
// [B,T,S] float32.  Scratch: hbuf [R,J] in T (bf16: [R, pad64(J)]), dpre
// [R,J] float32, dW_part [n_parts,J,V] and db_part [n_parts,V] float32
// (bf16: n_parts = 2 n_split; float32: n_split, used when n_split > 1).
// bf16 also takes the engine's plan (row_wgs, tile, chunk_panels,
// rows_per_split from ops/vocab_bwd.py bwd_plan; float32 ignores
// them and splits the rows evenly).  Outputs denc [B,T,J], dpred [B,U1,J] in
// T, dW [J,V], db [V] float32 (every element written).
int transducer_joint_bwd(int dtype_bf16, const void* enc, const void* pred, const void* W, const void* b,
                         const int* ids, const int* p, int B, int T, int U1, int S, int J, int V, int blank,
                         const float* lse, const float* dlpb, const float* dlpe, int n_split, int row_wgs,
                         int tile, int chunk_panels, int rows_per_split, void* hbuf, float* dpre,
                         float* dW_part, float* db_part, void* denc, void* dpred, float* dW, float* db, void* stream) {
  const srt::Slots sl{p, T, S, U1, U1 - 1};
  const int R = B * T * S;
  const srt::vb::Plan plan{row_wgs, tile, chunk_panels, n_split, rows_per_split};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_bf16)
    err = srt::joint_bwd_impl<__nv_bfloat16>(enc, pred, W, b, ids, sl, B, R, J, V, blank, lse, dlpb, dlpe, n_split,
                                             plan, hbuf, dpre, dW_part, db_part, denc, dpred, dW, db, st);
  else
    err = srt::joint_bwd_impl<float>(enc, pred, W, b, ids, sl, B, R, J, V, blank, lse, dlpb, dlpe, n_split, plan,
                                     hbuf, dpre, dW_part, db_part, denc, dpred, dW, db, st);
  return static_cast<int>(err);
}

}  // extern "C"
