// The split LAS decode step (las_split.cuh): the bf16 route of K4 (greedy_search_pallas,
// speech_recognition_tpu/ops/pallas/search_kernel.py:237) and K11 (beam_search_pallas, beam_kernel.py:415).
// The TPU kernels compute the step's products as whole-matrix jnp.dots on the MXU (search_kernel.py:131 and
// :146-150, beam_kernel.py:159 and :178-182); so does this route, on wgmma over all R rows.
//
// What bounds it at LAS-large (B = 128, S = 255, H = He = 1024, Dv = 2048): the attention streams pk + value,
// 200.5 MB a step, from device memory (60 us at 3.35 TB/s); the cell products are 6.4 GFLOP (greedy, R = 128)
// or 51.5 GFLOP (beam-8, R = 1024) a step, their 48 MB of weights read once for each row tile.  The design:
//  - products: a block owns 64 or 128 rows and 64 or 128 output columns; A (the rows) and B (the weights)
//    arrive by TMA, one [64 x 64] box each per 64-row k-panel, through a ring of four stages (two in flight
//    while one is multiplied), an mbarrier per stage; wgmma m64n64k16 or m64n128k16, each k-panel into a
//    fresh float32 accumulator whose sum is added into the total in float32.  Blocks that share a weight tile
//    are adjacent in the grid, so it is read from device memory about once and from L2 by the others.  The K
//    loop runs over the rows' first source, then the second (x, then rnd(h), for a cell);
//  - the gates: each cell's [Kc; Rc] is copied once per decode call into a gate-interleaved layout, column
//    32 g + 8 k + t holding gate k of unit 8 g + t, so that the thread that holds accumulator columns
//    8 j + 2 (lane % 4) + {0, 1} (j = 4 g + k) has all four gates of its two units in registers: the cell
//    update is the product's epilogue, with no shuffle and no round trip through memory;
//  - the attention keeps the sums of the per-row kernels it replaces (las_step.cuh attend for one beam, the
//    beam-minor vectors of the per-row beam step for K beams) in the same order, with all K beams of a batch
//    row in each of its blocks, so pk[b] and value[b] are read once a step; a row's key frames and value
//    columns spread over 8 + 8 blocks (at S = 255, Dv = 2048), pk and value staged through shared memory
//    16 bytes a load.
// The teacher-forced decoder loop (K2, decoder_fwd_pallas, speech_recognition_tpu/ops/pallas/decoder_kernel.py:238)
// runs the same step without the vocab pass (split_decoder_fwd): the embedding rows are given (dropout-masked
// before the loop), the context kernel applies the first cell's dropout mask, and the cells' epilogue
// (EPI_TRAIN) gates by the token mask and writes K3's residuals: rnd(z) in the natural gate order, rnd(c'),
// each next cell's masked input and the step's h / c.  At LAS-small (B = 128, S = 255, H = 256) a step is
// bound by the attention's pk + value, 50.1 MB from device memory (15 us at 3.35 TB/s).
// Its reverse (K3, decoder_bwd_pallas, decoder_kernel.py:477, body _bwd_kernel :296-405; split_decoder_bwd) is the
// same step transposed: per cell from the last down a product rnd(dz_i) @ [K_i^T | R_i^T] whose epilogue is the
// next cell's gate VJP (K_i^T and R_i^T interleaved by 8-column groups, so that a thread holds both columns of its
// units), cell 0's writing dx0 = [demb | dctx]; the attention's VJP in a dprobs kernel (a step reads value) and a
// dq kernel (the softmax VJP, then pk); the query product rnd(dq) @ qw^T adding into dh, then the last cell's gate
// VJP of the step before over all B H units (gate_kernel).  A step streams pk + value + probs (50.1 MB at
// LAS-small, 200.5 MB at LAS-large) and reads each transposed weight once per row tile (3 MB / 48 MB).
#include "las_split.cuh"

#include <utility>

namespace srt {
namespace sp {

using namespace wg;  // PANEL, W_PANEL, ALIGN and the PTX helpers

constexpr int STAGES = 4, IN_FLIGHT = STAGES - 2;  // = ops/las_step.py STAGES
constexpr int MAX_SMEM = 232448;                   // dynamic shared memory one block may use on the H100
constexpr int MAX_KB = 16;                         // beams of an attention block (= ops/vocab_topk.py MAX_K)
enum { EPI_QUERY = 0, EPI_CELL = 1, EPI_TRAIN = 2 };

// Dynamic shared memory of a product block (ops/las_step.py product_smem mirrors it): the ring only.
inline size_t product_smem(int wgs, int panels) { return ALIGN + (size_t)STAGES * (wgs + panels) * W_PANEL; }
// The attention's blocks (ops/las_step.py mirrors them): a scores block takes SCORE_FRAMES key frames with
// SCORE_THREADS threads (each warp SCORE_FRAMES / 8 of them) and holds the row's queries, q [KB][H] floats, and
// its key frames, [SCORE_FRAMES][H] bf16; a context block takes CTX_COLS value columns, a thread each, and holds
// two tiles of CTX_FRAMES frames of them (bf16), the row's scores, p [S][KB], and 33 floats of reduction scratch.
#define SCORE_FRAMES 32
#define SCORE_THREADS 256
#define CTX_COLS 256
#define CTX_FRAMES 32
inline size_t scores_smem(int kb, int H) { return sizeof(float) * (size_t)kb * H + 2 * SCORE_FRAMES * (size_t)H; }
inline size_t context_smem(int kb, int S) {
  return 2 * 2 * CTX_FRAMES * CTX_COLS + sizeof(float) * ((size_t)kb * S + 33);
}

// What a product's epilogue reads and writes.
struct Epi {
  const Bf* bias;  // query: qb [H]; cell: [4H]
  float* q;        // query: out [R,H]
  float *h, *c;    // cell: state [R,H], in place
  Bf *hq_out, *x_out;
  const int* prev;
  int prev_stride, pad_id, R, H;
  // EPI_TRAIN (the teacher-forced loop, K = 1): the pad gate of each row, the mask of the cell's output, the
  // residual streams of the step, and (the last cell) rnd(h), rnd(c) after it
  const float* gate;       // [R]
  const Bf* next_mask;     // [R,H]
  Bf *z_out, *cp_out;      // [R,4H], [R,H]
  Bf *hs_out, *cs_out;     // [R,H] or null
};

// z = A @ W for the block's 64 WGS rows and 64 NP columns (from col0): the thread's accumulator cells, z[4 j + 2 hf
// + x] at row 16 warp + lane / 4 + 8 hf of its warpgroup and column 8 j + 2 (lane % 4) + x of the tile.  A's
// k-panels 0..n_k1-1 come from a1, n_k1..n_k-1 from a2 (column (k - n_k1) 64), the block's rows from row a_row0 of
// each; W's k-panel k is rows 64 k.. of wm.  The ring holds one k-panel a stage; a stage is refilled once every
// product that read it is done.  Each k-panel's four k-steps go into a fresh accumulator, za and zb in turns, and
// the panel sums are added into z in float32, in order, while the next panel is multiplied: the tensor cores' own
// accumulation rounds toward zero, and over a 4096-deep product that bias moved h far enough to flip its bf16
// roundings (PERF.md §6).
template <int WGS, int NP>
__device__ __forceinline__ void product_tile(const CUtensorMap& a1, const CUtensorMap& a2, const CUtensorMap& wm,
                                             int n_k1, int n_k, int a_row0, int col0, float (&z)[32 * NP]) {
  constexpr int S = STAGES, D = IN_FLIGHT, A_BYTES = WGS * W_PANEL, KPB = (WGS + NP) * W_PANEL, N = 32 * NP;
  extern __shared__ uint8_t sp_smem[];
  __shared__ __align__(8) uint64_t sp_bars[STAGES];  // stage s has landed (one phase a fill)
  const uint32_t base = (smem_addr(sp_smem) + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const uint32_t bars = smem_addr(sp_bars);
  const int tid = threadIdx.x, wgi = tid >> 7;

  auto issue = [&](int k) {  // k-panel k into stage k % S
    if (k < n_k && tid == 0) {
      const uint32_t dst = base + (k % S) * KPB, bar = bars + (k % S) * 8;
      mbar_expect_tx(bar, KPB);
      for (int w = 0; w < WGS; ++w) {
        if (k < n_k1) tma_load_2d(dst + w * W_PANEL, &a1, k * PANEL, a_row0 + WG_ROWS * w, bar);
        else tma_load_2d(dst + w * W_PANEL, &a2, (k - n_k1) * PANEL, a_row0 + WG_ROWS * w, bar);
      }
      for (int np = 0; np < NP; ++np) tma_load_2d(dst + A_BYTES + np * W_PANEL, &wm, col0 + np * PANEL, k * PANEL, bar);
    }
  };
  // k-panel k into acc (fresh), one committed wgmma group, not waited for
  auto panel = [&](float (&acc)[N], int k) {
    mbar_wait(bars + (k % S) * 8, (k / S) & 1);
    __syncthreads();  // every warpgroup is done with k-panel k - 2, whose stage the next issue refills
    issue(k + D);
    const uint32_t st = base + (k % S) * KPB;
    wg_arrive();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t a = kmajor(st + wgi * W_PANEL + 32 * s), b = mnmajor(st + A_BYTES + 2048 * s, W_PANEL);
      if constexpr (NP == 2) mma_ss_n128(acc, a, b, s);
      else mma_ss<0, 1>(acc, a, b, s);
    }
    wg_commit();
  };
  float za[N], zb[N];
  auto add = [&](float (&acc)[N]) {
    reg_fence(acc);
#pragma unroll
    for (int c = 0; c < N; ++c) z[c] += acc[c];
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + 8 * s, 1);
    fence_mbar_init();
  }
  __syncthreads();
  for (int k = 0; k < D; ++k) issue(k);
#pragma unroll
  for (int c = 0; c < N; ++c) z[c] = za[c] = zb[c] = 0.0f;
  int k = 0;
  for (; k + 1 < n_k; k += 2) {
    panel(za, k);
    wg_wait<1>();  // k-panel k - 1 (zb) is done
    add(zb);
    panel(zb, k + 1);
    wg_wait<1>();
    add(za);
  }
  if (k < n_k) {
    panel(za, k);
    wg_wait<1>();
    add(zb);
    wg_wait<0>();
    add(za);
  } else {
    wg_wait<0>();
    add(zb);
  }
}

// out = A @ W (+ the epilogue) for the block's 64 WGS rows and 64 NP columns (product_tile)
template <int WGS, int NP, int EPI>
__global__ void __launch_bounds__(128 * WGS, 1)
    product_kernel(const __grid_constant__ CUtensorMap a1, const __grid_constant__ CUtensorMap a2,
                   const __grid_constant__ CUtensorMap wm, int n_k1, int n_k, const int* __restrict__ run_flag,
                   const Epi e) {
  if (run_flag != nullptr && *run_flag == 0) return;  // the beam loop (K11) has ended
  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31, q = lane & 3;
  const int row0 = blockIdx.x * WG_ROWS * WGS, col0 = blockIdx.y * PANEL * NP;
  float z[32 * NP];
  product_tile<WGS, NP>(a1, a2, wm, n_k1, n_k, row0, col0, z);

  // the thread's cells: z[4 j + 2 hf + x] is row (16 warp + lane / 4 + 8 hf) of its warpgroup, column
  // 8 j + 2 q + x of the tile
  const int H = e.H;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + WG_ROWS * wgi + 16 * warp + (lane >> 2) + 8 * hf;
    if (r >= e.R) continue;
    if constexpr (EPI == EPI_QUERY) {
#pragma unroll
      for (int j = 0; j < 8 * NP; ++j) {
        const int col = col0 + 8 * j + 2 * q;
        if (col < H)  // H % 8 == 0: a pair is inside or outside together
          *reinterpret_cast<float2*>(e.q + (size_t)r * H + col) =
              make_float2(z[4 * j + 2 * hf] + to_f(e.bias[col]), z[4 * j + 2 * hf + 1] + to_f(e.bias[col + 1]));
      }
    } else {
      // pad-token gating: the previous token (decoding) or the token mask (the teacher-forced loop)
      const bool m = EPI == EPI_TRAIN ? e.gate[r] != 0.0f : e.prev[(size_t)r * e.prev_stride] != e.pad_id;
#pragma unroll
      for (int g = 0; g < 2 * NP; ++g) {  // the tile's groups of 8 units, 16 NP units from col0 / 4
        const int u = col0 / 4 + 8 * g + 2 * q;
        if (u >= H) continue;
        const size_t at = (size_t)r * H + u;
        const float2 h_old = *reinterpret_cast<const float2*>(e.h + at);
        const float2 c_old = *reinterpret_cast<const float2*>(e.c + at);
        float hn[2], cn[2], xo[2], zk[4][2], cps[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
#pragma unroll
          for (int k = 0; k < 4; ++k) zk[k][x] = z[4 * (4 * g + k) + 2 * hf + x] + to_f(e.bias[k * H + u + x]);
          const float gi = sigmoidf(zk[0][x]), gf = sigmoidf(zk[1][x]);
          const float gg = tanhf(zk[2][x]), go = sigmoidf(zk[3][x]);
          const float co = x ? c_old.y : c_old.x, ho = x ? h_old.y : h_old.x;
          const float cp = gf * co + gi * gg;
          const float hp = go * tanhf(cp);
          hn[x] = m ? hp : ho;
          cn[x] = m ? cp : co;
          xo[x] = m ? hp : 0.0f;
          cps[x] = cp;
        }
        if (m) {
          *reinterpret_cast<float2*>(e.h + at) = make_float2(hn[0], hn[1]);
          *reinterpret_cast<float2*>(e.c + at) = make_float2(cn[0], cn[1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(e.hq_out + at) = __floats2bfloat162_rn(hn[0], hn[1]);
        if constexpr (EPI == EPI_TRAIN) {
          // the next cell's input (or the hidden stream) rnd(rnd(h' m) mask); the residuals K3 reads
          const float2 mk = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(e.next_mask + at));
          *reinterpret_cast<__nv_bfloat162*>(e.x_out + at) =
              __floats2bfloat162_rn(bf16_grid(xo[0]) * mk.x, bf16_grid(xo[1]) * mk.y);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            *reinterpret_cast<__nv_bfloat162*>(e.z_out + (size_t)r * 4 * H + k * H + u) =
                __floats2bfloat162_rn(zk[k][0], zk[k][1]);
          *reinterpret_cast<__nv_bfloat162*>(e.cp_out + at) = __floats2bfloat162_rn(cps[0], cps[1]);
          if (e.hs_out != nullptr) {
            *reinterpret_cast<__nv_bfloat162*>(e.hs_out + at) = __floats2bfloat162_rn(hn[0], hn[1]);
            *reinterpret_cast<__nv_bfloat162*>(e.cs_out + at) = __floats2bfloat162_rn(cn[0], cn[1]);
          }
        } else {
          *reinterpret_cast<__nv_bfloat162*>(e.x_out + at) = __floats2bfloat162_rn(xo[0], xo[1]);
        }
      }
    }
  }
}

// The attention of batch row b for its K beams (rows b K + k), KB = K rounded up to a power of two, in two
// launches so that a row's frames and value columns spread over many blocks, with the per-beam order of sums of
// the per-row step kernels (pk and value arrive 16 bytes a load through shared memory; each sum takes its terms
// in the same order as there):
//  - scores_kernel, grid (B, chunks of SCORE_FRAMES key frames): scores[b K + k][s] = q[k] . pk[b, s] +
//    bias[b, s], a warp per key frame (four at a time), lane l summing elements l, l + 32, ..;
//  - context_kernel, grid (B, chunks of CTX_COLS value columns): the float32 softmax of the row's scores (one
//    beam: block-wide max and sum; else a warp per beam; each block of the row computes the same), the context
//    rnd(sum_s p[s][k] value[b, s, d]) into x0[:, He + d] (a thread per value column, frames in order, value
//    streamed in tiles of CTX_FRAMES frames through a double buffer; times ctx_mask where one is given), and,
//    in the row's first block, the embedding rows of the previous tokens into x0[:, :He].
template <int KB>
__global__ void __launch_bounds__(SCORE_THREADS, 2)
    scores_kernel(const float* __restrict__ q_rows, const Bf* __restrict__ pk, const float* __restrict__ attn_bias,
                  const int* __restrict__ run_flag, float* __restrict__ scores, int K, int S, int H) {
  if (run_flag != nullptr && *run_flag == 0) return;
  constexpr int F = SCORE_FRAMES / (SCORE_THREADS / 32);  // key frames a warp takes together
  extern __shared__ __align__(16) float sm[];
  float* q = sm;  // [KB][H] queries, beam-major: lane l reads q[k][l + 32 u], conflict-free
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Bf* rows = reinterpret_cast<Bf*>(q + (size_t)KB * H) + (size_t)warp * F * H;  // [F][H]: this warp's key frames
  const size_t row0 = (size_t)b * K;
  for (int e = tid; e < KB * H; e += SCORE_THREADS) {
    const int k = e / H, j = e - k * H;
    q[e] = k < K ? q_rows[(row0 + k) * H + j] : 0.0f;
  }
  const int s0 = blockIdx.y * SCORE_FRAMES + warp * F;
  const Bf* pkb = pk + (size_t)b * S * H;
#pragma unroll
  for (int f = 0; f < F; ++f) {  // 16 bytes a copy (H % 8 == 0); frames past S read as zeros
    uint4* dst = reinterpret_cast<uint4*>(rows + f * H);
    const uint4* src = reinterpret_cast<const uint4*>(pkb + (size_t)(s0 + f) * H);
    for (int c = lane; c < H / 8; c += 32) dst[c] = s0 + f < S ? src[c] : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  // lane l sums the terms i = l, l + 32, .. of each (frame, beam) in order, as the per-row step kernels do; the
  // F frames share each load of the queries
  float acc[F][KB] = {};
  for (int i = lane; i < H; i += 32) {
    float r[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k) r[k] = q[k * H + i];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float kv = to_f(rows[f * H + i]);
#pragma unroll
      for (int k = 0; k < KB; ++k) acc[f][k] = fmaf(r[k], kv, acc[f][k]);
    }
  }
  const float* biasb = attn_bias + (size_t)b * S;
#pragma unroll
  for (int f = 0; f < F; ++f) {
#pragma unroll
    for (int k = 0; k < KB; ++k) acc[f][k] = warp_sum(acc[f][k]);
    const int s = s0 + f;
    if (lane == 0 && s < S) {
#pragma unroll
      for (int k = 0; k < KB; ++k)
        if (k < K) scores[(row0 + k) * S + s] = acc[f][k] + biasb[s];
    }
  }
}

template <int KB>
__global__ void __launch_bounds__(CTX_COLS)
    context_kernel(const float* __restrict__ scores, const Bf* __restrict__ value, const Bf* __restrict__ emb,
                   const int* __restrict__ prev, int prev_stride, const int* __restrict__ run_flag,
                   const Bf* __restrict__ ctx_mask, int mask_ld, Bf* __restrict__ x0, int K, int S, int He,
                   int Dv) {
  if (run_flag != nullptr && *run_flag == 0) return;
  extern __shared__ __align__(16) float sm[];
  Bf* tiles = reinterpret_cast<Bf*>(sm);                 // [2][CTX_FRAMES][CTX_COLS] value, double-buffered
  float* p = sm + CTX_FRAMES * CTX_COLS;                 // [S][KB] scores, then probabilities
  float* red = p + S * KB;                               // [33] reduction scratch
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const size_t row0 = (size_t)b * K, in = (size_t)He + Dv;
  const int d0 = blockIdx.y * CTX_COLS, n_tiles = (S + CTX_FRAMES - 1) / CTX_FRAMES;
  const Bf* vb = value + (size_t)b * S * Dv;
  // frames [CTX_FRAMES t, CTX_FRAMES (t + 1)) of the block's columns into buffer t % 2, 16 bytes a copy (Dv % 8 == 0)
  auto stage = [&](int t) {
    if (t < n_tiles) {
      const uint32_t dst = smem_addr(tiles + (t & 1) * CTX_FRAMES * CTX_COLS);
      for (int e = tid; e < CTX_FRAMES * CTX_COLS / 8; e += nt) {
        const int f = e / (CTX_COLS / 8), c = 8 * (e - f * (CTX_COLS / 8)), s = t * CTX_FRAMES + f;
        const bool in_row = s < S && d0 + c < Dv;
        cp_async16(dst + 2 * (f * CTX_COLS + c), in_row ? vb + (size_t)s * Dv + d0 + c : vb, in_row ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  stage(0);
  for (int e = tid; e < S * KB; e += nt) {
    const int k = e / S, s = e - k * S;
    p[s * KB + k] = k < K ? scores[(row0 + k) * S + s] : 0.0f;
  }
  if (blockIdx.y == 0)
    for (int e = tid; e < K * He; e += nt) {
      const int k = e / He, j = e - k * He;
      x0[(row0 + k) * in + j] = emb[(size_t)prev[(row0 + k) * prev_stride] * He + j];  // exact table rows
    }
  __syncthreads();

  if constexpr (KB == 1) {
    float mx = -INFINITY;
    for (int s = tid; s < S; s += nt) mx = fmaxf(mx, p[s]);
    mx = block_reduce(mx, red, true);
    float sum = 0.0f;
    for (int s = tid; s < S; s += nt) {
      const float ex = expf(p[s] - mx);
      p[s] = ex;
      sum += ex;
    }
    sum = block_reduce(sum, red, false);
    for (int s = tid; s < S; s += nt) p[s] = p[s] / sum;
  } else {
    for (int k = warp; k < KB; k += n_warps) {
      float mx = -INFINITY;
      for (int s = lane; s < S; s += 32) mx = fmaxf(mx, p[s * KB + k]);
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int s = lane; s < S; s += 32) {
        const float ex = expf(p[s * KB + k] - mx);
        p[s * KB + k] = ex;
        sum += ex;
      }
      sum = warp_sum(sum);
      for (int s = lane; s < S; s += 32) p[s * KB + k] = p[s * KB + k] / sum;
    }
  }

  float acc[KB] = {};
  for (int t = 0; t < n_tiles; ++t) {
    stage(t + 1);
    cp_async_wait<1>();
    __syncthreads();  // tile t has landed for every thread (and, at t = 0, the probabilities are ready)
    const Bf* tile = tiles + (t & 1) * CTX_FRAMES * CTX_COLS;
    const int nf = min(CTX_FRAMES, S - t * CTX_FRAMES);
    for (int f = 0; f < nf; ++f) {
      const float v = to_f(tile[f * CTX_COLS + tid]);
      float r[KB];
      load_beams<KB>(p + (t * CTX_FRAMES + f) * KB, r);
#pragma unroll
      for (int k = 0; k < KB; ++k) acc[k] = fmaf(r[k], v, acc[k]);
    }
    __syncthreads();  // every thread is done with buffer t % 2 before tile t + 2 refills it
  }
  const int d = d0 + tid;
  if (d < Dv) {
#pragma unroll
    for (int k = 0; k < KB; ++k)
      if (k < K) {
        // the teacher-forced loop's first cell takes rnd(rnd(ctx) cm0[He + d]): its dropout mask
        const float v = ctx_mask == nullptr ? acc[k] : bf16_grid(acc[k]) * to_f(ctx_mask[(row0 + k) * mask_ld + d]);
        x0[(row0 + k) * in + He + d] = __float2bfloat16_rn(v);
      }
  }
}

__global__ void hq_init_kernel(const float* __restrict__ h, Bf* __restrict__ hq, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.x * blockDim.x)
    hq[i] = __float2bfloat16_rn(h[i]);
}

// ---------------------------------------------------------------- the reverse step (K3, split_decoder_bwd)
enum { EPI_RCELL = 0, EPI_RCELL0 = 1, EPI_RQUERY = 2 };
// The attention VJP's blocks (ops/las_step.py mirrors them): a dprobs block takes DP_FRAMES key frames of one batch
// row with DP_THREADS threads (each warp DP_FRAMES / 8 of them) and holds the row's dctx, [Dv] floats; a dq block
// takes DQ_COLS columns of pk, a thread each, and holds two tiles of DQ_FRAMES frames of them (bf16), the row's
// probabilities and dscores, 2 [S] floats, and 33 floats of reduction scratch.
#define DP_FRAMES 32
#define DP_THREADS 256
#define DQ_COLS 128
#define DQ_FRAMES 32
inline size_t dprobs_smem(int Dv) { return sizeof(float) * (size_t)Dv; }
inline size_t dq_smem(int S) { return 2 * 2 * DQ_FRAMES * DQ_COLS + sizeof(float) * (2 * (size_t)S + 33); }

__device__ __forceinline__ float2 load_bf2(const Bf* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The rows of one step that a cell's gate VJP reads and writes, each pointer at the step's row 0 (stream row n B)
struct GateRows {
  int cell, H;                       // the cell; c entering it is rebuilt from c_in0 and the c' of cells < cell
  const float* gate;                 // [B] the pad gate
  const Bf *z, *cp, *c_in0;          // [B,4H] rnd(z) and [B,H] rnd(c') of the cell, [B,H] c_in0
  const Bf* cps[SPLIT_MAX_CELLS];    // [B,H] rnd(c') of every cell
  const Bf* dhidden;                 // [B,H] the last cell's output's cotangent
  Bf* dz;                            // [B,4H] out: rnd(dz)
};

// What the gate VJP of batch row r, units u and u + 1, reads from the residual streams: rnd(z) (gates i, f, g, o),
// rnd(c'), the c entering the cell (rebuilt from c_in0 and the c' of the cells before it) and the pad gate.
struct GateIn {
  __nv_bfloat162 z[4], cp;
  float2 cin;
  float m;
};

__device__ __forceinline__ GateIn gate_load(const GateRows& g, int r, int u) {
  const int H = g.H;
  const size_t at = (size_t)r * H + u;
  GateIn in;
  in.m = g.gate[r];
#pragma unroll
  for (int k = 0; k < 4; ++k) in.z[k] = *reinterpret_cast<const __nv_bfloat162*>(g.z + (size_t)r * 4 * H + k * H + u);
  in.cp = *reinterpret_cast<const __nv_bfloat162*>(g.cp + at);
  in.cin = load_bf2(g.c_in0 + at);
#pragma unroll
  for (int j = 0; j < SPLIT_MAX_CELLS - 1; ++j)  // unrolled, so that cps is indexed by constants
    if (j < g.cell) {
      const float2 c = load_bf2(g.cps[j] + at);
      in.cin = make_float2(in.m * c.x + (1.0f - in.m) * in.cin.x, in.m * c.y + (1.0f - in.m) * in.cin.y);
    }
  return in;
}

// The LSTM cell's gate VJP at batch row r, units u and u + 1, the Pallas kernel's math (decoder_kernel.py:337-360):
// dh and dc flow into the cell's h' and c', dx into its emitted x.  Writes rnd(dz) in the natural gate order (the
// cell's product reads it as its A operand) and leaves (1 - m) dh in dh (the part of dh_prev that the product's
// acc_R adds to) and dc_prev in dc.
__device__ __forceinline__ void gate_vjp(const GateRows& g, const GateIn& in, int r, int u, float (&dh)[2],
                                         float (&dc)[2], const float (&dx)[2]) {
  const float m = in.m;
  float dz[4][2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const auto pick = [x](__nv_bfloat162 v) { return x ? __high2float(v) : __low2float(v); };
    const float gi = sigmoidf(pick(in.z[0])), gf = sigmoidf(pick(in.z[1]));
    const float gg = tanhf(pick(in.z[2])), go = sigmoidf(pick(in.z[3]));
    const float tanh_cp = tanhf(pick(in.cp));
    const float dh_p = m * dh[x] + m * dx[x];
    const float dh_part = (1.0f - m) * dh[x];
    float dc_p = m * dc[x];
    float dc_prev = (1.0f - m) * dc[x];
    const float d_o = dh_p * tanh_cp;
    dc_p = dc_p + dh_p * go * (1.0f - tanh_cp * tanh_cp);
    const float df = dc_p * (x ? in.cin.y : in.cin.x);
    dc_prev = dc_prev + dc_p * gf;
    const float di = dc_p * gg, dg = dc_p * gi;
    dz[0][x] = di * gi * (1.0f - gi);
    dz[1][x] = df * gf * (1.0f - gf);
    dz[2][x] = dg * (1.0f - gg * gg);
    dz[3][x] = d_o * go * (1.0f - go);
    dh[x] = dh_part;
    dc[x] = dc_prev;
  }
  const int H = g.H;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    *reinterpret_cast<__nv_bfloat162*>(g.dz + (size_t)r * 4 * H + k * H + u) =
        __floats2bfloat162_rn(dz[k][0], dz[k][1]);
}

// What a reverse product's epilogue reads and writes, at step n
struct ReverseEpi {
  int a_row0, B, H, He, D0;  // A's first row (n B); D0 = He + Dv, cell 0's input width
  const Bf* in_mask;         // the product's cell: its input's dropout mask [B, in_i]
  float *dh, *dc;            // [B,H] float32: dh's partial sum, the carried dc
  GateRows g;                // EPI_RCELL: cell i - 1's rows at step n
  Bf *demb, *dctx;           // EPI_RCELL0: step n's rows of the streams
  float* dctx_f;             // [B,Dv] float32: dctx unrounded, for dprobs
  Bf *dh0, *dc0;             // EPI_RQUERY after step 0: out (else null)
};

// Gate VJPs an EPI_RCELL thread runs together: their loads are all issued before the first one's math
#define VJP_BATCH 4

// One product of the reverse step for the block's 64 WGS rows and 64 NP columns (product_tile over A = the rows of
// a stream at a_row0, K = 4H or H), with its epilogue:
//  - EPI_RCELL, cell i > 0 (W: K_i^T and R_i^T interleaved, column 16 G + 8 k + t column 8 G + t of K_i^T (k = 0)
//    or R_i^T (k = 1), so the thread holding accumulator columns 8 j + 2 q + {0, 1}, j = 2 g + k, holds both of
//    units 8 G + 2 q + {0, 1}): dx = acc_K cm_i, dh = dh_part + acc_R, then cell i - 1's gate VJP;
//  - EPI_RCELL0 (W = [K_0^T | R_0^T]): columns < D0 are dx0 = acc cm_0, written as demb and dctx (bf16) and dctx
//    (float32, for dprobs); columns D0 + u add acc into dh_part: dh_prev of cell 0;
//  - EPI_RQUERY (W = qw^T): dh = dh_prev + acc, whose gate VJP (the last cell's, of step n - 1) gate_kernel runs
//    over all B H units; after step 0 dh0 and dc0.
template <int WGS, int NP, int EPI>
__global__ void __launch_bounds__(128 * WGS, 1)
    reverse_product_kernel(const __grid_constant__ CUtensorMap a, const __grid_constant__ CUtensorMap wm, int n_k,
                           const ReverseEpi e) {
  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31, q = lane & 3;
  const int row0 = blockIdx.x * WG_ROWS * WGS, col0 = blockIdx.y * PANEL * NP;
  float z[32 * NP];
  product_tile<WGS, NP>(a, a, wm, n_k, n_k, e.a_row0 + row0, col0, z);

  const int H = e.H;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + WG_ROWS * wgi + 16 * warp + (lane >> 2) + 8 * hf;
    if (r >= e.B) continue;
    if constexpr (EPI == EPI_RCELL) {
#pragma unroll
      for (int g0 = 0; g0 < 4 * NP; g0 += VJP_BATCH) {
        GateIn in[VJP_BATCH];
        float2 dhp[VJP_BATCH], dcv[VJP_BATCH], cm[VJP_BATCH];
#pragma unroll
        for (int b = 0; b < VJP_BATCH; ++b) {
          const int u = 8 * (col0 / 16 + g0 + b) + 2 * q;
          if (u >= H) continue;  // H % 8 == 0: a pair is inside or outside together
          const size_t at = (size_t)r * H + u;
          in[b] = gate_load(e.g, r, u);
          dhp[b] = *reinterpret_cast<const float2*>(e.dh + at);
          dcv[b] = *reinterpret_cast<const float2*>(e.dc + at);
          cm[b] = load_bf2(e.in_mask + at);
        }
#pragma unroll
        for (int b = 0; b < VJP_BATCH; ++b) {
          const int g = g0 + b, u = 8 * (col0 / 16 + g) + 2 * q;
          if (u >= H) continue;
          const size_t at = (size_t)r * H + u;
          float dh[2] = {dhp[b].x + z[4 * (2 * g + 1) + 2 * hf], dhp[b].y + z[4 * (2 * g + 1) + 2 * hf + 1]};
          float dc[2] = {dcv[b].x, dcv[b].y};
          const float dx[2] = {z[4 * (2 * g) + 2 * hf] * cm[b].x, z[4 * (2 * g) + 2 * hf + 1] * cm[b].y};
          gate_vjp(e.g, in[b], r, u, dh, dc, dx);
          *reinterpret_cast<float2*>(e.dh + at) = make_float2(dh[0], dh[1]);
          *reinterpret_cast<float2*>(e.dc + at) = make_float2(dc[0], dc[1]);
        }
      }
    } else if constexpr (EPI == EPI_RCELL0) {
      // every load first: a load after a store to memory that might alias it would wait for the store
      const int Dv = e.D0 - e.He;
      float2 in[8 * NP];
#pragma unroll
      for (int j = 0; j < 8 * NP; ++j) {
        const int c = col0 + 8 * j + 2 * q;  // He and D0 are even: a pair lies on one side of each
        if (c < e.D0) in[j] = load_bf2(e.in_mask + (size_t)r * e.D0 + c);
        else if (c < e.D0 + H) in[j] = *reinterpret_cast<const float2*>(e.dh + (size_t)r * H + c - e.D0);
      }
#pragma unroll
      for (int j = 0; j < 8 * NP; ++j) {
        const int c = col0 + 8 * j + 2 * q;
        const float a0 = z[4 * j + 2 * hf], a1 = z[4 * j + 2 * hf + 1];
        if (c < e.D0) {  // dx0 = acc cm_0
          const float v0 = a0 * in[j].x, v1 = a1 * in[j].y;
          if (c < e.He) {
            *reinterpret_cast<__nv_bfloat162*>(e.demb + (size_t)r * e.He + c) = __floats2bfloat162_rn(v0, v1);
          } else {
            const size_t at = (size_t)r * Dv + c - e.He;
            *reinterpret_cast<__nv_bfloat162*>(e.dctx + at) = __floats2bfloat162_rn(v0, v1);
            *reinterpret_cast<float2*>(e.dctx_f + at) = make_float2(v0, v1);
          }
        } else if (c < e.D0 + H) {  // dh_prev of cell 0
          *reinterpret_cast<float2*>(e.dh + (size_t)r * H + c - e.D0) = make_float2(in[j].x + a0, in[j].y + a1);
        }
      }
    } else {
      float2 dh[8 * NP];
#pragma unroll
      for (int j = 0; j < 8 * NP; ++j) {
        const int u = col0 + 8 * j + 2 * q;
        if (u < H) dh[j] = *reinterpret_cast<const float2*>(e.dh + (size_t)r * H + u);
      }
#pragma unroll
      for (int j = 0; j < 8 * NP; ++j) {
        const int u = col0 + 8 * j + 2 * q;
        if (u >= H) continue;
        const size_t at = (size_t)r * H + u;
        const float dh0 = dh[j].x + z[4 * j + 2 * hf], dh1 = dh[j].y + z[4 * j + 2 * hf + 1];
        if (e.dh0 != nullptr) {
          *reinterpret_cast<__nv_bfloat162*>(e.dh0 + at) = __floats2bfloat162_rn(dh0, dh1);
          *reinterpret_cast<__nv_bfloat162*>(e.dc0 + at) =
              __float22bfloat162_rn(*reinterpret_cast<const float2*>(e.dc + at));
        } else {
          *reinterpret_cast<float2*>(e.dh + at) = make_float2(dh0, dh1);
        }
      }
    }
  }
}

// The last cell's gate VJP over all B H units, a unit pair a thread: its emitted x carries the cotangent of the
// hidden stream, dhidden out_mask; dh and dc flow in from dh_last / dc_last (step N - 1, bf16) or from the float32
// dh / dc that the query product of the step after left (dh_last null).  At H = 256 a step's query product has 8
// blocks: this elementwise pass spreads the VJP over the card instead of 16 VJPs a thread in its epilogue.
__global__ void __launch_bounds__(256)
    gate_kernel(const GateRows g, const Bf* __restrict__ out_mask, const Bf* __restrict__ dh_last,
                const Bf* __restrict__ dc_last, float* __restrict__ dh, float* __restrict__ dc, int B) {
  const int pairs = g.H / 2;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < (size_t)B * pairs;
       i += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(i / pairs), u = 2 * (int)(i - (size_t)r * pairs);
    const size_t at = (size_t)r * g.H + u;
    const GateIn in = gate_load(g, r, u);
    const float2 h = dh_last != nullptr ? load_bf2(dh_last + at) : *reinterpret_cast<const float2*>(dh + at);
    const float2 c = dc_last != nullptr ? load_bf2(dc_last + at) : *reinterpret_cast<const float2*>(dc + at);
    const float2 dhid = load_bf2(g.dhidden + at), om = load_bf2(out_mask + at);
    float dhv[2] = {h.x, h.y}, dcv[2] = {c.x, c.y};
    const float dx[2] = {dhid.x * om.x, dhid.y * om.y};
    gate_vjp(g, in, r, u, dhv, dcv, dx);
    *reinterpret_cast<float2*>(dh + at) = make_float2(dhv[0], dhv[1]);
    *reinterpret_cast<float2*>(dc + at) = make_float2(dcv[0], dcv[1]);
  }
}

// dprobs[b, s] = dctx[b] . value[b, s] in float32 (dctx unrounded, as the Pallas kernel takes it), grid (B, chunks
// of DP_FRAMES key frames): a warp takes DP_FRAMES / 8 frames together, lane l the 16-byte chunks l, l + 32, .. of
// each value row, then a warp sum; frames past S are skipped.
__global__ void __launch_bounds__(DP_THREADS)
    dprobs_kernel(const float* __restrict__ dctx, const Bf* __restrict__ value, float* __restrict__ dprobs, int S,
                  int Dv) {
  constexpr int F = DP_FRAMES / (DP_THREADS / 32);
  extern __shared__ __align__(16) float sm[];  // [Dv] the row's dctx
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int d = tid; d < Dv; d += DP_THREADS) sm[d] = dctx[(size_t)b * Dv + d];
  __syncthreads();
  const int s0 = blockIdx.y * DP_FRAMES + warp * F;
  const Bf* vb = value + (size_t)b * S * Dv;
  float acc[F] = {};
  for (int c = lane; c < Dv / 8; c += 32) {  // Dv % 8 == 0
    const float4 d0 = reinterpret_cast<const float4*>(sm)[2 * c], d1 = reinterpret_cast<const float4*>(sm)[2 * c + 1];
    const float d[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
    uint4 v[F];
#pragma unroll
    for (int f = 0; f < F; ++f)
      v[f] = s0 + f < S ? *reinterpret_cast<const uint4*>(vb + (size_t)(s0 + f) * Dv + 8 * c) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[f]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 x = __bfloat1622float2(h[k]);
        acc[f] = fmaf(d[2 * k], x.x, acc[f]);
        acc[f] = fmaf(d[2 * k + 1], x.y, acc[f]);
      }
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    acc[f] = warp_sum(acc[f]);
    if (lane == 0 && s0 + f < S) dprobs[(size_t)b * S + s0 + f] = acc[f];
  }
}

// The softmax VJP and dq of batch row b, grid (B, chunks of DQ_COLS columns of pk): every block of the row forms
// t = sum_s p dprobs (a block sum in a fixed order, the same in each) and dscores = p (dprobs - t) in float32 on the
// probabilities stored in bf16 (the row's first block writes dscores rounded), then dq[b, h] = sum_s dscores[s]
// pk[b, s, h], a thread per column, frames in order, pk streamed in tiles of DQ_FRAMES frames through a double
// buffer; dq is written rounded: the query product's A operand.  probs, dscores and dq point at step n's rows.
__global__ void __launch_bounds__(DQ_COLS)
    dq_kernel(const Bf* __restrict__ probs, const float* __restrict__ dprobs, const Bf* __restrict__ pk,
              Bf* __restrict__ dscores, Bf* __restrict__ dq, int S, int H) {
  extern __shared__ __align__(16) float sm[];
  Bf* tiles = reinterpret_cast<Bf*>(sm);        // [2][DQ_FRAMES][DQ_COLS] pk, double-buffered
  float* p = sm + DQ_FRAMES * DQ_COLS;          // [S] probabilities
  float* ds = p + S;                            // [S] dprobs, then dscores
  float* red = ds + S;                          // [33]
  const int b = blockIdx.x, tid = threadIdx.x;
  const int h0 = blockIdx.y * DQ_COLS, n_tiles = (S + DQ_FRAMES - 1) / DQ_FRAMES;
  const Bf* pkb = pk + (size_t)b * S * H;
  auto stage = [&](int t) {  // frames [DQ_FRAMES t, DQ_FRAMES (t + 1)) of the block's columns into buffer t % 2
    if (t < n_tiles) {
      const uint32_t dst = smem_addr(tiles + (t & 1) * DQ_FRAMES * DQ_COLS);
      for (int e = tid; e < DQ_FRAMES * DQ_COLS / 8; e += DQ_COLS) {
        const int f = e / (DQ_COLS / 8), c = 8 * (e - f * (DQ_COLS / 8)), s = t * DQ_FRAMES + f;
        const bool in_row = s < S && h0 + c < H;  // H % 8 == 0
        cp_async16(dst + 2 * (f * DQ_COLS + c), in_row ? pkb + (size_t)s * H + h0 + c : pkb, in_row ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  stage(0);
  float t = 0.0f;
  for (int s = tid; s < S; s += DQ_COLS) {
    const float pv = to_f(probs[(size_t)b * S + s]), dv = dprobs[(size_t)b * S + s];
    p[s] = pv;
    ds[s] = dv;
    t += pv * dv;
  }
  t = block_reduce(t, red, false);
  for (int s = tid; s < S; s += DQ_COLS) {
    const float v = p[s] * (ds[s] - t);
    ds[s] = v;
    if (blockIdx.y == 0) dscores[(size_t)b * S + s] = __float2bfloat16_rn(v);
  }
  float acc = 0.0f;
  for (int tt = 0; tt < n_tiles; ++tt) {
    stage(tt + 1);
    cp_async_wait<1>();
    __syncthreads();  // tile tt has landed for every thread (and, at tt = 0, dscores is complete)
    const Bf* tile = tiles + (tt & 1) * DQ_FRAMES * DQ_COLS;
    const int nf = min(DQ_FRAMES, S - tt * DQ_FRAMES);
    for (int f = 0; f < nf; ++f) acc = fmaf(ds[tt * DQ_FRAMES + f], to_f(tile[f * DQ_COLS + tid]), acc);
    __syncthreads();  // every thread is done with buffer tt % 2 before tile tt + 2 refills it
  }
  if (h0 + tid < H) dq[(size_t)b * H + h0 + tid] = __float2bfloat16_rn(acc);
}

template <int EPI>
decltype(&reverse_product_kernel<1, 1, EPI>) reverse_product_kernel_for(const ProductPlan& p) {
  if (p.wgs == 2) return p.panels == 2 ? reverse_product_kernel<2, 2, EPI> : reverse_product_kernel<2, 1, EPI>;
  return p.panels == 2 ? reverse_product_kernel<1, 2, EPI> : reverse_product_kernel<1, 1, EPI>;
}

template <int EPI>
cudaError_t launch_reverse_product(const ProductPlan& p, const CUtensorMap& a, const CUtensorMap& wm, int n_k, int B,
                                   int N, const ReverseEpi& e, cudaStream_t stream) {
  const dim3 grid((B + WG_ROWS * p.wgs - 1) / (WG_ROWS * p.wgs), (N + PANEL * p.panels - 1) / (PANEL * p.panels));
  reverse_product_kernel_for<EPI>(p)<<<grid, 128 * p.wgs, product_smem(p.wgs, p.panels), stream>>>(a, wm, n_k, e);
  return cudaGetLastError();
}

template <int EPI>
decltype(&product_kernel<1, 1, EPI>) product_kernel_for(const ProductPlan& p) {
  if (p.wgs == 2) return p.panels == 2 ? product_kernel<2, 2, EPI> : product_kernel<2, 1, EPI>;
  return p.panels == 2 ? product_kernel<1, 2, EPI> : product_kernel<1, 1, EPI>;
}

inline decltype(&scores_kernel<1>) scores_kernel_for(int kb) {
  switch (kb) {
    case 1: return scores_kernel<1>;
    case 2: return scores_kernel<2>;
    case 4: return scores_kernel<4>;
    case 8: return scores_kernel<8>;
    default: return scores_kernel<16>;
  }
}

inline decltype(&context_kernel<1>) context_kernel_for(int kb) {
  switch (kb) {
    case 1: return context_kernel<1>;
    case 2: return context_kernel<2>;
    case 4: return context_kernel<4>;
    case 8: return context_kernel<8>;
    default: return context_kernel<16>;
  }
}

inline int beams_pow2(int K) {
  int kb = 1;
  while (kb < K) kb *= 2;
  return kb;
}
inline int round64(int n) { return (n + PANEL - 1) / PANEL * PANEL; }
inline int cell_in(const SplitStep& s, int ci) { return ci == 0 ? s.He + s.Dv : s.H; }

inline bool plan_ok(const ProductPlan& p) { return (p.wgs == 1 || p.wgs == 2) && (p.panels == 1 || p.panels == 2); }

template <int EPI>
cudaError_t launch_product(const ProductPlan& p, const CUtensorMap& a1, const CUtensorMap& a2, const CUtensorMap& wm,
                           int n_k1, int n_k, int R, int N, const int* run_flag, const Epi& e, cudaStream_t stream) {
  const dim3 grid((R + WG_ROWS * p.wgs - 1) / (WG_ROWS * p.wgs), (N + PANEL * p.panels - 1) / (PANEL * p.panels));
  product_kernel_for<EPI>(p)<<<grid, 128 * p.wgs, product_smem(p.wgs, p.panels), stream>>>(a1, a2, wm, n_k1, n_k,
                                                                                             run_flag, e);
  return cudaGetLastError();
}

}  // namespace sp

cudaError_t split_prepare(const SplitStep& s, SplitMaps* m) {
  using namespace sp;
  const int R = s.B * s.K, H = s.H;
  if (s.n_cells < 1 || s.n_cells > SPLIT_MAX_CELLS || s.K < 1 || s.K > MAX_KB || H % 8 || s.He % 8 || s.Dv % 8 ||
      !plan_ok(s.qp) || !plan_ok(s.cp) || s.Hu < H || s.Hu % (16 * s.cp.panels))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = panel_map(&m->qw, s.qw, H, H)) != cudaSuccess) return err;
  if ((err = panel_map(&m->x0, s.x0, R, s.He + s.Dv)) != cudaSuccess) return err;
  for (int p = 0; p < 2; ++p) {
    if ((err = panel_map(&m->hq[p], s.hq + (size_t)p * R * H, R, H)) != cudaSuccess) return err;
    if ((err = panel_map(&m->xs[p], s.xs + (size_t)p * R * H, R, H)) != cudaSuccess) return err;
  }
  for (int ci = 0; ci < s.n_cells; ++ci) {
    const int depth = round64(cell_in(s, ci)) + round64(H);
    if ((err = panel_map(&m->w[ci], s.w[ci], depth, 4 * s.Hu)) != cudaSuccess) return err;
  }
  const ProductPlan* plans[3] = {&s.qp, &s.cp, &s.cp};
  for (int i = 0; i < 3; ++i) {
    const auto kernel = i == 0   ? (const void*)product_kernel_for<EPI_QUERY>(*plans[i])
                        : i == 1 ? (const void*)product_kernel_for<EPI_CELL>(*plans[i])
                                 : (const void*)product_kernel_for<EPI_TRAIN>(*plans[i]);
    const size_t smem = product_smem(plans[i]->wgs, plans[i]->panels);
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) != cudaSuccess)
      return err;
  }
  const int kb = beams_pow2(s.K);
  const size_t ss = scores_smem(kb, H), cs = context_smem(kb, s.S);
  if (ss > (size_t)MAX_SMEM || cs > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(scores_kernel_for(kb), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ss)) !=
      cudaSuccess)
    return err;
  return cudaFuncSetAttribute(context_kernel_for(kb), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cs);
}

cudaError_t split_hq_init(const SplitStep& s, cudaStream_t stream) {
  const size_t n = (size_t)s.B * s.K * s.H;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  sp::hq_init_kernel<<<blocks, 256, 0, stream>>>(s.h, s.hq, n);
  return cudaGetLastError();
}

// The step up to the first cell's input: the query product over hq[parity], the scores, the context (times
// ctx_mask where given) and the embedding rows prev[r prev_stride] of ``s.emb`` into x0
static cudaError_t split_attend(const SplitStep& s, const SplitMaps& m, const int* prev, int prev_stride,
                                const int* run_flag, int parity, const wg::Bf* ctx_mask, int mask_ld,
                                cudaStream_t stream) {
  using namespace sp;
  const int R = s.B * s.K, H = s.H;
  const int n_kh = round64(H) / PANEL;
  Epi e{};
  e.R = R;
  e.H = H;
  e.bias = s.qb;
  e.q = s.q;
  cudaError_t err = launch_product<EPI_QUERY>(s.qp, m.hq[parity], m.hq[parity], m.qw, n_kh, n_kh, R, H, run_flag, e,
                                              stream);
  if (err != cudaSuccess) return err;

  const int kb = beams_pow2(s.K);
  scores_kernel_for(kb)<<<dim3(s.B, (s.S + SCORE_FRAMES - 1) / SCORE_FRAMES), SCORE_THREADS, scores_smem(kb, H),
                          stream>>>(s.q, s.pk, s.attn_bias, run_flag, s.scores, s.K, s.S, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  context_kernel_for(kb)<<<dim3(s.B, (s.Dv + CTX_COLS - 1) / CTX_COLS), CTX_COLS, context_smem(kb, s.S), stream>>>(
      s.scores, s.value, s.emb, prev, prev_stride, run_flag, ctx_mask, mask_ld, s.x0, s.K, s.S, s.He, s.Dv);
  return cudaGetLastError();
}

cudaError_t split_step(const SplitStep& s, const SplitMaps& m, const int* prev, int prev_stride, const int* run_flag,
                       int parity, cudaStream_t stream) {
  using namespace sp;
  const int R = s.B * s.K, H = s.H;
  const size_t plane = (size_t)R * H;
  const int n_kh = round64(H) / PANEL;
  cudaError_t err = split_attend(s, m, prev, prev_stride, run_flag, parity, nullptr, 0, stream);
  if (err != cudaSuccess) return err;
  Epi e{};
  e.prev = prev;
  e.prev_stride = prev_stride;
  e.pad_id = s.pad_id;
  e.R = R;
  e.H = H;
  int p = parity;
  for (int ci = 0; ci < s.n_cells; ++ci) {
    e.bias = s.bias[ci];
    e.h = s.h;
    e.c = s.c;
    e.hq_out = s.hq + (p ^ 1) * plane;
    e.x_out = ci == s.n_cells - 1 ? s.hidden : s.xs + (ci & 1) * plane;
    const CUtensorMap& a1 = ci == 0 ? m.x0 : m.xs[(ci - 1) & 1];
    const int n_k1 = round64(cell_in(s, ci)) / PANEL;
    err = launch_product<EPI_CELL>(s.cp, a1, m.hq[p], m.w[ci], n_k1, n_k1 + n_kh, R, 4 * s.Hu, run_flag, e, stream);
    if (err != cudaSuccess) return err;
    p ^= 1;
  }
  return cudaSuccess;
}

cudaError_t split_decoder_fwd(const SplitStep& s, const SplitMaps& m, const SplitTrain& t, cudaStream_t stream) {
  using namespace sp;
  if (s.K != 1 || t.N < 1) return cudaErrorInvalidValue;
  const int B = s.B, H = s.H;
  const size_t plane = (size_t)B * H;
  const int n_kh = round64(H) / PANEL;
  int p = 0;  // the plane of hq holding rnd(h)
  for (int n = 0; n < t.N; ++n) {
    cudaError_t err = split_attend(s, m, t.rows + (size_t)n * B, 1, nullptr, p, t.ctx_mask, t.ctx_ld, stream);
    if (err != cudaSuccess) return err;
    Epi e{};
    e.R = B;
    e.H = H;
    e.h = s.h;
    e.c = s.c;
    e.gate = t.token_mask + (size_t)n * B;
    for (int ci = 0; ci < s.n_cells; ++ci) {
      const bool last = ci == s.n_cells - 1;
      e.bias = s.bias[ci];
      e.hq_out = s.hq + (p ^ 1) * plane;
      e.x_out = last ? t.hidden + n * plane : s.xs + (ci & 1) * plane;
      e.next_mask = t.out_mask[ci];
      e.z_out = t.z[ci] + n * 4 * plane;
      e.cp_out = t.cp[ci] + n * plane;
      e.hs_out = last ? t.h_state + (n + 1) * plane : nullptr;
      e.cs_out = last ? t.c_state + (n + 1) * plane : nullptr;
      const CUtensorMap& a1 = ci == 0 ? m.x0 : m.xs[(ci - 1) & 1];
      const int n_k1 = round64(cell_in(s, ci)) / PANEL;
      err = launch_product<EPI_TRAIN>(s.cp, a1, m.hq[p], m.w[ci], n_k1, n_k1 + n_kh, B, 4 * s.Hu, nullptr, e, stream);
      if (err != cudaSuccess) return err;
      p ^= 1;
    }
  }
  return cudaSuccess;
}

cudaError_t split_decoder_bwd(const SplitReverse& s, cudaStream_t stream) {
  using namespace sp;
  const int N = s.N, B = s.B, S = s.S, H = s.H, D0 = s.He + s.Dv, last = s.n_cells - 1;
  if (N < 1 || B < 1 || S < 1 || s.n_cells < 1 || s.n_cells > SPLIT_MAX_CELLS || H % 8 || s.He % 8 || s.Dv % 8 ||
      !plan_ok(s.query_plan) || !plan_ok(s.cell0_plan) || !plan_ok(s.cell_plan) || dq_smem(S) > (size_t)MAX_SMEM ||
      dprobs_smem(s.Dv) > (size_t)MAX_SMEM)
    return cudaErrorInvalidValue;
  const size_t plane = (size_t)B * H;
  CUtensorMap qw_map, dq_map, dz_map[SPLIT_MAX_CELLS], w_map[SPLIT_MAX_CELLS];
  cudaError_t err;
  if ((err = panel_map(&qw_map, s.qw_t, H, H)) != cudaSuccess) return err;
  if ((err = panel_map(&dq_map, s.dq, N * B, H)) != cudaSuccess) return err;
  for (int i = 0; i < s.n_cells; ++i) {
    if ((err = panel_map(&dz_map[i], s.dz[i], N * B, 4 * H)) != cudaSuccess) return err;
    if ((err = panel_map(&w_map[i], s.w[i], 4 * H, i == 0 ? D0 + H : 2 * H)) != cudaSuccess) return err;
  }
  const std::pair<const void*, size_t> smem[] = {
      {(const void*)reverse_product_kernel_for<EPI_RQUERY>(s.query_plan),
       product_smem(s.query_plan.wgs, s.query_plan.panels)},
      {(const void*)reverse_product_kernel_for<EPI_RCELL0>(s.cell0_plan),
       product_smem(s.cell0_plan.wgs, s.cell0_plan.panels)},
      {(const void*)reverse_product_kernel_for<EPI_RCELL>(s.cell_plan),
       product_smem(s.cell_plan.wgs, s.cell_plan.panels)},
      {(const void*)dprobs_kernel, dprobs_smem(s.Dv)},
      {(const void*)dq_kernel, dq_smem(S)}};
  for (const auto& [kernel, bytes] : smem)
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)) != cudaSuccess)
      return err;

  // cell ci's gate VJP rows at step n
  auto rows = [&](int ci, int n) {
    GateRows g{};
    g.cell = ci;
    g.H = H;
    g.gate = s.token_mask + (size_t)n * B;
    g.z = s.z[ci] + (size_t)n * 4 * plane;
    g.cp = s.cp[ci] + (size_t)n * plane;
    g.c_in0 = s.c_in0 + (size_t)n * plane;
    for (int j = 0; j < s.n_cells; ++j) g.cps[j] = s.cp[j] + (size_t)n * plane;
    g.dhidden = s.dhidden + (size_t)n * plane;
    g.dz = s.dz[ci] + (size_t)n * 4 * plane;
    return g;
  };
  const int pairs = B * (H / 2), gate_blocks = (pairs + 255) / 256 < 4096 ? (pairs + 255) / 256 : 4096;
  gate_kernel<<<gate_blocks, 256, 0, stream>>>(rows(last, N - 1), s.out_mask, s.dh_last, s.dc_last, s.dh, s.dc, B);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n_k4h = round64(4 * H) / PANEL, n_kh = round64(H) / PANEL;
  for (int n = N - 1; n >= 0; --n) {
    ReverseEpi e{};
    e.a_row0 = n * B;
    e.B = B;
    e.H = H;
    e.He = s.He;
    e.D0 = D0;
    e.dh = s.dh;
    e.dc = s.dc;
    for (int i = last; i > 0; --i) {
      e.in_mask = s.mask[i];
      e.g = rows(i - 1, n);
      err = launch_reverse_product<EPI_RCELL>(s.cell_plan, dz_map[i], w_map[i], n_k4h, B, 2 * H, e, stream);
      if (err != cudaSuccess) return err;
    }
    e.in_mask = s.mask[0];
    e.demb = s.demb + (size_t)n * B * s.He;
    e.dctx = s.dctx + (size_t)n * B * s.Dv;
    e.dctx_f = s.dctx_f;
    err = launch_reverse_product<EPI_RCELL0>(s.cell0_plan, dz_map[0], w_map[0], n_k4h, B, D0 + H, e, stream);
    if (err != cudaSuccess) return err;

    dprobs_kernel<<<dim3(B, (S + DP_FRAMES - 1) / DP_FRAMES), DP_THREADS, dprobs_smem(s.Dv), stream>>>(
        s.dctx_f, s.value, s.dprobs, S, s.Dv);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    dq_kernel<<<dim3(B, (H + DQ_COLS - 1) / DQ_COLS), DQ_COLS, dq_smem(S), stream>>>(
        s.probs + (size_t)n * B * S, s.dprobs, s.pk, s.dscores + (size_t)n * B * S, s.dq + (size_t)n * plane, S, H);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    if (n == 0) {
      e.dh0 = s.dh0;
      e.dc0 = s.dc0;
    }
    err = launch_reverse_product<EPI_RQUERY>(s.query_plan, dq_map, qw_map, n_kh, B, H, e, stream);
    if (err != cudaSuccess) return err;
    if (n > 0) {
      gate_kernel<<<gate_blocks, 256, 0, stream>>>(rows(last, n - 1), s.out_mask, nullptr, nullptr, s.dh, s.dc, B);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace srt
