// The split LAS decode step: the bf16 route of the greedy loop (K4, las_greedy.cu), the beam loop (K11,
// las_beam.cu) and the teacher-forced loop forward and reverse (K2, K3: las_decoder.cu).  Declarations here,
// kernels and host code in las_split.cu; the plans are plain Python, ops/las_step.py step_plan and reverse_plan.
//
// One step over all R = B K rows (beam-major: row b K + k) is five launches, each reading a weight once for
// every row of its tile instead of once per batch row:
//  1. the query product q = rnd(h) @ qw + qb (float32 out), a tiled wgmma product;
//  2. the attention, each block holding all K beams of one batch row for a chunk of its key frames (the scores)
//     or of its value columns (the embedding rows, the float32 softmax and the context rounded to bf16, written as
//     the first cell's input x0 = [emb | ctx]);
//  3. one wgmma product per LSTM cell, z = x @ Kc + rnd(h) @ Rc over a gate-interleaved copy of [Kc; Rc], its
//     epilogue the whole cell update (bias, gates, pad gating, h and c in float32, the next cell's inputs).
// The vocab tile pass and the callers' merge / select kernels follow.  Buffers whose every row a launch reads
// as a product's A operand (the rounded h, a cell's input) are ping-ponged, so no block reads what another
// block of the same launch writes.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

#define SPLIT_MAX_CELLS 8  // = ops/las_step.py MAX_CELLS

namespace srt {

// dst[k] = src[k], k < KB, for a beam-minor row in shared memory
template <int KB>
__device__ __forceinline__ void load_beams(const float* __restrict__ src, float (&dst)[KB]) {
  if constexpr (KB % 4 == 0) {
#pragma unroll
    for (int k = 0; k < KB; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + k);
      dst[k] = v.x;
      dst[k + 1] = v.y;
      dst[k + 2] = v.z;
      dst[k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < KB; ++k) dst[k] = src[k];
  }
}

// Weight rows a thread loads before it multiplies them (the rows come from L2 or device memory), so a thread
// keeps BEAM_LOADS loads in flight
#define BEAM_LOADS 16

// acc[k] += sum_a rows[a][k] * W[a * ld + col], a < n in increasing order (rows beam-minor in shared memory)
template <typename T, int KB>
__device__ __forceinline__ void beams_matvec(const float* __restrict__ rows, const T* __restrict__ W, int n,
                                             size_t ld, int col, float (&acc)[KB]) {
  for (int a0 = 0; a0 < n; a0 += BEAM_LOADS) {
    float w[BEAM_LOADS];
#pragma unroll
    for (int u = 0; u < BEAM_LOADS; ++u) w[u] = a0 + u < n ? to_f(W[(size_t)(a0 + u) * ld + col]) : 0.0f;
#pragma unroll
    for (int u = 0; u < BEAM_LOADS; ++u) {
      if (a0 + u < n) {
        float r[KB];
        load_beams<KB>(rows + (a0 + u) * KB, r);
#pragma unroll
        for (int k = 0; k < KB; ++k) acc[k] = fmaf(r[k], w[u], acc[k]);
      }
    }
  }
}

// The launch plan of one product (ops/las_step.py product_plan): warpgroups of 64 rows a block, 64-column
// panels of its output tile.
struct ProductPlan {
  int wgs, panels;
};

// One decode's operands and scratch on the split route, bf16 unless stated.  R = B K rows.
struct SplitStep {
  const wg::Bf *pk, *value, *qw, *qb, *emb;  // pk [B,S,H], value [B,S,Dv], qw [H,H], qb [H], emb [V,He]
  const float* attn_bias;                    // [B,S]
  int n_cells;
  const wg::Bf* w[SPLIT_MAX_CELLS];     // gate-interleaved [in_p + H_p, 4 Hu] (ops/las_step.py interleave_cell)
  const wg::Bf* bias[SPLIT_MAX_CELLS];  // [4H], gates i, f, g, o
  float *h, *c;                         // [R,H] float32, updated in place
  wg::Bf* hq;                           // [2,R,H]: rnd(h), ping-pong
  float* q;                             // [R,H] float32: the queries
  float* scores;                        // [R,S] float32: the attention's scores
  wg::Bf* x0;                           // [R, He + Dv]: the first cell's input
  wg::Bf* xs;                           // [2,R,H]: the inputs of cells 1..n-1, ping-pong
  wg::Bf* hidden;                       // [R,H]: the last cell's output, the vocab pass's rows
  int B, K, S, H, He, Dv, Hu, pad_id;   // Hu: H rounded up to the cell tile's units
  ProductPlan qp, cp;                   // the query product's plan and the cells'
};

// The teacher-forced loop's extra operands (K2 on the split step, las_decoder.cu las_decoder_fwd_split): the
// step's embedding rows come in through ``SplitStep::emb`` as rnd(emb[n] cm0[:He]), made for all N before the
// loop, row n B + b (``rows`` holds 0 .. N B - 1, so step n reads its rows at rows + n B), and each cell's
// epilogue writes K3's residual streams.
struct SplitTrain {
  int N;
  const int* rows;                            // [N B]: i at i, the embedding row of (n, b)
  const float* token_mask;                    // [N,B] float32: the pad gate (nonzero = a real token)
  const wg::Bf* ctx_mask;                     // cm0 + He: the context's dropout mask, row stride ctx_ld
  int ctx_ld;
  const wg::Bf* out_mask[SPLIT_MAX_CELLS];    // [B,H] the mask of cell i's output: cm_{i+1}, or out_mask
  wg::Bf* z[SPLIT_MAX_CELLS];                 // [N,B,4H] out: rnd(z), gates i, f, g, o
  wg::Bf* cp[SPLIT_MAX_CELLS];                // [N,B,H] out: rnd(c')
  wg::Bf* hidden;                             // [N,B,H] out: rnd(rnd(h' m) out_mask) of the last cell
  wg::Bf *h_state, *c_state;                  // [N+1,B,H] out: rnd(h), rnd(c) before step n (row 0 given), then
                                              // after the last step
};

// Tensor maps of the products' operands, built once per host call
struct SplitMaps {
  CUtensorMap qw, hq[2], x0, xs[2], w[SPLIT_MAX_CELLS];
};

// The tensor maps, and the shared memory the split kernels of ``s`` use
cudaError_t split_prepare(const SplitStep& s, SplitMaps* maps);
// hq[0] = rnd(h): the rounded state the first step reads
cudaError_t split_hq_init(const SplitStep& s, cudaStream_t stream);
// One step up to ``hidden``: the query product, the attention, the cells.  Row r's previous token is
// prev[r * prev_stride]; every launch returns at entry when run_flag is given and *run_flag == 0.  The step
// reads hq[parity] and leaves the new rounded state in hq[parity ^ (n_cells & 1)].
cudaError_t split_step(const SplitStep& s, const SplitMaps& maps, const int* prev, int prev_stride,
                       const int* run_flag, int parity, cudaStream_t stream);
// The whole teacher-forced loop of ``t`` (K = 1), enqueued without a host sync: for each of the N steps the
// query product, the attention (the context's mask applied) and one product per cell whose epilogue writes
// the residual streams.  hq[0] holds rnd(h0); h / c hold h0 / c0 in float32.
cudaError_t split_decoder_fwd(const SplitStep& s, const SplitMaps& maps, const SplitTrain& t, cudaStream_t stream);

// The teacher-forced loop's reverse (K3 in bf16, las_decoder.cu las_decoder_bwd_split): the same step transposed,
// steps N - 1 .. 0, each
//  1. one product per cell from the last down, rnd(dz_i) @ [K_i^T | R_i^T] over all B rows (A: the cell's dz
//     stream, written by the previous launch), its epilogue dx = acc_K cm_i, dh_prev = (1 - m) dh + acc_R and,
//     for i > 0, cell i - 1's whole gate VJP (writing rnd(dz_{i-1})); cell 0's writes dx0 = [demb | dctx] instead;
//  2. the attention's VJP: dprobs = dctx . value over chunks of key frames, then the softmax VJP and
//     dq = sum_s dscores pk over chunks of pk's columns;
//  3. the query product rnd(dq) @ qw^T, its epilogue dh = dh_prev + acc (after step 0: dh0, dc0), then the last
//     cell's gate VJP of step n - 1 as an elementwise kernel over all B H units (as at step N - 1, first).
// Every operand bf16 unless stated.
struct SplitReverse {
  int N, B, S, H, He, Dv, n_cells;
  const float* token_mask;                   // [N,B] float32: the pad gate
  const wg::Bf *dhidden, *dh_last, *dc_last;  // [N,B,H], [B,H], [B,H]
  const wg::Bf *probs, *c_in0, *pk, *value;   // [N,B,S], [N,B,H], [B,S,H], [B,S,Dv]
  const wg::Bf *qw_t, *out_mask;              // [H,H] = qw^T, [B,H]
  const wg::Bf* w[SPLIT_MAX_CELLS];           // cell 0: [4H, He + Dv + H] = [K_0^T | R_0^T]; cell i > 0: [4H, 2H],
                                              // K_i^T and R_i^T interleaved (ops/las_step.py reverse_cell_weights)
  const wg::Bf* mask[SPLIT_MAX_CELLS];        // [B, in_i] the cells' dropout masks
  const wg::Bf* z[SPLIT_MAX_CELLS];           // [N,B,4H] K2's rnd(z)
  const wg::Bf* cp[SPLIT_MAX_CELLS];          // [N,B,H] K2's rnd(c')
  wg::Bf* dz[SPLIT_MAX_CELLS];                // [N,B,4H] out: rnd(dz), gates i, f, g, o; the products' A operands
  wg::Bf *demb, *dctx, *dscores, *dq;         // [N,B,He], [N,B,Dv], [N,B,S], [N,B,H] out (dq: the query's A)
  wg::Bf *dh0, *dc0;                          // [B,H] out
  float *dh, *dc, *dctx_f, *dprobs;           // scratch [B,H], [B,H], [B,Dv], [B,S] float32
  ProductPlan query_plan, cell0_plan, cell_plan;  // the products' plans: query, cell 0, cells 1..n-1
};
cudaError_t split_decoder_bwd(const SplitReverse& s, cudaStream_t stream);

}  // namespace srt
