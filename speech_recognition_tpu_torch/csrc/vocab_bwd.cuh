// The bf16 backward of the vocab-projection kernels on Hopper's tensor cores:
// one engine for K1/K6 (csrc/ctc_emissions.cu) and K8/K9 (csrc/transducer_joint.cu).
//
// After a per-family prologue (K6: the fold of duplicate ids and their sorted
// list; K8/K9: h = rnd(tanh(rnd(enc + pred))) written once to hbuf), both
// compute, for rows h [R, H] (bf16), W [H, V], b [V] and per-row lse and
// coefficient c:
//   z = h W + b (float32),  dz = p c + label terms with p = exp(z - lse),
//   dh = rnd(dz) W^T,  dW = h^T rnd(dz),  db = sum dz (rounded or not, by family).
// A policy class P gives the per-row data (P::Row, P::row), the label terms
// (P::add_labels), the db rounding (P::kDbRounded) and the dh epilogue
// (P::store_dh: K1/K6 dhid in bf16; K8/K9 dpre = dh (1 - h^2) in float32).
//
// What bounds it: three products of 2 R H V operations (the recompute, dh,
// dW) against tens of MB of inputs: the bf16 tensor-core peak.  Design:
//  - every operand lives in shared memory as panels of [rows x 64] bf16, one
//    128-byte row per data row, 16-byte chunks swizzled by (row % 8): the
//    layout the wgmma descriptors name as 128-byte swizzle, usable both
//    K-major and MN-major, so one W panel is the B operand of z = h W
//    (MN-major) and of dh = dz W^T (K-major) without a transposed copy (the
//    panels, descriptors and PTX wrappers are csrc/wgmma.cuh, shared with the
//    forward vocab tile pass of csrc/vocab_topk.cuh);
//  - operands arrive by cp.async (16 bytes a thread, zero-filled past the
//    edges) into a ring of stages, the next stages' copies in flight while
//    the current one is multiplied; a row pitch that is not 16-byte aligned
//    (V or H not a multiple of 8) takes a staged copy into the same layout;
//  - the products are wgmma m64n64k16 (bf16 in, float32 accumulators): a
//    warpgroup owns 64 rows;
//  - row kernel (dh), grid (row block, chunk of H): a block owns 64 or 128
//    rows whose h stays resident and walks V in tiles of 64 columns; dz never
//    leaves registers (the accumulator's layout is the A operand's), and dh
//    stays in registers over the whole walk;
//  - column kernel (dW, db), grid (vocab tile, chunk of H, row split): a
//    block owns 64 vocab columns of W, resident, and walks its rows in blocks
//    of 128; rnd(dz) goes to shared memory as the B operand of dW += h^T
//    rnd(dz); each warpgroup and row split writes its own partial, summed in
//    a fixed order by part_sum_kernel: no atomics, so two calls return the
//    same bits;
//  - tile mode, when H is one chunk (at most MAX_CHUNK panels: every main-path
//    shape): a ring stage holds a whole W tile [H x 64] (row kernel) or row
//    block of h [128 x H] (column kernel), read by both products, one block
//    barrier and two waits a tile.  Panel mode, for wider H: a stage holds one
//    panel, each tile's panels stream in twice (for z over all of H, then for
//    the block's chunk), and one wgmma group runs on while the next panel is
//    waited for.  Tile mode took K8's backward from 36 to 28 ms on an H100
//    (tools/vocab_bwd_profile.py); both kernels stay at 130-270 TFLOP/s, with
//    each warpgroup's epilogue (exp, labels, rounding) between its two
//    products and m64n64 operands read from shared memory for every product.
// Rounding stays where JAX puts it: dz is rounded once before the products;
// db sums it unrounded (K1/K6) or rounded (K8/K9).
#pragma once

#include "wgmma.cuh"

namespace srt {
namespace vb {

using namespace wg;  // PANEL, ROW_BYTES, WG_ROWS, W_PANEL, ALIGN and the PTX helpers (csrc/wgmma.cuh)
using Bf = __nv_bfloat16;

constexpr int MAX_CHUNK = 5;      // panels of dh (row kernel) or dW (column kernel) a block keeps in registers
// Stages of the two rings.  Tile mode (H of at most MAX_CHUNK panels: one
// chunk): a stage holds a whole W tile [H x 64] (row kernel) or row block of
// h [128 x H] (column kernel), read by both products.  Panel mode (wider H):
// a stage holds one panel, and each tile's panels stream in twice.
constexpr int ROW_TILE_STAGES = 3, ROW_STAGES = 6;
constexpr int COL_TILE_STAGES = 2, COL_STAGES = 4;
constexpr int COL_ROWS = 128;     // rows of one row block of the column kernel (two warpgroups)
constexpr int H_PANEL = COL_ROWS * ROW_BYTES;     // [128 x 64] bf16
constexpr int DB_SCRATCH = 2 * 4 * PANEL * 4;     // per-warp column sums of db, float32

// Dynamic shared memory of the two kernels (ops/vocab_bwd.py mirrors both).
inline size_t row_smem(int n_k, int wgs, bool tile) {
  return ALIGN + (size_t)n_k * wgs * WG_ROWS * ROW_BYTES +
         (tile ? (size_t)ROW_TILE_STAGES * n_k * W_PANEL : (size_t)ROW_STAGES * W_PANEL);
}
inline size_t col_smem(int n_k, bool tile) {
  return ALIGN + (size_t)n_k * W_PANEL + (tile ? (size_t)COL_TILE_STAGES * n_k * H_PANEL : (size_t)COL_STAGES * H_PANEL) +
         2 * W_PANEL + DB_SCRATCH;
}

// The launch plan, from ops/vocab_bwd.py bwd_plan.
struct Plan {
  int row_wgs, tile, chunk_panels, n_split, rows_per_split;
};

__device__ __forceinline__ void bar_sync_wg(int id) { asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t a) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(a) : "memory");
}

// The thread's cells of a 64 x 64 accumulator: index i = 4j + 2 half + e is
// row 16 warp + lane / 4 + 8 half, column 8j + 2 (lane % 4) + e.  The 16
// cells of one half, as d[2j + e], are what the policies work on.
__device__ __forceinline__ void dz_cells(const float (&z)[32], int half, int v0, int q, int V, const Bf* __restrict__ bias,
                                         float lse, float c, float (&d)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int v = v0 + 8 * j + 2 * q + e;
      const float bv = v < V ? __bfloat162float(bias[v]) : 0.0f;
      d[2 * j + e] = expf(z[4 * j + 2 * half + e] + bv - lse) * c;
    }
}

// index of column ``col`` (0..63) in d[16] when it is one of this thread's (lane % 4 == q), else -1
__device__ __forceinline__ int cell_of(int col, int q) {
  return (col >= 0 && col < PANEL && ((col >> 1) & 3) == q) ? ((col >> 3) << 1 | (col & 1)) : -1;
}

__device__ __forceinline__ void add_at(float (&d)[16], int idx, float val) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i == idx) d[i] += val;
}

// ---------------------------------------------------------------- row kernel: dh
// grid (ceil(R / (64 wgs)), n_chunks), 128 wgs threads.  Shared memory: the
// block's h rows (n_k panels of [64 wgs x 64]), then the ring of W.  Tile
// mode: a stage is a W tile (n_k panels), read by z = h W and by dh += dz W^T,
// with S - 1 tiles in flight.  Panel mode: a stage is one panel, S - 2 in
// flight, and one wgmma group runs on while the next panel is waited for.  A
// stage is refilled once every product that read it is done.
template <class P, bool TILE>
__global__ void __launch_bounds__(256, 1)
    vb_row_kernel(const P pol, const Bf* __restrict__ h, size_t h_ld, int h_al, const Bf* __restrict__ W, int w_al,
                  const Bf* __restrict__ bias, int R, int H, int V, int n_k, int chunk_panels) {
  constexpr int S = TILE ? ROW_TILE_STAGES : ROW_STAGES, D = TILE ? S - 1 : S - 2;
  extern __shared__ uint8_t vb_smem[];
  const uint32_t base = (smem_addr(vb_smem) + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const int tid = threadIdx.x, nthr = blockDim.x, wg = tid >> 7;
  const int warp = (tid & 127) >> 5, lane = tid & 31, q = lane & 3;
  const int bm = nthr / 2;  // 64 rows per warpgroup
  const size_t r0 = (size_t)blockIdx.x * bm;
  const int p0 = blockIdx.y * chunk_panels, n_pc = min(chunk_panels, n_k - p0);
  const uint32_t hs = base, ring = base + n_k * bm * ROW_BYTES;
  const int stage_bytes = TILE ? n_k * W_PANEL : W_PANEL;
  const int per_tile = TILE ? 1 : n_k + n_pc, n_tiles = (V + PANEL - 1) / PANEL, n_units = n_tiles * per_tile;

  // unit i of the stream.  Tile mode: W tile i.  Panel mode: tile i / per_tile's W rows of panel j < n_k
  // (for z), then of the chunk (for dh).
  auto issue = [&](int i) {
    if (i < n_units) {
      const uint32_t st = ring + (i % S) * stage_bytes;
      if constexpr (TILE) {
        for (int k = 0; k < n_k; ++k)
          load_panel(st + k * W_PANEL, PANEL, W, V, w_al, (size_t)k * PANEL, H - k * PANEL, i * PANEL, V - i * PANEL,
                     tid, nthr);
      } else {
        const int t = i / per_tile, j = i - t * per_tile;
        const int kr = (j < n_k ? j : p0 + j - n_k) * PANEL;
        load_panel(st, PANEL, W, V, w_al, kr, H - kr, t * PANEL, V - t * PANEL, tid, nthr);
      }
    }
    cp_async_commit();
  };
  for (int k = 0; k < n_k; ++k)
    load_panel(hs + k * bm * ROW_BYTES, bm, h, h_ld, h_al, r0, (long long)R - (long long)r0, k * PANEL, H - k * PANEL,
               tid, nthr);
  cp_async_commit();
  for (int i = 0; i < D; ++i) issue(i);

  const size_t row0 = r0 + 64 * wg + 16 * warp + (lane >> 2);  // this thread's rows: row0, row0 + 8
  typename P::Row rows[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) rows[hf] = pol.row(row0 + 8 * hf, row0 + 8 * hf < (size_t)R, 0);

  float dh[MAX_CHUNK][32];
#pragma unroll
  for (int p = 0; p < MAX_CHUNK; ++p)
#pragma unroll
    for (int k = 0; k < 32; ++k) dh[p][k] = 0.0f;
  int i = 0;
  // unit i has landed for every thread and the stage of unit i + D is free: start its copy
  auto next = [&]() {
    cp_async_wait<D - 1>();
    fence_async_smem();
    __syncthreads();
    issue(i + D);
    return ring + (i % S) * stage_bytes;
  };
  const uint32_t a_rows = hs + 64 * wg * ROW_BYTES;
  for (int t = 0; t < n_tiles; ++t) {
    float z[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) z[k] = 0.0f;
    uint32_t wt = 0;  // tile mode: this tile's stage
    if constexpr (TILE) {
      wt = next();
      ++i;
      wg_arrive();
      for (int k = 0; k < n_k; ++k)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          mma_ss<0, 1>(z, kmajor(a_rows + k * bm * ROW_BYTES + 32 * s), mnmajor(wt + k * W_PANEL + 2048 * s));
      wg_commit();
    } else {
      for (int k = 0; k < n_k; ++k, ++i) {
        const uint32_t wp = next(), ap = a_rows + k * bm * ROW_BYTES;
        wg_arrive();
#pragma unroll
        for (int s = 0; s < 4; ++s) mma_ss<0, 1>(z, kmajor(ap + 32 * s), mnmajor(wp + 2048 * s));
        wg_commit();
        wg_wait<1>();
      }
    }
    wg_wait<0>();
    reg_fence(z);
    const int v0 = t * PANEL;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float d[16];
      dz_cells(z, hf, v0, q, V, bias, rows[hf].lse, rows[hf].c, d);
      pol.add_labels(rows[hf], v0, q, d);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = rows[hf].valid && v0 + 8 * j + 2 * q + e < V;
          z[4 * j + 2 * hf + e] = ok ? d[2 * j + e] : 0.0f;
        }
    }
    uint32_t a[16];  // rnd(dz) as the A operand: k-step s holds columns 16s .. 16s + 15
#pragma unroll
    for (int k = 0; k < 16; ++k) a[k] = pack_bf16(z[2 * k], z[2 * k + 1]);
    if constexpr (TILE) {
      wg_arrive();
#pragma unroll
      for (int p = 0; p < MAX_CHUNK; ++p)
        if (p < n_pc)
#pragma unroll
          for (int s = 0; s < 4; ++s)
            mma_rs(dh[p], a[4 * s], a[4 * s + 1], a[4 * s + 2], a[4 * s + 3], kmajor(wt + (p0 + p) * W_PANEL + 32 * s));
      wg_commit();
    } else {
#pragma unroll
      for (int p = 0; p < MAX_CHUNK; ++p) {
        if (p < n_pc) {
          const uint32_t wp = next();
          wg_arrive();
#pragma unroll
          for (int s = 0; s < 4; ++s)
            mma_rs(dh[p], a[4 * s], a[4 * s + 1], a[4 * s + 2], a[4 * s + 3], kmajor(wp + 32 * s));
          wg_commit();
          wg_wait<1>();
          ++i;
        }
      }
    }
    wg_wait<0>();
    reg_fence(a);  // the tensor cores have read a: its registers may be reused
  }
#pragma unroll
  for (int p = 0; p < MAX_CHUNK; ++p) {
    reg_fence(dh[p]);
    if (p < n_pc) {
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int j = k >> 2, hf = (k >> 1) & 1, e = k & 1;
        const size_t row = row0 + 8 * hf;
        const int col = (p0 + p) * PANEL + 8 * j + 2 * q + e;
        if (row < (size_t)R && col < H) pol.store_dh(row, col, dh[p][k]);
      }
    }
  }
}

// ---------------------------------------------------------------- column kernel: dW, db
// grid (ceil(V / 64), n_chunks, n_split), 256 threads.  Shared memory: the
// block's W columns (n_k panels of [64 x 64]), the ring of h, each
// warpgroup's rnd(dz) [64 x 64], the db column sums.  Tile mode: a stage is a
// row block of h (n_k panels of [128 x 64]), read by z and by dW += h^T dz.
// Panel mode: a stage is one panel, as in the row kernel.  Warpgroup g of split
// s writes partial 2s + g of dW and (chunk 0) of db.
template <class P, bool TILE>
__global__ void __launch_bounds__(256, 1)
    vb_col_kernel(const P pol, const Bf* __restrict__ h, size_t h_ld, int h_al, const Bf* __restrict__ W, int w_al,
                  const Bf* __restrict__ bias, int R, int H, int V, int n_k, int chunk_panels, int rows_per_split,
                  float* __restrict__ dW_part, float* __restrict__ db_part) {
  constexpr int S = TILE ? COL_TILE_STAGES : COL_STAGES, D = TILE ? S - 1 : S - 2;
  extern __shared__ uint8_t vb_smem[];
  const uint32_t raw = smem_addr(vb_smem), base = (raw + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31, q = lane & 3;
  const int v0 = blockIdx.x * PANEL, p0 = blockIdx.y * chunk_panels, n_pc = min(chunk_panels, n_k - p0);
  const size_t rb = (size_t)blockIdx.z * rows_per_split;
  const size_t re = rb + rows_per_split < (size_t)R ? rb + rows_per_split : (size_t)R;
  const int stage_bytes = TILE ? n_k * H_PANEL : H_PANEL;
  const uint32_t wcols = base, ring = wcols + n_k * W_PANEL, dzs = ring + S * stage_bytes;
  const uint32_t my_dz = dzs + wg * W_PANEL;
  float* dbw = reinterpret_cast<float*>(vb_smem + (dzs + 2 * W_PANEL - raw)) + wg * 4 * PANEL;  // [4 warps][64]
  const int n_blocks = re > rb ? (int)((re - rb + COL_ROWS - 1) / COL_ROWS) : 0;
  const int per_blk = TILE ? 1 : n_k + n_pc, n_units = n_blocks * per_blk;

  // unit i of the stream.  Tile mode: row block i.  Panel mode: row block i / per_blk's h columns of panel
  // j < n_k (for z), then of the chunk (for dW).
  auto issue = [&](int i) {
    if (i < n_units) {
      const uint32_t st = ring + (i % S) * stage_bytes;
      if constexpr (TILE) {
        const size_t rs = rb + (size_t)i * COL_ROWS;
        for (int k = 0; k < n_k; ++k)
          load_panel(st + k * H_PANEL, COL_ROWS, h, h_ld, h_al, rs, (long long)(re - rs), k * PANEL, H - k * PANEL,
                     tid, 256);
      } else {
        const int blk = i / per_blk, j = i - blk * per_blk;
        const int kc = (j < n_k ? j : p0 + j - n_k) * PANEL;
        const size_t rs = rb + (size_t)blk * COL_ROWS;
        load_panel(st, COL_ROWS, h, h_ld, h_al, rs, (long long)(re - rs), kc, H - kc, tid, 256);
      }
    }
    cp_async_commit();
  };
  for (int k = 0; k < n_k; ++k)
    load_panel(wcols + k * W_PANEL, PANEL, W, V, w_al, (size_t)k * PANEL, H - k * PANEL, v0, V - v0, tid, 256);
  cp_async_commit();
  for (int i = 0; i < D; ++i) issue(i);

  float dw[MAX_CHUNK][32];
#pragma unroll
  for (int p = 0; p < MAX_CHUNK; ++p)
#pragma unroll
    for (int k = 0; k < 32; ++k) dw[p][k] = 0.0f;
  float db_acc = 0.0f;  // threads wtid < 64: column v0 + wtid of this warpgroup's partial
  int i = 0;
  auto next = [&]() {
    cp_async_wait<D - 1>();
    fence_async_smem();
    __syncthreads();
    issue(i + D);
    return ring + (i % S) * stage_bytes + 64 * wg * ROW_BYTES;  // this warpgroup's 64 rows
  };
  for (int blk = 0; blk < n_blocks; ++blk) {
    float z[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) z[k] = 0.0f;
    uint32_t hb = 0;  // tile mode: this row block's stage (this warpgroup's rows)
    if constexpr (TILE) {
      hb = next();
      ++i;
      wg_arrive();
      for (int k = 0; k < n_k; ++k)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          mma_ss<0, 1>(z, kmajor(hb + k * H_PANEL + 32 * s), mnmajor(wcols + k * W_PANEL + 2048 * s));
      wg_commit();
    } else {
      for (int k = 0; k < n_k; ++k, ++i) {
        const uint32_t ap = next();
        wg_arrive();
#pragma unroll
        for (int s = 0; s < 4; ++s) mma_ss<0, 1>(z, kmajor(ap + 32 * s), mnmajor(wcols + k * W_PANEL + 2048 * s));
        wg_commit();
        wg_wait<1>();
      }
    }
    wg_wait<0>();
    reg_fence(z);
    const size_t row0 = rb + (size_t)blk * COL_ROWS + 64 * wg + 16 * warp + (lane >> 2);
    float colsum[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) colsum[k] = 0.0f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const size_t row = row0 + 8 * hf;
      typename P::Row rw = pol.row(row, row < re, v0);
      float d[16];
      dz_cells(z, hf, v0, q, V, bias, rw.lse, rw.c, d);
      pol.add_labels(rw, v0, q, d);
      const int lr = 16 * warp + (lane >> 2) + 8 * hf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float r[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = rw.valid && v0 + 8 * j + 2 * q + e < V;
          const float dv = ok ? d[2 * j + e] : 0.0f;
          r[e] = rnd<Bf>(dv);
          colsum[2 * j + e] += P::kDbRounded ? r[e] : dv;
        }
        st_shared_b32(my_dz + swz(lr, j) + 4 * q, pack_bf16(r[0], r[1]));
      }
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float s = colsum[k];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      colsum[k] = s;
    }
    if (lane < 4) {
#pragma unroll
      for (int k = 0; k < 16; ++k) dbw[warp * PANEL + 8 * (k >> 1) + 2 * q + (k & 1)] = colsum[k];
    }
    fence_async_smem();
    bar_sync_wg(1 + wg);  // this warpgroup's rnd(dz) and column sums are complete
    if (wtid < PANEL) db_acc += dbw[wtid] + dbw[PANEL + wtid] + dbw[2 * PANEL + wtid] + dbw[3 * PANEL + wtid];
    if constexpr (TILE) {
      wg_arrive();
#pragma unroll
      for (int p = 0; p < MAX_CHUNK; ++p)
        if (p < n_pc)
#pragma unroll
          for (int s = 0; s < 4; ++s)
            mma_ss<1, 1>(dw[p], mnmajor(hb + (p0 + p) * H_PANEL + 2048 * s), mnmajor(my_dz + 2048 * s));
      wg_commit();
    } else {
#pragma unroll
      for (int p = 0; p < MAX_CHUNK; ++p) {
        if (p < n_pc) {
          const uint32_t ap = next();
          wg_arrive();
#pragma unroll
          for (int s = 0; s < 4; ++s) mma_ss<1, 1>(dw[p], mnmajor(ap + 2048 * s), mnmajor(my_dz + 2048 * s));
          wg_commit();
          wg_wait<1>();
          ++i;
        }
      }
    }
    wg_wait<0>();  // the stage and my_dz are free once the next row block starts
  }
  const size_t part = (size_t)blockIdx.z * 2 + wg;
#pragma unroll
  for (int p = 0; p < MAX_CHUNK; ++p) {
    reg_fence(dw[p]);
    if (p < n_pc) {
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int j = k >> 2, hf = (k >> 1) & 1, e = k & 1;
        const int hrow = (p0 + p) * PANEL + 16 * warp + (lane >> 2) + 8 * hf, v = v0 + 8 * j + 2 * q + e;
        if (hrow < H && v < V) dW_part[(part * H + hrow) * V + v] = dw[p][k];
      }
    }
  }
  if (blockIdx.y == 0 && wtid < PANEL && v0 + wtid < V) db_part[part * V + v0 + wtid] = db_acc;
}

// out[i] = sum over z < n_parts of parts[z * n + i], in z order
static __global__ void part_sum_kernel(const float* __restrict__ parts, int n_parts, size_t n, float* __restrict__ out) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int z = 0; z < n_parts; ++z) s += parts[(size_t)z * n + i];
    out[i] = s;
  }
}

template <class Kernel, class... Args>
cudaError_t launch_one(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The row kernel, the column kernel and the ordered sums of the 2 n_split
// partials into dW [H, V] and db [V].  h [R, h_ld] (h_ld >= H), W [H, V], bias
// [V] bf16.
template <class P>
cudaError_t launch(const P& pol, const Bf* h, size_t h_ld, int H, const Bf* W, int V, const Bf* bias, int R,
                   const Plan& plan, float* dW_part, float* db_part, float* dW, float* db, cudaStream_t stream) {
  const int n_k = (H + PANEL - 1) / PANEL, n_chunks = (n_k + plan.chunk_panels - 1) / plan.chunk_panels;
  const int h_al = aligned16(h, h_ld), w_al = aligned16(W, (size_t)V), bm = WG_ROWS * plan.row_wgs;
  const dim3 row_grid((R + bm - 1) / bm, n_chunks), col_grid((V + PANEL - 1) / PANEL, n_chunks, plan.n_split);
  const bool tile = plan.tile;
  if (tile && n_chunks != 1) return cudaErrorInvalidValue;
  const size_t rs = row_smem(n_k, plan.row_wgs, tile), cs = col_smem(n_k, tile);
  cudaError_t err =
      launch_one(tile ? vb_row_kernel<P, true> : vb_row_kernel<P, false>, row_grid, 128 * plan.row_wgs, rs, stream,
                 pol, h, h_ld, h_al, W, w_al, bias, R, H, V, n_k, plan.chunk_panels);
  if (err != cudaSuccess) return err;
  err = launch_one(tile ? vb_col_kernel<P, true> : vb_col_kernel<P, false>, col_grid, 256, cs, stream, pol, h, h_ld,
                   h_al, W, w_al, bias, R, H, V, n_k, plan.chunk_panels, plan.rows_per_split, dW_part, db_part);
  if (err != cudaSuccess) return err;
  part_sum_kernel<<<1024, 256, 0, stream>>>(dW_part, 2 * plan.n_split, (size_t)H * V, dW);
  part_sum_kernel<<<64, 256, 0, stream>>>(db_part, 2 * plan.n_split, (size_t)V, db);
  return cudaGetLastError();
}

}  // namespace vb
}  // namespace srt
