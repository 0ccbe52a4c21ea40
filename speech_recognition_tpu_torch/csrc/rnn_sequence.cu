// Kernel K10: the forward pass of a whole masked LSTM (i,f,c,o) or reset-after
// GRU (z,r,h) sequence, every direction in one launch.  C interface for
// ops/rnn_sequence.py (ctypes).
//
// Replaces rnn_sequence_pallas (speech_recognition_tpu/ops/pallas/rnn_kernel.py:100,
// cells _lstm_kernel :31 and _gru_kernel :65).  On the TPU one core walks the
// T grid steps with the recurrent weights pinned in VMEM.  Here three designs
// share that idea, chosen by width and type (ops/rnn_sequence.py rnn_plan):
//
// 1. The cluster tensor-core route (rc::rnn_cluster_tc_kernel: bf16 up to H = 384, every bf16 recurrent layer of
//    the main paths).  A cluster of C <= 16 CTAs runs one (direction, tile of 64 batch rows) for all T steps: CTA j
//    owns units [j U, j U + U), U = ceil(H / 16) rounded up to 8, C = ceil(H / U), and keeps their gate-interleaved
//    slice of R [K x 4U] (column 32 g + 8 k + t: gate k of unit j U + 8 g + t; K = C U rounded up to 16) resident in
//    shared memory as wgmma's B operand.  It holds the cluster's 64 rows of h(t-1) [64 x K] as wgmma's A operand in
//    two planes by step parity, both K-major without swizzle (8 x 8 core matrices), so that a CTA's slice of h is
//    one contiguous run of bytes.  U / 8 warpgroups each compute their 8 units' 32 gate columns (m64n32k16), every
//    64-deep k-panel into its own accumulator, all issued before one wait, their sums added into z in panel order
//    in float32 (wgmma's accumulation rounds toward zero, PERF.md §6); the thread holding columns 8 i + 2 q + {0, 1}
//    holds every gate of its two units for two rows, so the cell update is the product's epilogue (no round trip
//    through shared memory).  The new h goes into the CTA's own plane (st.shared, a proxy fence, __syncthreads),
//    then to the C - 1 other CTAs as one bulk copy each (cp.async.bulk shared::cta -> shared::cluster), each
//    completing its bytes on the receiver's mbarrier: a CTA waits only on its own barrier for the step's C - 1
//    slices, no cluster barrier.  A CTA sends h(t) only after its own product of step t, which read the other
//    plane, so the wait for h(t) also tells that the other plane may be written again.  x_proj and the mask come
//    ahead of use through a four-stage TMA ring (each gate's columns padded to a multiple of 8 by the caller where
//    H is not, so that every box starts on 16 bytes); out[t] leaves as plain stores no barrier waits for.
//
// 2. The narrow and wide clusters (rnn_sequence_kernel: float32 at every width, bf16 from H = 385 to 512).  A
//    thread-block cluster of RNN_CLUSTER CTAs runs one (direction, tile of RNN_ROWS batch rows) for all T steps: CTA j
//    owns hidden units [j*U, j*U + U), U = ceil(H / 8), and keeps their G gate columns of R in shared memory for the
//    whole sequence.  Each step a CTA computes its [ROWS, G*U] slice of h @ R, applies the gates to its units, and
//    stores its slice of the new h into the next-h buffer of every CTA of the cluster through distributed shared
//    memory; one cluster barrier ends the step.  The step's x_proj and mask are loaded one step ahead, so their latency
//    hides behind the previous step.  The product has three modes, chosen at launch:
//    - MODE_MMA (bf16, 384 < H <= 512): mma.sync m16n8k16 bf16 tiles with float32 accumulators; the 16 batch rows
//      are the tile's M, R is held in shared memory in B-fragment order (one 8-byte load per lane and tile),
//      and h's rows are padded by 8 elements so the A-fragment loads hit 32 banks;
//    - MODE_FMA_SMEM (float32 when R fits): float32 FMA loops, R in shared memory;
//    - MODE_FMA_GLOBAL (R too large, float32 above H ~ 300): the same loops over R read from L2.
//    Up to H = 512 a thread takes 4 (row, unit) pairs of the gate phase and a warp 4 n-tiles
//    (RNN_NARROW_*); above, up to H = 1024 (float32 only), 8 pairs and 8 n-tiles (RNN_WIDE_*).
//
// 3. The persistent grid (rnn_persistent_kernel: bf16 above H = 512, LAS-large's listener at H = 1024).  A
//    direction's R is 8 MB there: no cluster holds it, and a cluster that reads it from L2 every step spent
//    ~48 us a step.  Instead one cooperative launch puts a CTA on each of D * ceil(H / 16) SMs (128 at
//    LAS-large), and each CTA keeps the 64 gate columns of its 16 units resident in shared memory for the
//    whole sequence: [Hp x 64] bf16, 128 KB at H = 1024, loaded once by TMA from a gate-interleaved copy
//    (ops/rnn_sequence.py interleave_recurrent: column 32 g + 8 k + t of a CTA's slice is gate k of its unit
//    8 g + t; the GRU's fourth gate slot is zero), so the thread holding accumulator columns 8 j + 2 (lane %
//    4) + {0, 1} holds every gate of its two units and the cell update is the product's epilogue.  A step:
//    thread 0 waits until every CTA of the direction has published h(t-1) (an acquire load of the
//    direction's step counter), then streams h(t-1) [B x Hp] through a four-stage TMA ring of [64 rows x 64]
//    k-panels as wgmma's A operand (m64n64k16, two warpgroups of 64 rows: 128 batch rows a chunk, chunks in
//    turn), against the resident R panels as B; each k-panel goes into a fresh float32 accumulator whose sum
//    is added into the total in float32.  The epilogue adds x_proj (loaded before the chunk's product), applies
//    the gates, keeps h and c for the CTA's units in shared memory (both are on the compute type's grid, so bf16
//    holds them exactly), writes out[t] and the CTA's slice of h(t) into the other of two h buffers (by step
//    parity: a CTA writes h(t+1) only after every CTA of its direction has read all of h(t)), and publishes the
//    step with a release add on the counter.  h is written by st.global and read by TMA in other CTAs, so both
//    sides fence the async proxy.  The batch is walked in slices of rows whose state fits shared memory (all of
//    B = 128 at once).
//
// Rounding is the Pallas kernel's: z = x (float32) + h @ R in float32 (bf16 x
// bf16 products are exact in float32); the GRU's recurrent bias (already in
// the compute type) is added in float32; gates in float32; c_new is rounded
// to the compute type before tanh(c_new); h_new is rounded to the compute
// type.  At a masked step the state is frozen and the output is zero.  Route 1
// takes sigmoid and tanh from ex2.approx and the approximate divide (within a
// few float32 ulps; the accurate functions' branches held its gates ~1 us a
// step); routes 2 and 3 use sigmoidf / tanhf.
//
// What bounds it on the H100: the chain of T dependent steps.  Each step's product is small (LAS-small: 64 x 64
// x 256 a CTA; LAS-large: 16.8 MFLOP a CTA) and the step ends in an exchange of h, so the kernel runs at T x
// (product latency + gates + exchange), far above the bytes / operations bound of the launch.  On route 1 at
// LAS-small's width a step is ~3.2 us: ~1.1 us the exchange (15 bulk copies of 2 KB a CTA), ~0.6 the product,
// ~1.2 a step's fixed work with no exchange at all (PERF.md §6).  On the persistent route each CTA also
// reads all of h(t-1) from L2 every step (256 KB at B = 128, 32 MB over the 128 CTAs).
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace srt {

constexpr int RNN_CLUSTER = 8;    // CTAs per (direction, batch tile)
constexpr int RNN_ROWS = 16;      // batch rows of an m16n8k16 tile: a cluster's batch tile
constexpr int RNN_STRIP = 4;      // batch rows per thread in the FMA product
constexpr int RNN_THREADS = 256;
constexpr int RNN_WARPS = RNN_THREADS / 32;
// (row, unit) pairs per thread in the gate phase, and n-tiles of 8 columns per warp in the mma mode
// (G * U <= 8 tiles x 8 warps x 8 columns), of the narrow route (H <= 512) and the wide one (H <= 1024, float32)
constexpr int RNN_NARROW_PAIRS = 4, RNN_NARROW_TILES = 4;
constexpr int RNN_WIDE_PAIRS = 8, RNN_WIDE_TILES = 8;
constexpr int RNN_NARROW_UNITS = RNN_THREADS * RNN_NARROW_PAIRS / RNN_ROWS * RNN_CLUSTER;  // 512
constexpr int RNN_MAX_UNITS = RNN_THREADS * RNN_WIDE_PAIRS / RNN_ROWS * RNN_CLUSTER;       // 1024
constexpr int MODE_FMA_GLOBAL = 0, MODE_FMA_SMEM = 1, MODE_MMA = 2;
// the persistent route (= ops/rnn_sequence.py P_*): units a CTA owns, its gate columns (4 slots a unit),
// warpgroups (64 batch rows each) and ring stages of h's k-panels, two in flight
constexpr int RNN_P_UNITS = 16, RNN_P_COLS = 64, RNN_P_WGS = 2, RNN_P_STAGES = 4, RNN_P_IN_FLIGHT = 2;
constexpr int RNN_P_THREADS = 128 * RNN_P_WGS;
constexpr int RNN_P_ROWS = 64 * RNN_P_WGS;  // batch rows of a chunk

__device__ __forceinline__ void mma_bf16_16816(float* d, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// h's row stride in shared memory: MODE_MMA pads H to whole k-steps of 16, plus 8
// elements so the 8 rows of an A fragment fall on different banks
__host__ __device__ inline int rnn_h_stride(int H, int mode) { return mode == MODE_MMA ? (H + 15) / 16 * 16 + 8 : H; }

// Element i of CTA j's fragment-order slice of direction d's R (MODE_MMA: [NT][KS][32 lanes][4]): column
// n < NCj of the slice is gate n / Uj, unit lo + n % Uj
template <typename T>
__device__ __forceinline__ T rnn_frag_elem(const T* __restrict__ rk_d, int i, int KS, int H, int GH, int lo, int Uj,
                                           int NCj) {
  const int e = i & 3, ln = (i >> 2) & 31, ks = (i >> 7) % KS, nt = (i >> 7) / KS;
  const int k = ks * 16 + (ln & 3) * 2 + (e & 1) + (e >> 1) * 8, n = nt * 8 + (ln >> 2);
  const int g = n / max(Uj, 1), u = n - g * Uj;
  return (k < H && n < NCj) ? rk_d[(size_t)k * GH + g * H + lo + u] : from_f<T>(0.0f);
}

// x [T, D, B, G*H]; mask [T, D, B] (bool bytes); rk [D, H, G*H]; rb [D, G*H]
// (GRU); h0, c0 [D, B, H]; out [T, D, B, H]; h_last, c_last [D, B, H].
// Direction d runs its own time order: the caller has flipped the inputs.  PAIRS and TILES: the route's
// RNN_*_PAIRS and RNN_*_TILES.
template <typename T, bool GRU, int PAIRS, int TILES>
__global__ void __launch_bounds__(RNN_THREADS)
    rnn_sequence_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask, const T* __restrict__ rk,
                        const T* __restrict__ rb, const T* __restrict__ h0, const T* __restrict__ c0,
                        T* __restrict__ out, T* __restrict__ h_last, T* __restrict__ c_last, int steps, int D, int B,
                        int H, int mode) {
  constexpr int G = GRU ? 3 : 4;
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int ROWS = RNN_ROWS;  // batch rows of the cluster
  cg::cluster_group cluster = cg::this_cluster();
  const int j = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d = blockIdx.z;
  const int b0 = blockIdx.y * ROWS;
  const int U = (H + RNN_CLUSTER - 1) / RNN_CLUSTER;
  const int lo = j * U;
  const int Uj = max(0, min(H - lo, U));  // units this CTA owns (0 for a trailing CTA when H is small)
  const int NC = G * U;                   // row stride of zs and of the FMA modes' R
  const int NCj = G * Uj;                 // columns this CTA computes
  const int GH = G * H;
  const int HS = rnn_h_stride(H, mode);
  const int KS = (H + 15) / 16, NT = (NCj + 7) / 8;  // MODE_MMA: k-steps and n-tiles

  extern __shared__ __align__(16) unsigned char smem[];
  T* hbuf = reinterpret_cast<T*>(smem);                                       // [2][ROWS][HS]
  float* zs = reinterpret_cast<float*>(smem + 2 * ROWS * HS * sizeof(T));     // [ROWS][NC]
  float* cs = zs + ROWS * NC;                                                 // [ROWS][U]
  T* Rs = reinterpret_cast<T*>(cs + ROWS * U);  // FMA: [H][NC]; MMA: [NT][KS][32 lanes][4]

  // this CTA's columns of R: column n < NCj is gate n / Uj, unit lo + n % Uj
  const T* rk_d = rk + (size_t)d * H * GH;
  if (mode == MODE_MMA) {
    for (int i = tid; i < NT * KS * 128; i += RNN_THREADS) Rs[i] = rnn_frag_elem(rk_d, i, KS, H, GH, lo, Uj, NCj);
  } else if (mode == MODE_FMA_SMEM) {
    for (int i = tid; i < H * NCj; i += RNN_THREADS) {
      const int k = i / NCj, n = i - k * NCj, g = n / Uj, u = n - g * Uj;
      Rs[k * NC + g * U + u] = rk_d[(size_t)k * GH + g * H + lo + u];
    }
  }
  // FMA modes: element (k, g, u) of the slice at Rp[k * rs + g * gs + u]
  const T* Rp = mode == MODE_FMA_SMEM ? Rs : rk_d + lo;
  const int rs = mode == MODE_FMA_SMEM ? NC : GH, gs = mode == MODE_FMA_SMEM ? U : H;

  for (int i = tid; i < 2 * ROWS * HS; i += RNN_THREADS) {  // h0 in buffer 0; rows past B and the pad zero
    const int r = (i / HS) % ROWS, k = i % HS, b = b0 + r;
    hbuf[i] = (i < ROWS * HS && b < B && k < H) ? h0[((size_t)d * B + b) * H + k] : from_f<T>(0.0f);
  }
  if constexpr (!GRU) {
    for (int i = tid; i < ROWS * U; i += RNN_THREADS) {
      const int r = i / U, u = i - r * U, b = b0 + r;
      cs[i] = (b < B && u < Uj) ? to_f(c0[((size_t)d * B + b) * H + lo + u]) : 0.0f;
    }
  }
  T* remote[RNN_CLUSTER];
#pragma unroll
  for (int q = 0; q < RNN_CLUSTER; ++q) remote[q] = cluster.map_shared_rank(hbuf, q);

  const int n_pairs = ROWS * Uj;
  const int n_strips = (ROWS / RNN_STRIP) * NCj;
  const T* rb_d = GRU ? rb + (size_t)d * GH + lo : nullptr;

  // the inputs of all the thread's pairs at step t
  auto load_inputs = [&](int t, float (&xs)[PAIRS][G], bool (&ms)[PAIRS]) {
    const size_t row0 = ((size_t)t * D + d) * B;
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int p = tid + i * RNN_THREADS;
      ms[i] = false;
#pragma unroll
      for (int g = 0; g < G; ++g) xs[i][g] = 0.0f;
      if (p < n_pairs) {
        const int r = p / Uj, u = p - r * Uj, b = b0 + r;
        if (b < B) {
          const T* xp = x + (row0 + b) * GH + lo + u;
#pragma unroll
          for (int g = 0; g < G; ++g) xs[i][g] = to_f(xp[g * H]);
          ms[i] = mask[row0 + b] != 0;
        }
      }
    }
  };

  // one step on inputs xv / mv, with step t+1's loads issued into xn / mn first
  auto step = [&](int t, const float (&xv)[PAIRS][G], const bool (&mv)[PAIRS],
                  float (&xn)[PAIRS][G], bool (&mn)[PAIRS]) {
    const int cur = t & 1;
    const T* hc = hbuf + cur * ROWS * HS;
    const size_t row0 = ((size_t)t * D + d) * B;  // [T, D, B] row of batch row 0
    if (t + 1 < steps) load_inputs(t + 1, xn, mn);  // in flight until the next step's gates

    // the recurrent product: zs[r][g*U + u] = sum_k h[r][k] R[k][g][u]
    if constexpr (BF16) {
      if (mode == MODE_MMA && warp < NT) {
        float acc[TILES][4];
#pragma unroll
        for (int q = 0; q < TILES; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
        const uint2* Rf = reinterpret_cast<const uint2*>(Rs);
#pragma unroll 4
        for (int ks = 0; ks < KS; ++ks) {
          // the A fragment: rows lane / 4 and + 8, columns ks * 16 + 2 (lane % 4) (+ 1, + 8, + 9)
          const T* hA = hc + (lane >> 2) * HS + ks * 16 + (lane & 3) * 2;
          const uint32_t a0 = *reinterpret_cast<const uint32_t*>(hA);
          const uint32_t a1 = *reinterpret_cast<const uint32_t*>(hA + 8 * HS);
          const uint32_t a2 = *reinterpret_cast<const uint32_t*>(hA + 8);
          const uint32_t a3 = *reinterpret_cast<const uint32_t*>(hA + 8 * HS + 8);
#pragma unroll
          for (int q = 0; q < TILES; ++q) {
            const int nt = warp + q * RNN_WARPS;
            if (nt < NT) {
              const uint2 bf = Rf[(nt * KS + ks) * 32 + lane];
              mma_bf16_16816(acc[q], a0, a1, a2, a3, bf.x, bf.y);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < TILES; ++q) {
          const int nt = warp + q * RNN_WARPS;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = (lane >> 2) + (e >> 1) * 8, n = nt * 8 + (lane & 3) * 2 + (e & 1);
            if (nt < NT && n < NCj) {
              const int g = n / Uj;
              zs[r * NC + g * U + (n - g * Uj)] = acc[q][e];
            }
          }
        }
      }
    }
    if (mode == MODE_FMA_SMEM || mode == MODE_FMA_GLOBAL) {
      for (int s = tid; s < n_strips; s += RNN_THREADS) {
        const int rg = s / NCj, col = s - rg * NCj, g = col / Uj, u = col - g * Uj;
        const T* rp = Rp + g * gs + u;
        const T* hp = hc + rg * RNN_STRIP * HS;
        float acc[RNN_STRIP];
#pragma unroll
        for (int q = 0; q < RNN_STRIP; ++q) acc[q] = 0.0f;
#pragma unroll 4
        for (int k = 0; k < H; ++k) {
          const float w = to_f(rp[(size_t)k * rs]);
#pragma unroll
          for (int q = 0; q < RNN_STRIP; ++q) acc[q] = fmaf(to_f(hp[q * HS + k]), w, acc[q]);
        }
#pragma unroll
        for (int q = 0; q < RNN_STRIP; ++q) zs[(rg * RNN_STRIP + q) * NC + g * U + u] = acc[q];
      }
    }
    __syncthreads();

    // the gates of the thread's pairs; the new h goes to every CTA's next-h buffer
    const size_t nxt = (size_t)(cur ^ 1) * ROWS * HS;
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int p = tid + i * RNN_THREADS;
      if (p < n_pairs) {
        const int r = p / Uj, u = p - r * Uj, b = b0 + r;
        const float* zr = zs + r * NC + u;
        const float h_old = to_f(hc[r * HS + lo + u]);
        const float* xg = xv[i];
        const bool m = mv[i];
        float h_new, h_next;
        if constexpr (GRU) {
          const float rz = zr[0] + to_f(rb_d[u]);
          const float rr = zr[U] + to_f(rb_d[H + u]);
          const float rh = zr[2 * U] + to_f(rb_d[2 * H + u]);
          const float zg = sigmoidf(xg[0] + rz);
          const float rg = sigmoidf(xg[1] + rr);
          const float hh = tanhf(xg[2] + rg * rh);
          h_new = rnd<T>(zg * h_old + (1.0f - zg) * hh);
          h_next = m ? h_new : h_old;
          if (b < B && t == steps - 1) h_last[((size_t)d * B + b) * H + lo + u] = from_f<T>(h_next);
        } else {
          const float c_old = cs[r * U + u];
          const float ig = sigmoidf(xg[0] + zr[0]);
          const float fg = sigmoidf(xg[1] + zr[U]);
          const float gg = tanhf(xg[2] + zr[2 * U]);
          const float og = sigmoidf(xg[3] + zr[3 * U]);
          const float c_new = rnd<T>(fg * c_old + ig * gg);
          h_new = rnd<T>(og * tanhf(c_new));
          h_next = m ? h_new : h_old;
          const float c_next = m ? c_new : c_old;
          cs[r * U + u] = c_next;
          if (b < B && t == steps - 1) {
            h_last[((size_t)d * B + b) * H + lo + u] = from_f<T>(h_next);
            c_last[((size_t)d * B + b) * H + lo + u] = from_f<T>(c_next);
          }
        }
        if (b < B) out[(row0 + b) * H + lo + u] = from_f<T>(m ? h_new : 0.0f);
        const T hv = from_f<T>(h_next);
#pragma unroll
        for (int q = 0; q < RNN_CLUSTER; ++q) remote[q][nxt + r * HS + lo + u] = hv;
      }
    }
    cluster.sync();  // the new h is in every CTA, and every read of this step's buffers is done
  };

  // two register sets of inputs, so a step's loads are consumed only in the step after
  float xa[PAIRS][G], xb[PAIRS][G];
  bool ma[PAIRS], mb[PAIRS];
  load_inputs(0, xa, ma);
  cluster.sync();  // every CTA of the cluster has started and loaded its state before any remote store
  for (int t = 0; t < steps; t += 2) {
    step(t, xa, ma, xb, mb);
    if (t + 1 < steps) step(t + 1, xb, mb, xa, ma);
  }
}

// ---------------------------------------------------------------- the persistent route
namespace rp {

using namespace wg;  // PANEL, W_PANEL, WG_ROWS, ALIGN and the PTX helpers

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
// orders this thread's global accesses of the generic proxy (st / ld) with those of the async proxy (TMA)
__device__ __forceinline__ void fence_async_global() { asm volatile("fence.proxy.async.global;\n" ::: "memory"); }

// One launch's operands, bf16 unless stated.  Hp = H rounded up to 64-column panels.
struct Args {
  const Bf* x;             // [T, D, B, G*H]
  const uint8_t* mask;     // [T, D, B]
  const Bf* rb;            // [D, G*H] (GRU)
  const Bf* c0;            // [D, B, H] (LSTM)
  Bf* hbuf;                // [2, D, B, Hp]: h(t) in plane t % 2 (h0 in plane 0), columns past H zero
  unsigned* done;          // [D] steps published by the direction's CTAs, 0 at launch
  Bf *out, *h_last, *c_last;  // [T, D, B, H], [D, B, H], [D, B, H] (LSTM)
  int T, D, B, H, Hp, ctas, slice_rows;
};

// Dynamic shared memory (ops/rnn_sequence.py persistent_smem mirrors it): alignment slack, the resident R
// panels, the ring, and h and c of the CTA's 16 units for a slice of batch rows.
inline size_t smem_bytes(int Hp, int slice_rows) {
  return ALIGN + (size_t)(Hp / PANEL) * W_PANEL + (size_t)RNN_P_STAGES * RNN_P_WGS * W_PANEL +
         2 * sizeof(Bf) * (size_t)RNN_P_UNITS * slice_rows;
}

// Grid: D x ctas CTAs, all resident (a cooperative launch); CTA (d, j) owns units [16 j, 16 j + 16) of
// direction d.  rmap: the interleaved R [D Hp, 64 ctas] in [64 x 64] boxes; hmap: hbuf as [2 D][B][Hp].
template <bool GRU>
__global__ void __launch_bounds__(RNN_P_THREADS, 1)
    rnn_persistent_kernel(const __grid_constant__ CUtensorMap rmap, const __grid_constant__ CUtensorMap hmap,
                          const Args a) {
  constexpr int G = GRU ? 3 : 4, S = RNN_P_STAGES, DF = RNN_P_IN_FLIGHT, STAGE = RNN_P_WGS * W_PANEL;
  extern __shared__ uint8_t rp_smem[];
  __shared__ __align__(8) uint64_t rp_bars[S + 1];  // the ring's stages, then R's
  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31, q = lane & 3;
  const int d = blockIdx.x / a.ctas, j = blockIdx.x - d * a.ctas;
  const int H = a.H, B = a.B, D = a.D, Hp = a.Hp, GH = G * H, lo = j * RNN_P_UNITS, n_kp = Hp / PANEL;
  const uint32_t raw = smem_addr(rp_smem);
  const uint32_t base = (raw + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const uint32_t r_base = base, ring = base + n_kp * W_PANEL;
  const uint32_t bars = smem_addr(rp_bars), r_bar = bars + 8 * S;
  Bf* hs = reinterpret_cast<Bf*>(rp_smem + (ring - raw) + S * STAGE);  // [slice_rows][16]: h of the units
  Bf* cs = hs + (size_t)a.slice_rows * RNN_P_UNITS;                    // [slice_rows][16]: c (LSTM)

  if (tid == 0) {
    for (int s = 0; s <= S; ++s) mbar_init(bars + 8 * s, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {  // the CTA's R panels, resident for the whole launch
    mbar_expect_tx(r_bar, n_kp * W_PANEL);
    for (int k = 0; k < n_kp; ++k) tma_load_2d(r_base + k * W_PANEL, &rmap, j * RNN_P_COLS, d * Hp + k * PANEL, r_bar);
  }
  // the thread's units: 8 g + 2 q + x, g, x in {0, 1}; the GRU's recurrent bias of them
  float rbv[2][3][2] = {};
  if constexpr (GRU) {
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int u = lo + 8 * g + 2 * q + x;
          rbv[g][k][x] = u < H ? to_f(a.rb[(size_t)d * GH + k * H + u]) : 0.0f;
        }
  }
  mbar_wait(r_bar, 0);

  const unsigned short* xraw = reinterpret_cast<const unsigned short*>(a.x);
  int job0 = 0;        // ring jobs (k-panels of a chunk) of the launch before this step's
  unsigned epoch = 0;  // steps this CTA has published
  for (int s0 = 0; s0 < B; s0 += a.slice_rows) {
    const int ns = min(a.slice_rows, B - s0), n_chunks = (ns + RNN_P_ROWS - 1) / RNN_P_ROWS;
    const int n_jobs = n_chunks * n_kp;
    for (int i = tid; i < ns * RNN_P_UNITS; i += RNN_P_THREADS) {  // the slice's state: h0 (plane 0), c0
      const int r = i / RNN_P_UNITS, u = lo + i % RNN_P_UNITS, b = s0 + r;
      hs[i] = u < H ? a.hbuf[((size_t)d * B + b) * Hp + u] : from_f<Bf>(0.0f);
      cs[i] = !GRU && u < H ? a.c0[((size_t)d * B + b) * H + u] : from_f<Bf>(0.0f);
    }
    __syncthreads();
    for (int t = 0; t < a.T; ++t, ++epoch) {
      const int par = t & 1;
      // ring job i of this step: k-panel i % n_kp of chunk i / n_kp's two 64-row boxes into stage (job0 + i) % S
      auto issue = [&](int i) {
        if (i < n_jobs && tid == 0) {
          const int g = job0 + i, ch = i / n_kp, k = i - ch * n_kp;
          const uint32_t dst = ring + (g % S) * STAGE, bar = bars + (g % S) * 8;
          mbar_expect_tx(bar, STAGE);
          for (int w = 0; w < RNN_P_WGS; ++w)
            tma_load_3d(dst + w * W_PANEL, &hmap, k * PANEL, s0 + ch * RNN_P_ROWS + w * WG_ROWS, par * D + d, bar);
        }
      };
      const size_t xrow0 = ((size_t)t * D + d) * B;
      for (int ch = 0; ch < n_chunks; ++ch) {
        // the thread's rows (16 warp + lane / 4 + 8 hf of its warpgroup) and their inputs, loaded before the
        // product: x[hf][g][k] packs units 8 g + 2 q + {0, 1} of gate k
        int rows[2];
        bool live[2], m[2];
        uint32_t xw[2][2][4] = {};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = s0 + ch * RNN_P_ROWS + wgi * WG_ROWS + 16 * warp + (lane >> 2) + 8 * hf;
          rows[hf] = r;
          live[hf] = r < s0 + ns;
          m[hf] = live[hf] && a.mask[xrow0 + r] != 0;
          if (live[hf]) {
            const unsigned short* xr = xraw + (xrow0 + r) * GH;
#pragma unroll
            for (int g = 0; g < 2; ++g)
#pragma unroll
              for (int k = 0; k < G; ++k) {
                const int u = lo + 8 * g + 2 * q;
                const uint32_t v0 = u < H ? xr[k * H + u] : 0u, v1 = u + 1 < H ? xr[k * H + u + 1] : 0u;
                xw[hf][g][k] = v0 | v1 << 16;
              }
          }
        }
        if (ch == 0) {  // h(t - 1) is complete once every CTA of the direction has published step t - 1
          if (tid == 0) {
            const unsigned target = epoch * (unsigned)a.ctas;
            for (uint32_t n = 0; ld_acquire(a.done + d) < target; ++n)
              if (n > (1u << 26)) __trap();  // a CTA that never publishes ends the launch, not a hang
            fence_async_global();  // the acquired h, written by st.global, before TMA reads it
          }
          for (int i = 0; i < DF; ++i) issue(i);
        }

        // the chunk's product: k-panel k into a fresh accumulator (za, zb in turns), its sum added into z
        float z[32], za[32], zb[32];
#pragma unroll
        for (int c = 0; c < 32; ++c) z[c] = za[c] = zb[c] = 0.0f;
        auto panel = [&](float (&acc)[32], int k) {
          const int i = ch * n_kp + k, g = job0 + i;
          mbar_wait(bars + (g % S) * 8, (g / S) & 1);
          __syncthreads();  // both warpgroups are done with job i - 2, whose stage the next issue refills
          issue(i + DF);
          const uint32_t st = ring + (g % S) * STAGE;
          wg_arrive();
#pragma unroll
          for (int s = 0; s < 4; ++s)
            mma_ss<0, 1>(acc, kmajor(st + wgi * W_PANEL + 32 * s), mnmajor(r_base + k * W_PANEL + 2048 * s, W_PANEL),
                         s);
          wg_commit();
        };
        auto add = [&](float (&acc)[32]) {
          reg_fence(acc);
#pragma unroll
          for (int c = 0; c < 32; ++c) z[c] += acc[c];
        };
        int k = 0;
        for (; k + 1 < n_kp; k += 2) {
          panel(za, k);
          wg_wait<1>();
          add(zb);
          panel(zb, k + 1);
          wg_wait<1>();
          add(za);
        }
        if (k < n_kp) {
          panel(za, k);
          wg_wait<1>();
          add(zb);
          wg_wait<0>();
          add(za);
        } else {
          wg_wait<0>();
          add(zb);
        }

        // the epilogue: z[4 (4 g + k) + 2 hf + x] is gate k of unit 8 g + 2 q + x, row rows[hf]
        Bf* hnext = a.hbuf + ((size_t)(par ^ 1) * D + d) * B * Hp;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (!live[hf]) continue;
          const int r = rows[hf], lr = r - s0;
          const size_t orow = (xrow0 + r) * H, srow = ((size_t)d * B + r) * H;
#pragma unroll
          for (int g = 0; g < 2; ++g)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int ul = 8 * g + 2 * q + x, u = lo + ul;
              if (u >= H) continue;
              float xg[4];
#pragma unroll
              for (int k = 0; k < 4; ++k)
                xg[k] = k < G ? __uint_as_float(((xw[hf][g][k] >> (16 * x)) & 0xffffu) << 16) : 0.0f;
              const int zc = 16 * g + 2 * hf + x;  // gate k at z[zc + 4 k]
              const float z0 = z[zc], z1 = z[zc + 4], z2 = z[zc + 8], z3 = z[zc + 12];
              const float h_old = to_f(hs[lr * RNN_P_UNITS + ul]);
              float h_new, h_next;
              if constexpr (GRU) {
                const float zg = sigmoidf(xg[0] + (z0 + rbv[g][0][x]));
                const float rg = sigmoidf(xg[1] + (z1 + rbv[g][1][x]));
                const float hh = tanhf(xg[2] + rg * (z2 + rbv[g][2][x]));
                h_new = bf16_grid(zg * h_old + (1.0f - zg) * hh);
                h_next = m[hf] ? h_new : h_old;
              } else {
                const float c_old = to_f(cs[lr * RNN_P_UNITS + ul]);
                const float ig = sigmoidf(xg[0] + z0), fg = sigmoidf(xg[1] + z1);
                const float gg = tanhf(xg[2] + z2), og = sigmoidf(xg[3] + z3);
                const float c_new = bf16_grid(fg * c_old + ig * gg);
                h_new = bf16_grid(og * tanhf(c_new));
                h_next = m[hf] ? h_new : h_old;
                const float c_next = m[hf] ? c_new : c_old;
                cs[lr * RNN_P_UNITS + ul] = from_f<Bf>(c_next);
                if (t == a.T - 1) a.c_last[srow + u] = from_f<Bf>(c_next);
              }
              const Bf hv = from_f<Bf>(h_next);
              hs[lr * RNN_P_UNITS + ul] = hv;
              hnext[(size_t)r * Hp + u] = hv;
              a.out[orow + u] = from_f<Bf>(m[hf] ? h_new : 0.0f);
              if (t == a.T - 1) a.h_last[srow + u] = hv;
            }
        }
      }
      // publish h(t): every thread's stores, then one release add for the CTA
      fence_async_global();
      __syncthreads();
      if (tid == 0) red_release(a.done + d, 1u);
      job0 += n_jobs;
    }
  }
}

template <bool GRU>
cudaError_t launch(const void* rk_il, const Args& a, cudaStream_t stream) {
  const int n_kp = a.Hp / PANEL;
  if (a.T < 1 || a.D < 1 || a.B < 1 || a.H <= RNN_NARROW_UNITS || a.H > RNN_MAX_UNITS || a.Hp % PANEL ||
      a.Hp < a.H || a.ctas != (a.H + RNN_P_UNITS - 1) / RNN_P_UNITS || a.slice_rows < 1 ||
      a.slice_rows % RNN_P_ROWS || n_kp < 1)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.Hp, a.slice_rows);
  int dev = 0, max_smem = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  if (!coop) return cudaErrorNotSupported;
  CUtensorMap rmap, hmap;
  if ((err = panel_map(&rmap, rk_il, a.D * a.Hp, a.ctas * RNN_P_COLS)) != cudaSuccess) return err;
  if ((err = batched_panel_map(&hmap, a.hbuf, 2 * a.D, a.B, a.Hp)) != cudaSuccess) return err;
  auto kernel = rnn_persistent_kernel<GRU>;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) != cudaSuccess)
    return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(a.D * a.ctas);
  config.blockDim = dim3(RNN_P_THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;  // refused, not hung, when the CTAs cannot all be resident
  attr[0].val.cooperative = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, rmap, hmap, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace rp

// ---------------------------------------------------------------- the cluster tensor-core route
namespace rc {

using namespace wg;  // Bf, the PTX helpers

constexpr int RC_ROWS = 64;  // batch rows of a cluster: the wgmma M
constexpr int RC_MAX_CLUSTER = 16, RC_MAX_STAGES = 4;
constexpr int RC_MAX_PANELS = 6;  // 64-deep k-panels of the product at most: K <= 384
constexpr int RC_CORE = 128;  // bytes of a core matrix: 8 rows x 8 bf16
constexpr int RC_MASK_SLOT = 128;  // bytes of a ring stage's mask row (64 used; TMA destinations 128-byte aligned)

// The operands' layout in shared memory (wgmma's K-major layout without swizzle): [K / 8][rows / 8] core
// matrices of [8 rows x 8 k] bf16, 128 contiguous bytes each; a k-step of 16 is two core matrices along K.
// lbo: bytes from one core matrix to the next along K; the 8-row groups are 128 bytes apart.
__device__ __forceinline__ uint64_t kdesc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 | (uint64_t)(RC_CORE >> 4) << 32;
}

#define RC_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define RC_OUT16(d)                                                                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),        \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// d[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B K-major from shared memory: a warpgroup's 8 units, 4 gates each
__device__ __forceinline__ void mma_n32(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " RC_D16 ", %16, %17, p, 1, 1, 0, 0;\n}\n"
               : RC_OUT16(d)
               : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// ``bytes`` of this CTA's shared memory at src into another CTA's at dst (a shared::cluster address), completing
// on that CTA's mbarrier at bar (also a shared::cluster address)
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, uint32_t src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   dst),
               "r"(src), "r"(bytes), "r"(bar)
               : "memory");
}
// waits for phase ``parity`` of an mbarrier; one that never completes (a slice or a tile that never lands) ends the
// kernel with a trap after ~2 s of the SM's clock, not a hang
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 32)) __trap();
}
// The gates' sigmoid and tanh without branches, from ex2.approx (__expf) and the approximate divide: within a few
// float32 ulps of sigmoidf / tanhf where it matters for a bf16 h (tanh: within ~1e-7 absolute near 0), and the
// four (row, unit) pairs of a thread interleave instead of running one after another through the accurate
// functions' branches (sigmoidf / tanhf took ~0.6-0.7 us more of a step, PERF.md §6)
__device__ __forceinline__ float fast_sigmoid(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }
__device__ __forceinline__ float fast_tanh(float x) {
  const float e = __expf(-2.0f * fabsf(x));
  return copysignf(__fdividef(1.0f - e, 1.0f + e), x);
}

struct Args {
  const Bf* rk;            // [D, H, G*H]
  const Bf* rb;            // [D, G*H] (GRU)
  const Bf* h0;            // [D, B, H]
  const Bf* c0;            // [D, B, H] (LSTM)
  Bf *out, *h_last, *c_last;  // [T, D, B, H], [D, B, H], [D, B, H] (LSTM)
  int T, D, B, H, Hg, C, Kp, stages;  // Hg: x_proj's gate pitch, H rounded up to 8; Kp: C U rounded up to 16
};

// Dynamic shared memory (ops/rnn_sequence.py cluster_tc_smem mirrors it): alignment slack, R's slice [Kp x 4U],
// two planes of h [64 x Kp], and the ring of x_proj tiles [G][64][U] and mask rows.
inline size_t smem_bytes(int G, int U, int Kp, int stages) {
  return RC_CORE + (size_t)Kp * 4 * U * 2 + (size_t)2 * Kp * RC_ROWS * 2 +
         (size_t)stages * ((size_t)G * RC_ROWS * U * 2 + RC_MASK_SLOT);
}

// Grid: (C, ceil(B / 64), D), clusters of C CTAs along x.  CTA j of a cluster owns units [j U, j U + U) of
// direction blockIdx.z for 64 batch rows, with U / 8 warpgroups: warpgroup w computes the 32 gate columns of units
// j U + 8 w + [0, 8) for all 64 rows (m64n32k16), so a thread's epilogue is 2 rows x 2 units.  xmap: x_proj as
// [T D][B][G Hg] in [1 x 64 x U] boxes (gate k of unit u in column k Hg + u: a box starts on 16 bytes, which TMA
// needs); mmap: the mask as [T D][Bm] bytes in 64-byte boxes.
template <bool GRU, int U>
__global__ void __launch_bounds__(16 * U, 1)
    rnn_cluster_tc_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap mmap,
                          const Args a) {
  constexpr int G = GRU ? 3 : 4, N = 4 * U, THREADS = 16 * U;
  constexpr uint32_t X_STAGE = G * RC_ROWS * U * 2, SLICE = RC_ROWS * U * 2;
  extern __shared__ uint8_t rc_smem[];
  __shared__ __align__(8) uint64_t rc_bars[2 + RC_MAX_STAGES];  // the two h planes' slices, the x ring's stages
  cg::cluster_group cluster = cg::this_cluster();
  const int j = (int)cluster.block_rank();
  const int tid = threadIdx.x, w = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, q = lane & 3;
  const int d = blockIdx.z, H = a.H, B = a.B, T = a.T, C = a.C, Kp = a.Kp, S = a.stages, GH = G * H;
  const int lo = j * U, KS = Kp / 16, b0 = blockIdx.y * RC_ROWS;
  const int ul = 8 * w + 2 * q, u = lo + ul;  // the thread's units u, u + 1 (of the CTA: ul, ul + 1)
  const uint32_t raw = smem_addr(rc_smem), base = (raw + RC_CORE - 1) & ~(uint32_t)(RC_CORE - 1);
  const uint32_t bs = base;                          // R: [Kp / 8][N / 8] cores
  const uint32_t planes = bs + Kp * N * 2;           // [2][Kp / 8][8] cores
  const uint32_t xring = planes + 2 * Kp * RC_ROWS * 2;  // [S][G][64][U]
  const uint32_t mring = xring + S * X_STAGE;        // [S][128 bytes]
  const uint8_t* gen = rc_smem + (base - raw);       // the same bytes, generic pointer
  auto plane = [&](int P) { return planes + P * Kp * RC_ROWS * 2; };
  const uint32_t full0 = smem_addr(&rc_bars[0]), xbar0 = smem_addr(&rc_bars[2]);
  const uint32_t in_bytes = (C - 1) * SLICE;  // the other CTAs' slices of one h
  const bool xchg = C > 1;                     // a cluster of one CTA has no other slices to wait for

  // R's slice, resident for the whole launch, gate-interleaved as ops/las_step.py gate_columns lays out a cell:
  // column 32 g + 8 k + t is gate k of unit lo + 8 g + t (zero for the GRU's slot 3, units past H and rows past
  // H), so the thread holding accumulator columns 8 i + 2 q + {0, 1} of warpgroup g holds every gate of its units
  const Bf* rk_d = a.rk + (size_t)d * H * GH;
  for (int e = tid; e < (Kp / 8) * N; e += THREADS) {
    const int kc = e / N, n = e - kc * N, k = (n >> 3) & 3, un = lo + 8 * (n >> 5) + (n & 7);
    const bool ok = k < G && un < H;
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r0 = 8 * kc + 2 * i;
      const uint32_t lo16 = ok && r0 < H ? __bfloat16_as_ushort(rk_d[(size_t)r0 * GH + k * H + un]) : 0u;
      const uint32_t hi16 = ok && r0 + 1 < H ? __bfloat16_as_ushort(rk_d[(size_t)(r0 + 1) * GH + k * H + un]) : 0u;
      v[i] = lo16 | hi16 << 16;
    }
    st_shared_v4(bs + (kc * (N / 8) + (n >> 3)) * RC_CORE + (n & 7) * 16, v[0], v[1], v[2], v[3]);
  }
  // h0 in plane 0 (every unit of the rows, zero past H and B), plane 1 zero
  const Bf* h0_d = a.h0 + (size_t)d * B * H;
  for (int e = tid; e < (Kp / 8) * RC_ROWS; e += THREADS) {
    const int kc = e / RC_ROWS, r = e - kc * RC_ROWS, b = b0 + r;
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k0 = 8 * kc + 2 * i;
      const uint32_t lo16 = b < B && k0 < H ? __bfloat16_as_ushort(h0_d[(size_t)b * H + k0]) : 0u;
      const uint32_t hi16 = b < B && k0 + 1 < H ? __bfloat16_as_ushort(h0_d[(size_t)b * H + k0 + 1]) : 0u;
      v[i] = lo16 | hi16 << 16;
    }
    const uint32_t off = (kc * 8 + (r >> 3)) * RC_CORE + (r & 7) * 16;
    st_shared_v4(plane(0) + off, v[0], v[1], v[2], v[3]);
    st_shared_v4(plane(1) + off, 0u, 0u, 0u, 0u);
  }
  // the thread's state: rows rw[hf], units u + x
  int rw[2];
  float hs[2][2], cs[2][2], rbv[3][2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    rw[hf] = 16 * warp + (lane >> 2) + 8 * hf;
    const int b = b0 + rw[hf];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const bool ok = b < B && u + x < H;
      hs[hf][x] = ok ? to_f(h0_d[(size_t)b * H + u + x]) : 0.0f;
      cs[hf][x] = !GRU && ok ? to_f(a.c0[((size_t)d * B + b) * H + u + x]) : 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int x = 0; x < 2; ++x) rbv[k][x] = GRU && u + x < H ? to_f(a.rb[(size_t)d * GH + k * H + u + x]) : 0.0f;
  fence_async_smem();  // R and the planes, written by st.shared, before the tensor cores and bulk copies use them

  // step tt's x_proj tiles and mask row into ring stage tt % S
  auto stage_inputs = [&](int tt) {
    const int s = tt % S;
    const uint32_t bar = xbar0 + 8 * s, dst = xring + s * X_STAGE;
    mbar_expect_tx(bar, X_STAGE + RC_ROWS);
    for (int k = 0; k < G; ++k) tma_load_3d(dst + k * RC_ROWS * U * 2, &xmap, k * a.Hg + lo, b0, tt * a.D + d, bar);
    tma_load_2d(mring + s * RC_MASK_SLOT, &mmap, b0, tt * a.D + d, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < 2 + S; ++i) mbar_init(full0 + 8 * i, 1);
    fence_mbar_init();
    // h(0) lands in plane 1 and h(1) in plane 0; a CTA sends h(t) only for t <= T - 2
    if (xchg && T >= 2) mbar_expect_tx(full0 + 8, in_bytes);
    if (xchg && T >= 3) mbar_expect_tx(full0, in_bytes);
    for (int tt = 0; tt < S && tt < T; ++tt) stage_inputs(tt);
  }
  cluster.sync();  // every CTA of the cluster has its barriers and planes ready before any copy reaches them

  const uint32_t bw = bs + w * 4 * RC_CORE;  // the warpgroup's 32 columns: 4 of the N / 8 column groups
  for (int t = 0; t < T; ++t) {
    const int P = t & 1;
    if (xchg && t >= 1) {
      // h(t - 1): the other CTAs' slices in plane P.  A CTA sends h(t - 1) only after its own product of step
      // t - 1, which read plane P ^ 1, so this wait also tells that plane P ^ 1 may be written again
      wait_phase(full0 + 8 * P, ((t - 1) >> 1) & 1);
      if (tid == 0 && t + 1 <= T - 2) mbar_expect_tx(full0 + 8 * P, in_bytes);  // h(t + 1), plane P again
    }

    // z = h(t-1) @ R: every 64-deep k-panel into its own accumulator, all issued before one wait, their sums
    // added into z in panel order in float32
    float z[16], acc[RC_MAX_PANELS][16];
    const uint32_t ap = plane(P);
    wg_arrive();
#pragma unroll
    for (int p = 0; p < RC_MAX_PANELS; ++p)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        if (4 * p + s < KS)
          mma_n32(acc[p], kdesc(ap + (4 * p + s) * 2 * RC_CORE * 8, RC_CORE * 8),
                  kdesc(bw + (4 * p + s) * 2 * 16 * N, 16 * N), s);
    wg_commit();
    // the stage step t - 1 read takes step t - 1 + S, while the tensor cores work: every thread passed step
    // t - 1's __syncthreads after its reads
    if (tid == 0 && t >= 1 && t - 1 + S < T) stage_inputs(t - 1 + S);
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < 16; ++c) z[c] = 0.0f;
#pragma unroll
    for (int p = 0; p < RC_MAX_PANELS; ++p) {
      reg_fence(acc[p]);
      if (4 * p < KS) {
#pragma unroll
        for (int c = 0; c < 16; ++c) z[c] += acc[p][c];
      }
    }

    // the epilogue: z[4 k + 2 hf + x] is gate k of unit u + x, row rw[hf]
    const int st = t % S;
    wait_phase(xbar0 + 8 * st, (t / S) & 1);
    const uint8_t* xs = gen + (xring - base) + st * X_STAGE;
    const uint8_t* ms = gen + (mring - base) + st * RC_MASK_SLOT;
    const bool send = t <= T - 2, last = t == T - 1;
    const uint32_t np = plane(P ^ 1);
    const size_t orow0 = ((size_t)t * a.D + d) * B;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = rw[hf], b = b0 + r;
      const bool m = ms[r] != 0;
      uint32_t xw[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        xw[k] = k < G ? *reinterpret_cast<const uint32_t*>(xs + ((k * RC_ROWS + r) * U + ul) * 2) : 0u;
      float hn[2], on[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        float xg[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) xg[k] = __uint_as_float(x ? xw[k] & 0xffff0000u : xw[k] << 16);
        const int zc = 2 * hf + x;
        const float z0 = z[zc], z1 = z[zc + 4], z2 = z[zc + 8], z3 = z[zc + 12];
        const float h_old = hs[hf][x];
        float h_new;
        if constexpr (GRU) {
          const float zg = fast_sigmoid(xg[0] + (z0 + rbv[0][x]));
          const float rg = fast_sigmoid(xg[1] + (z1 + rbv[1][x]));
          const float hh = fast_tanh(xg[2] + rg * (z2 + rbv[2][x]));
          h_new = bf16_grid(zg * h_old + (1.0f - zg) * hh);
        } else {
          const float c_old = cs[hf][x];
          const float ig = fast_sigmoid(xg[0] + z0), fg = fast_sigmoid(xg[1] + z1);
          const float gg = fast_tanh(xg[2] + z2), og = fast_sigmoid(xg[3] + z3);
          const float c_new = bf16_grid(fg * c_old + ig * gg);
          h_new = bf16_grid(og * fast_tanh(c_new));
          cs[hf][x] = m ? c_new : c_old;
        }
        const bool ok = u + x < H;  // units past H keep h = 0: their columns of h(t) are zero for every reader
        hs[hf][x] = ok ? (m ? h_new : h_old) : 0.0f;
        hn[x] = hs[hf][x];
        on[x] = m ? h_new : 0.0f;
      }
      if (b < B) {  // out[t], and at the last step h_last / c_last: plain stores no barrier waits for
        const size_t orow = (orow0 + b) * H, srow = ((size_t)d * B + b) * H;
        if ((H & 1) == 0 && u + 1 < H) {
          *reinterpret_cast<uint32_t*>(a.out + orow + u) = pack_bf16(on[0], on[1]);
          if (last) {
            *reinterpret_cast<uint32_t*>(a.h_last + srow + u) = pack_bf16(hn[0], hn[1]);
            if (!GRU) *reinterpret_cast<uint32_t*>(a.c_last + srow + u) = pack_bf16(cs[hf][0], cs[hf][1]);
          }
        } else {
#pragma unroll
          for (int x = 0; x < 2; ++x)
            if (u + x < H) {
              a.out[orow + u + x] = from_f<Bf>(on[x]);
              if (last) {
                a.h_last[srow + u + x] = from_f<Bf>(hn[x]);
                if (!GRU) a.c_last[srow + u + x] = from_f<Bf>(cs[hf][x]);
              }
            }
        }
      }
      if (send) {  // the CTA's slice of h(t) in its own plane P ^ 1
        const uint32_t off = ((u >> 3) * 8 + (r >> 3)) * RC_CORE + (r & 7) * 16 + (u & 7) * 2;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(np + off), "r"(pack_bf16(hn[0], hn[1])) : "memory");
      }
    }
    if (send) {
      fence_async_smem();  // the slice, written by st.shared, before the bulk copies and wgmma read it
      __syncthreads();     // the slice is whole, and every read of this step's ring stage is done
      if (tid < C && tid != j) {  // thread i sends the slice to CTA i
        const uint32_t src = np + (lo / 8) * 8 * RC_CORE;
        bulk_to_peer(mapa(src, tid), src, SLICE, mapa(full0 + 8 * (P ^ 1), tid));
      }
    }
  }
  cluster.sync();  // no CTA leaves while a copy from or to its shared memory may be in flight
}

template <bool GRU, int U>
cudaError_t launch(const void* x, const void* mask, int mask_pitch, const Args& a, cudaStream_t stream) {
  constexpr int G = GRU ? 3 : 4;
  const int pitch = G * a.Hg;
  if (a.T < 1 || a.D < 1 || a.B < 1 || a.H < 1 || a.C < 1 || a.C > RC_MAX_CLUSTER || (a.C - 1) * U >= a.H ||
      a.C * U < a.H || a.Kp != (a.C * U + 15) / 16 * 16 || a.Kp > 64 * RC_MAX_PANELS || a.stages < 1 ||
      a.stages > RC_MAX_STAGES || a.Hg < a.H || a.Hg % 8 || mask_pitch < a.B || mask_pitch % 16 ||
      (reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(mask) & 15))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(G, U, a.Kp, a.stages);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  TensorMapEncode encode;
  if ((err = tensor_map_encoder(&encode)) != cudaSuccess) return err;
  CUtensorMap xmap, mmap;
  {
    const cuuint64_t dims[3] = {(cuuint64_t)pitch, (cuuint64_t)a.B, (cuuint64_t)a.T * a.D};
    const cuuint64_t strides[2] = {(cuuint64_t)pitch * 2, (cuuint64_t)pitch * 2 * a.B};
    const cuuint32_t box[3] = {U, RC_ROWS, 1}, step[3] = {1, 1, 1};
    if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box, step,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)mask_pitch, (cuuint64_t)a.T * a.D};
    const cuuint64_t strides[1] = {(cuuint64_t)mask_pitch};
    const cuuint32_t box[2] = {RC_ROWS, 1}, step[2] = {1, 1};
    if (encode(&mmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(mask), dims, strides, box, step,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  auto kernel = rnn_cluster_tc_kernel<GRU, U>;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) != cudaSuccess)
    return err;
  if (a.C > 8 && (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) != cudaSuccess)
    return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(a.C, (a.B + RC_ROWS - 1) / RC_ROWS, a.D);
  config.blockDim = dim3(16 * U);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;  // a cluster whose CTAs cannot all be resident together would never pass its barriers
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config)) != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&config, kernel, xmap, mmap, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace rc

template <typename T, bool GRU>
cudaError_t launch_rnn_sequence(const void* x, const void* mask, const void* rk, const void* rb, const void* h0,
                                const void* c0, void* out, void* h_last, void* c_last, int steps, int D, int B, int H,
                                cudaStream_t stream) {
  constexpr int G = GRU ? 3 : 4;
  if (steps < 1 || D < 1 || B < 1 || H < 1 || H > RNN_MAX_UNITS) return cudaErrorInvalidValue;
  const bool wide = H > RNN_NARROW_UNITS;
  if (wide && sizeof(T) == 2) return cudaErrorInvalidValue;  // bf16 above 512: the persistent route
  const int rows = RNN_ROWS;  // batch rows of a cluster
  const int U = (H + RNN_CLUSTER - 1) / RNN_CLUSTER;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  auto smem_bytes = [&](int mode) {
    const size_t r_bytes = mode == MODE_MMA ? (size_t)(G * U + 7) / 8 * 8 * ((H + 15) / 16 * 16) * sizeof(T)
                           : mode == MODE_FMA_SMEM ? (size_t)H * G * U * sizeof(T)
                                                   : 0;
    return 2 * rows * rnn_h_stride(H, mode) * sizeof(T) + (size_t)rows * G * U * 4 + (size_t)rows * U * 4 + r_bytes;
  };
  int mode = wide ? MODE_FMA_GLOBAL : sizeof(T) == 2 ? MODE_MMA : MODE_FMA_SMEM;
  if (smem_bytes(mode) > (size_t)max_smem) mode = MODE_FMA_GLOBAL;
  const size_t smem = smem_bytes(mode);
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  auto kernel = rnn_sequence_kernel<T, GRU, RNN_NARROW_PAIRS, RNN_NARROW_TILES>;
  if constexpr (sizeof(T) == 4) {  // the wide cluster route is float32's only
    if (wide) kernel = rnn_sequence_kernel<T, GRU, RNN_WIDE_PAIRS, RNN_WIDE_TILES>;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(RNN_CLUSTER, (B + rows - 1) / rows, D);
  config.blockDim = dim3(RNN_THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = RNN_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  // a cluster whose CTAs cannot all be resident together would never pass its barrier
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
                           static_cast<const T*>(rk), static_cast<const T*>(rb), static_cast<const T*>(h0),
                           static_cast<const T*>(c0), static_cast<T*>(out), static_cast<T*>(h_last),
                           static_cast<T*>(c_last), steps, D, B, H, mode);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace srt

extern "C" {

// The cluster route.  is_gru: 0 LSTM (c0 / c_last used, rb unused), 1 GRU (rb [D, G*H] used, c0 / c_last
// unused).  Shapes as rnn_sequence_kernel's; T >= 1, 1 <= H <= 1024, and H <= 512 in bf16.
int rnn_sequence(int dtype_bf16, int is_gru, const void* x, const void* mask, const void* rk, const void* rb,
                 const void* h0, const void* c0, void* out, void* h_last, void* c_last, int T, int D, int B, int H,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_bf16 && is_gru)
    err = srt::launch_rnn_sequence<__nv_bfloat16, true>(x, mask, rk, rb, h0, c0, out, h_last, c_last, T, D, B, H, st);
  else if (dtype_bf16)
    err = srt::launch_rnn_sequence<__nv_bfloat16, false>(x, mask, rk, rb, h0, c0, out, h_last, c_last, T, D, B, H, st);
  else if (is_gru)
    err = srt::launch_rnn_sequence<float, true>(x, mask, rk, rb, h0, c0, out, h_last, c_last, T, D, B, H, st);
  else
    err = srt::launch_rnn_sequence<float, false>(x, mask, rk, rb, h0, c0, out, h_last, c_last, T, D, B, H, st);
  return static_cast<int>(err);
}

// The persistent route (bf16, 512 < H <= 1024; ops/rnn_sequence.py rnn_plan): x [T, D, B, G*H], mask [T, D, B],
// rk_il the gate-interleaved R [D, Hp, 64 ctas] (interleave_recurrent), rb [D, G*H] (GRU), c0 [D, B, H] (LSTM),
// hbuf [2, D, B, Hp] with h0 in plane 0 and zeros past H, done [D] zeros; out [T, D, B, H], h_last, c_last
// [D, B, H].  Fails (cudaErrorCooperativeLaunchTooLarge) when the D * ctas CTAs cannot all be resident.
int rnn_sequence_persistent(int is_gru, const void* x, const void* mask, const void* rk_il, const void* rb,
                            const void* c0, void* hbuf, void* done, void* out, void* h_last, void* c_last, int T,
                            int D, int B, int H, int ctas, int slice_rows, void* stream) {
  srt::rp::Args a{};
  a.x = static_cast<const srt::wg::Bf*>(x);
  a.mask = static_cast<const uint8_t*>(mask);
  a.rb = static_cast<const srt::wg::Bf*>(rb);
  a.c0 = static_cast<const srt::wg::Bf*>(c0);
  a.hbuf = static_cast<srt::wg::Bf*>(hbuf);
  a.done = static_cast<unsigned*>(done);
  a.out = static_cast<srt::wg::Bf*>(out);
  a.h_last = static_cast<srt::wg::Bf*>(h_last);
  a.c_last = static_cast<srt::wg::Bf*>(c_last);
  a.T = T;
  a.D = D;
  a.B = B;
  a.H = H;
  a.Hp = (H + srt::wg::PANEL - 1) / srt::wg::PANEL * srt::wg::PANEL;
  a.ctas = ctas;
  a.slice_rows = slice_rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_gru ? srt::rp::launch<true>(rk_il, a, st) : srt::rp::launch<false>(rk_il, a, st);
  return static_cast<int>(err);
}

// The cluster tensor-core route (bf16, H up to what fits shared memory; ops/rnn_sequence.py rnn_plan): x
// [T, D, B, G, Hg] (Hg: H rounded up to 8, the columns past H of each gate unread), mask [T, D, Bm] bytes
// (mask_pitch = Bm >= B, a multiple of 16; zero past B), rk [D, H, G*H], rb [D, G*H] (GRU), h0 and c0 (LSTM)
// [D, B, H]; out [T, D, B, H], h_last, c_last [D, B, H].  units (8, 16 or 24) a CTA, one warpgroup for each 8;
// cluster CTAs (cluster x units >= H, the product's K = cluster x units rounded up to 16, at most 384); stages of
// the x_proj ring.
int rnn_sequence_cluster_tc(int is_gru, const void* x, const void* mask, int mask_pitch, const void* rk,
                            const void* rb, const void* h0, const void* c0, void* out, void* h_last, void* c_last,
                            int T, int D, int B, int H, int units, int cluster, int stages, void* stream) {
  srt::rc::Args a{};
  a.rk = static_cast<const srt::wg::Bf*>(rk);
  a.rb = static_cast<const srt::wg::Bf*>(rb);
  a.h0 = static_cast<const srt::wg::Bf*>(h0);
  a.c0 = static_cast<const srt::wg::Bf*>(c0);
  a.out = static_cast<srt::wg::Bf*>(out);
  a.h_last = static_cast<srt::wg::Bf*>(h_last);
  a.c_last = static_cast<srt::wg::Bf*>(c_last);
  a.T = T;
  a.D = D;
  a.B = B;
  a.H = H;
  a.Hg = (H + 7) / 8 * 8;
  a.C = cluster;
  a.Kp = (cluster * units + 15) / 16 * 16;
  a.stages = stages;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define RC_LAUNCH(U)                                                                                        \
  case U:                                                                                                   \
    err = is_gru ? srt::rc::launch<true, U>(x, mask, mask_pitch, a, st)                                     \
                 : srt::rc::launch<false, U>(x, mask, mask_pitch, a, st);                                   \
    break;
  switch (units) {
    RC_LAUNCH(8)
    RC_LAUNCH(16)
    RC_LAUNCH(24)
    default:
      break;
  }
#undef RC_LAUNCH
  return static_cast<int>(err);
}

}  // extern "C"
