// Kernel K10: the forward pass of a whole masked LSTM (i,f,c,o) or reset-after
// GRU (z,r,h) sequence, every direction in one launch.  C interface for
// ops/rnn_sequence.py (ctypes).
//
// Replaces rnn_sequence_pallas (speech_recognition_tpu/ops/pallas/rnn_kernel.py:100,
// cells _lstm_kernel :31 and _gru_kernel :65).  On the TPU one core walks the
// T grid steps with the recurrent weights pinned in VMEM.  Here a thread-block
// cluster of RNN_CLUSTER CTAs runs one (direction, tile of RNN_ROWS x MT batch rows)
// for all T steps: CTA j owns hidden units [j*U, j*U + U), U = ceil(H / 8),
// and keeps their G gate columns of R in shared memory for the whole sequence.
// Each step a CTA computes its [ROWS, G*U] slice of h @ R, applies the gates to
// its units, and stores its slice of the new h into the next-h buffer of every
// CTA of the cluster through distributed shared memory; one cluster barrier
// ends the step.  The step's x_proj and mask are loaded one step ahead, so
// their latency hides behind the previous step.
//
// The product has four modes, chosen at launch:
// - MODE_MMA (bf16 when R fits): mma.sync m16n8k16 bf16 tiles with float32
//   accumulators; the 16 batch rows are the tile's M, R is held in shared
//   memory in B-fragment order (one 8-byte load per lane and tile), and h's
//   rows are padded by 8 elements so the A-fragment loads hit 32 banks;
// - MODE_MMA_GLOBAL (bf16 above H = 512, where a CTA's gate columns of R
//   are 1 MB at H = 1024): the same tiles, the B fragments read from L2 out
//   of a copy of R in fragment order that rnn_frag_kernel writes once per
//   launch, KU k-steps of loads issued before their products;
// - MODE_FMA_SMEM (float32 when R fits): float32 FMA loops, R in shared memory;
// - MODE_FMA_GLOBAL (R too large, e.g. float32 at H=320): the same loops over R
//   read from L2.
// Two routes: up to H = 512 a thread takes 4 (row, unit) pairs of the gate
// phase and a warp 4 n-tiles (RNN_NARROW_*); above, up to H = 1024, 8 pairs a
// thread for each m16 tile of rows and 8 n-tiles a warp (RNN_WIDE_*), with R
// always read from L2.  Above H = 512 each cluster of a direction reads the
// whole R every step (8 MB in bf16 at H = 1024), so in bf16 a cluster takes
// RNN_WIDE_MT = 2 m16 tiles (32 batch rows): each B fragment it loads feeds
// two products, and L2 carries half the bytes of one tile a cluster.  Its
// 16 pairs a thread load their inputs in the gate phase, not a step ahead
// (two steps of them would not fit the registers).
//
// Rounding is the Pallas kernel's: z = x (float32) + h @ R in float32 (bf16 x
// bf16 products are exact in float32); the GRU's recurrent bias (already in
// the compute type) is added in float32; gates in float32; c_new is rounded
// to the compute type before tanh(c_new); h_new is rounded to the compute
// type.  At a masked step the state is frozen and the output is zero.
//
// What bounds it on the H100: the chain of T dependent steps.  Each step's
// product is small (LAS-small: [16, 256] x [256, 128] per CTA) and the step
// ends in a cluster barrier, so the kernel runs at T x (product latency +
// barrier and exchange), far above the bytes / operations bound of the launch.
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace srt {

constexpr int RNN_CLUSTER = 8;    // CTAs per (direction, batch tile)
constexpr int RNN_ROWS = 16;      // batch rows of an m16n8k16 tile; a cluster takes MT such tiles
constexpr int RNN_STRIP = 4;      // batch rows per thread in the FMA product
constexpr int RNN_THREADS = 256;
constexpr int RNN_WARPS = RNN_THREADS / 32;
// (row, unit) pairs per thread in the gate phase for each m16 tile, and n-tiles of 8 columns per warp in the
// mma modes (G * U <= 8 tiles x 8 warps x 8 columns), of the narrow route (H <= 512) and the wide one (H <= 1024)
constexpr int RNN_NARROW_PAIRS = 4, RNN_NARROW_TILES = 4;
constexpr int RNN_WIDE_PAIRS = 8, RNN_WIDE_TILES = 8;
constexpr int RNN_WIDE_MT = 2;  // m16 tiles of a cluster on the wide route in bf16 (float32: 1, shared memory)
constexpr int RNN_NARROW_UNITS = RNN_THREADS * RNN_NARROW_PAIRS / RNN_ROWS * RNN_CLUSTER;  // 512
constexpr int RNN_MAX_UNITS = RNN_THREADS * RNN_WIDE_PAIRS / RNN_ROWS * RNN_CLUSTER;       // 1024
constexpr int RNN_KU = 4;  // MODE_MMA_GLOBAL: k-steps whose B fragments are loaded before their products
constexpr int MODE_FMA_GLOBAL = 0, MODE_FMA_SMEM = 1, MODE_MMA = 2, MODE_MMA_GLOBAL = 3;

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
__host__ __device__ inline int rnn_h_stride(int H, int mode) {
  return mode == MODE_MMA || mode == MODE_MMA_GLOBAL ? (H + 15) / 16 * 16 + 8 : H;
}

// Elements of one CTA's slice of R in B-fragment order: [NT][KS][32 lanes][4], NT = ceil(G * U / 8) n-tiles of
// 8 columns, KS = ceil(H / 16) k-steps (zero past H and past the CTA's columns)
__host__ __device__ inline size_t rnn_frag_elems(int G, int H) {
  const int U = (H + RNN_CLUSTER - 1) / RNN_CLUSTER;
  return (size_t)((G * U + 7) / 8) * ((H + 15) / 16) * 128;
}

// Element i of CTA j's fragment-order slice of direction d's R: column n < NCj of the slice is gate n / Uj,
// unit lo + n % Uj
template <typename T>
__device__ __forceinline__ T rnn_frag_elem(const T* __restrict__ rk_d, int i, int KS, int H, int GH, int lo, int Uj,
                                           int NCj) {
  const int e = i & 3, ln = (i >> 2) & 31, ks = (i >> 7) % KS, nt = (i >> 7) / KS;
  const int k = ks * 16 + (ln & 3) * 2 + (e & 1) + (e >> 1) * 8, n = nt * 8 + (ln >> 2);
  const int g = n / max(Uj, 1), u = n - g * Uj;
  return (k < H && n < NCj) ? rk_d[(size_t)k * GH + g * H + lo + u] : from_f<T>(0.0f);
}

// grid (RNN_CLUSTER, D, parts): frag[d][j] = CTA j's slice of rk[d] in B-fragment order (MODE_MMA_GLOBAL)
template <typename T>
__global__ void rnn_frag_kernel(const T* __restrict__ rk, int G, int H, T* __restrict__ frag) {
  const int j = blockIdx.x, d = blockIdx.y, GH = G * H;
  const int U = (H + RNN_CLUSTER - 1) / RNN_CLUSTER, lo = j * U, Uj = max(0, min(H - lo, U));
  const size_t n = rnn_frag_elems(G, H);
  T* out = frag + ((size_t)d * RNN_CLUSTER + j) * n;
  for (size_t i = (size_t)blockIdx.z * blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.z * blockDim.x)
    out[i] = rnn_frag_elem(rk + (size_t)d * H * GH, (int)i, (H + 15) / 16, H, GH, lo, Uj, G * Uj);
}

// x [T, D, B, G*H]; mask [T, D, B] (bool bytes); rk [D, H, G*H]; rb [D, G*H]
// (GRU); h0, c0 [D, B, H]; out [T, D, B, H]; h_last, c_last [D, B, H].
// Direction d runs its own time order: the caller has flipped the inputs.  frag: MODE_MMA_GLOBAL's
// fragment-order copy of R, [D][RNN_CLUSTER][rnn_frag_elems].  MT: m16 tiles of batch rows a cluster takes;
// PAIRS = MT x the route's RNN_*_PAIRS, TILES its RNN_*_TILES.
template <typename T, bool GRU, int PAIRS, int TILES, int MT>
__global__ void __launch_bounds__(RNN_THREADS)
    rnn_sequence_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask, const T* __restrict__ rk,
                        const T* __restrict__ frag, const T* __restrict__ rb, const T* __restrict__ h0,
                        const T* __restrict__ c0, T* __restrict__ out, T* __restrict__ h_last,
                        T* __restrict__ c_last, int steps, int D, int B, int H, int mode) {
  constexpr int G = GRU ? 3 : 4;
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr bool WIDE = TILES == RNN_WIDE_TILES;  // the wide route: R read from L2 (MODE_MMA_GLOBAL, FMA_GLOBAL)
  constexpr int ROWS = RNN_ROWS * MT;            // batch rows of the cluster
  constexpr bool AHEAD = MT == 1;  // step t+1's inputs loaded into registers during step t
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

  // the inputs of the thread's pair i at step t
  auto pair_inputs = [&](int t, int i, float (&xs)[G], bool& m) {
    const size_t row0 = ((size_t)t * D + d) * B;
    const int p = tid + i * RNN_THREADS;
    m = false;
#pragma unroll
    for (int g = 0; g < G; ++g) xs[g] = 0.0f;
    if (p < n_pairs) {
      const int r = p / Uj, u = p - r * Uj, b = b0 + r;
      if (b < B) {
        const T* xp = x + (row0 + b) * GH + lo + u;
#pragma unroll
        for (int g = 0; g < G; ++g) xs[g] = to_f(xp[g * H]);
        m = mask[row0 + b] != 0;
      }
    }
  };
  // AHEAD: the inputs of all the thread's pairs
  auto load_inputs = [&](int t, float (&xs)[PAIRS][G], bool (&ms)[PAIRS]) {
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) pair_inputs(t, i, xs[i], ms[i]);
  };

  // one step on inputs xv / mv, with step t+1's loads issued into xn / mn first
  auto step = [&](int t, const float (&xv)[PAIRS][G], const bool (&mv)[PAIRS],
                  float (&xn)[PAIRS][G], bool (&mn)[PAIRS]) {
    const int cur = t & 1;
    const T* hc = hbuf + cur * ROWS * HS;
    const size_t row0 = ((size_t)t * D + d) * B;  // [T, D, B] row of batch row 0
    if (AHEAD && t + 1 < steps) load_inputs(t + 1, xn, mn);  // in flight until the next step's gates

    // the recurrent product: zs[r][g*U + u] = sum_k h[r][k] R[k][g][u]
    if constexpr (BF16) {
      if (mode == MODE_MMA || mode == MODE_MMA_GLOBAL) {
        float acc[MT][TILES][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int q = 0; q < TILES; ++q) acc[mt][q][0] = acc[mt][q][1] = acc[mt][q][2] = acc[mt][q][3] = 0.0f;
        // the A fragment of k-step ks of m-tile mt: rows 16 mt + lane / 4 and + 8, columns ks * 16 + 2 (lane % 4)
        // (+ 1, + 8, + 9)
        auto a_frag = [&](int ks, int mt, uint32_t (&a)[4]) {
          const T* hA = hc + (mt * RNN_ROWS + (lane >> 2)) * HS + ks * 16 + (lane & 3) * 2;
          a[0] = *reinterpret_cast<const uint32_t*>(hA);
          a[1] = *reinterpret_cast<const uint32_t*>(hA + 8 * HS);
          a[2] = *reinterpret_cast<const uint32_t*>(hA + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(hA + 8 * HS + 8);
        };
        if (!WIDE && warp < NT) {  // MODE_MMA
          const uint2* Rf = reinterpret_cast<const uint2*>(Rs);
#pragma unroll 4
          for (int ks = 0; ks < KS; ++ks) {
            uint32_t a[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) a_frag(ks, mt, a[mt]);
#pragma unroll
            for (int q = 0; q < TILES; ++q) {
              const int nt = warp + q * RNN_WARPS;
              if (nt < NT) {
                const uint2 bf = Rf[(nt * KS + ks) * 32 + lane];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
                  mma_bf16_16816(acc[mt][q], a[mt][0], a[mt][1], a[mt][2], a[mt][3], bf.x, bf.y);
              }
            }
          }
        } else if (WIDE && warp < NT) {  // MODE_MMA_GLOBAL
          // this CTA's slice in fragment order; all of a group's loads are in flight before its first product
          const uint2* Rf = reinterpret_cast<const uint2*>(frag + ((size_t)d * RNN_CLUSTER + j) * rnn_frag_elems(G, H));
#pragma unroll 1
          for (int ks0 = 0; ks0 < KS; ks0 += RNN_KU) {
            uint2 bf[RNN_KU][TILES];
#pragma unroll
            for (int u = 0; u < RNN_KU; ++u)
#pragma unroll
              for (int q = 0; q < TILES; ++q) {
                const int nt = warp + q * RNN_WARPS;
                bf[u][q] = (nt < NT && ks0 + u < KS) ? Rf[(nt * KS + ks0 + u) * 32 + lane] : make_uint2(0u, 0u);
              }
#pragma unroll
            for (int u = 0; u < RNN_KU; ++u) {
              if (ks0 + u < KS) {
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                  uint32_t a[4];
                  a_frag(ks0 + u, mt, a);
#pragma unroll
                  for (int q = 0; q < TILES; ++q)
                    if (warp + q * RNN_WARPS < NT)
                      mma_bf16_16816(acc[mt][q], a[0], a[1], a[2], a[3], bf[u][q].x, bf[u][q].y);
                }
              }
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int q = 0; q < TILES; ++q) {
            const int nt = warp + q * RNN_WARPS;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = mt * RNN_ROWS + (lane >> 2) + (e >> 1) * 8, n = nt * 8 + (lane & 3) * 2 + (e & 1);
              if (nt < NT && n < NCj) {
                const int g = n / Uj;
                zs[r * NC + g * U + (n - g * Uj)] = acc[mt][q][e];
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
        float xg[G];
        bool m;
        if constexpr (AHEAD) {
#pragma unroll
          for (int g = 0; g < G; ++g) xg[g] = xv[i][g];
          m = mv[i];
        } else {
          pair_inputs(t, i, xg, m);
        }
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

  // AHEAD: two register sets of inputs, so a step's loads are consumed only in the step after
  float xa[PAIRS][G], xb[PAIRS][G];
  bool ma[PAIRS], mb[PAIRS];
  if (AHEAD) load_inputs(0, xa, ma);
  cluster.sync();  // every CTA of the cluster has started and loaded its state before any remote store
  for (int t = 0; t < steps; t += 2) {
    step(t, xa, ma, xb, mb);
    if (t + 1 < steps) step(t + 1, xb, mb, xa, ma);
  }
}

template <typename T, bool GRU>
cudaError_t launch_rnn_sequence(const void* x, const void* mask, const void* rk, const void* rb, const void* h0,
                                const void* c0, void* out, void* h_last, void* c_last, void* frag, int steps, int D,
                                int B, int H, cudaStream_t stream) {
  constexpr int G = GRU ? 3 : 4;
  if (steps < 1 || D < 1 || B < 1 || H < 1 || H > RNN_MAX_UNITS) return cudaErrorInvalidValue;
  const bool wide = H > RNN_NARROW_UNITS;
  constexpr int WIDE_MT = sizeof(T) > 2 ? 1 : RNN_WIDE_MT;  // float32: one m16 tile (shared memory)
  const int rows = RNN_ROWS * (wide ? WIDE_MT : 1);  // batch rows of a cluster
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
  int mode;
  if (wide) {  // R never fits: bf16 reads the fragment-order copy, float32 R itself
    mode = sizeof(T) == 2 ? MODE_MMA_GLOBAL : MODE_FMA_GLOBAL;
    if (sizeof(T) == 2 && frag == nullptr) return cudaErrorInvalidValue;
  } else {
    mode = sizeof(T) == 2 ? MODE_MMA : MODE_FMA_SMEM;
    if (smem_bytes(mode) > (size_t)max_smem) mode = MODE_FMA_GLOBAL;
  }
  const size_t smem = smem_bytes(mode);
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  auto kernel = wide ? rnn_sequence_kernel<T, GRU, RNN_WIDE_PAIRS * WIDE_MT, RNN_WIDE_TILES, WIDE_MT>
                     : rnn_sequence_kernel<T, GRU, RNN_NARROW_PAIRS, RNN_NARROW_TILES, 1>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (mode == MODE_MMA_GLOBAL) {
    rnn_frag_kernel<T><<<dim3(RNN_CLUSTER, D, 32), 256, 0, stream>>>(static_cast<const T*>(rk), G, H,
                                                                    static_cast<T*>(frag));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

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
                           static_cast<const T*>(rk), static_cast<const T*>(frag), static_cast<const T*>(rb),
                           static_cast<const T*>(h0), static_cast<const T*>(c0), static_cast<T*>(out),
                           static_cast<T*>(h_last), static_cast<T*>(c_last), steps, D, B, H, mode);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace srt

extern "C" {

// is_gru: 0 LSTM (c0 / c_last used, rb unused), 1 GRU (rb [D, G*H] used, c0 / c_last unused).
// Shapes as rnn_sequence_kernel's; T >= 1, 1 <= H <= 1024.  frag: scratch of D * 8 * rnn_frag_elems(G, H)
// elements in bf16 above H = 512 (ops/rnn_sequence.py rnn_plan), else unused.
int rnn_sequence(int dtype_bf16, int is_gru, const void* x, const void* mask, const void* rk, const void* rb,
                 const void* h0, const void* c0, void* out, void* h_last, void* c_last, void* frag, int T, int D,
                 int B, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_bf16 && is_gru)
    err = srt::launch_rnn_sequence<__nv_bfloat16, true>(x, mask, rk, rb, h0, c0, out, h_last, c_last, frag, T, D, B,
                                                        H, st);
  else if (dtype_bf16)
    err = srt::launch_rnn_sequence<__nv_bfloat16, false>(x, mask, rk, rb, h0, c0, out, h_last, c_last, frag, T, D,
                                                         B, H, st);
  else if (is_gru)
    err = srt::launch_rnn_sequence<float, true>(x, mask, rk, rb, h0, c0, out, h_last, c_last, frag, T, D, B, H, st);
  else
    err = srt::launch_rnn_sequence<float, false>(x, mask, rk, rb, h0, c0, out, h_last, c_last, frag, T, D, B, H, st);
  return static_cast<int>(err);
}

}  // extern "C"
