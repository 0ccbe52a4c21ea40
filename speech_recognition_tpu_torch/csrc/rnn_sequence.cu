// Kernel K10: the forward pass of a whole masked LSTM (i,f,c,o) or reset-after
// GRU (z,r,h) sequence, every direction in one launch.  C interface for
// ops/rnn_sequence.py (ctypes).
//
// Replaces rnn_sequence_pallas (speech_recognition_tpu/ops/pallas/rnn_kernel.py:100,
// cells _lstm_kernel :31 and _gru_kernel :65).  On the TPU one core walks the
// T grid steps with the recurrent weights pinned in VMEM.  Here a thread-block
// cluster of RNN_CLUSTER CTAs runs one (direction, tile of RNN_ROWS batch rows)
// for all T steps: CTA j owns hidden units [j*U, j*U + U), U = ceil(H / 8),
// and keeps their G gate columns of R in shared memory for the whole sequence.
// Each step a CTA computes its [ROWS, G*U] slice of h @ R, applies the gates to
// its units, and stores its slice of the new h into the next-h buffer of every
// CTA of the cluster through distributed shared memory; one cluster barrier
// ends the step.  The step's x_proj and mask are loaded one step ahead, so
// their latency hides behind the previous step.
//
// The product has three modes, chosen at launch:
// - MODE_MMA (bf16 when R fits): mma.sync m16n8k16 bf16 tiles with float32
//   accumulators; the 16 batch rows are the tile's M, R is held in shared
//   memory in B-fragment order (one 8-byte load per lane and tile), and h's
//   rows are padded by 8 elements so the A-fragment loads hit 32 banks;
// - MODE_FMA_SMEM (float32 when R fits): float32 FMA loops, R in shared memory;
// - MODE_FMA_GLOBAL (R too large, e.g. float32 at H=320): the same loops over R
//   read from L2.
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
constexpr int RNN_ROWS = 16;      // batch rows per tile: the M of an m16n8k16 tile
constexpr int RNN_STRIP = 4;      // batch rows per thread in the FMA product
constexpr int RNN_THREADS = 256;
constexpr int RNN_WARPS = RNN_THREADS / 32;
constexpr int RNN_MAX_PAIRS = 4;  // (row, unit) pairs per thread in the gate phase
constexpr int RNN_MAX_UNITS = RNN_THREADS * RNN_MAX_PAIRS / RNN_ROWS * RNN_CLUSTER;  // H <= 512
constexpr int RNN_MAX_TILES = 4;  // n-tiles of 8 columns per warp in MODE_MMA: G * U <= 256
constexpr int MODE_FMA_GLOBAL = 0, MODE_FMA_SMEM = 1, MODE_MMA = 2;

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
  return mode == MODE_MMA ? (H + 15) / 16 * 16 + 8 : H;
}

// x [T, D, B, G*H]; mask [T, D, B] (bool bytes); rk [D, H, G*H]; rb [D, G*H]
// (GRU); h0, c0 [D, B, H]; out [T, D, B, H]; h_last, c_last [D, B, H].
// Direction d runs its own time order: the caller has flipped the inputs.
template <typename T, bool GRU>
__global__ void __launch_bounds__(RNN_THREADS)
    rnn_sequence_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask, const T* __restrict__ rk,
                        const T* __restrict__ rb, const T* __restrict__ h0, const T* __restrict__ c0,
                        T* __restrict__ out, T* __restrict__ h_last, T* __restrict__ c_last, int steps, int D, int B,
                        int H, int mode) {
  constexpr int G = GRU ? 3 : 4;
  constexpr bool BF16 = sizeof(T) == 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int j = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d = blockIdx.z;
  const int b0 = blockIdx.y * RNN_ROWS;
  const int U = (H + RNN_CLUSTER - 1) / RNN_CLUSTER;
  const int lo = j * U;
  const int Uj = max(0, min(H - lo, U));  // units this CTA owns (0 for a trailing CTA when H is small)
  const int NC = G * U;                   // row stride of zs and of the FMA modes' R
  const int NCj = G * Uj;                 // columns this CTA computes
  const int GH = G * H;
  const int HS = rnn_h_stride(H, mode);
  const int KS = (H + 15) / 16, NT = (NCj + 7) / 8;  // MODE_MMA: k-steps and n-tiles

  extern __shared__ __align__(16) unsigned char smem[];
  T* hbuf = reinterpret_cast<T*>(smem);                                           // [2][ROWS][HS]
  float* zs = reinterpret_cast<float*>(smem + 2 * RNN_ROWS * HS * sizeof(T));     // [ROWS][NC]
  float* cs = zs + RNN_ROWS * NC;                                                 // [ROWS][U]
  T* Rs = reinterpret_cast<T*>(cs + RNN_ROWS * U);  // FMA: [H][NC]; MMA: [NT][KS][32 lanes][4]

  // this CTA's columns of R: column n < NCj is gate n / Uj, unit lo + n % Uj
  const T* rk_d = rk + (size_t)d * H * GH;
  if (mode == MODE_MMA) {
    for (int i = tid; i < NT * KS * 128; i += RNN_THREADS) {
      const int e = i & 3, ln = (i >> 2) & 31, ks = (i >> 7) % KS, nt = (i >> 7) / KS;
      const int k = ks * 16 + (ln & 3) * 2 + (e & 1) + (e >> 1) * 8, n = nt * 8 + (ln >> 2);
      const int g = n / max(Uj, 1), u = n - g * Uj;
      Rs[i] = (k < H && n < NCj) ? rk_d[(size_t)k * GH + g * H + lo + u] : from_f<T>(0.0f);
    }
  } else if (mode == MODE_FMA_SMEM) {
    for (int i = tid; i < H * NCj; i += RNN_THREADS) {
      const int k = i / NCj, n = i - k * NCj, g = n / Uj, u = n - g * Uj;
      Rs[k * NC + g * U + u] = rk_d[(size_t)k * GH + g * H + lo + u];
    }
  }
  // FMA modes: element (k, g, u) of the slice at Rp[k * rs + g * gs + u]
  const T* Rp = mode == MODE_FMA_SMEM ? Rs : rk_d + lo;
  const int rs = mode == MODE_FMA_SMEM ? NC : GH, gs = mode == MODE_FMA_SMEM ? U : H;

  for (int i = tid; i < 2 * RNN_ROWS * HS; i += RNN_THREADS) {  // h0 in buffer 0; rows past B and the pad zero
    const int r = (i / HS) % RNN_ROWS, k = i % HS, b = b0 + r;
    hbuf[i] = (i < RNN_ROWS * HS && b < B && k < H) ? h0[((size_t)d * B + b) * H + k] : from_f<T>(0.0f);
  }
  if constexpr (!GRU) {
    for (int i = tid; i < RNN_ROWS * U; i += RNN_THREADS) {
      const int r = i / U, u = i - r * U, b = b0 + r;
      cs[i] = (b < B && u < Uj) ? to_f(c0[((size_t)d * B + b) * H + lo + u]) : 0.0f;
    }
  }
  T* remote[RNN_CLUSTER];
#pragma unroll
  for (int q = 0; q < RNN_CLUSTER; ++q) remote[q] = cluster.map_shared_rank(hbuf, q);

  const int n_pairs = RNN_ROWS * Uj;
  const int n_strips = (RNN_ROWS / RNN_STRIP) * NCj;
  const T* rb_d = GRU ? rb + (size_t)d * GH + lo : nullptr;

  // the inputs of the thread's (row, unit) pairs at step t
  auto load_inputs = [&](int t, float (&xs)[RNN_MAX_PAIRS][G], bool (&ms)[RNN_MAX_PAIRS]) {
    const size_t row0 = ((size_t)t * D + d) * B;
#pragma unroll
    for (int i = 0; i < RNN_MAX_PAIRS; ++i) {
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
  auto step = [&](int t, const float (&xv)[RNN_MAX_PAIRS][G], const bool (&mv)[RNN_MAX_PAIRS],
                  float (&xn)[RNN_MAX_PAIRS][G], bool (&mn)[RNN_MAX_PAIRS]) {
    const int cur = t & 1;
    const T* hc = hbuf + cur * RNN_ROWS * HS;
    const size_t row0 = ((size_t)t * D + d) * B;  // [T, D, B] row of batch row 0
    if (t + 1 < steps) load_inputs(t + 1, xn, mn);  // in flight until the next step's gates

    // the recurrent product: zs[r][g*U + u] = sum_k h[r][k] R[k][g][u]
    if constexpr (BF16) {
      if (mode == MODE_MMA) {
        float acc[RNN_MAX_TILES][4];
#pragma unroll
        for (int q = 0; q < RNN_MAX_TILES; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
        const uint2* Rf = reinterpret_cast<const uint2*>(Rs);
        if (warp < NT) {
#pragma unroll 4
          for (int ks = 0; ks < KS; ++ks) {
            const T* hA = hc + (lane >> 2) * HS + ks * 16 + (lane & 3) * 2;
            const uint32_t a0 = *reinterpret_cast<const uint32_t*>(hA);
            const uint32_t a1 = *reinterpret_cast<const uint32_t*>(hA + 8 * HS);
            const uint32_t a2 = *reinterpret_cast<const uint32_t*>(hA + 8);
            const uint32_t a3 = *reinterpret_cast<const uint32_t*>(hA + 8 * HS + 8);
#pragma unroll
            for (int q = 0; q < RNN_MAX_TILES; ++q) {
              const int nt = warp + q * RNN_WARPS;
              if (nt < NT) {
                const uint2 bf = Rf[(nt * KS + ks) * 32 + lane];
                mma_bf16_16816(acc[q], a0, a1, a2, a3, bf.x, bf.y);
              }
            }
          }
        }
#pragma unroll
        for (int q = 0; q < RNN_MAX_TILES; ++q) {
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
    if (mode != MODE_MMA) {
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
    const size_t nxt = (size_t)(cur ^ 1) * RNN_ROWS * HS;
#pragma unroll
    for (int i = 0; i < RNN_MAX_PAIRS; ++i) {
      const int p = tid + i * RNN_THREADS;
      if (p < n_pairs) {
        const int r = p / Uj, u = p - r * Uj, b = b0 + r;
        const float* zr = zs + r * NC + u;
        const float h_old = to_f(hc[r * HS + lo + u]);
        const bool m = mv[i];
        float h_new, h_next;
        if constexpr (GRU) {
          const float rz = zr[0] + to_f(rb_d[u]);
          const float rr = zr[U] + to_f(rb_d[H + u]);
          const float rh = zr[2 * U] + to_f(rb_d[2 * H + u]);
          const float zg = sigmoidf(xv[i][0] + rz);
          const float rg = sigmoidf(xv[i][1] + rr);
          const float hh = tanhf(xv[i][2] + rg * rh);
          h_new = rnd<T>(zg * h_old + (1.0f - zg) * hh);
          h_next = m ? h_new : h_old;
          if (b < B && t == steps - 1) h_last[((size_t)d * B + b) * H + lo + u] = from_f<T>(h_next);
        } else {
          const float c_old = cs[r * U + u];
          const float ig = sigmoidf(xv[i][0] + zr[0]);
          const float fg = sigmoidf(xv[i][1] + zr[U]);
          const float gg = tanhf(xv[i][2] + zr[2 * U]);
          const float og = sigmoidf(xv[i][3] + zr[3 * U]);
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
  float xa[RNN_MAX_PAIRS][G], xb[RNN_MAX_PAIRS][G];
  bool ma[RNN_MAX_PAIRS], mb[RNN_MAX_PAIRS];
  load_inputs(0, xa, ma);
  cluster.sync();  // every CTA of the cluster has started and loaded its state before any remote store
  for (int t = 0; t < steps; t += 2) {
    step(t, xa, ma, xb, mb);
    if (t + 1 < steps) step(t + 1, xb, mb, xa, ma);
  }
}

template <typename T, bool GRU>
cudaError_t launch_rnn_sequence(const void* x, const void* mask, const void* rk, const void* rb, const void* h0,
                                const void* c0, void* out, void* h_last, void* c_last, int steps, int D, int B, int H,
                                cudaStream_t stream) {
  constexpr int G = GRU ? 3 : 4;
  if (steps < 1 || D < 1 || B < 1 || H < 1 || H > RNN_MAX_UNITS) return cudaErrorInvalidValue;
  const int U = (H + RNN_CLUSTER - 1) / RNN_CLUSTER;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  auto smem_bytes = [&](int mode) {
    const size_t r_bytes = mode == MODE_MMA ? (size_t)(G * U + 7) / 8 * 8 * ((H + 15) / 16 * 16) * sizeof(T)
                           : mode == MODE_FMA_SMEM ? (size_t)H * G * U * sizeof(T)
                                                   : 0;
    return 2 * RNN_ROWS * rnn_h_stride(H, mode) * sizeof(T) + (size_t)RNN_ROWS * G * U * 4 +
           (size_t)RNN_ROWS * U * 4 + r_bytes;
  };
  int mode = sizeof(T) == 2 ? MODE_MMA : MODE_FMA_SMEM;
  if (smem_bytes(mode) > (size_t)max_smem) mode = MODE_FMA_GLOBAL;
  const size_t smem = smem_bytes(mode);
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  auto kernel = rnn_sequence_kernel<T, GRU>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(RNN_CLUSTER, (B + RNN_ROWS - 1) / RNN_ROWS, D);
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

// is_gru: 0 LSTM (c0 / c_last used, rb unused), 1 GRU (rb [D, G*H] used, c0 / c_last unused).
// Shapes as rnn_sequence_kernel's; T >= 1, 1 <= H <= 512.
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

}  // extern "C"
