// Device code of one LAS decoder step, shared by the greedy kernel (K4,
// las_greedy.cu) and the teacher-forced decoder forward (K2, las_decoder.cu).
// Every function is called by all threads of a block, which holds one batch
// row; vectors live in shared memory, sums are float32 and each value is
// rounded to T where the TPU kernels round it.
#pragma once

#include "common.cuh"

namespace srt {

// q = hq @ qw + qb, scores[s] = q . pk[s] + bias[s] (a warp per key frame),
// float32 softmax over the S frames into ``sc``, then the context
// ctx[d] = rnd<T>(sum_s sc[s] value[s, d]) (a thread per value column).
// pkb [S,H] and vb [S,Dv] are this row's slices; ``red`` holds 33 floats.
template <typename T>
__device__ __forceinline__ void attend(const float* __restrict__ hq, const T* __restrict__ qw,
                                       const T* __restrict__ qb, const T* __restrict__ pkb,
                                       const T* __restrict__ vb, const float* __restrict__ biasb, int S, int H,
                                       int Dv, float* q, float* sc, float* red, float* ctx) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  for (int j = tid; j < H; j += nt) {
    float acc = 0.0f;
    for (int i = 0; i < H; ++i) acc = fmaf(hq[i], to_f(qw[(size_t)i * H + j]), acc);
    q[j] = acc + to_f(qb[j]);
  }
  __syncthreads();

  for (int s = warp; s < S; s += n_warps) {
    float acc = 0.0f;
    for (int i = lane; i < H; i += 32) acc = fmaf(q[i], to_f(pkb[(size_t)s * H + i]), acc);
    acc = warp_sum(acc);
    if (lane == 0) sc[s] = acc + biasb[s];
  }
  __syncthreads();

  float mx = -INFINITY;
  for (int s = tid; s < S; s += nt) mx = fmaxf(mx, sc[s]);
  mx = block_reduce(mx, red, true);
  float sum = 0.0f;
  for (int s = tid; s < S; s += nt) {
    const float e = expf(sc[s] - mx);
    sc[s] = e;
    sum += e;
  }
  sum = block_reduce(sum, red, false);
  for (int s = tid; s < S; s += nt) sc[s] = sc[s] / sum;
  __syncthreads();

  for (int d = tid; d < Dv; d += nt) {
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc = fmaf(sc[s], to_f(vb[(size_t)s * Dv + d]), acc);
    ctx[d] = rnd<T>(acc);
  }
  __syncthreads();
}

// z = x @ K + b + hq @ R over the 4H gate columns (a thread per column).
template <typename T>
__device__ __forceinline__ void cell_gates(const float* __restrict__ x, int in_dim, const float* __restrict__ hq,
                                           const T* __restrict__ K, const T* __restrict__ Rk,
                                           const T* __restrict__ Bc, int H, float* z) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int G = 4 * H;
  for (int j = tid; j < G; j += nt) {
    float a1 = 0.0f, a2 = 0.0f;
    for (int a = 0; a < in_dim; ++a) a1 = fmaf(x[a], to_f(K[(size_t)a * G + j]), a1);
    for (int a = 0; a < H; ++a) a2 = fmaf(hq[a], to_f(Rk[(size_t)a * G + j]), a2);
    z[j] = a1 + to_f(Bc[j]) + a2;
  }
  __syncthreads();
}

// LSTM cell update (gates i, f, c, o) with pad gating: where ``m`` is false
// the state (hc, cc) is kept and the output is zero.  Writes hq = rnd<T>(h)
// (the next recurrent / query input) and x[j] = rnd<T>(h' * m) (the next
// cell's input).  When ``z_out`` is given, z and c' are also stored in T.
template <typename T>
__device__ __forceinline__ void cell_update(const float* __restrict__ z, float* hc, float* cc, float* hq, float* x,
                                            int H, bool m, T* __restrict__ z_out, T* __restrict__ cp_out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (z_out != nullptr)
    for (int j = tid; j < 4 * H; j += nt) z_out[j] = from_f<T>(z[j]);
  for (int j = tid; j < H; j += nt) {
    const float gi = sigmoidf(z[j]), gf = sigmoidf(z[H + j]);
    const float gg = tanhf(z[2 * H + j]), go = sigmoidf(z[3 * H + j]);
    const float cp = gf * cc[j] + gi * gg;
    const float hp = go * tanhf(cp);
    if (cp_out != nullptr) cp_out[j] = from_f<T>(cp);
    if (m) {
      hc[j] = hp;
      cc[j] = cp;
    }
    hq[j] = rnd<T>(hc[j]);
    x[j] = m ? rnd<T>(hp) : 0.0f;
  }
  __syncthreads();
}

}  // namespace srt
