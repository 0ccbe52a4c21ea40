// Kernels K2 and K3: the teacher-forced LAS decoder loop, forward and
// backward.  C interface for ops/decoder_kernel.py (ctypes).
//   K2 replaces decoder_fwd_pallas (speech_recognition_tpu/ops/pallas/decoder_kernel.py:238),
//   K3 replaces decoder_bwd_pallas (same file, :477).
//
// Batch rows are independent in the decoder loop, so each kernel is ONE
// launch of one block of DEC_THREADS per batch row that runs all N steps
// itself (forward in order, backward in reverse): the loop inside the block
// takes the place of the TPU kernel's sequential grid.  The carried state
// (h, c forward; dh, dc backward) stays float32 in shared memory for the
// whole loop, and every per-step vector lives there too (~20 KB).
//
// What bounds them: each step of each row streams the row's projected keys
// (S*H) and values (S*Dv), 130 KB + 261 KB at LAS-small in bf16, and the
// ~3 MB of cell / query weights, all from L2 (the TPU kernel keeps ~50 MB
// resident in VMEM; an SM has 227 KB, so nothing is resident here).  Every
// matvec is the block's own float32 loop on the CUDA cores; 128 rows fill
// 128 of the 132 SMs with one block each.  Measured on the H100, one row
// alone takes half or more of the time of 128: each block is bound by the latency of
// its per-thread chains of ~2k dependent L2 loads and FMAs per step, so the
// loops are unit-stride to keep several loads in flight (see vec_mat).
// Batching rows per block to share the weight reads, and tensor-core tiles,
// are later work.
//
// Rounding follows the Pallas kernels (decoder_kernel.py:113-169 and
// :326-404) in T = bf16, and rounds nothing in T = float32 (the XLA scan's
// math):
//   K2: h_start, c_in0 stored in T before the step; x_in = rnd(x * cell_mask);
//       the query and recurrent inputs are rnd(h) of the threaded h; z and c'
//       stored in T while the gates use float32 z; x = rnd(h' * m);
//       hidden = rnd(x * out_mask); h_last, c_last stored in T.
//   K3: c_in rebuilt per cell from c_in0 and the stored c'; dz stored in T and
//       rnd(dz) feeds the R^T and K^T products; dctx float32 for dprobs but
//       stored in T; softmax VJP on probs that arrive in T; dq float32, then
//       rnd(dq) @ qw^T; dh0, dc0 stored in T.
// The key axis S is masked by the loops themselves: no padding of pk/value.
#include "las_step.cuh"

#define DEC_THREADS 1024
#define DEC_MAX_CELLS 8  // = ops/decoder_kernel.py MAX_CELLS

namespace srt {

template <typename T>
struct DecoderFwdCells {
  const T* kernel[DEC_MAX_CELLS];     // [in_i, 4H]
  const T* recurrent[DEC_MAX_CELLS];  // [H, 4H]
  const T* bias[DEC_MAX_CELLS];       // [4H]
  const T* mask[DEC_MAX_CELLS];       // [B, in_i] dropout mask
  T* z[DEC_MAX_CELLS];                // [N, B, 4H] out
  T* cp[DEC_MAX_CELLS];               // [N, B, H] out
  int n;
};

template <typename T>
struct DecoderBwdCells {
  const T* kernel_t[DEC_MAX_CELLS];     // [4H, in_i] = kernel^T
  const T* recurrent_t[DEC_MAX_CELLS];  // [4H, H] = recurrent_kernel^T
  const T* mask[DEC_MAX_CELLS];         // [B, in_i]
  const T* z[DEC_MAX_CELLS];            // [N, B, 4H]
  const T* cp[DEC_MAX_CELLS];           // [N, B, H]
  T* dz[DEC_MAX_CELLS];                 // [N, B, 4H] out
  int n;
};

template <typename T>
__global__ void __launch_bounds__(DEC_THREADS)
    decoder_fwd_kernel(const T* __restrict__ emb, const float* __restrict__ token_mask, const T* __restrict__ pk,
                       const T* __restrict__ value, const float* __restrict__ attn_bias, const T* __restrict__ qw,
                       const T* __restrict__ qb, DecoderFwdCells<T> cells, const T* __restrict__ out_mask,
                       const T* __restrict__ h0, const T* __restrict__ c0, T* __restrict__ hidden,
                       T* __restrict__ h_start, T* __restrict__ c_in0, T* __restrict__ h_last, T* __restrict__ c_last,
                       int N, int B, int S, int H, int He, int Dv) {
  extern __shared__ float sm[];
  float* hq = sm;          // [H]  rnd(h): the query / recurrent input
  float* q = hq + H;       // [H]
  float* x = q + H;        // [He + Dv] cell input
  float* z = x + He + Dv;  // [4H]
  float* hc = z + 4 * H;   // [H]  h, float32
  float* cc = hc + H;      // [H]  c, float32
  float* sc = cc + H;      // [S]  scores, then probabilities
  float* red = sc + S;     // [33]

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int G = 4 * H;
  for (int j = tid; j < H; j += nt) {
    hc[j] = to_f(h0[(size_t)b * H + j]);
    cc[j] = to_f(c0[(size_t)b * H + j]);
    hq[j] = rnd<T>(hc[j]);
  }
  for (int n = 0; n < N; ++n) {
    const size_t row = (size_t)n * B + b;
    const bool m = token_mask[row] != 0.0f;
    __syncthreads();
    for (int j = tid; j < H; j += nt) {
      h_start[row * H + j] = from_f<T>(hc[j]);
      c_in0[row * H + j] = from_f<T>(cc[j]);
    }
    for (int j = tid; j < He; j += nt) x[j] = to_f(emb[row * He + j]);
    __syncthreads();

    attend<T>(hq, qw, qb, pk + (size_t)b * S * H, value + (size_t)b * S * Dv, attn_bias + (size_t)b * S, S, H, Dv,
              q, sc, red, x + He);

    int in_dim = He + Dv;
    for (int ci = 0; ci < cells.n; ++ci) {
      const T* cm = cells.mask[ci] + (size_t)b * in_dim;
      for (int a = tid; a < in_dim; a += nt) x[a] = rnd<T>(x[a] * to_f(cm[a]));
      __syncthreads();
      cell_gates<T>(x, in_dim, hq, cells.kernel[ci], cells.recurrent[ci], cells.bias[ci], H, z);
      cell_update<T>(z, hc, cc, hq, x, H, m, cells.z[ci] + row * G, cells.cp[ci] + row * H);
      in_dim = H;
    }
    for (int j = tid; j < H; j += nt) hidden[row * H + j] = from_f<T>(x[j] * to_f(out_mask[(size_t)b * H + j]));
  }
  __syncthreads();
  for (int j = tid; j < H; j += nt) {
    h_last[(size_t)b * H + j] = from_f<T>(hc[j]);
    c_last[(size_t)b * H + j] = from_f<T>(cc[j]);
  }
}

// epi(j, sum_a v[a] * M[a * out_len + j]) for j < out_len.  When out_len fits
// the block, the a-range is split over P = blockDim / out_len thread groups
// whose partials (``part``, blockDim floats) are added in group order.  Each
// group takes a contiguous a-range: a unit-stride loop lets the compiler
// issue several L2 loads ahead of the sum, where a loop strided by the
// runtime P waited out each load's latency (K3 took 3.3x as long for one
// batch row at LAS-small).
template <typename T, typename Epi>
__device__ __forceinline__ void vec_mat(const float* __restrict__ v, int in_len, const T* __restrict__ M,
                                        int out_len, float* part, Epi epi) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (out_len <= nt) {
    const int P = nt / out_len;
    const int p = tid / out_len, j = tid - p * out_len;
    if (p < P) {
      const int chunk = (in_len + P - 1) / P;
      const int a1 = min(in_len, (p + 1) * chunk);
      float acc = 0.0f;
      for (int a = p * chunk; a < a1; ++a) acc = fmaf(v[a], to_f(M[(size_t)a * out_len + j]), acc);
      part[tid] = acc;
    }
    __syncthreads();
    if (tid < out_len) {
      float s = 0.0f;
      for (int g = 0; g < P; ++g) s += part[g * out_len + tid];
      epi(tid, s);
    }
  } else {
    for (int j = tid; j < out_len; j += nt) {
      float acc = 0.0f;
      for (int a = 0; a < in_len; ++a) acc = fmaf(v[a], to_f(M[(size_t)a * out_len + j]), acc);
      epi(j, acc);
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(DEC_THREADS)
    decoder_bwd_kernel(const T* __restrict__ dhidden, const T* __restrict__ dh_last, const T* __restrict__ dc_last,
                       const float* __restrict__ token_mask, const T* __restrict__ probs,
                       const T* __restrict__ c_in0, const T* __restrict__ pk, const T* __restrict__ value,
                       const T* __restrict__ qw_t, DecoderBwdCells<T> cells, const T* __restrict__ out_mask,
                       T* __restrict__ demb, T* __restrict__ dctx, T* __restrict__ dscores, T* __restrict__ dq_out,
                       T* __restrict__ dh0, T* __restrict__ dc0, int N, int B, int S, int H, int He, int Dv) {
  extern __shared__ float sm[];
  const int D0 = He + Dv;
  const int X = D0 > H ? D0 : H;
  float* dh = sm;                // [H] carried dh
  float* dc = dh + H;            // [H] carried dc
  float* dhp = dc + H;           // [H] dh flowing out of the current cell
  float* dcp = dhp + H;          // [H]
  float* dxo = dcp + H;          // [X] dx into the current cell's output, then dx0
  float* sdz = dxo + X;          // [4H] rnd(dz)
  float* cins = sdz + 4 * H;     // [n_cells * H] c entering each cell
  float* pr = cins + cells.n * H;  // [S] probs
  float* ds = pr + S;            // [S] dprobs, then dscores
  float* dqs = ds + S;           // [H] rnd(dq)
  float* part = dqs + H;         // [blockDim] vec_mat partials
  float* red = part + blockDim.x;  // [33]

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const int G = 4 * H;
  const T* pkb = pk + (size_t)b * S * H;
  const T* vb = value + (size_t)b * S * Dv;
  for (int j = tid; j < H; j += nt) {
    dh[j] = to_f(dh_last[(size_t)b * H + j]);
    dc[j] = to_f(dc_last[(size_t)b * H + j]);
  }
  for (int n = N - 1; n >= 0; --n) {
    const size_t row = (size_t)n * B + b;
    const float m = token_mask[row];
    __syncthreads();
    for (int j = tid; j < H; j += nt) {
      float c = to_f(c_in0[row * H + j]);
      cins[j] = c;
      for (int i = 1; i < cells.n; ++i) {
        c = m * to_f(cells.cp[i - 1][row * H + j]) + (1.0f - m) * c;
        cins[i * H + j] = c;
      }
      dxo[j] = to_f(dhidden[row * H + j]) * to_f(out_mask[(size_t)b * H + j]);
    }
    __syncthreads();

    const float* dh_cur = dh;
    const float* dc_cur = dc;
    for (int i = cells.n - 1; i >= 0; --i) {
      const T* zt = cells.z[i] + row * G;
      const T* cpt = cells.cp[i] + row * H;
      T* dzt = cells.dz[i] + row * G;
      for (int j = tid; j < H; j += nt) {
        const float gi = sigmoidf(to_f(zt[j])), gf = sigmoidf(to_f(zt[H + j]));
        const float gg = tanhf(to_f(zt[2 * H + j])), go = sigmoidf(to_f(zt[3 * H + j]));
        const float tanh_cp = tanhf(to_f(cpt[j]));
        const float dh_p = m * dh_cur[j] + m * dxo[j];
        float dh_prev = (1.0f - m) * dh_cur[j];
        float dc_p = m * dc_cur[j];
        float dc_prev = (1.0f - m) * dc_cur[j];
        const float d_o = dh_p * tanh_cp;
        dc_p = dc_p + dh_p * go * (1.0f - tanh_cp * tanh_cp);
        const float df = dc_p * cins[i * H + j];
        dc_prev = dc_prev + dc_p * gf;
        const float di = dc_p * gg, dg = dc_p * gi;
        const float dz4[4] = {di * gi * (1.0f - gi), df * gf * (1.0f - gf), dg * (1.0f - gg * gg),
                              d_o * go * (1.0f - go)};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          dzt[k * H + j] = from_f<T>(dz4[k]);
          sdz[k * H + j] = rnd<T>(dz4[k]);
        }
        dhp[j] = dh_prev;
        dcp[j] = dc_prev;
      }
      __syncthreads();
      vec_mat<T>(sdz, G, cells.recurrent_t[i], H, part, [&](int j, float s) { dhp[j] += s; });
      const int in_i = i == 0 ? D0 : H;
      const T* cm = cells.mask[i] + (size_t)b * in_i;
      vec_mat<T>(sdz, G, cells.kernel_t[i], in_i, part, [&](int a, float s) { dxo[a] = s * to_f(cm[a]); });
      dh_cur = dhp;
      dc_cur = dcp;
    }

    // attention backward of step n: dx0 = [demb, dctx] is in dxo
    for (int a = tid; a < D0; a += nt) {
      if (a < He)
        demb[row * He + a] = from_f<T>(dxo[a]);
      else
        dctx[row * Dv + a - He] = from_f<T>(dxo[a]);
    }
    for (int s = tid; s < S; s += nt) pr[s] = to_f(probs[row * S + s]);
    for (int s = warp; s < S; s += n_warps) {
      float acc = 0.0f;
      for (int d = lane; d < Dv; d += 32) acc = fmaf(dxo[He + d], to_f(vb[(size_t)s * Dv + d]), acc);
      acc = warp_sum(acc);
      if (lane == 0) ds[s] = acc;
    }
    __syncthreads();
    float t = 0.0f;
    for (int s = tid; s < S; s += nt) t += pr[s] * ds[s];
    t = block_reduce(t, red, false);
    for (int s = tid; s < S; s += nt) {
      const float v = pr[s] * (ds[s] - t);
      ds[s] = v;
      dscores[row * S + s] = from_f<T>(v);
    }
    __syncthreads();
    vec_mat<T>(ds, S, pkb, H, part, [&](int h, float s) {
      dq_out[row * H + h] = from_f<T>(s);
      dqs[h] = rnd<T>(s);
    });
    vec_mat<T>(dqs, H, qw_t, H, part, [&](int j, float s) { dhp[j] += s; });
    for (int j = tid; j < H; j += nt) {
      dh[j] = dhp[j];
      dc[j] = dcp[j];
    }
  }
  __syncthreads();
  for (int j = tid; j < H; j += nt) {
    dh0[(size_t)b * H + j] = from_f<T>(dh[j]);
    dc0[(size_t)b * H + j] = from_f<T>(dc[j]);
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
cudaError_t decoder_fwd_impl(const void* emb, const float* token_mask, const void* pk, const void* value,
                             const float* attn_bias, const void* qw, const void* qb, int n_cells, void** ks,
                             void** rs, void** bs, void** cms, void** zs, void** cps, const void* out_mask,
                             const void* h0, const void* c0, void* hidden, void* h_start, void* c_in0, void* h_last,
                             void* c_last, int N, int B, int S, int H, int He, int Dv, cudaStream_t stream) {
  if (n_cells < 1 || n_cells > DEC_MAX_CELLS) return cudaErrorInvalidValue;
  DecoderFwdCells<T> cells;
  cells.n = n_cells;
  for (int i = 0; i < n_cells; ++i) {
    cells.kernel[i] = static_cast<const T*>(ks[i]);
    cells.recurrent[i] = static_cast<const T*>(rs[i]);
    cells.bias[i] = static_cast<const T*>(bs[i]);
    cells.mask[i] = static_cast<const T*>(cms[i]);
    cells.z[i] = static_cast<T*>(zs[i]);
    cells.cp[i] = static_cast<T*>(cps[i]);
  }
  const size_t smem = sizeof(float) * ((size_t)H * 8 + He + Dv + S + 33);
  cudaError_t err = set_smem(decoder_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  decoder_fwd_kernel<T><<<B, DEC_THREADS, smem, stream>>>(
      static_cast<const T*>(emb), token_mask, static_cast<const T*>(pk), static_cast<const T*>(value), attn_bias,
      static_cast<const T*>(qw), static_cast<const T*>(qb), cells, static_cast<const T*>(out_mask),
      static_cast<const T*>(h0), static_cast<const T*>(c0), static_cast<T*>(hidden), static_cast<T*>(h_start),
      static_cast<T*>(c_in0), static_cast<T*>(h_last), static_cast<T*>(c_last), N, B, S, H, He, Dv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t decoder_bwd_impl(const void* dhidden, const void* dh_last, const void* dc_last, const float* token_mask,
                             const void* probs, const void* c_in0, const void* pk, const void* value,
                             const void* qw_t, int n_cells, void** kts, void** rts, void** cms, void** zs,
                             void** cps, void** dzs, const void* out_mask, void* demb, void* dctx, void* dscores,
                             void* dq, void* dh0, void* dc0, int N, int B, int S, int H, int He, int Dv,
                             cudaStream_t stream) {
  if (n_cells < 1 || n_cells > DEC_MAX_CELLS) return cudaErrorInvalidValue;
  DecoderBwdCells<T> cells;
  cells.n = n_cells;
  for (int i = 0; i < n_cells; ++i) {
    cells.kernel_t[i] = static_cast<const T*>(kts[i]);
    cells.recurrent_t[i] = static_cast<const T*>(rts[i]);
    cells.mask[i] = static_cast<const T*>(cms[i]);
    cells.z[i] = static_cast<const T*>(zs[i]);
    cells.cp[i] = static_cast<const T*>(cps[i]);
    cells.dz[i] = static_cast<T*>(dzs[i]);
  }
  const size_t X = (size_t)(He + Dv > H ? He + Dv : H);
  const size_t smem = sizeof(float) * ((size_t)H * (9 + n_cells) + X + 2 * (size_t)S + DEC_THREADS + 33);
  cudaError_t err = set_smem(decoder_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  decoder_bwd_kernel<T><<<B, DEC_THREADS, smem, stream>>>(
      static_cast<const T*>(dhidden), static_cast<const T*>(dh_last), static_cast<const T*>(dc_last), token_mask,
      static_cast<const T*>(probs), static_cast<const T*>(c_in0), static_cast<const T*>(pk),
      static_cast<const T*>(value), static_cast<const T*>(qw_t), cells, static_cast<const T*>(out_mask),
      static_cast<T*>(demb), static_cast<T*>(dctx), static_cast<T*>(dscores), static_cast<T*>(dq),
      static_cast<T*>(dh0), static_cast<T*>(dc0), N, B, S, H, He, Dv);
  return cudaGetLastError();
}

}  // namespace srt

extern "C" {

// K2.  emb [N,B,He], pk [B,S,H], value [B,S,Dv], qw [H,H], qb [H], per cell
// kernel [in_i,4H], recurrent [H,4H], bias [4H], mask [B,in_i]; out_mask,
// h0, c0 [B,H]: all in T (bf16 when dtype_bf16, else float32).
// token_mask [N,B] and attn_bias [B,S] float32.  Outputs in T: hidden,
// h_start, c_in0 [N,B,H], per cell z [N,B,4H] and c' [N,B,H], h_last, c_last [B,H].
int las_decoder_fwd(int dtype_bf16, const void* emb, const float* token_mask, const void* pk, const void* value,
                    const float* attn_bias, const void* qw, const void* qb, int n_cells, void** ks, void** rs,
                    void** bs, void** cms, void** zs, void** cps, const void* out_mask, const void* h0,
                    const void* c0, void* hidden, void* h_start, void* c_in0, void* h_last, void* c_last, int N,
                    int B, int S, int H, int He, int Dv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_bf16)
    err = srt::decoder_fwd_impl<__nv_bfloat16>(emb, token_mask, pk, value, attn_bias, qw, qb, n_cells, ks, rs, bs,
                                               cms, zs, cps, out_mask, h0, c0, hidden, h_start, c_in0, h_last,
                                               c_last, N, B, S, H, He, Dv, st);
  else
    err = srt::decoder_fwd_impl<float>(emb, token_mask, pk, value, attn_bias, qw, qb, n_cells, ks, rs, bs, cms, zs,
                                       cps, out_mask, h0, c0, hidden, h_start, c_in0, h_last, c_last, N, B, S, H,
                                       He, Dv, st);
  return static_cast<int>(err);
}

// K3.  dhidden [N,B,H], dh_last/dc_last [B,H], probs [N,B,S], c_in0 [N,B,H],
// pk, value, qw_t = qw^T [H,H], per cell kernel^T [4H,in_i],
// recurrent^T [4H,H], mask [B,in_i], z [N,B,4H], c' [N,B,H]; out_mask [B,H]:
// in T.  token_mask [N,B] float32.  Outputs in T: per cell dz [N,B,4H],
// demb [N,B,He], dctx [N,B,Dv], dscores [N,B,S], dq [N,B,H], dh0, dc0 [B,H].
int las_decoder_bwd(int dtype_bf16, const void* dhidden, const void* dh_last, const void* dc_last,
                    const float* token_mask, const void* probs, const void* c_in0, const void* pk, const void* value,
                    const void* qw_t, int n_cells, void** kts, void** rts, void** cms, void** zs, void** cps,
                    void** dzs, const void* out_mask, void* demb, void* dctx, void* dscores, void* dq, void* dh0,
                    void* dc0, int N, int B, int S, int H, int He, int Dv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_bf16)
    err = srt::decoder_bwd_impl<__nv_bfloat16>(dhidden, dh_last, dc_last, token_mask, probs, c_in0, pk, value, qw_t,
                                               n_cells, kts, rts, cms, zs, cps, dzs, out_mask, demb, dctx, dscores,
                                               dq, dh0, dc0, N, B, S, H, He, Dv, st);
  else
    err = srt::decoder_bwd_impl<float>(dhidden, dh_last, dc_last, token_mask, probs, c_in0, pk, value, qw_t,
                                       n_cells, kts, rts, cms, zs, cps, dzs, out_mask, demb, dctx, dscores, dq, dh0,
                                       dc0, N, B, S, H, He, Dv, st);
  return static_cast<int>(err);
}

}  // extern "C"
