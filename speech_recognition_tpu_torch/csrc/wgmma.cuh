// Hopper building blocks shared by the port's tensor-core kernels: the bf16
// backward engine of the vocab projections (csrc/vocab_bwd.cuh), the vocab
// tile pass (csrc/vocab_topk.cuh) and the bf16 attention kernels
// (csrc/attention.cu).
//
// Every operand lives in shared memory as panels of [rows x 64] bf16, one
// 128-byte row per data row, 16-byte chunks swizzled by (row % 8): the layout
// the wgmma descriptors name as 128-byte swizzle, readable both K-major and
// MN-major.  Panels arrive by cp.async (16 bytes a thread, zero-filled past
// the edges), by the tensor memory accelerator (TMA, one thread a box, an
// mbarrier counting the bytes), or by a staged copy where a row pitch is not
// 16-byte aligned.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace srt {
namespace wg {

using Bf = __nv_bfloat16;

constexpr int PANEL = 64;         // bf16 columns of a panel: one 128-byte swizzle row
constexpr int ROW_BYTES = 128;
constexpr int WG_ROWS = 64;       // rows of one warpgroup: the wgmma M
constexpr int W_PANEL = PANEL * ROW_BYTES;        // [64 x 64] bf16
constexpr int ALIGN = 1024;                       // the swizzle atom: 8 rows x 128 bytes

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// orders this thread's shared-memory writes (st.shared, cp.async) before the tensor cores' reads
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}

// byte offset of 16-byte chunk ``chunk`` of row ``r`` in a swizzled panel
__device__ __forceinline__ uint32_t swz(int r, int chunk) { return r * ROW_BYTES + ((chunk ^ (r & 7)) << 4); }

// wgmma shared-memory descriptors for a 128-byte-swizzled panel (1024-byte
// aligned atoms).  K-major: 8-row groups 1024 bytes apart, a k-step of 16 is
// +32 bytes along the row.  MN-major: 8 k-rows per 1024 bytes, a k-step of 16
// is +2048 bytes; the leading offset is the step from one 64-column panel to
// the next along MN (unused when the operand's MN extent is one panel).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 | (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}
__device__ __forceinline__ uint64_t kmajor(uint32_t addr) { return desc(addr, 16, 1024); }
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr, uint32_t panel_step = 1024) {
  return desc(addr, panel_step, 1024);
}

#define VB_D32                                                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define VB_OUT32(d)                                                                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),        \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),         \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define VB_D64                                                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "   \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define VB_OUT64(d)                                                                                                  \
  VB_OUT32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]),            \
      "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),        \
      "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),        \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),        \
      "+f"(d[63])

// d[64 x 128] += A[64 x 16] B[16 x 128] (d = A B where accumulate is 0): A K-major, B MN-major (two 64-column
// panels), both from shared memory
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VB_D64 ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : VB_OUT64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64] (d = A B where accumulate is 0), both from shared memory; TA / TB:
// 1 = MN-major
template <int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VB_D32 ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : VB_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers (the A fragment: pack_bf16 of an accumulator's cells,
// a0..a3 = registers 4s..4s + 3 for k-step s), B in shared memory; TB: 1 = MN-major
template <int TB = 0>
__device__ __forceinline__ void mma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VB_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : VB_OUT32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1), "n"(TB));
}

// Two floats rounded to bf16 (round to nearest even) in one register, lo in the low half: register k of a
// 64 x 64 accumulator's A fragment is pack_bf16(z[2k], z[2k + 1]) (its row, columns 8 (k / 2) + 2 (lane % 4) + 0, 1)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void wg_arrive() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// at most N of this warpgroup's committed wgmma groups still in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// ties registers that the tensor cores read or write to the wgmma fences around them
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// ---------------------------------------------------------------- TMA and mbarriers
// The tensor memory accelerator copies a [64 x 64] bf16 box of a row-major
// matrix into a 128-byte-swizzled panel (the layout above), zero-filling
// what lies outside the matrix, and reports the bytes to an mbarrier.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// makes initialised mbarriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}
// waits for phase ``parity`` of the mbarrier; a copy that never lands ends the kernel with a trap, not a hang
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n > (1u << 24)) __trap();
}
// box (x = column, y = row) of the tensor map into the panel at dst, completing on the mbarrier at bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(map), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// box (x = column, y = row, z = batch entry) of a batched tensor map, as tma_load_2d
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map, int x, int y, int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(map), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

// cuTensorMapEncodeTiled through the runtime's entry-point query, so the library needs no link to libcuda.
using TensorMapEncode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                     const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                     CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline cudaError_t tensor_map_encoder(TensorMapEncode* out) {
  static TensorMapEncode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<TensorMapEncode>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

// A tensor map of a row-major bf16 array (dims innermost first, strides in bytes) read in [64 x 64] boxes (one
// batch entry where there is a batch axis) into 128-byte-swizzled panels, zero-filling outside it.  The pointer
// must be 16-byte aligned and the row pitch a multiple of 16 bytes.
inline cudaError_t bf16_panel_map(CUtensorMap* map, const void* ptr, cuuint32_t rank, const cuuint64_t* dims,
                                  const cuuint64_t* strides) {
  TensorMapEncode encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint32_t box[3] = {PANEL, PANEL, 1}, step[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides, box,
                              step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A tensor map of a row-major bf16 matrix [rows, cols] (cols a multiple of 8)
inline cudaError_t panel_map(CUtensorMap* map, const void* ptr, int rows, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(Bf)};
  return bf16_panel_map(map, ptr, 2, dims, strides);
}

// A tensor map of a row-major bf16 array [batch, rows, cols] (cols a multiple of 8): a box holds rows of one batch
// entry only, and rows >= ``rows`` read as zeros, never as the next entry's
inline cudaError_t batched_panel_map(CUtensorMap* map, const void* ptr, int batch, int rows, int cols) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * sizeof(Bf), (cuuint64_t)rows * cols * sizeof(Bf)};
  return bf16_panel_map(map, ptr, 3, dims, strides);
}

// ---------------------------------------------------------------- panels
// rows x 64 bf16 of src (row-major, ``ld`` elements a row) from (r0, c0) into
// the swizzled panel at ``dst``; rows >= nr and columns >= nc read as 0.
// cp.async when every row starts 16-byte aligned, else a staged copy.
__device__ __forceinline__ void load_panel(uint32_t dst, int rows, const Bf* __restrict__ src, size_t ld, int aligned,
                                           size_t r0, long long nr, int c0, int nc, int tid, int nthr) {
  for (int e = tid; e < rows * 8; e += nthr) {
    const int r = e >> 3, ch = e & 7, c = ch * 8;
    const int n = r < nr ? min(max(nc - c, 0), 8) : 0;  // elements of this chunk inside src
    const Bf* s = src + (r0 + r) * ld + c0 + c;
    if (aligned) {
      cp_async16(dst + swz(r, ch), n ? static_cast<const void*>(s) : static_cast<const void*>(src), 2 * n);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t lo = 2 * k < n ? __bfloat16_as_ushort(s[2 * k]) : 0u;
        const uint32_t hi = 2 * k + 1 < n ? __bfloat16_as_ushort(s[2 * k + 1]) : 0u;
        w[k] = lo | hi << 16;
      }
      st_shared_v4(dst + swz(r, ch), w[0], w[1], w[2], w[3]);
    }
  }
}

inline int aligned16(const void* p, size_t ld) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && ld % 8 == 0;
}

}  // namespace wg
}  // namespace srt
