// Hopper (sm_90a) building blocks for the port's kernels, as inline PTX:
// mbarriers, TMA tile loads, wgmma shared-memory descriptors and the
// wgmma.mma_async products the flash-attention kernels use, and on the host
// the tensor maps their TMA loads read. Kept to plain functions (no CuTe)
// so a source that includes it builds in seconds.
//
// Shared-memory tiles are written by TMA with the 128-byte swizzle: a box
// is 64 16-bit values (128 bytes) wide, row r of a box lies at byte r * 128,
// and its 16-byte chunk c at chunk c ^ (r % 8). A tile wider than 64
// values is several boxes, one after the other. Every box starts on a
// 1024-byte boundary, so the swizzle pattern (which the hardware derives
// from address bits 4-9) lines up with the rows of the box.
//
// wgmma accumulator layout (m64nNk16, f32): warp w of the warpgroup owns
// rows [16 w, 16 w + 16); with g = lane / 4 and t = lane % 4, register
// 4 j + e holds row 16 w + g + 8 (e >> 1), column 8 j + 2 t + (e & 1) --
// the C fragment of mma.m16n8k16 repeated over the N / 8 column chunks. The
// A operand from registers (16-bit, m64k16) is mma.m16n8k16's A fragment
// of the warp's 16 rows, so an accumulator re-packs in registers as the A
// operand of the next product: with pa[2 j] = (r[4 j], r[4 j + 1]) and
// pa[2 j + 1] = (r[4 j + 2], r[4 j + 3]) rounded to 16 bits, the A operand
// of k step kk (columns 16 kk .. 16 kk + 15) is pa[4 kk .. 4 kk + 3].
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// one arrival that also announces `bytes` of TMA transactions: the phase
// completes when they have landed
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// spin until the phase of parity `parity` has completed. A freshly
// initialised barrier is in phase 0, and the phase before it (parity 1)
// counts as completed, so a producer's first wait on parity 1 passes.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// ---- TMA -----------------------------------------------------------------

// the box at coordinates (c0 innermost, c1, c2) of a 3-D tensor map into
// shared memory at `dst`; completion is counted in bytes on `bar`.
// Elements outside the tensor read as zero and still count.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory; completion counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand starting
// at byte `addr`:
//   bits  0-13 start address >> 4
//   bits 16-29 leading byte offset >> 4
//   bits 32-45 stride byte offset >> 4
//   bits 62-63 layout: 1 = 128-byte swizzle
// K-major (the reduction dim contiguous, 64 values a 128-byte row): the
// stride byte offset is 1024, from one 8-row group to the next; the
// leading offset is unused. A k16 step inside the 64-wide box adds 32 bytes
// to the start address. MN-major (the output dim contiguous): the stride
// byte offset is again 1024, from one group of 8 reduction rows to the
// next, and the leading byte offset is the distance from one 64-wide box
// of the output dim to the next.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr,
                                               uint32_t lead_bytes) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lead_bytes >> 4) & 0x3FFF) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wait: each register passes through an
// empty volatile asm, which stays in order with the wgmma asm statements.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define HOPPER_F8(d, i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_F32(d) \
  HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16), HOPPER_F8(d, 24)
#define HOPPER_F64(d)                                                     \
  HOPPER_F32(d), HOPPER_F8(d, 32), HOPPER_F8(d, 40), HOPPER_F8(d, 48),    \
      HOPPER_F8(d, 56)
#define HOPPER_R32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"  \
  "%30, %31}"
#define HOPPER_R64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x N, f32) = (accumulate ? d : 0) + A B, A (64 x 16) and B
// (16 x N) both K-major in shared memory; N = 128 or 64, told apart by
// the accumulator's size (N / 2 registers a thread). TY: bf16 or f16.
#define HOPPER_SS_N128(TY)                                                \
  asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "       \
      HOPPER_R64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"                         \
      : HOPPER_F64(d)                                                    \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate))
#define HOPPER_SS_N64(TY)                                                 \
  asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "        \
      HOPPER_R32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"                         \
      : HOPPER_F32(d)                                                    \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate))

template <bool BF16>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  if constexpr (BF16) HOPPER_SS_N128("bf16");
  else HOPPER_SS_N128("f16");
}

template <bool BF16>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  if constexpr (BF16) HOPPER_SS_N64("bf16");
  else HOPPER_SS_N64("f16");
}

// d (64 x N, f32) += A B: A (64 x 16) from registers (four 32-bit
// registers a thread, 16-bit pairs), B (16 x N) MN-major in shared memory
// (the transpose bit set). TY: bf16 or f16.
#define HOPPER_RS_N128(TY)                                                \
  asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "       \
      HOPPER_R64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"          \
      : HOPPER_F64(d)                                                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))
#define HOPPER_RS_N64(TY)                                                 \
  asm volatile(                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "        \
      HOPPER_R32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"          \
      : HOPPER_F32(d)                                                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

template <bool BF16>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (BF16) HOPPER_RS_N128("bf16");
  else HOPPER_RS_N128("f16");
}

template <bool BF16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (BF16) HOPPER_RS_N64("bf16");
  else HOPPER_RS_N64("f16");
}

// ---- host side: tensor maps ----------------------------------------------

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so the
// library needs no link against libcuda
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a (heads, rows, d) tensor of 16-bit values as 128-byte-swizzled boxes of
// 64 x box_rows x 1; rows past `rows` of a head read as zero
inline bool encode_map(CUtensorMap* map, const void* ptr, int d, int rows,
                       int heads, int box_rows, bool bf16) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(d), cuuint64_t(rows),
                              cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(d) * 2,
                                 cuuint64_t(d) * 2 * cuuint64_t(rows)};
  const cuuint32_t box[3] = {64, cuuint32_t(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map,
            bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
            3, const_cast<void*>(ptr), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int MAX_DEVICES = 64;

// raise `kernel`'s dynamic shared-memory limit to `smem` bytes on `device`,
// once: `raised` is the caller's record, per kernel, of the devices done
template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, uint32_t smem,
                       bool (&raised)[MAX_DEVICES], int device) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (raised[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err == cudaSuccess) raised[device] = true;
  return err;
}

}  // namespace hopper
