// Pieces of the flash-attention kernels: the element types, 16-bit
// packing and NEG_INF / LOG2E, which the forward (flash_attention_fwd.cu)
// and the backward (flash_attention_bwd.cu) share; the backward's tile
// constants, 16-byte tile loader and mma.sync.m16n8k16 fragment helpers.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a[0] = A[g][2t..2t+1],   a[1] = A[g+8][2t..2t+1],
//                         a[2] = A[g][2t+8..2t+9], a[3] = A[g+8][2t+8..2t+9]
//   B (16x8, "col"):      b[0] = B[2t..2t+1][g],   b[1] = B[2t+8..2t+9][g]
//   C (16x8, f32):        c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..2t+1]
// Two neighbouring C tiles (columns 0-7 and 8-15) hold exactly the values of
// one A fragment over those 16 columns, so a product's accumulator is
// re-packed in registers as the A operand of the next product (the FA-2
// register trick): `pack_a`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int BLOCK_M = 64;   // rows of a tile: 4 warps x 16 rows
constexpr int BLOCK_N = 64;   // keys per tile
constexpr int THREADS = 128;
constexpr int PAD = 8;        // elements of padding per shared-memory row
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <bool BF16> struct Elem;
template <> struct Elem<true> { using T = __nv_bfloat16; };
template <> struct Elem<false> { using T = __half; };

template <bool BF16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (BF16) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

// two neighbouring 16-bit values (lo at the lower address) as f32
template <bool BF16>
__device__ __forceinline__ float2 unpack2(uint32_t bits) {
  if constexpr (BF16) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&bits));
  } else {
    return __half22float2(*reinterpret_cast<__half2*>(&bits));
  }
}

// c += a * b for one 16x8x16 tile; a: 16x16 row-major, b: 16x8 col-major.
template <bool BF16>
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  if constexpr (BF16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld16x2(const void* lo, const void* hi) {
  return uint32_t(*reinterpret_cast<const uint16_t*>(lo)) |
         (uint32_t(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

// A fragment of rows [0, 16) x columns [16 kc, 16 kc + 16) of a row-major
// shared-memory tile `w` with row pitch LD.
template <int LD, typename T>
__device__ __forceinline__ void load_a(uint32_t a[4], const T* w, int kc,
                                       int g, int t) {
  a[0] = ld32(w + g * LD + kc * 16 + 2 * t);
  a[1] = ld32(w + (g + 8) * LD + kc * 16 + 2 * t);
  a[2] = ld32(w + g * LD + kc * 16 + 2 * t + 8);
  a[3] = ld32(w + (g + 8) * LD + kc * 16 + 2 * t + 8);
}

// B fragment for a product X * Y^T: Y (rows = the product's columns) is
// row-major in shared memory; this is columns [8 nt, 8 nt + 8) x depth
// [16 kc, 16 kc + 16).
template <int LD, typename T>
__device__ __forceinline__ void load_b_t(uint32_t b[2], const T* y, int nt,
                                         int kc, int g, int t) {
  const T* r = y + (nt * 8 + g) * LD + kc * 16 + 2 * t;
  b[0] = ld32(r);
  b[1] = ld32(r + 8);
}

// B fragment for a product X * Y: Y (rows = the depth) is row-major in
// shared memory; this is depth [16 kc, 16 kc + 16) x columns
// [8 dt, 8 dt + 8), assembled from 16-bit loads.
template <int LD, typename T>
__device__ __forceinline__ void load_b(uint32_t b[2], const T* y, int kc,
                                       int dt, int g, int t) {
  const T* p = y + (kc * 16 + 2 * t) * LD + dt * 8 + g;
  b[0] = ld16x2(p, p + LD);
  b[1] = ld16x2(p + 8 * LD, p + 9 * LD);
}

// The A fragment over columns [16 kc, 16 kc + 16) of a 16-row f32
// accumulator held as 8-column C tiles c[..][4], rounded to the input dtype.
template <bool BF16>
__device__ __forceinline__ void pack_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
  a[0] = pack2<BF16>(c0[0], c0[1]);
  a[1] = pack2<BF16>(c0[2], c0[3]);
  a[2] = pack2<BF16>(c1[0], c1[1]);
  a[3] = pack2<BF16>(c1[2], c1[3]);
}

// rows [row0, row0 + 64) of a (rows, D) matrix into shared memory; rows at
// or past `rows` are zero-filled. 16-byte loads and stores.
template <int D, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int rows) {
  constexpr int LD = D + PAD;
  constexpr int CHUNKS = D / 8;
  for (int idx = threadIdx.x; idx < BLOCK_M * CHUNKS; idx += THREADS) {
    int r = idx / CHUNKS, c = idx % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + size_t(row0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

}  // namespace flash
