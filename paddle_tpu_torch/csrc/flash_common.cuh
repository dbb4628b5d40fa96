// Pieces of the flash-attention kernels that the forward
// (flash_attention_fwd.cu) and the backward (flash_attention_bwd.cu) share:
// the element types, 16-bit packing and NEG_INF / LOG2E. The Hopper
// building blocks (TMA, mbarriers, wgmma) are in hopper_common.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

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

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace flash
