// Shared pieces of the attention kernels: constants, the strides of a
// (B, T, H, D) view, bf16 and fp16 packing, and cp.async.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace jv {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 x = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// two f32 values rounded to fp16 (kF16) or bf16 and packed, lo in the low half
template <bool kF16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kF16)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace jv
