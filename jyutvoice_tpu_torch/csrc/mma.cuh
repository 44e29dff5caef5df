// Shared pieces of the stock-flash kernels (forward and backward): the
// tf32 tensor-core products of mma.sync and their fragment loads (kernels 4
// and 5), bf16 packing, and cp.async.
//
// Fragment layouts of m16n8k8 tf32 (g = lane / 4, tg = lane % 4):
//   A (16x8, row):  a0 = A[g][tg], a1 = A[g+8][tg], a2 = A[g][tg+4], a3 = A[g+8][tg+4]
//   B (8x8, col):   b0 = B[tg][g], b1 = B[tg+4][g]
//   C (16x8):       c0, c1 = C[g][2tg..2tg+1], c2, c3 = C[g+8][2tg..2tg+1]
// So one C fragment is the tf32 A fragment of an 8-deep k-step whose k
// order is permuted (slot tg holds column 2tg, slot tg + 4 column 2tg + 1;
// the B operand reads its rows in that order).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
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

// f32 -> tf32 (10 mantissa bits), rounded to nearest, as a 32-bit pattern
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// c += a . b for one 16x8 tile, a 16x8 (row), b 8x8 (col), tf32 -> f32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the tf32 A fragments of rows r and r + 8 of a row-major f32 matrix, all of
// D (row pitch `ld` floats)
template <int D>
__device__ __forceinline__ void load_a_rows_tf32(uint32_t (&f)[D / 8][4], const float* base,
                                                 long long ld, int r, int tg) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int c = kk * 8 + tg;
    f[kk][0] = to_tf32(base[r * ld + c]);
    f[kk][1] = to_tf32(base[(r + 8) * ld + c]);
    f[kk][2] = to_tf32(base[r * ld + c + 4]);
    f[kk][3] = to_tf32(base[(r + 8) * ld + c + 4]);
  }
}

// a C fragment as the tf32 A fragment of a k-permuted 8-deep k-step
__device__ __forceinline__ void c_to_a_tf32(uint32_t (&a)[4], const float (&c)[4]) {
  a[0] = to_tf32(c[0]);
  a[1] = to_tf32(c[2]);
  a[2] = to_tf32(c[1]);
  a[3] = to_tf32(c[3]);
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
