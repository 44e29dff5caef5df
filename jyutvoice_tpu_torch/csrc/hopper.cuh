// Hopper (sm_90a) building blocks of the attention kernels and of the
// ResBlock stage: shared-memory mbarriers with phase parity (and the
// transaction count of a bulk copy), the 1-D bulk copy (TMA without a tensor
// map) from global to shared memory, the async-proxy fence, a named barrier,
// wgmma descriptors for 128-byte-swizzled tiles, the m64nNk16 bf16 or fp16
// -> f32 and m64nNk8 tf32 -> f32 wgmma with A in registers (tf32: N up to
// 128; and the m64n64k8 tf32 one with A in shared memory), their fence /
// commit / wait, and setmaxnreg.
//
// Tile layout (`sw128_offset`): a bf16 tile of R rows x C columns (C a
// multiple of 64) is stored as C / 64 blocks of R rows x 128 bytes, block c
// at c * R * 128 bytes; inside a block the 16-byte chunk j of row r sits at
// chunk j ^ (r % 8), the pattern wgmma's 128-byte swizzle reads. Blocks start
// on 1024-byte boundaries. The same stored tile serves as a K-major operand
// (rows are the N dimension, columns the reduction: k^T of q.k^T) and as an
// MN-major one (rows are the reduction, columns N: v of p.v).
//
// wgmma's accumulator fragment (m64nNk16, f32): warp w of the warpgroup
// holds rows 16w + g and 16w + g + 8 (g = lane / 4, tg = lane % 4);
// d[4j], d[4j+1] are row 16w + g, columns 8j + 2tg and 8j + 2tg + 1, and
// d[4j+2], d[4j+3] the same columns of row 16w + g + 8. Its A register
// fragment for one 16-deep k-step holds, as packed bf16 (or fp16) pairs, a0 = row g,
// columns 2tg..2tg+1; a1 = row g + 8, the same columns; a2, a3 = rows g and
// g + 8, columns 2tg+8..2tg+9 (rows within the warp's 16). So the
// accumulator of columns 16kk..16kk+15, rounded to bf16 and packed in
// pairs, is the A operand of k-step kk of the next product.
//
// tf32 (m64nNk8): one k-step is 8 values = 32 bytes of a 128-byte row, so a
// K-major tf32 tile of N rows x 32 columns is the same swizzled image as a
// bf16 one of N rows x 64 columns, and the descriptor of k-step kk starts
// kk * 32 bytes into it. TF32 wgmma cannot transpose: B is always K-major.
// The A register fragment of warp w holds a0 = row 16w + g, column tg;
// a1 = row 16w + g + 8, column tg; a2, a3 = the same rows, column tg + 4,
// each a tf32 in a 32-bit register. The accumulator fragment is the one
// above, so the accumulator of columns 8kk..8kk+7 is the A fragment of an
// 8-deep k-step whose reduction order is permuted within the step to
// [0, 2, 4, 6, 1, 3, 5, 7] (a0, a1, a2, a3 = d[4kk], d[4kk+2], d[4kk+1],
// d[4kk+3]); the B tile of that product stores its K index in that order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace jv {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible before any thread uses them
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive and add `bytes` to the transaction count the current phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory by the TMA unit; its completion counts
// against `bar`'s transaction count
__device__ __forceinline__ void bulk_copy_g2s(void* smem_dst, const void* gmem_src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(smem_dst)),
      "l"(gmem_src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a barrier among `count` threads (a multiple of 32) on barrier `id` (1-15;
// 0 is __syncthreads')
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// wait until the phase with the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// orders this thread's generic-proxy shared-memory writes before later
// async-proxy (wgmma) reads of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the current device's SM count, read once (132 on the H100 SXM)
inline int num_sms() {
  static const int n = [] {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  }();
  return n;
}

// 2^x on the special-function unit (flush-to-zero; 2 ulp)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- register budget -----------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- swizzled tiles and wgmma descriptors --------------------------------

// byte offset of element (r, c) (c a multiple of 4: an 8-byte group) in a
// 128-byte-swizzled bf16 tile of `rows` rows
__device__ __forceinline__ uint32_t sw128_offset(int rows, int r, int c) {
  const int cc = c & 63;
  return (uint32_t)((c >> 6) * rows * 128 + r * 128 + (((cc >> 3) ^ (r & 7)) << 4) +
                    ((cc >> 2) & 1) * 8);
}

// a 128-byte-swizzle shared-memory matrix descriptor; lbo and sbo in bytes
// (K-major: sbo = 1024, the stride between 8-row groups, lbo unused;
// MN-major: lbo = stride between 64-column blocks, sbo = 1024 between
// 8-row groups of the reduction dimension)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t smem_addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// ---- wgmma ---------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across the
// asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// The operand lists of the m64nNk16 wgmma with A in registers: N / 2 f32
// accumulators, then the 4 A registers, desc_b, the accumulate flag and the
// transpose of B.
#define JV_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define JV_D32 JV_D8(0), JV_D8(8), JV_D8(16), JV_D8(24)
#define JV_D64 JV_D32, JV_D8(32), JV_D8(40), JV_D8(48), JV_D8(56)
#define JV_RS_IN "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), \
                 "n"(kTransB)
#define JV_WGMMA_N64(T)                                                                      \
  "{\n.reg .pred p;\n"                                                                       \
  "setp.ne.b32 p, %37, 0;\n"                                                                 \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." T "." T " "                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "       \
  "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
#define JV_WGMMA_N128(T)                                                                     \
  "{\n.reg .pred p;\n"                                                                       \
  "setp.ne.b32 p, %69, 0;\n"                                                                 \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." T "." T " "                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"         \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"         \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "       \
  "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"

// d (64 x 64) += a (64 x 16, registers) . b (16 x 64, shared memory via
// desc_b), operands bf16 or (kF16) fp16; the first k-step of a product
// passes accumulate = 0 to overwrite d
template <int kTransB, bool kF16>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  if constexpr (kF16)
    asm volatile(JV_WGMMA_N64("f16") : JV_D32 : JV_RS_IN);
  else
    asm volatile(JV_WGMMA_N64("bf16") : JV_D32 : JV_RS_IN);
}

// d (64 x 128) += a (64 x 16, registers) . b (16 x 128, shared memory via
// desc_b), operands bf16 or (kF16) fp16; the first k-step of a product
// passes accumulate = 0 to overwrite d
template <int kTransB, bool kF16>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int accumulate) {
  if constexpr (kF16)
    asm volatile(JV_WGMMA_N128("f16") : JV_D64 : JV_RS_IN);
  else
    asm volatile(JV_WGMMA_N128("bf16") : JV_D64 : JV_RS_IN);
}

#undef JV_D8
#undef JV_D32
#undef JV_D64
#undef JV_RS_IN
#undef JV_WGMMA_N64
#undef JV_WGMMA_N128

template <int N, int kTransB, bool kF16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  if constexpr (N == 64)
    wgmma_m64n64k16_rs<kTransB, kF16>(d, a, desc_b, accumulate);
  else
    wgmma_m64n128k16_rs<kTransB, kF16>(d, a, desc_b, accumulate);
}

// ---- tf32 wgmma: d (64 x N) += a (64 x 8, registers) . b (8 x N, K-major
// shared memory via desc_b); accumulate = 0 overwrites d ----------------------

__device__ __forceinline__ void wgmma_m64n8k8_tf32_rs(float (&d)[4], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3"
      "}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n16k8_tf32_rs(float (&d)[8], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n32k8_tf32_rs(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64 || N == 128,
                "wgmma_tf32_rs: N is 8, 16, 32, 64 or 128");
  if constexpr (N == 8)
    wgmma_m64n8k8_tf32_rs(d, a, desc_b, accumulate);
  else if constexpr (N == 16)
    wgmma_m64n16k8_tf32_rs(d, a, desc_b, accumulate);
  else if constexpr (N == 32)
    wgmma_m64n32k8_tf32_rs(d, a, desc_b, accumulate);
  else if constexpr (N == 64)
    wgmma_m64n64k8_tf32_rs(d, a, desc_b, accumulate);
  else
    wgmma_m64n128k8_tf32_rs(d, a, desc_b, accumulate);
}

// d (64 x 64) += a (64 x 8) . b (8 x 64), both K-major tf32 tiles in shared
// memory (desc_a, desc_b); accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n64k8_tf32_ss(float (&d)[32], uint64_t desc_a,
                                                       uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

}  // namespace jv
