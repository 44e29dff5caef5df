// The int8 linear of the quantized estimator (`nn/quant.py::_linear_q`) in
// two kernels: a one-pass row quantization and an int8 GEMM whose epilogue
// applies both scales and the bias.
//
// Replaces no TPU kernel: the JAX package leaves this product to plain XLA
// (`jyutvoice_tpu/nn/quant.py::linear_q`), and the port's plain version is
// the composition `quantize_rows`, `int8_matmul` (torch._int_mm) and the f32
// epilogue: 13 passes over device memory for a bias-free linear, 14 with a
// bias. Both kernels compute exactly what that composition computes, bit for
// bit:
//   sx  = max(max|x| / 127, 1e-12) per row (an IEEE division),
//   x_q = clamp(rint(x / sx), -127, 127) (IEEE division, half to even),
//   y   = ((float(x_q . w_q) * sx) * scale) + b, each step rounded on its
//         own (__fmul_rn / __fadd_rn: no FMA contraction).
// The int32 sums are exact, and below 2^24 for K <= 1024, so their f32
// conversion is exact too.
//
// What bounds it on the H100: bytes. At the serving shapes (M = 49152 rows,
// K and N in 256-1024) a linear needs x read once in f32 and y written once
// in f32: 3.8 KB a row on average over the estimator's six linears, 0.055 ms
// a call at 3.35 TB/s, against about 0.007 ms of int8 products at 1979
// TOP/s. The design keeps every intermediate but x_q and sx out of device
// memory; their round trip adds 0.9 KB a row (0.013 ms a call):
//
// 1. `jv_int8_quant_rows`: one warp per row (K <= 1024 f32), read once with
//    16-byte loads and held in registers; the row's max is reduced with
//    shuffles, and the warp writes its x_q row as 4-byte stores and its sx.
//    x's rows may be a strided view (a row stride, unit inner stride).
// 2. `jv_int8_gemm`: a persistent warp-specialised wgmma GEMM. Both operands
//    are K-major, as 8-bit wgmma requires: x_q (M, K) row-major and w_q
//    (N, K), the module's own buffer. One producer thread keeps a ring of
//    NSTAGE stages filled by TMA (tensor maps with the 128-byte swizzle,
//    zero-filled past M, N and K), 128 k-bytes of a 128-row A tile and a
//    64-row B tile per stage, under `full` / `empty` mbarriers; two consumer
//    warpgroups of 64 rows each run m64n64k32 s8.s8 -> s32 wgmma out of the
//    stages, keep the int32 sums in registers and write f32 y straight from
//    them in the epilogue. The grid is one block per SM walking the output
//    tiles, so the producer loads the next tile while the consumers store
//    this one: the kernel is bound by the f32 writes. One tile shape, 128 x
//    64, serves every M and N: at the serving shapes a width of 128 took
//    0.379 ms over the six linears of a block against 64's 0.375, and was
//    slower at small M; 256 was slower still, and two consumers on separate
//    tiles, each with its own ring, were no faster.
//
// Tensor maps: `tma.cuh`, encoded for every launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace jv {
namespace i8 {

constexpr int kMaxK = 1024;                // the quantization holds a row in registers
constexpr int kRowsPerBlock = 8;           // quantization: a warp per row
constexpr int kMaxVec = kMaxK / 4 / 32;    // float4 per lane at the widest row
constexpr int BM = 128;                    // GEMM tile rows: two consumer warpgroups
constexpr int BN = 64;                     // GEMM tile columns
constexpr int BK = 128;                    // int8 k-values per stage: one swizzled row
constexpr int NSTAGE = 4;
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;

// ---- 1. row quantization --------------------------------------------------

__device__ __forceinline__ signed char quantize(float v, float s) {
  const float t = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<signed char>(__float2int_rz(t));
}

__global__ void __launch_bounds__(kRowsPerBlock * 32)
int8_quant_rows(const float* __restrict__ x, long long ldx, int8_t* __restrict__ xq,
                float* __restrict__ sx, int M, int K) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= M) return;
  const float4* src = reinterpret_cast<const float4*>(x + row * ldx);
  const int nv = K >> 2;
  float4 v[kMaxVec];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int c = lane + 32 * i;
    if (c < nv) {
      v[i] = __ldg(src + c);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[i].x), fabsf(v[i].y)),
                               fmaxf(fabsf(v[i].z), fabsf(v[i].w))));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, o));
  const float s = fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
  if (lane == 0) sx[row] = s;
  char4* dst = reinterpret_cast<char4*>(xq + row * K);
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int c = lane + 32 * i;
    if (c < nv)
      dst[c] = make_char4(quantize(v[i].x, s), quantize(v[i].y, s), quantize(v[i].z, s),
                          quantize(v[i].w, s));
  }
}

// ---- 2. the GEMM: wgmma s8.s8 -> s32, both operands K-major in shared
// memory (128-byte swizzle), d (64 x 64) = a (64 x 32) . b (32 x 64) (+ d) ----

#define JV_R8(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
                 "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

__device__ __forceinline__ void wgmma_m64n64k32_s8(uint32_t (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : JV_R8(0), JV_R8(8), JV_R8(16), JV_R8(24)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#undef JV_R8

// keeps the compiler from moving the accumulators across the asynchronous
// wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_acc(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// shared memory: NSTAGE stages of a 128-row A tile and a 64-row B tile,
// then the barriers
constexpr int kTileA = BM * BK;
constexpr int kStage = kTileA + BN * BK;
constexpr int kBarOff = NSTAGE * kStage;
constexpr size_t kSmem = kBarOff + 2 * NSTAGE * 8 + 1024;  // + alignment slack

struct GemmArgs {
  const float* sx;     // (M,) row scales
  const float* scale;  // (N,) column scales
  const float* bias;   // (N,) or null
  float* y;            // (M, N) contiguous
  int M, N, K;
  int n_tiles;         // column tiles
  int tiles;           // row tiles x column tiles
};

// y rows r0 and r0 + 8 of this thread, from its accumulator fragment: d[4j],
// d[4j + 1] are row r0, columns 8j + 2tg and 8j + 2tg + 1 of the tile,
// d[4j + 2], d[4j + 3] the same columns of row r0 + 8
__device__ __forceinline__ void epilogue(const GemmArgs& p, const uint32_t (&d)[BN / 2], int r0,
                                         int n0, int tg) {
  const int r1 = r0 + 8;
  const float s0 = r0 < p.M ? __ldg(p.sx + r0) : 0.f;
  const float s1 = r1 < p.M ? __ldg(p.sx + r1) : 0.f;
  float* y0 = p.y + (long long)r0 * p.N;
  float* y1 = p.y + (long long)r1 * p.N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * tg;
    if (col >= p.N) continue;  // N is a multiple of 8, so col + 1 < N too
    const float2 sc = __ldg(reinterpret_cast<const float2*>(p.scale + col));
    float2 a = make_float2(
        __fmul_rn(__fmul_rn(__int2float_rn((int)d[4 * j]), s0), sc.x),
        __fmul_rn(__fmul_rn(__int2float_rn((int)d[4 * j + 1]), s0), sc.y));
    float2 b = make_float2(
        __fmul_rn(__fmul_rn(__int2float_rn((int)d[4 * j + 2]), s1), sc.x),
        __fmul_rn(__fmul_rn(__int2float_rn((int)d[4 * j + 3]), s1), sc.y));
    if (p.bias != nullptr) {
      const float2 bi = __ldg(reinterpret_cast<const float2*>(p.bias + col));
      a = make_float2(__fadd_rn(a.x, bi.x), __fadd_rn(a.y, bi.y));
      b = make_float2(__fadd_rn(b.x, bi.x), __fadd_rn(b.y, bi.y));
    }
    if (r0 < p.M) *reinterpret_cast<float2*>(y0 + col) = a;
    if (r1 < p.M) *reinterpret_cast<float2*>(y1 + col) = b;
  }
}

// Block b walks the output tiles b, b + grid, ...; tile t covers rows
// (t / n_tiles) * BM and columns (t % n_tiles) * BN, so the blocks in flight
// share A rows and every B tile stays in L2. A tile takes nk = ceil(K / BK)
// stages; the ring's position `it` runs on across tiles: stage it % NSTAGE,
// pass it / NSTAGE, whose parity the barriers wait on.
__global__ void __launch_bounds__(kThreads, 1)
int8_gemm_sm90(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b, const GemmArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + NSTAGE;
  const int nk = (p.K + BK - 1) / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);                  // the producer's arrive, plus the bytes
      mbar_init(&empty[s], kConsumers * 128);  // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // the producer: one thread issues every copy; 128 x 40 + 256 x 232
    // registers fit the SM's 65536
    setmaxnreg_dec<40>();
    if (threadIdx.x != kConsumers * 128) return;
    int it = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int m0 = (t / p.n_tiles) * BM, n0 = (t % p.n_tiles) * BN;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % NSTAGE;
        mbar_wait(&empty[s], ((it / NSTAGE) & 1) ^ 1);
        uint8_t* stage = smem + s * kStage;
        mbar_arrive_expect_tx(&full[s], kStage);
        tma_load_2d(stage, &map_a, kb * BK, m0, &full[s]);
        tma_load_2d(stage + kTileA, &map_b, kb * BK, n0, &full[s]);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int ct = threadIdx.x % 128;
    const int warp = ct / 32, lane = ct % 32;
    const int g = lane / 4, tg = lane % 4;
    uint32_t d[BN / 2];
    int it = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int m0 = (t / p.n_tiles) * BM, n0 = (t % p.n_tiles) * BN;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % NSTAGE;
        mbar_wait(&full[s], (it / NSTAGE) & 1);
        // this warpgroup's 64 rows of the A tile start 64 x 128 bytes in, on
        // a 1024-byte boundary; k-step kk of 32 bytes starts kk * 32 bytes
        // into each swizzled row
        const uint32_t a_addr = smem_u32(smem + s * kStage) + wg * 64 * BK;
        const uint32_t b_addr = smem_u32(smem + s * kStage + kTileA);
        fence_acc(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_m64n64k32_s8(d, sw128_desc(a_addr + kk * 32, 16, 1024),
                             sw128_desc(b_addr + kk * 32, 16, 1024), kb > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(d);
        mbar_arrive(&empty[s]);
      }
      epilogue(p, d, m0 + wg * 64 + warp * 16 + g, n0, tg);
    }
  }
}

// ---- host side --------------------------------------------------------------

// a (rows, K) int8 row-major matrix read in boxes of `box_rows` rows x BK
// bytes, swizzled for wgmma; reads past the matrix fill zeros
inline bool encode(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, rows, K, box_rows, BK);
}

// the shared-memory attribute is set once (the first launch), not on every
// launch
cudaError_t launch_gemm(const CUtensorMap& a, const CUtensorMap& b, const GemmArgs& p,
                        cudaStream_t stream) {
  static_assert(kSmem <= 232448, "shared memory over the H100's 227 KB per block");
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_gemm_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (attr != cudaSuccess) return attr;
  const int grid = p.tiles < num_sms() ? p.tiles : num_sms();
  int8_gemm_sm90<<<grid, kThreads, kSmem, stream>>>(a, b, p);
  return cudaGetLastError();
}

}  // namespace i8
}  // namespace jv

// x (M, K) f32 rows at a stride of ldx floats (unit inner stride, 16-byte
// aligned) -> xq (M, K) int8 contiguous, sx (M,) f32
extern "C" int jv_int8_quant_rows(const float* x, long long ldx, int8_t* xq, float* sx, int M,
                                  int K, void* stream) {
  using namespace jv::i8;
  if (M <= 0 || K <= 0 || K > kMaxK || K % 16 || ldx < K || ldx % 4)
    return (int)cudaErrorInvalidValue;
  const int blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  int8_quant_rows<<<blocks, kRowsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      x, ldx, xq, sx, M, K);
  return (int)cudaGetLastError();
}

// y (M, N) f32 = ((float(xq . w^T) * sx[row]) * scale[col]) + bias[col];
// xq (M, K) and w (N, K) int8 row-major (16-byte aligned), bias may be null
extern "C" int jv_int8_gemm(const int8_t* xq, const int8_t* w, const float* sx,
                            const float* scale, const float* bias, float* y, int M, int N, int K,
                            void* stream) {
  using namespace jv::i8;
  if (M <= 0 || N <= 0 || N % 8 || K <= 0 || K % 16) return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!encode(&map_a, xq, M, K, BM) || !encode(&map_b, w, N, K, BN))
    return (int)cudaErrorInvalidValue;
  GemmArgs p{sx, scale, bias, y, M, N, K, (N + BN - 1) / BN, 0};
  p.tiles = ((M + BM - 1) / BM) * p.n_tiles;
  return (int)launch_gemm(map_a, map_b, p, static_cast<cudaStream_t>(stream));
}
