// The DiT's block linears (`models/dit.py`: q/k/v, out, ff_in, ff_out) on
// the H100's tensor cores at f32 accuracy: y = x W^T + b in 3xTF32 wgmma.
//
// Replaces no TPU kernel and no JAX computation: the DiT exists only in the
// port (its plain reference is `tests/reference_dit.py`). Before this kernel
// cuBLAS ran these products as its f32 SIMT GEMM (FFMA on the CUDA cores),
// whose ceiling is f32's 67 TFLOP/s.
// The port's plain version, `nn/f32_gemm.py::linear_plain`, repeats this
// kernel's arithmetic with three f32 products.
//
// What bounds it on the H100: operations. At the DiT cell's shapes (about
// 28,500 packed rows, K 1024 or 2048, N 1024-3072) a linear does 60-180
// GFLOP against a few hundred MB of x and y: three TF32 products per product
// on the tensor cores' 495 TFLOP/s give 165 TFLOP/s of f32 work.
// What the design does about it:
// 1. 3xTF32. Each f32 a is split into hi = a rounded to the nearest tf32
//    (ties away from zero) and lo = a - hi rounded the same way, so hi + lo
//    is within 2^-22 of a (`split`; kernel 2 cuts lo, within 2^-21); the
//    product a b is lo_a hi_b + hi_a lo_b + hi_a hi_b, each exact in f32,
//    dropping lo_a lo_b (2^-22).
//    A (x, K-major rows of f32) is split in registers from its tile in
//    shared memory; B is prepared once per model (`prepare_weight`): the
//    (2N, K) f32 image of W's hi rows, then its lo rows, K-major as tf32
//    wgmma needs both operands.
// 2. Rounding toward zero. The tensor cores round their f32 sums toward
//    zero; hundreds of such roundings into one accumulator bias it by ~3e-5
//    of itself (kernel 2's finding, `resblock_stage.cu`). So each 32-deep
//    k-tile's twelve m64n128k8 products (4 k-steps x 3) start from zero and
//    are added into f32 sums on the CUDA cores (`__fadd_rn`), kernel 2's
//    rule of at most 12 roundings; and the k-tile's eight small products
//    (lo.hi, hi.lo) come first, then its four hi.hi ones, so only four of
//    the twelve roundings are at the scale of the k-tile's sum. Small
//    terms after large ones left the kernel's error at twice cuBLAS's on a
//    single row and shrank products of one sign by 3 * 2^-24 of themselves
//    (measured on an H100).
// 3. The Hopper GEMM shape: a persistent grid (one block per SM) walks the
//    128 x 128 output tiles, rows outer, so the blocks in flight share x's
//    rows and every W tile stays in L2; one producer thread keeps a ring of
//    NSTAGE stages filled by TMA (tensor maps with the 128-byte swizzle, x
//    zero-filled past M), each a 128 x 32 f32 tile of x and the 128 x 32 hi
//    and lo tiles of W (48 KB), under `full` / `empty` mbarriers; two
//    consumer warpgroups of 64 rows each load their A fragments from the
//    swizzled x tile (conflict-free 4-byte loads), split them, and run the
//    wgmmas of each 8-deep k-step with the next step's fragment loaded
//    while the last one's are in flight; setmaxnreg gives the producer's
//    registers to the consumers (64 accumulators and 64 sums a thread). The
//    bias is added in the epilogue, which writes f32 y straight from the
//    sums, rows past M not stored, while the producer loads the next tile.
// Tensor maps: `tma.cuh`.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace jv {
namespace f32g {

constexpr int BM = 128;  // tile rows: two consumer warpgroups of 64
constexpr int BN = 128;  // tile columns: one m64n128k8 product
constexpr int BK = 32;   // f32 k-values per stage: one 128-byte swizzled row
constexpr int KSTEPS = BK / 8;  // 8-deep tf32 wgmma k-steps per stage
constexpr int NSTAGE = 4;
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert((kProducerRegs + kConsumers * kConsumerRegs) * 128 <= 65536,
              "setmaxnreg asks for more registers than the block holds");

// shared memory: NSTAGE stages of the x tile and W's hi and lo tiles, then
// the barriers
constexpr int kTileA = BM * BK * 4;
constexpr int kTileB = BN * BK * 4;
constexpr int kStage = kTileA + 2 * kTileB;
constexpr int kBarOff = NSTAGE * kStage;
constexpr size_t kSmem = kBarOff + 2 * NSTAGE * 8 + 1024;  // + alignment slack

// the largest f32 that rounds to a finite tf32 (0x7F7FEFFF): larger
// magnitudes take the largest finite tf32 as hi
constexpr float kSplitMax = 0x1.ffdffep+127f;

// hi = a rounded to the nearest tf32, ties away from zero (as cvt.rna
// rounds), lo = a - hi (exact in f32) rounded the same way: kernel 2's
// `split_tf32` with lo rounded rather than cut, and the clamp that keeps hi
// finite for a finite a. Integer and FADD / FMNMX instructions only.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  const float c = fminf(fmaxf(a, -kSplitMax), kSplitMax);
  hi = (__float_as_uint(c) + 0x1000u) & 0xFFFFE000u;
  lo = (__float_as_uint(a - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}

struct GemmArgs {
  const float* bias;  // (N,) or null
  float* y;           // (M, N) contiguous
  int M, N, K;
  int n_tiles;        // column tiles
  int tiles;          // row tiles x column tiles
};

// y rows r0 and r0 + 8 of this thread from its sums: s[4j], s[4j + 1] are
// row r0, columns 8j + 2tg and 8j + 2tg + 1 of the tile, s[4j + 2],
// s[4j + 3] the same columns of row r0 + 8
__device__ __forceinline__ void epilogue(const GemmArgs& p, const float (&s)[BN / 2], int r0,
                                         int n0, int tg) {
  const int r1 = r0 + 8;
  float* y0 = p.y + (long long)r0 * p.N;
  float* y1 = p.y + (long long)r1 * p.N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * tg;
    float2 a = make_float2(s[4 * j], s[4 * j + 1]);
    float2 b = make_float2(s[4 * j + 2], s[4 * j + 3]);
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
// (t / n_tiles) * BM and columns (t % n_tiles) * BN. A tile takes K / BK
// stages; the ring's position `it` runs on across tiles: stage it % NSTAGE,
// pass it / NSTAGE, whose parity the barriers wait on.
__global__ void __launch_bounds__(kThreads, 1)
f32_gemm_sm90(const __grid_constant__ CUtensorMap map_x,
              const __grid_constant__ CUtensorMap map_w, const GemmArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + NSTAGE;
  const int nk = p.K / BK;

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
    // the producer: one thread issues every copy
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != kConsumers * 128) return;
    int it = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int m0 = (t / p.n_tiles) * BM, n0 = (t % p.n_tiles) * BN;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % NSTAGE;
        mbar_wait(&empty[s], ((it / NSTAGE) & 1) ^ 1);
        uint8_t* stage = smem + s * kStage;
        mbar_arrive_expect_tx(&full[s], kStage);
        tma_load_2d(stage, &map_x, kb * BK, m0, &full[s]);
        tma_load_2d(stage + kTileA, &map_w, kb * BK, n0, &full[s]);           // hi
        tma_load_2d(stage + kTileA + kTileB, &map_w, kb * BK, p.N + n0, &full[s]);  // lo
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int ct = threadIdx.x % 128;
    const int warp = ct / 32, lane = ct % 32;
    const int g = lane / 4, tg = lane % 4;
    // this thread's A fragment rows in the x tile, r0 and r0 + 8 (both
    // r % 8 == g): k-step kk's columns 8kk + tg and 8kk + tg + 4 lie in the
    // 16-byte chunks 2kk and 2kk + 1 of a row, stored at chunk c ^ g
    const int r0 = wg * 64 + warp * 16 + g;
    const uint32_t row0 = r0 * 128 + tg * 4, row1 = row0 + 8 * 128;
    float acc[BN / 2], sum[BN / 2];
    uint32_t ah[2][4], al[2][4];  // A fragments, double-buffered over k-steps
    float v[4];                   // the next k-step's x values
    int it = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int m0 = (t / p.n_tiles) * BM, n0 = (t % p.n_tiles) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sum[i] = 0.f;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % NSTAGE;
        mbar_wait(&full[s], (it / NSTAGE) & 1);
        const uint8_t* xs = smem + s * kStage;
        const uint32_t b_hi = smem_u32(xs + kTileA);
        const uint32_t b_lo = b_hi + kTileB;
        auto load = [&](int kk) {
          const uint32_t c0 = ((2 * kk) ^ g) * 16, c1 = ((2 * kk + 1) ^ g) * 16;
          v[0] = *reinterpret_cast<const float*>(xs + row0 + c0);
          v[1] = *reinterpret_cast<const float*>(xs + row1 + c0);
          v[2] = *reinterpret_cast<const float*>(xs + row0 + c1);
          v[3] = *reinterpret_cast<const float*>(xs + row1 + c1);
        };
        // two passes over the k-tile's k-steps: lo.hi and hi.lo from zero,
        // then hi.hi into their sum (the x values loaded and split again)
        load(0);
#pragma unroll
        for (int j = 0; j < 2 * KSTEPS; ++j) {
          const int kk = j % KSTEPS, buf = j & 1;
          const bool small = j < KSTEPS;
#pragma unroll
          for (int e = 0; e < 4; ++e) split(v[e], ah[buf][e], al[buf][e]);
          if (j + 1 < 2 * KSTEPS) load((j + 1) % KSTEPS);
          fence_regs(ah);
          if (small) fence_regs(al);
          wgmma_fence();
          const uint64_t d_hi = sw128_desc(b_hi + kk * 32, 16, 1024);
          if (small) {
            wgmma_tf32_rs<BN>(acc, al[buf], d_hi, kk > 0);  // the k-tile's first: from zero
            wgmma_tf32_rs<BN>(acc, ah[buf], sw128_desc(b_lo + kk * 32, 16, 1024), 1);
          } else {
            wgmma_tf32_rs<BN>(acc, ah[buf], d_hi, 1);
          }
          wgmma_commit();
          if (j + 1 < 2 * KSTEPS) wgmma_wait<1>();  // the other fragment buffer is free
        }
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(&empty[s]);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
      }
      epilogue(p, sum, m0 + r0, n0, tg);
    }
  }
}

// the shared-memory attribute is set once (the first launch), not on every
// launch
cudaError_t launch(const CUtensorMap& x, const CUtensorMap& w, const GemmArgs& p,
                   cudaStream_t stream) {
  static_assert(kSmem <= 232448, "shared memory over the H100's 227 KB per block");
  static const cudaError_t attr = cudaFuncSetAttribute(
      f32_gemm_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (attr != cudaSuccess) return attr;
  const int grid = p.tiles < num_sms() ? p.tiles : num_sms();
  f32_gemm_sm90<<<grid, kThreads, kSmem, stream>>>(x, w, p);
  return cudaGetLastError();
}

}  // namespace f32g
}  // namespace jv

// y (M, N) f32 = x . W^T + bias; x (M, K) f32 row-major, w2 the (2N, K) f32
// image of W's tf32 hi rows then its lo rows (`prepare_weight`), both
// 16-byte aligned; bias (N,) or null; N % 128 == 0, K % 32 == 0
extern "C" int jv_f32_gemm(const float* x, const float* w2, const float* bias, float* y, int M,
                           int N, int K, void* stream) {
  using namespace jv::f32g;
  if (M <= 0 || N <= 0 || N % BN || K <= 0 || K % BK ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w2) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_x, map_w;
  if (!jv::encode_2d(&map_x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, M, K, BM, BK) ||
      !jv::encode_2d(&map_w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w2, 2 * N, K, BN, BK))
    return (int)cudaErrorInvalidValue;
  GemmArgs p{bias, y, M, N, K, N / BN, 0};
  p.tiles = ((M + BM - 1) / BM) * p.n_tiles;
  return (int)launch(map_x, map_w, p, static_cast<cudaStream_t>(stream));
}
