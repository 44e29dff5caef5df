// One HiFT upsample stage's ResBlocks, fused into one kernel.
//
// Replaces the JAX package's Pallas kernel
// `jyutvoice_tpu/nn/pallas/resblock.py::fused_resblock_stage`
// (`_stage_kernel`). A stage averages n_branches parallel ResBlocks (kernel
// sizes 3/7/11 at full width); each ResBlock runs n_steps residual steps
//   x = x + conv_k(snake(conv_{k,d}(snake(x, a1)), a2))
// with dilations 1/3/5 on the first conv. Rows outside [0, T) are zeroed
// before every conv, which reproduces each unfused conv's zero "same"
// padding at the true sequence edges. All math is f32 on the CUDA cores, as
// on the TPU.
//
// Layout: x and out are (B, T, C) contiguous f32. The weights come packed in
// one f32 buffer in the order of the JAX package's `pack_stage_weights`: for
// each branch, for each step, [w1 (k, C, C) as (tap, in, out), b1, a1,
// w2 (k, C, C), b2, a2].
//
// What bounds it on the H100: the work, 2*C*C*T*sum(2k) flops per batch row
// (84.6 GFLOP at C=128, T=20480), against only tens of MB of activations and
// 8 MB of weights, so the bound is the f32 CUDA-core rate. The design: one
// block per (batch row, tile of TT output rows), 256 threads; TT is 64 at
// C=128 and 256 below. A block holds a (TT + 2*halo) x C window; each branch
// recomputes its own halo (60 rows a side for k=11, 12 for k=3), which makes
// the kernel do about 1.7x the stage's work at C=128 and 1.2x at C=64. Two
// window-sized buffers live in shared memory (the snake output that feeds a
// conv, and the first conv's output); the residual stream of the window
// lives in a per-block global scratch, which stays in L2. Each conv runs as
// a GEMM (rows x C) . ((tap, in) x C): chunks of 16 input channels of the
// weights are staged in shared memory with cp.async, double-buffered (the
// C=128 stage's 8 MB of weights cannot sit there whole, and stream from L2),
// and each thread accumulates an up-to-8-row x 8-channel tile in registers;
// for every 4 input channels it loads one float4 of activations per row and
// 8 float4 of weights, 256 FMAs for 16 shared loads. A pass gives each thread only as many
// rows as the conv has left, so short convs compute no idle rows. Tensor
// cores (3xTF32 for f32 accuracy) are left for later work.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BRANCHES = 4;
constexpr int MAX_STEPS = 4;
constexpr int TN = 8;   // output channels per thread
constexpr int TM = 8;   // most output rows per thread in one pass
constexpr int KC = 16;  // most input channels per staged weight chunk

struct StageCfg {
  int n_branches;
  int n_steps;
  int ks[MAX_BRANCHES];
  int dil[MAX_STEPS];
};

template <int C>
struct Geometry {
  static constexpr int LDW = C + 4;              // row pitch of the window buffers
  static constexpr int NCG = C / TN;             // thread columns
  static constexpr int NRG = THREADS / NCG;      // thread rows
  static constexpr int KCC = C < KC ? C : KC;    // input channels per chunk
  static constexpr int STAGE = KCC * C;          // floats in one weight chunk
};

__device__ __forceinline__ float snake(float x, float a) {
  float s = sinf(x * a);
  return x + (1.0f / (a + 1e-9f)) * (s * s);
}

// One pass of a conv over rows [rb, min(rb + NRG*TMV, r_hi)):
//   out[r] = bias + sum_i sum_ci in[r - pad + i*dil][ci] * w[i][ci][:]
// written to `out` (pitch out_pitch), or with `residual` added to it. The
// conv is a GEMM (rows x C) . ((tap, ci) x C): the weights stream through
// shared memory in chunks of KCC input channels, double-buffered with
// cp.async; each thread keeps a TMV x TN tile of outputs in registers.
template <int C, int TMV>
__device__ __forceinline__ void conv_pass(const float* in, float* out, int out_pitch,
                                          const float* __restrict__ w,
                                          const float* __restrict__ bias, float* w_s,
                                          int rb, int r_hi, int pad, int dil, int k,
                                          bool residual) {
  using G = Geometry<C>;
  constexpr int CH = C / G::KCC;  // chunks per tap
  const int tid = threadIdx.x;
  const int c0 = (tid % G::NCG) * TN;
  const int rg = tid / G::NCG;
  float acc[TMV][TN];
  int aidx[TMV];
#pragma unroll
  for (int m = 0; m < TMV; ++m) {
    const int r = min(rb + rg + G::NRG * m, r_hi - 1);
    aidx[m] = (r - pad) * G::LDW;
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = bias[c0 + n];
  }
  const int n_chunks = k * CH;
  auto stage = [&](int q) {
    const float* src = w + (size_t)q * G::STAGE;
    float* dst = w_s + (q & 1) * G::STAGE;
    for (int j = tid; j < G::STAGE / 4; j += THREADS)
      __pipeline_memcpy_async(dst + 4 * j, src + 4 * j, 16);
  };
  stage(0);
  __pipeline_commit();
  for (int q = 0; q < n_chunks; ++q) {
    if (q + 1 < n_chunks) stage(q + 1);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this thread's copies of chunk q are done
    __syncthreads();           // and every thread's
    const float* ws = w_s + (q & 1) * G::STAGE + c0;
    const float* a_base = in + (q / CH) * dil * G::LDW + (q % CH) * G::KCC;
    // four input channels at a time: one float4 of activations per row and
    // four weight rows of TN channels
#pragma unroll
    for (int k4 = 0; k4 < G::KCC; k4 += 4) {
      float4 a[TMV];
#pragma unroll
      for (int m = 0; m < TMV; ++m)
        a[m] = *reinterpret_cast<const float4*>(a_base + aidx[m] + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(ws + (k4 + kk) * C);
        const float4 b1 = *reinterpret_cast<const float4*>(ws + (k4 + kk) * C + 4);
        const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int m = 0; m < TMV; ++m) {
          const float av = kk == 0 ? a[m].x : kk == 1 ? a[m].y : kk == 2 ? a[m].z : a[m].w;
#pragma unroll
          for (int n = 0; n < TN; ++n) acc[m][n] += av * bv[n];
        }
      }
    }
    __syncthreads();  // chunk q's buffer is free for chunk q + 2
  }
#pragma unroll
  for (int m = 0; m < TMV; ++m) {
    const int r = rb + rg + G::NRG * m;
    if (r >= r_hi) continue;
    float* dst = out + r * out_pitch + c0;
#pragma unroll
    for (int n = 0; n < TN; n += 4) {
      float4 y = make_float4(acc[m][n], acc[m][n + 1], acc[m][n + 2], acc[m][n + 3]);
      if (residual) {
        const float4 x = *reinterpret_cast<const float4*>(dst + n);
        y = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
      }
      *reinterpret_cast<float4*>(dst + n) = y;
    }
  }
}

// A conv over rows [r_lo, r_hi) in passes; each pass gives every thread
// as many rows as the remaining rows need (at most TM), so a short conv
// does not compute idle rows.
template <int C>
__device__ void conv_rows(const float* in, float* out, int out_pitch,
                          const float* __restrict__ w, const float* __restrict__ bias,
                          float* w_s, int r_lo, int r_hi, int pad, int dil, int k,
                          bool residual) {
  constexpr int NRG = Geometry<C>::NRG;
  for (int rb = r_lo; rb < r_hi;) {
    const int tm = min(TM, (r_hi - rb + NRG - 1) / NRG);
#define JV_PASS(V)                                                              \
  case V:                                                                       \
    conv_pass<C, V>(in, out, out_pitch, w, bias, w_s, rb, r_hi, pad, dil, k,   \
                    residual);                                                  \
    break;
    switch (tm) {
      JV_PASS(1) JV_PASS(2) JV_PASS(3) JV_PASS(4)
      JV_PASS(5) JV_PASS(6) JV_PASS(7) JV_PASS(8)
    }
#undef JV_PASS
    rb += NRG * tm;
  }
}

// dst[r] = snake(src[r], alpha) for rows [lo, hi), zero where the absolute
// position g0 + r lies outside [0, T)
template <int C>
__device__ void snake_rows(const float* src, int src_pitch, float* dst, int dst_pitch,
                           const float* __restrict__ alpha, int lo, int hi, int g0, int T) {
  for (int i = threadIdx.x; i < (hi - lo) * C; i += THREADS) {
    const int r = lo + i / C, c = i % C;
    const int g = g0 + r;
    const float y = snake(src[r * src_pitch + c], alpha[c]);
    dst[r * dst_pitch + c] = (g >= 0 && g < T) ? y : 0.f;
  }
}

template <int C, int TT>
__global__ void __launch_bounds__(THREADS)
resblock_stage_kernel(const float* __restrict__ x, float* __restrict__ out,
                      float* __restrict__ scratch, const float* __restrict__ w,
                      int T, int n_tiles, int w_max, StageCfg cfg) {
  constexpr int LDW = Geometry<C>::LDW;
  extern __shared__ __align__(16) float smem[];
  float* t1 = smem;                     // snake output feeding a conv
  float* t2 = smem + w_max * LDW;       // first conv's output
  float* w_s = smem + 2 * w_max * LDW;  // two staged weight chunks
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const float* xb = x + (long long)b * T * C;
  float* ob = out + (long long)b * T * C;
  float* X = scratch + ((long long)b * n_tiles + tile) * w_max * C;
  const int base = tile * TT;
  const float* wp = w;

  for (int br = 0; br < cfg.n_branches; ++br) {
    const int k = cfg.ks[br];
    int halo = 0;
    for (int j = 0; j < cfg.n_steps; ++j)
      halo += (k * cfg.dil[j] - cfg.dil[j]) / 2 + (k - 1) / 2;
    const int W = TT + 2 * halo;
    const int g0 = base - halo;

    for (int i = threadIdx.x; i < W * C; i += THREADS) {
      const int r = i / C, c = i % C;
      const int g = g0 + r;
      X[i] = (g >= 0 && g < T) ? xb[(long long)g * C + c] : 0.f;
    }
    __syncthreads();

    int lo = 0, hi = W;
    for (int j = 0; j < cfg.n_steps; ++j) {
      const int d = cfg.dil[j];
      const int p1 = (k * d - d) / 2;
      const int p2 = (k - 1) / 2;
      const float* w1 = wp;
      const float* b1 = w1 + (size_t)k * C * C;
      const float* a1 = b1 + C;
      const float* w2 = a1 + C;
      const float* b2 = w2 + (size_t)k * C * C;
      const float* a2 = b2 + C;
      wp = a2 + C;

      snake_rows<C>(X, C, t1, LDW, a1, lo, hi, g0, T);
      __syncthreads();
      conv_rows<C>(t1, t2, LDW, w1, b1, w_s, lo + p1, hi - p1, p1, d, k, false);
      __syncthreads();
      snake_rows<C>(t2, LDW, t2, LDW, a2, lo + p1, hi - p1, g0, T);
      __syncthreads();
      conv_rows<C>(t2, X, C, w2, b2, w_s, lo + p1 + p2, hi - p1 - p2, p2, 1, k, true);
      __syncthreads();
      lo += p1 + p2;
      hi -= p1 + p2;
    }

    // the branch's output rows are the window's centre [halo, halo + TT)
    const bool last = br == cfg.n_branches - 1;
    for (int i = threadIdx.x; i < TT * C; i += THREADS) {
      const int r = i / C, c = i % C;
      const int g = base + r;
      if (g >= T) continue;
      const float v = X[(halo + r) * C + c];
      float acc = br == 0 ? v : ob[(long long)g * C + c] + v;
      if (last) acc = acc / (float)cfg.n_branches;
      ob[(long long)g * C + c] = acc;
    }
    __syncthreads();
  }
}

template <int C, int TT>
cudaError_t launch(const float* x, float* out, float* scratch, const float* w,
                   int B, int T, int w_max, const StageCfg& cfg, cudaStream_t stream) {
  const size_t bytes =
      (2 * (size_t)w_max * Geometry<C>::LDW + 2 * Geometry<C>::STAGE) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(resblock_stage_kernel<C, TT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const int n_tiles = (T + TT - 1) / TT;
  dim3 grid(n_tiles, B);
  resblock_stage_kernel<C, TT><<<grid, THREADS, bytes, stream>>>(
      x, out, scratch, w, T, n_tiles, w_max, cfg);
  return cudaGetLastError();
}

}  // namespace

// Output-row tile of the kernel for C channels; the caller sizes the scratch
// as B * ceil(T / tile) * (tile + 2 * max_halo) * C floats.
extern "C" int jv_resblock_stage_tile(int C) { return C == 128 ? 64 : 256; }

extern "C" int jv_resblock_stage_fwd(const float* x, float* out, float* scratch,
                                     const float* w, int B, int T, int C,
                                     int n_branches, const int* ks, int n_steps,
                                     const int* dil, int max_halo, void* stream) {
  if (n_branches < 1 || n_branches > MAX_BRANCHES || n_steps < 1 || n_steps > MAX_STEPS)
    return (int)cudaErrorInvalidValue;
  StageCfg cfg{};
  cfg.n_branches = n_branches;
  cfg.n_steps = n_steps;
  for (int i = 0; i < n_branches; ++i) cfg.ks[i] = ks[i];
  for (int i = 0; i < n_steps; ++i) cfg.dil[i] = dil[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tt = jv_resblock_stage_tile(C);
  const int w_max = tt + 2 * max_halo;
  switch (C) {
    case 128: return (int)launch<128, 64>(x, out, scratch, w, B, T, w_max, cfg, st);
    case 64: return (int)launch<64, 256>(x, out, scratch, w, B, T, w_max, cfg, st);
    case 32: return (int)launch<32, 256>(x, out, scratch, w, B, T, w_max, cfg, st);
    case 16: return (int)launch<16, 256>(x, out, scratch, w, B, T, w_max, cfg, st);
    case 8: return (int)launch<8, 256>(x, out, scratch, w, B, T, w_max, cfg, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
