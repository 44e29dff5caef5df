// One HiFT upsample stage's ResBlocks, fused into one kernel, on the H100's
// tensor cores at f32 accuracy (3xTF32 wgmma).
//
// Replaces the JAX package's Pallas kernel
// `jyutvoice_tpu/nn/pallas/resblock.py::fused_resblock_stage`
// (`_stage_kernel`). A stage averages n_branches parallel ResBlocks (kernel
// sizes 3/7/11 at full width); each ResBlock runs n_steps residual steps
//   x = x + conv_k(snake(conv_{k,d}(snake(x, a1)), a2))
// with dilations 1/3/5 on the first conv. Rows outside [0, T) are zeroed
// before every conv, which reproduces each unfused conv's zero "same"
// padding at the true sequence edges.
//
// Layout: x and out are (B, T, C) contiguous f32. The weights come prepared
// once per model by `nn/resblock_stage.py::prepare_stage_weights`: `tiles`
// holds, for each branch, step, conv, pass of NB output channels, tap and
// group of 32 input channels (one "chunk", in the order this kernel reads
// them), the (NB out x 32 in) weight slice as a K-major, 128-byte-swizzled
// image of its tf32 high part, then the same of its low part (w - hi,
// rounded to tf32), ready to be copied into shared memory as it is; `params`
// holds per branch and step [b1, a1, 1/(a1 + 1e-9), b2, a2, 1/(a2 + 1e-9)],
// C floats each.
//
// What bounds it on the H100: the work is 2 C^2 T sum(2k) flops per batch
// row (148 GFLOP for the vocoder's C=128, T=20480 and C=64, T=61441 stages)
// against tens of MB of activations and 8 MB of weights, so operations bound
// it: 0.90 ms for three TF32 products per product on the tensor cores'
// 495 TFLOP/s, 2.21 ms for f32 FFMA on the CUDA cores' 67 TFLOP/s.
// What the design does about each limit of the FFMA kernel it replaces:
// 1. Tensor cores at f32 accuracy. Every conv is a GEMM (rows x C) .
//    ((tap, in) x C) on `wgmma.m64nNk8.f32.tf32.tf32`, N = NB (64 at C=128,
//    in two passes, else C). A comes from registers: each thread loads its
//    fragment from the f32 window in shared memory at row offset r + i*d
//    for tap i (so no descriptor has to start at an arbitrary row of a
//    swizzled tile) and splits it, hi = a rounded to tf32, lo = a - hi cut
//    to tf32, with integer instructions (`split_tf32`). B is the prepared hi
//    or lo tile. Three wgmmas per 8-deep k-step, small terms first: lo.hi,
//    hi.lo, hi.hi. The tensor cores round their f32 sums toward zero, and a
//    run of hundreds of such roundings into one accumulator (528 per output
//    of a k=11, C=128 conv) biases it by ~3e-5 of itself, past the bar; so
//    each chunk's products (at most 12 roundings) start from zero and are
//    added into f32 sums on the CUDA cores.
// 2. Halo recompute: a block holds a window of ROWS rows (248 at C=128, 256
//    below) and computes each conv's rows in one pass of four consumer
//    warpgroups, one 64-row tile each; the output tile is what the window
//    leaves after the halos (at most 128 rows at C=128 and 136 below for
//    the 3/7/11, 1/3/5 stage), shorter where that fills the last wave of
//    blocks better (`pick_tile` in the wrapper).
// 3. Shared memory and barriers: one f32 window (the snake output that feeds
//    a conv; the first conv's output replaces it after a consumer barrier)
//    and a ring of NS = 4 weight chunks (16 KB each at C=128 and 64). One
//    thread of a producer warpgroup (setmaxnreg gives its registers to the
//    consumers) streams the chunks into the ring with bulk copies (TMA)
//    behind full/empty mbarriers, so no block-wide barrier runs per chunk:
//    the consumers meet at a named barrier four times per residual step,
//    around the window writes. Sixteen consumer warps hide the window
//    loads and splits better than eight (on an H100 80GB HBM3: 1.42
//    against 1.84 ms at C=64, T=61441).
// 4. L2 traffic of the weights: every block streams the stage's prepared
//    weights (hi and lo: 16.5 MB at C=128) once, for all its rows (up to 256
//    rows per chunk, against 64 in the FFMA kernel).
// 5. cudaFuncSetAttribute runs once per instantiation, not per launch.
// 6. The weights are prepared once per model (HiFT holds them), not
//    repacked on every call.
// The residual stream of the window stays in a per-block global scratch
// (it lives in L2); the bias, the residual add, the edge mask, the snakes
// and the branch mean are fused into the epilogues and the window writes.

#include "hopper.cuh"

namespace {

using namespace jv;

constexpr int MAX_BRANCHES = 4;
constexpr int MAX_STEPS = 4;
constexpr int CONSUMERS = 4;  // consumer warpgroups, one 64-row tile each
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup
constexpr int CONSUMER_THREADS = CONSUMERS * 128;
// setmaxnreg moves registers within the block's launch allocation (65536 /
// THREADS a thread, in multiples of 8): what the producer gives back is all
// the consumers can take, or their setmaxnreg.inc waits forever
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 112;
static_assert((PRODUCER_REGS + CONSUMERS * CONSUMER_REGS) * 128 <= LAUNCH_REGS * THREADS,
              "setmaxnreg asks for more registers than the block holds");
constexpr int KB = 32;          // input channels per weight chunk
constexpr int BAR_WINDOW = 1;   // named barrier of the consumers

struct StageCfg {
  int n_branches;
  int n_steps;
  int ks[MAX_BRANCHES];
  int dil[MAX_STEPS];
};

template <int C>
struct Geo {
  static constexpr int LDW = C + 4;                     // window row pitch (floats)
  static constexpr int NB = C == 128 ? 64 : C;          // output channels per pass
  static constexpr int NP = C / NB;                     // passes per conv
  static constexpr int ROWS = C == 128 ? 248 : 256;     // window rows
  static constexpr int CPT = (C + KB - 1) / KB;         // chunks per tap
  static constexpr int KSTEPS = (C < KB ? C : KB) / 8;  // 8-deep k-steps per chunk
  static constexpr int TILE = NB * 128;                 // bytes of one hi or lo tile
  static constexpr int CHUNK = 2 * TILE;
  static constexpr int NS = 4;                          // ring stages
  static constexpr int SCRATCH = (NP > 1 ? 2 : 1) * ROWS * C;  // global floats per block
  static constexpr int ring_off = (ROWS * LDW * 4 + 1023) / 1024 * 1024;
  static constexpr int bar_off = ring_off + NS * CHUNK;
  static constexpr int bytes = bar_off + 2 * NS * 8 + 1024;  // + 1024-byte alignment slack
  static_assert(ROWS <= CONSUMERS * 64, "a conv's rows must fit one tile per consumer");
  static_assert(bytes <= 232448, "shared memory over the H100's 227 KB per block");
};

__device__ __forceinline__ float snake(float x, float a, float inv_a) {
  const float s = sinf(x * a);
  return x + inv_a * (s * s);
}

// The 3xTF32 split of one f32 a: hi = a rounded to the nearest tf32 (ties
// away from zero, as cvt.rna.tf32.f32 rounds), lo = a - hi (exact in f32)
// cut to tf32; hi + lo is within 2^-21 of a. Integer and FADD instructions
// only: the conversion unit's cvt has a quarter of their throughput.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(a - __uint_as_float(hi)) & 0xFFFFE000u;
}

// The producer: one thread streams every chunk of the stage, in order, into
// the ring (stage q % NS), each as one bulk copy that completes on full[s].
template <int C>
__device__ void produce(const float* __restrict__ tiles, const StageCfg& cfg, uint8_t* ring,
                        uint64_t* full, uint64_t* empty) {
  using G = Geo<C>;
  int n_chunks = 0;
  for (int br = 0; br < cfg.n_branches; ++br)
    n_chunks += cfg.n_steps * 2 * G::NP * cfg.ks[br] * G::CPT;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(tiles);
  for (int q = 0; q < n_chunks; ++q) {
    const int s = q % G::NS;
    mbar_wait(&empty[s], ((q / G::NS) & 1) ^ 1);
    mbar_arrive_expect_tx(&full[s], G::CHUNK);
    bulk_copy_g2s(ring + s * G::CHUNK, src + (size_t)q * G::CHUNK, G::CHUNK, &full[s]);
  }
}

// One pass of a conv (NB output channels) over k taps of dilation dil, for
// a consumer warpgroup whose 64-row tile has rows (ACTIVE) or lies past the
// conv's rows (it then only keeps the ring moving): sum (64 x NB) = the
// window rows (offA/offB: this thread's two fragment rows, minus the conv's
// padding, times the pitch) through the taps. Each chunk's products start
// from zero in acc and are added into sum once done (header, point 1).
// The window values of the next k-step (across chunks too: the window does
// not depend on the ring) are loaded before this one's wgmmas are issued.
// Chunks are ring positions q0, q0 + 1, ...; a chunk's stage is released
// once its products are in sum.
template <int C, bool ACTIVE>
__device__ __forceinline__ void conv_pass(float (&sum)[Geo<C>::NB / 2], const float* win,
                                          int offA, int offB, int dil, int k, int q0,
                                          const uint8_t* ring, uint64_t* full, uint64_t* empty) {
  using G = Geo<C>;
  const int n_chunks = k * G::CPT;
  if constexpr (!ACTIVE) {
    for (int c = 0; c < n_chunks; ++c) {
      const int q = q0 + c;
      mbar_wait(&full[q % G::NS], (q / G::NS) & 1);
      mbar_arrive(&empty[q % G::NS]);
    }
  } else {
    float acc[G::NB / 2];
    uint32_t ah[2][4], al[2][4];  // A fragments, double-buffered over k-steps
    float v[4];                   // the next k-step's window values
    auto load = [&](const float* wp, int kk) {
      v[0] = wp[offA + kk * 8];
      v[1] = wp[offB + kk * 8];
      v[2] = wp[offA + kk * 8 + 4];
      v[3] = wp[offB + kk * 8 + 4];
    };
    // chunk c's window columns: tap c / CPT, input channels 32 (c % CPT) on
    auto chunk_base = [&](int c) { return win + (c / G::CPT) * dil * G::LDW + (c % G::CPT) * KB; };
    load(win, 0);
    for (int c = 0; c < n_chunks; ++c) {
      const int q = q0 + c;
      const int s = q % G::NS;
      const float* wp = chunk_base(c);
      const float* wp_next = chunk_base(c + 1 < n_chunks ? c + 1 : c);
      mbar_wait(&full[s], (q / G::NS) & 1);
      const uint32_t b_hi = smem_u32(ring + s * G::CHUNK);
      const uint32_t b_lo = b_hi + G::TILE;
#pragma unroll
      for (int kk = 0; kk < G::KSTEPS; ++kk) {
        const int buf = kk & 1;
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(v[e], ah[buf][e], al[buf][e]);
        if (kk + 1 < G::KSTEPS)
          load(wp, kk + 1);
        else if (c + 1 < n_chunks)
          load(wp_next, 0);
        fence_regs(ah);
        fence_regs(al);
        wgmma_fence();
        const uint64_t d_hi = sw128_desc(b_hi + kk * 32, 16, 1024);
        const uint64_t d_lo = sw128_desc(b_lo + kk * 32, 16, 1024);
        wgmma_tf32_rs<G::NB>(acc, al[buf], d_hi, kk > 0);  // the chunk's first: from zero
        wgmma_tf32_rs<G::NB>(acc, ah[buf], d_lo, 1);
        wgmma_tf32_rs<G::NB>(acc, ah[buf], d_hi, 1);
        wgmma_commit();
        if (kk < G::KSTEPS - 1) wgmma_wait<1>();  // the other fragment buffer is free
      }
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < G::NB / 2; ++i) sum[i] += acc[i];
      mbar_arrive(&empty[s]);
    }
  }
}

// One pass of a conv over window rows [r_lo, r_hi) into sum for this
// consumer warpgroup's 64-row tile wg; returns whether the tile has rows.
// Rows past r_hi read row r_hi - 1 and are not stored.
template <int C>
__device__ __forceinline__ bool conv(float (&sum)[Geo<C>::NB / 2], const float* win, int r_lo,
                                     int r_hi, int pad, int dil, int k, int& q,
                                     const uint8_t* ring, uint64_t* full, uint64_t* empty, int wg,
                                     int warp, int g, int tg) {
  using G = Geo<C>;
  const bool active = r_lo + 64 * wg < r_hi;
  const int row = r_lo + 64 * wg + 16 * warp + g;
  const int offA = (min(row, r_hi - 1) - pad) * G::LDW + tg;
  const int offB = (min(row + 8, r_hi - 1) - pad) * G::LDW + tg;
#pragma unroll
  for (int i = 0; i < G::NB / 2; ++i) sum[i] = 0.f;
  if (active)
    conv_pass<C, true>(sum, win, offA, offB, dil, k, q, ring, full, empty);
  else
    conv_pass<C, false>(sum, win, offA, offB, dil, k, q, ring, full, empty);
  q += k * G::CPT;
  return active;
}

template <int C>
__device__ void consume(const float* __restrict__ x, float* __restrict__ out, float* scratch,
                        const float* __restrict__ params, int T, int TT, int n_tiles,
                        const StageCfg& cfg, float* win, const uint8_t* ring, uint64_t* full,
                        uint64_t* empty) {
  using G = Geo<C>;
  constexpr int LDW = G::LDW, NB = G::NB;
  const int ct = threadIdx.x;
  const int wg = ct / 128, warp = (ct % 128) / 32, lane = ct % 32;
  const int g = lane / 4, tg = lane % 4;
  const int b = blockIdx.y;
  const int base = blockIdx.x * TT;
  const float* xb = x + (long long)b * T * C;
  float* ob = out + (long long)b * T * C;
  // this block's scratch: the window's residual stream, then the first
  // conv's output of the passes before the last
  float* X = scratch + ((long long)b * n_tiles + blockIdx.x) * G::SCRATCH;
  float* T2 = X + G::ROWS * C;
  const float* prm = params;
  int q = 0;
  float sum[NB / 2];

  for (int br = 0; br < cfg.n_branches; ++br) {
    const int k = cfg.ks[br];
    int halo = 0;
    for (int j = 0; j < cfg.n_steps; ++j)
      halo += (k * cfg.dil[j] - cfg.dil[j]) / 2 + (k - 1) / 2;
    const int g0 = base - halo;  // absolute position of window row 0
    int lo = 0, hi = TT + 2 * halo;
    for (int j = 0; j < cfg.n_steps; ++j) {
      const int d = cfg.dil[j];
      const int p1 = (k * d - d) / 2, p2 = (k - 1) / 2;
      const float *b1 = prm, *a1 = prm + C, *r1 = prm + 2 * C;
      const float *b2 = prm + 3 * C, *a2 = prm + 4 * C, *r2 = prm + 5 * C;
      prm += 6 * C;
      const bool first = j == 0, last = j == cfg.n_steps - 1;

      // the window: snake(x, a1) on rows [lo, hi), zero outside [0, T); the
      // residual stream is x itself at the first step, then the scratch
      for (int i = ct; i < (hi - lo) * (C / 4); i += CONSUMER_THREADS) {
        const int r = lo + i / (C / 4), c = (i % (C / 4)) * 4;
        const int gp = g0 + r;
        float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gp >= 0 && gp < T) {
          const float4 v = *reinterpret_cast<const float4*>(
              first ? xb + (long long)gp * C + c : X + r * C + c);
          const float4 a = *reinterpret_cast<const float4*>(a1 + c);
          const float4 ia = *reinterpret_cast<const float4*>(r1 + c);
          y = make_float4(snake(v.x, a.x, ia.x), snake(v.y, a.y, ia.y), snake(v.z, a.z, ia.z),
                          snake(v.w, a.w, ia.w));
        }
        *reinterpret_cast<float4*>(win + r * LDW + c) = y;
      }
      named_barrier_sync(BAR_WINDOW, CONSUMER_THREADS);

      // conv1 (dilation d) over rows [lo + p1, hi - p1), NB output channels
      // per pass; its output, biased, snaked with a2 and masked, replaces the
      // window once every consumer is done reading it: the last pass's from
      // the registers, the earlier ones' through T2
      int r_lo = lo + p1, r_hi = hi - p1;
      for (int p = 0; p < G::NP; ++p) {
        const bool active =
            conv<C>(sum, win, r_lo, r_hi, p1, d, k, q, ring, full, empty, wg, warp, g, tg);
        const bool to_win = p == G::NP - 1;
        if (to_win) named_barrier_sync(BAR_WINDOW, CONSUMER_THREADS);
        float* dst = to_win ? win : T2;
        const int ld = to_win ? LDW : C;
        if (!active) continue;
#pragma unroll
        for (int n = 0; n < NB / 8; ++n) {
          const int c = p * NB + n * 8 + tg * 2;
          const float2 bb = *reinterpret_cast<const float2*>(b1 + c);
          const float2 aa = *reinterpret_cast<const float2*>(a2 + c);
          const float2 ia = *reinterpret_cast<const float2*>(r2 + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r_lo + 64 * wg + 16 * warp + g + 8 * h;
            if (r >= r_hi) continue;
            const int gp = g0 + r;
            float2 y = make_float2(0.f, 0.f);
            if (gp >= 0 && gp < T)
              y = make_float2(snake(sum[4 * n + 2 * h] + bb.x, aa.x, ia.x),
                              snake(sum[4 * n + 2 * h + 1] + bb.y, aa.y, ia.y));
            *reinterpret_cast<float2*>(dst + r * ld + c) = y;
          }
        }
      }
      if constexpr (G::NP > 1) {
        constexpr int C4 = (G::NP - 1) * NB / 4;  // float4s of the earlier passes per row
        for (int i = ct; i < (r_hi - r_lo) * C4; i += CONSUMER_THREADS) {
          const int r = r_lo + i / C4, c = (i % C4) * 4;
          *reinterpret_cast<float4*>(win + r * LDW + c) =
              *reinterpret_cast<const float4*>(T2 + r * C + c);
        }
      }
      named_barrier_sync(BAR_WINDOW, CONSUMER_THREADS);

      // conv2 (dilation 1) over rows [lo + p1 + p2, hi - p1 - p2); + b2 + the
      // residual, into the scratch, or at the last step (the window's centre
      // rows [halo, halo + TT)) into the branch mean in out
      r_lo += p2;
      r_hi -= p2;
      const bool last_branch = br == cfg.n_branches - 1;
      const float n_br = (float)cfg.n_branches;
      for (int p = 0; p < G::NP; ++p) {
        if (!conv<C>(sum, win, r_lo, r_hi, p2, 1, k, q, ring, full, empty, wg, warp, g, tg))
          continue;
#pragma unroll
        for (int n = 0; n < NB / 8; ++n) {
          const int c = p * NB + n * 8 + tg * 2;
          const float2 bb = *reinterpret_cast<const float2*>(b2 + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r_lo + 64 * wg + 16 * warp + g + 8 * h;
            if (r >= r_hi) continue;
            const int gp = g0 + r;
            if (last && gp >= T) continue;
            float2 res = make_float2(0.f, 0.f);
            if (!first)
              res = *reinterpret_cast<const float2*>(X + r * C + c);
            else if (gp >= 0 && gp < T)
              res = *reinterpret_cast<const float2*>(xb + (long long)gp * C + c);
            float2 y = make_float2(res.x + (sum[4 * n + 2 * h] + bb.x),
                                   res.y + (sum[4 * n + 2 * h + 1] + bb.y));
            if (!last) {
              *reinterpret_cast<float2*>(X + r * C + c) = y;
              continue;
            }
            float2* o = reinterpret_cast<float2*>(ob + (long long)gp * C + c);
            if (br > 0) {
              const float2 prev = *o;
              y = make_float2(prev.x + y.x, prev.y + y.y);
            }
            if (last_branch) y = make_float2(y.x / n_br, y.y / n_br);
            *o = y;
          }
        }
      }
      named_barrier_sync(BAR_WINDOW, CONSUMER_THREADS);
      lo += p1 + p2;
      hi -= p1 + p2;
    }
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
resblock_stage_sm90(const float* __restrict__ x, float* __restrict__ out, float* scratch,
                    const float* __restrict__ tiles, const float* __restrict__ params, int T,
                    int TT, int n_tiles, StageCfg cfg) {
  using G = Geo<C>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* win = reinterpret_cast<float*>(smem);
  uint8_t* ring = smem + G::ring_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::bar_off);
  uint64_t* empty = full + G::NS;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < G::NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_THREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // registers: the launch gives each thread LAUNCH_REGS (96); the producer
  // keeps PRODUCER_REGS and the consumers take CONSUMER_REGS
  if (threadIdx.x / 128 == CONSUMERS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x % 128 == 0) produce<C>(tiles, cfg, ring, full, empty);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<C>(x, out, scratch, params, T, TT, n_tiles, cfg, win, ring, full, empty);
  }
}

// the shared-memory attribute is set once per instantiation (the first
// launch), not on every launch
template <int C>
cudaError_t launch(const float* x, float* out, float* scratch, const float* tiles,
                   const float* params, int B, int T, int TT, const StageCfg& cfg,
                   cudaStream_t stream) {
  using G = Geo<C>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      resblock_stage_sm90<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::bytes);
  if (attr != cudaSuccess) return attr;
  const int n_tiles = (T + TT - 1) / TT;
  const dim3 grid(n_tiles, B);
  resblock_stage_sm90<C><<<grid, THREADS, G::bytes, stream>>>(x, out, scratch, tiles, params, T,
                                                               TT, n_tiles, cfg);
  return cudaGetLastError();
}

}  // namespace

// Rows of the window a block holds for C channels: an output tile of TT rows
// needs TT + 2 * (the largest branch halo) of them. 0 for a C the kernel
// does not take.
extern "C" int jv_resblock_stage_rows(int C) {
  switch (C) {
    case 128: return Geo<128>::ROWS;
    case 64: return Geo<64>::ROWS;
    case 32: return Geo<32>::ROWS;
    case 16: return Geo<16>::ROWS;
    case 8: return Geo<8>::ROWS;
    default: return 0;
  }
}

// Output channels per pass of a conv for C channels (the prepared weights'
// chunks hold this many output rows); 0 for a C the kernel does not take.
extern "C" int jv_resblock_stage_pass_channels(int C) {
  switch (C) {
    case 128: return Geo<128>::NB;
    case 64: return Geo<64>::NB;
    case 32: return Geo<32>::NB;
    case 16: return Geo<16>::NB;
    case 8: return Geo<8>::NB;
    default: return 0;
  }
}

// Scratch floats per block for C channels: the window's residual stream,
// and with more than one pass per conv the first conv's earlier passes.
extern "C" int jv_resblock_stage_scratch(int C) {
  switch (C) {
    case 128: return Geo<128>::SCRATCH;
    case 64: return Geo<64>::SCRATCH;
    case 32: return Geo<32>::SCRATCH;
    case 16: return Geo<16>::SCRATCH;
    case 8: return Geo<8>::SCRATCH;
    default: return 0;
  }
}

// The caller sizes the scratch as B * ceil(T / tt) * scratch(C) floats.
extern "C" int jv_resblock_stage_fwd(const float* x, float* out, float* scratch,
                                     const float* tiles, const float* params, int B, int T,
                                     int C, int n_branches, const int* ks, int n_steps,
                                     const int* dil, int tt, void* stream) {
  if (n_branches < 1 || n_branches > MAX_BRANCHES || n_steps < 1 || n_steps > MAX_STEPS ||
      B < 1 || T < 1 || tt < 1)
    return (int)cudaErrorInvalidValue;
  StageCfg cfg{};
  cfg.n_branches = n_branches;
  cfg.n_steps = n_steps;
  int max_halo = 0;
  for (int i = 0; i < n_branches; ++i) {
    cfg.ks[i] = ks[i];
    if (ks[i] < 1 || ks[i] % 2 == 0) return (int)cudaErrorInvalidValue;
    int halo = 0;
    for (int j = 0; j < n_steps; ++j) halo += (ks[i] * dil[j] - dil[j]) / 2 + (ks[i] - 1) / 2;
    max_halo = max(max_halo, halo);
  }
  for (int j = 0; j < n_steps; ++j) {
    cfg.dil[j] = dil[j];
    if (dil[j] < 1) return (int)cudaErrorInvalidValue;
  }
  if (tt + 2 * max_halo > jv_resblock_stage_rows(C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return (int)launch<128>(x, out, scratch, tiles, params, B, T, tt, cfg, st);
    case 64: return (int)launch<64>(x, out, scratch, tiles, params, B, T, tt, cfg, st);
    case 32: return (int)launch<32>(x, out, scratch, tiles, params, B, T, tt, cfg, st);
    case 16: return (int)launch<16>(x, out, scratch, tiles, params, B, T, tt, cfg, st);
    case 8: return (int)launch<8>(x, out, scratch, tiles, params, B, T, tt, cfg, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
