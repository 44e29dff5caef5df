// The Hopper main loop shared by kernel 1 (`flash_attention.cu`) and kernel
// 3 (`flash_stock.cu`): forward flash attention over f32 (B, T, H, D) views
// with 16-bit products on wgmma and f32 accumulation. The two kernels differ
// only in their key rule (`Rule`), in where the softmax scale is applied
// (`Params::q_scale` before the rounding of q, `Params::s_scale` after the
// product), in the residual output and in the product type (`kF16`): kernel
// 1 rounds q, k, P and v to bf16, as its Pallas original does; kernel 3 to
// fp16, whose 3 more mantissa bits keep rows that see a handful of keys
// within its bar (`scripts/flash_fwd_precision.py`: with bf16 the rounding
// of q and k in the scores alone put such rows past it). Each source's
// header says what bounds it and why this design.
//
// One block owns NC * 64 query rows of one (b, h) and has NC + 1
// warpgroups:
// - the producer (the last warpgroup) copies each 64-key tile of k and v,
//   f32, into a ring of NS staging slots with cp.async (each thread copies
//   its own 16-byte chunks, so NS tiles are in flight without registers or
//   a barrier), then rounds the tile it waited for once into a 128-byte-
//   swizzled 16-bit K tile and V tile in one of NB stages, fences the async
//   proxy and arrives on that stage's `full` mbarrier;
// - each consumer warpgroup owns 64 query rows, holds its q rows as 16-bit A
//   fragments in registers for the whole block, and per tile waits on
//   `full`, computes S = q.k^T with wgmma (A in registers, the K tile as a
//   K-major B operand), runs the online softmax on the accumulator
//   registers in the log2 domain, packs P to 16 bits as the register A operand
//   of O += P.V (the V tile as an MN-major B operand), and arrives on the
//   stage's `empty` mbarrier, on which the producer waits before refilling.
// setmaxnreg moves registers from the producer to the consumers (NC >= 2).
// A consumer whose 64 rows lie past T takes no part (the `empty` barriers
// count only the active ones), so a T that is no multiple of the block's
// rows (T % 128 == 64) needs no other case. All consumers read every staged
// tile: the block walks the union of their key ranges and a consumer skips
// the products of tiles its own rows cannot see. Its own tiles are software
// pipelined: the scores of tile j go to the tensor cores together with P.V
// of tile j - 1, and the softmax of tile j runs while that P.V is still on
// them. The softmax takes the row
// max of the raw scores and folds the scale into the exponent (one FMA and
// one ex2.approx per score), and skips the rescale of the accumulator
// where no row max of the warp moved.

#pragma once

#include "hopper.cuh"

namespace jv {
namespace fwd {

constexpr int BK = 64;       // keys per tile
constexpr int WG_ROWS = 64;  // query rows per consumer warpgroup
constexpr int NB = 3;        // 16-bit stages read by wgmma
constexpr float NEG_BIG = -1e30f;  // a masked score

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;      // contiguous (B, T, H, D)
  float* m_out;  // (B, H, T) natural-log row max of the scaled scores, or null
  float* l_out;  // (B, H, T) row sum of exp(s - m), or null
  const int* lengths;
  int T, H;
  Strides qs, ks, vs;
  float q_scale;  // multiplies q in f32 before it is rounded to 16 bits
  float s_scale;  // multiplies q.k after the product (log2 domain)
  int chunk, left;  // kernel 1's streaming band; chunk <= 0: none
};

enum class Rule {
  KeyBand,   // kernel 1: keys [0, len) within the row's chunk band
  Segments,  // kernel 3: query i sees key j iff (i < len) == (j < len)
};

// the keys [lo, hi) row `row` (< T) can see; both ends are non-decreasing
// in the row, so a block of rows sees [lo(first), hi(last))
template <Rule R>
__device__ __forceinline__ void key_range(const Params& p, int len, int row, int& lo, int& hi) {
  if constexpr (R == Rule::Segments) {
    lo = row < len ? 0 : len;
    hi = row < len ? len : p.T;
  } else {
    lo = 0;
    hi = len;
    if (p.chunk > 0) {
      const int ci = row / p.chunk;
      hi = min(hi, (ci + 1) * p.chunk);
      if (p.left >= 0) lo = max((ci - p.left) * p.chunk, 0);
    }
  }
}

// the key tiles [t_lo, t_hi) that rows [r0, r0 + n) (all < T) can see
template <Rule R>
__device__ __forceinline__ void tile_range(const Params& p, int len, int r0, int n, int& t_lo,
                                           int& t_hi) {
  int lo, hi, lo_last, hi_first;
  key_range<R>(p, len, r0, lo, hi_first);
  key_range<R>(p, len, r0 + n - 1, lo_last, hi);
  t_lo = lo / BK;
  t_hi = hi > lo ? (hi + BK - 1) / BK : t_lo;
}

template <int D, int NS>
struct Layout {
  static constexpr int TILE = BK * D * 2;  // one 16-bit K or V tile
  static constexpr int STAGE = 2 * TILE;   // K tile, then V tile
  static constexpr int SLOT = 2 * BK * D * 4;  // one f32 staging slot: K rows, then V rows
  static constexpr int f32_off = NB * STAGE;
  static constexpr int bar_off = f32_off + NS * SLOT;
  static constexpr size_t bytes = bar_off + 2 * NB * 8 + 1024;  // + 1024-byte alignment slack
};

template <int D, int NS, bool kF16>
__device__ __forceinline__ void produce(const Params& p, uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, int b, int h, int t_lo, int ntiles,
                                        int pt) {
  using L = Layout<D, NS>;
  // Thread pt owns the 16-byte chunks pt + 128 n of every k and v tile (a
  // warp covers whole rows, so the copies are coalesced); it copies them
  // into the staging slot with cp.async and later converts exactly those
  // chunks, so no barrier inside the producer is needed.
  constexpr int CH = D / 4;           // 16-byte chunks per row
  constexpr int PER = BK * CH / 128;  // chunks of k (and of v) per thread per tile
  const float* kb = p.k + b * p.ks.b + h * p.ks.h;
  const float* vb = p.v + b * p.vs.b + h * p.vs.h;
  const int T = p.T;

  // tile t_lo + j into staging slot j % NS; one commit group per tile, empty
  // past the last, so the wait below always counts NS groups
  auto fetch = [&](int j) {
    if (j < ntiles) {
      float* ks = reinterpret_cast<float*>(smem + L::f32_off + (j % NS) * L::SLOT);
      float* vs = ks + BK * D;
      const int k0 = (t_lo + j) * BK;
#pragma unroll
      for (int n = 0; n < PER; ++n) {
        const int i = pt + 128 * n;
        const int r = i / CH, c = (i % CH) * 4;
        if (k0 + r < T) {
          cp_async16(ks + i * 4, kb + (long long)(k0 + r) * p.ks.t + c);
          cp_async16(vs + i * 4, vb + (long long)(k0 + r) * p.vs.t + c);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int j = 0; j < NS; ++j) fetch(j);
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<NS - 1>();  // this thread's chunks of tile j have landed
    const int s = j % NB;
    mbar_wait(&empty[s], ((j / NB) & 1) ^ 1);
    uint8_t* kt = smem + s * L::STAGE;
    uint8_t* vt = kt + L::TILE;
    const float* ks = reinterpret_cast<const float*>(smem + L::f32_off + (j % NS) * L::SLOT);
    const float* vs = ks + BK * D;
    const int k0 = (t_lo + j) * BK;
#pragma unroll
    for (int n = 0; n < PER; ++n) {
      const int i = pt + 128 * n;
      const int r = i / CH, c = (i % CH) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;  // keys past T: zeros
      if (k0 + r < T) {
        x = *reinterpret_cast<const float4*>(ks + i * 4);
        y = *reinterpret_cast<const float4*>(vs + i * 4);
      }
      const uint32_t off = sw128_offset(BK, r, c);
      *reinterpret_cast<uint2*>(kt + off) =
          make_uint2(pack2<kF16>(x.x, x.y), pack2<kF16>(x.z, x.w));
      *reinterpret_cast<uint2*>(vt + off) =
          make_uint2(pack2<kF16>(y.x, y.y), pack2<kF16>(y.z, y.w));
    }
    fence_proxy_async();
    mbar_arrive(&full[s]);
    fetch(j + NS);  // refills the slot just read
  }
}

template <int D, int NS, Rule R, bool kResiduals, bool kF16>
__device__ __forceinline__ void consume(const Params& p, uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, int bh, int b, int h, int len,
                                        int t_lo, int ntiles, int w0, int ct) {
  using L = Layout<D, NS>;
  constexpr int KS = D / 16;   // k-steps of q.k^T over the head dim
  constexpr int NT = BK / 8;   // 8-key column groups of the score tile
  constexpr int NO = D / 8;    // 8-dim column groups of the output
  const int T = p.T;
  const int warp = ct / 32, lane = ct % 32;
  const int g = lane / 4, tg = lane % 4;
  const int r0 = w0 + warp * 16 + g;  // this thread's rows r0 and r0 + 8
  const int rows[2] = {r0, r0 + 8};

  // q rows as 16-bit A fragments (scaled first where the rule says so)
  const float* qb = p.q + b * p.qs.b + h * p.qs.h;
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    float2 x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = rows[e & 1];
      const int c = kk * 16 + tg * 2 + (e >> 1) * 8;
      x[e] = row < T ? *reinterpret_cast<const float2*>(qb + (long long)row * p.qs.t + c)
                     : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      qf[kk][e] = pack2<kF16>(x[e].x * p.q_scale, x[e].y * p.q_scale);
  }

  int klo[2], khi[2];  // each row's visible keys; rows past T see none
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] < T) {
      key_range<R>(p, len, rows[i], klo[i], khi[i]);
    } else {
      klo[i] = khi[i] = 0;
    }
  }
  const int k_lo_max = max(klo[0], klo[1]);
  const int k_hi_min = min(khi[0], khi[1]);
  int w_lo, w_hi;  // the tiles this warpgroup's rows can see
  tile_range<R>(p, len, w0, min(WG_ROWS, T - w0), w_lo, w_hi);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG};  // running max (log2 domain)
  float l[2] = {0.f, 0.f};          // running sum over this thread's columns
  float s[BK / 2];                  // the score tile, then its probabilities
  uint32_t pa[BK / 16][4];          // P as 16-bit A fragments of P.V
  float alpha[2];

  // S = q . k^T of the tile in stage st (started, not waited for)
  auto start_scores = [&](int st) {
    const uint32_t k_addr = smem_u32(smem + st * L::STAGE);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint64_t desc = sw128_desc(k_addr + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024);
      wgmma_rs<BK, 0, kF16>(s, qf[kk], desc, kk > 0);
    }
    wgmma_commit();
  };
  // O += P . V of the tile in stage st: key columns 16kk..16kk+15 of P are
  // the A fragment of k-step kk
  auto start_pv = [&](int st) {
    const uint32_t v_addr = smem_u32(smem + st * L::STAGE) + L::TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t desc = sw128_desc(v_addr + kk * 16 * 128, BK * 128, 1024);
      wgmma_rs<D, 1, kF16>(acc, pa[kk], desc, 1);
    }
    wgmma_commit();
  };
  // mask the scores of tile t, then the online softmax with the scale
  // folded into the exponent: s becomes the probabilities, m and l (the
  // scaled, log2-domain max and the sum) advance, alpha is the rescale of
  // acc. The
  // four lanes of a quad share rows r0 and r0 + 8. A row that has seen only
  // masked keys subtracts 0, so its probabilities are 0 and an empty row
  // comes out 0.
  auto softmax = [&](int t) {
    const int k0 = t * BK;
    if (!(k0 >= k_lo_max && k0 + BK <= k_hi_min)) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int key = k0 + n * 8 + tg * 2 + (e & 1);
          if (key < klo[i] || key >= khi[i]) s[4 * n + e] = NEG_BIG;
        }
      }
    }
    // the row max of the raw scores; the scale is positive, so the scaled
    // max is the max times the scale
    float mt[2][2] = {{NEG_BIG, NEG_BIG}, {NEG_BIG, NEG_BIG}};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mt[0][n & 1] = fmaxf(mt[0][n & 1], fmaxf(s[4 * n], s[4 * n + 1]));
      mt[1][n & 1] = fmaxf(mt[1][n & 1], fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    const float c = p.s_scale;
    float sub[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x = fmaxf(mt[i][0], mt[i][1]);
      x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
      x = fmaxf(x, __shfl_xor_sync(FULL, x, 2));
      const float m_new = fmaxf(m[i], x == NEG_BIG ? NEG_BIG : x * c);
      sub[i] = m_new == NEG_BIG ? 0.f : m_new;
      alpha[i] = ex2(m[i] - sub[i]);
      m[i] = m_new;
    }
    float rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * n + e] = ex2(fmaf(s[4 * n + e], c, -sub[e >> 1]));
        rs[e >> 1][n & 1] += s[4 * n + e];
      }
    }
    l[0] = l[0] * alpha[0] + (rs[0][0] + rs[0][1]);
    l[1] = l[1] * alpha[1] + (rs[1][0] + rs[1][1]);
  };
  // once the previous P.V has completed: rescale acc, pack P
  auto rescale_and_pack = [&]() {
    if (__any_sync(FULL, alpha[0] != 1.f || alpha[1] != 1.f)) {  // the max moved
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[4 * n] *= alpha[0];
        acc[4 * n + 1] *= alpha[0];
        acc[4 * n + 2] *= alpha[1];
        acc[4 * n + 3] *= alpha[1];
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack2<kF16>(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack2<kF16>(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack2<kF16>(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack2<kF16>(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  // The block's tiles are j = 0..ntiles-1 (tile t_lo + j, stage j % NB);
  // this warpgroup computes [j_a, j_e) of them and only waits for and
  // releases the others. Its own tiles are pipelined: the scores of tile j
  // start together with P.V of tile j - 1, and the softmax of tile j
  // runs while that P.V is still on the tensor cores.
  const int j_a = min(max(w_lo - t_lo, 0), ntiles);
  const int j_e = max(min(w_hi - t_lo, ntiles), j_a);
  for (int j = 0; j < j_a; ++j) {
    mbar_wait(&full[j % NB], (j / NB) & 1);
    mbar_arrive(&empty[j % NB]);
  }
  if (j_a < j_e) {
    mbar_wait(&full[j_a % NB], (j_a / NB) & 1);
    fence_regs(s);
    wgmma_fence();
    start_scores(j_a % NB);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(t_lo + j_a);
    rescale_and_pack();
    for (int j = j_a + 1; j < j_e; ++j) {
      const int st = j % NB, prev = (j - 1) % NB;
      mbar_wait(&full[st], (j / NB) & 1);
      fence_regs(s);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      start_scores(st);
      start_pv(prev);
      wgmma_wait<1>();  // the scores of tile j; P.V of tile j - 1 may run on
      fence_regs(s);
      softmax(t_lo + j);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(&empty[prev]);
      rescale_and_pack();
    }
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
    start_pv((j_e - 1) % NB);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[(j_e - 1) % NB]);
  }
  for (int j = j_e; j < ntiles; ++j) {
    mbar_wait(&full[j % NB], (j / NB) & 1);
    mbar_arrive(&empty[j % NB]);
  }

  // o = acc / l, with l summed over the quad; rows past T are not written
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
  if (kResiduals && tg == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] < T) {
        const long long at = (long long)bh * T + rows[i];
        p.m_out[at] = m[i] * LN2;
        p.l_out[at] = l[i];
      }
    }
  }
  float* ob = p.o + ((long long)b * T * p.H + h) * D;
  const long long row_stride = (long long)p.H * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= T) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<float2*>(ob + rows[i] * row_stride + n * 8 + tg * 2) =
          make_float2(acc[4 * n + 2 * i] * inv[i], acc[4 * n + 2 * i + 1] * inv[i]);
    }
  }
}

template <int D, int NC, int NS, Rule R, bool kResiduals, bool kF16>
__global__ void __launch_bounds__((NC + 1) * 128, 1) flash_fwd_sm90(const Params p) {
  using L = Layout<D, NS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* empty = full + NB;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int T = p.T;
  const int len = min(max(p.lengths[b], 0), T);
  const int q0 = blockIdx.x * (NC * WG_ROWS);
  const int active = min(NC, (T - q0 + WG_ROWS - 1) / WG_ROWS);  // consumers with rows
  int t_lo, t_hi;
  tile_range<R>(p, len, q0, min(NC * WG_ROWS, T - q0), t_lo, t_hi);
  const int ntiles = t_hi - t_lo;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NB; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 128 * active);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // registers per thread: the launch gives each 65536 / (128 (NC + 1));
  // the producer keeps 56 (NC = 2) or 40 (NC = 3) and the consumers take
  // the rest
  constexpr int kProducerRegs = NC == 2 ? 56 : 40;
  constexpr int kConsumerRegs = NC == 2 ? 224 : 152;
  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    if constexpr (NC >= 2) setmaxnreg_dec<kProducerRegs>();
    produce<D, NS, kF16>(p, smem, full, empty, b, h, t_lo, ntiles, threadIdx.x % 128);
  } else {
    if constexpr (NC >= 2) setmaxnreg_inc<kConsumerRegs>();
    const int w0 = q0 + wg * WG_ROWS;
    if (w0 < T)
      consume<D, NS, R, kResiduals, kF16>(p, smem, full, empty, bh, b, h, len, t_lo, ntiles,
                                          w0, threadIdx.x % 128);
  }
}

// launches one configuration; the shared-memory attribute is set once per
// instantiation (the first launch), not on every launch
template <int D, int NC, int NS, Rule R, bool kResiduals, bool kF16>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  using L = Layout<D, NS>;
  static_assert(L::bytes <= 232448, "shared memory over the H100's 227 KB per block");
  static const cudaError_t attr =
      cudaFuncSetAttribute(flash_fwd_sm90<D, NC, NS, R, kResiduals, kF16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.T + NC * WG_ROWS - 1) / (NC * WG_ROWS), B * p.H);
  flash_fwd_sm90<D, NC, NS, R, kResiduals, kF16><<<grid, (NC + 1) * 128, L::bytes, stream>>>(p);
  return cudaGetLastError();
}

// Consumer warpgroups per block (64 query rows each) for a grid, the same
// rule for both kernels: the count whose grid takes the least estimated
// time, that is its waves of blocks (one block per SM) times the time a
// block of that many consumers takes per key tile. kTileCost holds those
// times relative to each other, fitted to runs on the H100 with the count
// forced to 1, 2 and 3 (per wave, 1 consumer took 0.73-0.79x the time of 2
// and 3 consumers 1.17-1.27x). With them the rule picks the fastest forced
// count at every shape measured (T = 128-15512, both kernels). max_nc caps
// it (3 needs D = 64: at D = 128 its consumers have too few registers).
inline int pick_consumers(int T, int BH, int sms, int max_nc) {
  constexpr int kTileCost[4] = {0, 14, 18, 22};
  int best = 1;
  long long best_cost = -1;
  for (int nc = 1; nc <= max_nc; ++nc) {
    const long long blocks = (long long)((T + nc * WG_ROWS - 1) / (nc * WG_ROWS)) * BH;
    const long long cost = (blocks + sms - 1) / sms * kTileCost[nc];
    if (best_cost < 0 || cost < best_cost) {
      best = nc;
      best_cost = cost;
    }
  }
  return best;
}

// launches the configuration pick_consumers chooses for this grid; the f32
// staging ring holds 4 tiles at D = 64 and 2 at D = 128 (shared memory:
// 177 / 225 KB)
template <int D, Rule R, bool kResiduals, bool kF16>
cudaError_t launch_picked(const Params& p, int B, cudaStream_t stream) {
  constexpr int NS = D == 64 ? 4 : 2;
  const int nc = pick_consumers(p.T, B * p.H, num_sms(), D == 64 ? 3 : 2);
  if constexpr (D == 64) {
    if (nc == 3) return launch<D, 3, NS, R, kResiduals, kF16>(p, B, stream);
  }
  if (nc == 2) return launch<D, 2, NS, R, kResiduals, kF16>(p, B, stream);
  return launch<D, 1, NS, R, kResiduals, kF16>(p, B, stream);
}

}  // namespace fwd
}  // namespace jv
