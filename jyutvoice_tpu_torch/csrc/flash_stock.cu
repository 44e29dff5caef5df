// Forward flash attention with segment ids built from lengths (kernel 3).
//
// Replaces JAX's stock TPU flash kernel, the forward `pallas_call` of
// `jax/experimental/pallas/ops/tpu/flash_attention.py::flash_attention`
// (`_flash_attention_kernel`), as the JAX package's estimator calls it for
// long-form full attention (`jyutvoice_tpu/models/estimator.py::_attend`,
// "flash_stock"): non-causal, segment id of position i = (i < length), query
// i sees key j iff the ids are equal. Valid queries see the valid keys and
// padded queries only the padded keys, so no row is empty and every row is
// computed, padded ones included. Scores are q.k accumulated in f32 and
// scaled after the product, as the stock kernel does; products take bf16
// inputs (q, k, the probabilities and v), which is what the TPU's default
// f32 matmul precision gives the stock kernel too.
//
// Layout: q, k, v are (B, T, H, D) with the last dim contiguous and any
// strides on B, T and H, so the estimator's (B, T, H*D) projections are read
// in place; o is a contiguous (B, T, H, D), the merged-heads layout. T is a
// multiple of 64 (the gate sends multiples of 512), D is 64 or 128.
//
// What bounds it on the H100: at the long-form shapes (B = 2, H = 8, D = 64,
// T = 2048-16384) a launch does 4 T^2 D B H flop (17 GFLOP at T = 2048)
// against 16 T B H D bytes of f32 q/k/v/o (8 MB), so it is bound by
// operations. The design: one block per 64 query rows of one (b, h), four
// warps of 16 rows each; both products run on the tensor cores as
// mma.sync m16n8k16 bf16 -> f32 with the scores, the probabilities and the
// output accumulator kept in registers (the score fragment of one product
// is the A fragment of the next), q held in registers for the whole block,
// and each 64-key tile of k and v copied as f32 into shared memory with
// cp.async, two tiles in flight. The online softmax works in the log2
// domain, one quad of lanes per pair of rows. A block walks only the key
// tiles its rows can see: valid blocks stop at the length, padded blocks
// start there. wgmma, TMA and warp specialisation are left for later work.
//
// For training, the launch also writes the backward's residuals (the f32
// row max m and row sum l of the scaled scores, (B, H, T), as the stock
// kernel's forward saves them). That is a second instantiation of the
// kernel, so the inference launch (null pointers) compiles as before.

#include "mma.cuh"

namespace {

using jv::cp_async16;
using jv::cp_async_commit;
using jv::cp_async_wait;
using jv::FULL;
using jv::LOG2E;
using jv::mma_bf16;
using jv::pack_bf16;
using jv::Strides;

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int WARPS = 4;  // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr float NEG_BIG = -1e30f;  // a masked score

template <int D>
struct Smem {
  // f32 row pitches chosen so the warp's fragment loads hit distinct banks:
  // k is read as float2 pairs along D, v as scalars down the keys
  static constexpr int LDK = D + 8;
  static constexpr int LDV = D + 4;
  static constexpr int K_FLOATS = BK * LDK;
  static constexpr int STAGE = K_FLOATS + BK * LDV;
  static constexpr size_t bytes = sizeof(float) * 2 * STAGE;
};

template <int D, bool kResiduals>
__global__ void __launch_bounds__(THREADS)
flash_stock_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   const int* __restrict__ lengths, int T, int H, Strides qs,
                   Strides ks, Strides vs, float scale_log2) {
  using S = Smem<D>;
  constexpr int KS = D / 16;  // k-steps of q.k^T over the head dim
  constexpr int NT = BK / 8;  // 8-key n-tiles of the score tile
  constexpr int NO = D / 8;   // 8-dim n-tiles of the output
  constexpr int CH = D / 4;   // 16-byte chunks per k or v row
  extern __shared__ __align__(16) float smem[];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q_start = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // fragment row group
  const int tg = lane % 4;  // thread in group
  const int len = min(max(lengths[b], 0), T);

  // key tiles this block's rows can see
  int kt_lo = 0, kt_hi = T / BK;
  if (q_start + BQ <= len) {
    kt_hi = (len + BK - 1) / BK;  // every row valid: keys [0, len)
  } else if (q_start >= len) {
    kt_lo = len / BK;  // every row padded: keys [len, T)
  }
  const bool mixed = q_start < len && len < q_start + BQ;

  // this thread's rows r0 and r0 + 8; q as bf16 A fragments for all of D
  const int r0 = q_start + warp * 16 + g;
  const float* qb = q + b * qs.b + h * qs.h;
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 16 + tg * 2;
    const float2 x0 = *reinterpret_cast<const float2*>(qb + r0 * qs.t + c);
    const float2 x1 = *reinterpret_cast<const float2*>(qb + (r0 + 8) * qs.t + c);
    const float2 x2 = *reinterpret_cast<const float2*>(qb + r0 * qs.t + c + 8);
    const float2 x3 = *reinterpret_cast<const float2*>(qb + (r0 + 8) * qs.t + c + 8);
    qf[kk][0] = pack_bf16(x0.x, x0.y);
    qf[kk][1] = pack_bf16(x1.x, x1.y);
    qf[kk][2] = pack_bf16(x2.x, x2.y);
    qf[kk][3] = pack_bf16(x3.x, x3.y);
  }

  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  auto load_tile = [&](int kt, int stage) {
    float* k_s = smem + stage * S::STAGE;
    float* v_s = k_s + S::K_FLOATS;
    const int k0 = kt * BK;
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 4;
      cp_async16(k_s + r * S::LDK + c, kb + (k0 + r) * ks.t + c);
      cp_async16(v_s + r * S::LDV + c, vb + (k0 + r) * vs.t + c);
    }
    cp_async_commit();
  };

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG};  // running max (log2 domain), rows r0, r0 + 8
  float l[2] = {0.f, 0.f};          // running sum over this thread's columns

  load_tile(kt_lo, 0);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) {
      load_tile(kt + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* k_s = smem + stage * S::STAGE;
    const float* v_s = k_s + S::K_FLOATS;
    const int k0 = kt * BK;

    // s = q . k^T for 16 rows x 64 keys, f32 accumulation
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const float* krow = k_s + (j * 8 + g) * S::LDK + tg * 2;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const float2 x0 = *reinterpret_cast<const float2*>(krow + kk * 16);
        const float2 x1 = *reinterpret_cast<const float2*>(krow + kk * 16 + 8);
        mma_bf16(s[j], qf[kk], pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y));
      }
    }

    // scale after the product (log2 domain), then the segment mask where a
    // row or this tile straddles the length
    const bool need_mask = mixed || (k0 < len && len < k0 + BK);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (need_mask) {
          const int row = r0 + (e / 2) * 8;
          const int key = k0 + j * 8 + tg * 2 + (e % 2);
          if ((row < len) != (key < len)) x = NEG_BIG;
        }
        s[j][e] = x;
      }
    }

    // online softmax; the four lanes of a quad share rows r0 and r0 + 8
    float mt[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mt[0] = fmaxf(mt[0], fmaxf(s[j][0], s[j][1]));
      mt[1] = fmaxf(mt[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(FULL, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(FULL, mt[i], 2));
      const float m_new = fmaxf(m[i], mt[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2f(s[j][0] - m[0]);
      s[j][1] = exp2f(s[j][1] - m[0]);
      s[j][2] = exp2f(s[j][2] - m[1]);
      s[j][3] = exp2f(s[j][3] - m[1]);
      rs[0] += s[j][0] + s[j][1];
      rs[1] += s[j][2] + s[j][3];
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += p . v: the score fragments of key n-tiles 2kk, 2kk + 1 are the
    // A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const float* v0 = v_s + (kk * 16 + tg * 2) * S::LDV + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const float* vp = v0 + n * 8;
        mma_bf16(acc[n], pa, pack_bf16(vp[0], vp[S::LDV]),
                 pack_bf16(vp[8 * S::LDV], vp[9 * S::LDV]));
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  // o = acc / l, with l summed over the quad
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 1.f;
  }
  if (kResiduals && tg == 0) {
    // residuals for the backward, (B, H, T): the row max in the natural-log
    // domain of the scaled scores and the sum of exp(s - max)
    const long long row0 = (long long)bh * T + r0;
    m_out[row0] = m[0] * jv::LN2;
    m_out[row0 + 8] = m[1] * jv::LN2;
    l_out[row0] = l[0];
    l_out[row0 + 8] = l[1];
  }
  float* ob = o + ((long long)b * T * H + h) * D;
  const long long row_stride = (long long)H * D;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + tg * 2;
    *reinterpret_cast<float2*>(ob + r0 * row_stride + c) =
        make_float2(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<float2*>(ob + (r0 + 8) * row_stride + c) =
        make_float2(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
}

template <int D, bool kResiduals>
cudaError_t launch_as(const float* q, const float* k, const float* v, float* o, float* m_out,
                      float* l_out, const int* lengths, int B, int T, int H, Strides qs,
                      Strides ks, Strides vs, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_stock_kernel<D, kResiduals>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(T / BQ, B * H);
  flash_stock_kernel<D, kResiduals><<<grid, THREADS, bytes, stream>>>(
      q, k, v, o, m_out, l_out, lengths, T, H, qs, ks, vs, scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* m_out,
                   float* l_out, const int* lengths, int B, int T, int H, Strides qs,
                   Strides ks, Strides vs, float scale, cudaStream_t stream) {
  if (m_out != nullptr && l_out != nullptr)
    return launch_as<D, true>(q, k, v, o, m_out, l_out, lengths, B, T, H, qs, ks, vs, scale,
                              stream);
  return launch_as<D, false>(q, k, v, o, nullptr, nullptr, lengths, B, T, H, qs, ks, vs, scale,
                             stream);
}

}  // namespace

// m_out and l_out ((B, H, T) f32) are written only when both are non-null,
// by the residual instantiation; the inference launch does no extra work.
extern "C" int jv_flash_stock_fwd(
    const float* q, const float* k, const float* v, float* o, float* m_out, float* l_out,
    const int* lengths, int B, int T, int H, int D, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, float scale, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T % BQ) return (int)cudaErrorInvalidValue;
  Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch<64>(q, k, v, o, m_out, l_out, lengths, B, T, H, qs, ks, vs, scale, st);
  if (D == 128)
    return (int)launch<128>(q, k, v, o, m_out, l_out, lengths, B, T, H, qs, ks, vs, scale, st);
  return (int)cudaErrorInvalidValue;
}
