// Backward of the stock flash attention with segment ids from lengths
// (kernels 4 and 5).
//
// Replaces the two backward `pallas_call`s of JAX's stock TPU flash kernel
// (`jax/experimental/pallas/ops/tpu/flash_attention.py`):
// `_flash_attention_bwd_dkv` (kernel 4, dK and dV) and
// `_flash_attention_bwd_dq` (kernel 5, dQ), as `_flash_attention_bwd`
// calls them for the JAX package's estimator in training (non-causal,
// segment id of position i = (i < length), no bias). With the forward's
// residuals m and l (row max and row sum of the scaled scores) and
// di = sum(o * do, -1):
//   s  = (q . k) * scale, masked entries excluded   p  = exp(s - m) / l
//   dv = p^T do      dp = do v^T      ds = (dp - di) * p * scale
//   dk = ds^T q      dq = ds k
//
// Precision: every product runs on the tensor cores in TF32 (10 mantissa
// bits, operands rounded to nearest) with f32 accumulation. bf16 operands,
// kernel 3's choice, put the gradients about 1e-2 (max error over max value)
// from the f32 backward at the training shapes, mostly through the
// recomputed scores; TF32 brings that to about 1e-3 at twice the cost of a
// bf16 product.
//
// Layout: q, k, v and do are (B, T, H, D) with the last dim contiguous and
// any strides on B, T and H (the projections' views); m, l and di are
// contiguous (B, H, T); dq, dk and dv come out as contiguous f32 (B, T, H, D).
// T is a multiple of 64 and D is 64 or 128.
//
// What bounds it on the H100: at the training shape (B = 2, H = 8, D = 64,
// T = 2048, lengths 2048 and 1700) kernel 4 does 8 D flop per visible
// (query, key) pair and kernel 5 6 D, 29.5 and 22.1 GFLOP over 57.6 M pairs,
// against about 30 MB of f32 tensors: both are bound by operations. The
// design is kernel 3's: four warps of 16 rows per block, every product as
// mma.sync with the score, probability and gradient tiles in registers (a
// C fragment becomes the next product's A fragment), f32 tiles in shared
// memory by cp.async, two in flight, rounded to TF32 in place once they
// land. Kernel 4 gives a block 64 keys of one (b, h), holds their k and v
// rows as A fragments and accumulates dk and dv in registers while it walks
// the query tiles that see those keys; kernel 5 gives a block 64 queries,
// holds q and do as A fragments and accumulates dq while it walks the key
// tiles. Each walks only visible tiles, as kernel 3 does (a valid key tile
// meets valid queries only, a padded one padded queries only), so the work
// is len^2 + (T - len)^2 pairs per head. Nothing is written twice and no
// atomics are used. At D = 128 the fragments and accumulators exceed the
// register file and spill; the estimator runs D = 64. wgmma, TMA and warp
// specialisation are left for later work.

#include "mma.cuh"

namespace {

using jv::c_to_a_tf32;
using jv::cp_async16;
using jv::cp_async_commit;
using jv::cp_async_wait;
using jv::LOG2E;
using jv::mma_tf32;
using jv::Strides;

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per tile
constexpr int WARPS = 4;  // each warp owns 16 rows (keys in kernel 4, queries in 5)
constexpr int THREADS = WARPS * 32;

// f32 row pitch D + 4: both the scalar fragment reads along a row (bank
// 4 g + tg) and those down the rows (bank 8 tg + g) are conflict-free
template <int D>
struct Tile {
  static constexpr int LD = D + 4;
  static constexpr int FLOATS = 64 * LD;
};

template <int D>
struct DkvSmem {
  static constexpr int STAGE = 2 * Tile<D>::FLOATS + 3 * BQ;  // q, do, then m, l, di
  static constexpr size_t bytes = sizeof(float) * 2 * STAGE;
};

template <int D>
struct DqSmem {
  static constexpr int STAGE = 2 * Tile<D>::FLOATS;  // k, v
  static constexpr size_t bytes = sizeof(float) * 2 * STAGE;
};

// the tile range [lo, hi) of the other side that 64 rows starting at
// `start` can see
__device__ __forceinline__ void visible_tiles(int start, int len, int T, int& lo, int& hi) {
  lo = 0;
  hi = T / 64;
  if (start + 64 <= len) {
    hi = (len + 63) / 64;  // every row valid: [0, len)
  } else if (start >= len) {
    lo = len / 64;  // every row padded: [len, T)
  }
}

// copy 64 rows of D floats (row pitch `ld` in memory) into a tile
template <int D>
__device__ __forceinline__ void copy_tile(float* dst, const float* src, long long ld, int tid) {
  constexpr int CH = D / 4;  // 16-byte chunks per row
  for (int i = tid; i < 64 * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    cp_async16(dst + r * Tile<D>::LD + c, src + r * ld + c);
  }
}

// round a landed tile to TF32 in place
template <int D>
__device__ __forceinline__ void round_tile(float* t, int tid) {
  constexpr int CH = D / 4;
  for (int i = tid; i < 64 * CH; i += THREADS) {
    float4* p = reinterpret_cast<float4*>(t + (i / CH) * Tile<D>::LD + (i % CH) * 4);
    float4 x = *p;
    x.x = __uint_as_float(jv::to_tf32(x.x));
    x.y = __uint_as_float(jv::to_tf32(x.y));
    x.z = __uint_as_float(jv::to_tf32(x.z));
    x.w = __uint_as_float(jv::to_tf32(x.w));
    *p = x;
  }
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_stock_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ m_in, const float* __restrict__ l_in,
                           const float* __restrict__ di, float* __restrict__ dk,
                           float* __restrict__ dv, const int* __restrict__ lengths, int T,
                           int H, Strides qs, Strides ks, Strides vs, Strides dos,
                           float scale, float scale_log2) {
  using S = DkvSmem<D>;
  constexpr int LD = Tile<D>::LD;
  constexpr int KS = D / 8;   // 8-deep k-steps over the head dim
  constexpr int NQ = BQ / 8;  // 8-query n-tiles of the transposed score tile
  constexpr int ND = D / 8;   // 8-dim n-tiles of dk and dv
  extern __shared__ __align__(16) float smem[];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k_start = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int tg = lane % 4;
  const int len = min(max(lengths[b], 0), T);

  int qt_lo, qt_hi;
  visible_tiles(k_start, len, T, qt_lo, qt_hi);
  const bool mixed = k_start < len && len < k_start + BK;

  // this thread's keys c0 and c0 + 8; k and v as tf32 A fragments
  const int c0 = k_start + warp * 16 + g;
  uint32_t kf[KS][4], vf[KS][4];
  jv::load_a_rows_tf32<D>(kf, k + b * ks.b + h * ks.h, ks.t, c0, tg);
  jv::load_a_rows_tf32<D>(vf, v + b * vs.b + h * vs.h, vs.t, c0, tg);

  const float* qb = q + b * qs.b + h * qs.h;
  const float* db = dout + b * dos.b + h * dos.h;
  const long long row_base = (long long)bh * T;
  auto load_tile = [&](int qt, int stage) {
    float* q_s = smem + stage * S::STAGE;
    float* d_s = q_s + Tile<D>::FLOATS;
    float* st_s = d_s + Tile<D>::FLOATS;
    const int q0 = qt * BQ;
    copy_tile<D>(q_s, qb + q0 * qs.t, qs.t, tid);
    copy_tile<D>(d_s, db + q0 * dos.t, dos.t, tid);
    if (tid < 3 * BQ / 4) {  // m, l and di of the tile's rows, 16 chunks each
      const int which = tid / (BQ / 4), c = (tid % (BQ / 4)) * 4;
      const float* src = which == 0 ? m_in : (which == 1 ? l_in : di);
      cp_async16(st_s + which * BQ + c, src + row_base + q0 + c);
    }
    cp_async_commit();
  };

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  load_tile(qt_lo, 0);
  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int stage = (qt - qt_lo) & 1;
    if (qt + 1 < qt_hi) {
      load_tile(qt + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* q_s = smem + stage * S::STAGE;
    float* d_s = q_s + Tile<D>::FLOATS;
    round_tile<D>(q_s, tid);
    round_tile<D>(d_s, tid);
    __syncthreads();
    const float* m_s = d_s + Tile<D>::FLOATS;
    const float* l_s = m_s + BQ;
    const float* di_s = l_s + BQ;
    const int q0 = qt * BQ;
    const bool need_mask = mixed || (q0 < len && len < q0 + BQ);

    // s^T = k . q^T for 16 keys x 64 queries
    float st[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
      const float* qrow = q_s + (j * 8 + g) * LD + tg;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_tf32(st[j], kf[kk], bits(qrow[kk * 8]), bits(qrow[kk * 8 + 4]));
    }

    // p^T = exp2(s^T * scale * log2e - (m * log2e + log2 l)); masked entries 0
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = j * 8 + tg * 2 + e;
        const float lse2 = m_s[qc] * LOG2E + log2f(l_s[qc]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float p = exp2f(st[j][r * 2 + e] * scale_log2 - lse2);
          if (need_mask && ((c0 + r * 8 < len) != (q0 + qc < len))) p = 0.f;
          st[j][r * 2 + e] = p;
        }
      }
    }

    // dv += p^T . do: the p^T fragment of query n-tile j is the A fragment
    // of k-step j (k order permuted); do is read down its rows
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      uint32_t pa[4];
      c_to_a_tf32(pa, st[j]);
      const float* d0 = d_s + (j * 8 + tg * 2) * LD + g;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        mma_tf32(dv_acc[n], pa, bits(d0[n * 8]), bits(d0[n * 8 + LD]));
    }

    // dp^T = v . do^T, then ds^T = p^T * (dp^T - di) in place of p^T
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      float dpt[4] = {0.f, 0.f, 0.f, 0.f};
      const float* drow = d_s + (j * 8 + g) * LD + tg;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_tf32(dpt, vf[kk], bits(drow[kk * 8]), bits(drow[kk * 8 + 4]));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d_i = di_s[j * 8 + tg * 2 + e];
        st[j][e] *= dpt[e] - d_i;
        st[j][2 + e] *= dpt[2 + e] - d_i;
      }
    }

    // dk += ds^T . q; q is read down its rows
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      uint32_t pa[4];
      c_to_a_tf32(pa, st[j]);
      const float* q0p = q_s + (j * 8 + tg * 2) * LD + g;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        mma_tf32(dk_acc[n], pa, bits(q0p[n * 8]), bits(q0p[n * 8 + LD]));
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  // dk = scale * sum(ds^T q), dv as accumulated; rows c0 and c0 + 8
  const long long row_stride = (long long)H * D;
  float* dkb = dk + ((long long)b * T * H + h) * D;
  float* dvb = dv + ((long long)b * T * H + h) * D;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + tg * 2;
    *reinterpret_cast<float2*>(dkb + c0 * row_stride + c) =
        make_float2(dk_acc[n][0] * scale, dk_acc[n][1] * scale);
    *reinterpret_cast<float2*>(dkb + (c0 + 8) * row_stride + c) =
        make_float2(dk_acc[n][2] * scale, dk_acc[n][3] * scale);
    *reinterpret_cast<float2*>(dvb + c0 * row_stride + c) =
        make_float2(dv_acc[n][0], dv_acc[n][1]);
    *reinterpret_cast<float2*>(dvb + (c0 + 8) * row_stride + c) =
        make_float2(dv_acc[n][2], dv_acc[n][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_stock_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ m_in, const float* __restrict__ l_in,
                          const float* __restrict__ di, float* __restrict__ dq,
                          const int* __restrict__ lengths, int T, int H, Strides qs,
                          Strides ks, Strides vs, Strides dos, float scale,
                          float scale_log2) {
  using S = DqSmem<D>;
  constexpr int LD = Tile<D>::LD;
  constexpr int KS = D / 8;
  constexpr int NT = BK / 8;  // 8-key n-tiles of the score tile
  constexpr int ND = D / 8;   // 8-dim n-tiles of dq
  extern __shared__ __align__(16) float smem[];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q_start = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int tg = lane % 4;
  const int len = min(max(lengths[b], 0), T);

  int kt_lo, kt_hi;
  visible_tiles(q_start, len, T, kt_lo, kt_hi);
  const bool mixed = q_start < len && len < q_start + BQ;

  // this thread's rows r0 and r0 + 8: q and do as tf32 A fragments, and the
  // rows' log2-domain normaliser and di
  const int r0 = q_start + warp * 16 + g;
  uint32_t qf[KS][4], df[KS][4];
  jv::load_a_rows_tf32<D>(qf, q + b * qs.b + h * qs.h, qs.t, r0, tg);
  jv::load_a_rows_tf32<D>(df, dout + b * dos.b + h * dos.h, dos.t, r0, tg);
  const long long row0 = (long long)bh * T + r0;
  const float lse2[2] = {m_in[row0] * LOG2E + log2f(l_in[row0]),
                         m_in[row0 + 8] * LOG2E + log2f(l_in[row0 + 8])};
  const float d_i[2] = {di[row0], di[row0 + 8]};

  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  auto load_tile = [&](int kt, int stage) {
    float* k_s = smem + stage * S::STAGE;
    const int k0 = kt * BK;
    copy_tile<D>(k_s, kb + k0 * ks.t, ks.t, tid);
    copy_tile<D>(k_s + Tile<D>::FLOATS, vb + k0 * vs.t, vs.t, tid);
    cp_async_commit();
  };

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

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
    float* k_s = smem + stage * S::STAGE;
    float* v_s = k_s + Tile<D>::FLOATS;
    round_tile<D>(k_s, tid);
    round_tile<D>(v_s, tid);
    __syncthreads();
    const int k0 = kt * BK;
    const bool need_mask = mixed || (k0 < len && len < k0 + BK);

    // s = q . k^T, then p = exp2(s * scale * log2e - lse2), masked entries 0
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const float* krow = k_s + (j * 8 + g) * LD + tg;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_tf32(s[j], qf[kk], bits(krow[kk * 8]), bits(krow[kk * 8 + 4]));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        float p = exp2f(s[j][e] * scale_log2 - lse2[i]);
        if (need_mask && ((r0 + i * 8 < len) != (k0 + j * 8 + tg * 2 + (e % 2) < len))) p = 0.f;
        s[j][e] = p;
      }
    }

    // dp = do . v^T, then ds = p * (dp - di) in place of p
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
      const float* vrow = v_s + (j * 8 + g) * LD + tg;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_tf32(dp, df[kk], bits(vrow[kk * 8]), bits(vrow[kk * 8 + 4]));
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= dp[e] - d_i[e / 2];
    }

    // dq += ds . k: the ds fragment of key n-tile j is the A fragment of
    // k-step j (k order permuted); k is read down its rows
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t pa[4];
      c_to_a_tf32(pa, s[j]);
      const float* k0p = k_s + (j * 8 + tg * 2) * LD + g;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        mma_tf32(acc[n], pa, bits(k0p[n * 8]), bits(k0p[n * 8 + LD]));
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  const long long row_stride = (long long)H * D;
  float* qb = dq + ((long long)b * T * H + h) * D;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + tg * 2;
    *reinterpret_cast<float2*>(qb + r0 * row_stride + c) =
        make_float2(acc[n][0] * scale, acc[n][1] * scale);
    *reinterpret_cast<float2*>(qb + (r0 + 8) * row_stride + c) =
        make_float2(acc[n][2] * scale, acc[n][3] * scale);
  }
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const float* dout,
                       const float* m, const float* l, const float* di, float* dk, float* dv,
                       const int* lengths, int B, int T, int H, Strides qs, Strides ks,
                       Strides vs, Strides dos, float scale, cudaStream_t stream) {
  constexpr size_t bytes = DkvSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_stock_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(T / BK, B * H);
  flash_stock_bwd_dkv_kernel<D><<<grid, THREADS, bytes, stream>>>(
      q, k, v, dout, m, l, di, dk, dv, lengths, T, H, qs, ks, vs, dos, scale, scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const float* dout,
                      const float* m, const float* l, const float* di, float* dq,
                      const int* lengths, int B, int T, int H, Strides qs, Strides ks,
                      Strides vs, Strides dos, float scale, cudaStream_t stream) {
  constexpr size_t bytes = DqSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_stock_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(T / BQ, B * H);
  flash_stock_bwd_dq_kernel<D><<<grid, THREADS, bytes, stream>>>(
      q, k, v, dout, m, l, di, dq, lengths, T, H, qs, ks, vs, dos, scale, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements: (batch, time, head) of q, k, v and do.
extern "C" int jv_flash_stock_bwd_dkv(
    const float* q, const float* k, const float* v, const float* dout, const float* m,
    const float* l, const float* di, float* dk, float* dv, const int* lengths, int B, int T,
    int H, int D, long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long d_sb, long long d_st, long long d_sh, float scale, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T % BK) return (int)cudaErrorInvalidValue;
  Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh},
      dos{d_sb, d_st, d_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch_dkv<64>(q, k, v, dout, m, l, di, dk, dv, lengths, B, T, H, qs, ks, vs,
                               dos, scale, st);
  if (D == 128)
    return (int)launch_dkv<128>(q, k, v, dout, m, l, di, dk, dv, lengths, B, T, H, qs, ks,
                                vs, dos, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int jv_flash_stock_bwd_dq(
    const float* q, const float* k, const float* v, const float* dout, const float* m,
    const float* l, const float* di, float* dq, const int* lengths, int B, int T, int H,
    int D, long long q_sb, long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh, long long d_sb,
    long long d_st, long long d_sh, float scale, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T % BQ) return (int)cudaErrorInvalidValue;
  Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh},
      dos{d_sb, d_st, d_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch_dq<64>(q, k, v, dout, m, l, di, dq, lengths, B, T, H, qs, ks, vs, dos,
                              scale, st);
  if (D == 128)
    return (int)launch_dq<128>(q, k, v, dout, m, l, di, dq, lengths, B, T, H, qs, ks, vs,
                               dos, scale, st);
  return (int)cudaErrorInvalidValue;
}
