// Forward flash attention with inline key-padding and streaming-chunk masks.
//
// Replaces the JAX package's Pallas kernel
// `jyutvoice_tpu/nn/pallas/attention.py::flash_attention` (`_flash_kernel`).
// It computes the same function with the same rounding points: q is scaled
// in f32 and rounded to bf16, k and v are rounded to bf16, the probabilities
// p are rounded to bf16 before P.V, and both products accumulate in f32, as
// do the running max m, the running sum l and the output accumulator.
// Keys at or past a row's valid length, or outside its streaming chunk band,
// are masked to -1e30; key blocks that no query of the block can see are
// skipped; a query row whose key range is empty comes out 0.
//
// Layout: q, k, v are (B, T, H, D) with the last dim contiguous and any
// strides on B, T and H, so the estimator's (B, T, H*D) projections are read
// in place with no head split copy; o is written as a contiguous
// (B, T, H, D), which is already the merged-heads (B, T, HD) layout. T may be
// any length: the ragged last query and key tiles are masked here.
//
// What bounds it on the H100: at the estimator's shapes (BH = 16, D = 64,
// T = 512-640) the work is about 1 GFLOP per launch against 8 MB of f32
// q/k/v/o, so the bound is the memory traffic (about 2.5 us at 3.35 TB/s);
// a launch that small is in practice bounded by latency and by how many
// blocks fill the card. The design keeps one 64-row query tile per block
// (BH * T/64 blocks), stages each 64-key tile of k and v in shared memory as
// bf16 once for all four warps, and runs both products on the tensor cores
// (wmma 16x16x16 bf16 -> f32). The online softmax works on the score tile in
// shared memory, one warp per 16 query rows and two lanes per row. Pipelined
// loads (cp.async/TMA) and register-resident accumulators are left for later
// work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int WARPS = 4;     // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;

template <int D>
struct Smem {
  static constexpr int LDH = D + 8;     // bf16 row pitch of q, k, v tiles
  static constexpr int LDS = BK + 4;    // f32 row pitch of the score tile
  static constexpr int LDP = BK + 8;    // bf16 row pitch of the prob tile
  static constexpr int LDO = D + 4;     // f32 row pitch of the accumulator
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(__nv_bfloat16) * BQ * LDH;
  static constexpr size_t v = k + sizeof(__nv_bfloat16) * BK * LDH;
  static constexpr size_t s = v + sizeof(__nv_bfloat16) * BK * LDH;
  static constexpr size_t p = s + sizeof(float) * BQ * LDS;
  static constexpr size_t o = p + sizeof(__nv_bfloat16) * BQ * LDP;
  static constexpr size_t m = o + sizeof(float) * BQ * LDO;
  static constexpr size_t l = m + sizeof(float) * BQ;
  static constexpr size_t alpha = l + sizeof(float) * BQ;
  static constexpr size_t bytes = alpha + sizeof(float) * BQ;
};

struct Strides {
  long long b, t, h;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 const int* __restrict__ lengths, int T, int H, Strides qs,
                 Strides ks, Strides vs, float scale, int chunk, int left) {
  using S = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + S::q);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + S::k);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + S::v);
  float* s_s = reinterpret_cast<float*>(smem + S::s);
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem + S::p);
  float* o_s = reinterpret_cast<float*>(smem + S::o);
  float* m_s = reinterpret_cast<float*>(smem + S::m);
  float* l_s = reinterpret_cast<float*>(smem + S::l);
  float* a_s = reinterpret_cast<float*>(smem + S::alpha);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q_start = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int valid = min(lengths[b], T);
  constexpr int V4 = D / 4;  // float4 per row

  // q tile: scale in f32, round to bf16; rows past T are zero
  const float* qb = q + b * qs.b + h * qs.h;
  for (int i = tid; i < BQ * V4; i += THREADS) {
    int r = i / V4, c = (i % V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q_start + r < T)
      x = *reinterpret_cast<const float4*>(qb + (q_start + r) * qs.t + c);
    __nv_bfloat16* dst = q_s + r * S::LDH + c;
    dst[0] = __float2bfloat16(x.x * scale);
    dst[1] = __float2bfloat16(x.y * scale);
    dst[2] = __float2bfloat16(x.z * scale);
    dst[3] = __float2bfloat16(x.w * scale);
  }
  for (int i = tid; i < BQ * S::LDO; i += THREADS) o_s[i] = 0.f;
  for (int i = tid; i < BQ; i += THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }

  // key blocks this query block can see (the Pallas kernel's bounds)
  int kb_lo, kb_hi;
  if (chunk > 0) {
    int blk_end = ((q_start + BQ - 1) / chunk + 1) * chunk;
    int blk_start = left >= 0 ? max((q_start / chunk - left) * chunk, 0) : 0;
    kb_lo = blk_start / BK;
    kb_hi = (min(blk_end, T) + BK - 1) / BK;
  } else {
    kb_lo = 0;
    kb_hi = (T + BK - 1) / BK;
  }
  kb_hi = min(kb_hi, (valid + BK - 1) / BK);

  const float* kb_ptr = k + b * ks.b + h * ks.h;
  const float* vb_ptr = v + b * vs.b + h * vs.h;
  const int row0 = warp * 16;  // this warp's first query row in the tile

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k_start = kb * BK;
    __syncthreads();  // previous tile's k/v/p no longer in use
    for (int i = tid; i < BK * V4; i += THREADS) {
      int r = i / V4, c = (i % V4) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k_start + r < T) {
        kx = *reinterpret_cast<const float4*>(kb_ptr + (k_start + r) * ks.t + c);
        vx = *reinterpret_cast<const float4*>(vb_ptr + (k_start + r) * vs.t + c);
      }
      __nv_bfloat16* kd = k_s + r * S::LDH + c;
      __nv_bfloat16* vd = v_s + r * S::LDH + c;
      kd[0] = __float2bfloat16(kx.x); kd[1] = __float2bfloat16(kx.y);
      kd[2] = __float2bfloat16(kx.z); kd[3] = __float2bfloat16(kx.w);
      vd[0] = __float2bfloat16(vx.x); vd[1] = __float2bfloat16(vx.y);
      vd[2] = __float2bfloat16(vx.z); vd[3] = __float2bfloat16(vx.w);
    }
    __syncthreads();

    // S = q16 . k16^T for this warp's 16 rows x 64 keys, f32 accumulate
    for (int n0 = 0; n0 < BK; n0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int d0 = 0; d0 < D; d0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, q_s + row0 * S::LDH + d0, S::LDH);
        wmma::load_matrix_sync(bt, k_s + n0 * S::LDH + d0, S::LDH);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(s_s + row0 * S::LDS + n0, acc, S::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: lanes 2r and 2r+1 own row r of the warp's 16, 32 keys
    // each; a lane visits its keys from a lane-rotated start so the warp's
    // shared-memory reads fall in distinct banks
    {
      const int rr = lane >> 1, half = lane & 1;
      const int r = row0 + rr;
      const int q_pos = q_start + r;
      int start = 0, ending = T;
      if (chunk > 0) {
        int ci = q_pos / chunk;
        ending = (ci + 1) * chunk;
        start = left >= 0 ? max((ci - left) * chunk, 0) : 0;
      }
      const float* srow = s_s + r * S::LDS + half * 32;
      __nv_bfloat16* prow = p_s + r * S::LDP + half * 32;
      const int kbase = k_start + half * 32;
      float sv[32];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = (j + lane) & 31;
        const int k_pos = kbase + c;
        const bool keep = k_pos < valid && k_pos < ending && k_pos >= start;
        sv[j] = keep ? srow[c] : NEG_INF;
        mx = fmaxf(mx, sv[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float p = expf(sv[j] - m_new);
        sum += p;
        prow[(j + lane) & 31] = __float2bfloat16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __syncwarp();  // both lanes of a pair have read m_s[r]
      if (half == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncwarp();

    // acc = acc * alpha (per row), then acc += p16 . v16
    for (int i = lane; i < 16 * D; i += 32) {
      int r = row0 + i / D, c = i % D;
      o_s[r * S::LDO + c] *= a_s[r];
    }
    __syncwarp();
    for (int d0 = 0; d0 < D; d0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, o_s + row0 * S::LDO + d0, S::LDO, wmma::mem_row_major);
      for (int k0 = 0; k0 < BK; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, p_s + row0 * S::LDP + k0, S::LDP);
        wmma::load_matrix_sync(bv, v_s + k0 * S::LDH + d0, S::LDH);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(o_s + row0 * S::LDO + d0, acc, S::LDO, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // o = acc / max(l, 1e-30), rows past T are not written
  float* ob = o + ((long long)b * T * H + h) * D;
  for (int i = tid; i < BQ * V4; i += THREADS) {
    int r = i / V4, c = (i % V4) * 4;
    if (q_start + r >= T) continue;
    float inv_l = 1.f / fmaxf(l_s[r], 1e-30f);
    const float* src = o_s + r * S::LDO + c;
    float4 y = make_float4(src[0] * inv_l, src[1] * inv_l, src[2] * inv_l, src[3] * inv_l);
    *reinterpret_cast<float4*>(ob + (long long)(q_start + r) * H * D + c) = y;
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   const int* lengths, int B, int T, int H, Strides qs, Strides ks,
                   Strides vs, float scale, int chunk, int left, cudaStream_t stream) {
  constexpr size_t bytes = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(
      q, k, v, o, lengths, T, H, qs, ks, vs, scale, chunk, left);
  return cudaGetLastError();
}

}  // namespace

extern "C" int jv_flash_attention_fwd(
    const float* q, const float* k, const float* v, float* o, const int* lengths,
    int B, int T, int H, int D, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, float scale, int chunk, int left, void* stream) {
  Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch<64>(q, k, v, o, lengths, B, T, H, qs, ks, vs, scale, chunk, left, st);
  if (D == 128)
    return (int)launch<128>(q, k, v, o, lengths, B, T, H, qs, ks, vs, scale, chunk, left, st);
  return (int)cudaErrorInvalidValue;
}
