// Backward of the stock flash attention with segment ids from lengths
// (kernels 4 and 5), on Hopper's tf32 wgmma.
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
// Precision: every product runs on the tensor cores in TF32 (operands
// rounded to nearest, f32 accumulation); p and ds are formed in f32 and
// rounded where they enter a product. A plain-PyTorch emulation of these
// rounding points (`nn/flash_stock.py::flash_stock_bwd_rounded`) is within
// 1.72e-3 (max error over max value) of the f32 backward at the shapes of
// `chip_smoke.py`'s phase 8 and of the card tests; with bf16 operands
// outside the scores it reached 1.53e-2, past the 1e-2 bar
// (`scripts/flash_stock_bwd_precision.py`).
//
// Layout: one preparation launch (`jv_flash_stock_bwd_prep`) reads q, k, v
// and do ((B, T, H, D), last dim contiguous, any strides on B, T and H) and
// the residuals m and l (contiguous (B, H, T)) and writes, rounded to TF32,
// every 64-row tile of every (b, h) as the image wgmma reads, ready for a
// 1-D bulk copy: q, do, k and v as they are (64 rows x D, K-major: the B
// operand of s, s^T, dp, dp^T), and q, do and k transposed (D rows x 64,
// the 64 positions in the order [0, 2, 4, 6, 1, 3, 5, 7] within each 8,
// the order in which an accumulator serves as the next product's A
// operand), each 128-byte swizzled; and lse2 = m log2(e) + log2(l), the
// log2-domain normaliser, (B, H, T). `nn/flash_stock.py::
// flash_stock_bwd_prepare_plain` builds the same buffer in PyTorch. di is
// (B, H, T) f32; dq, dk and dv come out as contiguous f32 (B, T, H, D). T
// is a multiple of 64 and D is 64 or 128.
//
// What bounds it on the H100: at the training shape (B = 2, H = 8, D = 64,
// T = 2048, lengths 2048 and 1700) kernel 4 does 8 D flop per visible
// (query, key) pair and kernel 5 6 D, 29.5 and 22.1 GFLOP over 57.6 M
// pairs, against about 30 MB of f32 tensors: both are bound by operations,
// 0.060 and 0.045 ms at TF32's 495 TFLOP/s, which only wgmma reaches. What
// the design does about it:
// 1. Every product is a tf32 wgmma (m64n64k8). Kernel 4 runs, per 64 keys
//    and 64-query tile, s^T = k q^T and dp^T = v do^T (B: the q and do
//    tiles), then dv += p^T do and dk += ds^T q with p^T and ds^T taken
//    from the accumulators as register A operands (B: the permuted,
//    transposed do and q tiles). Kernel 5 runs s = q k^T, dp = do v^T and
//    dq += ds k the same way. The rows' own operands (k and v in kernel 4,
//    q and do in 5) are A fragments in registers at D = 64 and tiles in
//    shared memory at D = 128, where registers run out.
// 2. The rounding to TF32, the swizzle and the transposes happen once per
//    call in the preparation launch, not once per block that reads a tile
//    (each (b, h) has T / 64 blocks reading the same tiles).
// 3. Warp specialisation: one producer thread streams each tile the block
//    needs with bulk copies (TMA) into a ring of stages behind full/empty
//    mbarriers; one or two consumer warpgroups of 64 rows each share every
//    staged tile (the count picked per launch by the waves of blocks it
//    gives, `pick_consumers`), and setmaxnreg gives the producer's registers
//    to them. At D = 128 one consumer and one stage fit shared memory.
// 4. Each block walks only the tiles its rows can see (a valid row sees the
//    valid positions, a padded one the padded positions), so the work is
//    len^2 + (T - len)^2 pairs per head. Blocks run in launch order:
//    ranking them heaviest first from the lengths, in each block's
//    prologue, made both kernels 3-30 % slower on the H100 and gained
//    nothing with uneven lengths.
// 5. Nothing is written twice and no atomics are used: kernel 4 owns its
//    keys' dk and dv, kernel 5 its queries' dq, so the sums are
//    deterministic.

#include "hopper.cuh"

namespace {

using namespace jv;

constexpr int TR = 64;  // rows of a tile (keys of a key tile, queries of a query tile)
enum Region { QN = 0, DON, QT, DOT, KN, VN, KT, N_REGIONS };  // the prepared tile images
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

struct BwdParams {
  const float* prep;  // the prepared buffer (header, Layout)
  const float* di;    // (B, H, T)
  float* g0;          // dk (kernel 4) or dq (kernel 5), contiguous (B, T, H, D)
  float* g1;          // dv (kernel 4)
  const int* lengths;
  int B, T, H;
  float scale, scale_log2;
};

// f32 -> tf32 (10 mantissa bits), rounded to nearest with ties away from
// zero, as cvt.rna.tf32.f32 and `tf32_round` in PyTorch round
__device__ __forceinline__ float round_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// float offset of element (r, c) in a 128-byte-swizzled K-major image of
// `rows` rows x a multiple of 32 columns: 32-column blocks of rows x 128
// bytes, 16-byte chunk j of row r at chunk j ^ (r % 8)
__device__ __forceinline__ int img_offset(int rows, int r, int c) {
  return (c >> 5) * rows * 32 + r * 32 + ((((c & 31) >> 2) ^ (r & 7)) << 2) + (c & 3);
}

// the image of tile t of (b, h) = bh in region r
template <int D>
__device__ __forceinline__ const float* tile_img(const float* prep, int r, int B, int H, int T,
                                                 int bh, int t) {
  return prep + (long long)r * B * H * T * D + ((long long)bh * (T / TR) + t) * TR * D;
}

template <int D>
__device__ __forceinline__ const float* lse2_rows(const float* prep, int B, int H, int T) {
  return prep + (long long)N_REGIONS * B * H * T * D;
}

__device__ __forceinline__ int seq_len(const int* lengths, int b, int T) {
  return min(max(lengths[b], 0), T);
}

// the tiles [lo, hi) of the other side that n rows starting at `start` see
__device__ __forceinline__ void visible_tiles(int start, int n, int len, int T, int& lo, int& hi) {
  lo = 0;
  hi = T / TR;
  if (start + n <= len) {
    hi = (len + TR - 1) / TR;  // every row valid: [0, len)
  } else if (start >= len) {
    lo = len / TR;  // every row padded: [len, T)
  }
}

// the tf32 A fragments of rows r and r + 8 (r = 16 warp + g) of a tile
// image in device memory: k-step kk holds columns 8kk + tg and 8kk + tg + 4
template <int D>
__device__ __forceinline__ void load_a_tf32(uint32_t (&f)[D / 8][4], const float* img, int r,
                                            int tg) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int c = kk * 8 + tg;
    f[kk][0] = __float_as_uint(img[img_offset(TR, r, c)]);
    f[kk][1] = __float_as_uint(img[img_offset(TR, r + 8, c)]);
    f[kk][2] = __float_as_uint(img[img_offset(TR, r, c + 4)]);
    f[kk][3] = __float_as_uint(img[img_offset(TR, r + 8, c + 4)]);
  }
}

// descriptor of k-step kk of a K-major tile image at `addr` (`rows` rows)
__device__ __forceinline__ uint64_t kstep_desc(uint32_t addr, int rows, int kk) {
  return sw128_desc(addr + (kk / 4) * rows * 128 + (kk % 4) * 32, 16, 1024);
}

// acc (64 x 64) = A . B^T over D, A (the block's own rows) from registers
// (af) or from the tile image at a_addr, B the tile image at b_addr
template <int D, bool kASmem>
__device__ __forceinline__ void rows_product(float (&acc)[32], const uint32_t (&af)[kASmem ? 1 : D / 8][4],
                                             uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint64_t db = kstep_desc(b_addr, TR, kk);
    if constexpr (kASmem)
      wgmma_m64n64k8_tf32_ss(acc, kstep_desc(a_addr, TR, kk), db, kk > 0);
    else
      wgmma_tf32_rs<64>(acc, af[kk], db, kk > 0);
  }
}

// acc (64 x D) += X . Y, X (64 x 64) the tf32-rounded accumulator x, Y the
// transposed, permuted tile image at y_addr (D rows x 64); D = 128 runs as
// two 64-wide halves
template <int D>
__device__ __forceinline__ void grad_product(float (&acc)[D / 64][32], const float (&x)[32],
                                             uint32_t y_addr) {
#pragma unroll
  for (int j = 0; j < TR / 8; ++j) {
    const uint32_t a[4] = {__float_as_uint(x[4 * j]), __float_as_uint(x[4 * j + 2]),
                           __float_as_uint(x[4 * j + 1]), __float_as_uint(x[4 * j + 3])};
#pragma unroll
    for (int hf = 0; hf < D / 64; ++hf)
      wgmma_tf32_rs<64>(acc[hf], a, kstep_desc(y_addr + hf * 64 * 128, D, j), 1);
  }
}

template <int D, int NC, int NS>
struct DkvLayout {
  static constexpr int TILE = TR * D * 4;          // bytes of one tile image
  static constexpr int STAGE = 4 * TILE + 1024;    // q, do, q^T, do^T, then lse2 and di rows
  static constexpr int kv_off = NS * STAGE;        // D = 128: each consumer's k and v tiles
  static constexpr int bar_off = kv_off + (D == 128 ? NC * 2 * TILE : 0);
  static constexpr size_t bytes = bar_off + (2 * NS + 1) * 8 + 1024;  // + alignment slack
};

template <int D, int NC, int NS>
struct DqLayout {
  static constexpr int TILE = TR * D * 4;
  static constexpr int STAGE = 3 * TILE;          // k, v, k^T
  static constexpr int qa_off = NS * STAGE;       // D = 128: each consumer's q and do tiles
  static constexpr int bar_off = qa_off + (D == 128 ? NC * 2 * TILE : 0);
  static constexpr size_t bytes = bar_off + (2 * NS + 1) * 8 + 1024;
};

// ---- kernel 4: dk, dv -------------------------------------------------------

template <int D, int NC, int NS>
__device__ __forceinline__ void dkv_consume(const BwdParams& p, uint8_t* smem, uint64_t* full,
                                            uint64_t* empty, uint64_t* own_bar, int b, int h,
                                            int len, int t_lo, int ntiles, int k0, int wg,
                                            int ct) {
  using L = DkvLayout<D, NC, NS>;
  constexpr bool kASmem = D == 128;
  constexpr int NH = D / 64;
  const int T = p.T, bh = b * p.H + h;
  const int warp = ct / 32, lane = ct % 32, g = lane / 4, tg = lane % 4;
  const int c0 = k0 + warp * 16 + g;  // this thread's keys c0 and c0 + 8
  const bool key_valid[2] = {c0 < len, c0 + 8 < len};

  // k and v of this warpgroup's 64 keys: A fragments, or tiles in shared memory
  uint32_t kf[kASmem ? 1 : D / 8][4], vf[kASmem ? 1 : D / 8][4];
  const uint32_t k_addr = smem_u32(smem + L::kv_off + wg * 2 * L::TILE);
  const uint32_t v_addr = k_addr + L::TILE;
  if constexpr (kASmem) {
    mbar_wait(own_bar, 0);
  } else {
    load_a_tf32<D>(kf, tile_img<D>(p.prep, KN, p.B, p.H, T, bh, k0 / TR), warp * 16 + g, tg);
    load_a_tf32<D>(vf, tile_img<D>(p.prep, VN, p.B, p.H, T, bh, k0 / TR), warp * 16 + g, tg);
  }
  int w_lo, w_hi;
  visible_tiles(k0, TR, len, T, w_lo, w_hi);
  const bool key_mixed = k0 < len && len < k0 + TR;

  float dk[NH][32], dv[NH][32];
#pragma unroll
  for (int hf = 0; hf < NH; ++hf) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[hf][i] = dv[hf][i] = 0.f;
  }
  float st[32], dpt[32];  // s^T, then p^T; dp^T, then ds^T (64 keys x 64 queries)

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % NS, t = t_lo + j;
    mbar_wait(&full[s], (j / NS) & 1);
    if (t < w_lo || t >= w_hi) {  // a tile only the other warpgroup's keys see
      mbar_arrive(&empty[s]);
      continue;
    }
    const uint32_t qn = smem_u32(smem + s * L::STAGE);
    const uint32_t don = qn + L::TILE, qt = don + L::TILE, dot = qt + L::TILE;
    const float* lse2_s = reinterpret_cast<const float*>(smem + s * L::STAGE + 4 * L::TILE);
    const float* di_s = lse2_s + TR;

    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
    rows_product<D, kASmem>(st, kf, k_addr, qn);
    wgmma_commit();
    rows_product<D, kASmem>(dpt, vf, v_addr, don);
    wgmma_commit();

    // p^T = exp2(s^T scale log2(e) - lse2 of the query); masked entries 0.
    // st[4n + 2r + e] is key c0 + 8r, query column 8n + 2tg + e.
    const int q0 = t * TR;
    const bool need_mask = key_mixed || (q0 < len && len < q0 + TR);
    wgmma_wait<1>();
    fence_regs(st);
#pragma unroll
    for (int n = 0; n < TR / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = n * 8 + tg * 2 + e;
        const float lse = lse2_s[qc];
        const bool q_valid = q0 + qc < len;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x = ex2(fmaf(st[4 * n + 2 * r + e], p.scale_log2, -lse));
          if (need_mask && key_valid[r] != q_valid) x = 0.f;
          st[4 * n + 2 * r + e] = x;
        }
      }
    }
    // ds^T = p^T (dp^T - di), then both rounded to tf32 for their products
    wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int n = 0; n < TR / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d_i = di_s[n * 8 + tg * 2 + e];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * n + 2 * r + e;
          dpt[i] = round_tf32(st[i] * (dpt[i] - d_i));
          st[i] = round_tf32(st[i]);
        }
      }
    }
    fence_regs(st);
    fence_regs(dpt);
#pragma unroll
    for (int hf = 0; hf < NH; ++hf) {
      fence_regs(dk[hf]);
      fence_regs(dv[hf]);
    }
    wgmma_fence();
    grad_product<D>(dv, st, dot);   // dv += p^T . do
    grad_product<D>(dk, dpt, qt);   // dk += ds^T . q
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int hf = 0; hf < NH; ++hf) {
      fence_regs(dk[hf]);
      fence_regs(dv[hf]);
    }
    mbar_arrive(&empty[s]);
  }

  // dk = scale * sum(ds^T q), dv as accumulated; rows c0 and c0 + 8
  const long long row_stride = (long long)p.H * D;
  float* dkb = p.g0 + ((long long)b * T * p.H + h) * D;
  float* dvb = p.g1 + ((long long)b * T * p.H + h) * D;
#pragma unroll
  for (int hf = 0; hf < NH; ++hf) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = hf * 64 + n * 8 + tg * 2;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long at = (c0 + 8 * r) * row_stride + c;
        *reinterpret_cast<float2*>(dkb + at) =
            make_float2(dk[hf][4 * n + 2 * r] * p.scale, dk[hf][4 * n + 2 * r + 1] * p.scale);
        *reinterpret_cast<float2*>(dvb + at) =
            make_float2(dv[hf][4 * n + 2 * r], dv[hf][4 * n + 2 * r + 1]);
      }
    }
  }
}

// ---- kernel 5: dq -------------------------------------------------------------

template <int D, int NC, int NS>
__device__ __forceinline__ void dq_consume(const BwdParams& p, uint8_t* smem, uint64_t* full,
                                           uint64_t* empty, uint64_t* own_bar, int b, int h,
                                           int len, int t_lo, int ntiles, int q_first, int wg,
                                           int ct) {
  using L = DqLayout<D, NC, NS>;
  constexpr bool kASmem = D == 128;
  constexpr int NH = D / 64;
  const int T = p.T, bh = b * p.H + h;
  const int warp = ct / 32, lane = ct % 32, g = lane / 4, tg = lane % 4;
  const int r0 = q_first + warp * 16 + g;  // this thread's queries r0 and r0 + 8
  const bool row_valid[2] = {r0 < len, r0 + 8 < len};
  const float* lse2 = lse2_rows<D>(p.prep, p.B, p.H, T) + (long long)bh * T;
  const float lse[2] = {lse2[r0], lse2[r0 + 8]};
  const float d_i[2] = {p.di[(long long)bh * T + r0], p.di[(long long)bh * T + r0 + 8]};

  uint32_t qf[kASmem ? 1 : D / 8][4], df[kASmem ? 1 : D / 8][4];
  const uint32_t q_addr = smem_u32(smem + L::qa_off + wg * 2 * L::TILE);
  const uint32_t do_addr = q_addr + L::TILE;
  if constexpr (kASmem) {
    mbar_wait(own_bar, 0);
  } else {
    load_a_tf32<D>(qf, tile_img<D>(p.prep, QN, p.B, p.H, T, bh, q_first / TR), warp * 16 + g, tg);
    load_a_tf32<D>(df, tile_img<D>(p.prep, DON, p.B, p.H, T, bh, q_first / TR), warp * 16 + g,
                   tg);
  }
  int w_lo, w_hi;
  visible_tiles(q_first, TR, len, T, w_lo, w_hi);
  const bool row_mixed = q_first < len && len < q_first + TR;

  float dq[NH][32];
#pragma unroll
  for (int hf = 0; hf < NH; ++hf) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[hf][i] = 0.f;
  }
  float sc[32], dp[32];  // s, then p; dp, then ds (64 queries x 64 keys)

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % NS, t = t_lo + j;
    mbar_wait(&full[s], (j / NS) & 1);
    if (t < w_lo || t >= w_hi) {
      mbar_arrive(&empty[s]);
      continue;
    }
    const uint32_t kn = smem_u32(smem + s * L::STAGE);
    const uint32_t vn = kn + L::TILE, kt = vn + L::TILE;

    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    rows_product<D, kASmem>(sc, qf, q_addr, kn);
    wgmma_commit();
    rows_product<D, kASmem>(dp, df, do_addr, vn);
    wgmma_commit();

    // p = exp2(s scale log2(e) - lse2 of the row); sc[4n + 2r + e] is
    // query r0 + 8r, key column 8n + 2tg + e
    const int k0 = t * TR;
    const bool need_mask = row_mixed || (k0 < len && len < k0 + TR);
    wgmma_wait<1>();
    fence_regs(sc);
#pragma unroll
    for (int n = 0; n < TR / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool k_valid = k0 + n * 8 + tg * 2 + e < len;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x = ex2(fmaf(sc[4 * n + 2 * r + e], p.scale_log2, -lse[r]));
          if (need_mask && row_valid[r] != k_valid) x = 0.f;
          sc[4 * n + 2 * r + e] = x;
        }
      }
    }
    // ds = p (dp - di), rounded to tf32 for dq += ds . k
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = round_tf32(sc[i] * (dp[i] - d_i[(i >> 1) & 1]));
    fence_regs(dp);
#pragma unroll
    for (int hf = 0; hf < NH; ++hf) fence_regs(dq[hf]);
    wgmma_fence();
    grad_product<D>(dq, dp, kt);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int hf = 0; hf < NH; ++hf) fence_regs(dq[hf]);
    mbar_arrive(&empty[s]);
  }

  const long long row_stride = (long long)p.H * D;
  float* dqb = p.g0 + ((long long)b * T * p.H + h) * D;
#pragma unroll
  for (int hf = 0; hf < NH; ++hf) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = hf * 64 + n * 8 + tg * 2;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<float2*>(dqb + (r0 + 8 * r) * row_stride + c) =
            make_float2(dq[hf][4 * n + 2 * r] * p.scale, dq[hf][4 * n + 2 * r + 1] * p.scale);
      }
    }
  }
}

// ---- the two kernels: one block per item and head ------------------------------

// setmaxnreg moves registers within the block's launch allocation (65536 /
// threads a thread, in multiples of 8): what the producer gives back is all
// the consumers can take, or their setmaxnreg.inc waits forever
template <int NC>
constexpr bool regs_fit() {
  constexpr int threads = (NC + 1) * 128;
  return NC < 2 || (PRODUCER_REGS + NC * CONSUMER_REGS) * 128 <= 65536 / threads / 8 * 8 * threads;
}

template <int D, int NC, int NS, bool kDkv>
__global__ void __launch_bounds__((NC + 1) * 128, 1) flash_stock_bwd_sm90(const BwdParams p) {
  using LK = DkvLayout<D, NC, NS>;
  using LQ = DqLayout<D, NC, NS>;
  constexpr int STAGE = kDkv ? LK::STAGE : LQ::STAGE;
  constexpr int TILE = TR * D * 4;
  constexpr int bar_off = kDkv ? LK::bar_off : LQ::bar_off;
  constexpr int own_off = kDkv ? LK::kv_off : LQ::qa_off;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + bar_off);
  uint64_t* empty = full + NS;
  uint64_t* own_bar = empty + NS;  // D = 128: the consumers' own tiles

  // block x takes row block x / H % nblk of batch row x / H / nblk, head
  // x % H: the heads of one row block are launched together
  const int T = p.T, nblk = (T + NC * TR - 1) / (NC * TR);
  const int b = blockIdx.x / p.H / nblk, h = blockIdx.x % p.H, bh = b * p.H + h;
  const int len = seq_len(p.lengths, b, T);
  const int start = blockIdx.x / p.H % nblk * NC * TR;
  const int active = min(NC, (T - start) / TR);  // consumers with rows
  int t_lo, t_hi;
  visible_tiles(start, active * TR, len, T, t_lo, t_hi);
  const int ntiles = t_hi - t_lo;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * active);
    }
    mbar_init(own_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    if constexpr (NC >= 2) setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x % 128 == 0) {
      // the producer: the consumers' own tiles (D = 128), then per tile of
      // the other side its images (and, in kernel 4, its lse2 and di rows)
      if constexpr (D == 128) {
        mbar_arrive_expect_tx(own_bar, active * 2 * TILE);
        for (int c = 0; c < active; ++c) {
          const int t = start / TR + c;
          uint8_t* dst = smem + own_off + c * 2 * TILE;
          bulk_copy_g2s(dst, tile_img<D>(p.prep, kDkv ? KN : QN, p.B, p.H, T, bh, t), TILE, own_bar);
          bulk_copy_g2s(dst + TILE, tile_img<D>(p.prep, kDkv ? VN : DON, p.B, p.H, T, bh, t), TILE,
                        own_bar);
        }
      }
      const float* lse2 = lse2_rows<D>(p.prep, p.B, p.H, T) + (long long)bh * T;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % NS, t = t_lo + j;
        mbar_wait(&empty[s], ((j / NS) & 1) ^ 1);
        uint8_t* dst = smem + s * STAGE;
        if constexpr (kDkv) {
          mbar_arrive_expect_tx(&full[s], 4 * TILE + 2 * TR * 4);
          const int regions[4] = {QN, DON, QT, DOT};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            bulk_copy_g2s(dst + i * TILE, tile_img<D>(p.prep, regions[i], p.B, p.H, T, bh, t),
                          TILE, &full[s]);
          bulk_copy_g2s(dst + 4 * TILE, lse2 + t * TR, TR * 4, &full[s]);
          bulk_copy_g2s(dst + 4 * TILE + TR * 4, p.di + (long long)bh * T + t * TR, TR * 4,
                        &full[s]);
        } else {
          mbar_arrive_expect_tx(&full[s], 3 * TILE);
          const int regions[3] = {KN, VN, KT};
#pragma unroll
          for (int i = 0; i < 3; ++i)
            bulk_copy_g2s(dst + i * TILE, tile_img<D>(p.prep, regions[i], p.B, p.H, T, bh, t),
                          TILE, &full[s]);
        }
      }
    }
  } else {
    if constexpr (NC >= 2) setmaxnreg_inc<CONSUMER_REGS>();
    if (wg < active) {
      const int r_first = start + wg * TR;
      if constexpr (kDkv)
        dkv_consume<D, NC, NS>(p, smem, full, empty, own_bar, b, h, len, t_lo, ntiles, r_first,
                               wg, threadIdx.x % 128);
      else
        dq_consume<D, NC, NS>(p, smem, full, empty, own_bar, b, h, len, t_lo, ntiles, r_first,
                              wg, threadIdx.x % 128);
    }
  }
}

// Consumer warpgroups per block (64 rows each) for a grid: the count whose
// grid takes the least estimated time, its waves of blocks (one block per
// SM) times the time a block of that many consumers takes per tile,
// relative: 14 for one and 18 for two (fitted to kernel 3's forward on the
// H100; `flash_fwd_sm90.cuh::pick_consumers`). D = 128 takes one.
inline int pick_consumers(int T, int BH, int D) {
  if (D != 64) return 1;
  const int sms = jv::num_sms();
  constexpr long long kTileCost[3] = {0, 14, 18};
  int best = 1;
  long long best_cost = -1;
  for (int nc = 1; nc <= 2; ++nc) {
    const long long blocks = (long long)((T + nc * TR - 1) / (nc * TR)) * BH;
    const long long cost = (blocks + sms - 1) / sms * kTileCost[nc];
    if (best_cost < 0 || cost < best_cost) {
      best = nc;
      best_cost = cost;
    }
  }
  return best;
}

// launches one configuration; the shared-memory attribute is set and the
// compiled register count checked once per instantiation (the first launch)
template <int D, int NC, int NS, bool kDkv>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  constexpr size_t bytes = kDkv ? DkvLayout<D, NC, NS>::bytes : DqLayout<D, NC, NS>::bytes;
  static_assert(bytes <= 232448, "shared memory over the H100's 227 KB per block");
  static_assert(regs_fit<NC>(), "setmaxnreg asks for more registers than the block holds");
  constexpr int threads = (NC + 1) * 128;
  static const cudaError_t ready = [] {
    auto kernel = flash_stock_bwd_sm90<D, NC, NS, kDkv>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    // setmaxnreg draws on the registers the launch allocated: refuse a
    // build whose allocation is smaller than the budget (it would hang)
    if (NC >= 2 && attr.numRegs * threads < (PRODUCER_REGS + NC * CONSUMER_REGS) * 128)
      return cudaErrorInvalidConfiguration;
    return cudaSuccess;
  }();
  if (ready != cudaSuccess) return ready;
  const int nblk = (p.T + NC * TR - 1) / (NC * TR);
  flash_stock_bwd_sm90<D, NC, NS, kDkv><<<p.B * p.H * nblk, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool kDkv>
cudaError_t launch_picked(const BwdParams& p, int D, cudaStream_t stream) {
  // stages: as many as shared memory holds (kernel 4: 3 at D = 64, kernel
  // 5: 4; at D = 128 the consumer's own tiles leave room for one)
  if (D == 128) return launch<128, 1, 1, kDkv>(p, stream);
  constexpr int NS = kDkv ? 3 : 4;
  if (pick_consumers(p.T, p.B * p.H, D) == 2) return launch<64, 2, NS, kDkv>(p, stream);
  return launch<64, 1, NS, kDkv>(p, stream);
}

// ---- the preparation -----------------------------------------------------------

struct PrepParams {
  const float* src[4];  // q, do, k, v
  Strides st[4];
  const float* m;
  const float* l;
  float* prep;
  int B, T, H;
};

// block (t, bh): tile t of (b, h) of q, do, k and v into the prepared images
template <int D>
__global__ void __launch_bounds__(256) flash_stock_bwd_prep_kernel(const PrepParams p) {
  __shared__ float tile[TR][D + 1];  // one source tile, rounded, for the transpose
  const int t = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, T = p.T, tid = threadIdx.x;
  const int natural[4] = {QN, DON, KN, VN};
  const int transposed[4] = {QT, DOT, KT, -1};
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float* src = p.src[x] + b * p.st[x].b + h * p.st[x].h + (long long)t * TR * p.st[x].t;
    float* img = p.prep + (long long)natural[x] * p.B * p.H * T * D + ((long long)bh * (T / TR) + t) * TR * D;
    for (int i = tid; i < TR * D / 4; i += 256) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 v = *reinterpret_cast<const float4*>(src + r * p.st[x].t + c);
      v = make_float4(round_tf32(v.x), round_tf32(v.y), round_tf32(v.z), round_tf32(v.w));
      *reinterpret_cast<float4*>(img + img_offset(TR, r, c)) = v;
      if (transposed[x] >= 0) {
        tile[r][c] = v.x;
        tile[r][c + 1] = v.y;
        tile[r][c + 2] = v.z;
        tile[r][c + 3] = v.w;
      }
    }
    if (transposed[x] < 0) continue;
    __syncthreads();
    // row d of the transposed image, K index k (position 8 (k / 8) +
    // [0, 2, 4, 6, 1, 3, 5, 7][k % 8] of the tile)
    float* timg = p.prep + (long long)transposed[x] * p.B * p.H * T * D +
                  ((long long)bh * (T / TR) + t) * TR * D;
    for (int i = tid; i < D * TR / 4; i += 256) {
      const int d = i / (TR / 4), k = (i % (TR / 4)) * 4;  // 4 consecutive K indices
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = (k + e) & 7;
        v[e] = tile[((k + e) & ~7) + (kk < 4 ? 2 * kk : 2 * (kk - 4) + 1)][d];
      }
      *reinterpret_cast<float4*>(timg + img_offset(D, d, k)) = make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
  }
  if (tid < TR) {  // lse2 = m log2(e) + log2(l) of the tile's rows
    const long long row = (long long)bh * T + t * TR + tid;
    float* lse2 = p.prep + (long long)N_REGIONS * p.B * p.H * T * D;
    lse2[row] = __fadd_rn(__fmul_rn(p.m[row], LOG2E), log2f(p.l[row]));
  }
}

}  // namespace

// Floats of the prepared buffer for a shape: seven tile regions of
// B * H * T * D floats, then lse2 (B * H * T).
extern "C" long long jv_flash_stock_bwd_prep_floats(int B, int T, int H, int D) {
  return (long long)B * H * T * ((long long)N_REGIONS * D + 1);
}

// Strides are in elements: (batch, time, head) of q, k, v and do.
extern "C" int jv_flash_stock_bwd_prep(
    const float* q, const float* k, const float* v, const float* dout, const float* m,
    const float* l, float* prep, int B, int T, int H, int D, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, long long d_sb, long long d_st, long long d_sh,
    void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T % TR || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  PrepParams p{{q, dout, k, v},
               {{q_sb, q_st, q_sh}, {d_sb, d_st, d_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh}},
               m, l, prep, B, T, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(T / TR, B * H);
  if (D == 64)
    flash_stock_bwd_prep_kernel<64><<<grid, 256, 0, st>>>(p);
  else
    flash_stock_bwd_prep_kernel<128><<<grid, 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

static int bwd_check(int B, int T, int H, int D) {
  return B > 0 && H > 0 && T > 0 && T % TR == 0 && (D == 64 || D == 128);
}

// Kernel 4: dk and dv from the prepared buffer and di ((B, H, T)).
extern "C" int jv_flash_stock_bwd_dkv(const float* prep, const float* di, float* dk, float* dv,
                                      const int* lengths, int B, int T, int H, int D,
                                      float scale, void* stream) {
  if (!bwd_check(B, T, H, D)) return (int)cudaErrorInvalidValue;
  BwdParams p{prep, di, dk, dv, lengths, B, T, H, scale, scale * LOG2E};
  return (int)launch_picked<true>(p, D, static_cast<cudaStream_t>(stream));
}

// Kernel 5: dq from the same inputs.
extern "C" int jv_flash_stock_bwd_dq(const float* prep, const float* di, float* dq,
                                     const int* lengths, int B, int T, int H, int D, float scale,
                                     void* stream) {
  if (!bwd_check(B, T, H, D)) return (int)cudaErrorInvalidValue;
  BwdParams p{prep, di, dq, nullptr, lengths, B, T, H, scale, scale * LOG2E};
  return (int)launch_picked<false>(p, D, static_cast<cudaStream_t>(stream));
}
