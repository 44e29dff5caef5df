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
// scaled after the product, as the stock kernel does; products take fp16
// inputs (q, k, the probabilities and v). The TPU's default f32 matmul
// precision gives the stock kernel bf16 inputs, but with bf16 a padded row
// that sees 8-12 keys (batch 16 at T = 512) missed the bar atol 5e-3 /
// rtol 1e-2 against the f32 version, mostly through the rounding of q and
// k in its scores; fp16's 3 more mantissa bits keep every row within it
// (`scripts/flash_fwd_precision.py`). fp16 holds |q|, |k|, |v| up to 65504;
// the largest that reached this kernel in `chip_smoke.py`'s long-form and
// training phases (full-width estimator, seeded random weights; NVIDIA H100
// 80GB HBM3, 700 W) were |q| 3.52, |k| 3.18, |v| 3.33, and those phases fail
// on an input past fp16's range. Trained weights are not measured.
//
// Layout: q, k, v are (B, T, H, D) with the last dim contiguous and any
// strides on B, T and H, so the estimator's (B, T, H*D) projections are read
// in place; o is a contiguous (B, T, H, D), the merged-heads layout. T is a
// multiple of 64 (the gate sends multiples of 512), D is 64 or 128.
//
// What bounds it on the H100: at the long-form shapes (B = 2, H = 8, D = 64,
// T = 2048-16384) a launch does 4 T^2 D B H flop (17 GFLOP at T = 2048)
// against 16 T B H D bytes of f32 q/k/v/o (8 MB), so it is bound by
// operations, which only wgmma delivers at full rate on Hopper. Two limits
// stand in the way: the tensor cores must be fed from shared memory without
// the loads stalling them, and k and v arrive as f32, twice the bytes of
// bf16, re-read from L2 by every block of a (b, h). The design is the
// shared Hopper main loop of `flash_fwd_sm90.cuh`: 128 or 192 query rows
// per block (two or three consumer warpgroups of 64 rows on wgmma, scores
// and accumulator in registers) share every staged k/v tile, cutting the L2
// traffic of 64-row blocks by 2-3x; a producer warpgroup keeps four f32
// tiles in flight with cp.async and rounds each once into a swizzled fp16
// tile, so the rounding happens in the kernel and no cast pass goes through
// device memory. The header's `pick_consumers` chooses 1-3 consumers by the
// waves of blocks each gives, the same rule as kernel 1's; at the long-form
// shapes (B * H = 16, T >= 2048) that is two or three. A block walks only
// the key tiles its rows can see (valid rows stop at the length, padded
// rows start there) and each warpgroup computes only its own rows' tiles.
// Where T is not a multiple of the block's rows, the last block's spare
// warpgroups sit out.
//
// For training, the launch also writes the backward's residuals (the f32
// row max m, natural log, and row sum l of the scaled scores, (B, H, T), as
// the stock kernel's forward saves them). That is a second instantiation of
// the kernel, so the inference launch does no extra work.

#include "hopper.cuh"
#include "flash_fwd_sm90.cuh"

using jv::fwd::launch_picked;
using jv::fwd::Params;
using jv::fwd::Rule;

// m_out and l_out ((B, H, T) f32) are written only when both are non-null,
// by the residual instantiation; the inference launch does no extra work.
extern "C" int jv_flash_stock_fwd(
    const float* q, const float* k, const float* v, float* o, float* m_out, float* l_out,
    const int* lengths, int B, int T, int H, int D, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, float scale, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T % 64) return (int)cudaErrorInvalidValue;
  const bool res = m_out != nullptr && l_out != nullptr;
  Params p{q, k, v, o, res ? m_out : nullptr, res ? l_out : nullptr, lengths, T, H,
           {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh},
           1.f, scale * jv::LOG2E, 0, -1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // fp16 products (kF16 true)
  if (D == 64)
    return (int)(res ? launch_picked<64, Rule::Segments, true, true>(p, B, st)
                     : launch_picked<64, Rule::Segments, false, true>(p, B, st));
  if (D == 128)
    return (int)(res ? launch_picked<128, Rule::Segments, true, true>(p, B, st)
                     : launch_picked<128, Rule::Segments, false, true>(p, B, st));
  return (int)cudaErrorInvalidValue;
}
