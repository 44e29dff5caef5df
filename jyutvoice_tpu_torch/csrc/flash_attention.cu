// Forward flash attention with inline key-padding and streaming-chunk masks
// (kernel 1).
//
// Replaces the JAX package's Pallas kernel
// `jyutvoice_tpu/nn/pallas/attention.py::flash_attention` (`_flash_kernel`).
// It computes the same function with the same rounding points: q is scaled
// in f32 and rounded to bf16, k and v are rounded to bf16, the probabilities
// p are rounded to bf16 before P.V, and both products accumulate in f32, as
// do the running max m, the running sum l and the output accumulator.
// Keys at or past a row's valid length, or outside its streaming chunk band,
// are masked; key tiles that no query of the block can see are skipped; a
// query row whose key range is empty comes out 0.
//
// Layout: q, k, v are (B, T, H, D) with the last dim contiguous and any
// strides on B, T and H, so the estimator's (B, T, H*D) projections are read
// in place with no head split copy; o is written as a contiguous
// (B, T, H, D), which is already the merged-heads (B, T, HD) layout. T may be
// any length: the ragged last key tile is zero-filled by the loader and
// masked, and rows past T are neither read nor written.
//
// What bounds it on the H100: two regimes. On every short request
// (BH = 16, D = 64, T = 128-2048, 560 launches) a launch is about 1 GFLOP
// against 8 MB of f32 q/k/v/o, bytes-bound at about 2.5 us, and in practice
// bound by latency and by how many blocks fill the card. In the top mel
// bucket (T = 15000-15512) a launch is 0.8-0.9 TFLOP, bound by operations.
// The design is the shared Hopper main loop of `flash_fwd_sm90.cuh`
// (wgmma with scores and accumulator in registers, a producer warpgroup
// keeping k/v tiles in flight and rounding them once into swizzled bf16
// tiles), with 64, 128 or 192 query rows per block (1-3 consumer
// warpgroups sharing each staged tile) chosen for the grid by the header's
// `pick_consumers`, the same rule as kernel 3's: one consumer up to
// T = 512, where that gives twice the blocks and the grid is still one
// wave, two or three past it. The shared-memory attribute is set once per
// configuration.

#include "hopper.cuh"
#include "flash_fwd_sm90.cuh"

using jv::fwd::launch_picked;
using jv::fwd::Params;
using jv::fwd::Rule;

extern "C" int jv_flash_attention_fwd(
    const float* q, const float* k, const float* v, float* o, const int* lengths,
    int B, int T, int H, int D, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, float scale, int chunk, int left, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, nullptr, nullptr, lengths, T, H,
           {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh},
           scale, jv::LOG2E, chunk, left};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // bf16 products (kF16 false), as the Pallas kernel's
  if (D == 64) return (int)launch_picked<64, Rule::KeyBand, false, false>(p, B, st);
  if (D == 128) return (int)launch_picked<128, Rule::KeyBand, false, false>(p, B, st);
  return (int)cudaErrorInvalidValue;
}
