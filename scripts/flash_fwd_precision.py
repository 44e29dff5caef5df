"""Error budget of kernels 1 and 3's rounding (the forward flash main loop),
on the CPU.

    python scripts/flash_fwd_precision.py [--seeds N]

Emulates, in plain PyTorch, the rounding points of the shared forward main
loop (`jyutvoice_tpu_torch/csrc/flash_fwd_sm90.cuh`) at kernel 3's short
training shape (B=16, T=512, H=8, D=64, lengths 512, 508, ..., 452: the
card test `test_flash_stock_backward_kernels_match_plain[512-lengths10-64]`)
and at the long-form shape (B=2, T=2048, lengths 2048/1700), against
`flash_stock_plain` on the same seeded standard-normal q, k, v. Designs (the
operands rounded to bf16 or fp16; l summed over the f32 P or over the
rounded P that enters P.V):
  bf16:         q, k, P and v in bf16, l over the f32 P (kernel 1, and
                kernel 3 before the fix);
  bf16_sum:     the same, l over the rounded P;
  bf16_qk:      q and k in bf16, P and v exact (the scores' share);
  f16_pv:       q and k in bf16, P and v in fp16, l over the rounded P;
  f16:          q, k, P and v in fp16, l over the f32 P (kernel 3 now);
  f16_sum:      the same, l over the rounded P.
Prints, per design, the elements past atol 5e-3 / rtol 1e-2 (the card
test's bar) and the largest |err| - rtol |ref| over the padded rows and
over the valid rows.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from jyutvoice_tpu_torch.nn import flash_stock as fs  # noqa: E402

ATOL, RTOL = 5e-3, 1e-2
CASES = [(512, [512 - 4 * i for i in range(16)]), (2048, [2048, 1700])]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _f16(x):
    return x.to(torch.float16).float()


def _exact(x):
    return x


DESIGNS = {  # (rounding of q and k, of P and v, whether l sums the rounded P)
    "bf16": (_bf16, _bf16, False),
    "bf16_sum": (_bf16, _bf16, True),
    "bf16_qk": (_bf16, _exact, False),
    "f16_pv": (_bf16, _f16, True),
    "f16": (_f16, _f16, False),
    "f16_sum": (_f16, _f16, True),
}


def emulate(q, k, v, lengths, scale, round_qk, round_pv, rounded_sum):
    """(B, T, H, D) output of the main loop's rounding, one tile per row
    (the row max is exact, as it is once the online max settles)."""
    s = torch.einsum("bqhd,bkhd->bhqk", round_qk(q), round_qk(k)) * scale
    s = s + torch.where(fs.segment_keep_mask(lengths, q.shape[1]), 0.0, fs.MASK_VALUE)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pr = round_pv(p)
    l = (pr if rounded_sum else p).sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", pr / l, round_pv(v))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    for t, lengths in CASES:
        stats = {d: [0, 0.0, 0.0] for d in DESIGNS}
        for seed in range(args.seeds):
            g = torch.Generator().manual_seed(seed)
            for b, n in enumerate(lengths):  # one batch row at a time
                q, k, v = (torch.randn(1, t, 8, 64, generator=g) for _ in range(3))
                lens = torch.tensor([n], dtype=torch.int32)
                ref = fs.flash_stock_plain(q, k, v, lens, scale=0.125)
                pad = torch.arange(t) >= n
                for d, rounding in DESIGNS.items():
                    got = emulate(q, k, v, lens, 0.125, *rounding)
                    over = (got - ref).abs() - RTOL * ref.abs()
                    stats[d][0] += int((over > ATOL).sum())
                    if pad.any():
                        stats[d][1] = max(stats[d][1], float(over[:, pad].max()))
                    stats[d][2] = max(stats[d][2], float(over[:, ~pad].max()))
        print(f"T={t} lengths={lengths[0]}..{lengths[-1]} x{len(lengths)}, {args.seeds} seeds:")
        for d, (n_over, worst_pad, worst_valid) in stats.items():
            print(f"  {d:8s} past the bar {n_over:4d}   max |err| - rtol|ref|: "
                  f"padded rows {worst_pad:.3e}, valid rows {worst_valid:.3e} (atol {ATOL})")


if __name__ == "__main__":
    main()
