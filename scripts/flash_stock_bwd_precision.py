"""Error budget of kernels 4 and 5's rounding, on the CPU.

    python scripts/flash_stock_bwd_precision.py [--heads N]

For each shape of `chip_smoke.py`'s phase 8 and of the card tests of the
stock flash backward, runs `flash_stock_bwd_rounded` (the kernels' rounding
points in plain PyTorch) in two designs against the plain f32 backward on
the same seeded inputs (q, k, v, do standard normal, scale D^-0.5, the plain
forward's m and l), one (batch row, head) at a time:
  tf32:  every product's operands rounded to TF32 (the kernels' design);
  mixed: the scores' q and k in TF32, every other operand in bf16.
Prints max |err| / max |ref| per gradient; the bar is 1e-2, and a design
is kept only at or under 5e-3 everywhere.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from jyutvoice_tpu_torch.nn import flash_stock as fs  # noqa: E402
from jyutvoice_tpu_torch.nn.resblock_stage import tf32_round  # noqa: E402

CASES = [  # (T, lengths, D): phase 8, then the card tests
    (2048, [2048, 1700], 64), (2560, [2560, 2148], 64), (4096, [4096, 3001], 64),
    (2048, [2048, 1700], 128), (512, [512] * 8 + [300] * 8, 64),
    (64, [64, 30], 64), (192, [1, 192], 64), (2112, [1, 63, 65, 2111], 64),
    (512, [1, 512], 64), (640, [0, 333], 64), (1024, [700, 1024], 128), (256, [100, 191], 64),
]
DESIGNS = {
    "tf32": dict(round_scores=tf32_round, round_grads=tf32_round),
    "mixed": dict(round_scores=tf32_round, round_grads=lambda x: x.to(torch.bfloat16).float()),
}


def errors(t, lengths, d, heads, seed=0):
    g = torch.Generator().manual_seed(seed)
    worst = {k: {n: 0.0 for n in ("dq", "dk", "dv")} for k in DESIGNS}
    top = {n: 0.0 for n in ("dq", "dk", "dv")}
    err = {k: {n: 0.0 for n in ("dq", "dk", "dv")} for k in DESIGNS}
    for n in lengths:
        lens = torch.tensor([n], dtype=torch.int32)
        for _ in range(heads):
            q, k, v, do = (torch.randn(1, t, 1, d, generator=g) for _ in range(4))
            o, m, l = fs.flash_stock_plain(q, k, v, lens, scale=d ** -0.5, residuals=True)
            ref = fs.flash_stock_bwd_plain(q, k, v, o, do, m, l, lens, scale=d ** -0.5)
            di = fs.flash_stock_di(o, do)
            for name, r in zip(("dq", "dk", "dv"), ref):
                top[name] = max(top[name], float(r.abs().max()))
            for design, kw in DESIGNS.items():
                got = fs.flash_stock_bwd_rounded(q, k, v, do, m, l, di, lens, scale=d ** -0.5,
                                                 **kw)
                for name, x, r in zip(("dq", "dk", "dv"), got, ref):
                    err[design][name] = max(err[design][name], float((x - r).abs().max()))
    for design in DESIGNS:
        for name in top:
            worst[design][name] = err[design][name] / top[name]
    return worst


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--heads", type=int, default=8)
    args = ap.parse_args()
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    overall = {k: 0.0 for k in DESIGNS}
    for t, lengths, d in CASES:
        w = errors(t, lengths, d, args.heads)
        cells = "  ".join(f"{k}: " + " ".join(f"{n}={x:.2e}" for n, x in v.items())
                          for k, v in w.items())
        print(f"T={t} lengths={lengths} D={d}  {cells}", flush=True)
        for k in DESIGNS:
            overall[k] = max(overall[k], *w[k].values())
    print("worst over all cases: " + ", ".join(f"{k} {v:.2e}" for k, v in overall.items()))


if __name__ == "__main__":
    main()
