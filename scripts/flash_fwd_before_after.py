"""Kernels 1 and 3 of two checkouts timed in turns on one card.

    python scripts/flash_fwd_before_after.py OTHER_ROOT

OTHER_ROOT is another checkout of the repository (e.g. the parent commit
unpacked with `git archive` into a gitignored directory). Runs one child
process per turn, in the order other, this, this, other; each imports
`jyutvoice_tpu_torch` from its own root, builds kernels 1 and 3 there, and
prints one JSON line:
  - kernel 1 at T=512 (B=2, H=8, D=64, lengths 512/389: the 512-frame
    bucket): CUDA-event ms of 200 back-to-back launches (median of 3
    loops) and device ms (CUDA-graph replay); at T=15000 (lengths
    15000/13000: the 15000 bucket), CUDA-event ms;
  - kernel 3 at T=4096 (B=2, lengths 4096/3001), CUDA-event ms;
  - kernel 3 at batch 16, T=512, lengths 512, 508, ..., 452, on the inputs
    of the card test `test_flash_stock_backward_kernels_match_plain` (seed
    3, strided views of one projection): the elements past atol 5e-3 /
    rtol 1e-2 against `flash_stock_plain` and the largest |err|.
Timing helpers are `chip_smoke.py`'s. Prints the card's name and power
limit first. Needs a CUDA card.
"""

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(root):
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    from jyutvoice_tpu_torch import kernels
    from jyutvoice_tpu_torch.nn.flash_attention import flash_attention
    from jyutvoice_tpu_torch.nn.flash_stock import flash_stock, flash_stock_plain

    assert os.path.dirname(kernels.__file__).startswith(os.path.abspath(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.load("flash_attention")
    kernels.load("flash_stock")
    cs.warm_card()
    out = {"root": root}
    g = torch.Generator(device="cuda").manual_seed(0)
    for t, lens, iters in ((512, [512, 389], 200), (15000, [15000, 13000], 5)):
        q, k, v = (torch.randn(2, t, 8, 64, device="cuda", generator=g) for _ in range(3))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        fn = lambda: flash_attention(q, k, v, lengths, scale=0.125)  # noqa: E731
        out[f"k1_T{t}_ms"] = cs.cuda_time_ms(fn, iters, warmup=1 if t > 512 else 3)
        if t == 512:
            out["k1_T512_device_ms"] = cs.graph_time_ms(fn)
        del q, k, v
    q, k, v = (torch.randn(2, 4096, 8, 64, device="cuda", generator=g) for _ in range(3))
    lengths = torch.tensor([4096, 3001], dtype=torch.int32, device="cuda")
    out["k3_T4096_ms"] = cs.cuda_time_ms(lambda: flash_stock(q, k, v, lengths, scale=0.125), 50)
    # the card test's inputs
    g = torch.Generator(device="cuda").manual_seed(3)
    lens = [512 - 4 * i for i in range(16)]
    qkv = torch.randn(16, 512, 3 * 8 * 64, device="cuda", generator=g)
    q, k, v = (x.view(16, 512, 8, 64) for x in qkv.split(8 * 64, dim=-1))
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    o = flash_stock(q, k, v, lengths, scale=0.125)
    ref = flash_stock_plain(q, k, v, lengths, scale=0.125)
    gap = (o - ref).abs()
    out["k3_B16_T512_past_bar"] = int((gap > 5e-3 + 1e-2 * ref.abs()).sum())
    out["k3_B16_T512_max_abs_err"] = float(gap.max())
    print(json.dumps(out), flush=True)


def main():
    if sys.argv[1] == "--child":
        child(sys.argv[2])
        return
    other = os.path.abspath(sys.argv[1])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    rows = []
    for root in (other, HERE, HERE, other):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout, res.stderr, flush=True)
            sys.exit(1)
        rows.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)


if __name__ == "__main__":
    main()
