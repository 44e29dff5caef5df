"""The controls of the comparison that decides `correct`: the reference
put in the program's place, one precision below what the configuration
states (TF32 for the f32 configuration, int4 linears for the int8 one;
with `--control tf32`, the int8 one's int8 linears and TF32 elsewhere),
judged as the program's outputs are. A sound comparison reads each control
as not correct; its readings set the upper end of each limit.

    python3 portbench/control.py --workload <name> --seeds <n,n,...> [--control tf32]

prints one JSON line per seed with the numbers that the cell's check
compares. It runs the traffic's requests as the cell samples them (the
longest of the first `requests_for_control`, then seeded picks) at their
own sizes, without the program.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import check, layout  # noqa: E402
from portbench.kinds import serve  # noqa: E402
from portbench.reference import model as ref  # noqa: E402


@contextlib.contextmanager
def tf32(on: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def readings(conf, traffic, seed: int, device, n_pool: int = 32, kind: str = "below"):
    """The worst of each number over the sampled requests of one seed,
    with the control in the program's place: "whole" (the control's own
    durations, mel and waveform) and "staged" (durations at the
    configuration's precision, then the control's mel and waveform).
    kind: "below" (one precision below the configuration's) or "tf32"
    (the configuration's linears, TF32 everywhere else)."""
    dev = torch.device(device)
    model = conf["model"]
    tts_t, hift_t, _ = layout.model_trees(model, seed, dev)
    trees = (tts_t, hift_t)
    with tf32(False):
        reqs, ls = serve.sized(trees, conf, traffic, seed, dev)
    bits = 8 if conf["int8"] else 0
    if kind == "tf32":
        control = ref.Numerics(quant_bits=bits, tf32=True)
    else:
        control = ref.Numerics(quant_bits=4) if bits else ref.Numerics(tf32=True)
    rng = np.random.default_rng(seed + 1)
    noise = serve.noise_buffer(dev)
    pool = reqs[:n_pool]
    longest = max(range(len(pool)), key=lambda i: pool[i].tokens)
    pick = [longest] + [int(i) for i in rng.permutation(len(pool)) if i != longest]
    pick = pick[: traffic["check_sample"]]
    whole, staged = [], []
    steps = traffic["engine"]["n_timesteps"]
    with torch.no_grad():
        for i in pick:
            r = pool[i]
            ids = serve.ids_of(r, dev)
            spk = torch.as_tensor(r.spk, device=dev)[None]

            def run(num, got):
                frames = None if got is None else got[0]
                w = ref.durations(tts_t, model, ids, spk)
                y = int(max(float((torch.ceil(w) * ls).sum()), 1.0))
                return check.reference_outputs(trees, model, ids, spk, noise, ls, steps, frames,
                                               num, **serve.alone_route(traffic, model, y, dev))

            with tf32(control.tf32):
                _, c_mel, c_wav = run(control, None)
            c_frames = c_mel.shape[1]
            with tf32(False):
                off, mel, wav = run(ref.Numerics(quant_bits=bits), (c_frames,))
                whole.append(check.judge(off, mel, wav, c_frames, c_mel[0].cpu().numpy(),
                                         c_wav.cpu().numpy(), hift_t, model["hift"],
                                         serve.alone_route(traffic, model, c_frames,
                                                           dev)["window"]))
            # staged: the durations at the configuration's precision, the mel
            # phase and the vocoder in the control's, so that the mel and the
            # waveform read their own gaps where the control's durations moved
            with tf32(False):
                off, mel, wav = run(ref.Numerics(quant_bits=bits), None)
                frames = torch.ceil(ref.durations(tts_t, model, ids, spk)) * ls
            with tf32(control.tf32):
                route = serve.alone_route(traffic, model, mel.shape[1], dev)
                s_mel = ref.mel(tts_t, model, ids, spk, frames, noise, steps, control,
                                route["band"])
                pad = torch.zeros(1, check.TAIL, 80, device=dev)
                s_wav = check.pcm16(ref.vocode(hift_t, model["hift"], torch.cat([s_mel, pad], 1),
                                               window=route["window"])[0])
            with tf32(False):
                staged.append(check.judge(off, mel, wav, mel.shape[1], s_mel[0].cpu().numpy(),
                                          s_wav.cpu().numpy(), hift_t, model["hift"],
                                          route["window"]))
    return {"whole": check.worst(whole), "staged": check.worst(staged)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", choices=("below", "tf32"), default="below")
    args = ap.parse_args(argv)
    from portbench import run

    wl, conf, traffic, limits, _, _ = run.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed, "kind": args.control,
                          "control": readings(conf, traffic, seed, "cuda",
                                              kind=args.control)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
