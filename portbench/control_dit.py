"""The control of the DiT cell's comparison: the DiT reference put in the
program's place one precision below the configuration's (TF32 for its
float32), judged as the program's outputs are, as `control.py` does for
the other cells. A sound comparison reads it as not correct on every seed;
its readings set the upper end of each limit.

    python3 portbench/control_dit.py --workload dit.offline-b16 --seeds <n,n,...>

prints one JSON line per seed with the numbers that the cell's check
compares: "whole" (the control's own durations, mel and waveform) and
"staged" (durations at the configuration's precision, then the control's
mel and waveform), each over the traffic's sample (the longest of the first
32 requests, then seeded picks) at the requests' own sizes, without the
program.
"""

from __future__ import annotations

import argparse
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

from portbench import check, layout_dit  # noqa: E402
from portbench.control import tf32  # noqa: E402
from portbench.kinds import serve, serve_dit  # noqa: E402
from portbench.reference import dit as dit_ref  # noqa: E402
from portbench.reference import model as ref  # noqa: E402


def readings(conf, traffic, seed: int, device, n_pool: int = 32):
    dev = torch.device(device)
    model = conf["model"]
    tts_t, hift_t, _ = layout_dit.model_trees(model, seed, dev)
    trees = (tts_t, hift_t)
    with tf32(False):
        reqs, ls = serve.sized(trees, conf, traffic, seed, dev)
    control, own = ref.Numerics(tf32=True), ref.Numerics()
    rng = np.random.default_rng(seed + 1)
    noise = serve.noise_buffer(dev)
    pool = reqs[:n_pool]
    longest = max(range(len(pool)), key=lambda i: pool[i].tokens)
    pick = [longest] + [int(i) for i in rng.permutation(len(pool)) if i != longest]
    steps = traffic["engine"]["n_timesteps"]
    whole, staged = [], []
    with torch.no_grad():
        for i in pick[: traffic["check_sample"]]:
            r = pool[i]
            ids = serve.ids_of(r, dev)
            spk = torch.as_tensor(r.spk, device=dev)[None]

            def run(num, got):
                w = ref.durations(tts_t, model, ids, spk)
                y = int(max(float((torch.ceil(w) * ls).sum()), 1.0))
                return serve_dit.reference_outputs(trees, model, ids, spk, noise, ls, steps, got,
                                                   num, **serve.alone_route(traffic, model, y, dev))

            with tf32(True):
                _, c_mel, c_wav = run(control, None)
            n = c_mel.shape[1]
            with tf32(False):
                off, mel, wav = run(own, n)
                whole.append(check.judge(off, mel, wav, n, c_mel[0].cpu().numpy(),
                                         c_wav.cpu().numpy(), hift_t, model["hift"]))
                off, mel, wav = run(own, None)
                frames = torch.ceil(ref.durations(tts_t, model, ids, spk)) * ls
            route = serve.alone_route(traffic, model, mel.shape[1], dev)
            with tf32(True):
                s_mel = dit_ref.mel(tts_t, model, ids, spk, frames, noise, steps, control,
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
    ap.add_argument("--workload", default="dit.offline-b16")
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    from portbench import run

    _, conf, traffic, limits, _, _ = run.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        got = readings(conf, traffic, seed, "cuda")
        fails = {k: {n: v > limits["limits"][n] for n, v in r.items()} for k, r in got.items()}
        print(json.dumps({"workload": args.workload, "seed": seed, "kind": "tf32",
                          "control": got, "over_limit": fails}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
