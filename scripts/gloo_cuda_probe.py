#!/usr/bin/env python3
"""Which torch.distributed operations the Gloo backend takes on CUDA tensors.

    python scripts/gloo_cuda_probe.py [--device cuda:0] [--timeout 60]

Two ranks share one device (the way `chip_smoke.py` phase 13 runs two ranks
on one card). Each operation runs in its own pair of processes, so a crash
or a hang of one says nothing about the others; each rank checks the
result it received against the expected values. Prints one line per
operation ("ok", "wrong", "error: ..." or "crashed / timed out") and, last,
one JSON object {op: verdict}. A rank that imports this file runs one
operation (`--rank R --port P --op NAME`).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

OPS = ("broadcast", "all_reduce", "all_gather", "all_gather_into_tensor", "gather",
       "scatter", "reduce_scatter_tensor", "send_recv", "isend_irecv", "batch_isend_irecv",
       "broadcast_object_list", "barrier")


def _rank_main(rank: int, port: int, op: str, device: str) -> int:
    import datetime

    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=30))
    dev = torch.device(device)
    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
    ok = False
    if op == "broadcast":
        dist.broadcast(x, src=0)
        ok = torch.equal(x.cpu(), torch.arange(4.0))
    elif op == "all_reduce":
        dist.all_reduce(x)
        ok = torch.equal(x.cpu(), 2 * torch.arange(4.0) + 10)
    elif op == "all_gather":
        out = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(out, x)
        ok = torch.equal(torch.cat(out).cpu(), torch.cat([torch.arange(4.0), torch.arange(4.0) + 10]))
    elif op == "all_gather_into_tensor":
        out = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(out, x)
        ok = torch.equal(out.cpu(), torch.cat([torch.arange(4.0), torch.arange(4.0) + 10]))
    elif op == "gather":
        out = [torch.empty_like(x) for _ in range(2)] if rank == 0 else None
        dist.gather(x, out, dst=0)
        ok = rank != 0 or torch.equal(out[1].cpu(), torch.arange(4.0) + 10)
    elif op == "scatter":
        src = [torch.full((4,), float(i), device=dev) for i in range(2)] if rank == 0 else None
        dist.scatter(x, src, src=0)
        ok = torch.equal(x.cpu(), torch.full((4,), float(rank)))
    elif op == "reduce_scatter_tensor":
        inp = torch.arange(8, dtype=torch.float32, device=dev)
        dist.reduce_scatter_tensor(x, inp)
        ok = torch.equal(x.cpu(), 2 * torch.arange(8.0)[4 * rank: 4 * rank + 4])
    elif op == "send_recv":
        if rank == 0:
            dist.send(x, dst=1)
            ok = True
        else:
            dist.recv(x, src=0)
            ok = torch.equal(x.cpu(), torch.arange(4.0))
    elif op == "isend_irecv":
        if rank == 0:
            dist.isend(x, dst=1).wait()
            ok = True
        else:
            dist.irecv(x, src=0).wait()
            ok = torch.equal(x.cpu(), torch.arange(4.0))
    elif op == "batch_isend_irecv":
        y = torch.empty_like(x)
        peer = 1 - rank
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                         dist.P2POp(dist.irecv, y, peer)]):
            w.wait()
        ok = torch.equal(y.cpu(), torch.arange(4.0) + 10 * peer)
    elif op == "broadcast_object_list":
        objs = [{"rank": rank}]
        dist.broadcast_object_list(objs, src=0, device=dev)
        ok = objs[0] == {"rank": 0}
    elif op == "barrier":
        dist.barrier()
        ok = True
    torch.cuda.synchronize() if dev.type == "cuda" else None
    dist.destroy_process_group()
    print("RESULT", "ok" if ok else "wrong", flush=True)
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--rank", type=int)
    ap.add_argument("--port", type=int)
    ap.add_argument("--op")
    args = ap.parse_args()
    if args.rank is not None:
        return _rank_main(args.rank, args.port, args.op, args.device)
    verdicts, pairs = {}, {}
    for op in OPS:  # every pair at once: each rank mostly waits on CUDA start-up
        port = _free_port()
        pairs[op] = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--port", str(port),
             "--op", op, "--device", args.device],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    t0 = time.time()
    for op, procs in pairs.items():
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(1.0, args.timeout - (time.time() - t0)))[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\n(timed out)")
        results = [next((ln.split()[1] for ln in o.splitlines() if ln.startswith("RESULT")), None)
                   for o in outs]
        if all(r == "ok" for r in results):
            verdicts[op] = "ok"
        elif any(r == "wrong" for r in results):
            verdicts[op] = "wrong"
        else:
            err = [ln for o in outs for ln in o.splitlines()
                   if "Error" in ln or "error" in ln or "timed out" in ln]
            verdicts[op] = ("error: " + err[-1].strip()[:200]) if err else "crashed / timed out"
        print(f"{op}: {verdicts[op]}", flush=True)
    print(json.dumps(verdicts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
