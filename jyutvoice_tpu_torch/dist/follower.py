"""A follower rank of a spawned mesh (`dist/mesh.py::Mesh.spawn`).

    python -m jyutvoice_tpu_torch.dist.follower RANK SPEC

SPEC is the mesh's description (axis names and sizes, a device per rank,
the backend, the rendezvous file, the parent's torch thread count and TF32
settings, and its pid) as a Python literal. The follower joins the process group, then reads
commands from its standard input: each a length-prefixed pickle of
("call", module, function, args), on which it calls `function(mesh, *args)`
as rank 0 does. It exits at the end of its input (its parent closed the
mesh or ended), when its parent's pid goes away, or after a command raises
(the traceback goes to standard error and the exit code is 1, which breaks
the group's collectives on the other ranks).
"""

from __future__ import annotations

import ast
import importlib
import os
import pickle
import sys
import threading
import time
import traceback


def _watch_parent(parent: int) -> None:
    while True:
        time.sleep(1.0)
        if os.getppid() != parent:
            os._exit(1)


def _read_exact(stream, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = stream.read(n - len(buf))
        if not chunk:
            return b""
        buf += chunk
    return buf


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rank, spec = int(argv[0]), ast.literal_eval(argv[1])
    threading.Thread(target=_watch_parent, args=(spec["parent"],), daemon=True).start()

    import torch

    from jyutvoice_tpu_torch.dist.mesh import Mesh

    torch.set_num_threads(int(spec["threads"]))
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = spec["tf32"]
    mesh = Mesh(tuple(spec["axis_names"]), tuple(spec["sizes"]), spec["devices"],
                spec["backend"], rank)
    mesh._init_group(spec["init"])
    stdin = sys.stdin.buffer
    while True:
        head = _read_exact(stdin, 8)
        if not head:
            break
        kind, module, name, args = pickle.loads(_read_exact(stdin, int.from_bytes(head, "little")))
        if kind != "call":
            break
        try:
            fn = importlib.import_module(module)
            for part in name.split("."):
                fn = getattr(fn, part)
            fn(mesh, *args)
        except BaseException:
            traceback.print_exc()
            sys.stderr.flush()
            os._exit(1)
    mesh._release_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
