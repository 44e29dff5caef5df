"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's cards. The cell is
found by name in BENCHMARK.json; its configuration, traffic, limits and
per-layer metrics are files under portbench/ named after them. The last
line of standard output is one JSON object (`correct`, `attempted`,
`failed`, `metrics`, `device`, with `--trace 1` `breakdown`, then `checks`:
each number compared beside its limit, which the last lines of standard
error repeat). Without the cards the cell asks for, or with JAX or the JAX
package loaded, it prints no result and exits 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "jyutvoice_tpu")
# the checkout's root, not this folder, on the import path: portbench's
# modules are imported as the package's
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _fail(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(2)


def _load(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cell(workload: str):
    """(workload entry, config file, traffic file, limits file, per-layer
    metric entries) of a cell of BENCHMARK.json."""
    bench = _load(os.path.join(ROOT, "BENCHMARK.json"))
    wl = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if wl is None:
        _fail(f"no workload {workload!r} in BENCHMARK.json")
    cfg = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    conf = _load(os.path.join(ROOT, cfg["file"]))
    traffic = _load(os.path.join(HERE, "traffic", wl["traffic"] + ".json"))
    limits = _load(os.path.join(HERE, "limits", workload + ".json"))
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if workload in m.get("workloads", [workload] if m["moves"] in names else [])]
    return wl, conf, traffic, limits, e2e, layers


def evaluate(workload, seed, seconds, trace, device="cuda", fault=None, adjust=None,
             t_start=T_START):
    """Run the cell; returns the result object (without printing). Tests
    pass `device`, `adjust(conf, traffic)` (a small size) and `fault(synth)`
    (the timed path broken underneath)."""
    wl, conf, traffic, limits, e2e, layers = cell(workload)
    if adjust is not None:
        conf, traffic = adjust(conf, traffic)
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    out = kind.run(conf, traffic, limits, seed, seconds, bool(trace), t_start,
                     device=device, fault=fault)
    checks = {k: {"value": out["checks"][k], "limit": v} for k, v in limits["limits"].items()}
    ok = out["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    if trace:
        peaks = _load(os.path.join(HERE, "peaks.json"))
        ctx = {"conf": conf, "traffic": traffic, "out": out, "peaks": peaks}
        metrics = {}
        for m in layers:
            v = _module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                        "portbench_metric_" + m["name"].replace(".", "_")).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]} for m in e2e}
    import torch

    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": wl["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    res = {"correct": ok, "attempted": out["attempted"], "failed": out["failed"],
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = out["trace"]["busy_s"]
        dev["window_s"] = out["trace"]["window_s"]
        res["breakdown"] = out["trace"]["breakdown"]
    res["checks"] = checks
    res["_errors"] = out["errors"]
    res["_setup_parts"] = out["setup_parts"]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    wl = cell(args.workload)[0]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        _fail(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    res = evaluate(args.workload, args.seed, args.seconds, args.trace)
    bad = forbidden_modules()
    if bad:
        _fail(f"the run loaded {', '.join(bad)}")
    print("setup parts " + json.dumps({k: round(v, 3) for k, v in res.pop("_setup_parts").items()}),
          file=sys.stderr)
    for e in res.pop("_errors"):
        print(f"failed request: {e}", file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
