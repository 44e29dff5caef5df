"""The benchmark of `jyutvoice_tpu_torch` on one NVIDIA H100 (see
BENCHMARK.json and PERF.md). `run.py` is the entry point; this package is
the yardstick: traffic, weights, the plain reference, the comparison that
decides `correct`, the operation counts, the peaks and the trace reduction.
Nothing in it imports JAX or the JAX package."""
