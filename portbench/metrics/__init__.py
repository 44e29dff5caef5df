"""One reader per per-layer metric, in a file named as the metric: a
`read(ctx)` that returns the number, or None where the run has nothing for
it to read. ctx: "conf" (the config file), "traffic", "out" (what the
cell's run returned: its trace reduction, probes, counters, served work) and
"peaks" (`portbench/peaks.json`)."""
