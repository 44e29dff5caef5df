"""Kernel 2's share of its roofline: its calls' ResBlock operations
(`flops.resblock_stage`) at three TF32 products per f32 multiply-add
against the TF32 peak, or its input read and output written once at the
HBM rate, whichever is longer, over the device time of its kernel
(`resblock_stage_sm90`) in the trace, in %."""

from portbench import flops
from portbench import trace as tr


def read(ctx):
    out, peaks = ctx["out"], ctx["peaks"]
    h = ctx["conf"]["model"]["hift"]
    t = tr.kernel_seconds(out["trace"], "resblock_stage_sm90")
    calls = out["probes"]["k2"]
    if not calls or t <= 0:
        return None
    bound = sum(max(3 * b * flops.resblock_stage(h, seq, c) / peaks["tf32_flops"],
                    2 * 4.0 * b * seq * c / peaks["hbm_bytes_per_s"]) for b, seq, c in calls)
    return 100.0 * bound / t
