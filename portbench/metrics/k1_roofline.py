"""Kernel 1's share of its roofline: the least time the attention that its
calls' inputs need could take on the card (the larger of its operations at
the bf16 peak and its bytes at the HBM rate, `flops.attention_fwd`), over
the device time of its kernel (`flash_fwd_sm90`) in the trace, in %."""

from portbench import flops
from portbench import trace as tr


def read(ctx):
    out, peaks = ctx["out"], ctx["peaks"]
    t = tr.kernel_seconds(out["trace"], "flash_fwd_sm90")
    calls = out["probes"]["k1"]
    if not calls or t <= 0:
        return None
    bound = 0.0
    for b, seq, h, d, lengths in calls:
        w = flops.attention_fwd(lengths, h, d, seq)
        bound += max(w["ops"] / peaks["bf16_flops"], w["bytes"] / peaks["hbm_bytes_per_s"])
    return 100.0 * bound / t
