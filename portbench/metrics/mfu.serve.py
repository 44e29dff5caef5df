"""The served requests' model operations (`portbench/flops.py::request`:
the text half, 2 x steps estimator rows, the vocoder, over valid frames,
the attention banded where the request's route banded it) over the traced
window's time at the bf16 peak, in %."""

from portbench import flops


def read(ctx):
    out, traffic = ctx["out"], ctx["traffic"]
    model = ctx["conf"]["model"]
    steps = traffic["engine"]["n_timesteps"]
    ops = sum(flops.request(model, tok, fr, steps, banded=banded)
              for tok, fr, banded in out["served"])
    if not ops:
        return None
    return 100.0 * ops / (out["window_s"] * ctx["peaks"]["bf16_flops"])
