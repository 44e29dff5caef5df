"""The served requests' operations on the DiT configuration
(`portbench/flops_dit.py::request`: the text half, 2 x steps DiT rows, the
vocoder, over valid frames, the attention banded where the request's route
banded it) over the traced window's time at the bf16 peak, in %."""

from portbench import flops_dit


def read(ctx):
    out, traffic = ctx["out"], ctx["traffic"]
    model = ctx["conf"]["model"]
    if "dit" not in model["tts"]["cfm"] or not out.get("served"):
        return None
    steps = traffic["engine"]["n_timesteps"]
    ops = sum(flops_dit.request(model, tok, fr, steps, banded=banded)
              for tok, fr, banded in out["served"])
    return 100.0 * ops / (out["window_s"] * ctx["peaks"]["bf16_flops"])
