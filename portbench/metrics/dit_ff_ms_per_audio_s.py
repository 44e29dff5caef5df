"""Device milliseconds under the program's `dit.ff` spans (each DiT
block's feed-forward half: norm and modulation, the two linears and the
tanh GELU, the gated residual) per second of audio served in the traced
window (`portbench/spans.py`). None where the program records no such
span."""


def read(ctx):
    sp = ctx["out"].get("spans")
    if not sp or "dit.ff" not in sp["device_s"] or sp["audio_s"] <= 0:
        return None
    return 1e3 * sp["device_s"]["dit.ff"] / sp["audio_s"]
