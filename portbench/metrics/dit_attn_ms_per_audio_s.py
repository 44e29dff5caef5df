"""Device milliseconds under the program's `dit.attn` spans (each DiT
block's attention half: norm and modulation, RoPE, q/k/v, kernel 1, the
output projection, the gated residual) per second of audio served in the
traced window (`portbench/spans.py`). None where the program records no
such span."""


def read(ctx):
    sp = ctx["out"].get("spans")
    if not sp or "dit.attn" not in sp["device_s"] or sp["audio_s"] <= 0:
        return None
    return 1e3 * sp["device_s"]["dit.attn"] / sp["audio_s"]
