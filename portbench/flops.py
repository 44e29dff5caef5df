"""Operation and byte counts from the model's widths and the inputs'
lengths: the work the inputs need, not what a kernel happens to do.

A multiply-add is two operations. Masked positions do no work: attention
counts each valid query against each key its mask keeps, convolutions and
linears count valid frames. The copies of the plain gather that expands
text to frames count nothing.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence


def _conv(t: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * t * cin * cout * k


def text_half(m: Dict, t: int) -> float:
    """Text encoder and duration predictor of one request of t tokens."""
    e, d = m["tts"]["encoder"], m["tts"]["dp"]
    c = e["n_channels"]
    hid = 2 * c + e["gin_channels"]
    ops = 3 * _conv(t, c, c, 5) + _conv(t, c, c, 1)
    per_layer = 4 * _conv(t, hid, hid, 1) + 4.0 * t * t * hid
    per_layer += _conv(t, hid, e["filter_channels"], e["kernel_size"])
    per_layer += _conv(t, e["filter_channels"], hid, e["kernel_size"])
    ops += e["n_layers"] * per_layer + _conv(t, hid, e["n_feats"], 1)
    f = d["filter_channels"]
    ops += _conv(t, d["in_channels"], f, d["kernel_size"]) + _conv(t, f, f, d["kernel_size"])
    ops += _conv(t, f, 1, 1) + _conv(1, d["gin_channels"], d["in_channels"], 1)
    return ops + _conv(1, m["tts"]["spk_embed_dim"], m["tts"]["output_size"], 1)


def estimator_call(m: Dict, t: int, keys_per_query: float = None) -> float:
    """One estimator call on one row of t valid frames; every query sees
    keys_per_query keys (t for exact attention)."""
    s = m["tts"]["cfm"]["estimator"]
    ch = s["channels"][0]
    inner = s["num_heads"] * s["attention_head_dim"]
    kq = t if keys_per_query is None else keys_per_query
    block = _conv(t, ch, inner, 1) * 3 + _conv(t, inner, ch, 1)
    block += _conv(t, ch, 4 * ch, 1) * 2 + 4.0 * t * kq * inner

    def stage(cin):
        return (_conv(t, cin, ch, 3) + _conv(t, ch, ch, 3) + _conv(t, cin, ch, 1)
                + s["n_blocks"] * block)

    ops = stage(s["in_channels"]) + s["num_mid_blocks"] * stage(ch) + stage(2 * ch)
    ops += 3 * _conv(t, ch, ch, 3) + _conv(t, ch, s["out_channels"], 1)
    temb = 4 * ch  # the time MLP and each stage's projection of it, once per row
    ops += _conv(1, s["in_channels"], temb, 1) + _conv(1, temb, temb, 1)
    return ops + (s["num_mid_blocks"] + 2) * _conv(1, temb, ch, 1)


def banded_keys(t: int, chunk: int, left: int, right: int) -> float:
    """Mean keys per query of the chunk band over t valid frames."""
    nc = -(-t // chunk)
    total = 0.0
    for c in range(nc):
        rows = min((c + 1) * chunk, t) - c * chunk
        keys = min((c + right + 1) * chunk, t) - max(c - left, 0) * chunk
        total += rows * keys
    return total / t


def solve(m: Dict, t: int, steps: int, banded: bool = False) -> float:
    """The CFM solve of one request of t frames: 2 rows (guidance) per step."""
    s = m["tts"]["cfm"]["estimator"]
    kq = banded_keys(t, s["banded_chunk"], s["banded_left"], s["banded_right"]) if banded else None
    return 2 * steps * estimator_call(m, t, kq)


def vocoder(m: Dict, t: int) -> float:
    """HiFT over t mel frames."""
    h = m["hift"]
    base = h["base_channels"]
    nsrc = h["istft_n_fft"] + 2
    ops = _conv(t, h["in_channels"], h["f0_predictor_cond_channels"], 3)
    ops += 4 * _conv(t, h["f0_predictor_cond_channels"], h["f0_predictor_cond_channels"], 3)
    ops += _conv(t, h["in_channels"], base, 7)
    rates = h["upsample_rates"]
    strides = [1] + list(rates[::-1][:-1])
    strides = [int(v) for v in reversed([math.prod(strides[: i + 1]) for i in range(len(strides))])]
    n_in = t
    for i, (u, k) in enumerate(zip(rates, h["upsample_kernel_sizes"])):
        cin, cout = base // 2 ** i, base // 2 ** (i + 1)
        ops += 2.0 * n_in * k * cin * cout
        n = n_in * u
        ops += _conv(n, nsrc, cout, 1 if strides[i] == 1 else 2 * strides[i])
        ops += 2 * len(h["source_resblock_dilation_sizes"][i]) * _conv(
            n, cout, cout, h["source_resblock_kernel_sizes"][i])
        ops += resblock_stage(h, n, cout)
        n_in = n
    ops += _conv(n_in, base // 2 ** len(rates), nsrc, 7)
    return ops


def resblock_stage(h: Dict, t: int, c: int) -> float:
    """The parallel ResBlocks of one upsampling stage: each branch's
    dilated and plain convolution per dilation, over t samples of c
    channels (kernel 2 computes this for c <= 128)."""
    return sum(2 * len(d) * _conv(t, c, c, k)
               for k, d in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]))


def request(m: Dict, tokens: int, frames: int, steps: int, banded: bool = False) -> float:
    """A whole served request."""
    return text_half(m, tokens) + solve(m, frames, steps, banded) + vocoder(m, frames)


def attention_fwd(lengths: Sequence[int], heads: int, d: int, t: int) -> Dict[str, float]:
    """Kernel 1 at (B, T, H, D) q/k/v with per-row valid key lengths: the
    operations of every valid query against its valid keys, and the bytes
    of the valid rows of q, k and v read and of the output written, once
    each (f32). T, the padded length, costs nothing the inputs need."""
    ops = sum(4.0 * n * n * heads * d for n in lengths)
    return {"ops": ops, "bytes": 4.0 * 4 * sum(lengths) * heads * d}
