"""Operation counts of the DiT configuration, as `flops.py` counts the
U-Net's: a multiply-add is two operations, linears and convolutions count
valid frames, attention each valid query against each key it keeps. The
text half and the vocoder are `flops.py`'s."""

from __future__ import annotations

from typing import Dict

from portbench import flops
from portbench.flops import _conv


def estimator_call(m: Dict, t: int, keys_per_query: float = None) -> float:
    """One DiT call on one row of t valid frames; every query sees
    keys_per_query keys (t for exact attention)."""
    d = m["tts"]["cfm"]["dit"]
    dim, inner, hidden = d["dim"], d["heads"] * d["dim_head"], d["ff_mult"] * d["dim"]
    kq = t if keys_per_query is None else keys_per_query
    ops = _conv(t, 2 * d["mel_dim"] + d["mu_dim"] + d["spk_dim"], dim, 1)
    ops += 2 * _conv(t, dim // d["conv_groups"], dim, d["conv_kernel"])
    block = 3 * _conv(t, dim, inner, 1) + _conv(t, inner, dim, 1) + 4.0 * t * kq * inner
    block += _conv(t, dim, hidden, 1) + _conv(t, hidden, dim, 1)
    ops += d["depth"] * block + _conv(t, dim, d["out_channels"], 1)
    # once per row: the time MLP and every modulation
    ops += _conv(1, d["freq_embed_dim"], dim, 1) + _conv(1, dim, dim, 1)
    return ops + d["depth"] * _conv(1, dim, 6 * dim, 1) + _conv(1, dim, 2 * dim, 1)


def solve(m: Dict, t: int, steps: int, banded: bool = False) -> float:
    """The CFM solve of one request of t frames: 2 rows (guidance) per step."""
    s = m["tts"]["cfm"]["estimator"]
    kq = flops.banded_keys(t, s["banded_chunk"], s["banded_left"], s["banded_right"]) \
        if banded else None
    return 2 * steps * estimator_call(m, t, kq)


def request(m: Dict, tokens: int, frames: int, steps: int, banded: bool = False) -> float:
    """A whole served request."""
    return flops.text_half(m, tokens) + solve(m, frames, steps, banded) + flops.vocoder(m, frames)
