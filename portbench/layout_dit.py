"""The DiT configuration's parameter trees, drawn from a seed on the device.

The text half, the speaker layer and HiFT are `layout.model_trees`'s for the
same seed and the configuration's U-Net settings, so a seed gives cell 1's
(`base.offline-b16`) text half, durations and vocoder; the U-Net decoder
drawn beside them is not used. The DiT decoder is drawn from seed + 2 in
the layout that `jyutvoice_tpu_torch/weights/random_init.py` gives the
port's DiT (written out here from the widths, so the reference reads the
same tree without the program), every linear and convolution at torch's
default bounds: the adaLN linears and proj_out too, which the published
initialisation zeroes (a random model's velocity would be zero).
"""

from __future__ import annotations

from typing import Dict

from portbench import layout


def dit(d: Dict) -> Dict:
    """The DiT's spec from its widths (the config's `tts.cfm.dit`)."""
    dim, inner, hidden = d["dim"], d["heads"] * d["dim_head"], d["ff_mult"] * d["dim"]
    cin = dim // d["conv_groups"]

    def block():
        return {"ada": layout.linear(dim, 6 * dim),
                "attn": {**{n: layout.linear(dim, inner) for n in ("q", "k", "v")},
                         "o": layout.linear(inner, dim)},
                "ff_in": layout.linear(dim, hidden), "ff_out": layout.linear(hidden, dim)}

    return {
        "time_mlp": {"linear1": layout.linear(d["freq_embed_dim"], dim),
                     "linear2": layout.linear(dim, dim)},
        "proj": layout.linear(2 * d["mel_dim"] + d["mu_dim"] + d["spk_dim"], dim),
        "conv_pos": {"conv1": layout.conv(cin, dim, d["conv_kernel"]),
                     "conv2": layout.conv(cin, dim, d["conv_kernel"])},
        "blocks": [block() for _ in range(d["depth"])],
        "ada_out": layout.linear(dim, 2 * dim),
        "proj_out": layout.linear(dim, d["out_channels"]),
    }


def model_trees(model: Dict, seed: int, device):
    """(tts tree with the DiT decoder, hift tree, flat buffers) from `seed`."""
    tts_t, hift_t, (tts_flat, hift_flat) = layout.model_trees(model, seed, device)
    dec, dec_flat = layout.draw(dit(model["tts"]["cfm"]["dit"]), seed + 2, device)
    return {**tts_t, "decoder": dec}, hift_t, (tts_flat, hift_flat, dec_flat)


def to_numpy(tts_tree, hift_tree, flats):
    """(tts, hift) as numpy views of host copies of the flat buffers."""
    rest = {k: v for k, v in tts_tree.items() if k != "decoder"}
    tts_np = {**layout.to_numpy(rest, flats[0]),
              "decoder": layout.to_numpy(tts_tree["decoder"], flats[2])}
    return tts_np, layout.to_numpy(hift_tree, flats[1])
