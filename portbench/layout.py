"""The model's parameter trees, drawn from a seed on the device.

The trees have the layout that `jyutvoice_tpu_torch/weights/from_jax.py`
takes (the JAX package's `init_tts` / `init_hift` paths and shapes) and the
same distributions as its random initialisers: torch's default Linear and
Conv bounds, unit layer norms, unit snake alphas, a zero prenet projection,
embeddings N(0, 1/dim). The layout is written out here, from the model's
widths, so the reference reads the same tree without the program.

All uniform leaves come from one `torch.rand` call and all normal leaves
from one `torch.randn` call on a `torch.Generator` of the device, so a seed
gives the same weights whatever the leaf order costs.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# leaf specs: ("u", shape, bound) uniform(-bound, bound); ("n", shape, std)
# normal; ("c", shape, value) constant


def _u(shape, bound):
    return ("u", tuple(shape), float(bound))


def _c(shape, value):
    return ("c", tuple(shape), float(value))


def linear(i, o, bias=True):
    p = {"w": _u((i, o), 1.0 / math.sqrt(i))}
    if bias:
        p["b"] = _u((o,), 1.0 / math.sqrt(i))
    return p


def conv(i, o, k):
    b = 1.0 / math.sqrt(i * k)
    return {"w": _u((k, i, o), b), "b": _u((o,), b)}


def conv_transpose(i, o, k):
    b = 1.0 / math.sqrt(o * k)
    return {"w": _u((k, i, o), b), "b": _u((o,), b)}


def norm(d):
    return {"g": _c((d,), 1.0), "b": _c((d,), 0.0)}


def embedding(n, d):
    return {"w": ("n", (n, d), d ** -0.5)}


def text_encoder(e: Dict) -> Dict:
    c = e["n_channels"]
    hid = 2 * c + e["gin_channels"]
    xavier = math.sqrt(6.0 / (2 * hid))

    def layer():
        attn = {n: {"w": _u((hid, hid), xavier), "b": _u((hid,), hid ** -0.5)}
                for n in ("q", "k", "v")}
        attn["o"] = linear(hid, hid)
        return {"attn": attn, "norm1": norm(hid),
                "ffn": {"conv1": conv(hid, e["filter_channels"], e["kernel_size"]),
                        "conv2": conv(e["filter_channels"], hid, e["kernel_size"])},
                "norm2": norm(hid)}

    return {
        "emb": embedding(e["n_vocab"], c),
        "lang_emb": embedding(e["n_lang"], c),
        "tone_emb": embedding(e["n_tone"], c),
        "word_pos_emb": embedding(e["n_word_pos"], c),
        "syllable_pos_emb": embedding(e["n_syllable_pos"], c),
        "prenet": {"convs": [conv(c, c, 5) for _ in range(3)],
                   "norms": [norm(c) for _ in range(3)],
                   "proj": {"w": _c((1, c, c), 0.0), "b": _c((c,), 0.0)}},
        "layers": [layer() for _ in range(e["n_layers"])],
        "proj": conv(hid, e["n_feats"], 1),
    }


def duration(d: Dict) -> Dict:
    f = d["filter_channels"]
    return {"conv1": conv(d["in_channels"], f, d["kernel_size"]), "norm1": norm(f),
            "conv2": conv(f, f, d["kernel_size"]), "norm2": norm(f),
            "proj": conv(f, 1, 1), "cond": conv(d["gin_channels"], d["in_channels"], 1)}


def estimator(s: Dict) -> Dict:
    ch = s["channels"][0]
    inner = s["num_heads"] * s["attention_head_dim"]
    temb = 4 * ch

    def causal_block(i, o):
        return {"conv": conv(i, o, 3), "norm": norm(o)}

    def block():
        return {"norm1": norm(ch),
                "attn": {"q": linear(ch, inner, False), "k": linear(ch, inner, False),
                         "v": linear(ch, inner, False), "o": linear(inner, ch)},
                "norm3": norm(ch), "ff_in": linear(ch, 4 * ch), "ff_out": linear(4 * ch, ch)}

    def stage(i):
        return {"resnet": {"mlp": linear(temb, ch), "block1": causal_block(i, ch),
                           "block2": causal_block(ch, ch), "res_conv": conv(i, ch, 1)},
                "blocks": [block() for _ in range(s["n_blocks"])]}

    return {
        "time_mlp": {"linear1": linear(s["in_channels"], temb), "linear2": linear(temb, temb)},
        "down": stage(s["in_channels"]), "down_conv": conv(ch, ch, 3),
        "mid": [stage(ch) for _ in range(s["num_mid_blocks"])],
        "up": stage(2 * ch), "up_conv": conv(ch, ch, 3),
        "final_block": causal_block(ch, ch), "final_proj": conv(ch, s["out_channels"], 1),
    }


def tts(m: Dict) -> Dict:
    t = m["tts"]
    return {"encoder": text_encoder(t["encoder"]), "dp": duration(t["dp"]),
            "decoder": estimator(t["cfm"]["estimator"]),
            "spk_embed_affine_layer": linear(t["spk_embed_dim"], t["output_size"])}


def source_down_strides(h: Dict) -> List[int]:
    rates = [1] + list(h["upsample_rates"][::-1][:-1])
    return [int(u) for u in np.cumprod(rates)[::-1]]


def hift(h: Dict) -> Dict:
    base = h["base_channels"]
    nsrc = h["istft_n_fft"] + 2

    def resblock(ch, k, dil):
        n = len(dil)
        return {"convs1": [conv(ch, ch, k) for _ in range(n)],
                "convs2": [conv(ch, ch, k) for _ in range(n)],
                "alphas1": [_c((ch,), 1.0) for _ in range(n)],
                "alphas2": [_c((ch,), 1.0) for _ in range(n)]}

    nup = len(h["upsample_rates"])
    chans = [h["in_channels"]] + [h["f0_predictor_cond_channels"]] * 5
    return {
        "f0_predictor": {"convs": [conv(chans[i], chans[i + 1], 3) for i in range(5)],
                         "classifier": linear(h["f0_predictor_cond_channels"], 1)},
        "m_source": {"l_linear": linear(h["nb_harmonics"] + 1, 1)},
        "conv_pre": conv(h["in_channels"], base, 7),
        "ups": [conv_transpose(base // 2 ** i, base // 2 ** (i + 1), k)
                for i, k in enumerate(h["upsample_kernel_sizes"])],
        "source_downs": [{"conv": conv(nsrc, base // 2 ** (i + 1), 1 if u == 1 else 2 * u)}
                         for i, u in enumerate(source_down_strides(h))],
        "source_resblocks": [resblock(base // 2 ** (i + 1), k, d) for i, (k, d) in enumerate(
            zip(h["source_resblock_kernel_sizes"], h["source_resblock_dilation_sizes"]))],
        "resblocks": [resblock(base // 2 ** (i + 1), k, d) for i in range(nup)
                      for k, d in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"])],
        "conv_post": conv(base // 2 ** nup, nsrc, 7),
    }


def _leaves(tree, path=()) -> List[Tuple[Tuple, Any]]:
    if isinstance(tree, tuple):
        return [(path, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [leaf for k, v in items for leaf in _leaves(v, path + (k,))]


def _build(tree, values, path=()):
    if isinstance(tree, tuple):
        return values[path]
    if isinstance(tree, dict):
        return {k: _build(v, values, path + (k,)) for k, v in tree.items()}
    return [_build(v, values, path + (i,)) for i, v in enumerate(tree)]


def draw(spec, seed: int, device) -> Tuple[Any, torch.Tensor]:
    """(tree of float32 tensors on `device`, the flat buffer they view) for a
    spec tree, from `seed`: one uniform and one normal call."""
    leaves = _leaves(spec)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    sizes = {k: [int(np.prod(s[1])) for _, s in leaves if s[0] == k] for k in "unc"}
    total = {k: sum(v) for k, v in sizes.items()}
    flat = torch.empty(sum(total.values()), device=device)
    uni = flat[: total["u"]]
    torch.rand(total["u"], generator=gen, device=device, out=uni)
    bounds = torch.tensor([s[2] for _, s in leaves if s[0] == "u"], device=device)
    uni.mul_(2.0).sub_(1.0).mul_(torch.repeat_interleave(
        bounds, torch.tensor(sizes["u"], dtype=torch.long, device=device)))
    nor = flat[total["u"]: total["u"] + total["n"]]
    torch.randn(total["n"], generator=gen, device=device, out=nor)
    stds = torch.tensor([s[2] for _, s in leaves if s[0] == "n"], device=device)
    nor.mul_(torch.repeat_interleave(stds, torch.tensor(sizes["n"], dtype=torch.long, device=device)))
    off = {"u": 0, "n": total["u"], "c": total["u"] + total["n"]}
    values = {}
    for path, (kind, shape, arg) in leaves:
        n = int(np.prod(shape))
        view = flat[off[kind]: off[kind] + n].view(shape)
        if kind == "c":
            view.fill_(arg)
        values[path] = view
        off[kind] += n
    return _build(spec, values), flat


def to_numpy(tree, flat: torch.Tensor):
    """The same tree as numpy views of one host copy of `flat`."""
    host = flat.cpu().numpy()
    base = flat.data_ptr()

    def conv_leaf(t):
        start = (t.data_ptr() - base) // 4
        return host[start: start + t.numel()].reshape(t.shape)

    def walk(node):
        if isinstance(node, torch.Tensor):
            return conv_leaf(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return [walk(v) for v in node]

    return walk(tree)


def model_trees(model: Dict, seed: int, device):
    """(tts tree, hift tree, the flat buffers) drawn from `seed` for the
    model configuration `model` (the config file's "model" object)."""
    tts_tree, tts_flat = draw(tts(model), seed, device)
    hift_tree, hift_flat = draw(hift(model["hift"]), seed + 1, device)
    return tts_tree, hift_tree, (tts_flat, hift_flat)
