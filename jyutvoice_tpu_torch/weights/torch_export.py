"""Parameter trees in the JAX package's layout -> the reference's torch
state_dict: the inverse of `weights/torch_convert.py`, a copy of the JAX
package's `weights/torch_export.py`.

A model fine-tuned with this package goes back to the reference PyTorch
code (`JyutVoiceTTS.load_state_dict`): turn the module into a tree with
`weights/from_jax.py::jax_params_from_module`, then `export_tts` or
`save_torch_checkpoint`. Keys and layouts invert the converters exactly:
conv (K, Cin, Cout) -> (Cout, Cin, K), linear (Cin, Cout) -> (Cout, Cin),
the 1x1-conv linears get their kernel axis back, the glow-TTS norms emit
gamma/beta. Trees hold numpy arrays (anything `np.asarray` takes).

An int8 tree (`nn/quant.py::quantize_estimator`) raises: the reference
has no int8 format. Only the trainable JyutVoiceTTS artifact is exported: HiFT and the flow
encoder are frozen upstream artifacts that users already have in torch form.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

SD = Dict[str, np.ndarray]


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _conv(out: SD, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _np(p["w"]).transpose(2, 1, 0)
    if "b" in p:
        out[f"{name}.bias"] = _np(p["b"])


def _linear(out: SD, name: str, p: dict) -> None:
    if "w_q" in p:
        raise ValueError(
            f"{name}: an int8 linear (nn/quant.py::quantize_estimator); the reference "
            "has no int8 format, so export the f32 tree it was quantized from"
        )
    out[f"{name}.weight"] = _np(p["w"]).T
    if "b" in p:
        out[f"{name}.bias"] = _np(p["b"])


def _linear_to_conv1x1(out: SD, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _np(p["w"]).T[:, :, None]
    if "b" in p:
        out[f"{name}.bias"] = _np(p["b"])


def _glowtts_norm(out: SD, name: str, p: dict) -> None:
    out[f"{name}.gamma"] = _np(p["g"])
    out[f"{name}.beta"] = _np(p["b"])


def _layer_norm(out: SD, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _np(p["g"])
    out[f"{name}.bias"] = _np(p["b"])


def _emb(out: SD, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _np(p["w"])


def export_text_encoder(p: dict, prefix: str = "") -> SD:
    pre = prefix
    out: SD = {}
    _emb(out, f"{pre}emb", p["emb"])
    _emb(out, f"{pre}lang_emb", p["lang_emb"])
    _emb(out, f"{pre}tone_emb", p["tone_emb"])
    _emb(out, f"{pre}word_pos_emb", p["word_pos_emb"])
    _emb(out, f"{pre}syllable_pos", p["syllable_pos_emb"])
    for i, conv in enumerate(p["prenet"]["convs"]):
        _conv(out, f"{pre}prenet.conv_layers.{i}", conv)
    for i, norm in enumerate(p["prenet"]["norms"]):
        _glowtts_norm(out, f"{pre}prenet.norm_layers.{i}", norm)
    _conv(out, f"{pre}prenet.proj", p["prenet"]["proj"])
    for i, layer in enumerate(p["layers"]):
        for qkv, tname in (("q", "conv_q"), ("k", "conv_k"), ("v", "conv_v"), ("o", "conv_o")):
            _linear_to_conv1x1(out, f"{pre}encoder.attn_layers.{i}.{tname}", layer["attn"][qkv])
        _glowtts_norm(out, f"{pre}encoder.norm_layers_1.{i}", layer["norm1"])
        _conv(out, f"{pre}encoder.ffn_layers.{i}.conv_1", layer["ffn"]["conv1"])
        _conv(out, f"{pre}encoder.ffn_layers.{i}.conv_2", layer["ffn"]["conv2"])
        _glowtts_norm(out, f"{pre}encoder.norm_layers_2.{i}", layer["norm2"])
    _conv(out, f"{pre}proj", p["proj"])
    return out


def export_duration_predictor(p: dict, prefix: str = "") -> SD:
    pre = prefix
    out: SD = {}
    _conv(out, f"{pre}conv_1", p["conv1"])
    _glowtts_norm(out, f"{pre}norm_1", p["norm1"])
    _conv(out, f"{pre}conv_2", p["conv2"])
    _glowtts_norm(out, f"{pre}norm_2", p["norm2"])
    _conv(out, f"{pre}proj", p["proj"])
    _conv(out, f"{pre}cond", p["cond"])
    return out


def _causal_block(out: SD, name: str, p: dict) -> None:
    _conv(out, f"{name}.block.0", p["conv"])
    _layer_norm(out, f"{name}.block.2", p["norm"])


def _causal_resnet(out: SD, name: str, p: dict) -> None:
    _linear(out, f"{name}.mlp.1", p["mlp"])
    _causal_block(out, f"{name}.block1", p["block1"])
    _causal_block(out, f"{name}.block2", p["block2"])
    _conv(out, f"{name}.res_conv", p["res_conv"])


def _transformer_block(out: SD, name: str, p: dict) -> None:
    _layer_norm(out, f"{name}.norm1", p["norm1"])
    _linear(out, f"{name}.attn1.to_q", p["attn"]["q"])
    _linear(out, f"{name}.attn1.to_k", p["attn"]["k"])
    _linear(out, f"{name}.attn1.to_v", p["attn"]["v"])
    _linear(out, f"{name}.attn1.to_out.0", p["attn"]["o"])
    _layer_norm(out, f"{name}.norm3", p["norm3"])
    _linear(out, f"{name}.ff.net.0.proj", p["ff_in"])
    _linear(out, f"{name}.ff.net.2", p["ff_out"])


def _stage(out: SD, resnet_name: str, blocks_name: str, p: dict) -> None:
    _causal_resnet(out, resnet_name, p["resnet"])
    for j, blk in enumerate(p["blocks"]):
        _transformer_block(out, f"{blocks_name}.{j}", blk)


def export_estimator(p: dict, prefix: str = "") -> SD:
    pre = prefix
    out: SD = {}
    _linear(out, f"{pre}time_mlp.linear_1", p["time_mlp"]["linear1"])
    _linear(out, f"{pre}time_mlp.linear_2", p["time_mlp"]["linear2"])
    _stage(out, f"{pre}down_blocks.0.0", f"{pre}down_blocks.0.1", p["down"])
    _conv(out, f"{pre}down_blocks.0.2", p["down_conv"])
    for i, mid in enumerate(p["mid"]):
        _stage(out, f"{pre}mid_blocks.{i}.0", f"{pre}mid_blocks.{i}.1", mid)
    _stage(out, f"{pre}up_blocks.0.0", f"{pre}up_blocks.0.1", p["up"])
    _conv(out, f"{pre}up_blocks.0.2", p["up_conv"])
    _causal_block(out, f"{pre}final_block", p["final_block"])
    _conv(out, f"{pre}final_proj", p["final_proj"])
    return out


def export_tts(params: dict, prefix: str = "") -> SD:
    """The whole JyutVoiceTTS state_dict (the reference loads it with
    load_state_dict; wrapped in {"state_dict": ...} it is a Lightning ckpt)."""
    pre = prefix
    out: SD = {}
    out.update(export_text_encoder(params["encoder"], f"{pre}encoder."))
    out.update(export_duration_predictor(params["dp"], f"{pre}dp."))
    out.update(export_estimator(params["decoder"], f"{pre}decoder.estimator."))
    _linear(out, f"{pre}spk_embed_affine_layer", params["spk_embed_affine_layer"])
    return out


def save_torch_checkpoint(path: str, params: dict, lightning: bool = True) -> None:
    """Write a torch-loadable .ckpt/.pt file of a TTS tree; `lightning`
    wraps the state_dict as {"state_dict": ...}."""
    import torch

    sd = {k: torch.from_numpy(np.array(v)) for k, v in export_tts(params).items()}
    torch.save({"state_dict": sd} if lightning else sd, path)
