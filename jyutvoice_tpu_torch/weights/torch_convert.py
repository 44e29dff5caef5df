"""torch state_dict -> parameter trees in the JAX package's layout (numpy),
a copy of its `weights/torch_convert.py`; the trees load through
`weights/from_jax.py`.

Input is a flat {name: np.ndarray} dict (load with `load_torch_state_dict`,
which handles Lightning .ckpt wrappers and bare .pt files, reference formats:
infer.py:343-351, scripts/download_pretrain_weights.py:168-215).

Layout conventions:
  torch Conv1d weight (C_out, C_in, K)      -> ours (K, C_in, C_out)
  torch ConvTranspose1d weight (C_in, C_out, K) -> ours (K, C_in, C_out)
  torch Linear weight (C_out, C_in)          -> ours (C_in, C_out)
  1x1 Conv used as a linear                  -> stays a (1, C_in, C_out) conv
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from jyutvoice_tpu_torch.config import (
    DurationPredictorConfig,
    EstimatorConfig,
    FlowEncoderConfig,
    HiFTConfig,
    TextEncoderConfig,
)

SD = Mapping[str, np.ndarray]


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a torch checkpoint into numpy. Requires torch at call time only."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in ckpt.items()}


def _conv(sd: SD, name: str) -> dict:
    p = {"w": np.asarray(np.transpose(sd[f"{name}.weight"], (2, 1, 0)))}
    if f"{name}.bias" in sd:
        p["b"] = np.asarray(sd[f"{name}.bias"])
    return p


def _conv_transpose(sd: SD, name: str) -> dict:
    p = {"w": np.asarray(np.transpose(sd[f"{name}.weight"], (2, 0, 1)))}
    if f"{name}.bias" in sd:
        p["b"] = np.asarray(sd[f"{name}.bias"])
    return p


def _linear(sd: SD, name: str) -> dict:
    p = {"w": np.asarray(sd[f"{name}.weight"].T)}
    if f"{name}.bias" in sd:
        p["b"] = np.asarray(sd[f"{name}.bias"])
    return p


def _linear_from_conv1x1(sd: SD, name: str) -> dict:
    """reference 1x1 Conv1d -> our linear params (in, out)."""
    p = {"w": np.asarray(sd[f"{name}.weight"][:, :, 0].T)}
    if f"{name}.bias" in sd:
        p["b"] = np.asarray(sd[f"{name}.bias"])
    return p


def _glowtts_norm(sd: SD, name: str) -> dict:
    return {"g": np.asarray(sd[f"{name}.gamma"]), "b": np.asarray(sd[f"{name}.beta"])}


def _layer_norm(sd: SD, name: str) -> dict:
    return {
        "g": np.asarray(sd[f"{name}.weight"]),
        "b": np.asarray(sd[f"{name}.bias"]),
    }


def _emb(sd: SD, name: str) -> dict:
    return {"w": np.asarray(sd[f"{name}.weight"])}


# ---------------------------------------------------------------------------
# TextEncoder (reference models/text_encoder.py:340-451)
# ---------------------------------------------------------------------------


def convert_text_encoder(sd: SD, cfg: TextEncoderConfig, prefix: str = "") -> dict:
    pre = prefix
    prenet = {
        "convs": [
            _conv(sd, f"{pre}prenet.conv_layers.{i}") for i in range(3)
        ],
        "norms": [
            _glowtts_norm(sd, f"{pre}prenet.norm_layers.{i}") for i in range(3)
        ],
        "proj": _conv(sd, f"{pre}prenet.proj"),
    }
    layers = []
    for i in range(cfg.n_layers):
        layers.append(
            {
                "attn": {
                    "q": _linear_from_conv1x1(sd, f"{pre}encoder.attn_layers.{i}.conv_q"),
                    "k": _linear_from_conv1x1(sd, f"{pre}encoder.attn_layers.{i}.conv_k"),
                    "v": _linear_from_conv1x1(sd, f"{pre}encoder.attn_layers.{i}.conv_v"),
                    "o": _linear_from_conv1x1(sd, f"{pre}encoder.attn_layers.{i}.conv_o"),
                },
                "norm1": _glowtts_norm(sd, f"{pre}encoder.norm_layers_1.{i}"),
                "ffn": {
                    "conv1": _conv(sd, f"{pre}encoder.ffn_layers.{i}.conv_1"),
                    "conv2": _conv(sd, f"{pre}encoder.ffn_layers.{i}.conv_2"),
                },
                "norm2": _glowtts_norm(sd, f"{pre}encoder.norm_layers_2.{i}"),
            }
        )
    return {
        "emb": _emb(sd, f"{pre}emb"),
        "lang_emb": _emb(sd, f"{pre}lang_emb"),
        "tone_emb": _emb(sd, f"{pre}tone_emb"),
        "word_pos_emb": _emb(sd, f"{pre}word_pos_emb"),
        "syllable_pos_emb": _emb(sd, f"{pre}syllable_pos"),
        "prenet": prenet,
        "layers": layers,
        "proj": _conv(sd, f"{pre}proj"),
    }


# ---------------------------------------------------------------------------
# DurationPredictor (reference models/duration_predictor.py:26-60)
# ---------------------------------------------------------------------------


def convert_duration_predictor(
    sd: SD, cfg: DurationPredictorConfig, prefix: str = ""
) -> dict:
    pre = prefix
    return {
        "conv1": _conv(sd, f"{pre}conv_1"),
        "norm1": _glowtts_norm(sd, f"{pre}norm_1"),
        "conv2": _conv(sd, f"{pre}conv_2"),
        "norm2": _glowtts_norm(sd, f"{pre}norm_2"),
        "proj": _conv(sd, f"{pre}proj"),
        "cond": _conv(sd, f"{pre}cond"),
    }


# ---------------------------------------------------------------------------
# CFM estimator (reference flow/decoder.py:798-1018)
# ---------------------------------------------------------------------------


def _causal_block(sd: SD, name: str) -> dict:
    """CausalBlock1D.block = Sequential(conv, Transpose, LayerNorm, Transpose, Mish)."""
    return {
        "conv": _conv(sd, f"{name}.block.0"),
        "norm": _layer_norm(sd, f"{name}.block.2"),
    }


def _causal_resnet(sd: SD, name: str) -> dict:
    return {
        "mlp": _linear(sd, f"{name}.mlp.1"),  # Sequential(Mish, Linear)
        "block1": _causal_block(sd, f"{name}.block1"),
        "block2": _causal_block(sd, f"{name}.block2"),
        "res_conv": _conv(sd, f"{name}.res_conv"),
    }


def _basic_transformer_block(sd: SD, name: str) -> dict:
    return {
        "norm1": _layer_norm(sd, f"{name}.norm1"),
        "attn": {
            "q": _linear(sd, f"{name}.attn1.to_q"),
            "k": _linear(sd, f"{name}.attn1.to_k"),
            "v": _linear(sd, f"{name}.attn1.to_v"),
            "o": _linear(sd, f"{name}.attn1.to_out.0"),
        },
        "norm3": _layer_norm(sd, f"{name}.norm3"),
        "ff_in": _linear(sd, f"{name}.ff.net.0.proj"),
        "ff_out": _linear(sd, f"{name}.ff.net.2"),
    }


def _estimator_stage(sd: SD, resnet_name: str, blocks_name: str, n_blocks: int) -> dict:
    return {
        "resnet": _causal_resnet(sd, resnet_name),
        "blocks": [
            _basic_transformer_block(sd, f"{blocks_name}.{j}") for j in range(n_blocks)
        ],
    }


# ---------------------------------------------------------------------------
# Weight-norm folding (HiFT convs; reference generator.py:26,288 etc.)
# ---------------------------------------------------------------------------


def _wn_weight(sd: SD, name: str) -> np.ndarray:
    """Return the effective conv weight, folding weight-norm if present.

    Handles the modern parametrization keys (`parametrizations.weight.
    original0/1`), the legacy `weight_g`/`weight_v` pair, and plain weights.
    Norm is over all dims except dim 0 (torch weight_norm default).
    """
    if f"{name}.parametrizations.weight.original0" in sd:
        g = sd[f"{name}.parametrizations.weight.original0"]
        v = sd[f"{name}.parametrizations.weight.original1"]
    elif f"{name}.weight_g" in sd:
        g = sd[f"{name}.weight_g"]
        v = sd[f"{name}.weight_v"]
    else:
        return sd[f"{name}.weight"]
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=axes, keepdims=True))
    return (g * (v / norm)).astype(np.float32)


def _conv_wn(sd: SD, name: str) -> dict:
    p = {"w": np.asarray(np.transpose(_wn_weight(sd, name), (2, 1, 0)))}
    if f"{name}.bias" in sd:
        p["b"] = np.asarray(sd[f"{name}.bias"])
    return p


def _conv_transpose_wn(sd: SD, name: str) -> dict:
    p = {"w": np.asarray(np.transpose(_wn_weight(sd, name), (2, 0, 1)))}
    if f"{name}.bias" in sd:
        p["b"] = np.asarray(sd[f"{name}.bias"])
    return p


def convert_estimator(sd: SD, cfg: EstimatorConfig, prefix: str = "") -> dict:
    pre = prefix
    return {
        "time_mlp": {
            "linear1": _linear(sd, f"{pre}time_mlp.linear_1"),
            "linear2": _linear(sd, f"{pre}time_mlp.linear_2"),
        },
        "down": _estimator_stage(
            sd, f"{pre}down_blocks.0.0", f"{pre}down_blocks.0.1", cfg.n_blocks
        ),
        "down_conv": _conv(sd, f"{pre}down_blocks.0.2"),
        "mid": [
            _estimator_stage(
                sd, f"{pre}mid_blocks.{i}.0", f"{pre}mid_blocks.{i}.1", cfg.n_blocks
            )
            for i in range(cfg.num_mid_blocks)
        ],
        "up": _estimator_stage(
            sd, f"{pre}up_blocks.0.0", f"{pre}up_blocks.0.1", cfg.n_blocks
        ),
        "up_conv": _conv(sd, f"{pre}up_blocks.0.2"),
        "final_block": _causal_block(sd, f"{pre}final_block"),
        "final_proj": _conv(sd, f"{pre}final_proj"),
    }


# ---------------------------------------------------------------------------
# Full JyutVoiceTTS checkpoint (reference models/jyutvoice_tts.py:23-106)
# ---------------------------------------------------------------------------


def convert_tts(sd: SD, tts_cfg, prefix: str = "") -> dict:
    """Map a full JyutVoiceTTS state_dict (Lightning ckpt or pretrain.pt)."""
    pre = prefix
    return {
        "encoder": convert_text_encoder(sd, tts_cfg.encoder, f"{pre}encoder."),
        "dp": convert_duration_predictor(sd, tts_cfg.dp, f"{pre}dp."),
        "decoder": convert_estimator(
            sd, tts_cfg.cfm.estimator, f"{pre}decoder.estimator."
        ),
        "spk_embed_affine_layer": _linear(sd, f"{pre}spk_embed_affine_layer"),
    }


# ---------------------------------------------------------------------------
# FlowEncoder / UpsampleConformerEncoder
# (reference infer.py:35-82, transformer/upsample_encoder.py:140-514)
# ---------------------------------------------------------------------------


def _batch_norm(sd: SD, name: str) -> dict:
    return {
        "gamma": np.asarray(sd[f"{name}.weight"]),
        "beta": np.asarray(sd[f"{name}.bias"]),
        "mean": np.asarray(sd[f"{name}.running_mean"]),
        "var": np.asarray(sd[f"{name}.running_var"]),
    }


def _conv_module(sd: SD, name: str) -> dict:
    """Conformer ConvolutionModule (reference transformer/convolution.py:24-145):
    torch depthwise weight (C, 1, K) -> ours (K, C); BN (running stats) vs LN
    detected from the checkpoint keys."""
    dw = sd[f"{name}.depthwise_conv.weight"]
    p = {
        "pw1": _linear_from_conv1x1(sd, f"{name}.pointwise_conv1"),
        "dw": {
            "w": np.asarray(dw[:, 0, :].T),
            "b": np.asarray(sd[f"{name}.depthwise_conv.bias"]),
        },
        "norm": (
            _batch_norm(sd, f"{name}.norm")
            if f"{name}.norm.running_mean" in sd
            else _layer_norm(sd, f"{name}.norm")
        ),
        "pw2": _linear_from_conv1x1(sd, f"{name}.pointwise_conv2"),
    }
    return p


def _conformer_layer(sd: SD, name: str) -> dict:
    p = {
        "attn": {
            "q": _linear(sd, f"{name}.self_attn.linear_q"),
            "k": _linear(sd, f"{name}.self_attn.linear_k"),
            "v": _linear(sd, f"{name}.self_attn.linear_v"),
            "o": _linear(sd, f"{name}.self_attn.linear_out"),
            "pos": _linear(sd, f"{name}.self_attn.linear_pos"),
            "pos_bias_u": np.asarray(sd[f"{name}.self_attn.pos_bias_u"]),
            "pos_bias_v": np.asarray(sd[f"{name}.self_attn.pos_bias_v"]),
        },
        "norm_mha": _layer_norm(sd, f"{name}.norm_mha"),
        "ff": {
            "w1": _linear(sd, f"{name}.feed_forward.w_1"),
            "w2": _linear(sd, f"{name}.feed_forward.w_2"),
        },
        "norm_ff": _layer_norm(sd, f"{name}.norm_ff"),
    }
    # full-conformer options (encoder_layer.py:241-319); present only when
    # the source config enabled macaron_style / use_cnn_module
    if f"{name}.feed_forward_macaron.w_1.weight" in sd:
        p["ff_macaron"] = {
            "w1": _linear(sd, f"{name}.feed_forward_macaron.w_1"),
            "w2": _linear(sd, f"{name}.feed_forward_macaron.w_2"),
        }
        p["norm_ff_macaron"] = _layer_norm(sd, f"{name}.norm_ff_macaron")
    if f"{name}.conv_module.depthwise_conv.weight" in sd:
        p["conv"] = _conv_module(sd, f"{name}.conv_module")
        p["norm_conv"] = _layer_norm(sd, f"{name}.norm_conv")
        p["norm_final"] = _layer_norm(sd, f"{name}.norm_final")
    return p


def convert_flow_encoder(sd: SD, cfg: FlowEncoderConfig, prefix: str = "") -> dict:
    pre = prefix
    return {
        "input_embedding": _emb(sd, f"{pre}input_embedding"),
        "embed": {
            "linear": _linear(sd, f"{pre}encoder.embed.out.0"),
            "norm": _layer_norm(sd, f"{pre}encoder.embed.out.1"),
        },
        "pre_lookahead": {
            "conv1": _conv(sd, f"{pre}encoder.pre_lookahead_layer.conv1"),
            "conv2": _conv(sd, f"{pre}encoder.pre_lookahead_layer.conv2"),
        },
        "encoders": [
            _conformer_layer(sd, f"{pre}encoder.encoders.{i}")
            for i in range(cfg.num_blocks)
        ],
        "up_conv": _conv(sd, f"{pre}encoder.up_layer.conv"),
        "up_embed": {
            "linear": _linear(sd, f"{pre}encoder.up_embed.out.0"),
            "norm": _layer_norm(sd, f"{pre}encoder.up_embed.out.1"),
        },
        "up_encoders": [
            _conformer_layer(sd, f"{pre}encoder.up_encoders.{i}")
            for i in range(cfg.num_up_blocks)
        ],
        "after_norm": _layer_norm(sd, f"{pre}encoder.after_norm"),
        "encoder_proj": _linear(sd, f"{pre}encoder_proj"),
    }


# ---------------------------------------------------------------------------
# HiFT vocoder (reference hifigan/generator.py:239-466, f0_predictor.py:19-55)
# ---------------------------------------------------------------------------


def _resblock(sd: SD, name: str, kernel_size: int, dilations) -> dict:
    n = len(dilations)
    return {
        "convs1": [_conv_wn(sd, f"{name}.convs1.{i}") for i in range(n)],
        "convs2": [_conv_wn(sd, f"{name}.convs2.{i}") for i in range(n)],
        "alphas1": [
            np.asarray(sd[f"{name}.activations1.{i}.alpha"]) for i in range(n)
        ],
        "alphas2": [
            np.asarray(sd[f"{name}.activations2.{i}.alpha"]) for i in range(n)
        ],
    }


def convert_hift(sd: SD, cfg: HiFTConfig, prefix: str = "") -> dict:
    pre = prefix
    f0_pred = {
        # condnet = Sequential(conv, ELU, conv, ELU, ...) -> indices 0,2,4,6,8
        "convs": [
            _conv_wn(sd, f"{pre}f0_predictor.condnet.{2 * i}") for i in range(5)
        ],
        "classifier": _linear(sd, f"{pre}f0_predictor.classifier"),
    }
    ups = [
        _conv_transpose_wn(sd, f"{pre}ups.{i}")
        for i in range(len(cfg.upsample_rates))
    ]
    downsample_rates = [1] + list(cfg.upsample_rates[::-1][:-1])
    downsample_cum = list(np.cumprod(downsample_rates))[::-1]
    source_downs = []
    source_resblocks = []
    for i, (u, k, d) in enumerate(
        zip(
            downsample_cum,
            cfg.source_resblock_kernel_sizes,
            cfg.source_resblock_dilation_sizes,
        )
    ):
        source_downs.append({"conv": _conv(sd, f"{pre}source_downs.{i}")})
        source_resblocks.append(_resblock(sd, f"{pre}source_resblocks.{i}", k, d))
    resblocks = []
    idx = 0
    for i in range(len(cfg.upsample_rates)):
        for k, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            resblocks.append(_resblock(sd, f"{pre}resblocks.{idx}", k, d))
            idx += 1
    return {
        "f0_predictor": f0_pred,
        "m_source": {"l_linear": _linear(sd, f"{pre}m_source.l_linear")},
        "conv_pre": _conv_wn(sd, f"{pre}conv_pre"),
        "ups": ups,
        "source_downs": source_downs,
        "source_resblocks": source_resblocks,
        "resblocks": resblocks,
        "conv_post": _conv_wn(sd, f"{pre}conv_post"),
    }
