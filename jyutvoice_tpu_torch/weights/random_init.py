"""Seeded random parameter trees in the JAX package's layout, made with numpy.

`init_tts_tree` / `init_hift_tree` give trees with the same paths and shapes
as the JAX package's `init_tts` / `init_hift` and the same distributions
(torch's default Linear/Conv init, unit norms, unit snake alphas, a zero
prenet projection), drawn from `numpy.random.default_rng(seed)`. They feed
`weights/from_jax.py` like any JAX tree, so a random-weight model goes
through the same bridge as a trained one.
"""

from __future__ import annotations

import math

import numpy as np

from jyutvoice_tpu_torch.config import (
    DurationPredictorConfig,
    EstimatorConfig,
    HiFTConfig,
    TextEncoderConfig,
    TTSConfig,
)


class _Init:
    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def uniform(self, shape, bound):
        return self.rng.uniform(-bound, bound, shape).astype(np.float32)

    def linear(self, in_dim, out_dim, bias=True):
        p = {"w": self.uniform((in_dim, out_dim), 1.0 / math.sqrt(in_dim))}
        if bias:
            p["b"] = self.uniform((out_dim,), 1.0 / math.sqrt(in_dim))
        return p

    def conv(self, in_ch, out_ch, k):
        fan_in = in_ch * k
        return {
            "w": self.uniform((k, in_ch, out_ch), 1.0 / math.sqrt(fan_in)),
            "b": self.uniform((out_ch,), 1.0 / math.sqrt(fan_in)),
        }

    def conv_transpose(self, in_ch, out_ch, k):
        fan_in = out_ch * k
        return {
            "w": self.uniform((k, in_ch, out_ch), 1.0 / math.sqrt(fan_in)),
            "b": self.uniform((out_ch,), 1.0 / math.sqrt(fan_in)),
        }

    @staticmethod
    def norm(dim):
        return {"g": np.ones((dim,), np.float32), "b": np.zeros((dim,), np.float32)}

    def embedding(self, n, dim):
        return {"w": (self.rng.standard_normal((n, dim)) * dim**-0.5).astype(np.float32)}


def _text_encoder(ini: _Init, cfg: TextEncoderConfig):
    c, hid = cfg.n_channels, cfg.hidden_channels
    xavier = math.sqrt(6.0 / (2 * hid))

    def layer():
        attn = {
            n: {"w": ini.uniform((hid, hid), xavier), "b": ini.uniform((hid,), hid**-0.5)}
            for n in ("q", "k", "v")
        }
        attn["o"] = ini.linear(hid, hid)
        return {
            "attn": attn,
            "norm1": ini.norm(hid),
            "ffn": {
                "conv1": ini.conv(hid, cfg.filter_channels, cfg.kernel_size),
                "conv2": ini.conv(cfg.filter_channels, hid, cfg.kernel_size),
            },
            "norm2": ini.norm(hid),
        }

    return {
        "emb": ini.embedding(cfg.n_vocab, c),
        "lang_emb": ini.embedding(cfg.n_lang, c),
        "tone_emb": ini.embedding(cfg.n_tone, c),
        "word_pos_emb": ini.embedding(cfg.n_word_pos, c),
        "syllable_pos_emb": ini.embedding(cfg.n_syllable_pos, c),
        "prenet": {
            "convs": [ini.conv(c, c, 5) for _ in range(3)],
            "norms": [ini.norm(c) for _ in range(3)],
            "proj": {"w": np.zeros((1, c, c), np.float32), "b": np.zeros((c,), np.float32)},
        },
        "layers": [layer() for _ in range(cfg.n_layers)],
        "proj": ini.conv(hid, cfg.n_feats, 1),
    }


def _duration(ini: _Init, cfg: DurationPredictorConfig):
    f = cfg.filter_channels
    return {
        "conv1": ini.conv(cfg.in_channels, f, cfg.kernel_size),
        "norm1": ini.norm(f),
        "conv2": ini.conv(f, f, cfg.kernel_size),
        "norm2": ini.norm(f),
        "proj": ini.conv(f, 1, 1),
        "cond": ini.conv(cfg.gin_channels, cfg.in_channels, 1),
    }


def _estimator(ini: _Init, cfg: EstimatorConfig):
    ch = cfg.channels[0]
    inner = cfg.num_heads * cfg.attention_head_dim

    def causal_block(dim, dim_out):
        return {"conv": ini.conv(dim, dim_out, 3), "norm": ini.norm(dim_out)}

    def block():
        return {
            "norm1": ini.norm(ch),
            "attn": {
                "q": ini.linear(ch, inner, bias=False),
                "k": ini.linear(ch, inner, bias=False),
                "v": ini.linear(ch, inner, bias=False),
                "o": ini.linear(inner, ch),
            },
            "norm3": ini.norm(ch),
            "ff_in": ini.linear(ch, ch * 4),
            "ff_out": ini.linear(ch * 4, ch),
        }

    def stage(in_dim):
        return {
            "resnet": {
                "mlp": ini.linear(cfg.time_embed_dim, ch),
                "block1": causal_block(in_dim, ch),
                "block2": causal_block(ch, ch),
                "res_conv": ini.conv(in_dim, ch, 1),
            },
            "blocks": [block() for _ in range(cfg.n_blocks)],
        }

    return {
        "time_mlp": {
            "linear1": ini.linear(cfg.in_channels, cfg.time_embed_dim),
            "linear2": ini.linear(cfg.time_embed_dim, cfg.time_embed_dim),
        },
        "down": stage(cfg.in_channels),
        "down_conv": ini.conv(ch, ch, 3),
        "mid": [stage(ch) for _ in range(cfg.num_mid_blocks)],
        "up": stage(ch * 2),
        "up_conv": ini.conv(ch, ch, 3),
        "final_block": causal_block(ch, ch),
        "final_proj": ini.conv(ch, cfg.out_channels, 1),
    }


def init_tts_tree(cfg: TTSConfig, seed: int = 0):
    """Random TTS tree: encoder, dp, decoder, spk_embed_affine_layer."""
    ini = _Init(seed)
    return {
        "encoder": _text_encoder(ini, cfg.encoder),
        "dp": _duration(ini, cfg.dp),
        "decoder": _estimator(ini, cfg.cfm.estimator),
        "spk_embed_affine_layer": ini.linear(cfg.spk_embed_dim, cfg.output_size),
    }


def init_hift_tree(cfg: HiFTConfig, seed: int = 1):
    """Random HiFT vocoder tree."""
    ini = _Init(seed)
    base = cfg.base_channels
    n_fft_src = cfg.istft_n_fft + 2

    def resblock(ch, k, dil):
        n = len(dil)
        return {
            "convs1": [ini.conv(ch, ch, k) for _ in range(n)],
            "convs2": [ini.conv(ch, ch, k) for _ in range(n)],
            "alphas1": [np.ones((ch,), np.float32) for _ in range(n)],
            "alphas2": [np.ones((ch,), np.float32) for _ in range(n)],
        }

    downsample = [1] + list(cfg.upsample_rates[::-1][:-1])
    strides = [int(u) for u in np.cumprod(downsample)[::-1]]
    chans = [cfg.in_channels] + [cfg.f0_predictor_cond_channels] * 5
    last = base // (2 ** len(cfg.upsample_rates))
    return {
        "f0_predictor": {
            "convs": [ini.conv(chans[i], chans[i + 1], 3) for i in range(5)],
            "classifier": ini.linear(cfg.f0_predictor_cond_channels, 1),
        },
        "m_source": {"l_linear": ini.linear(cfg.nb_harmonics + 1, 1)},
        "conv_pre": ini.conv(cfg.in_channels, base, 7),
        "ups": [
            ini.conv_transpose(base // (2**i), base // (2 ** (i + 1)), k)
            for i, k in enumerate(cfg.upsample_kernel_sizes)
        ],
        "source_downs": [
            {"conv": ini.conv(n_fft_src, base // (2 ** (i + 1)), 1 if u == 1 else 2 * u)}
            for i, u in enumerate(strides)
        ],
        "source_resblocks": [
            resblock(base // (2 ** (i + 1)), k, d)
            for i, (k, d) in enumerate(
                zip(cfg.source_resblock_kernel_sizes, cfg.source_resblock_dilation_sizes)
            )
        ],
        "resblocks": [
            resblock(base // (2 ** (i + 1)), k, d)
            for i in range(len(cfg.upsample_rates))
            for k, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)
        ],
        "conv_post": ini.conv(last, n_fft_src, 7),
    }
