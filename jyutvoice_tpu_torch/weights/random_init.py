"""Seeded random parameter trees in the JAX package's layout, made with numpy.

`init_tts_tree` / `init_hift_tree` give trees with the same paths and shapes
as the JAX package's `init_tts` / `init_hift` (a DiT decoder's, which the
JAX package lacks, in the layout of `models/dit.py`) and the same distributions
(torch's default Linear/Conv init, unit norms, unit snake alphas, a zero
prenet projection), drawn from `numpy.random.default_rng(seed)`; so do
`init_flow_encoder_tree`, `init_campplus_tree` and `init_s3_tree` for the
prompt extractor's models (`init_flow_encoder`, `init_campplus`,
`init_s3_tokenizer`; batch norms at identity running statistics). They feed
`weights/from_jax.py` like any JAX tree, so a random-weight model goes
through the same bridge as a trained one.
"""

from __future__ import annotations

import math

import numpy as np

from jyutvoice_tpu_torch.config import (
    DiTConfig,
    DurationPredictorConfig,
    EstimatorConfig,
    FlowEncoderConfig,
    HiFTConfig,
    TextEncoderConfig,
    TTSConfig,
)
from jyutvoice_tpu_torch.models.campplus import CampPlusConfig
from jyutvoice_tpu_torch.models.s3_tokenizer import S3TokenizerConfig, sinusoids


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

    def conv2d(self, in_ch, out_ch, k):
        return {"w": self.uniform((k, k, in_ch, out_ch), 1.0 / math.sqrt(in_ch * k * k))}

    @staticmethod
    def batch_norm(ch, affine=True):
        p = {"mean": np.zeros((ch,), np.float32), "var": np.ones((ch,), np.float32)}
        if affine:
            p["gamma"] = np.ones((ch,), np.float32)
            p["beta"] = np.zeros((ch,), np.float32)
        return p


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


def _dit(ini: _Init, cfg: DiTConfig):
    """The DiT's tree (`models/dit.py`). Every linear takes torch's default
    bounds, the adaLN linears and proj_out too: the published
    initialisation zeroes those, which would make a random model's
    velocity zero."""
    d, inner, hidden = cfg.dim, cfg.heads * cfg.dim_head, cfg.ff_mult * cfg.dim

    def block():
        return {
            "ada": ini.linear(d, 6 * d),
            "attn": {**{n: ini.linear(d, inner) for n in ("q", "k", "v")},
                     "o": ini.linear(inner, d)},
            "ff_in": ini.linear(d, hidden),
            "ff_out": ini.linear(hidden, d),
        }

    cin = d // cfg.conv_groups
    return {
        "time_mlp": {"linear1": ini.linear(cfg.freq_embed_dim, d), "linear2": ini.linear(d, d)},
        "proj": ini.linear(cfg.in_dim, d),
        "conv_pos": {"conv1": ini.conv(cin, d, cfg.conv_kernel),
                     "conv2": ini.conv(cin, d, cfg.conv_kernel)},
        "blocks": [block() for _ in range(cfg.depth)],
        "ada_out": ini.linear(d, 2 * d),
        "proj_out": ini.linear(d, cfg.out_channels),
    }


def init_tts_tree(cfg: TTSConfig, seed: int = 0):
    """Random TTS tree: encoder, dp, decoder (the U-Net's or the DiT's, as
    `cfg.cfm.estimator_kind` says), spk_embed_affine_layer."""
    ini = _Init(seed)
    dit = cfg.cfm.estimator_kind == "dit"
    return {
        "encoder": _text_encoder(ini, cfg.encoder),
        "dp": _duration(ini, cfg.dp),
        "decoder": _dit(ini, cfg.cfm.dit) if dit else _estimator(ini, cfg.cfm.estimator),
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


def init_flow_encoder_tree(cfg: FlowEncoderConfig, seed: int = 2):
    """Random flow-encoder tree (the JAX package's `init_flow_encoder`)."""
    ini = _Init(seed)
    d, heads = cfg.output_size, cfg.attention_heads
    d_k = d // heads

    def ff():
        return {"w1": ini.linear(d, cfg.linear_units), "w2": ini.linear(cfg.linear_units, d)}

    def layer():
        xavier = math.sqrt(6.0 / (heads + d_k))
        p = {
            "attn": {
                **{n: ini.linear(d, d) for n in ("q", "k", "v", "o")},
                "pos": {"w": ini.uniform((d, d), 1.0 / math.sqrt(d))},
                "pos_bias_u": ini.uniform((heads, d_k), xavier),
                "pos_bias_v": ini.uniform((heads, d_k), xavier),
            },
            "norm_mha": ini.norm(d),
            "ff": ff(),
            "norm_ff": ini.norm(d),
        }
        if cfg.macaron_style:
            p["ff_macaron"] = ff()
            p["norm_ff_macaron"] = ini.norm(d)
        if cfg.use_cnn_module:
            k = cfg.cnn_module_kernel
            p["conv"] = {
                "pw1": ini.linear(d, 2 * d),
                "dw": {"w": ini.uniform((k, d), 1.0 / math.sqrt(k)),
                       "b": ini.uniform((d,), 1.0 / math.sqrt(k))},
                "norm": ini.batch_norm(d) if cfg.cnn_module_norm == "batch_norm" else ini.norm(d),
                "pw2": ini.linear(d, d),
            }
            p["norm_conv"] = ini.norm(d)
            p["norm_final"] = ini.norm(d)
        return p

    return {
        "input_embedding": ini.embedding(cfg.vocab_size, cfg.input_size),
        "embed": {"linear": ini.linear(cfg.input_size, d), "norm": ini.norm(d)},
        "pre_lookahead": {
            "conv1": ini.conv(d, d, cfg.pre_lookahead_len + 1),
            "conv2": ini.conv(d, d, 3),
        },
        "encoders": [layer() for _ in range(cfg.num_blocks)],
        "up_conv": ini.conv(d, d, cfg.upsample_stride * 2 + 1),
        "up_embed": {"linear": ini.linear(cfg.input_size, d), "norm": ini.norm(d)},
        "up_encoders": [layer() for _ in range(cfg.num_up_blocks)],
        "after_norm": ini.norm(d),
        "encoder_proj": ini.linear(d, cfg.proj_size),
    }


def init_campplus_tree(cfg: CampPlusConfig = CampPlusConfig(), seed: int = 3):
    """Random CAM++ tree (the JAX package's `init_campplus`)."""
    ini = _Init(seed)
    m = cfg.m_channels

    def res_block(stride):
        p = {"conv1": ini.conv2d(m, m, 3), "bn1": ini.batch_norm(m),
             "conv2": ini.conv2d(m, m, 3), "bn2": ini.batch_norm(m)}
        if stride != 1:
            p["sc_conv"] = ini.conv2d(m, m, 1)
            p["sc_bn"] = ini.batch_norm(m)
        return p

    def bias_free(in_dim, out_dim):
        return {"w": ini.uniform((in_dim, out_dim), 1.0 / math.sqrt(in_dim))}

    tree = {
        "head": {
            "conv1": ini.conv2d(1, m, 3),
            "bn1": ini.batch_norm(m),
            "layer1": [res_block(2), res_block(1)],
            "layer2": [res_block(2), res_block(1)],
            "conv2": ini.conv2d(m, m, 3),
            "bn2": ini.batch_norm(m),
        },
        "tdnn": {
            "conv": {"w": ini.uniform((5, cfg.fcm_out_channels, cfg.init_channels),
                                      1.0 / math.sqrt(5 * cfg.fcm_out_channels))},
            "bn": ini.batch_norm(cfg.init_channels),
        },
        "blocks": [],
    }
    ch, bn_ch = cfg.init_channels, cfg.bn_size * cfg.growth_rate
    for n_layers, k in zip(cfg.num_layers, cfg.kernel_sizes):
        layers = []
        for j in range(n_layers):
            in_ch = ch + j * cfg.growth_rate
            layers.append({
                "bn1": ini.batch_norm(in_ch),
                "linear1": bias_free(in_ch, bn_ch),
                "bn2": ini.batch_norm(bn_ch),
                "cam": {
                    "local": {"w": ini.uniform((k, bn_ch, cfg.growth_rate),
                                               1.0 / math.sqrt(k * bn_ch))},
                    "lin1": ini.linear(bn_ch, bn_ch // 2),
                    "lin2": ini.linear(bn_ch // 2, cfg.growth_rate),
                },
            })
        ch += n_layers * cfg.growth_rate
        tree["blocks"].append({"layers": layers, "transit": {
            "bn": ini.batch_norm(ch), "linear": bias_free(ch, ch // 2)}})
        ch //= 2
    tree["out_bn"] = ini.batch_norm(ch)
    tree["dense"] = {"linear": bias_free(ch * 2, cfg.embedding_size),
                     "bn": ini.batch_norm(cfg.embedding_size, affine=False)}
    return tree


def init_s3_tree(cfg: S3TokenizerConfig = S3TokenizerConfig(), seed: int = 4):
    """Random S3 tokenizer tree (the JAX package's `init_s3_tokenizer`)."""
    ini = _Init(seed)
    d = cfg.n_audio_state

    def block():
        return {
            "attn": {"q": ini.linear(d, d), "k": ini.linear(d, d, bias=False),
                     "v": ini.linear(d, d), "out": ini.linear(d, d)},
            "attn_ln": ini.norm(d),
            "mlp1": ini.linear(d, d * 4),
            "mlp2": ini.linear(d * 4, d),
            "mlp_ln": ini.norm(d),
        }

    return {
        "conv1": ini.conv(cfg.n_mels, d, 3),
        "conv2": ini.conv(d, d, 3),
        "pos": sinusoids(cfg.n_audio_ctx, d),
        "blocks": [block() for _ in range(cfg.n_audio_layer)],
        "fsq": ini.linear(d, cfg.n_fsq_dims),
    }
