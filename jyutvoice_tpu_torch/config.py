"""Configuration dataclasses, a copy of the JAX package's `config.py`.

Defaults reproduce the reference's live configuration. The fields are the
same as the JAX package's, so one set of values describes one model in both
packages; a few backend switches that only the JAX package reads are kept
as inert fields.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """Audio frontend parameters (configs/base.yaml:16-24, infer.py:169-179)."""

    sample_rate: int = 24000
    n_fft: int = 1920
    hop_length: int = 480
    win_length: int = 1920
    n_mels: int = 80
    f_min: float = 0.0
    f_max: Optional[float] = 8000.0  # infer.py passes fmax=8000 explicitly

    @property
    def frames_per_second(self) -> float:
        return self.sample_rate / self.hop_length


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    """RoPE transformer text encoder (configs/base.yaml:51-67)."""

    n_vocab: int = 97
    n_lang: int = 4  # pad + yue/zh/en
    n_tone: int = 7  # pad + 6 tones
    n_word_pos: int = 4
    n_syllable_pos: int = 4
    n_feats: int = 80
    n_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1
    gin_channels: int = 192  # speaker embedding dim
    prenet: bool = True

    @property
    def hidden_channels(self) -> int:
        # phoneme (n_channels) + lang emb (n_channels) + tiled speaker embed
        return self.n_channels * 2 + self.gin_channels


@dataclasses.dataclass(frozen=True)
class DurationPredictorConfig:
    """Duration predictor (configs/base.yaml:69-74)."""

    in_channels: int = 576  # = TextEncoderConfig.hidden_channels
    filter_channels: int = 256
    kernel_size: int = 3
    p_dropout: float = 0.1
    gin_channels: int = 192


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    """Causal CFM estimator U-Net (configs/base.yaml:88-99).

    With a single channel level the network never changes temporal
    resolution: 1 down stage + num_mid_blocks mid stages + 1 up stage, each
    [CausalResnetBlock -> n_blocks transformer blocks], plus causal-conv
    bridges (reference: jyutvoice/flow/decoder.py:798-1018).
    """

    in_channels: int = 320  # pack([x, mu, spks, cond]) = 80*4
    out_channels: int = 80
    channels: Tuple[int, ...] = (256,)
    dropout: float = 0.0
    attention_head_dim: int = 64
    n_blocks: int = 4
    num_mid_blocks: int = 12
    num_heads: int = 8
    act_fn: str = "gelu"
    static_chunk_size: int = 50  # mel frames per streaming chunk (25 tokens * 2)
    num_decoding_left_chunks: int = -1
    # Attention backends (models/estimator.py::attention_route): "xla" takes
    # the long-form gates on CUDA (banded at T >= banded_long_threshold,
    # 128-aligned; else kernel 3 at 512-aligned T >= 2048) and kernel 1
    # otherwise; "banded" forces the chunk-band on every device; any other
    # value of the JAX package ("xla_scores", "pallas") computes exact
    # attention through kernel 1. The banded geometry: query chunk c attends
    # key chunks [c - banded_left, c + banded_right] of banded_chunk frames.
    # The 2048 threshold is the JAX package's TPU choice, kept until an H100
    # measurement decides it. conv_backend is read only by the JAX package.
    attention_backend: str = "xla"
    banded_chunk: int = 128
    banded_left: int = 2
    banded_right: int = 2
    banded_long_threshold: int = 2048
    conv_backend: str = "matmul"

    @property
    def time_embed_dim(self) -> int:
        return self.channels[0] * 4


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """CosyVoice 3's flow-matching estimator, a DiT adapted from F5-TTS
    (FunAudioLLM/CosyVoice `cosyvoice/flow/DiT/dit.py`, `modules.py`; the
    widths of Fun-CosyVoice3-0.5B's `cosyvoice3.yaml`, flow.decoder.estimator),
    with no long skip. `models/dit.py` runs it where `CFMConfig.estimator_kind`
    is "dit".

    rope_heads: the heads whose q and k RoPE turns. CosyVoice's
    AttnProcessor rotates the projection before the heads are split, so only
    the first dim_head channels turn: 1 (F5-TTS names the same choice
    `pe_attn_head`). `heads` turns every head."""

    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 2
    mel_dim: int = 80
    mu_dim: int = 80
    spk_dim: int = 80
    out_channels: int = 80
    static_chunk_size: int = 50
    freq_embed_dim: int = 256  # sinusoidal features of the timestep
    conv_kernel: int = 31  # CausalConvPositionEmbedding's two grouped convs
    conv_groups: int = 16
    rope_heads: int = 1

    @property
    def in_dim(self) -> int:
        # cat[x, cond, mu, spks]
        return 2 * self.mel_dim + self.mu_dim + self.spk_dim


ESTIMATOR_KINDS = ("unet", "dit")


@dataclasses.dataclass(frozen=True)
class CFMConfig:
    """Conditional flow matching (configs/base.yaml:76-87).

    estimator_kind selects the estimator: "unet", the U-Net of `estimator`
    (JyutVoice's), or "dit", the DiT of `dit` (CosyVoice 3's), which takes
    its attention routes from `estimator`'s backend and band settings.
    Neither field is in the JAX package's config."""

    in_channels: int = 240
    n_spks: int = 1
    spk_emb_dim: int = 80
    sigma_min: float = 1e-6
    solver: str = "euler"
    t_scheduler: str = "cosine"
    training_cfg_rate: float = 0.2
    inference_cfg_rate: float = 0.7
    # Fixed noise buffer length: 50 fps * 300 s (flow_matching.py:354)
    rand_noise_frames: int = 15000
    estimator: EstimatorConfig = dataclasses.field(default_factory=EstimatorConfig)
    estimator_kind: str = "unet"
    dit: DiTConfig = dataclasses.field(default_factory=DiTConfig)


def require_unet(cfm_or_estimator, path: str) -> None:
    """Raise for a path that runs the U-Net estimator only, given a
    CFMConfig that selects the DiT or a DiT module (whose `cfg` is a
    DiTConfig)."""
    kind = getattr(cfm_or_estimator, "estimator_kind", None)
    if kind is None:
        kind = "dit" if isinstance(getattr(cfm_or_estimator, "cfg", None), DiTConfig) else "unet"
    if kind != "unet":
        raise NotImplementedError(
            f"{path} runs the U-Net estimator only; this decoder is the DiT "
            f"(tts.cfm.estimator_kind={kind!r})"
        )


@dataclasses.dataclass(frozen=True)
class FlowEncoderConfig:
    """CosyVoice2 speech-token encoder (infer.py:35-82)."""

    vocab_size: int = 6561
    input_size: int = 512
    output_size: int = 512
    proj_size: int = 80
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    num_up_blocks: int = 4
    pre_lookahead_len: int = 3
    upsample_stride: int = 2
    static_chunk_size: int = 25
    dropout_rate: float = 0.1
    # full conformer options (reference upsample_encoder.py:155-166,
    # encoder_layer.py:241-319). The live FlowEncoder config disables both
    # (reference infer.py:55-56); CosyVoice2-style encoder configs enable
    # them.
    macaron_style: bool = False
    use_cnn_module: bool = False
    cnn_module_kernel: int = 15
    cnn_module_norm: str = "batch_norm"  # or "layer_norm"
    causal_cnn: bool = False


@dataclasses.dataclass(frozen=True)
class HiFTConfig:
    """HiFT NSF+iSTFT vocoder (configs/base.yaml:26-48)."""

    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 24000
    nsf_alpha: float = 0.1
    nsf_sigma: float = 0.003
    nsf_voiced_threshold: float = 10.0
    upsample_rates: Tuple[int, ...] = (8, 5, 3)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 11, 7)
    istft_n_fft: int = 16
    istft_hop_len: int = 4
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    source_resblock_kernel_sizes: Tuple[int, ...] = (7, 7, 11)
    source_resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99
    f0_predictor_cond_channels: int = 512
    # Backend switches of the JAX package, kept for a shared configuration.
    # This package always runs the C <= 128 stages through its fused stage
    # kernel (nn/resblock_stage.py) and the others as separate convs.
    fuse_resblock_branches: bool = False
    resblock_backend: str = "xla"

    @property
    def total_upsample(self) -> int:
        total = self.istft_hop_len
        for r in self.upsample_rates:
            total *= r
        return total  # 8*5*3*4 = 480 = hop_length


@dataclasses.dataclass(frozen=True)
class TTSConfig:
    """Top-level acoustic model (configs/base.yaml:50-110)."""

    encoder: TextEncoderConfig = dataclasses.field(default_factory=TextEncoderConfig)
    dp: DurationPredictorConfig = dataclasses.field(
        default_factory=DurationPredictorConfig
    )
    cfm: CFMConfig = dataclasses.field(default_factory=CFMConfig)
    output_size: int = 80
    spk_embed_dim: int = 192
    freeze_encoder: bool = False
    freeze_decoder: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (configs/base.yaml:106-144)."""

    learning_rate: float = 2e-4
    weight_decay: float = 0.0
    warmup_steps: int = 100
    max_epochs: int = 20
    gradient_clip_val: float = 1.0
    batch_size: int = 8
    seed: int = 42
    diff_loss_weight: float = 0.1  # total = dur + prior + 0.1*diff
    # prefix teacher-forcing of conds: 50% chance, up to 0.3*len
    cond_prob: float = 0.5
    cond_max_ratio: float = 0.3
    precision: str = "bf16"  # activations; params/optimizer state stay f32
    # optional main LR schedule after warmup (reference SequentialLR hook,
    # baselightningmodule.py:38-60; the live config has scheduler: null):
    # None | "cosine" | "exponential"
    scheduler: Optional[str] = None
    scheduler_decay_steps: int = 100_000  # cosine horizon
    scheduler_gamma: float = 0.999995  # exponential per-step decay


@dataclasses.dataclass(frozen=True)
class JyutVoiceConfig:
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig)
    tts: TTSConfig = dataclasses.field(default_factory=TTSConfig)
    flow_encoder: FlowEncoderConfig = dataclasses.field(
        default_factory=FlowEncoderConfig
    )
    hift: HiFTConfig = dataclasses.field(default_factory=HiFTConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    token_frame_rate: int = 25
    token_mel_ratio: int = 2
    add_blank: bool = True


DEFAULT_CONFIG = JyutVoiceConfig()


def config_from_dict(values: dict, cls=JyutVoiceConfig):
    """A config from nested dicts of its fields (a JSON file's), lists as
    tuples; fields left out keep their defaults, unknown keys raise."""
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    extra = sorted(set(values) - names)
    if extra:
        raise ValueError(f"{cls.__name__} has no fields {extra}")
    kw = {}
    for name, v in values.items():
        if dataclasses.is_dataclass(hints[name]):
            v = config_from_dict(v, hints[name])
        elif isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kw[name] = v
    return cls(**kw)


def load_config(path: str) -> JyutVoiceConfig:
    """A JyutVoiceConfig from a JSON file: the config's nested fields at
    the top level, or under "model" (a benchmark configuration file)."""
    with open(path, encoding="utf-8") as f:
        values = json.load(f)
    return config_from_dict(values.get("model", values))
