"""The acoustic model: text + optional voice-cloning prompt -> mel, and its
training losses.

The counterpart of the JAX package's `models/tts.py`: `synthesize_mel` at
padded bucket shapes (text bucket T_text, mel bucket T_mel, prompt bucket
T_prompt) and `compute_losses`. The decoder is the configuration's
estimator: the U-Net, or CosyVoice 3's DiT (`models/dit.py`), which the JAX
package lacks. Two details of synthesis are kept exactly:
  * durations are ceil(w) * length_scale, i.e. the scale comes AFTER the ceil,
    so fractional "durations" feed the cumulative sum;
  * the generated frames are grafted right after the TRUE prompt length, so
    prompt and speech frames are contiguous, and stripped from there.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from jyutvoice_tpu_torch.align import maximum_path
from jyutvoice_tpu_torch.config import ESTIMATOR_KINDS, CFMConfig, TTSConfig
from jyutvoice_tpu_torch.models.cfm import cfm_forward, cfm_loss
from jyutvoice_tpu_torch.models.dit import DiT
from jyutvoice_tpu_torch.models.duration import DurationPredictor, duration_loss
from jyutvoice_tpu_torch.models.estimator import Estimator
from jyutvoice_tpu_torch.models.text_encoder import TextEncoder
from jyutvoice_tpu_torch.nn import core
from jyutvoice_tpu_torch.utils.observability import span

Tensor = torch.Tensor


def make_estimator(cfm: CFMConfig) -> nn.Module:
    """The configuration's estimator: the U-Net or the DiT."""
    if cfm.estimator_kind == "unet":
        return Estimator(cfm.estimator)
    if cfm.estimator_kind == "dit":
        return DiT(cfm.dit, cfm.estimator)
    raise ValueError(f"unknown estimator_kind {cfm.estimator_kind!r} "
                     f"(one of {', '.join(ESTIMATOR_KINDS)})")


class TTS(nn.Module):
    def __init__(self, cfg: TTSConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = TextEncoder(cfg.encoder)
        self.dp = DurationPredictor(cfg.dp)
        self.decoder = make_estimator(cfg.cfm)
        self.spk_embed_affine_layer = core.Linear(cfg.spk_embed_dim, cfg.output_size)


def l2_normalize(x: Tensor, dim: int = -1, eps: float = 1e-12) -> Tensor:
    """torch F.normalize semantics: x / max(||x||, eps)."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


class SynthesisOutput(NamedTuple):
    mel: Tensor  # (B, T_mel, 80) generated mel, prompt stripped
    mel_lengths: Tensor  # (B,) valid frames
    encoder_mel: Tensor  # (B, T_mel, 80) encoder prior mu_y
    attn: Tensor  # (B, T_text, T_mel) alignment path
    durations: Tensor  # (B, T_text) frame durations


def _prompt_offsets(prompt_lengths: Tensor, t_prompt_pad: int, device) -> Tensor:
    """(B,) int64 offsets of the generated frames: the true prompt lengths
    clamped to [0, t_prompt_pad], as lax.dynamic_update_slice and
    dynamic_slice clamp their start."""
    return torch.clamp(prompt_lengths.to(device=device, dtype=torch.int64), 0, t_prompt_pad)


def graft_prompt(mu_y: Tensor, prompt_feat: Tensor, prompt_h: Tensor,
                 prompt_lengths: Tensor):
    """The CFM inputs of a prompted request, on the device: (mu, conds), each
    (B, T_prompt_pad + T_mel, 80). conds holds prompt_feat at the head; mu
    holds prompt_h at the head and mu_y from each row's true prompt length
    on, so prompt and speech frames are contiguous. Copies only, and nothing
    is read on the host, so a CUDA graph captures it and torch.export traces
    it."""
    b, t_mel, n_feats = mu_y.shape
    total = prompt_feat.shape[1] + t_mel
    off = _prompt_offsets(prompt_lengths, prompt_feat.shape[1], mu_y.device)
    tail = torch.zeros((b, t_mel, n_feats), dtype=mu_y.dtype, device=mu_y.device)
    conds = torch.cat([prompt_feat.to(mu_y.dtype), tail], dim=1)
    head = torch.cat([prompt_h.to(mu_y.dtype), tail], dim=1)
    rel = torch.arange(total, device=mu_y.device)[None, :] - off[:, None]  # (B, total)
    from_y = ((rel >= 0) & (rel < t_mel))[..., None]
    grafted = torch.gather(mu_y, 1, rel.clamp(0, t_mel - 1)[..., None].expand(b, total, n_feats))
    return torch.where(from_y, grafted, head), conds


def strip_prompt(mel_full: Tensor, prompt_lengths: Tensor, t_prompt_pad: int) -> Tensor:
    """(B, T_prompt_pad + T_mel, 80) -> the T_mel frames from each row's true
    prompt length on (clamped as in `graft_prompt`), on the device."""
    b, total, n_feats = mel_full.shape
    t_mel = total - t_prompt_pad
    off = _prompt_offsets(prompt_lengths, t_prompt_pad, mel_full.device)
    rows = off[:, None] + torch.arange(t_mel, device=mel_full.device)[None, :]
    return torch.gather(mel_full, 1, rows[..., None].expand(b, t_mel, n_feats))


def synthesize_mel(
    model: TTS,
    x_ids: Tensor,
    x_lengths: Tensor,
    lang: Tensor,
    tone: Tensor,
    word_pos: Tensor,
    syllable_pos: Tensor,
    spk_embed: Tensor,
    prompt_feat: Tensor,  # (B, T_prompt_pad, 80) mel of the reference audio
    prompt_h: Tensor,  # (B, T_prompt_pad, 80) flow-encoder hidden states
    prompt_lengths: Tensor,  # (B,)
    *,
    t_mel_max: int,
    n_timesteps: int,
    rand_noise: Tensor,
    temperature: float = 1.0,
    length_scale: float = 1.0,
) -> SynthesisOutput:
    """Prompt lengths of zero (and empty prompt arrays) give the path with no
    voice cloning. Nothing is read back to the host."""
    cfg = model.cfg
    with span("text_half"):
        enc = model.encoder(x_ids, x_lengths, lang, tone, word_pos, syllable_pos, spk_embed)
        c = model.spk_embed_affine_layer(l2_normalize(spk_embed, dim=1))  # (B, 80)
        logw = model.dp(enc.x, enc.x_mask, spk_embed)  # (B, T_text, 1)
    w = torch.exp(logw) * enc.x_mask
    w_ceil = torch.ceil(w) * length_scale  # scale AFTER ceil, as the reference
    y_lengths = torch.clamp(torch.sum(w_ceil, dim=(1, 2)), min=1.0).to(torch.int32)

    y_mask = core.sequence_mask(y_lengths, t_mel_max).to(w.dtype)  # (B, T_mel)
    attn_mask = enc.x_mask[:, :, 0][:, :, None] * y_mask[:, None, :]
    attn = core.generate_path(w_ceil[:, :, 0], attn_mask)  # (B, T_text, T_mel)
    mu_y = torch.einsum("btm,btf->bmf", attn, enc.mu)  # (B, T_mel, 80)

    # prompt graft: prompt rows at the head, mu_y right after the true length
    t_prompt_pad = prompt_feat.shape[1]
    mu, conds = graft_prompt(mu_y, prompt_feat, prompt_h, prompt_lengths)
    plens_t = prompt_lengths.to(device=mu.device, dtype=torch.int32)
    mask = core.sequence_mask(plens_t + y_lengths, mu.shape[1]).to(mu.dtype)[..., None]
    mel_full = cfm_forward(
        model.decoder, cfg.cfm, mu, mask, c, conds,
        n_timesteps=n_timesteps, rand_noise=rand_noise, temperature=temperature,
    )
    mel = strip_prompt(mel_full, prompt_lengths, t_prompt_pad)
    mel = mel * y_mask[..., None]
    return SynthesisOutput(
        mel=mel,
        mel_lengths=y_lengths,
        encoder_mel=mu_y * y_mask[..., None],
        attn=attn,
        durations=w_ceil[:, :, 0],
    )


class TrainLosses(NamedTuple):
    dur_loss: Tensor
    prior_loss: Tensor
    diff_loss: Tensor
    total: Tensor
    attn: Tensor  # (B, T_text, T_mel) MAS alignment


def compute_losses(
    model: TTS,
    generator: Optional[torch.Generator],
    x_ids: Tensor,
    x_lengths: Tensor,
    y_mel: Tensor,  # (B, T_mel, 80) target mel
    y_lengths: Tensor,
    lang: Tensor,
    tone: Tensor,
    word_pos: Tensor,
    syllable_pos: Tensor,
    spk_embed: Tensor,
    decoder_h: Tensor,  # (B, T_mel, 80) frozen flow-encoder hidden states
    *,
    diff_loss_weight: float = 0.1,
    cond_prob: float = 0.5,
    cond_max_ratio: float = 0.3,
    cfm_overrides: Optional[dict] = None,
    train_dropout: bool = True,
) -> TrainLosses:
    """Training losses: duration, prior and diffusion, and their total
    dur + prior + diff_loss_weight * diff.

    MAS aligns text to mel over the Gaussian log-prior of the detached
    encoder means; its path gives the duration target and mu_y = attn^T mu,
    through which the diffusion loss backpropagates into the encoder across
    the frozen decoder. A prefix of the target mel is teacher-forced as
    `conds` with probability 1 - cond_prob.

    Random draws come from `generator`, in this order: the encoder's and
    then the duration predictor's dropout (with `train_dropout`), the cond
    draws (use-cond (B,) uniform, then the prefix fraction (B,) uniform),
    then `cfm_loss`'s (t, z, keep; `cfm_overrides` fixes them)."""
    cfg = model.cfg
    drop = dict(generator=generator, deterministic=not train_dropout)
    c = model.spk_embed_affine_layer(l2_normalize(spk_embed, dim=1))
    enc = model.encoder(x_ids, x_lengths, lang, tone, word_pos, syllable_pos, spk_embed, **drop)
    logw = model.dp(enc.x, enc.x_mask, spk_embed, **drop)

    b, t_mel, n_feats = y_mel.shape
    y_mask = core.sequence_mask(y_lengths, t_mel).to(enc.x_mask.dtype)
    attn_mask = enc.x_mask[:, :, 0][:, :, None] * y_mask[:, None, :]

    # MAS over the Gaussian log-prior, outside the graph
    with torch.no_grad():
        mu_x = enc.mu.detach()
        h = decoder_h
        const = -0.5 * math.log(2 * math.pi) * n_feats
        h_sq = -0.5 * torch.sum(torch.square(h), dim=-1)[:, None, :]
        h_mu = torch.einsum("btf,bmf->btm", mu_x, h)
        mu_sq = -0.5 * torch.sum(torch.square(mu_x), dim=-1)[:, :, None]
        log_prior = h_sq + h_mu + mu_sq + const  # (B, T_text, T_mel)
        attn = maximum_path(log_prior, attn_mask)

    logw_target = torch.log(1e-8 + torch.sum(attn, dim=-1))[:, :, None] * enc.x_mask
    dur_loss = duration_loss(logw, logw_target, x_lengths)

    # prefix teacher-forcing of conds
    use_cond = core.draw((b,), generator, y_mel.device) >= cond_prob
    frac = core.draw((b,), generator, y_mel.device)
    cond_len = (frac * cond_max_ratio * y_lengths.float()).to(torch.int32)
    cond_len = torch.where(use_cond, cond_len, 0)
    pos = torch.arange(t_mel, device=y_mel.device)
    cond_mask = (pos[None, :] < cond_len[:, None]).to(y_mel.dtype)[..., None]
    conds = y_mel * cond_mask

    mu_y = torch.einsum("btm,btf->bmf", attn, enc.mu)
    diff_loss, _ = cfm_loss(
        model.decoder, cfg.cfm, generator, y_mel, y_mask[..., None], mu_y, c, conds,
        **(cfm_overrides or {}),
    )

    prior_loss = torch.sum(
        0.5 * (torch.square(decoder_h - mu_y) + math.log(2 * math.pi)) * y_mask[..., None]
    )
    prior_loss = prior_loss / (core.batch_total(torch.sum(y_mask[..., None])) * n_feats)

    total = dur_loss + prior_loss + diff_loss_weight * diff_loss
    return TrainLosses(dur_loss, prior_loss, diff_loss, total, attn)
