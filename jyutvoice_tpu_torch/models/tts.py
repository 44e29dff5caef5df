"""The acoustic model: text + optional voice-cloning prompt -> mel.

The counterpart of the JAX package's `models/tts.py::synthesize_mel` at
padded bucket shapes: text bucket T_text, mel bucket T_mel, prompt bucket
T_prompt. Two details are kept exactly:
  * durations are ceil(w) * length_scale, i.e. the scale comes AFTER the ceil,
    so fractional "durations" feed the cumulative sum;
  * the generated frames are grafted right after the TRUE prompt length, so
    prompt and speech frames are contiguous, and stripped from there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from jyutvoice_tpu_torch.config import TTSConfig
from jyutvoice_tpu_torch.models.cfm import cfm_forward
from jyutvoice_tpu_torch.models.duration import DurationPredictor
from jyutvoice_tpu_torch.models.estimator import Estimator
from jyutvoice_tpu_torch.models.text_encoder import TextEncoder
from jyutvoice_tpu_torch.nn import core

Tensor = torch.Tensor


class TTS(nn.Module):
    def __init__(self, cfg: TTSConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = TextEncoder(cfg.encoder)
        self.dp = DurationPredictor(cfg.dp)
        self.decoder = Estimator(cfg.cfm.estimator)
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
    voice cloning. prompt_lengths are read on the host for the graft."""
    cfg = model.cfg
    enc = model.encoder(x_ids, x_lengths, lang, tone, word_pos, syllable_pos, spk_embed)
    c = model.spk_embed_affine_layer(l2_normalize(spk_embed, dim=1))  # (B, 80)

    logw = model.dp(enc.x, enc.x_mask, spk_embed)  # (B, T_text, 1)
    w = torch.exp(logw) * enc.x_mask
    w_ceil = torch.ceil(w) * length_scale  # scale AFTER ceil, as the reference
    y_lengths = torch.clamp(torch.sum(w_ceil, dim=(1, 2)), min=1.0).to(torch.int32)

    b = x_ids.shape[0]
    y_mask = core.sequence_mask(y_lengths, t_mel_max).to(w.dtype)  # (B, T_mel)
    attn_mask = enc.x_mask[:, :, 0][:, :, None] * y_mask[:, None, :]
    attn = core.generate_path(w_ceil[:, :, 0], attn_mask)  # (B, T_text, T_mel)
    mu_y = torch.einsum("btm,btf->bmf", attn, enc.mu)  # (B, T_mel, 80)

    # prompt graft: prompt rows at the head, mu_y right after the true length
    t_prompt_pad = prompt_feat.shape[1]
    total = t_prompt_pad + t_mel_max
    mu = torch.zeros((b, total, cfg.output_size), dtype=mu_y.dtype, device=mu_y.device)
    conds = torch.zeros_like(mu)
    mu[:, :t_prompt_pad] = prompt_h.to(mu.dtype)
    conds[:, :t_prompt_pad] = prompt_feat.to(mu.dtype)
    plens = [int(p) for p in prompt_lengths.tolist()]
    for i, p in enumerate(plens):
        mu[i, p : p + t_mel_max] = mu_y[i]

    plens_t = prompt_lengths.to(device=mu.device, dtype=torch.int32)
    mask = core.sequence_mask(plens_t + y_lengths, total).to(mu.dtype)[..., None]
    mel_full = cfm_forward(
        model.decoder, cfg.cfm, mu, mask, c, conds,
        n_timesteps=n_timesteps, rand_noise=rand_noise, temperature=temperature,
    )
    mel = torch.stack([mel_full[i, p : p + t_mel_max] for i, p in enumerate(plens)])
    mel = mel * y_mask[..., None]
    return SynthesisOutput(
        mel=mel,
        mel_lengths=y_lengths,
        encoder_mel=mu_y * y_mask[..., None],
        attn=attn,
        durations=w_ceil[:, :, 0],
    )
