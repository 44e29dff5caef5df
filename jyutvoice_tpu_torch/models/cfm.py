"""Conditional flow matching: fixed-step Euler solve with classifier-free guidance.

The counterpart of the JAX package's `models/cfm.py`. The Euler loop is a
Python loop over the steps; classifier-free guidance runs as one doubled
batch per step (rows [0, B) conditioned, rows [B, 2B) with mu, spks and cond
zeroed), so each step makes one estimator call. `cfm_loss` is the training
loss: a cosine-scheduled t, the OT path and CFG dropout of the conditioning,
with one estimator call on the undoubled batch.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from jyutvoice_tpu_torch.config import CFMConfig
from jyutvoice_tpu_torch.models.estimator import Estimator
from jyutvoice_tpu_torch.nn import core
from jyutvoice_tpu_torch.utils.observability import span

Tensor = torch.Tensor


def cosine_t_span(n_timesteps: int, device="cpu") -> Tensor:
    """t_span = 1 - cos(linspace(0, 1) * pi / 2), n_timesteps + 1 points."""
    t = torch.linspace(0.0, 1.0, n_timesteps + 1, dtype=torch.float32, device=device)
    return 1.0 - torch.cos(t * 0.5 * math.pi)


def solve_euler_cfg(
    estimator: Estimator, cfg: CFMConfig, z: Tensor, t_span: Tensor, mu: Tensor,
    mask: Tensor, spks: Tensor, cond: Tensor, streaming: bool = False,
    attention: str = "auto",
) -> Tensor:
    """z, mu, cond (B, T, 80); mask (B, T, 1); spks (B, 80); attention the
    estimator's long-form mode ("auto", "banded" or "exact")."""
    b = z.shape[0]
    mu2 = torch.cat([mu, torch.zeros_like(mu)], dim=0)
    spks2 = torch.cat([spks, torch.zeros_like(spks)], dim=0)
    cond2 = torch.cat([cond, torch.zeros_like(cond)], dim=0)
    mask2 = torch.cat([mask, mask], dim=0)
    rate = cfg.inference_cfg_rate
    x = z
    for i in range(t_span.shape[0] - 1):
        t, dt = t_span[i], t_span[i + 1] - t_span[i]
        x2 = torch.cat([x, x], dim=0)
        t2 = t.to(x.dtype).expand(2 * b)
        dphi = estimator(x2, mask2, mu2, t2, spks2, cond2, streaming, attention)
        dphi = (1.0 + rate) * dphi[:b] - rate * dphi[b:]
        x = x + dt * dphi
    return x.float()


def cfm_forward(
    estimator: Estimator, cfg: CFMConfig, mu: Tensor, mask: Tensor, spks: Tensor,
    cond: Tensor, *, n_timesteps: int, rand_noise: Tensor,
    temperature: float = 1.0, streaming: bool = False, attention: str = "auto",
) -> Tensor:
    """Mel from the prior mean. rand_noise: (1, >= T, 80) fixed noise buffer."""
    with span("mel.solve"):
        t = mu.shape[1]
        z = rand_noise[:, :t, :].to(mu.dtype) * temperature
        z = z.expand(mu.shape)
        t_span = cosine_t_span(n_timesteps, device=mu.device).to(mu.dtype)
        return solve_euler_cfg(
            estimator, cfg, z, t_span, mu, mask, spks, cond, streaming, attention
        )


def cfm_loss(
    estimator: Estimator, cfg: CFMConfig, generator: Optional[torch.Generator],
    x1: Tensor, mask: Tensor, mu: Tensor, spks: Tensor, cond: Tensor,
    streaming: bool = False, t_override: Optional[Tensor] = None,
    z_override: Optional[Tensor] = None, cfg_keep_override: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Flow-matching loss. x1 (target mel), mu, cond (B, T, 80); mask
    (B, T, 1); spks (B, 80). Returns (loss, y), y the point on the OT path.

    Random draws come from `generator`, in this order: t (B,) uniform, then
    z like x1 standard normal, then the CFG keep draw (B,) uniform; an
    override skips its draw. The estimator runs with `training=True`: no
    banded attention, the stock-flash gate kept (kernels 3, 4 and 5 on the
    card at 512-aligned T >= 2048)."""
    b = x1.shape[0]
    dev, dt = x1.device, x1.dtype
    if t_override is None:
        t = core.draw((b, 1, 1), generator, dev, dt)
        if cfg.t_scheduler == "cosine":
            t = 1.0 - torch.cos(t * 0.5 * math.pi)
    else:
        t = t_override.reshape(b, 1, 1).to(dt)
    if z_override is None:
        z = core.draw(x1.shape, generator, dev, dt, normal=True)
    else:
        z = z_override.to(dt)

    y = (1.0 - (1.0 - cfg.sigma_min) * t) * z + t * x1
    u = x1 - (1.0 - cfg.sigma_min) * z

    if cfg.training_cfg_rate > 0:
        if cfg_keep_override is None:
            draw = core.draw((b,), generator, dev)
            keep = (draw > cfg.training_cfg_rate).to(dt)
        else:
            keep = cfg_keep_override.to(dt)
        mu = mu * keep[:, None, None]
        spks = spks * keep[:, None]
        cond = cond * keep[:, None, None]

    pred = estimator(y, mask, mu, t[:, 0, 0], spks, cond, streaming, training=True)
    num = torch.sum(torch.square((pred - u) * mask))
    den = core.batch_total(torch.sum(mask)) * u.shape[-1]
    return num / den, y
