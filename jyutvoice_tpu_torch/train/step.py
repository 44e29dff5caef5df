"""Training step: the frozen-decoder fine-tune.

The counterpart of the JAX package's `train/step.py` on one device:
  * frozen parameter groups: the decoder and the speaker affine layer when
    `freeze_decoder` (the encoder when `freeze_encoder`) get
    `requires_grad=False`, so they take no weight gradients and hold no
    optimizer state, while the diffusion loss still backpropagates through
    the frozen decoder into the encoder;
  * a linear warmup from lr / warmup_steps, then none, a cosine or an
    exponential decay, joined at warmup_steps as optax joins schedules;
  * global-norm clipping with optax's rule (g unchanged when the norm is
    below max_norm, else g / norm * max_norm);
  * AdamW with optax's arithmetic: b1 0.9, b2 0.999, eps 1e-8 outside the
    square root, bias correction by the update count, weight decay added to
    the update before the learning rate scales it.
`Trainer.step` is `make_train_step`'s step: losses, backward, grad norm over
the trainable parameters, clip, AdamW, and the step's learning rate.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from jyutvoice_tpu_torch.config import TrainConfig, TTSConfig
from jyutvoice_tpu_torch.models.tts import TTS, compute_losses

Tensor = torch.Tensor
Schedule = Callable[[int], float]

_INT_KEYS = ("x", "tone", "word_pos", "syllable_pos", "lang")


def trainable_mask(model: TTS, cfg: TTSConfig) -> Dict[str, bool]:
    """Parameter name -> trainable, by top-level module."""
    flags = {
        "encoder": not cfg.freeze_encoder,
        "dp": True,
        "decoder": not cfg.freeze_decoder,
        "spk_embed_affine_layer": not cfg.freeze_decoder,
    }
    return {name: flags[name.split(".")[0]] for name, _ in model.named_parameters()}


def freeze(model: TTS, cfg: TTSConfig) -> List[str]:
    """Set requires_grad from `trainable_mask`; returns the trainable names."""
    mask = trainable_mask(model, cfg)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    return [n for n, m in mask.items() if m]


def warmup_schedule(lr: float, warmup_steps: int) -> Schedule:
    """Linear warmup to lr over warmup_steps, then constant. Step 0 takes
    lr / warmup_steps, not 0, so the first step updates."""

    def sched(step: int) -> float:
        return lr * min((step + 1) / max(warmup_steps, 1), 1.0)

    return sched


def lr_schedule(train_cfg: TrainConfig) -> Schedule:
    """Warmup, then the main schedule from step warmup_steps on, counted
    from 0 there (`optax.join_schedules`)."""
    warm = warmup_schedule(train_cfg.learning_rate, train_cfg.warmup_steps)
    kind = train_cfg.scheduler
    lr = train_cfg.learning_rate
    if kind in (None, "", "none"):
        return warm
    if kind == "cosine":
        horizon = train_cfg.scheduler_decay_steps

        def main(step: int) -> float:
            count = min(step, horizon)
            return lr * 0.5 * (1 + math.cos(math.pi * count / horizon))
    elif kind == "exponential":
        gamma = train_cfg.scheduler_gamma

        def main(step: int) -> float:
            return lr if step <= 0 else lr * gamma ** step
    else:
        raise ValueError(f"unknown scheduler {kind!r}")
    boundary = train_cfg.warmup_steps

    def sched(step: int) -> float:
        return warm(step) if step < boundary else main(step - boundary)

    return sched


def global_norm(tensors: List[Tensor]) -> Tensor:
    """sqrt of the sum of squares over all the tensors, as a 0-d tensor."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


class AdamW:
    """AdamW over a fixed list of parameters, with global-norm clipping in
    front, in optax's arithmetic (`clip_by_global_norm` then `adamw`).
    Multi-tensor (`torch._foreach_*`) updates, in place."""

    def __init__(self, params: List[Tensor], *, weight_decay: float, max_norm: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.weight_decay = weight_decay
        self.max_norm = max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def update(self, grads: List[Tensor], lr: float, norm: Optional[Tensor] = None) -> None:
        """Clip `grads` (in place) by their global norm, then one AdamW step
        at learning rate `lr`."""
        norm = global_norm(grads) if norm is None else norm
        scale = torch.where(norm < self.max_norm, 1.0, self.max_norm / norm)
        torch._foreach_mul_(grads, scale)
        self.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.m, b1)
        torch._foreach_add_(self.m, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.v, b2)
        torch._foreach_addcmul_(self.v, grads, grads, value=1.0 - b2)
        m_hat = torch._foreach_div(self.m, 1.0 - b1 ** self.count)
        denom = torch._foreach_sqrt(torch._foreach_div(self.v, 1.0 - b2 ** self.count))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(m_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)

    def state_dict(self) -> dict:
        return {"count": self.count, "m": self.m, "v": self.v}

    def load_state_dict(self, state: dict) -> None:
        if len(state["m"]) != len(self.params) or len(state["v"]) != len(self.params):
            raise ValueError("optimizer state does not fit the trainable parameters")
        self.count = int(state["count"])
        with torch.no_grad():
            for dst, src in zip(self.m + self.v, list(state["m"]) + list(state["v"])):
                dst.copy_(src)


def batch_to_device(batch: Dict, device) -> Dict[str, Tensor]:
    """A collated numpy batch -> tensors on `device` (text ids int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        out[k] = t.to(device=device, dtype=torch.int64 if k in _INT_KEYS else t.dtype)
    return out


def loss_fn(model: TTS, train_cfg: TrainConfig, generator: Optional[torch.Generator],
            batch: Dict[str, Tensor], train_dropout: bool = True):
    """(total loss, metrics) of one batch of device tensors."""
    losses = compute_losses(
        model, generator, batch["x"], batch["x_lengths"], batch["y"], batch["y_lengths"],
        batch["lang"], batch["tone"], batch["word_pos"], batch["syllable_pos"],
        batch["spk_embed"], batch["decoder_h"],
        diff_loss_weight=train_cfg.diff_loss_weight, cond_prob=train_cfg.cond_prob,
        cond_max_ratio=train_cfg.cond_max_ratio, train_dropout=train_dropout,
    )
    metrics = {
        "dur_loss": losses.dur_loss.detach(),
        "prior_loss": losses.prior_loss.detach(),
        "diff_loss": losses.diff_loss.detach(),
        "loss": losses.total.detach(),
    }
    return losses.total, metrics


class Trainer:
    """Holds the training state of one device: the model (its parameters),
    the optimizer state, the step count and the random generator.

    `generator` (on the model's device) feeds every random draw of the
    losses; saving its state with a checkpoint makes a resumed run draw
    what an uninterrupted one would."""

    def __init__(self, model: TTS, train_cfg: TrainConfig, generator: torch.Generator,
                 train_dropout: bool = True):
        self.model = model
        self.train_cfg = train_cfg
        self.generator = generator
        self.train_dropout = train_dropout
        self.device = next(model.parameters()).device
        self.trainable = freeze(model, model.cfg)
        named = dict(model.named_parameters())
        self.params = [named[n] for n in self.trainable]
        self.optimizer = AdamW(self.params, weight_decay=train_cfg.weight_decay,
                               max_norm=train_cfg.gradient_clip_val)
        self.schedule = lr_schedule(train_cfg)
        self.step_count = 0

    def step(self, batch: Dict) -> Dict[str, Tensor]:
        """One optimizer step on a collated batch (numpy arrays or device
        tensors). Returns the step's metrics: the losses, `grad_norm` over
        the trainable parameters before clipping, and `lr`."""
        if not isinstance(batch["x"], Tensor) or batch["x"].device != self.device:
            batch = batch_to_device(batch, self.device)
        for p in self.params:
            p.grad = None
        total, metrics = loss_fn(self.model, self.train_cfg, self.generator, batch,
                                 self.train_dropout)
        total.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norm = global_norm(grads)
        lr = self.schedule(self.step_count)
        self.optimizer.update(grads, lr, norm)
        for p in self.params:
            p.grad = None
        metrics["grad_norm"] = norm.detach()
        metrics["lr"] = lr
        self.step_count += 1
        return metrics

    @torch.no_grad()
    def evaluate(self, batch: Dict) -> Dict[str, Tensor]:
        """Eval-mode losses (no dropout) of one batch; draws from a
        generator seeded 0, as the JAX package's validation uses key 0."""
        if not isinstance(batch["x"], Tensor) or batch["x"].device != self.device:
            batch = batch_to_device(batch, self.device)
        gen = torch.Generator(device=self.device).manual_seed(0)
        _, metrics = loss_fn(self.model, self.train_cfg, gen, batch, False)
        return metrics

    def state_dict(self) -> dict:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step_count,
            "generator": self.generator.get_state(),
        }

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step_count = int(state["step"])
        self.generator.set_state(state["generator"])
