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

Data parallel (`Trainer(mesh=...)`, the data mesh of a torchrun job,
`dist/mesh.py::make_mesh`): every rank is handed the same global batch and
runs its own rows of it whole, so kernels 3-5 stay on the route at T >=
2048. The trainable half is wrapped in DistributedDataParallel (the frozen
decoder has requires_grad=False and stays out of its reducer). The JAX
package's losses are ratios over the whole global batch, so each rank
divides its numerators by the denominators summed over the ranks and
scales its loss by the world size before DDP averages the gradients; every
random draw is made at the global batch's shape and cut to the rank's rows
(`nn/core.py::batch_rows`). The ranks together then take the step one
process takes on the whole batch: the same losses, the same all-reduced
gradients, so grad_norm, the clip and AdamW act alike on every rank.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from jyutvoice_tpu_torch.config import TrainConfig, TTSConfig, require_unet
from jyutvoice_tpu_torch.models.tts import TTS, compute_losses
from jyutvoice_tpu_torch.nn import core

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


class _Losses(torch.nn.Module):
    """`loss_fn` as a module call, the unit DistributedDataParallel wraps."""

    def __init__(self, model: TTS, train_cfg: TrainConfig):
        super().__init__()
        self.model = model
        self.train_cfg = train_cfg

    def forward(self, batch, generator, train_dropout):
        return loss_fn(self.model, self.train_cfg, generator, batch, train_dropout)


class Trainer:
    """Holds the training state of one device: the model (its parameters),
    the optimizer state, the step count and the random generator.

    `generator` (on the model's device) feeds every random draw of the
    losses; saving its state with a checkpoint makes a resumed run draw
    what an uninterrupted one would. `mesh`: the data mesh of a torchrun
    job (`dist/mesh.py::make_mesh`); with more than one rank, every rank
    is handed the same global batch and runs its own rows (module
    docstring). Every rank holds the same model and optimizer state."""

    def __init__(self, model: TTS, train_cfg: TrainConfig, generator: torch.Generator,
                 train_dropout: bool = True, mesh=None):
        require_unet(model.cfg.cfm, "the training step")
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
        # a data mesh over a process group (a group of one too: torchrun
        # --nproc-per-node 1 runs the same collectives)
        self.mesh = mesh if mesh is not None and torch.distributed.is_initialized() else None
        self._losses = _Losses(model, train_cfg)
        self._forward = self._losses
        if self.mesh is not None:
            from torch.nn.parallel import DistributedDataParallel

            # DDP broadcasts rank 0's parameters and buffers here
            self._forward = DistributedDataParallel(
                self._losses, device_ids=[self.device] if self.device.type == "cuda" else None)

    def _rows(self, batch: Dict[str, Tensor], sharded: bool):
        """(this rank's rows of the batch, their `core.BatchRows`), or the
        whole batch on one process or unsharded."""
        if self.mesh is None or not sharded:
            return batch, None
        from jyutvoice_tpu_torch.dist.mesh import batch_sharding

        b = batch["x"].shape[0]
        rows = batch_sharding(self.mesh).rows(b)
        local = {k: v[rows] for k, v in batch.items()}
        return local, core.BatchRows(rows.start, b, self.mesh.comm().all_reduce)

    def _sum_metrics(self, metrics: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Each rank's share of the losses -> the global batch's, on every rank."""
        keys = list(metrics)
        total = self.mesh.comm().all_reduce(torch.stack([metrics[k].float() for k in keys]))
        return {k: total[i] for i, k in enumerate(keys)}

    def gradients(self, batch: Dict):
        """(metrics, gradients): the losses of a collated global batch (numpy
        arrays or device tensors) and the trainable parameters' gradients
        (all-reduced over a data mesh), without updating anything."""
        if not isinstance(batch["x"], Tensor) or batch["x"].device != self.device:
            batch = batch_to_device(batch, self.device)
        for p in self.params:
            p.grad = None
        local, rows = self._rows(batch, sharded=True)
        with core.batch_rows(rows):
            total, metrics = self._forward(local, self.generator, self.train_dropout)
        if rows is not None:
            # DDP averages the ranks' gradients: scale so that they add up
            total = total * self.mesh.size
            metrics = self._sum_metrics(metrics)
        total.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        for p in self.params:
            p.grad = None
        return metrics, grads

    def step(self, batch: Dict) -> Dict[str, Tensor]:
        """One optimizer step on a collated batch (numpy arrays or device
        tensors). Returns the step's metrics: the losses, `grad_norm` over
        the trainable parameters before clipping, and `lr`."""
        metrics, grads = self.gradients(batch)
        norm = global_norm(grads)
        lr = self.schedule(self.step_count)
        self.optimizer.update(grads, lr, norm)
        metrics["grad_norm"] = norm.detach()
        metrics["lr"] = lr
        self.step_count += 1
        return metrics

    @torch.no_grad()
    def evaluate(self, batch: Dict) -> Dict[str, Tensor]:
        """Eval-mode losses (no dropout) of one batch; draws from a
        generator seeded 0, as the JAX package's validation uses key 0. On a
        data mesh a batch whose rows split over the ranks is sharded; one
        that does not is evaluated whole on every rank (exact: padding it
        with repeated rows would bias the mean)."""
        if not isinstance(batch["x"], Tensor) or batch["x"].device != self.device:
            batch = batch_to_device(batch, self.device)
        gen = torch.Generator(device=self.device).manual_seed(0)
        sharded = self.mesh is not None and batch["x"].shape[0] % self.mesh.size == 0
        local, rows = self._rows(batch, sharded)
        with core.batch_rows(rows):
            _, metrics = loss_fn(self.model, self.train_cfg, gen, local, False)
        return self._sum_metrics(metrics) if rows is not None else metrics

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
