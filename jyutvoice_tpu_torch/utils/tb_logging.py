"""TensorBoard and optional WandB logging of training metrics and images
(the reference's baselightningmodule.py:118-300), the port's copy of the JAX
package's `utils/tb_logging.py`. WandB mirrors the TensorBoard surface when
the package imports and a project name is given (the reference ships its
WandB logger commented out, configs/base.yaml:164-172)."""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from jyutvoice_tpu_torch.utils.viz import colormap

_log = logging.getLogger(__name__)


class TrainLogger:
    """Scalar dicts and mel / alignment images; logs nothing without a sink.
    Without `torch.utils.tensorboard` (or `wandb`) it warns and writes
    nothing to that sink."""

    def __init__(
        self,
        log_dir: Optional[str] = None,
        wandb_project: Optional[str] = None,
        wandb_run_name: Optional[str] = None,
    ):
        self.writer = None
        self.wandb = None
        if log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(log_dir)
            except Exception as e:  # noqa: BLE001 — tensorboard is optional
                _log.warning("tensorboard unavailable: %s", e)
        if wandb_project:
            try:
                import wandb  # type: ignore

                wandb.init(project=wandb_project, name=wandb_run_name)
                self.wandb = wandb
            except Exception as e:  # noqa: BLE001 — wandb is optional
                _log.warning("wandb requested but unavailable (%s); falling back to "
                             "TensorBoard only", e)

    def scalars(self, tag_prefix: str, metrics: Dict[str, float], step: int):
        if self.writer is not None:
            for k, v in metrics.items():
                self.writer.add_scalar(f"{tag_prefix}/{k}", float(v), step)
        if self.wandb is not None:
            self.wandb.log({f"{tag_prefix}/{k}": float(v) for k, v in metrics.items()},
                           step=step)

    def _image(self, tag: str, img: np.ndarray, step: int):
        if self.writer is not None:
            self.writer.add_image(tag, img, step, dataformats="HWC")
        if self.wandb is not None:
            self.wandb.log({tag: self.wandb.Image(img)}, step=step)

    def mel_image(self, tag: str, mel: np.ndarray, step: int):
        """mel (T, n_mels), frequency on the vertical axis."""
        if self.writer is None and self.wandb is None:
            return
        self._image(tag, colormap(np.asarray(mel).T[::-1]), step)

    def attn_image(self, tag: str, attn: np.ndarray, step: int):
        """alignment (T_text, T_mel)."""
        if self.writer is None and self.wandb is None:
            return
        self._image(tag, colormap(np.asarray(attn)), step)

    def close(self):
        if self.writer is not None:
            self.writer.flush()
            self.writer.close()
        if self.wandb is not None:
            self.wandb.finish()
