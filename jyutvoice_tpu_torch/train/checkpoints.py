"""Checkpoints with `torch.save`, in place of the JAX package's orbax
checkpoints (`train/checkpoints.py`).

A checkpoint is one file, `<dir>/step_<n>.pt`, holding whatever state dict
the caller passes (the trainer's: model, optimizer state, step, generator
state, and the CLI's epoch position). `save` keeps the newest max_to_keep
steps. `save_best` keeps the max_to_keep lowest validation losses in
`<dir>/best`, with the losses in `<dir>/best/val_loss.json`. Files are
written to a temporary name and renamed, so a crash mid-write leaves no
partial file behind.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{int(step)}.pt")


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory) if (m := _NAME.match(f)))


def _write(directory: str, step: int, payload: Dict[str, Any]) -> None:
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _losses_path(best_dir: str) -> str:
    return os.path.join(best_dir, "val_loss.json")


def save(directory: str, step: int, state: Dict[str, Any], max_to_keep: int = 10) -> None:
    """Write `state` as step `step`; drop all but the newest max_to_keep."""
    _write(directory, step, {"state": state})
    for old in _steps(directory)[:-max_to_keep]:
        os.remove(_path(directory, old))


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: Optional[int] = None, map_location=None):
    """The state saved at `step` (the latest when None), or None if there is
    none."""
    step = latest_step(directory) if step is None else step
    if step is None:
        return None
    payload = torch.load(_path(directory, step), map_location=map_location, weights_only=False)
    return payload["state"]


def _best_losses(best_dir: str) -> Dict[int, float]:
    if not os.path.exists(_losses_path(best_dir)):
        return {}
    with open(_losses_path(best_dir)) as f:
        losses = {int(s): float(v) for s, v in json.load(f).items()}
    return {s: v for s, v in losses.items() if s in set(_steps(best_dir))}


def save_best(directory: str, step: int, state: Dict[str, Any], val_loss: float,
              max_to_keep: int = 10) -> None:
    """Keep the top max_to_keep checkpoints by validation loss in <dir>/best
    (the reference's ModelCheckpoint(monitor="val_loss", save_top_k=10))."""
    best_dir = os.path.join(directory, "best")
    _write(best_dir, step, {"state": state})
    losses = _best_losses(best_dir)
    losses[int(step)] = float(val_loss)
    for s in sorted(losses, key=lambda s: (losses[s], s))[max_to_keep:]:
        os.remove(_path(best_dir, s))
        del losses[s]
    tmp = _losses_path(best_dir) + ".tmp"
    with open(tmp, "w") as f:
        json.dump({str(s): v for s, v in losses.items()}, f)
    os.replace(tmp, _losses_path(best_dir))


def best_step(directory: str) -> Optional[int]:
    """Step of the lowest-val_loss checkpoint in <dir>/best, or None."""
    losses = _best_losses(os.path.join(directory, "best"))
    return min(losses, key=lambda s: (losses[s], s)) if losses else None


def restore_best(directory: str, map_location=None):
    step = best_step(directory)
    if step is None:
        return None
    return restore(os.path.join(directory, "best"), step, map_location)
