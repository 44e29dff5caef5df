"""The fixed CFM noise buffer.

The reference model draws `torch.randn(1, 80, 15000)` from seed 0 when its
decoder is built, which makes synthesis deterministic. `rand_noise`
regenerates that buffer with an explicit CPU generator: it equals the JAX
package's committed `rand_noise_seed0.npy` bit for bit. Past 15000 frames
`rand_noise_extended` continues with the JAX package's numpy stream.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

FRAMES = 50 * 300


@functools.lru_cache(maxsize=1)
def _seed0_buffer() -> torch.Tensor:
    g = torch.Generator().manual_seed(0)
    return torch.randn(1, 80, FRAMES, generator=g).transpose(1, 2).contiguous()


def rand_noise(frames: int = FRAMES, device="cpu") -> torch.Tensor:
    """(1, frames, 80) float32 noise, channels-last; at most 15000 frames."""
    if frames > FRAMES:
        raise ValueError(
            f"{frames} frames exceed the {FRAMES}-frame seed-0 noise buffer"
        )
    return _seed0_buffer()[:, :frames].to(device, copy=True)  # callers own their copy


def rand_noise_extended(frames: int, device="cpu") -> torch.Tensor:
    """(1, frames, 80) noise past the 15000-frame buffer: the seed-0 buffer,
    then a numpy `default_rng(0xC0DEC)` stream for the frames beyond it."""
    if frames <= FRAMES:
        return rand_noise(frames, device)
    extra = (
        np.random.default_rng(0xC0DEC)
        .standard_normal((frames - FRAMES, 80))
        .astype(np.float32)[None]
    )
    return torch.cat([_seed0_buffer(), torch.from_numpy(extra)], dim=1).to(device)
