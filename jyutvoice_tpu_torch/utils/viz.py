"""Mel and alignment images (the reference's utils/utils.py:138-182), a copy
of the JAX package's `utils/viz.py`: numpy colour mapping and PIL PNGs, no
matplotlib."""

from __future__ import annotations

import numpy as np

# a compact viridis: anchor colours, linearly interpolated
_VIRIDIS = np.array(
    [
        [68, 1, 84], [71, 44, 122], [59, 81, 139], [44, 113, 142],
        [33, 144, 141], [39, 173, 129], [92, 200, 99], [170, 220, 50],
        [253, 231, 37],
    ],
    dtype=np.float32,
)


def colormap(x: np.ndarray) -> np.ndarray:
    """(H, W) floats -> (H, W, 3) uint8 viridis-like image."""
    x = np.asarray(x, np.float32)
    lo, hi = float(x.min()), float(x.max())
    t = (x - lo) / (hi - lo + 1e-9) * (len(_VIRIDIS) - 1)
    i = np.clip(t.astype(np.int32), 0, len(_VIRIDIS) - 2)
    frac = (t - i)[..., None]
    rgb = _VIRIDIS[i] * (1 - frac) + _VIRIDIS[i + 1] * frac
    return rgb.astype(np.uint8)


def save_mel_png(path: str, mel: np.ndarray) -> None:
    """mel (T, n_mels) -> PNG with frequency on the vertical axis."""
    from PIL import Image

    img = colormap(np.asarray(mel).T[::-1])  # (n_mels, T, 3), low frequencies at the bottom
    Image.fromarray(img).save(path)


def save_attn_png(path: str, attn: np.ndarray) -> None:
    """alignment (T_text, T_mel) -> PNG."""
    from PIL import Image

    Image.fromarray(colormap(np.asarray(attn))).save(path)
