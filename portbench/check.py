"""The comparison that decides `correct` for served requests.

The reference (`portbench/reference/model.py`) recomputes each sampled
request from its text, speaker embedding and the engine's length scale,
with the weights the benchmark drew, and judges what the program returned:

  frames_off  mel frames of the program's length that no rounding of the
              reference's durations reaches (exact: limit 0). A token whose
              duration lies within DUR_TOL of an integer may round either
              way, since the last bits of two correct f32 computations
              differ; the reference takes the ceilings that reach the
              program's length, nearest boundaries first.
  mel_gap     the largest |mel - reference mel| over the request's frames,
              as a share of the reference mel's largest magnitude.
  wav_gap     the largest |PCM16 sample - reference sample rounded to
              PCM16|, in steps of 1/32767, over the samples of all but the
              last TAIL frames: the vocoder runs over the engine's padded
              mel bucket, whose zero (or noise) frames reach back no
              further than its 32-frame receptive field.
  mel_mean_gap the mean |mel - reference mel| over the request's frames,
              as a share of the reference mel's largest magnitude: where
              the reference rounds activations to int8 as the program
              does, a last-bit difference flips an activation's step here
              and there, which sets the largest gap; a lower precision
              elsewhere flips them everywhere, which the mean shows.
  voc_gap     the vocoder alone: the largest |PCM16 sample - the
              reference vocoder's sample from the program's own mel|, over
              the same samples as wav_gap.

Each number is the worst over the sample, and each has a limit of its own
(`portbench/limits/<workload>.json`).
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference import model as ref

NUMBERS = ("frames_off", "mel_gap", "mel_mean_gap", "wav_gap", "voc_gap")
DUR_TOL = 1e-4  # relative distance of a duration from an integer that may round either way
TAIL = 32  # frames at a request's end left out of the waveform comparison
MAX_AMBIGUOUS = 8


def frame_counts(w: torch.Tensor, length_scale: float, y_len: int):
    """(per-token frames reaching y_len, frames_off) from the reference's
    durations w (T_text,) and the program's length y_len."""
    base = torch.ceil(w).double()
    dist = (w.double() - torch.round(w.double())).abs() / torch.clamp(w.double(), min=1.0)
    amb = torch.nonzero((dist < DUR_TOL) & (torch.round(w.double()) >= 1)).flatten().tolist()
    amb = sorted(amb, key=lambda i: float(dist[i]))[:MAX_AMBIGUOUS]

    def length(c):
        return int(max(float(c.sum()) * length_scale, 1.0))

    best = (abs(length(base) - y_len), base)
    for k in range(1, len(amb) + 1):
        for subset in itertools.combinations(amb, k):
            c = base.clone()
            for i in subset:  # the other side of the nearest integer
                r = float(torch.round(w[i].double()))
                c[i] = r if float(base[i]) > r else r + 1.0
            off = abs(length(c) - y_len)
            if off < best[0]:
                best = (off, c)
        if best[0] == 0:
            break
    return (best[1] * length_scale).float(), best[0]


def pcm16(wav: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0)


def reference_outputs(trees, model: Dict, ids, spk: torch.Tensor, noise: torch.Tensor,
                      length_scale: float, steps: int, got_frames: Optional[int],
                      num: ref.Numerics, band=None, window: Optional[int] = None):
    """(frames_off, mel (1, T, 80), PCM16 waveform (480 (T + TAIL),)) of one
    request computed by the reference in `num`. With got_frames, the
    ceilings of nearly integral durations are taken to reach it (the
    judge); without, they are the reference's own (a control in the
    program's place)."""
    tts, hift = trees
    w = ref.durations(tts, model, ids, spk)
    if got_frames is None:
        frames, off = torch.ceil(w) * length_scale, 0
    else:
        frames, off = frame_counts(w, length_scale, got_frames)
    mel = ref.mel(tts, model, ids, spk, frames, noise, steps, num, band)
    pad = torch.zeros(1, TAIL, mel.shape[2], device=mel.device)
    wav = ref.vocode(hift, model["hift"], torch.cat([mel, pad], dim=1), window=window)
    return off, mel, pcm16(wav[0])


def judge(off: int, mel: torch.Tensor, wav: torch.Tensor, got_frames: int,
          got_mel: Optional[np.ndarray], got_wav: np.ndarray, hift: Optional[Dict] = None,
          hift_model: Optional[Dict] = None, window: Optional[int] = None) -> Dict[str, float]:
    """The numbers of one request from the reference's outputs and the
    program's (its length, its mel (frames, 80), its PCM16 samples); with
    the vocoder's weights, `voc_gap` too."""
    out = {"frames_off": float(off)}
    scale = float(mel.abs().max()) or 1.0
    keep = max(got_frames - TAIL, 0) * (wav.shape[0] // (mel.shape[1] + TAIL))
    gw = torch.as_tensor(np.asarray(got_wav[:keep], np.float32), device=mel.device)
    short = gw.shape[0] < keep
    if got_mel is not None:
        n = mel.shape[1]
        if got_mel.shape[0] != n:
            out["mel_gap"] = out["mel_mean_gap"] = math.inf
            if hift is not None:
                out["voc_gap"] = math.inf
        else:
            gm = torch.as_tensor(np.asarray(got_mel), device=mel.device)
            diff = (gm - mel[0]).abs()
            out["mel_gap"] = float(diff.max()) / scale
            out["mel_mean_gap"] = float(diff.mean()) / scale
            if hift is not None:
                pad = torch.zeros(1, TAIL, gm.shape[1], device=mel.device)
                own = pcm16(ref.vocode(hift, hift_model, torch.cat([gm[None], pad], 1),
                                       window=window)[0])
                out["voc_gap"] = math.inf if short else (
                    float((gw - own[:keep]).abs().max()) if keep else 0.0)
    if short or wav.shape[0] < keep:
        out["wav_gap"] = math.inf
    else:
        out["wav_gap"] = float((gw - wav[:keep]).abs().max()) if keep else 0.0
    return out


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in readings) for k in readings[0]}
