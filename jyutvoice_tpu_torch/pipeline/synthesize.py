"""End-to-end synthesis: text -> token ids -> mel -> 24 kHz waveform.

The counterpart of the JAX package's `pipeline/synthesize.py::Synthesizer`
(non-streaming path):
  * host: g2p + blank interspersal, padded to a text bucket;
  * phase 1, duration: text encoder + duration predictor -> mel frames;
  * phase 2, mel: `synthesize_mel` at the (text, mel, prompt) bucket, with
    the 10-step Euler CFM whose attention is kernel 1 on CUDA;
  * phase 3, vocoder: HiFT at the mel bucket, kernel 2 for the C <= 128
    ResBlock stages on CUDA.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from jyutvoice_tpu_torch.config import JyutVoiceConfig
from jyutvoice_tpu_torch.models import hift as hift_mod
from jyutvoice_tpu_torch.models import tts as tts_mod
from jyutvoice_tpu_torch.pipeline import buckets as bkt
from jyutvoice_tpu_torch.text import intersperse, text_to_sequence
from jyutvoice_tpu_torch.weights.from_jax import load_jax_params
from jyutvoice_tpu_torch.weights.noise import rand_noise, rand_noise_extended


def disable_tf32() -> None:
    """Keep f32 convs and matmuls in full f32 on the card. cuDNN would run
    f32 convs in TF32 by default; full f32 keeps parity with the JAX
    package's f32 path. Enabling TF32 is a separate, measured decision."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@dataclasses.dataclass
class SynthesisResult:
    wav: np.ndarray  # (num_samples,) float32 at 24 kHz
    mel: np.ndarray  # (T_mel, 80)
    mel_frames: int
    rtf: float  # wall-clock real-time factor
    timings: Dict[str, float]


class Synthesizer:
    """Holds the models on one device.

    params_tts / params_hift are the JAX package's parameter trees (from
    `init_tts` / `init_hift`, `load_pytree_npz`, or this package's
    `weights/random_init.py`), loaded through `weights/from_jax.py`.
    """

    def __init__(self, cfg: JyutVoiceConfig, params_tts, params_hift, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda":
            disable_tf32()
        self.tts = load_jax_params(tts_mod.TTS(cfg.tts), params_tts).to(self.device).eval()
        self.hift = load_jax_params(hift_mod.HiFT(cfg.hift), params_hift).to(self.device).eval()
        self.noise = rand_noise(device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prepare_text(self, text: str, lang: str, phone: Optional[str] = None):
        """g2p + blank interspersal -> padded int arrays (1, T_bucket)."""
        ids, tones, word_pos, syllable_pos, lang_ids = text_to_sequence(
            text, lang=lang, phone=phone
        )
        seqs = [intersperse(s, 0) for s in (ids, tones, word_pos, syllable_pos, lang_ids)]
        n = len(seqs[0])
        t_text = bkt.pick_bucket(n, bkt.TEXT_BUCKETS)
        arrs = []
        for s in seqs:
            a = np.zeros((1, t_text), np.int64)
            a[0, :n] = s
            arrs.append(a)
        return arrs, np.array([n], np.int64), t_text

    @torch.inference_mode()
    def duration_frames(self, arrs, n, spk: torch.Tensor) -> int:
        """Phase 1: mel frames the text needs at length_scale 1."""
        x, tone, word_pos, syllable_pos, lang_ids = (
            torch.from_numpy(a).to(self.device) for a in arrs
        )
        x_lengths = torch.from_numpy(n).to(self.device)
        enc = self.tts.encoder(x, x_lengths, lang_ids, tone, word_pos, syllable_pos, spk)
        logw = self.tts.dp(enc.x, enc.x_mask, spk)
        w_ceil = torch.ceil(torch.exp(logw) * enc.x_mask)
        return int(torch.clamp(torch.sum(w_ceil, dim=(1, 2)), min=1.0)[0])

    @torch.inference_mode()
    def synthesize(
        self,
        text: str,
        lang: str = "yue",
        phone: Optional[str] = None,
        spk_embed: Optional[np.ndarray] = None,
        prompt_feat: Optional[np.ndarray] = None,  # (T_p, 80)
        prompt_h: Optional[np.ndarray] = None,  # (T_p, 80)
        n_timesteps: int = 10,
        length_scale: float = 1.0,
    ) -> SynthesisResult:
        t0 = time.perf_counter()
        arrs, n, t_text = self.prepare_text(text, lang, phone)
        if spk_embed is None:
            spk = torch.zeros((1, self.cfg.tts.spk_embed_dim), device=self.device)
        else:
            spk = torch.as_tensor(
                np.asarray(spk_embed, np.float32).reshape(1, -1), device=self.device
            )

        # phase 1: required mel frames
        y_len = int(np.ceil(self.duration_frames(arrs, n, spk) * length_scale))
        if (prompt_feat is None) != (prompt_h is None):
            raise ValueError(
                "voice cloning needs BOTH prompt_feat and prompt_h; got only one"
            )
        if y_len > bkt.MEL_BUCKETS[-1]:
            raise NotImplementedError(
                f"{y_len} mel frames exceed the largest bucket "
                f"({bkt.MEL_BUCKETS[-1]}); long-form synthesis (synthesize_long) "
                "belongs to the long-form slice of the port, not yet ported"
            )
        t_mel = bkt.pick_bucket(max(y_len, 1), bkt.MEL_BUCKETS)

        if prompt_feat is not None:
            p_len = prompt_feat.shape[0]
            t_prompt = bkt.pick_prompt_bucket(p_len, t_mel)
            pf = np.zeros((1, t_prompt, 80), np.float32)
            ph = np.zeros((1, t_prompt, 80), np.float32)
            pf[0, :p_len] = prompt_feat
            ph[0, :p_len] = prompt_h
        else:
            p_len, t_prompt = 0, 0
            pf = ph = np.zeros((1, 0, 80), np.float32)

        noise = self.noise
        if t_prompt + t_mel > noise.shape[1]:
            # past the 15000-frame buffer: extend deterministically
            noise = rand_noise_extended(t_prompt + t_mel, device=self.device)
        x, tone, word_pos, syllable_pos, lang_ids = (
            torch.from_numpy(a).to(self.device) for a in arrs
        )
        t1 = time.perf_counter()

        out = tts_mod.synthesize_mel(
            self.tts, x, torch.from_numpy(n).to(self.device), lang_ids, tone,
            word_pos, syllable_pos, spk,
            torch.from_numpy(pf).to(self.device), torch.from_numpy(ph).to(self.device),
            torch.tensor([p_len], dtype=torch.int32),
            t_mel_max=t_mel, n_timesteps=n_timesteps, rand_noise=noise,
            length_scale=length_scale,
        )
        mel_frames = int(out.mel_lengths[0])
        self._sync()
        t2 = time.perf_counter()

        wav, _ = hift_mod.hift_vocode_auto(self.hift, out.mel)
        self._sync()
        t3 = time.perf_counter()

        num_samples = mel_frames * self.cfg.audio.hop_length
        wav_np = wav[0, :num_samples].float().cpu().numpy()
        mel_np = out.mel[0, :mel_frames].float().cpu().numpy()
        elapsed = t3 - t0
        audio_seconds = num_samples / self.cfg.audio.sample_rate
        return SynthesisResult(
            wav=wav_np,
            mel=mel_np,
            mel_frames=mel_frames,
            rtf=elapsed / max(audio_seconds, 1e-9),
            timings={
                "frontend_and_duration": t1 - t0,
                "mel": t2 - t1,
                "vocoder": t3 - t2,
                "total": elapsed,
                "audio_seconds": audio_seconds,
            },
        )
