"""End-to-end synthesis: text -> token ids -> mel -> 24 kHz waveform.

The counterpart of the JAX package's `pipeline/synthesize.py::Synthesizer`
(non-streaming paths, one device):
  * host: g2p + blank interspersal, padded to a text bucket;
  * phase 1, duration: text encoder + duration predictor -> mel frames;
  * phase 2, mel: `synthesize_mel` at the (text, mel, prompt) bucket, with
    the 10-step Euler CFM whose attention is kernel 1 on CUDA;
  * phase 3, vocoder: HiFT at the mel bucket, kernel 2 for the C <= 128
    ResBlock stages on CUDA.
The short path is `synthesize_batch_dispatch` (the serving engine's path,
`pipeline/server.py`): staging, one duration pass, then the mel phase and
the vocoder at a power-of-two batch, with the read-back left to the
`finalize` it returns. `synthesize` runs its steps at a batch of one and
`warmup` its mel phase and vocoder on zero inputs. Past the largest mel
bucket, `synthesize` hands the request to `synthesize_long`: the text half
once (`prepare_stream`), then one CFM solve over the whole utterance at a
512-aligned length, where the estimator takes the long-form attention gates
(banded, or kernel 3 for exact attention), then the windowed vocoder.
`synthesize_streaming` runs the same text half, then yields the waveform
chunk by chunk (`pipeline/streaming.py`). `synthesize_long(mesh=...)` and
`warmup_long(mesh=...)` shard the long-form solve over a sequence-parallel
mesh of ranks (`dist/sp.py`). Every request entry, here and in
`pipeline/server.py`, first calls `check_request`.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from jyutvoice_tpu_torch.config import JyutVoiceConfig
from jyutvoice_tpu_torch.models import hift as hift_mod
from jyutvoice_tpu_torch.models import tts as tts_mod
from jyutvoice_tpu_torch.models.cfm import cfm_forward
from jyutvoice_tpu_torch.models.estimator import ATTENTION_MODES
from jyutvoice_tpu_torch.pipeline import buckets as bkt
from jyutvoice_tpu_torch.text import intersperse, text_to_sequence
from jyutvoice_tpu_torch.utils.observability import span
from jyutvoice_tpu_torch.weights.from_jax import load_jax_params
from jyutvoice_tpu_torch.weights.noise import rand_noise, rand_noise_extended


def check_request(cfg: JyutVoiceConfig, spk_embed=None, prompt_feat=None, prompt_h=None):
    """The checks every request entry makes before any work: a speaker
    embedding of shape (spk_embed_dim,), and a cloning prompt given as a
    whole pair of equal-length (T, n_mels) arrays no longer than the largest
    prompt bucket. Returns the pair as float32 arrays, or None without a
    prompt; raises ValueError."""
    dim = cfg.tts.spk_embed_dim
    if spk_embed is not None and np.shape(spk_embed) != (dim,):
        raise ValueError(f"spk_embed must have shape ({dim},); got {np.shape(spk_embed)}")
    if (prompt_feat is None) != (prompt_h is None):
        raise ValueError(
            "mismatched cloning prompt: voice cloning needs BOTH prompt_feat and prompt_h "
            "(PromptExtractor returns the pair); got only one"
        )
    if prompt_feat is None:
        return None
    n_mels = cfg.audio.n_mels
    pf, ph = np.asarray(prompt_feat, np.float32), np.asarray(prompt_h, np.float32)
    if any(a.ndim != 2 or a.shape[1] != n_mels for a in (pf, ph)):
        raise ValueError(
            f"prompt_feat/prompt_h must be (T_p, {n_mels}), the (T, {n_mels}) pair "
            f"PromptExtractor returns; got {pf.shape} / {ph.shape}"
        )
    if len(pf) != len(ph):
        raise ValueError(
            f"mismatched cloning prompt: prompt_feat/prompt_h lengths differ: {len(pf)} vs "
            f"{len(ph)} frames (PromptExtractor returns the aligned pair)"
        )
    cap = bkt.PROMPT_BUCKETS[-1]
    if len(pf) > cap:
        raise ValueError(
            f"cloning prompt is {len(pf)} mel frames, past the largest prompt bucket {cap} "
            f"(~{cap * cfg.audio.hop_length / cfg.audio.sample_rate:.0f} s): trim the "
            "reference audio"
        )
    return pf, ph


class OverLongBatchItems(ValueError):
    """Raised by synthesize_batch_dispatch when some items need more mel
    frames than the bucket table holds. `indices` are those items'
    positions in the list passed, so a server can send only them elsewhere
    and dispatch the rest again."""

    def __init__(self, msg: str, indices):
        super().__init__(msg)
        self.indices = tuple(indices)


class NoiseBufferExceeded(ValueError):
    """Raised by synthesize_batch_dispatch when the batch's prompt bucket +
    mel bucket pass the 15000-frame noise buffer. The mel bucket is the
    longest item's, so this is a property of the group: a server catches
    the type, splits the group and retries."""


def long_frame_granule(n_seq: int) -> int:
    """Mel-frame granule of the one-pass long-form decode: multiples of it
    keep the shape table small and divide by any sequence-mesh size."""
    return math.lcm(32, n_seq) if n_seq > 1 else 32


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one ("cuda" is the current CUDA device)."""
    def index(d):
        return d.index if d.index is not None or d.type != "cuda" else torch.cuda.current_device()

    return a.type == b.type and index(a) == index(b)


def _seq_size(mesh) -> int:
    from jyutvoice_tpu_torch.dist.sp import SEQ_AXIS

    return mesh.axis_size(SEQ_AXIS)


def long_form_shapes(
    y_len: int, prompted: bool, attention: str = "auto", banded_chunk: int = 128,
    n_seq: int = 1,
) -> Tuple[int, int]:
    """(prompt head, mel length) of the long-form solve, which runs at
    t_total = head + mel frames, as the JAX package picks them for a
    sequence mesh of n_seq ranks (1: one device).

    The mel length is y_len rounded up to the frame granule
    (`long_frame_granule(n_seq)`), then past 1536 frames to a multiple of
    lcm(512, n_seq) (512 is the stock-flash block); inside the bucket table
    it is the bucket, except a bucket the mesh cannot split and the
    15000-frame cap, which is not 512-aligned: those keep the aligned
    length. attention="banded" rounds it up to the banded chunk. A prompt
    takes a fixed lcm(512, granule)-frame head."""
    granule = long_frame_granule(n_seq)
    align = 512 if n_seq == 1 else math.lcm(512, n_seq)
    want = -(-max(y_len, 1) // granule) * granule
    if want > 1536:
        want = -(-want // align) * align
    if want <= bkt.MEL_BUCKETS[-1]:
        t_mel = bkt.pick_bucket(want, bkt.MEL_BUCKETS)
        if t_mel % granule or (t_mel % align and t_mel >= 2048):
            t_mel = want
    else:
        t_mel = want
    if attention == "banded":
        t_mel = -(-t_mel // banded_chunk) * banded_chunk
    head = math.lcm(512, granule) if prompted else 0
    return head, t_mel


def to_pcm16(wav: torch.Tensor) -> torch.Tensor:
    """round(clip(wav, -1, 1) * 32767) as int16, on the wav's device."""
    return torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)


def disable_tf32() -> None:
    """Keep f32 convs and matmuls in full f32 on the card. cuDNN would run
    f32 convs in TF32 by default; full f32 keeps parity with the JAX
    package's f32 path. Enabling TF32 is a separate, measured decision."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device` without waiting for the device: a pinned
    copy, sent asynchronously (a blocking copy would synchronize the
    stream)."""
    t = torch.from_numpy(arr)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class _Readback:
    """A device tensor copied to pinned host memory behind a CUDA event, so
    the host waits for that copy only, not for later work on the stream."""

    def __init__(self, x: torch.Tensor):
        if x.device.type == "cuda":
            self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self.host.copy_(x, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(x.device))
        else:
            self.host, self.event = x, None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            with span("wait.readback"):
                self.event.synchronize()
        return self.host.numpy()


@dataclasses.dataclass
class SynthesisResult:
    wav: np.ndarray  # (num_samples,) float32 at 24 kHz (int16 if not dequantized)
    mel: Optional[np.ndarray]  # (T_mel, 80); None when not asked for
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
        self._streams: dict = {}  # (chunk, prompt capacity, steps, masks) -> StreamingSynthesizer
        self._sp: dict = {}  # (mesh, ...) -> the decoder on a mesh, its solvers

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

    def _spk(self, spk_embed: Optional[np.ndarray]) -> torch.Tensor:
        if spk_embed is None:
            return torch.zeros((1, self.cfg.tts.spk_embed_dim), device=self.device)
        return torch.as_tensor(
            np.asarray(spk_embed, np.float32).reshape(1, -1), device=self.device
        )

    def _durations(self, arrs, n, spk: torch.Tensor):
        """Text encoder + duration predictor: (encoder output, ceil(w)).
        arrs and n are host arrays or tensors on the device."""
        x, tone, word_pos, syllable_pos, lang_ids = (
            torch.as_tensor(a, device=self.device) for a in arrs
        )
        x_lengths = torch.as_tensor(n, device=self.device)
        with span("text_half"):
            enc = self.tts.encoder(x, x_lengths, lang_ids, tone, word_pos, syllable_pos, spk)
            logw = self.tts.dp(enc.x, enc.x_mask, spk)
            return enc, torch.ceil(torch.exp(logw) * enc.x_mask)

    @torch.inference_mode()
    def duration_frames_batch(self, arrs, n, spk: torch.Tensor) -> np.ndarray:
        """Phase 1 for every row: the mel frames each text needs at
        length_scale 1, read back to the host (float32, at least 1)."""
        _, w_ceil = self._durations(arrs, n, spk)
        frames = torch.clamp(torch.sum(w_ceil, dim=(1, 2)), min=1.0)
        with span("wait.durations"):
            return frames.cpu().numpy()

    def duration_frames(self, arrs, n, spk: torch.Tensor) -> int:
        """Phase 1: mel frames the text needs at length_scale 1."""
        return int(self.duration_frames_batch(arrs, n, spk)[0])

    @torch.inference_mode()
    def prepare_stream(
        self,
        text: str,
        lang: str = "yue",
        phone: Optional[str] = None,
        spk_embed: Optional[np.ndarray] = None,
        length_scale: float = 1.0,
        prepped=None,
    ):
        """The text half of long-form synthesis: encoder and durations on the
        device, the duration -> frame expansion on the host. Returns
        (mu_y (y_len, 80), c (80,), y_len). prepped= reuses a
        `prepare_text` result.

        Frame j belongs to token i iff cum[i-1] <= j < cum[i] (what
        `generate_path` computes), i.e. np.searchsorted(cum, j, "right"),
        with the cumulative sum in f64 so a fractional length_scale puts the
        boundaries where real arithmetic does."""
        arrs, n, _ = prepped if prepped is not None else self.prepare_text(text, lang, phone)
        spk = self._spk(spk_embed)
        enc, w_ceil = self._durations(arrs, n, spk)
        w_ceil = w_ceil * length_scale
        c = self.tts.spk_embed_affine_layer(tts_mod.l2_normalize(spk, dim=1))
        w_np = w_ceil.float().cpu().numpy()
        mu_np = enc.mu.float().cpu().numpy()
        c_np = c.float().cpu().numpy()
        y_len = int(max(w_np.sum(), 1.0))
        # masked text rows carry w = 0, so the flat cumsum tail claims no frame
        cum = np.cumsum(w_np[0, :, 0], dtype=np.float64)
        idx = np.searchsorted(cum, np.arange(y_len, dtype=np.float64), side="right")
        mu_t = mu_np[0]
        mu_y = np.zeros((y_len, mu_t.shape[1]), np.float32)
        valid = idx < mu_t.shape[0]  # y_len = 1 on empty durations -> zero row
        mu_y[valid] = mu_t[idx[valid]]
        return mu_y, c_np[0], y_len

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
        pcm16: bool = False,
    ) -> SynthesisResult:
        """One request through the steps of `synthesize_batch_dispatch` at a
        batch of one, extending the noise past its buffer, then waited for
        and read back. pcm16=True rounds the waveform to 16 bits on the
        device (read back as int16, returned dequantized)."""
        t0 = time.perf_counter()
        pair = check_request(self.cfg, spk_embed, prompt_feat, prompt_h)
        prepped, texts = self._stage_texts([dict(text=text, lang=lang, phone=phone,
                                                 spk_embed=spk_embed)])
        y_len = int(np.ceil(self.duration_frames_batch(*texts)[0] * length_scale))
        if y_len > bkt.MEL_BUCKETS[-1]:
            # past the bucket table: one pass of the long-form path, reusing
            # this call's g2p
            return self.synthesize_long(
                text, lang=lang, phone=phone, spk_embed=spk_embed,
                prompt_feat=prompt_feat, prompt_h=prompt_h,
                n_timesteps=n_timesteps, length_scale=length_scale, pcm16=pcm16,
                prepped=prepped[0],
            )
        t_mel = bkt.pick_bucket(max(y_len, 1), bkt.MEL_BUCKETS)
        t_prompt = bkt.pick_prompt_bucket(0 if pair is None else len(pair[0]), t_mel)
        prompts = self._stage_prompts([pair], t_prompt)
        t1 = time.perf_counter()
        clock = []
        out, wav = self._enqueue(texts, prompts, t_mel, n_timesteps, length_scale, pcm16,
                                 self._noise(t_prompt + t_mel), clock)
        self._sync()
        t3 = time.perf_counter()
        (res,) = self._read_back(out, wav, 1, return_mel=True)()
        wav_np = res.wav.astype(np.float32) / 32767.0 if pcm16 else res.wav
        return self._timed_result(wav_np, res.mel, res.mel_frames, (t0, t1, clock[0], t3))

    def _timed_result(self, wav, mel, mel_frames: int, clock) -> SynthesisResult:
        """The result of `synthesize` / `synthesize_long`, with its rtf and
        timings from the clock readings at its start, after its text half,
        after its mel phase and after its vocoder."""
        t0, t1, t2, t3 = clock
        audio_seconds = mel_frames * self.cfg.audio.hop_length / self.cfg.audio.sample_rate
        return SynthesisResult(
            wav=wav,
            mel=mel,
            mel_frames=mel_frames,
            rtf=(t3 - t0) / max(audio_seconds, 1e-9),
            timings={
                "frontend_and_duration": t1 - t0,
                "mel": t2 - t1,
                "vocoder": t3 - t2,
                "total": t3 - t0,
                "audio_seconds": audio_seconds,
            },
        )

    def synthesize_streaming(
        self,
        text: str,
        lang: str = "yue",
        phone: Optional[str] = None,
        spk_embed: Optional[np.ndarray] = None,
        prompt_feat: Optional[np.ndarray] = None,
        prompt_h: Optional[np.ndarray] = None,
        chunk_frames: int = 100,
        length_scale: float = 1.0,
        n_timesteps: int = 10,
        estimator_chunk_masks: bool = False,
    ) -> Iterator[np.ndarray]:
        """Generator of 24 kHz waveform chunks (chunk_frames * 480 samples,
        the last one shorter): the text half once, then the CFM decoder and
        the vocoder chunk by chunk with overlap caches, so the first chunk
        comes after one chunk's decode. estimator_chunk_masks=True runs the
        estimator with the 50-frame chunk masks. The prompt is padded to a
        prompt bucket (it right-aligns in it), so one streaming synthesizer
        per (chunk, bucket, steps, masks) serves every prompt length."""
        from jyutvoice_tpu_torch.pipeline.streaming import StreamingSynthesizer

        pair = check_request(self.cfg, spk_embed, prompt_feat, prompt_h)
        mu_y, c, y_len = self.prepare_stream(
            text, lang=lang, phone=phone, spk_embed=spk_embed, length_scale=length_scale,
        )
        prompt_feat, prompt_h = pair or (None, None)
        p_len = 0 if prompt_feat is None else len(prompt_feat)
        p_cap = bkt.pick_bucket(p_len, bkt.PROMPT_BUCKETS[1:]) if p_len else 0
        key = (chunk_frames, p_cap, n_timesteps, estimator_chunk_masks)
        if key not in self._streams:
            self._streams[key] = StreamingSynthesizer(
                self.cfg, self.tts, self.hift, chunk_frames=chunk_frames,
                prompt_frames=p_cap, n_timesteps=n_timesteps,
                estimator_chunk_masks=estimator_chunk_masks, device=self.device,
            )
        total, want = 0, y_len * self.cfg.hift.total_upsample
        for chunk in self._streams[key].stream(mu_y, c, prompt_feat, prompt_h):
            emit = min(len(chunk), want - total)
            if emit <= 0:
                break
            yield chunk[:emit]
            total += emit

    @torch.inference_mode()
    def synthesize_long(
        self,
        text: str,
        lang: str = "yue",
        phone: Optional[str] = None,
        spk_embed: Optional[np.ndarray] = None,
        prompt_feat: Optional[np.ndarray] = None,  # (T_p, 80)
        prompt_h: Optional[np.ndarray] = None,  # (T_p, 80)
        mesh=None,
        n_timesteps: int = 10,
        length_scale: float = 1.0,
        sp_attention: str = "scores",
        attention: str = "auto",
        pcm16: bool = False,
        dequantize: bool = True,
        return_mel: bool = True,
        prepped=None,
    ) -> SynthesisResult:
        """One-pass long-form synthesis past the bucket table, optionally
        sequence-parallel.

        attention (one device): "auto" keeps the configured estimator
        backend (on CUDA: banded past banded_long_threshold, kernel 3 for
        exact attention at 512-aligned T >= 2048 below it); "banded" forces
        the chunk-band at any length; "exact" forces full attention (kernel
        3 where the stock-flash gate admits T).

        mesh (`dist/sp.py::make_sp_mesh`, rank 0 on this synthesizer's
        device): the CFM solve shards the sequence over the mesh's "seq"
        ranks, shapes rounded so that they split (`long_form_shapes`);
        attention must stay "auto" and sp_attention picks the sharded
        attention: "scores" (K/V gathered, per-rank scores (2B, H, T/n, T)),
        "ring" (per-rank tile (2B, H, T/n, T/n)) or "banded" (the chunk band,
        approximate). The text half and the vocoder run on this device.

        Voice cloning: the prompt pair grafts front-aligned into a fixed
        512-frame head (prompt_h into mu, prompt_feat into cond), so the
        mask stays a prefix mask; the generated frames start right after the
        true prompt length and are cut out before vocoding.

        pcm16=True rounds the waveform to int16 on the device;
        dequantize=False returns that int16. return_mel=False skips the mel
        readback; prepped= reuses a `prepare_text` result."""
        t0 = time.perf_counter()
        if attention not in ATTENTION_MODES:
            raise ValueError(
                f"unknown long-form attention {attention!r} "
                "(use 'auto', 'banded' or 'exact')"
            )
        if attention != "auto" and mesh is not None:
            raise ValueError(
                f"attention={attention!r} is the single-device long-form "
                "control; sharded decodes pick sp_attention instead"
            )
        n_seq = 1 if mesh is None else _seq_size(mesh)
        pair = check_request(self.cfg, spk_embed, prompt_feat, prompt_h)
        p_len = 0 if pair is None else len(pair[0])

        mu_y, c, y_len = self.prepare_stream(
            text, lang=lang, phone=phone, spk_embed=spk_embed,
            length_scale=length_scale, prepped=prepped,
        )
        p_head, t_mel = long_form_shapes(
            y_len, pair is not None, attention,
            self.cfg.tts.cfm.estimator.banded_chunk, n_seq,
        )
        t_total = p_head + t_mel
        t1 = time.perf_counter()

        mu = np.zeros((1, t_total, 80), np.float32)
        cond = np.zeros((1, t_total, 80), np.float32)
        if p_len:
            cond[0, :p_len], mu[0, :p_len] = pair  # prompt_feat into cond, prompt_h into mu
        mu[0, p_len : p_len + y_len] = mu_y[:y_len]
        mask = (np.arange(t_total) < p_len + y_len).astype(np.float32)[None, :, None]
        dev = self.device
        args = [torch.from_numpy(a).to(dev) for a in
                (mu, mask, np.asarray(c, np.float32).reshape(1, -1), cond)]
        noise = rand_noise_extended(t_total, device=dev)
        if mesh is None:
            mel = cfm_forward(self.tts.decoder, self.cfg.tts.cfm, *args,
                              n_timesteps=n_timesteps, rand_noise=noise, attention=attention)
        else:
            run, dec = self._long_sp_fn(mesh, n_timesteps, sp_attention)
            mel = run(dec, *args, noise[:, :t_total])
        if p_head:
            mel = mel[:, p_len : p_len + t_mel]
        self._sync()
        t2 = time.perf_counter()

        wav, _ = hift_mod.hift_vocode_auto(self.hift, mel)
        if pcm16:
            wav = to_pcm16(wav)
        wav_np = wav[0, : y_len * self.cfg.audio.hop_length].cpu().numpy()
        mel_np = mel[0, :y_len].float().cpu().numpy() if return_mel else None
        if pcm16 and dequantize:
            wav_np = wav_np.astype(np.float32) / 32767.0
        return self._timed_result(wav_np, mel_np, y_len, (t0, t1, t2, time.perf_counter()))

    def _noise(self, frames: int) -> torch.Tensor:
        """The seed-0 noise buffer, extended deterministically past its
        15000 frames."""
        if frames <= self.noise.shape[1]:
            return self.noise
        return rand_noise_extended(frames, device=self.device)

    def _stage_texts(self, items):
        """The dispatch's first staging: each item's g2p (or its "_prepped"),
        padded to the batch's largest text bucket, and its speaker, sent to
        the device. Returns (the g2p results, (features (5, B, T_text), text
        lengths (B,), speakers (B, spk_embed_dim)))."""
        with span("batch.stage"):
            prepped = [
                it.get("_prepped")
                or self.prepare_text(it["text"], it.get("lang", "yue"), it.get("phone"))
                for it in items
            ]
            b = len(items)
            t_text = max(p[2] for p in prepped)
            feats = np.zeros((5, b, t_text), np.int64)  # x, tone, word_pos, syllable_pos, lang
            x_lengths = np.zeros((b,), np.int64)
            for i, (arrs, n, _) in enumerate(prepped):
                for f, a in enumerate(arrs):
                    feats[f, i, : a.shape[1]] = a[0]
                x_lengths[i] = n[0]
            spk = np.zeros((b, self.cfg.tts.spk_embed_dim), np.float32)
            for i, it in enumerate(items):
                if it.get("spk_embed") is not None:
                    spk[i] = it["spk_embed"]
            return prepped, tuple(_to_device(a, self.device) for a in (feats, x_lengths, spk))

    def _stage_prompts(self, pairs, t_prompt: int):
        """The dispatch's second staging: the checked prompt pairs (None: no
        prompt) padded to t_prompt frames, on the device, and their lengths,
        on the host (read there: no device sync)."""
        with span("batch.stage"):
            prompts = np.zeros((2, len(pairs), t_prompt, 80), np.float32)  # feat, h
            p_lens = np.zeros((len(pairs),), np.int32)
            for i, pair in enumerate(pairs):
                if pair is not None:
                    p_lens[i] = len(pair[0])
                    prompts[:, i, : p_lens[i]] = pair
            return _to_device(prompts, self.device), torch.from_numpy(p_lens)

    def _enqueue(self, texts, prompts, t_mel: int, n_timesteps: int, length_scale: float,
                 pcm16: bool, noise: torch.Tensor, clock=None):
        """The mel phase at the (text, mel, prompt) bucket and the vocoder,
        enqueued on the device: returns (the mel output, the waveform, int16
        with pcm16). With `clock` (a list), the device is waited for after
        the mel phase and the time appended."""
        (x, tone, word_pos, syllable_pos, lang_ids), x_lengths, spk = texts
        prompts_d, p_lens = prompts
        out = tts_mod.synthesize_mel(
            self.tts, x, x_lengths, lang_ids, tone, word_pos, syllable_pos, spk,
            prompts_d[0], prompts_d[1], p_lens,
            t_mel_max=t_mel, n_timesteps=n_timesteps, rand_noise=noise,
            length_scale=length_scale,
        )
        if clock is not None:
            self._sync()
            clock.append(time.perf_counter())
        wav, _ = hift_mod.hift_vocode_auto(self.hift, out.mel)
        if pcm16:
            wav = to_pcm16(wav)
        return out, wav

    def _read_back(self, out, wav, b_real: int, return_mel: bool):
        """Copies of the first b_real rows' mel lengths, waveforms and (with
        return_mel) mels to pinned host memory, enqueued behind CUDA events;
        returns the `finalize` that waits for those copies alone and builds
        the SynthesisResults (rtf nan, no timings)."""
        lens_rb = _Readback(out.mel_lengths[:b_real])
        wav_rb = _Readback(wav[:b_real])
        mel_rb = _Readback(out.mel[:b_real]) if return_mel else None
        hop = self.cfg.audio.hop_length

        def finalize():
            lens, wav_np = lens_rb.numpy(), wav_rb.numpy()
            mel_np = mel_rb.numpy() if return_mel else None
            results = []
            for i in range(b_real):
                frames = int(lens[i])
                results.append(SynthesisResult(
                    wav=wav_np[i, : frames * hop],
                    mel=mel_np[i, :frames] if return_mel else None,
                    mel_frames=frames,
                    rtf=float("nan"),
                    timings={},
                ))
            return results

        return finalize

    @torch.inference_mode()
    def synthesize_batch_dispatch(
        self,
        items,
        n_timesteps: int = 10,
        length_scale: float = 1.0,
        return_mel: bool = True,
        pcm16: bool = False,
    ):
        """Start the short path for a batch of requests; returns a
        zero-argument `finalize` that waits for this batch's results and
        builds the list of SynthesisResult (rtf nan, no timings).

        items: dicts with text / lang / phone and optional spk_embed /
        prompt_feat / prompt_h (and "_prepped", a `prepare_text` result a
        server computed while validating the item). Text, mel and prompt
        lengths are padded to the batch's largest bucket, and the batch to
        the next power of two by repeating item 0, so group sizes map onto
        a few shapes; results drop the padding rows.

        The durations are read back here (they pick the mel bucket): that is
        the one wait for the device. The mel phase, the vocoder and the
        copies of the waveform, the mel lengths and (with return_mel) the
        mel to pinned host memory are only enqueued, behind CUDA events;
        `finalize` waits for those copies alone, so a server can prepare the
        next batch's texts before reading this one back. The next batch's
        own duration read-back then waits, on the same stream, for this
        batch's mel phase and vocoder: the device work of two batches does
        not overlap. pcm16=True rounds the waveform to int16 on the device
        and returns it as int16.

        Raises ValueError naming the first item that fails `check_request`,
        OverLongBatchItems for items past the 15000-frame bucket (with
        their indices) and NoiseBufferExceeded when prompt + mel buckets
        pass the noise buffer."""
        b_real = len(items)
        if b_real == 0:
            return lambda: []
        pairs = []
        for i, it in enumerate(items):
            try:
                pairs.append(check_request(self.cfg, it.get("spk_embed"),
                                           it.get("prompt_feat"), it.get("prompt_h")))
            except ValueError as e:
                raise ValueError(f"item {i}: {e}") from e
        b_pad = 1 << (b_real - 1).bit_length()  # the next power of two
        items = list(items) + [items[0]] * (b_pad - b_real)
        pairs += [pairs[0]] * (b_pad - b_real)
        _, texts = self._stage_texts(items)

        y_lens = self.duration_frames_batch(*texts)
        y_max = int(np.ceil(y_lens.max() * length_scale))
        if y_max > bkt.MEL_BUCKETS[-1]:
            # padding rows copy row 0, so the real rows name every culprit
            need = np.ceil(y_lens[:b_real] * length_scale)
            raise OverLongBatchItems(
                f"an item needs {y_max} mel frames, past the {bkt.MEL_BUCKETS[-1]}-frame "
                "batch table: synthesize it alone (synthesize / synthesize_long have no "
                "cap)",
                [i for i in range(b_real) if need[i] > bkt.MEL_BUCKETS[-1]],
            )
        t_mel = bkt.pick_bucket(max(y_max, 1), bkt.MEL_BUCKETS)
        p_max = max(0 if pair is None else len(pair[0]) for pair in pairs)
        t_prompt = bkt.pick_prompt_bucket(p_max, t_mel)
        if t_prompt + t_mel > self.noise.shape[1]:
            raise NoiseBufferExceeded(
                f"prompt ({t_prompt}) + mel ({t_mel}) frames exceed the "
                f"{self.noise.shape[1]}-frame noise buffer; synthesize such items alone "
                "(synthesize / synthesize_long extend the noise)"
            )
        prompts = self._stage_prompts(pairs, t_prompt)
        out, wav = self._enqueue(texts, prompts, t_mel, n_timesteps, length_scale, pcm16,
                                 self.noise)
        return self._read_back(out, wav, b_real, return_mel)

    def synthesize_batch(
        self,
        items,
        n_timesteps: int = 10,
        length_scale: float = 1.0,
        return_mel: bool = True,
        pcm16: bool = False,
    ):
        """Batched synthesis; see synthesize_batch_dispatch."""
        return self.synthesize_batch_dispatch(
            items, n_timesteps=n_timesteps, length_scale=length_scale,
            return_mel=return_mel, pcm16=pcm16,
        )()

    @torch.inference_mode()
    def warmup(
        self,
        text_buckets=None,
        mel_buckets=None,
        prompt_buckets=(0,),
        n_timesteps=(10,),
        batch_sizes=(1,),
        pcm16: bool = False,
        log_fn=None,
    ) -> int:
        """Drive each (batch, text, mel, prompt, steps) shape of the serving
        path once before traffic arrives, through the dispatch's own steps on
        zero inputs: the duration pass at each (batch, text bucket), the mel
        phase and the vocoder at each combination. In eager PyTorch this
        builds the CUDA kernels at their first use and warms cuDNN's
        algorithm choice and the caching allocator at those shapes. It
        compiles nothing and captures no CUDA graph: later requests still
        launch op by op.

        batch_sizes follows the engine's power-of-two padding ((1, 2, 4, 8)
        covers max_batch=8). Defaults: text buckets <= 128, mel buckets <=
        1024, no prompt. Returns the count the JAX package's warmup returns
        for the same arguments: 1 per duration shape, 2 per mel + vocoder
        shape, and 1 more per shape at batch 1, where the JAX package also
        compiles the single-request graph; here a single request runs the
        same code as a batch of one, which this warms."""
        tb = tuple(text_buckets) if text_buckets else bkt.TEXT_BUCKETS[:4]
        mb = tuple(mel_buckets) if mel_buckets else bkt.MEL_BUCKETS[:6]
        dev, count = self.device, 0
        for b in sorted({int(v) for v in batch_sizes}):
            spk = torch.zeros((b, self.cfg.tts.spk_embed_dim), device=dev)
            ones = torch.ones((b,), dtype=torch.int64, device=dev)
            for t_text in tb:
                texts = ((torch.zeros((b, t_text), dtype=torch.int64, device=dev),) * 5,
                         ones, spk)
                self.duration_frames_batch(*texts)
                count += 1
                for t_mel in mb:
                    for t_prompt in prompt_buckets:
                        prompts = (torch.zeros((2, b, t_prompt, 80), device=dev),
                                   torch.zeros((b,), dtype=torch.int32))
                        noise = self._noise(t_prompt + t_mel)
                        for steps in n_timesteps:
                            if log_fn:
                                log_fn(f"warmup b={b} {(t_text, t_mel, t_prompt, int(steps))}")
                            self._enqueue(texts, prompts, t_mel, int(steps), 1.0, pcm16, noise)
                            count += 3 if b == 1 else 2
        self._sync()
        return count

    def _long_sp_fn(self, mesh, n_timesteps: int, sp_attention: str):
        """The sequence-parallel long-form solve on `mesh`, cached per (mesh,
        steps, attention), and the decoder on the mesh, placed once per mesh
        (shared by every step count and attention mode)."""
        from jyutvoice_tpu_torch.dist.sp import shard_params, sp_cfm_solve

        if not _same_device(mesh.device, self.device):
            raise ValueError(
                f"the mesh's rank 0 runs on {mesh.device}, this synthesizer on "
                f"{self.device}: make the mesh with this device first"
            )
        dec_key = ("long_sp_dec", mesh)
        if dec_key not in self._sp:
            self._sp[dec_key] = shard_params(self.tts.decoder, mesh)
        key = ("long_sp", mesh, n_timesteps, sp_attention)
        if key not in self._sp:
            self._sp[key] = sp_cfm_solve(self.tts.decoder, self.cfg.tts.cfm, mesh,
                                         n_timesteps=n_timesteps, attention=sp_attention)
        return self._sp[key], self._sp[dec_key]

    @torch.inference_mode()
    def warmup_long(
        self,
        # the long-form shape table synthesize_long picks: every 512-aligned
        # mel length >= 2048 up to the 12288 bucket
        mel_sizes=(2048, 3072, 4096, 6144, 8192, 12288),
        text_buckets=(1024, 2048, 4096, 8192),
        n_timesteps=(10,),
        pcm16: bool = False,
        log_fn=None,
        mesh=None,
        sp_attention: str = "scores",
        with_prompt: bool = False,
        attention: str = "auto",
    ) -> int:
        """Drive the long-form path (`synthesize_long`) once at each shape
        before traffic arrives, on zero inputs: the text half that
        `prepare_stream` runs at each text bucket, then for each mel size
        and step count the CFM solve at t_total = head + t_mel under the
        same `attention` routing (banded, kernel 3 or kernel 1 as
        `attention_route` picks for that length), the strip of the prompt
        head and the vocoder at t_mel (windowed past its threshold). In
        eager PyTorch this builds the CUDA kernels at their first use and
        warms cuDNN's algorithm choice and the caching allocator at those
        shapes; it compiles and captures nothing.

        mel_sizes are the t_mel that `long_form_shapes` picks (multiples of
        512 past 1536). with_prompt=True also warms the cloning shapes: the
        solve with the 512-frame prompt head. attention must be the
        engine's long_attention, or the served requests take routes that
        were not warmed. With mesh / sp_attention the solves warmed are the
        sequence-parallel ones that synthesize_long(mesh=...) runs (the
        decoder is placed on the mesh here); mel sizes the mesh's shape
        table never picks are refused before any work. Returns the JAX
        package's count: 1 per text bucket, 1 per (mel job, steps)."""
        if attention not in ATTENTION_MODES:
            raise ValueError(
                f"unknown long-form attention {attention!r} "
                "(use 'auto', 'banded' or 'exact')"
            )
        n_seq = 1 if mesh is None else _seq_size(mesh)
        if mesh is not None:
            granule = long_frame_granule(n_seq)
            align = math.lcm(512, n_seq)
            bad = [t for t in mel_sizes if t % granule or (t > 1536 and t % align)]
            if bad:
                raise ValueError(
                    f"mel_sizes {bad} not divisible by the mesh's frame "
                    f"granule ({granule}; 512-aligned past 1536) — "
                    f"synthesize_long(mesh=...) would never pick them"
                )
        dev, count = self.device, 0
        spk = torch.zeros((1, self.cfg.tts.spk_embed_dim), device=dev)
        ones = torch.ones((1,), dtype=torch.int64, device=dev)
        for t_text in text_buckets:
            x = torch.zeros((1, t_text), dtype=torch.int64, device=dev)
            self._durations([x] * 5, ones, spk)
            self.tts.spk_embed_affine_layer(tts_mod.l2_normalize(spk, dim=1))
            count += 1
            if log_fn:
                log_fn(f"warmup_long: text bucket {t_text} ready")
        p_head = math.lcm(512, long_frame_granule(n_seq)) if with_prompt else 0
        spks = torch.zeros((1, 80), device=dev)
        for t_mel in mel_sizes:
            for t_total, head in [(t_mel, 0)] + ([(p_head + t_mel, p_head)] if p_head else []):
                mu = torch.zeros((1, t_total, 80), device=dev)
                mask = torch.ones((1, t_total, 1), device=dev)
                cond = torch.zeros_like(mu)
                noise = rand_noise_extended(t_total, device=dev)
                for steps in n_timesteps:
                    if mesh is None:
                        mel = cfm_forward(
                            self.tts.decoder, self.cfg.tts.cfm, mu, mask, spks, cond,
                            n_timesteps=int(steps), rand_noise=noise, attention=attention,
                        )
                    else:
                        run, dec = self._long_sp_fn(mesh, int(steps), sp_attention)
                        mel = run(dec, mu, mask, spks, cond, noise[:, :t_total])
                    if head:
                        mel = mel[:, head : head + t_mel]
                    wav, _ = hift_mod.hift_vocode_auto(self.hift, mel)
                    if pcm16:
                        to_pcm16(wav)
                    count += 1
                    if log_fn:
                        log_fn(f"warmup_long: mel {t_mel}" + (f" +prompt{head}" if head else "")
                               + f" x {steps} steps ready")
        self._sync()
        return count
