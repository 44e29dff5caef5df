"""Streaming (chunked) synthesis.

The counterpart of the JAX package's `pipeline/streaming.py`: the CFM
decoder and the vocoder run over fixed-size mel chunks with

  * the 34-frame z/mu overlap cache and the prompt cache (the reference's
    ConditionalCFM.forward),
  * optional chunk-causal attention masks inside the estimator
    (static_chunk_size 50),
  * a hann crossfade between consecutive mel chunks (fade_in_out),
  * the HiFT sine-source cache across waveform chunk boundaries.

Every chunk has the same shapes: a segment of [prompt capacity | OVERLAP
re-generated | chunk fresh] frames, masked to its valid rows. The per-chunk
core runs eagerly, so the emit plan (ov, n_new, l_emit) is host ints and
slices replace the JAX package's traced dynamic slices. The carries (the
held frames, the vocoder's mel tail, the HiFT source cache) stay on the
device; a chunk's inputs go over in one pinned, asynchronous copy (the
multi-session lane adds one of its speaker rows), its waveform comes back
in one copy, and nothing in the core waits for the device. On CUDA tensors the estimator's attention is
kernel 1 (`nn/flash_attention.py`) and the vocoder's ResBlock stages are
kernel 2 (`nn/resblock_stage.py`); a prompted graph's front-padded mask
takes "xla_scores" ("plain" attention with the mask as a bias), as the
JAX package's does.

`StreamingTokenEncoder` is the KV-cached flow encoder behind a push/flush
interface (`models/flow_encoder.py::apply_flow_encoder_chunk`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from jyutvoice_tpu_torch.config import FlowEncoderConfig, JyutVoiceConfig, require_unet
from jyutvoice_tpu_torch.models import hift as hift_mod
from jyutvoice_tpu_torch.models import tts as tts_mod
from jyutvoice_tpu_torch.models.cfm import cosine_t_span, solve_euler_cfg
from jyutvoice_tpu_torch.models.estimator import with_attention_backend
from jyutvoice_tpu_torch.models.flow_encoder import (
    FlowEncoder,
    apply_flow_encoder_chunk,
    init_stream_state,
)
from jyutvoice_tpu_torch.pipeline.synthesize import (
    _Readback,
    _to_device,
    disable_tf32,
    to_pcm16,
)
from jyutvoice_tpu_torch.weights.from_jax import load_jax_params
from jyutvoice_tpu_torch.weights.noise import rand_noise_extended

Tensor = torch.Tensor

OVERLAP = 34  # frames carried between chunks (the reference's flow_matching.py:203)


class StreamingTokenEncoder:
    """Incremental speech tokens -> prompt hidden states over KV caches.

    Tokens arrive in pieces of any size; a whole chunk is encoded as soon as
    its lookahead context (the next chunk's first pre_lookahead_len tokens)
    has arrived, each step costing O(chunk * T_max). `model` is a loaded
    `FlowEncoder`; the caches live on its device."""

    def __init__(self, model: FlowEncoder, t_max_tokens: int, chunk_tokens: int = 0):
        self.model = model
        self.cfg: FlowEncoderConfig = model.cfg
        self.device = next(model.parameters()).device
        self.chunk = chunk_tokens or self.cfg.static_chunk_size
        # the capacity is a chunk multiple (see init_stream_state)
        self.t_max = -(-t_max_tokens // self.chunk) * self.chunk
        self.reset()

    def reset(self) -> None:
        """Start a new stream."""
        self.state = init_stream_state(self.cfg, self.t_max, chunk=self.chunk,
                                       device=self.device)
        self._buf: List[int] = []  # pending tokens not yet encoded
        self._consumed = 0
        self._final = False  # set by flush() or a partial-chunk encode

    @torch.inference_mode()
    def _encode(self, toks: Sequence[int], ctx: Sequence[int]) -> np.ndarray:
        n = len(toks)
        if self._final:
            # after a partial chunk the cache offset is off the chunk grid
            # and the conv caches hold end-of-stream padding
            raise ValueError(
                "stream already finalized by a partial-chunk flush(); "
                "reset() before encoding a new stream"
            )
        if self._consumed + n > self.t_max:
            raise ValueError(
                f"stream exceeds capacity: {self._consumed + n} tokens > "
                f"t_max={self.t_max}; construct StreamingTokenEncoder with a "
                "larger t_max_tokens (or reset() between prompts)"
            )
        pre = self.cfg.pre_lookahead_len
        buf = np.zeros((2, max(self.chunk, pre)), np.int64)  # one copy: chunk, context
        buf[0, :n] = toks
        buf[1, : len(ctx)] = ctx
        dev = torch.from_numpy(buf).to(self.device)
        h, self.state = apply_flow_encoder_chunk(
            self.model, dev[0:1, : self.chunk], n, dev[1:2, :pre], len(ctx), self.state
        )
        self._consumed += n
        if n < self.chunk:
            self._final = True
        return h[0, : n * self.cfg.upsample_stride].float().cpu().numpy()

    def push(self, tokens) -> np.ndarray:
        """Feed new tokens; returns the newly available hidden frames
        ((n * stride, 80), possibly empty)."""
        self._buf.extend(int(t) for t in np.asarray(tokens).reshape(-1))
        pre = self.cfg.pre_lookahead_len
        outs = []
        while len(self._buf) >= self.chunk + pre:
            outs.append(self._encode(self._buf[: self.chunk],
                                     self._buf[self.chunk : self.chunk + pre]))
            self._buf = self._buf[self.chunk :]
        if outs:
            return np.concatenate(outs, axis=0)
        return np.zeros((0, self.cfg.proj_size), np.float32)

    def flush(self) -> np.ndarray:
        """End of stream: encode the remaining tokens, with zero lookahead at
        the true end."""
        outs = []
        while self._buf:
            n = min(self.chunk, len(self._buf))
            outs.append(self._encode(self._buf[:n],
                                     self._buf[n : n + self.cfg.pre_lookahead_len]))
            self._buf = self._buf[n:]
        # a chunk-aligned tail is encoded with zero lookahead too, so a later
        # push() would contradict frames already emitted
        self._final = True
        if outs:
            return np.concatenate(outs, axis=0)
        return np.zeros((0, self.cfg.proj_size), np.float32)


def hann_crossfade_window(overlap: int) -> np.ndarray:
    """(2 * overlap,) hann window; the first half fades in, the second out."""
    n = 2 * overlap
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / (n - 1)))).astype(np.float32)


def _init_session(
    p: int, mu_y: np.ndarray, prompt_feat: Optional[np.ndarray],
    prompt_h: Optional[np.ndarray],
) -> dict:
    """Host state of one streaming session, shared by
    `StreamingSynthesizer.stream` and `MultiStreamSynthesizer.open`.

    p is the prompt capacity; a shorter prompt right-aligns against the
    generated frames (rows [p - p_valid, p)) and rows [0, p_start) are
    masked, so one graph serves every prompt length up to p, none included.
    Noise is the seed-0 buffer indexed by absolute frame position (prompt,
    then mel), as in the non-streaming path, extended past 15000 frames."""
    t_total = mu_y.shape[0]
    if prompt_feat is not None and not p:
        raise ValueError(
            "a cloning prompt was passed but this streaming graph was "
            "compiled without prompt capacity — rebuild with "
            "prompt_frames>0"
        )
    if p and prompt_feat is not None:
        if prompt_h is None:
            raise ValueError("a cloning prompt needs prompt_h with prompt_feat")
        p_valid = prompt_feat.shape[0]
        if p_valid > p:
            raise ValueError(
                f"cloning prompt is {p_valid} frames but this streaming "
                f"graph was compiled with prompt capacity {p} — trim the "
                f"prompt or rebuild with prompt_frames>={p_valid}"
            )
    else:
        p_valid = 0
    p_start = p - p_valid
    noise_full = rand_noise_extended(p_valid + t_total)[0].numpy()  # (p_valid + T, 80)
    # the z/mu overlap cache, assembled into each segment on the host
    z_cache = np.zeros((p + OVERLAP, 80), np.float32)
    mu_cache = np.zeros((p + OVERLAP, 80), np.float32)
    if p_valid:
        z_cache[p_start:p] = noise_full[:p_valid]
        mu_cache[p_start:p] = prompt_h[:p_valid]
    return {
        "mu_y": np.asarray(mu_y, np.float32),
        "noise": noise_full,
        "z_cache": z_cache,
        "mu_cache": mu_cache,
        "prompt_feat": prompt_feat,
        "p_valid": p_valid,
        "p_start": p_start,
        "pos": 0,
        "has_held": False,
    }


@dataclasses.dataclass
class _Plan:
    """One session's share of one dispatch: the emit plan of the chunk."""

    n_new: int  # fresh frames in the segment
    ov: int  # re-generated overlap frames (0 or OVERLAP)
    n_valid: int  # valid rows end here; they start at p_start
    l_emit: int  # frames emitted (crossfaded) by this chunk
    next_held: bool  # the last OVERLAP frames are held for the next chunk
    is_last: bool


def _fill_segment(st: dict, p: int, chunk: int, mu_row, z_row, cond_row) -> _Plan:
    """Assemble one chunk's (seg, 80) mu / z / cond rows from a session's
    state and decide its emit plan. Layout: [prompt capacity p | OVERLAP
    re-generated | chunk fresh]; fresh frames draw noise at their absolute
    position."""
    t_total = st["mu_y"].shape[0]
    pos = st["pos"]
    n_new = min(chunk, t_total - pos)
    ov = OVERLAP if st["has_held"] else 0
    p_valid, p_start = st["p_valid"], st["p_start"]
    if p_valid:
        mu_row[p_start:p] = st["mu_cache"][p_start:p]
        z_row[p_start:p] = st["z_cache"][p_start:p]
        cond_row[p_start:p] = st["prompt_feat"][:p_valid]
    if ov:
        # re-generate positions [pos - OVERLAP, pos) from the cached z/mu;
        # the core crossfades them against the held copy
        mu_row[p : p + ov] = st["mu_cache"][p:]
        z_row[p : p + ov] = st["z_cache"][p:]
    mu_row[p + ov : p + ov + n_new] = st["mu_y"][pos : pos + n_new]
    z_row[p + ov : p + ov + n_new] = st["noise"][p_valid + pos : p_valid + pos + n_new]
    n_valid = p + ov + n_new
    is_last = pos + n_new >= t_total
    if is_last or ov + n_new <= OVERLAP:
        l_emit, next_held = ov + n_new, False
    else:
        l_emit, next_held = ov + n_new - OVERLAP, True
    return _Plan(n_new, ov, n_valid, l_emit, next_held, is_last)


def _advance_session(st: dict, p: int, mu_row, z_row, plan: _Plan) -> None:
    """After a dispatch: cache the segment's last OVERLAP valid frames of
    z / mu for the next chunk's re-generation, and advance the position."""
    tail_lo = max(plan.n_valid - OVERLAP, 0)
    st["z_cache"][p:] = z_row[tail_lo : tail_lo + OVERLAP]
    st["mu_cache"][p:] = mu_row[tail_lo : tail_lo + OVERLAP]
    st["pos"] += plan.n_new
    st["has_held"] = plan.next_held


def _as_module(tree_or_module, cls, cfg, device: torch.device) -> nn.Module:
    if isinstance(tree_or_module, cls):
        return tree_or_module
    return load_jax_params(cls(cfg), tree_or_module).to(device).eval()


class StreamingSynthesizer:
    """Chunked mel decoding and vocoding over a precomputed prior `mu_y`.

    The text half (encoder, durations, expansion: `Synthesizer.
    prepare_stream`) runs once up front; chunking applies to the CFM
    decoder and the vocoder. params_tts / params_hift are the JAX package's
    parameter trees or this package's loaded `TTS` / `HiFT` modules (then
    shared, as `Synthesizer.synthesize_streaming` does)."""

    def __init__(
        self,
        cfg: JyutVoiceConfig,
        params_tts,
        params_hift,
        chunk_frames: int = 100,  # 2 s of mel (a multiple of the chunk mask)
        prompt_frames: int = 0,
        n_timesteps: int = 10,
        estimator_chunk_masks: bool = False,
        pcm16: bool = False,
        device="cuda",
    ):
        require_unet(cfg.tts.cfm, "streaming synthesis")
        if chunk_frames <= OVERLAP:
            # every chunk would take the emit-everything branch and the
            # crossfade would never run (seams at every chunk boundary)
            raise ValueError(
                f"chunk_frames={chunk_frames} must exceed the crossfade "
                f"overlap ({OVERLAP} frames)"
            )
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda":
            disable_tf32()
        self.tts = _as_module(params_tts, tts_mod.TTS, cfg.tts, self.device)
        self.hift = _as_module(params_hift, hift_mod.HiFT, cfg.hift, self.device)
        self.chunk = chunk_frames
        self.p_len = prompt_frames
        self.n_timesteps = n_timesteps
        # on-device int16 before the read-back; stream() then yields int16
        self.pcm16 = pcm16
        # the reference's chunked path runs the estimator with full attention
        # within each segment; True selects the 50-frame chunk masks instead
        self.est_masks = estimator_chunk_masks
        # vocoder samples per mel frame: all chunk slicing keys off it
        self.spf = cfg.hift.total_upsample
        self.seg = prompt_frames + OVERLAP + chunk_frames
        self.cap = OVERLAP + chunk_frames  # the most regenerated + fresh frames
        self.estimator = self.tts.decoder
        if prompt_frames > 0:
            # a partly filled prompt bucket masks rows [0, p_start): kernel 1
            # takes each row's validity as a length and would mis-mask it, so
            # the bias path builds the mask from the pattern itself
            self.estimator = with_attention_backend(self.tts.decoder, "xla_scores")
        win = hann_crossfade_window(OVERLAP)[:, None]
        self._fade_in = torch.from_numpy(win[:OVERLAP]).to(self.device)
        self._fade_out = torch.from_numpy(win[OVERLAP:]).to(self.device)
        self._t_span = cosine_t_span(n_timesteps, device=self.device)

    def zero_carries(self, s: int) -> Tuple[Tensor, Tensor, Tensor]:
        """(held, vocoder mel tail, HiFT source cache) for s sessions."""
        kw = dict(dtype=torch.float32, device=self.device)
        return (torch.zeros((s, OVERLAP, 80), **kw), torch.zeros((s, OVERLAP, 80), **kw),
                torch.zeros((s, OVERLAP * self.spf, 1), **kw))

    def host_inputs(self, s: int) -> np.ndarray:
        """The host buffer of one dispatch: (4, s, seg, 80) = z, mu, cond and
        the mask (in channel 0), filled by `fill`."""
        return np.zeros((4, s, self.seg, 80), np.float32)

    def fill(self, buf: np.ndarray, row: int, st: dict) -> _Plan:
        """Fill one row of a dispatch's host buffer from a session."""
        z, mu, cond, mask = buf
        plan = _fill_segment(st, self.p_len, self.chunk, mu[row], z[row], cond[row])
        mask[row, st["p_start"] : plan.n_valid, 0] = 1.0
        return plan

    @torch.inference_mode()
    def core(
        self, buf: np.ndarray, spk: Tensor, plans: Dict[int, _Plan], held: Tensor,
        voc_tail: Tensor, src: Tensor,
    ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
        """One chunk of every row: the masked CFG solve, the crossfade of the
        re-generated overlap against `held`, the vocoder over [mel tail |
        emitted frames | zeros] with the source cache, the new carries.

        buf: the host inputs (`host_inputs`); spk (S, 80) on the device;
        plans: row -> its emit plan (rows without one ride along masked and
        keep their carries); held / voc_tail (S, OVERLAP, 80) and src
        (S, OVERLAP * spf, 1): the carries, updated in place. Returns (wav
        (S, cap * spf), float32 or int16 with pcm16, mel out (S, cap, 80),
        held, voc_tail, src)."""
        p, spf = self.p_len, self.spf
        x = _to_device(buf, self.device)
        z, mu, cond, mask = x[0], x[1], x[2], x[3, :, :, :1]
        mel = solve_euler_cfg(
            self.estimator, self.cfg.tts.cfm, z * mask, self._t_span, mu * mask, mask, spk,
            cond, streaming=self.est_masks,
        )  # (S, seg, 80)
        out = mel[:, p:]  # (S, cap, 80); rows [0, ov + n_new) are valid
        s = out.shape[0]
        voc_in = torch.zeros((s, OVERLAP + self.cap, 80), dtype=out.dtype, device=out.device)
        voc_in[:, :OVERLAP] = voc_tail
        for i, pl in plans.items():
            assert 0 <= pl.l_emit <= pl.ov + pl.n_new <= self.cap, pl
            if pl.ov:
                # crossfade the re-generated frames with the held versions of
                # the same positions (the reference's fade_in_out)
                out[i, :OVERLAP] = out[i, :OVERLAP] * self._fade_in + held[i] * self._fade_out
            lo = max(pl.ov + pl.n_new - OVERLAP, 0)
            held[i] = out[i, lo : lo + OVERLAP]
            voc_in[i, OVERLAP : OVERLAP + pl.l_emit] = out[i, : pl.l_emit]
        wav, source = hift_mod.hift_inference(self.hift, voc_in, cache_source=src)
        for i, pl in plans.items():
            if pl.l_emit > 0:
                # the next chunk's mel context: the last OVERLAP rows of
                # [tail | emitted], and the source under them
                voc_tail[i] = voc_in[i, pl.l_emit : pl.l_emit + OVERLAP]
                src[i] = source[i, pl.l_emit * spf : (pl.l_emit + OVERLAP) * spf]
        # only the emit window leaves the device: the mel-context samples in
        # front of it are never emitted
        wav = wav[:, OVERLAP * spf : (OVERLAP + self.cap) * spf]
        if self.pcm16:
            wav = to_pcm16(wav)
        return wav, out, held, voc_tail, src

    def stream(
        self,
        mu_y: np.ndarray,  # (T, 80) prior mean of the whole utterance
        spk: np.ndarray,  # (80,) projected speaker embedding
        prompt_feat: Optional[np.ndarray] = None,  # (P, 80)
        prompt_h: Optional[np.ndarray] = None,  # (P, 80)
        emit_mel: bool = False,
    ) -> Iterator:
        """Yield 24 kHz waveform chunks of up to chunk_frames * 480 samples
        (or (wav, mel) pairs with emit_mel=True)."""
        p = self.p_len
        st = _init_session(p, mu_y, prompt_feat, prompt_h)
        spk_dev = _to_device(np.asarray(spk, np.float32).reshape(1, 80), self.device)
        held, voc_tail, src = self.zero_carries(1)
        while st["pos"] < st["mu_y"].shape[0]:
            buf = self.host_inputs(1)
            plan = self.fill(buf, 0, st)
            wav, mel_out, held, voc_tail, src = self.core(
                buf, spk_dev, {0: plan}, held, voc_tail, src)
            _advance_session(st, p, buf[1, 0], buf[0, 0], plan)
            if plan.l_emit > 0:
                # the one read-back of the chunk (already cut to its window)
                wav_chunk = wav[0, : plan.l_emit * self.spf].cpu().numpy()
                if emit_mel:
                    yield wav_chunk, mel_out[0, : plan.l_emit].cpu().numpy()
                else:
                    yield wav_chunk


class MultiStreamSynthesizer:
    """Concurrent streaming sessions advanced by one batched dispatch per
    tick: the per-chunk core runs over a fixed session axis, so S live
    sessions share every launch and one waveform read-back. Sessions join
    and leave at any tick; free slots ride along masked (n_valid = 0,
    l_emit = 0) and their carries stay untouched."""

    def __init__(
        self,
        cfg: JyutVoiceConfig,
        params_tts,
        params_hift,
        max_sessions: int = 4,
        chunk_frames: int = 100,
        prompt_frames: int = 0,
        n_timesteps: int = 10,
        estimator_chunk_masks: bool = False,
        pcm16: bool = False,
        device="cuda",
    ):
        self._ss = StreamingSynthesizer(
            cfg, params_tts, params_hift, chunk_frames, prompt_frames, n_timesteps,
            estimator_chunk_masks, pcm16, device=device,
        )
        self.cfg = cfg
        self.S = max_sessions
        self.chunk = chunk_frames
        self.p_len = prompt_frames
        self._held, self._voc_tail, self._src = self._ss.zero_carries(max_sessions)
        self._spk = np.zeros((max_sessions, 80), np.float32)
        self._sessions: list = [None] * max_sessions  # per-slot host state or None
        self._pending = None  # (plan, read-back) of the last dispatch
        self.dispatches = 0  # ticks that launched work

    @property
    def active(self) -> int:
        return sum(s is not None for s in self._sessions)

    def reset(self) -> None:
        """Drop every session and any in-flight dispatch: slots free, carries
        zeroed."""
        self._sessions = [None] * self.S
        self._pending = None
        for carry in (self._held, self._voc_tail, self._src):
            carry.zero_()
        self._spk[:] = 0.0

    def open(
        self, mu_y: np.ndarray, spk: np.ndarray, prompt_feat: Optional[np.ndarray] = None,
        prompt_h: Optional[np.ndarray] = None,
    ) -> int:
        """Claim a free slot for a new utterance; returns the session id."""
        if prompt_feat is not None and self.p_len == 0:
            raise ValueError(
                "this MultiStreamSynthesizer was built with prompt_frames=0"
                " — rebuild with prompt capacity to open cloning sessions"
            )
        if mu_y.shape[0] == 0:
            # it would never be dispatched nor delivered, and leak the slot
            raise ValueError("mu_y is empty (0 frames); nothing to stream")
        try:
            sid = self._sessions.index(None)
        except ValueError:
            raise RuntimeError(
                f"all {self.S} streaming slots busy; tick() until one frees"
            ) from None
        self._sessions[sid] = _init_session(self.p_len, mu_y, prompt_feat, prompt_h)
        self._spk[sid] = spk
        for carry in (self._held, self._voc_tail, self._src):
            carry[sid] = 0.0
        return sid

    def tick(self):
        """Advance every active session by one chunk with one dispatch,
        double-buffered: this tick's work is enqueued before the previous
        tick's waveform is read back, and that read-back waits on its own
        copy only.

        Returns (chunks, finished) of the previous dispatch: chunks maps
        session id -> waveform samples; finished holds the ids whose last
        chunk was just delivered (a slot stays claimed until then). Call
        tick() while `active` is nonzero."""
        pending = self._dispatch()
        prev, self._pending = self._pending, pending
        if prev is None:
            return {}, set()
        return self._deliver(prev)

    def _dispatch(self):
        ss, p = self._ss, self.p_len
        buf = ss.host_inputs(self.S)
        plans = {}
        for sid, st in enumerate(self._sessions):
            if st is None or st["pos"] >= st["mu_y"].shape[0]:
                continue  # free, or dispatched fully (delivery pending)
            plans[sid] = ss.fill(buf, sid, st)
        if not plans:
            return None
        wav, _mel, self._held, self._voc_tail, self._src = ss.core(
            buf, _to_device(self._spk, ss.device), plans, self._held, self._voc_tail,
            self._src,
        )
        self.dispatches += 1
        readback = _Readback(wav)
        # the host z / mu caches and positions advance at dispatch time: the
        # next dispatch needs them, only the waveform waits
        for sid, plan in plans.items():
            _advance_session(self._sessions[sid], p, buf[1, sid], buf[0, sid], plan)
        return plans, readback

    def close(self, sid: int) -> None:
        """Release a session's slot early (the client went away) and drop its
        share of the in-flight dispatch, so a slot reopened before that
        delivery does not receive the closed session's audio."""
        self._sessions[sid] = None
        if self._pending is not None:
            plans, _ = self._pending
            plans.pop(sid, None)
            if not plans:
                self._pending = None

    def _deliver(self, pending):
        plans, readback = pending
        wav = readback.numpy()  # the one read-back for all sessions
        chunks, finished = {}, set()
        for sid, plan in plans.items():
            if plan.l_emit > 0:
                chunks[sid] = wav[sid, : plan.l_emit * self._ss.spf]
            if plan.is_last:
                finished.add(sid)
                self._sessions[sid] = None
        return chunks, finished

    def run_all(self, requests):
        """Open all requests (at most max_sessions) and tick until done.
        Returns {index: concatenated waveform}."""
        if len(requests) > self.S:
            raise ValueError(f"{len(requests)} requests for {self.S} sessions")
        sid_to_idx = {self.open(*req): i for i, req in enumerate(requests)}
        out = {i: [] for i in range(len(requests))}
        while self.active or self._pending is not None:
            chunks, _ = self.tick()
            for sid, wav in chunks.items():
                out[sid_to_idx[sid]].append(wav)
        return {i: np.concatenate(parts) for i, parts in out.items() if parts}
