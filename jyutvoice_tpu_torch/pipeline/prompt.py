"""Voice-cloning prompt extraction: reference audio -> (prompt_feat,
prompt_h, spk_embed), the inputs of a cloned `Synthesizer.synthesize`.

The counterpart of the JAX package's `pipeline/prompt.py` (the reference's
prompt path):

  ref wav 24 kHz -> log-mel                         -> prompt_feat (T_p, 80)
  ref wav 16 kHz -> whisper mel -> S3 tokenizer     -> speech tokens (25 Hz)
  speech tokens  -> flow encoder                    -> prompt_h (2 T_tok, 80)
  ref wav 16 kHz -> kaldi fbank -> CAM++            -> spk_embed (192,)

The models run on the extractor's device (default "cuda"); resampling, and
the kaldi fbank and whisper mel unless `device_dsp` is on, run on the host,
as in the JAX package. Lengths are padded to geometric buckets and every
model masks its padding, so a bucketed run equals the exact-length one.
Without a CAM++ or tokenizer artifact the extractor returns a zero speaker
embedding and no tokens (no prompt_h), as the JAX package does.
`streaming_encoder=True` encodes the tokens with the KV-cached
`StreamingTokenEncoder` (`pipeline/streaming.py`) one chunk at a time,
through the per-component path. Not ported: the onnxruntime backends (so an
artifact that the native models cannot read raises, where the JAX package
would fall back to onnxruntime).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Optional

import numpy as np
import torch

from jyutvoice_tpu_torch.audio.fbank import kaldi_fbank, kaldi_fbank_batch
from jyutvoice_tpu_torch.audio.mel import MelSpec
from jyutvoice_tpu_torch.audio.resample import resample_sinc
from jyutvoice_tpu_torch.audio.whisper_mel import whisper_log_mel, whisper_log_mel_batch
from jyutvoice_tpu_torch.config import FlowEncoderConfig
from jyutvoice_tpu_torch.models.campplus import CampPlusConfig, apply_campplus, build_campplus
from jyutvoice_tpu_torch.models.flow_encoder import FlowEncoder, apply_flow_encoder
from jyutvoice_tpu_torch.models.s3_tokenizer import (
    S3Tokenizer,
    S3TokenizerConfig,
    apply_s3_tokenizer,
    out_len,
)
from jyutvoice_tpu_torch.weights.from_jax import load_jax_params

_log = logging.getLogger(__name__)


def _time_bucket(n: int, base: int = 128, growth: float = 1.5) -> int:
    """Geometric length buckets: a bounded set of shapes, whatever the
    utterance lengths (the masked models make the padding exact)."""
    b = base
    while b < n:
        b = int(b * growth)
    return b


def _prepare_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        from jyutvoice_tpu_torch.pipeline.synthesize import disable_tf32

        disable_tf32()
    return device


class CampPlusEmbedder:
    """192-d speaker embedding from 16 kHz audio with the native CAM++
    (`models/campplus.py`), its weights read from campplus.onnx by the
    stdlib reader or given as a JAX-layout tree (`params`)."""

    def __init__(self, onnx_path: Optional[str] = None, params: Optional[dict] = None,
                 device="cuda"):
        self.cfg = CampPlusConfig()
        self.device = _prepare_device(device)
        if onnx_path and params is None:
            from jyutvoice_tpu_torch.weights.campplus_convert import campplus_from_onnx

            params = campplus_from_onnx(onnx_path, self.cfg)
            _log.info("campplus: native backend (weights from %s)", onnx_path)
        self.model = None
        if params is not None:
            self.model = build_campplus(params, self.cfg).to(self.device)

    @torch.inference_mode()
    def __call__(self, audio16k: np.ndarray) -> np.ndarray:
        if self.model is None:
            return np.zeros(self.cfg.embedding_size, np.float32)
        feat = kaldi_fbank(audio16k, num_mel_bins=80)
        feat = feat - feat.mean(axis=0, keepdims=True)
        t = feat.shape[0]
        fb = np.zeros((1, _time_bucket(t), feat.shape[1]), np.float32)
        fb[0, :t] = feat
        out = apply_campplus(self.model, torch.from_numpy(fb).to(self.device),
                             torch.tensor([t], device=self.device))
        return out.cpu().numpy().flatten().astype(np.float32)


class SpeechTokenizer:
    """whisper mel -> 6561-vocab speech tokens at 25 Hz with the native S3
    tokenizer (`models/s3_tokenizer.py`), its weights from a torch checkpoint
    (`torch_path`), from ONNX initializers that keep module-path names
    (`onnx_path`), or a JAX-layout tree (`params`)."""

    def __init__(self, onnx_path: Optional[str] = None, torch_path: Optional[str] = None,
                 params: Optional[dict] = None, device="cuda"):
        from jyutvoice_tpu_torch.weights import s3_convert

        self.cfg = S3TokenizerConfig()
        self.device = _prepare_device(device)
        if torch_path and params is None:
            params = s3_convert.s3_from_torch(torch_path, self.cfg)
            _log.info("speech tokenizer: native backend (%s)", torch_path)
        if onnx_path and params is None:
            params = s3_convert.s3_from_onnx(onnx_path, self.cfg)
            _log.info("speech tokenizer: native backend (%s)", onnx_path)
        self.model = None
        if params is not None:
            self.model = load_jax_params(S3Tokenizer(self.cfg), params).to(self.device).eval()

    @torch.inference_mode()
    def __call__(self, audio16k: np.ndarray) -> Optional[np.ndarray]:
        if self.model is None:
            return None
        mel = whisper_log_mel(audio16k)  # (128, T)
        t = mel.shape[1]
        mb = np.zeros((1, _time_bucket(t), mel.shape[0]), np.float32)
        mb[0, :t] = mel.T
        tokens = apply_s3_tokenizer(self.model, torch.from_numpy(mb).to(self.device),
                                    torch.tensor([t], device=self.device))
        n_valid = int(out_len(np.asarray([t]))[0])
        return tokens[0, :n_valid].cpu().numpy().astype(np.int32)


@dataclasses.dataclass
class PromptFeatures:
    prompt_feat: np.ndarray  # (T_p, 80) 24 kHz mel
    prompt_h: Optional[np.ndarray]  # (T_p, 80) flow-encoder hidden states
    spk_embed: np.ndarray  # (192,)
    speech_tokens: Optional[np.ndarray]


class PromptExtractor:
    """flow_encoder_params, campplus_params and tokenizer_params are
    JAX-layout trees (`init_flow_encoder` / `init_campplus` /
    `init_s3_tokenizer`, the converters of `weights/`, or
    `weights/random_init.py`), the CAM++ and S3 ones at the default
    `CampPlusConfig` / `S3TokenizerConfig`; campplus_onnx, tokenizer_onnx
    and tokenizer_torch are artifact paths converted at construction (one
    that the native models cannot read raises)."""

    def __init__(
        self,
        flow_encoder_params=None,
        flow_encoder_cfg: Optional[FlowEncoderConfig] = None,
        campplus_onnx: Optional[str] = None,
        tokenizer_onnx: Optional[str] = None,
        tokenizer_torch: Optional[str] = None,
        streaming_encoder: bool = False,
        streaming_t_max: int = 1024,
        device_dsp: bool = False,
        device="cuda",
        campplus_params: Optional[dict] = None,
        tokenizer_params: Optional[dict] = None,
    ):
        self.device = _prepare_device(device)
        # incremental KV-cached token encoding (streaming_t_max tokens of
        # capacity); the encoder is stateful, so extractions share it under
        # a lock
        self.streaming_encoder = streaming_encoder
        self.streaming_t_max = streaming_t_max
        self._stream_encoder = None
        self._stream_lock = threading.Lock()
        self.mel = MelSpec()
        # device_dsp: the kaldi fbank and whisper mel run in the batched
        # device computation (matmul DFT) instead of per row on the host
        self.device_dsp = device_dsp
        self.embedder = CampPlusEmbedder(campplus_onnx, params=campplus_params,
                                         device=self.device)
        self.tokenizer = SpeechTokenizer(tokenizer_onnx, torch_path=tokenizer_torch,
                                         params=tokenizer_params, device=self.device)
        self.flow_encoder_cfg = flow_encoder_cfg or FlowEncoderConfig()
        self.flow_encoder = None
        if flow_encoder_params is not None:
            self.flow_encoder = load_jax_params(
                FlowEncoder(self.flow_encoder_cfg), flow_encoder_params
            ).to(self.device).eval()

    def __call__(self, audio: np.ndarray, sr: int) -> PromptFeatures:
        """One row of `extract_batch`: one batched pass on the device; with
        streaming_encoder, the per-component path."""
        if self.streaming_encoder:
            return self._extract_single(audio, sr)
        out = self.extract_batch([audio], [sr])[0]
        if isinstance(out, Exception):
            raise out
        return out

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.inference_mode()
    def _extract_single(self, audio: np.ndarray, sr: int) -> PromptFeatures:
        """Per-component extraction, one model at a time: the streaming
        encoder's path, and the independent reference that the batched path
        is tested against."""
        wav24 = resample_sinc(audio, sr, 24000)
        pad = (self.mel.n_fft - self.mel.hop) // 2
        if len(wav24) // self.mel.hop < 1 or len(wav24) <= pad:
            # the reference's torch.stft(center=False) refuses sub-frame clips too
            raise ValueError(f"audio too short for mel frontend ({len(wav24)} samples at 24 kHz)")
        wav16 = resample_sinc(audio, sr, 16000)
        prompt_feat = self.mel(self._to_device(wav24[None]))[0].cpu().numpy()  # (T, 80)
        spk = self.embedder(wav16)
        tokens = self.tokenizer(wav16)
        prompt_h = None
        if tokens is not None and self.flow_encoder is not None:
            if self.streaming_encoder:
                prompt_h = self._encode_tokens_streaming(tokens)
            else:
                prompt_h = self._encode_tokens(tokens)
            # the flow encoder upsamples tokens x2 to the mel frame rate;
            # min() is the reference's data-prep trim
            t = min(prompt_feat.shape[0], prompt_h.shape[0])
            prompt_feat, prompt_h = prompt_feat[:t], prompt_h[:t]
        return PromptFeatures(prompt_feat, prompt_h, spk, tokens)

    @torch.inference_mode()
    def _encode_tokens(self, tokens: np.ndarray) -> np.ndarray:
        """speech tokens -> flow-encoder hidden states (T, 80), bucket-padded
        with exact_pad (the padded run equals the exact-length one)."""
        tb = _time_bucket(len(tokens), base=64)
        tok_pad = np.zeros((1, tb), np.int64)
        tok_pad[0, : len(tokens)] = tokens
        h, h_len = apply_flow_encoder(
            self.flow_encoder, self._to_device(tok_pad),
            torch.tensor([len(tokens)], device=self.device), exact_pad=True,
        )
        return h[0, : int(h_len[0])].cpu().numpy()

    def _encode_tokens_streaming(self, tokens: np.ndarray) -> np.ndarray:
        """speech tokens -> hidden states (T, 80) through the cached
        KV-cached encoder: push every token, then flush."""
        from jyutvoice_tpu_torch.pipeline.streaming import StreamingTokenEncoder

        with self._stream_lock:
            if self._stream_encoder is None:
                self._stream_encoder = StreamingTokenEncoder(
                    self.flow_encoder, t_max_tokens=self.streaming_t_max)
            enc = self._stream_encoder
            enc.reset()
            return np.concatenate([enc.push(tokens), enc.flush()], axis=0)

    # ------------------------------------------------------------------
    # Batched extraction
    # ------------------------------------------------------------------

    def _batch_models(self, outs, fb, fb_len, wm, wm_len, with_spk, with_tok):
        if with_spk:
            outs["spk"] = apply_campplus(self.embedder.model, fb, t_len=fb_len)
        if with_tok:
            tokens = apply_s3_tokenizer(self.tokenizer.model, wm, t_len=wm_len)
            # tokens go to the flow encoder on the device; those past n_tok
            # are masked by its sequence mask
            h, h_len = apply_flow_encoder(self.flow_encoder, tokens, out_len(wm_len),
                                          exact_pad=True)
            outs.update(tokens=tokens, h=h, h_len=h_len)
        return outs

    def _batch_dsp(self, w16, len16, with_spk, with_tok):
        """The kaldi fbank (mean-normalized over each row's valid frames) and
        the whisper mel of one reflect-padded 16 kHz batch, on the device."""
        fb = fb_len = wm = wm_len = None
        if with_spk:
            # the raw signal starts at the 200-sample reflect pad
            fb, fb_len = kaldi_fbank_batch(w16[:, 200:], len16)
            m = (torch.arange(fb.shape[1], device=fb.device)[None, :] < fb_len[:, None])[..., None]
            mean = torch.where(m, fb, 0.0).sum(dim=1) / torch.clamp(
                fb_len.to(fb.dtype), min=1.0)[:, None]
            fb = torch.where(m, fb - mean[:, None, :], 0.0)
        if with_tok:
            wm, wm_len = whisper_log_mel_batch(w16, len16)
        return fb, fb_len, wm, wm_len

    @torch.inference_mode()
    def extract_batch(self, audios, srs, max_batch: int = 32,
                      device_dsp: Optional[bool] = None) -> list:
        """Batched prompt extraction. Rows are grouped by mel-frame bucket;
        each group of up to max_batch rows (padded to a power of two) runs
        one pass on the device: the 24 kHz mel, CAM++, and the tokenizer
        chained into the flow encoder, then one read-back. A component
        without a native model runs per row on the host, as `__call__`
        would. Returns one entry per row: PromptFeatures, or the Exception
        that failed that row. device_dsp (default: the constructor's) also
        computes the kaldi fbank and whisper mel on the device."""
        if device_dsp is None:
            device_dsp = self.device_dsp
        hop, n_fft = self.mel.hop, self.mel.n_fft
        pad = (n_fft - hop) // 2
        # a component without a model runs per row (a zero embedding, no tokens)
        with_spk = self.embedder.model is not None
        with_tok = self.tokenizer.model is not None and self.flow_encoder is not None

        results: list = [None] * len(audios)
        prepped = []  # (row, reflect-padded 24 kHz wav, 16 kHz wav, mel frames)
        for i, (audio, sr) in enumerate(zip(audios, srs)):
            try:
                wav24 = resample_sinc(audio, int(sr), 24000)
                t24 = len(wav24) // hop
                if t24 < 1 or len(wav24) <= pad:
                    raise ValueError(
                        f"audio too short for mel frontend ({len(wav24)} samples at 24 kHz)")
                wav16 = resample_sinc(audio, int(sr), 16000)
                # each row reflects its own tail: padding the zero-padded
                # batch buffer on the device would reflect zeros
                prepped.append((i, np.pad(wav24, (pad, pad), mode="reflect"), wav16, t24))
            except Exception as e:  # noqa: BLE001 — one row's failure is that row's result
                results[i] = e

        groups: dict = {}
        for item in prepped:
            groups.setdefault(_time_bucket(item[3]), []).append(item)

        for f_bucket, items in groups.items():
            for start in range(0, len(items), max_batch):
                chunk = items[start : start + max_batch]
                b_pad = 1 << (len(chunk) - 1).bit_length()
                # one frame of slack: a row at the bucket edge can carry up
                # to hop - 1 more samples
                wavbuf = np.zeros((b_pad, (f_bucket + 1) * hop + 2 * pad), np.float32)
                row_fail: dict = {}
                dsp_on_device = device_dsp and (with_spk or with_tok)
                if dsp_on_device:
                    # one reflect-padded 16 kHz buffer: the fbank reads it
                    # past the 200-sample pad, the whisper mel with it
                    w16buf = np.zeros((b_pad, (f_bucket + 1) * 320 + 400), np.float32)
                    len16 = np.zeros(b_pad, np.int64)
                    for j, (_i, wavp, wav16, _t24) in enumerate(chunk):
                        wavbuf[j, : len(wavp)] = wavp
                        try:
                            w16p = np.pad(wav16, (200, 200), mode="reflect")
                            w16buf[j, : len(w16p)] = w16p
                            len16[j] = len(wav16)
                        except Exception as e:  # noqa: BLE001
                            row_fail[j] = e
                    feats = self._batch_dsp(self._to_device(w16buf), self._to_device(len16),
                                            with_spk, with_tok)
                else:
                    cap = 2 * (f_bucket + 1)
                    fbbuf = np.zeros((b_pad, cap, 80), np.float32)
                    fb_len = np.zeros(b_pad, np.int64)
                    wmbuf = np.zeros((b_pad, cap, 128), np.float32)
                    wm_len = np.zeros(b_pad, np.int64)
                    for j, (_i, wavp, wav16, _t24) in enumerate(chunk):
                        wavbuf[j, : len(wavp)] = wavp
                        try:
                            if with_spk:
                                fb = kaldi_fbank(wav16, num_mel_bins=80)
                                fbbuf[j, : fb.shape[0]] = fb - fb.mean(axis=0, keepdims=True)
                                fb_len[j] = fb.shape[0]
                            if with_tok:
                                wm = whisper_log_mel(wav16)  # (128, T)
                                wmbuf[j, : wm.shape[1]] = wm.T
                                wm_len[j] = wm.shape[1]
                        except Exception as e:  # noqa: BLE001
                            row_fail[j] = e
                    feats = tuple(self._to_device(a) for a in (fbbuf, fb_len, wmbuf, wm_len))
                outs = {"mel": self.mel.from_padded(self._to_device(wavbuf))}
                outs = self._batch_models(outs, *feats, with_spk, with_tok)
                outs = {k: v.cpu().numpy() for k, v in outs.items()}

                for j, (i, _wavp, wav16, t24) in enumerate(chunk):
                    if j in row_fail:
                        results[i] = row_fail[j]
                        continue
                    try:
                        prompt_feat = outs["mel"][j, :t24]
                        spk = outs["spk"][j] if with_spk else self.embedder(wav16)
                        tokens = prompt_h = None
                        if with_tok:
                            h_len = int(outs["h_len"][j])
                            n_tok = h_len // self.flow_encoder_cfg.upsample_stride
                            tokens = outs["tokens"][j, :n_tok].astype(np.int32)
                            prompt_h = outs["h"][j, :h_len]
                        else:
                            tokens = self.tokenizer(wav16)
                            if tokens is not None and self.flow_encoder is not None:
                                prompt_h = self._encode_tokens(tokens)
                        if prompt_h is not None:
                            t = min(prompt_feat.shape[0], prompt_h.shape[0])
                            prompt_feat, prompt_h = prompt_feat[:t], prompt_h[:t]
                        results[i] = PromptFeatures(prompt_feat, prompt_h, spk, tokens)
                    except Exception as e:  # noqa: BLE001
                        results[i] = e
        return results
