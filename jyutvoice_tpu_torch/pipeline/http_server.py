"""HTTP front end of the serving engines (standard library only).

The counterpart of the JAX package's `pipeline/http_server.py`:

  GET  /healthz     -> {"ok": true, "device": ...}
  GET  /stats       -> serving counters (requests, batches, latency, queue)
  POST /tts         -> audio/wav (16-bit PCM, 24 kHz)
                       body: {"text": "...", "lang": "yue", "phone": null,
                              "spk_embed": [192 floats] (optional),
                              "ref_audio_b64": "<base64 WAV>" (optional)}
  POST /tts/stream  -> chunked-transfer audio/wav whose PCM arrives as the
                       streaming lane generates it

Voice cloning over HTTP: `ref_audio_b64` is a base64 PCM WAV; the server
runs it through its `PromptExtractor` (speaker embedding, prompt mel and
prompt hidden states) and keeps the result in an LRU cache keyed by the
audio's SHA-256, so a repeated voice costs one extraction; concurrent
requests for the same new voice share one extraction. /tts/stream grafts
the prompt only on a lane built with prompt capacity, and otherwise clones
through the speaker embedding alone.

A threaded `http.server` maps one connection to one thread, which waits on
an engine future or a stream handle; the batching happens in the engine's
worker, the device work in the synthesizer.
"""

from __future__ import annotations

import base64
import hashlib
import json
import struct
import threading
import wave
from collections import OrderedDict
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from io import BytesIO

import numpy as np
import torch

from jyutvoice_tpu_torch.pipeline.server import ServingEngine, StreamingLane

# ---------------------------------------------------------------------------
# WAV container
# ---------------------------------------------------------------------------


def pcm16_of(wav: np.ndarray) -> np.ndarray:
    """float32 in [-1, 1] (or int16 already) -> int16 PCM."""
    if wav.dtype == np.int16:
        return wav
    return np.round(np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)


def wav_header(num_samples: int, sample_rate: int) -> bytes:
    """44-byte PCM16 mono WAV header. num_samples < 0 writes the streaming
    convention (0xFFFFFFFF sizes: a data chunk of unknown length)."""
    if num_samples < 0:
        data_size, riff_size = 0xFFFFFFFF - 36, 0xFFFFFFFF
    else:
        data_size = num_samples * 2
        riff_size = data_size + 36
    return b"".join([
        b"RIFF", struct.pack("<I", riff_size), b"WAVEfmt ",
        struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16),
        b"data", struct.pack("<I", data_size),
    ])


def wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    pcm = pcm16_of(wav)
    return wav_header(len(pcm), sample_rate) + pcm.tobytes()


def decode_wav(data: bytes):
    """PCM WAV bytes -> (mono float32 in [-1, 1], sample rate)."""
    with wave.open(BytesIO(data), "rb") as f:
        sr = f.getframerate()
        width = f.getsampwidth()
        raw = f.readframes(f.getnframes())
        nch = f.getnchannels()
    if width == 2:
        audio = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 1:
        audio = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        audio = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if nch > 1:
        audio = audio.reshape(-1, nch).mean(axis=1)
    return audio, sr


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "jyutvoice-torch"

    def log_message(self, fmt, *args):  # noqa: D102 — quiet unless verbose
        if self.server.tts_verbose:
            super().log_message(fmt, *args)

    def _json_body(self) -> dict:
        length = int(self.headers.get("Content-Length", "0"))
        if length <= 0:
            raise ValueError("empty request body")
        limit = self.server.tts_max_body
        if length > limit:
            # the client's Content-Length is untrusted: refuse before reading
            raise ValueError(f"request body is {length} bytes; the limit is {limit} "
                             "(raise TTSServer max_body_bytes if intended)")
        body = json.loads(self.rfile.read(length))
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        return body

    def _send_json(self, obj: dict, code: int = 200) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_error_json(self, code: int, msg: str) -> None:
        self._send_json({"error": msg}, code=code)

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")

    # -- routes -------------------------------------------------------------

    def do_GET(self):  # noqa: N802
        srv = self.server
        if self.path == "/healthz":
            self._send_json({"ok": True, "device": srv.tts_device})
        elif self.path == "/stats":
            st = srv.tts_engine.stats
            out = {
                "requests": st.requests,
                "batches": st.batches,
                "errors": st.errors,
                "mean_batch": st.mean_batch,
                "mean_latency_ms": st.mean_latency_ms,
                "queued": srv.tts_engine._q.qsize(),
                "cached_voices": len(srv.tts_prompt_cache),
            }
            if srv.tts_lane is not None:
                out["active_streams"] = len(srv.tts_lane._handles)
            self._send_json(out)
        else:
            self._send_error_json(404, f"no such path: {self.path}")

    def do_POST(self):  # noqa: N802
        srv = self.server
        try:
            body = self._json_body()
            text = body.get("text")
            if not isinstance(text, str) or not text:
                raise ValueError("'text' (non-empty string) is required")
            kwargs = dict(text=text, lang=body.get("lang", "yue"), phone=body.get("phone"))
            spk = body.get("spk_embed")
            if spk is not None:
                kwargs["spk_embed"] = np.asarray(spk, np.float32)
            ref_b64 = body.get("ref_audio_b64")
            if ref_b64 is not None:
                pf = self._extract_prompt(srv, ref_b64)
                kwargs["spk_embed"] = pf.spk_embed
                # the prompt grafts on /tts always, on /tts/stream only when
                # the lane has prompt capacity (else speaker embedding only)
                graft = self.path == "/tts" or (
                    self.path == "/tts/stream" and srv.tts_lane is not None
                    and srv.tts_lane.prompt_frames > 0)
                if pf.prompt_h is not None and graft:
                    kwargs["prompt_feat"] = pf.prompt_feat
                    kwargs["prompt_h"] = pf.prompt_h
        except (ValueError, json.JSONDecodeError) as e:
            self._send_error_json(400, str(e))
            return
        except Exception as e:  # noqa: BLE001 — e.g. a failed prompt extraction
            self._send_error_json(500, f"{type(e).__name__}: {e}")
            return
        if self.path == "/tts":
            self._tts(srv, kwargs)
        elif self.path == "/tts/stream":
            self._tts_stream(srv, kwargs)
        else:
            self._send_error_json(404, f"no such path: {self.path}")

    def _extract_prompt(self, srv, ref_b64: str):
        """base64 WAV -> PromptFeatures, cached by the audio's SHA-256."""
        if srv.tts_prompt_extractor is None:
            raise ValueError("this server was started without prompt models "
                             "(--campplus/--s3-tokenizer/--flow-encoder); "
                             "ref_audio_b64 is unavailable")
        try:
            data = base64.b64decode(ref_b64, validate=True)
        except ValueError as e:
            raise ValueError(f"ref_audio_b64 is not valid base64: {e}") from None
        key = hashlib.sha256(data).hexdigest()
        cache = srv.tts_prompt_cache
        with srv.tts_prompt_lock:
            if key in cache:
                cache.move_to_end(key)  # LRU: a hit refreshes the entry
                return cache[key]
            # the first request for a new voice extracts it; concurrent ones
            # for the same voice wait on its future
            fut = srv.tts_prompt_inflight.get(key)
            owner = fut is None
            if owner:
                fut = Future()
                srv.tts_prompt_inflight[key] = fut
        if not owner:
            return fut.result(timeout=srv.tts_request_timeout)
        try:
            audio, sr = decode_wav(data)
            pf = srv.tts_prompt_extractor(audio, sr)
        except BaseException as e:
            with srv.tts_prompt_lock:
                srv.tts_prompt_inflight.pop(key, None)
            fut.set_exception(e)
            raise
        with srv.tts_prompt_lock:
            while len(cache) >= srv.tts_prompt_cache_size:
                cache.popitem(last=False)
            cache[key] = pf
            srv.tts_prompt_inflight.pop(key, None)
        fut.set_result(pf)
        return pf

    def _tts(self, srv, kwargs) -> None:
        try:
            res = srv.tts_engine.submit(**kwargs).result(timeout=srv.tts_request_timeout)
        except ValueError as e:  # bad language, unknown character, bad phonetics
            self._send_error_json(400, str(e))
            return
        except Exception as e:  # noqa: BLE001
            self._send_error_json(500, f"{type(e).__name__}: {e}")
            return
        data = wav_bytes(res.wav, srv.tts_sample_rate)
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _tts_stream(self, srv, kwargs) -> None:
        if srv.tts_lane is None:
            self._send_error_json(404, "streaming lane disabled (start the server with "
                                       "streaming)")
            return
        handle = None
        try:
            # the engine applies the server's length_scale itself; the lane
            # takes it per stream, so /tts and /tts/stream speak at one rate
            handle = srv.tts_lane.submit(length_scale=srv.tts_length_scale, **kwargs)
            chunks = handle.iter_timeout(srv.tts_request_timeout)
            first = next(chunks)  # front-end errors surface before the headers
        except ValueError as e:
            self._send_error_json(400, str(e))
            return
        except StopIteration:
            first = None
        except Exception as e:  # noqa: BLE001 — a per-chunk TimeoutError included
            if handle is not None:
                handle.cancel()
            self._send_error_json(500, f"{type(e).__name__}: {e}")
            return
        try:
            # a client that left while the first chunk was decoded fails
            # these writes: cancel its stream then too
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self._chunk(wav_header(-1, srv.tts_sample_rate))
            if first is not None:
                self._chunk(pcm16_of(np.asarray(first)).tobytes())
                for chunk in chunks:
                    self._chunk(pcm16_of(np.asarray(chunk)).tobytes())
            self._chunk(b"")  # the terminator: only after the whole stream
        except Exception:  # noqa: BLE001 — a failed lane or a gone client: drop
            # the connection without the terminator (an aborted transfer, not
            # truncated audio in a complete response) and free the slot
            handle.cancel()
            self.close_connection = True


def device_name(device: torch.device) -> str:
    """The synthesizer's device as /healthz reports it."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


class TTSServer:
    """The HTTP server and the serving engines around one Synthesizer.

    Constructing it starts the engine's worker, the lane's (with streaming)
    and the HTTP thread; close() stops all three. `port` is resolved after
    the bind, so port=0 picks a free one. The engine serves PCM16.
    """

    def __init__(
        self,
        synthesizer,
        host: str = "127.0.0.1",
        port: int = 8080,
        *,
        max_batch: int = 8,
        max_wait_ms: float = 20.0,
        n_timesteps: int = 10,
        length_scale: float = 1.0,
        streaming: bool = False,
        max_streams: int = 4,
        chunk_frames: int = 100,
        stream_prompt_frames: int = 0,
        request_timeout: float = 600.0,
        max_body_bytes: int = 64 << 20,
        verbose: bool = False,
        prompt_extractor=None,
        prompt_cache_size: int = 16,
        sp_mesh=None,
        sp_attention: str = "scores",
        long_attention: str = "auto",
    ):
        self.engine = ServingEngine(
            synthesizer, max_batch=max_batch, max_wait_ms=max_wait_ms,
            n_timesteps=n_timesteps, length_scale=length_scale, pcm16=True,
            # a multi-device host shards each long-form solve over the mesh
            sp_mesh=sp_mesh, sp_attention=sp_attention, long_attention=long_attention,
        )
        self.lane = None
        self._httpd = None
        try:
            if streaming:
                # stream_prompt_frames > 0 lets /tts/stream graft cloning
                # prompts; every tick then decodes the prompt-extended segment
                self.lane = StreamingLane(
                    synthesizer, max_streams=max_streams, chunk_frames=chunk_frames,
                    n_timesteps=n_timesteps, pcm16=True, prompt_frames=stream_prompt_frames,
                )
            self._httpd = ThreadingHTTPServer((host, port), _Handler)
        except BaseException:
            self._close_engines()
            raise
        self._httpd.daemon_threads = True
        # the handler reaches these through self.server
        self._httpd.tts_engine = self.engine
        self._httpd.tts_lane = self.lane
        self._httpd.tts_sample_rate = synthesizer.cfg.audio.sample_rate
        self._httpd.tts_length_scale = length_scale
        self._httpd.tts_request_timeout = request_timeout
        self._httpd.tts_max_body = max_body_bytes
        self._httpd.tts_verbose = verbose
        self._httpd.tts_prompt_extractor = prompt_extractor
        self._httpd.tts_prompt_cache = OrderedDict()
        self._httpd.tts_prompt_cache_size = max(1, prompt_cache_size)
        self._httpd.tts_prompt_inflight = {}
        self._httpd.tts_prompt_lock = threading.Lock()
        self._httpd.tts_device = device_name(synthesizer.device)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="jyutvoice-http", daemon=True)
        self._thread.start()

    def _close_engines(self) -> None:
        self.engine.close()
        if self.lane is not None:
            self.lane.close()

    def close(self) -> None:
        """Stop accepting connections, then drain the engines: requests
        already submitted finish, queued ones fail."""
        self._httpd.shutdown()
        self._thread.join(timeout=10.0)
        self._httpd.server_close()
        self._close_engines()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
