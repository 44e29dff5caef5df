"""The port's HTTP front end (`pipeline/http_server.py`) and `cli.serve` on
the CPU: the cases of the JAX package's tests/test_http_server.py (the
sequence-parallel mesh left out: the port has none; its long_attention
plumbing is held instead), on the small configuration with the JAX
package's random trees, 2 Euler steps. Cloning runs through a small
`PromptExtractor` (the reduced CAM++ / S3 / flow-encoder configs of
test_torch_port_prompt.py, random trees). `cli.serve` runs in a child
process that gets SIGTERM and must drain to exit code 0.

Every wait is bounded (urllib and socket timeouts, future and join
timeouts); servers close in `finally` or at the fixture's end.
"""

import base64
import http.client
import json
import os
import queue
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import wave as wave_mod
from io import BytesIO

import numpy as np
import pytest

import jyutvoice_tpu_torch.pipeline.http_server as hs
from jyutvoice_tpu_torch.config import FlowEncoderConfig
from jyutvoice_tpu_torch.models.campplus import CampPlusConfig
from jyutvoice_tpu_torch.models.s3_tokenizer import S3TokenizerConfig
from jyutvoice_tpu_torch.pipeline.http_server import (
    TTSServer,
    decode_wav,
    pcm16_of,
    wav_bytes,
    wav_header,
)
from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer
from torch_port_setup import PORT_CFG, jax_trees

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT, PHONE = "佢 係邊 個", "keoi5 hai6 bin1 go3"
T = 120  # seconds: the bound of every wait below


@pytest.fixture(scope="module")
def synth():
    return Synthesizer(PORT_CFG, *jax_trees(), device="cpu")


@pytest.fixture(scope="module")
def server(synth):
    srv = TTSServer(synth, port=0, max_batch=2, max_wait_ms=5.0, n_timesteps=2,
                    streaming=True, max_streams=2, chunk_frames=50)
    yield srv, synth
    srv.close()


def _url(srv, path):
    return f"http://127.0.0.1:{srv.port}{path}"


def _post(srv, path, body, timeout=T):
    req = urllib.request.Request(_url(srv, path), data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _pcm(data):
    with wave_mod.open(BytesIO(data), "rb") as f:
        assert f.getframerate() == 24000 and f.getsampwidth() == 2
        return np.frombuffer(f.readframes(f.getnframes()), np.int16)


def test_wav_container_roundtrip():
    wav = np.sin(np.linspace(0, 100, 2400)).astype(np.float32) * 0.5
    data = wav_bytes(wav, 24000)
    with wave_mod.open(BytesIO(data), "rb") as f:
        assert f.getnchannels() == 1
    np.testing.assert_array_equal(_pcm(data), pcm16_of(wav))
    assert wav_header(-1, 24000)[4:8] == b"\xff\xff\xff\xff"
    audio, sr = decode_wav(wav_bytes(wav, 16000))
    assert sr == 16000
    np.testing.assert_allclose(audio, wav, atol=1e-4)


def test_healthz_and_stats(server):
    srv, _ = server
    with urllib.request.urlopen(_url(srv, "/healthz"), timeout=T) as r:
        assert json.loads(r.read()) == {"ok": True, "device": "cpu"}
    with urllib.request.urlopen(_url(srv, "/stats"), timeout=T) as r:
        st = json.loads(r.read())
    assert {"requests", "batches", "errors", "cached_voices", "active_streams"} <= set(st)


def test_tts_endpoint_matches_direct(server):
    srv, synth = server
    direct = synth.synthesize(TEXT, lang="yue", phone=PHONE, n_timesteps=2)
    with _post(srv, "/tts", {"text": TEXT, "lang": "yue", "phone": PHONE}) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        pcm = _pcm(r.read())
    assert len(pcm) == len(direct.wav)
    np.testing.assert_allclose(pcm.astype(np.float32) / 32767.0, direct.wav, atol=2e-3)


def test_tts_bad_requests(server):
    srv, _ = server
    for body in ({"lang": "yue"}, {"text": TEXT, "lang": "nope-such-lang"},
                 {"text": TEXT, "lang": "yue", "phone": "bad jyutping!!"}):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv, "/tts", body)
        assert ei.value.code == 400
        assert "error" in json.loads(ei.value.read())
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(srv, "/nope", {"text": TEXT})
    assert ei.value.code == 404


def test_tts_stream_endpoint(server):
    srv, synth = server
    with _post(srv, "/tts/stream", {"text": TEXT, "lang": "yue", "phone": PHONE}) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        data = r.read()  # urllib joins the chunked transfer
    header, pcm = data[:44], np.frombuffer(data[44:], np.int16)
    assert header[:4] == b"RIFF" and header[8:12] == b"WAVE"
    direct = synth.synthesize(TEXT, lang="yue", phone=PHONE, n_timesteps=2)
    assert len(pcm) == len(direct.wav) and np.abs(pcm).max() > 0


def test_stream_client_disconnect_frees_lane_slot(server):
    """A /tts/stream client that goes away mid-stream cancels its lane
    session."""
    srv, _ = server
    body = json.dumps({"text": ("佢係邊個 " * 30).strip(), "lang": "yue",
                       "phone": " ".join([PHONE] * 30)}).encode()
    s = socket.create_connection(("127.0.0.1", srv.port), timeout=T)
    try:
        s.sendall(b"POST /tts/stream HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                  b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
        got = b""
        while len(got) < 2048:  # headers, the WAV header and the first chunk
            chunk = s.recv(4096)
            if not chunk:
                break
            got += chunk
        assert b"200" in got.split(b"\r\n", 1)[0]
    finally:
        s.close()
    deadline = time.monotonic() + T
    while time.monotonic() < deadline:
        if srv.lane._ms.active == 0 and not srv.lane._handles:
            break
        time.sleep(0.1)
    assert srv.lane._ms.active == 0 and not srv.lane._handles


def test_concurrent_requests_coalesce(server):
    srv, _ = server
    texts = [(TEXT, PHONE), ("你好", "nei5 hou2"), ("我 哋 去", "ngo5 dei6 heoi3"),
             (TEXT, PHONE)]
    before = srv.engine.stats.batches
    results = {}

    def post_one(i, text, phone):
        with _post(srv, "/tts", {"text": text, "lang": "yue", "phone": phone}) as r:
            results[i] = r.read()

    ts = [threading.Thread(target=post_one, args=(i, t, p)) for i, (t, p) in enumerate(texts)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(T)
    assert not any(t.is_alive() for t in ts) and len(results) == 4
    # identical requests, identical audio up to 1 LSB: they may ride batches
    # of different sizes, whose f32 sums round differently
    same = [_pcm(results[i]).astype(np.int32) for i in (0, 3)]
    assert same[0].shape == same[1].shape and np.abs(same[0] - same[1]).max() <= 1
    assert results[0] != results[1]
    assert srv.engine.stats.batches - before <= 3  # max_batch=2: they coalesce


def test_ref_audio_without_extractor_is_400(server):
    srv, _ = server
    b64 = base64.b64encode(wav_bytes(np.zeros(1600, np.float32), 16000)).decode()
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(srv, "/tts", {"text": TEXT, "phone": PHONE, "ref_audio_b64": b64})
    assert ei.value.code == 400
    assert "prompt models" in json.loads(ei.value.read())["error"]


def test_long_attention_reaches_engine(server):
    srv, synth = server
    assert srv.engine.long_attention == "auto"
    srv2 = TTSServer(synth, port=0, max_batch=2, max_wait_ms=5.0, n_timesteps=2,
                     long_attention="exact")
    try:
        assert srv2.engine.long_attention == "exact" and srv2.lane is None
    finally:
        srv2.close()


def test_ref_audio_cloning_path(synth, monkeypatch):
    """ref_audio_b64 -> a small PromptExtractor -> a cloned /tts, cached by
    the audio's hash: the second request extracts nothing and returns the
    same audio."""
    from jyutvoice_tpu_torch.pipeline import prompt
    from jyutvoice_tpu_torch.weights import random_init

    fe = FlowEncoderConfig(input_size=64, output_size=64, attention_heads=2,
                           linear_units=128, num_blocks=2, num_up_blocks=1)
    cp = CampPlusConfig(num_layers=(2, 2, 2))
    s3 = S3TokenizerConfig(n_mels=128, n_audio_ctx=256, n_audio_state=64, n_audio_head=4,
                           n_audio_layer=2)
    monkeypatch.setattr(prompt, "CampPlusConfig", lambda: cp)
    monkeypatch.setattr(prompt, "S3TokenizerConfig", lambda: s3)
    ex = prompt.PromptExtractor(
        flow_encoder_params=random_init.init_flow_encoder_tree(fe), flow_encoder_cfg=fe,
        campplus_params=random_init.init_campplus_tree(cp),
        tokenizer_params=random_init.init_s3_tree(s3), device="cpu")
    calls = []
    real_call = ex.__call__

    class Counting:
        def __call__(self, audio, sr):
            calls.append(sr)
            return real_call(audio, sr)

    srv = TTSServer(synth, port=0, max_batch=2, max_wait_ms=5.0, n_timesteps=2,
                    prompt_extractor=Counting())
    try:
        t = np.arange(24000) / 24000
        ref = (0.3 * np.sin(2 * np.pi * 150 * t)).astype(np.float32)
        body = {"text": TEXT, "lang": "yue", "phone": PHONE,
                "ref_audio_b64": base64.b64encode(wav_bytes(ref, 24000)).decode()}
        with _post(srv, "/tts", body) as r:
            first = r.read()
        with _post(srv, "/tts", body) as r:
            second = r.read()
        plain = synth.synthesize(TEXT, lang="yue", phone=PHONE, n_timesteps=2)
        assert first == second and calls == [24000]
        assert len(srv._httpd.tts_prompt_cache) == 1
        feats = real_call(*decode_wav(wav_bytes(ref, 24000)))
        cloned = synth.synthesize(TEXT, lang="yue", phone=PHONE, n_timesteps=2,
                                  spk_embed=feats.spk_embed, prompt_feat=feats.prompt_feat,
                                  prompt_h=feats.prompt_h)
        pcm = _pcm(first).astype(np.float32) / 32767.0
        assert len(pcm) == len(cloned.wav) == len(plain.wav)
        np.testing.assert_allclose(pcm, cloned.wav, atol=2e-3)
        assert not np.allclose(pcm, plain.wav, atol=2e-3)  # the prompt took part
    finally:
        srv.close()


def test_stream_endpoint_grafts_cloning_prompt(synth):
    """On a lane with prompt capacity /tts/stream grafts the prompt (the
    audio differs from the plain stream's, at the same length)."""
    rng = np.random.default_rng(7)
    pf = rng.standard_normal((24, 80)).astype(np.float32)
    ph = rng.standard_normal((24, 80)).astype(np.float32)

    class FakeExtractor:
        def __call__(self, audio, sr):
            return type("PF", (), {"spk_embed": np.zeros(192, np.float32),
                                   "prompt_feat": pf, "prompt_h": ph})()

    srv = TTSServer(synth, port=0, max_batch=2, max_wait_ms=5.0, n_timesteps=2,
                    streaming=True, max_streams=2, chunk_frames=50, stream_prompt_frames=64,
                    prompt_extractor=FakeExtractor())
    try:
        ref = (rng.standard_normal(2400) * 0.1).astype(np.float32)
        b64 = base64.b64encode(wav_bytes(ref, 24000)).decode()
        plain_body = {"text": TEXT, "lang": "yue", "phone": PHONE}
        with _post(srv, "/tts/stream", plain_body) as r:
            plain = r.read()
        with _post(srv, "/tts/stream", {**plain_body, "ref_audio_b64": b64}) as r:
            cloned = r.read()
        assert len(plain) == len(cloned) and plain[44:] != cloned[44:]
    finally:
        srv.close()


def test_stream_abort_closes_without_terminator(server, monkeypatch):
    """A failure mid-stream aborts the chunked transfer (no terminator)."""
    srv, _ = server

    def boom(x):
        raise RuntimeError("injected encode failure")

    monkeypatch.setattr(hs, "pcm16_of", boom)
    req = urllib.request.Request(
        _url(srv, "/tts/stream"),
        data=json.dumps({"text": TEXT, "lang": "yue", "phone": PHONE}).encode(),
        headers={"Content-Type": "application/json"})
    with pytest.raises((http.client.IncompleteRead, ConnectionError)):
        with urllib.request.urlopen(req, timeout=T) as r:
            r.read()


def test_prompt_cache_lru_and_inflight_dedup(synth):
    """The cache is an LRU (a hit refreshes), and concurrent requests for one
    new voice share one extraction."""
    calls = {"n": 0}
    gate = threading.Event()

    class SlowExtractor:
        def __call__(self, audio, sr):
            calls["n"] += 1
            gate.wait(timeout=30)
            return type("PF", (), {"spk_embed": np.zeros(192, np.float32),
                                   "prompt_feat": None, "prompt_h": None})()

    srv = TTSServer(synth, port=0, max_batch=2, max_wait_ms=5.0, n_timesteps=2,
                    prompt_extractor=SlowExtractor(), prompt_cache_size=2)
    try:
        def b64_of(seed):
            wav = (np.random.default_rng(seed).standard_normal(2400) * 0.1).astype(np.float32)
            return base64.b64encode(wav_bytes(wav, 24000)).decode()

        def post(b64):
            with _post(srv, "/tts", {"text": TEXT, "lang": "yue", "phone": PHONE,
                                     "ref_audio_b64": b64}) as r:
                r.read()

        a = b64_of(0)
        t1, t2 = threading.Thread(target=post, args=(a,)), threading.Thread(target=post, args=(a,))
        t1.start()
        t2.start()
        time.sleep(0.5)  # both reach the extractor or its waiter before release
        gate.set()
        t1.join(T)
        t2.join(T)
        assert not t1.is_alive() and not t2.is_alive()
        assert calls["n"] == 1
        post(b64_of(1))  # B (cache: A, B)
        post(a)  # hit A (recency: B, A)
        post(b64_of(2))  # C evicts B (cache: A, C)
        n_after = calls["n"]
        post(a)
        assert calls["n"] == n_after
        post(b64_of(1))  # B was evicted
        assert calls["n"] == n_after + 1
    finally:
        srv.close()


def test_body_size_limit_rejected_before_read(server):
    srv, _ = server
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
    try:
        conn.putrequest("POST", "/tts")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(1 << 31))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400 and b"limit" in resp.read()
    finally:
        conn.close()


_SERVE_CHILD = r"""
from jyutvoice_tpu_torch.cli import serve
from jyutvoice_tpu_torch.config import (
    CFMConfig, EstimatorConfig, HiFTConfig, JyutVoiceConfig, TextEncoderConfig, TTSConfig,
)

cfg = JyutVoiceConfig(
    tts=TTSConfig(
        encoder=TextEncoderConfig(n_layers=1, filter_channels=64),
        cfm=CFMConfig(estimator=EstimatorConfig(n_blocks=1, num_mid_blocks=1)),
    ),
    hift=HiFTConfig(base_channels=64),
)
serve.main(["--random-init", "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
            "--n-timesteps", "2", "--max-batch", "2", "--max-wait-ms", "5", "--streaming",
            "--warmup", "--warmup-text", "32", "--warmup-mel", "128"], cfg=cfg)
print("SERVE_DRAINED", flush=True)
"""


def test_cli_serve_drains_on_sigterm():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, "-c", _SERVE_CHILD], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stderr],
                              daemon=True)
    reader.start()
    log = []
    try:
        port = None
        deadline = time.monotonic() + T
        while port is None and time.monotonic() < deadline:
            try:
                line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                break
            log.append(line)
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
        assert port is not None, "".join(log)[-3000:]
        assert any("warmup: 7 shapes" in ln for ln in log), "".join(log)[-3000:]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=T) as r:
            assert json.loads(r.read()) == {"ok": True, "device": "cpu"}
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/tts",
            data=json.dumps({"text": "佢", "lang": "yue", "phone": "keoi5"}).encode())
        with urllib.request.urlopen(req, timeout=T) as r:
            pcm = _pcm(r.read())
        assert len(pcm) > 0 and len(pcm) % 480 == 0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=T) == 0, "".join(log)[-3000:]
        assert "SERVE_DRAINED" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        reader.join(timeout=10)
