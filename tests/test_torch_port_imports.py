"""The port stands alone: no module of `jyutvoice_tpu_torch`, and not
`chip_smoke.py`, imports JAX or the JAX package or names a path into it, the
port reads its own copy of the LTS rule table (and of the modules it copies
byte for byte), and it synthesizes, streams, trains, clones a voice,
serves (the batching engine and the HTTP server), serves an int8 estimator,
warms the long-form shapes, runs the host MAS, trains the LTS and exports
and reloads a bucket graph in a process where JAX and the JAX package are
import-blocked."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "jyutvoice_tpu_torch")


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "jyutvoice_tpu")


@pytest.mark.parametrize(
    "path", sorted(_port_sources()), ids=lambda p: os.path.relpath(p, REPO)
)
def test_no_jax_imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{os.path.relpath(path, REPO)}:{node.lineno} imports {bad}"


def _docstrings(tree):
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant):
            yield body[0].value


@pytest.mark.parametrize(
    "path", sorted(_port_sources()), ids=lambda p: os.path.relpath(p, REPO)
)
def test_no_paths_into_the_jax_package(path):
    """No string in the code names the JAX package's directory, so nothing
    builds a path into it. Docstrings and chip_smoke.py's `replaces=` labels
    (which name the TPU kernel a kernel replaces) are text, not paths."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    docs = {id(d) for d in _docstrings(tree)}
    docs |= {id(n.value) for n in ast.walk(tree)
             if isinstance(n, ast.keyword) and n.arg == "replaces"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            v = node.value
            assert not (v == "jyutvoice_tpu" or "jyutvoice_tpu/" in v
                        or "jyutvoice_tpu" + os.sep in v), \
                f"{os.path.relpath(path, REPO)}:{node.lineno} names {v!r}"


def test_lts_model_is_the_ports_own_copy():
    from jyutvoice_tpu_torch.text import lts

    path = os.path.realpath(lts.MODEL_PATH)
    assert path.startswith(os.path.realpath(PORT) + os.sep)
    jax_copy = os.path.join(REPO, "jyutvoice_tpu", "text", "data", "lts_model.pkl.gz")
    with open(path, "rb") as a, open(jax_copy, "rb") as b:
        assert a.read() == b.read()
    assert lts.load_model(path)["rules"]


_CHILD = r"""
import sys


class _Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "jyutvoice_tpu"):
            raise ImportError(f"blocked for this test ({name})")
        return None


sys.meta_path.insert(0, _Block())

import numpy as np

from jyutvoice_tpu_torch.config import (
    CFMConfig, EstimatorConfig, HiFTConfig, JyutVoiceConfig, TextEncoderConfig, TTSConfig,
)
from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer
from jyutvoice_tpu_torch.weights.random_init import init_hift_tree, init_tts_tree

cfg = JyutVoiceConfig(
    tts=TTSConfig(
        encoder=TextEncoderConfig(n_layers=1, filter_channels=64),
        cfm=CFMConfig(estimator=EstimatorConfig(n_blocks=1, num_mid_blocks=1)),
    ),
    hift=HiFTConfig(base_channels=64),
)
s = Synthesizer(cfg, init_tts_tree(cfg.tts), init_hift_tree(cfg.hift), device="cpu")
r = s.synthesize("佢", lang="yue", phone="keoi5", n_timesteps=2)
assert r.wav.shape == (r.mel_frames * 480,) and np.isfinite(r.wav).all()
assert not any(m.split(".")[0] in ("jax", "jyutvoice_tpu") for m in sys.modules)
print("PORT_STANDALONE_OK", r.wav.shape[0])
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD], env=env, capture_output=True, timeout=600,
        text=True, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "PORT_STANDALONE_OK" in proc.stdout


_TRAIN_CHILD = _CHILD.split("s = Synthesizer(")[0] + r"""
import tempfile

from jyutvoice_tpu_torch.cli import train

with tempfile.TemporaryDirectory() as d:
    out = train.main(["--device", "cpu", "--dummy", "--dummy-rows", "6", "--batch-size", "2",
                      "--max-steps", "2", "--ckpt-dir", d], cfg=cfg)
assert out["step"] == 2 and np.isfinite(out["metrics"]["loss"])
assert not any(m.split(".")[0] in ("jax", "jyutvoice_tpu") for m in sys.modules)
print("PORT_TRAINS_STANDALONE_OK", out["metrics"]["loss"])
"""


def test_port_trains_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _TRAIN_CHILD], env=env, capture_output=True, timeout=600,
        text=True, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "PORT_TRAINS_STANDALONE_OK" in proc.stdout


@pytest.mark.parametrize("rel", ["audio/resample.py", "weights/onnx_reader.py", "align/mas.cpp"])
def test_byte_for_byte_copies(rel):
    """Modules the port copies unchanged from the JAX package (numpy and the
    standard library only, and the host MAS's C++ source) stay identical to
    their originals."""
    with open(os.path.join(PORT, rel), "rb") as a, \
            open(os.path.join(REPO, "jyutvoice_tpu", rel), "rb") as b:
        assert a.read() == b.read()


_CLONE_CHILD = _CHILD.split("s = Synthesizer(")[0] + r"""
from jyutvoice_tpu_torch.config import FlowEncoderConfig
from jyutvoice_tpu_torch.models.campplus import CampPlusConfig
from jyutvoice_tpu_torch.models.s3_tokenizer import S3TokenizerConfig
from jyutvoice_tpu_torch.pipeline import prompt
from jyutvoice_tpu_torch.weights import random_init

fe = FlowEncoderConfig(input_size=64, output_size=64, attention_heads=2, linear_units=128,
                       num_blocks=2, num_up_blocks=1)
cp = CampPlusConfig(num_layers=(2, 2, 2))
s3 = S3TokenizerConfig(n_audio_ctx=256, n_audio_state=64, n_audio_head=4, n_audio_layer=2)
# reduced CAM++ and S3: the extractor builds them at its default configs
prompt.CampPlusConfig, prompt.S3TokenizerConfig = lambda: cp, lambda: s3
ex = prompt.PromptExtractor(
    flow_encoder_params=random_init.init_flow_encoder_tree(fe), flow_encoder_cfg=fe,
    campplus_params=random_init.init_campplus_tree(cp),
    tokenizer_params=random_init.init_s3_tree(s3), device="cpu")
t = np.arange(22050) / 22050
f = ex((0.3 * np.sin(2 * np.pi * 150 * t)).astype(np.float32), 22050)
assert f.prompt_h.shape == f.prompt_feat.shape and f.spk_embed.shape == (192,)
s = Synthesizer(cfg, init_tts_tree(cfg.tts), init_hift_tree(cfg.hift), device="cpu")
r = s.synthesize("佢", lang="yue", phone="keoi5", n_timesteps=2, spk_embed=f.spk_embed,
                 prompt_feat=f.prompt_feat, prompt_h=f.prompt_h)
assert r.wav.shape == (r.mel_frames * 480,) and np.isfinite(r.wav).all()
assert not any(m.split(".")[0] in ("jax", "jyutvoice_tpu") for m in sys.modules)
print("PORT_CLONES_STANDALONE_OK", f.prompt_feat.shape[0])
"""


def test_port_clones_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _CLONE_CHILD], env=env, capture_output=True, timeout=600,
        text=True, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "PORT_CLONES_STANDALONE_OK" in proc.stdout


_STREAM_CHILD = _CHILD.split("s = Synthesizer(")[0] + r"""
from jyutvoice_tpu_torch.config import FlowEncoderConfig
from jyutvoice_tpu_torch.models.flow_encoder import FlowEncoder
from jyutvoice_tpu_torch.pipeline.streaming import MultiStreamSynthesizer, StreamingTokenEncoder
from jyutvoice_tpu_torch.weights import from_jax, random_init

s = Synthesizer(cfg, init_tts_tree(cfg.tts), init_hift_tree(cfg.hift), device="cpu")
chunks = list(s.synthesize_streaming("佢係邊個", phone="keoi5 hai6 bin1 go3", chunk_frames=50,
                                     n_timesteps=2, length_scale=3.0))
assert len(chunks) >= 2 and all(np.isfinite(c).all() for c in chunks)
mu_y, c, y_len = s.prepare_stream("佢", phone="keoi5")
ms = MultiStreamSynthesizer(cfg, s.tts, s.hift, max_sessions=2, chunk_frames=50, n_timesteps=2,
                            device="cpu")
out = ms.run_all([(mu_y, c)])
assert out[0].shape == (y_len * 480,)
fe = FlowEncoderConfig(input_size=64, output_size=64, attention_heads=2, linear_units=128,
                       num_blocks=2, num_up_blocks=1)
enc = StreamingTokenEncoder(from_jax.load_jax_params(
    FlowEncoder(fe), random_init.init_flow_encoder_tree(fe)).eval(), t_max_tokens=64)
h = np.concatenate([enc.push(np.arange(40) % 300), enc.flush()])
assert h.shape == (80, 80) and np.isfinite(h).all()
assert not any(m.split(".")[0] in ("jax", "jyutvoice_tpu") for m in sys.modules)
print("PORT_STREAMS_STANDALONE_OK", len(chunks))
"""


def test_port_streams_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _STREAM_CHILD], env=env, capture_output=True, timeout=600,
        text=True, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "PORT_STREAMS_STANDALONE_OK" in proc.stdout


_SERVE_CHILD = _CHILD.split("s = Synthesizer(")[0] + r"""
import json
import urllib.request
import wave
from io import BytesIO

from jyutvoice_tpu_torch.pipeline import ServingEngine
from jyutvoice_tpu_torch.pipeline.http_server import TTSServer

s = Synthesizer(cfg, init_tts_tree(cfg.tts), init_hift_tree(cfg.hift), device="cpu")
with ServingEngine(s, max_batch=2, max_wait_ms=5.0, n_timesteps=2) as engine:
    r = engine.submit("佢", lang="yue", phone="keoi5").result(timeout=120)
assert r.wav.shape == (r.mel_frames * 480,) and np.isfinite(r.wav).all()
with TTSServer(s, port=0, max_batch=2, max_wait_ms=5.0, n_timesteps=2) as srv:
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/tts",
        data=json.dumps({"text": "佢", "lang": "yue", "phone": "keoi5"}).encode())
    with urllib.request.urlopen(req, timeout=120) as resp:
        with wave.open(BytesIO(resp.read()), "rb") as f:
            assert f.getnframes() == r.mel_frames * 480
assert not any(m.split(".")[0] in ("jax", "jyutvoice_tpu") for m in sys.modules)
print("PORT_SERVES_STANDALONE_OK", r.mel_frames)
"""


def test_port_serves_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _SERVE_CHILD], env=env, capture_output=True, timeout=600,
        text=True, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "PORT_SERVES_STANDALONE_OK" in proc.stdout


_SLICE11_CHILD = _CHILD.split("s = Synthesizer(")[0] + r"""
from jyutvoice_tpu_torch import align
from jyutvoice_tpu_torch.nn.quant import QuantLinear, quantize_estimator
from jyutvoice_tpu_torch.text import lts

tts = init_tts_tree(cfg.tts)
s = Synthesizer(cfg, {**tts, "decoder": quantize_estimator(tts["decoder"])},
                init_hift_tree(cfg.hift), device="cpu")
assert isinstance(s.tts.decoder.up.blocks[0].attn.o, QuantLinear)
r = s.synthesize("佢", lang="yue", phone="keoi5", n_timesteps=2)
assert r.wav.shape == (r.mel_frames * 480,) and np.isfinite(r.wav).all()
assert s.warmup_long(mel_sizes=(128,), text_buckets=(32,), n_timesteps=(1,)) == 2
value = np.random.default_rng(0).standard_normal((2, 5, 9)).astype(np.float32)
mask = np.ones((2, 5, 9), np.float32)
mask[1, 3:] = 0
mask[1, :, 6:] = 0
path = align.maximum_path_host(value, mask)
assert (path.sum(axis=1) == mask[:, 0]).all()
model, held = lts.train({"CAT": [["K", "AE1", "T"]], "CATS": [["K", "AE1", "T", "S"]],
                         "TACK": [["T", "AE1", "K"]]}, iterations=1)
assert model["rules"] and held == []
assert not any(m.split(".")[0] in ("jax", "jyutvoice_tpu") for m in sys.modules)
print("PORT_SLICE11_STANDALONE_OK", r.mel_frames)
"""


def test_int8_host_mas_warmup_long_and_lts_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _SLICE11_CHILD], env=env, capture_output=True, timeout=600,
        text=True, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "PORT_SLICE11_STANDALONE_OK" in proc.stdout


_EXPORT_CHILD = _CHILD.split("s = Synthesizer(")[0] + r"""
import os
import tempfile

import torch

from jyutvoice_tpu_torch.pipeline import serving

tts, hift = init_tts_tree(cfg.tts), init_hift_tree(cfg.hift)
args = serving.example_args(16, 0)
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "bucket.pt2")
    serving.export_program(cfg, tts, hift, path, t_text=16, t_mel=32, n_timesteps=1,
                           device="cpu")
    wav, mel, lengths = serving.load_program(path)(*args)
want = serving.build_serving_fn(serving.export_safe_cfg(cfg), tts, hift, t_text=16, t_mel=32,
                                n_timesteps=1, device="cpu")(*args)
assert torch.equal(lengths, want[2]) and float((wav - want[0]).abs().max()) <= 1e-6
assert wav.shape == (1, 32 * 480) and bool(torch.isfinite(wav).all())
assert not any(m.split(".")[0] in ("jax", "jyutvoice_tpu") for m in sys.modules)
print("PORT_EXPORTS_STANDALONE_OK", int(lengths[0]))
"""


def test_port_exports_and_reloads_a_bucket_with_jax_blocked():
    """export_program, load_program and a call of the reloaded bucket graph
    in a process where JAX and the JAX package cannot be imported."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _EXPORT_CHILD], env=env, capture_output=True, timeout=600,
        text=True, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "PORT_EXPORTS_STANDALONE_OK" in proc.stdout


_DIST_CHILD = _CHILD.split("s = Synthesizer(")[0] + r"""
import torch

from jyutvoice_tpu_torch import dist
from jyutvoice_tpu_torch.dist import sp
from jyutvoice_tpu_torch.models import tts as tts_mod
from jyutvoice_tpu_torch.weights.from_jax import load_jax_params
from jyutvoice_tpu_torch.weights.noise import rand_noise

dec = load_jax_params(tts_mod.TTS(cfg.tts), init_tts_tree(cfg.tts)).decoder
with dist.make_sp_mesh(1, devices=["cpu"], backend="gloo") as mesh:
    assert mesh.shape == {"seq": 1} and mesh.backend == "gloo"
    placed = dist.shard_params(dec, mesh)
    mu = torch.randn(1, 32, 80)
    mel = dist.sp_cfm_solve(dec, cfg.tts.cfm, mesh, n_timesteps=1)(
        placed, mu, torch.ones(1, 32, 1), torch.randn(1, 80), torch.zeros_like(mu), rand_noise(32))
assert mel.shape == (1, 32, 80) and bool(torch.isfinite(mel).all())
assert not any(m.split(".")[0] in ("jax", "jyutvoice_tpu") for m in sys.modules)
print("PORT_DIST_STANDALONE_OK", tuple(mel.shape))
"""


def test_dist_builds_a_gloo_mesh_with_jax_blocked():
    """`jyutvoice_tpu_torch.dist` imports, builds a 1-rank Gloo mesh and
    solves on it in a process where JAX and the JAX package cannot be
    imported."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _DIST_CHILD], env=env, capture_output=True, timeout=600,
        text=True, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "PORT_DIST_STANDALONE_OK" in proc.stdout
