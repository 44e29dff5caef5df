"""The port's multi-device paths (`jyutvoice_tpu_torch/dist/`) on the CPU,
against the JAX package's CPU mesh (the conftest's 8 virtual devices) and
against one process.

Sequence parallel (tests/test_sequence_parallel.py's cases): the port's
meshes are 2 and 4 Gloo ranks (this process and follower processes), the
JAX package's the same sizes on its CPU devices; every SP mel is held to
the JAX SP mel and to the single-device "xla_scores" solve at atol 2e-5 /
rtol 1e-4. Tensor parallel (tests/test_tensor_parallel.py's) and the int8
refusal, multihost's env cases, the data-parallel step (2 ranks against one
process on a global batch of unequal lengths, rtol 1e-4, the JAX
tests/test_multihost.py bars) and `cli.train` under two Gloo ranks, and the
serving plumbing (`warmup_long(mesh=)`, `ServingEngine(sp_mesh=)`,
`TTSServer`, `cli.serve --sp-devices`). A process holds one mesh at a
time: `_mesh` keeps the current one and closes it for another.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jyutvoice_tpu import config as jcfg
from jyutvoice_tpu.dist import sp as jsp
from jyutvoice_tpu.models.cfm import cfm_forward as jax_cfm_forward
from jyutvoice_tpu.models.tts import init_tts
from jyutvoice_tpu.weights.noise import rand_noise as jax_rand_noise
from jyutvoice_tpu_torch import config as pcfg
from jyutvoice_tpu_torch.dist import mesh as pmesh
from jyutvoice_tpu_torch.dist import multihost, sp, tp
from jyutvoice_tpu_torch.models import estimator as pest
from jyutvoice_tpu_torch.models import tts as ptts
from jyutvoice_tpu_torch.models.cfm import cfm_forward
from jyutvoice_tpu_torch.weights.from_jax import load_jax_params
from jyutvoice_tpu_torch.weights.noise import rand_noise
from torch_port_dist_ranks import ddp_steps, ring_unit, small_trainer, train_child_source
from torch_port_setup import PORT_CFG, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(atol=2e-5, rtol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(m):
    """tests/test_pipeline.py's TINY in either package."""
    return m.JyutVoiceConfig(tts=m.TTSConfig(
        encoder=m.TextEncoderConfig(n_layers=2, filter_channels=128),
        cfm=m.CFMConfig(estimator=m.EstimatorConfig(n_blocks=1, num_mid_blocks=2)),
    ))


JTINY, PTINY = _tiny(jcfg), _tiny(pcfg)
_MESH = {}


def _mesh(n_seq, n_model=1, tp_only=False):
    """A CPU mesh of n_seq x n_model Gloo ranks (tp_only: a 1-D "model" mesh
    of n_model), kept across tests until another one is asked for."""
    key = (n_seq, n_model, tp_only)
    if key not in _MESH:
        _close_all()
        _MESH[key] = (tp.make_tp_mesh(n_model, devices=["cpu"] * n_model) if tp_only else
                      sp.make_sp_mesh(n_seq, n_model, devices=["cpu"] * (n_seq * n_model)))
    return _MESH[key]


def _close_all():
    for m in _MESH.values():
        m.close()
    _MESH.clear()


@pytest.fixture(scope="module", autouse=True)
def _close_meshes():
    yield
    _close_all()


@pytest.fixture(scope="module")
def setup():
    params = init_tts(jax.random.PRNGKey(0), JTINY.tts)
    dec = load_jax_params(ptts.TTS(PTINY.tts), params).eval().decoder
    rng = np.random.default_rng(0)
    b, t = 1, 64
    arrs = dict(mu=rng.standard_normal((b, t, 80)), mask=np.ones((b, t, 1)),
                spks=rng.standard_normal((b, 80)), cond=rng.standard_normal((b, t, 80)))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    return params, dec, arrs, {}


def _jax_single(setup, key, mask=None, streaming=False, cfm=None):
    """The JAX package's single-device solve (jitted once per case)."""
    params, _, a, cache = setup
    if key not in cache:
        mk = a["mask"] if mask is None else mask
        noise = jnp.asarray(jax_rand_noise(64))
        cache[key] = np.asarray(jax.jit(lambda p, mu, m, s, c: jax_cfm_forward(
            p, cfm or JTINY.tts.cfm, mu, m, s, c, n_timesteps=2, rand_noise=noise,
            streaming=streaming))(params["decoder"], a["mu"], mk, a["spks"], a["cond"]))
    return cache[key]


def _port_single(setup, backend="xla_scores", mask=None, streaming=False, est_cfg=None):
    _, dec, a, _ = setup
    cfg = est_cfg or PTINY.tts.cfm.estimator
    view = pest.with_config(dec, dataclasses.replace(cfg, attention_backend=backend))
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    with torch.inference_mode():
        return cfm_forward(view, PTINY.tts.cfm, t(a["mu"]), t(a["mask"] if mask is None else mask),
                           t(a["spks"]), t(a["cond"]), n_timesteps=2, rand_noise=rand_noise(64),
                           streaming=streaming).numpy()


def _port_sp(setup, mesh, attention="scores", mask=None, streaming=False, cfm=None):
    _, dec, a, _ = setup
    placed = _placed(setup, mesh)
    run = sp.sp_cfm_solve(dec, cfm or PTINY.tts.cfm, mesh, n_timesteps=2, streaming=streaming,
                          attention=attention)
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    out = run(placed, t(a["mu"]), t(a["mask"] if mask is None else mask), t(a["spks"]),
              t(a["cond"]), rand_noise(64))
    assert mesh.last_stats.shape[0] == mesh.size  # every rank solved its shard
    return out.numpy()


def _placed(setup, mesh):
    cache = setup[3]
    if cache.get(("placed", id(mesh))) is None or cache[("mesh", id(mesh))] is not mesh:
        cache[("placed", id(mesh))] = sp.shard_params(setup[1], mesh)
        cache[("mesh", id(mesh))] = mesh
    return cache[("placed", id(mesh))]


# ---------------------------------------------------------------------------
# Sequence parallel: 2 ranks, then 4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_sp_matches_jax_sp_and_single_device(setup, n):
    params, _, a, _ = setup
    jmesh = jsp.make_sp_mesh(n)
    seq = jsp.seq_sharding(jmesh)
    want = np.asarray(jsp.sp_cfm_solve(params["decoder"], JTINY.tts.cfm, jmesh, n_timesteps=2)(
        jax.device_put(params["decoder"], jsp.sp_param_shardings(params["decoder"], jmesh)),
        jax.device_put(a["mu"], seq), jax.device_put(a["mask"], seq), a["spks"],
        jax.device_put(a["cond"], seq), jnp.asarray(jax_rand_noise(64))))
    got = _port_sp(setup, _mesh(n))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _port_single(setup), **TOL)
    np.testing.assert_allclose(got, _jax_single(setup, "plain"), **TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_sp_streaming_chunk_masks(setup, n):
    got = _port_sp(setup, _mesh(n), streaming=True)
    np.testing.assert_allclose(got, _jax_single(setup, "stream", streaming=True), **TOL)
    np.testing.assert_allclose(got, _port_single(setup, streaming=True), **TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_sp_ring_matches_single_device(setup, n):
    got = _port_sp(setup, _mesh(n), attention="ring")
    np.testing.assert_allclose(got, _jax_single(setup, "plain"), **TOL)
    np.testing.assert_allclose(got, _port_single(setup), **TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_sp_ring_with_padding(setup, n):
    """Key validity travels with the rotating blocks: 41 valid of 64 frames
    spans several shards."""
    valid = 41
    mask = (np.arange(64) < valid).astype(np.float32)[None, :, None]
    got = _port_sp(setup, _mesh(n), attention="ring", mask=mask)
    np.testing.assert_allclose(got[:, :valid], _jax_single(setup, "pad", mask=mask)[:, :valid],
                               **TOL)
    np.testing.assert_allclose(got[:, :valid], _port_single(setup, mask=mask)[:, :valid], **TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_sp_banded_matches_single_device(setup, n):
    geo = dict(banded_chunk=16, banded_left=1, banded_right=1)
    jcfm = dataclasses.replace(JTINY.tts.cfm, estimator=dataclasses.replace(
        JTINY.tts.cfm.estimator, attention_backend="banded", **geo))
    pcfm = dataclasses.replace(PTINY.tts.cfm, estimator=dataclasses.replace(
        PTINY.tts.cfm.estimator, **geo))
    mesh = _mesh(n)
    got = _port_sp(setup, mesh, attention="banded", cfm=pcfm)
    np.testing.assert_allclose(got, _jax_single(setup, "banded", cfm=jcfm), **TOL)
    np.testing.assert_allclose(got, _port_single(setup, "banded", est_cfg=pcfm.estimator), **TOL)
    with pytest.raises(ValueError, match="full attention only"):
        sp.sp_cfm_solve(setup[1], pcfm, mesh, n_timesteps=2, attention="banded", streaming=True)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_unit_vs_sdpa(n):
    """dist/ring.py against the dense SDPA core: batched, multi-head, a
    random key-validity length per row."""
    from jyutvoice_tpu_torch.nn import attention, core

    rng = np.random.default_rng(7)
    b, h, t, d = 3, 4, 64, 16
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3))
    lens = [t, 41, 17]
    valid = (np.arange(t)[None, :] < np.array(lens)[:, None])
    mesh = _mesh(n)
    got = mesh.run(ring_unit, q, k, v, valid)
    bias = core.mask_to_bias(torch.from_numpy(valid))[:, None, None, :]
    want = attention.sdpa(*(torch.from_numpy(x) for x in (q, k, v)), bias=bias).numpy()
    for i, m in enumerate(lens):
        np.testing.assert_allclose(got[i, :, :m], want[i, :, :m], atol=2e-6, rtol=1e-5)


def test_sp_rejects_indivisible_t_and_unknown_modes(setup):
    _, dec, a, _ = setup
    mesh = _mesh(4)
    run = sp.sp_cfm_solve(dec, PTINY.tts.cfm, mesh, n_timesteps=2)
    t = lambda x: torch.from_numpy(x[:, :62])  # noqa: E731
    with pytest.raises(ValueError, match="not divisible"):
        run(_placed(setup, mesh), t(a["mu"]), t(a["mask"]), torch.from_numpy(a["spks"]),
            t(a["cond"]), rand_noise(62))
    with pytest.raises(ValueError, match="unknown attention"):
        sp.sp_cfm_solve(dec, PTINY.tts.cfm, mesh, n_timesteps=2, attention="flash")
    with pytest.raises(ValueError, match="streaming chunk masks"):
        sp.sp_cfm_solve(dec, PTINY.tts.cfm, mesh, n_timesteps=2, attention="ring",
                        streaming=True)
    with pytest.raises(ValueError, match="mesh needs 16 devices, only 4 visible"):
        sp.make_sp_mesh(16, devices=["cpu"] * 4)


def test_sp_composes_with_tp(setup):
    """A ("model", "seq") 2 x 2 mesh: TP slices x SP activations; ring is
    refused there."""
    mesh = _mesh(2, 2)
    got = _port_sp(setup, mesh)
    np.testing.assert_allclose(got, _port_single(setup), **TOL)
    np.testing.assert_allclose(got, _jax_single(setup, "plain"), **TOL)
    local = mesh.state[_placed(setup, mesh).key]
    inner = PTINY.tts.cfm.estimator.num_heads * PTINY.tts.cfm.estimator.attention_head_dim
    assert local.mid[0].blocks[0].attn.q.weight.shape[0] == inner // 2  # weights really sliced
    with pytest.raises(ValueError, match="1-D seq meshes"):
        sp.sp_cfm_solve(setup[1], PTINY.tts.cfm, mesh, n_timesteps=2, attention="ring")


# ---------------------------------------------------------------------------
# Tensor parallel
# ---------------------------------------------------------------------------


def test_tp_estimator_matches_single_device(setup):
    _, dec, a, _ = setup
    mesh = _mesh(1, 2, tp_only=True)
    placed = _placed(setup, mesh)
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    got = tp.tp_cfm_solve(dec, PTINY.tts.cfm, mesh, n_timesteps=2)(
        placed, t(a["mu"]), t(a["mask"]), t(a["spks"]), t(a["cond"]), rand_noise(64))
    np.testing.assert_allclose(got.numpy(), _jax_single(setup, "plain"), **TOL)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 64, 80)).astype(np.float32))
    tt = torch.tensor([0.3, 0.7])
    args = (x, torch.ones(2, 64, 1), t(a["mu"]).expand(2, -1, -1), tt,
            t(a["spks"]).expand(2, -1), t(a["cond"]).expand(2, -1, -1))
    with torch.inference_mode():
        want = pest.with_attention_backend(dec, "xla_scores")(*args)
    np.testing.assert_allclose(tp.tp_estimator(placed, *args).numpy(), want.numpy(), **TOL)


def test_tp_cfm_cfg_forces_scores_backend_and_refuses_int8(setup):
    assert PTINY.tts.cfm.estimator.attention_backend == "xla"
    forced = tp.tp_cfm_cfg(PTINY.tts.cfm)
    assert forced.estimator.attention_backend == "xla_scores"
    assert tp.tp_cfm_cfg(forced) is forced
    from jyutvoice_tpu.dist.tp import estimator_partition_specs as jax_specs
    from jyutvoice_tpu.nn.quant import quantize_estimator as jax_quantize
    from jyutvoice_tpu_torch.nn.quant import quantize_estimator

    params = setup[0]
    qdec = load_jax_params(ptts.TTS(PTINY.tts), {
        **params, "decoder": quantize_estimator(params["decoder"])}).decoder
    with pytest.raises(ValueError) as port_err:
        tp.estimator_partition_specs(qdec)
    with pytest.raises(ValueError) as jax_err:
        jax_specs(jax_quantize(params["decoder"]))
    assert str(port_err.value) == str(jax_err.value)
    specs = tp.estimator_partition_specs(setup[1])
    tree = tp.tts_partition_tree(load_jax_params(ptts.TTS(PTINY.tts), params), None)
    assert tree["decoder.mid.0.blocks.0.attn.q.weight"] == ("model", 0)
    assert all(v is None for n, v in tree.items() if not n.startswith("decoder."))
    assert specs["mid.0.blocks.0.attn.q.weight"] == ("model", 0)
    assert specs["mid.0.blocks.0.ff_out.weight"] == ("model", 1)
    assert specs["mid.0.blocks.0.ff_out.bias"] is None and specs["down_conv.weight"] is None


# ---------------------------------------------------------------------------
# The pipeline on a mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def synths():
    from jyutvoice_tpu.models.hift import init_hift
    from jyutvoice_tpu.pipeline.synthesize import Synthesizer as JaxSynthesizer
    from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer

    params = init_tts(jax.random.PRNGKey(0), JTINY.tts)
    params_hift = init_hift(jax.random.PRNGKey(1), JTINY.hift)
    # the sharded solve's single-device counterpart: the "xla_scores" config
    # (f32 scores; on the CPU "auto" is kernel 1's plain version, bf16 products)
    scores = dataclasses.replace(PTINY, tts=dataclasses.replace(PTINY.tts, cfm=tp.tp_cfm_cfg(
        PTINY.tts.cfm)))
    return (Synthesizer(PTINY, params, params_hift, device="cpu"),
            JaxSynthesizer(JTINY, params, params_hift),
            Synthesizer(scores, params, params_hift, device="cpu"))


KW = dict(lang="yue", phone="keoi5 hai6 bin1 go3", n_timesteps=2)


def test_synthesize_long_pipeline_matches_plain_and_sp(synths):
    synth, jsynth, scores = synths
    mesh = _mesh(2)
    single = scores.synthesize_long("佢 係邊 個", **KW)
    plain = scores.synthesize("佢 係邊 個", **KW)
    assert single.mel_frames == plain.mel_frames
    np.testing.assert_allclose(single.mel, plain.mel, atol=1e-3)
    got = synth.synthesize_long("佢 係邊 個", mesh=mesh, **KW)
    assert got.mel_frames == single.mel_frames
    np.testing.assert_allclose(got.mel, single.mel, **TOL)
    assert np.corrcoef(got.wav, single.wav)[0, 1] > 0.9999
    want = jsynth.synthesize_long("佢 係邊 個", mesh=jsp.make_sp_mesh(2), **KW)
    np.testing.assert_allclose(got.mel, want.mel, atol=1e-3)
    assert ("long_sp_dec", mesh) in synth._sp and ("long_sp", mesh, 2, "scores") in synth._sp
    with pytest.raises(ValueError, match="sharded decodes pick sp_attention"):
        synth.synthesize_long("佢", mesh=mesh, attention="exact", **KW)


def test_synthesize_long_cloning_prompt_on_a_mesh(synths):
    synth, _, scores = synths
    rng = np.random.default_rng(5)
    pf = rng.standard_normal((24, 80)).astype(np.float32)
    ph = rng.standard_normal((24, 80)).astype(np.float32)
    kw = dict(KW, prompt_feat=pf, prompt_h=ph)
    single = scores.synthesize_long("佢 係邊 個", **kw)
    np.testing.assert_allclose(single.mel, scores.synthesize("佢 係邊 個", **kw).mel, atol=1e-3)
    for attn in ("scores", "ring"):
        got = synth.synthesize_long("佢 係邊 個", mesh=_mesh(2), sp_attention=attn, **kw)
        assert got.mel_frames == single.mel_frames
        np.testing.assert_allclose(got.mel, single.mel, atol=5e-4, rtol=1e-3,
                                   err_msg=f"sp_attention={attn}")


def test_synthesize_long_pcm16_on_a_mesh(synths):
    synth = synths[0]
    kw = dict(KW, n_timesteps=1, mesh=_mesh(2))
    f32 = synth.synthesize_long("佢 係邊 個", **kw)
    q = synth.synthesize_long("佢 係邊 個", pcm16=True, **kw)
    assert q.wav.dtype == np.float32
    np.testing.assert_allclose(q.wav, f32.wav, atol=1.0 / 32767)


def test_long_frame_granule_and_shapes_match_jax():
    from jyutvoice_tpu.pipeline.synthesize import long_frame_granule as jax_granule
    from jyutvoice_tpu_torch.pipeline.synthesize import long_form_shapes, long_frame_granule

    for n_seq in range(1, 33):
        g = long_frame_granule(n_seq)
        assert g == jax_granule(n_seq) and g % 32 == 0 and g % n_seq == 0
    for n_seq in (1, 2, 3, 4, 6, 8):
        for y_len in (1, 100, 1500, 1537, 4000, 14999, 15000, 20000):
            head, t_mel = long_form_shapes(y_len, True, n_seq=n_seq)
            assert (head + t_mel) % n_seq == 0 and t_mel >= y_len
            assert head == (512 if n_seq in (1, 2, 4, 8) else 1536)


def test_warmup_long_on_a_mesh(synths):
    """warmup_long(mesh=) warms the solve synthesize_long(mesh=) runs, keyed
    on the mesh object, the decoder placed once; sizes the mesh never picks
    are refused before any work (tests/test_pipeline.py:541-560)."""
    synth = synths[0]
    mesh = _mesh(2)
    n = synth.warmup_long(mel_sizes=(128,), text_buckets=(64,), n_timesteps=(1,), mesh=mesh)
    assert n == 2
    assert ("long_sp", mesh, 1, "scores") in synth._sp
    assert ("long_sp_dec", mesh) in synth._sp
    with pytest.raises(ValueError, match="not divisible"):
        synth.warmup_long(mel_sizes=(130,), text_buckets=(), n_timesteps=(1,), mesh=mesh)
    n = synth.warmup_long(mel_sizes=(128,), text_buckets=(), n_timesteps=(1,), mesh=mesh,
                          with_prompt=True, sp_attention="ring")
    assert n == 2 and ("long_sp", mesh, 1, "ring") in synth._sp


def test_engine_long_request_sequence_parallel(synths, monkeypatch):
    """ServingEngine(sp_mesh=...): a long request's solve runs on the mesh
    and matches the single-device long path (tests/test_server.py:332-362)."""
    from jyutvoice_tpu_torch.pipeline.server import ServingEngine

    synth, _, scores = synths
    long_ph = " ".join(["keoi5 hai6 bin1 go3"] * 40)  # > 512 tokens
    long_tx = ("佢係邊個 " * 40).strip()
    # length_scale keeps the solve short; the text alone takes the long route
    want = scores.synthesize_long(long_tx, lang="yue", phone=long_ph, n_timesteps=1,
                                  length_scale=0.1)
    seen = {}
    orig = type(synth).synthesize_long

    def spy(self, text, **kw):
        seen.update(kw)
        return orig(self, text, **kw)

    monkeypatch.setattr(type(synth), "synthesize_long", spy)
    mesh = _mesh(2)
    with ServingEngine(synth, max_batch=2, n_timesteps=1, length_scale=0.1, return_mel=True,
                       sp_mesh=mesh, sp_attention="ring", long_attention="exact") as engine:
        res = engine.submit(long_tx, lang="yue", phone=long_ph).result(timeout=600)
    assert seen["mesh"] is mesh and seen["sp_attention"] == "ring"
    assert seen["attention"] == "auto"  # long_attention is the single-device control
    assert res.mel_frames == want.mel_frames
    np.testing.assert_allclose(res.mel, want.mel, **TOL)


def test_tts_server_plumbs_the_mesh(synths):
    from jyutvoice_tpu_torch.pipeline.http_server import TTSServer

    synth = synths[0]
    sentinel = object()
    srv = TTSServer(synth, port=0, max_batch=2, max_wait_ms=5.0, n_timesteps=2,
                    sp_mesh=sentinel, sp_attention="ring", long_attention="exact")
    try:
        assert srv.engine.sp_mesh is sentinel
        assert srv.engine.sp_attention == "ring"
        assert srv.engine.long_attention == "exact"
    finally:
        srv.close()
    srv = TTSServer(synth, port=0, max_batch=2, max_wait_ms=5.0, n_timesteps=2)
    try:
        assert srv.engine.sp_mesh is None
    finally:
        srv.close()


@pytest.mark.parametrize("n,match", [(1, "must be >= 2"), (2, "only 0 device")])
def test_cli_serve_refuses_sp_devices(n, match):
    from jyutvoice_tpu_torch.cli import serve

    with pytest.raises(SystemExit, match=match):
        serve.main(["--random-init", "--device", "cpu", "--port", "0", "--sp-devices", str(n)],
                   cfg=PORT_CFG)


# ---------------------------------------------------------------------------
# Multihost and the data mesh
# ---------------------------------------------------------------------------


def _clear_env(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)


def test_single_process_noop(monkeypatch):
    _clear_env(monkeypatch)
    called = []
    monkeypatch.setattr(torch.distributed, "init_process_group", lambda *a, **k: called.append(k))
    assert multihost.init_distributed(device="cpu") is False
    assert multihost.init_distributed(num_processes=1, device="cpu") is False
    assert called == []


def test_env_vars_trigger_initialize(monkeypatch):
    _clear_env(monkeypatch)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "8476")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("LOCAL_RANK", "2")
    called = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **k: called.append((backend, k)))
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    assert multihost.init_distributed(device="cpu") is True
    backend, kw = called[0]
    assert backend == "gloo"  # the CPU's backend: never probed
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == ("tcp://10.0.0.1:8476", 4, 2)
    assert multihost.backend_for("cuda") == "nccl"
    assert multihost.rank_device("cuda") == torch.device("cuda", 2)
    assert multihost.rank_device("cuda:0") == torch.device("cuda", 0)


def test_global_batch_sharding_single_process(monkeypatch):
    _clear_env(monkeypatch)
    _close_all()  # no process group: this process alone
    mesh, sharding = multihost.global_batch_sharding()
    assert mesh.size == 1 and sharding.rows(6) == slice(0, 6)
    batch = {"x": np.arange(6)}
    assert (pmesh.shard_batch(batch, mesh)["x"] == batch["x"]).all()
    with pytest.raises(ValueError, match="only 1 device"):
        pmesh.make_mesh(2)


def _ddp_batch():
    from jyutvoice_tpu_torch.train.datamodule import DataConfig, TextMelDataModule, dummy_rows

    dm = TextMelDataModule(dummy_rows(8, seed=0, mel_frames=(40, 90)), DataConfig(batch_size=4,
                                                                                  seed=0))
    batch = next(iter(dm.train_batches(0)))
    assert len(set(batch["y_lengths"].tolist())) == 4  # unequal lengths
    return batch


def test_ddp_step_matches_one_process(monkeypatch):
    """Two Gloo ranks, each on its half of a global batch of 4 unequal rows,
    take the step one process takes on the whole batch: losses, gradients,
    grad_norm and the updated parameters at rtol 1e-4; every rank ends
    with the same parameters; the frozen decoder is unchanged. The step
    keeps the estimator's kernel route (no "xla_scores" rewrite), so on the
    card it runs kernels 3-5 at T >= 2048."""
    routes = []
    orig = pest.attention_route

    def spy(cfg, t, chunk, attention="auto", on_cuda=True, training=False):
        routes.append((cfg.attention_backend, training))
        return orig(cfg, t, chunk, attention, on_cuda, training)

    monkeypatch.setattr(pest, "attention_route", spy)
    batch = _ddp_batch()
    one = small_trainer(PORT_CFG, 0)
    start = {n: p.detach().clone() for n, p in one.model.named_parameters()}
    m1, g1 = one.gradients(batch)
    one.generator.manual_seed(0)
    hist1 = [{k: float(v) for k, v in one.step(batch).items()} for _ in range(2)]
    _close_all()
    with pmesh.Mesh.spawn(("data",), (2,), ["cpu"] * 2) as mesh:
        (m2, g2), hist2, params2, sums, frozen = mesh.run(ddp_steps, PORT_CFG, 0, batch, 2)
    for k in m1:
        np.testing.assert_allclose(m2[k], float(m1[k]), rtol=1e-4)
    for a, b in zip(g2, g1):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-4, atol=1e-6)
    for h2, h1 in zip(hist2, hist1):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(h2[k], h1[k], rtol=1e-4)
    for a, b in zip(params2, one.params):
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=1e-4, atol=1e-7)
    assert sums[0] == sums[1]  # every rank holds the same parameters
    for n, p in frozen.items():
        assert np.array_equal(p, start[n].numpy()), n
    assert routes and all(r == ("xla", True) for r in routes)
    est_cfg = PORT_CFG.tts.cfm.estimator
    assert orig(est_cfg, 2048, 0, on_cuda=True, training=True) == "flash_stock"


def test_cli_train_under_two_gloo_ranks(tmp_path):
    """`cli.train` as two torchrun-style processes (MASTER_ADDR / WORLD_SIZE
    / RANK) against one process: the same losses and grad norm at each of
    2 steps (global batch 4 of unequal lengths), rank 0 alone writes the
    checkpoint, each rank its report."""
    from jyutvoice_tpu_torch.cli import train

    # 9 rows: 8 train (two full batches of 4, no tail to pad) and 1 validates
    argv = ["--device", "cpu", "--dummy", "--dummy-rows", "9", "--dummy-mel", "40,90",
            "--batch-size", "4", "--max-steps", "2", "--log-every", "1"]
    one = train.main(argv + ["--ckpt-dir", str(tmp_path / "one")], cfg=PORT_CFG)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", WORLD_SIZE="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        env["MASTER_PORT"] = str(s.getsockname()[1])
    ddp_argv = argv + ["--ckpt-dir", str(tmp_path / "two"),
                       "--report", str(tmp_path / "rank{rank}.json")]
    procs = [subprocess.Popen([sys.executable, "-c", train_child_source(ddp_argv)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    reports = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    for rep in reports:
        assert rep["step"] == 2 and rep["world"] == 2
        for k in ("loss", "dur_loss", "prior_loss", "diff_loss", "grad_norm"):
            np.testing.assert_allclose(rep["metrics"][k], one["metrics"][k], rtol=1e-4)
    assert "step 2 | loss" in logs[0] and "step 2 | loss" not in logs[1]  # rank 0 logs
    assert os.listdir(tmp_path / "two")
