"""The port's serving export (`pipeline/serving.py`) and its two repairs,
on the CPU at the small configuration.

  * `build_serving_fn` against the JAX package's, jitted, on the same trees
    and inputs: lengths equal, mel MAE < 1e-2, wav atol 1e-4 (the bars of
    test_torch_port_e2e.py: the port's kernel-1 plain version rounds its
    products' inputs to bf16, the JAX CPU path stays f32);
  * `aot_compile` against the reloaded `export_program` artifact: atol 1e-6
    and lengths equal where both take plain attention (the export's), and
    the e2e bars where the program keeps the config's kernel-1 route;
  * the export traces on plain attention and leaves the caller's config as
    it is; its graph holds kernel 2 as one `jyutvoice.resblock_stage` node
    per kernel-2 stage and nothing else of the port's kernels;
  * the op passes `torch.library.opcheck` and equals the plain version;
  * `BucketProgram` raises on inputs of another shape, dtype or count and
    returns fresh tensors;
  * graphs built on already built modules share them and compute what a
    graph with its own copies computes; `hift.keep_constants` collects the
    cached constants a vocoder call reads;
  * the prompt graft on the device equals the host loop it replaced, bit
    for bit, and the whole `synthesize_mel` at batch 2 JAX's;
  * an export run before any eager call leaves no FakeTensor in a cache;
  * an int8 decoder tree exports: the trace takes the int8 linear's plain
    composition (`torch._int_mm` nodes, no kernel launch) and the reloaded
    artifact equals the eager graph.
One export of the 2-step bucket serves the whole file.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jyutvoice_tpu.models import tts as jtts
from jyutvoice_tpu.pipeline import serving as jserving
from jyutvoice_tpu.weights.noise import rand_noise as jax_rand_noise
from jyutvoice_tpu_torch.models import estimator as pest
from jyutvoice_tpu_torch.models import hift as phift
from jyutvoice_tpu_torch.models import tts as ptts
from jyutvoice_tpu_torch.nn import attention as pattention
from jyutvoice_tpu_torch.nn import resblock_stage as rs
from jyutvoice_tpu_torch.pipeline import serving
from jyutvoice_tpu_torch.weights.from_jax import load_jax_params
from jyutvoice_tpu_torch.weights.noise import rand_noise
from torch_port_setup import JAX_CFG, PORT_CFG, jax_trees, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_TEXT, T_MEL, STEPS = 32, 128, 2
WAV_ATOL = 1e-4
OP = torch.ops.jyutvoice.resblock_stage.default


def _inputs(seed=0, t_prompt=0, p_len=0, n=24):
    """The ten batch-1 inputs as numpy arrays: random ids up to length n,
    a random speaker, a p_len-frame prompt pair padded to t_prompt."""
    rng = np.random.default_rng(seed)

    def ids(hi):
        a = np.zeros((1, T_TEXT), np.int32)
        a[0, :n] = rng.integers(1 if hi == 97 else 0, hi, n)
        return a

    pf = np.zeros((1, t_prompt, 80), np.float32)
    ph = np.zeros((1, t_prompt, 80), np.float32)
    pf[0, :p_len] = rng.standard_normal((p_len, 80))
    ph[0, :p_len] = rng.standard_normal((p_len, 80))
    return (ids(97), np.array([n], np.int32), ids(4), ids(7), ids(4), ids(4),
            rng.standard_normal((1, 192)).astype(np.float32), pf, ph,
            np.array([p_len], np.int32))


def _t(args):
    return tuple(torch.from_numpy(a) for a in args)


@pytest.fixture(scope="module")
def trees():
    return jax_trees()


@pytest.fixture(scope="module")
def exported(trees, tmp_path_factory):
    """The 2-step bucket exported once, with every estimator routing
    decision recorded and kernel 1's wrapper made to raise."""
    seen = []
    route = pest.attention_route

    def spy(cfg, *a, **k):
        out = route(cfg, *a, **k)
        seen.append((cfg.attention_backend, out))
        return out

    def no_kernel_1(*a, **k):
        raise AssertionError("the export reached kernel 1")

    path = str(tmp_path_factory.mktemp("serving") / "bucket.pt2")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pest, "attention_route", spy)
        mp.setattr(pattention, "flash_attention", no_kernel_1)
        program = serving.export_program(PORT_CFG, *trees, path, t_text=T_TEXT, t_mel=T_MEL,
                                         n_timesteps=STEPS, device="cpu")
    return program, path, seen


@pytest.mark.parametrize("t_prompt,p_len", [(0, 0), (64, 40)])
def test_serving_fn_matches_jax(trees, t_prompt, p_len):
    tt, th = trees
    args = _inputs(1, t_prompt, p_len)
    fn = jserving.build_serving_fn(JAX_CFG, tt, th, t_text=T_TEXT, t_mel=T_MEL,
                                   t_prompt=t_prompt, n_timesteps=STEPS)
    ref = [np.asarray(a) for a in jax.jit(fn)(*(jnp.asarray(a) for a in args))]
    graph = serving.build_serving_fn(PORT_CFG, tt, th, t_text=T_TEXT, t_mel=T_MEL,
                                     t_prompt=t_prompt, n_timesteps=STEPS, device="cpu")
    assert not graph.training and not any(p.requires_grad for p in graph.parameters())
    with torch.inference_mode():
        wav, mel, lengths = (o.numpy() for o in graph(*_t(args)))
    np.testing.assert_array_equal(lengths, ref[2])
    n = int(ref[2][0])
    assert 0 < n < T_MEL
    assert np.abs(mel - ref[1]).mean() < 1e-2
    np.testing.assert_allclose(wav, ref[0], atol=WAV_ATOL)


def test_serving_aot_and_export(trees, exported):
    """The bucket program against the reloaded artifact: at 1e-6 where both
    take plain attention, at the e2e bars where the program keeps kernel
    1's route (its plain version on the CPU, bf16 products)."""
    _, path, _ = exported
    args = _t(_inputs(2))
    reloaded = serving.load_program(path)
    wav2, mel2, lens2 = reloaded(*args)
    assert type(wav2) is torch.Tensor and bool(torch.isfinite(wav2).all())
    plain = serving.aot_compile(serving.export_safe_cfg(PORT_CFG), *trees, t_text=T_TEXT,
                                t_mel=T_MEL, n_timesteps=STEPS, device="cpu")
    wav, mel, lens = plain(*args)
    torch.testing.assert_close(wav, wav2, atol=1e-6, rtol=0)
    torch.testing.assert_close(mel, mel2, atol=1e-6, rtol=0)
    assert torch.equal(lens, lens2)
    kernel = serving.aot_compile(PORT_CFG, *trees, t_text=T_TEXT, t_mel=T_MEL,
                                 n_timesteps=STEPS, device="cpu")
    wav1, mel1, lens1 = kernel(*args)
    assert torch.equal(lens1, lens2)
    assert float((mel1 - mel2).abs().mean()) < 1e-2
    torch.testing.assert_close(wav1, wav2, atol=WAV_ATOL, rtol=0)
    assert kernel.replays == 1 and kernel.launches == {}


def test_export_forces_plain_attention(exported):
    """The export traces with attention_backend "xla_scores" (plain
    attention, never kernel 1) and leaves the caller's config as it was."""
    _, _, seen = exported
    assert seen and set(seen) == {("xla_scores", "plain")}
    assert PORT_CFG.tts.cfm.estimator.attention_backend == "xla"
    assert serving.export_safe_cfg(PORT_CFG) is not PORT_CFG
    safe = serving.export_safe_cfg(PORT_CFG)
    assert serving.export_safe_cfg(safe) is safe


def test_exported_graph_holds_kernel_2_as_op_nodes(exported):
    program, path, _ = exported
    stages = phift.HiFT(PORT_CFG.hift).kernel_stages
    assert len(stages) == 3  # C = 32, 16, 8
    for graph in (program.graph, torch.export.load(path).graph):
        ours = [n.target for n in graph.nodes if n.op == "call_function"
                and getattr(n.target, "namespace", None) == "jyutvoice"]
        assert ours == [OP] * len(stages)


def _stage(c=16, ks=(3, 7, 11), dil=(1, 3, 5), seed=0):
    g = torch.Generator().manual_seed(seed)
    n = sum(len(dil) * (2 * k * c * c + 4 * c) for k in ks)
    w = torch.randn(n, generator=g) * 0.05
    return rs.prepare_stage_weights(w, c, ks, dil)


def test_resblock_stage_op_opcheck_and_plain():
    stage = _stage()
    x = torch.randn(2, 50, 16, generator=torch.Generator().manual_seed(1))
    args = (x, stage.flat, stage.tiles, stage.params, list(stage.kernel_sizes),
            list(stage.dilations))
    torch.library.opcheck(OP, args)
    want = rs.resblock_stage_plain(x, stage.flat, kernel_sizes=stage.kernel_sizes,
                                   dilations=stage.dilations)
    for got in (OP(*args), rs.resblock_stage_prepared(x, stage)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="layout"):
        rs.resblock_stage_prepared(torch.zeros(1, 20, 8), stage)


def test_hift_reaches_kernel_2_only_through_the_op(trees, monkeypatch):
    """Every kernel-2 stage of a vocoder call goes through the op (on the
    CPU too), with the stage's prepared buffers; re-preparation after an
    in-place weight change still happens."""
    _, th = trees
    hift = load_jax_params(phift.HiFT(PORT_CFG.hift), th).eval()
    calls = []
    real = rs.resblock_stage_op

    def spy(x, flat, tiles, params, ks, dil):
        calls.append((x.shape[-1], tiles.data_ptr()))
        return real(x, flat, tiles, params, ks, dil)

    monkeypatch.setattr(rs, "resblock_stage_op", spy)
    mel = torch.randn(1, 20, 80, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        phift.hift_inference(hift, mel)
        assert [c for c, _ in calls] == [32, 16, 8]
        first = [p for _, p in calls]
        phift.hift_inference(hift, mel)
        assert [p for _, p in calls[3:]] == first  # cached
        hift.resblocks[0].convs1[0].weight.mul_(1.5)
        phift.hift_inference(hift, mel)
    assert calls[6][1] != first[0] and [p for _, p in calls[7:]] == first[1:]


def test_bucket_program_contract(trees):
    prog = serving.aot_compile(PORT_CFG, *trees, t_text=T_TEXT, t_mel=T_MEL, n_timesteps=1,
                               device="cpu")
    a, b = _t(_inputs(3)), _t(_inputs(4))
    out1 = prog(*a)
    keep = [o.clone() for o in out1]
    out2 = prog(*b)
    assert prog.replays == 2
    assert all(torch.equal(o, k) for o, k in zip(out1, keep))
    assert not torch.equal(out1[1], out2[1])
    assert all(o.data_ptr() != p.data_ptr() for o, p in zip(out1, out2))
    with pytest.raises(ValueError, match="input x:"):
        prog(torch.zeros((1, T_TEXT + 1), dtype=torch.int32), *a[1:])
    with pytest.raises(ValueError, match="input spk_embed:"):
        prog(*a[:6], a[6].double(), *a[7:])
    with pytest.raises(ValueError, match="input prompt_feat:"):
        prog(*a[:7], torch.zeros((1, 64, 80)), *a[8:])
    with pytest.raises(TypeError):
        prog(*a[:9])
    assert prog.replays == 2


def test_serving_graph_shares_built_modules(trees):
    """A graph built on already built TTS / HiFT modules holds those very
    modules (no copy of the weights) and equals a graph loaded from the
    trees; modules built on another config are refused."""
    tt, th = trees
    tts = load_jax_params(ptts.TTS(PORT_CFG.tts), tt).eval()
    hift = load_jax_params(phift.HiFT(PORT_CFG.hift), th).eval()
    kw = dict(t_text=T_TEXT, t_mel=T_MEL, n_timesteps=1, device="cpu")
    shared = [serving.build_serving_fn(PORT_CFG, tts, hift, **kw) for _ in range(2)]
    assert all(g.tts is tts and g.hift is hift for g in shared)
    own = serving.build_serving_fn(PORT_CFG, tt, th, **kw)
    args = _t(_inputs(8))
    with torch.inference_mode():
        for got, want in zip(shared[0](*args), own(*args)):
            assert torch.equal(got, want)
    with pytest.raises(ValueError, match="config"):
        serving.build_serving_fn(serving.export_safe_cfg(PORT_CFG), tts, hift, **kw)


def test_keep_constants_collects_what_a_vocoder_call_reads(trees):
    """Inside `keep_constants`, a vocoder call hands the list every cached
    STFT table it reads and every kernel stage's prepared buffers, so they
    outlive an eviction from the cache; outside, nothing is collected."""
    _, th = trees
    hift = load_jax_params(phift.HiFT(PORT_CFG.hift), th).eval()
    mel = torch.randn(1, 20, 80, generator=torch.Generator().manual_seed(9))
    read = []
    on_device = phift._on_device

    def spy(make, args, device):
        out = on_device(make, args, device)
        read.extend(out)
        return out

    with torch.inference_mode(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(phift, "_on_device", spy)
        with phift.keep_constants() as kept:
            phift.hift_inference(hift, mel)
        phift.hift_inference(hift, mel)
    phift._to_device_cached.cache_clear()
    ids = {id(t) for t in kept}
    assert read and all(id(t) in ids for t in read[: len(read) // 2])
    stages = [getattr(hift, f"stage{i}_{part}") for i in hift.kernel_stages
              for part in ("flat", "tiles", "params")]
    assert all(id(t) in ids for t in stages)
    assert len(kept) == len(read) // 2 + len(stages)


def _host_loop_graft(mu_y, prompt_feat, prompt_h, plens):
    """The graft as synthesize_mel computed it before, with the prompt
    lengths read on the host (in-range offsets only)."""
    b, t_mel, f = mu_y.shape
    tp = prompt_feat.shape[1]
    mu = torch.zeros((b, tp + t_mel, f))
    conds = torch.zeros_like(mu)
    mu[:, :tp] = prompt_h
    conds[:, :tp] = prompt_feat
    for i, p in enumerate(plens.tolist()):
        mu[i, p : p + t_mel] = mu_y[i]
    return mu, conds


@pytest.mark.parametrize("plens", [(0, 40), (64, 17)])
def test_device_graft_equals_the_host_loop(plens):
    g = torch.Generator().manual_seed(5)
    mu_y, full = torch.randn(2, 128, 80, generator=g), torch.randn(2, 192, 80, generator=g)
    pf, ph = torch.randn(2, 64, 80, generator=g), torch.randn(2, 64, 80, generator=g)
    lens = torch.tensor(plens, dtype=torch.int32)
    mu, conds = ptts.graft_prompt(mu_y, pf, ph, lens)
    want_mu, want_conds = _host_loop_graft(mu_y, pf, ph, lens)
    assert torch.equal(mu, want_mu) and torch.equal(conds, want_conds)
    mel = ptts.strip_prompt(full, lens, 64)
    assert torch.equal(mel, torch.stack([full[i, p : p + 128] for i, p in enumerate(plens)]))
    # offsets past the pad clamp to it, as lax.dynamic_update_slice does
    over = torch.tensor([70, 64], dtype=torch.int32)
    assert torch.equal(ptts.graft_prompt(mu_y, pf, ph, over)[0],
                       _host_loop_graft(mu_y, pf, ph, torch.tensor([64, 64]))[0])


def test_batched_prompted_synthesize_mel_matches_jax(trees):
    """synthesize_mel at B=2, prompt lengths 0 and 40 in a 64-frame pad,
    against the JAX package's at the e2e bars."""
    tt, _ = trees
    rows = [_inputs(6, 64, 0, n=20), _inputs(7, 64, 40, n=24)]
    args = [np.concatenate(parts) for parts in zip(*rows)]
    kw = dict(t_mel_max=T_MEL, n_timesteps=STEPS)
    ref = jtts.synthesize_mel(tt, JAX_CFG.tts, *(jnp.asarray(a) for a in args),
                              rand_noise=jnp.asarray(jax_rand_noise(64 + T_MEL)), **kw)
    model = load_jax_params(ptts.TTS(PORT_CFG.tts), tt).eval()
    with torch.inference_mode():
        out = ptts.synthesize_mel(model, *_t(args), rand_noise=rand_noise(64 + T_MEL), **kw)
    np.testing.assert_array_equal(out.mel_lengths.numpy(), np.asarray(ref.mel_lengths))
    assert np.abs(out.mel.numpy() - np.asarray(ref.mel)).mean() < 1e-2


_TRAP_CHILD = r"""
import sys

import numpy as np
import torch

from jyutvoice_tpu_torch.config import (
    CFMConfig, EstimatorConfig, HiFTConfig, JyutVoiceConfig, TextEncoderConfig, TTSConfig,
)
from jyutvoice_tpu_torch.models import hift
from jyutvoice_tpu_torch.pipeline import serving
from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer
from jyutvoice_tpu_torch.weights.random_init import init_hift_tree, init_tts_tree

torch.set_num_threads(1)
cfg = JyutVoiceConfig(
    tts=TTSConfig(encoder=TextEncoderConfig(n_layers=1, filter_channels=64),
                  cfm=CFMConfig(estimator=EstimatorConfig(n_blocks=1, num_mid_blocks=1))),
    hift=HiFTConfig(base_channels=64),
)
tts, hif = init_tts_tree(cfg.tts), init_hift_tree(cfg.hift)
kw = dict(t_text=32, t_mel=32, n_timesteps=1, device="cpu")
if sys.argv[1] == "export":
    serving.export_program(cfg, tts, hif, sys.argv[2] + ".pt2", **kw)
args = serving.example_args(32, 0)
with torch.inference_mode():
    outs = list(serving.build_serving_fn(cfg, tts, hif, **kw)(*args))
    outs += list(hift.hift_inference(Synthesizer(cfg, tts, hif, device="cpu").hift,
                                     torch.ones(1, 40, 80)))
outs += list(hift._on_device(hift._hann, (16,), torch.device("cpu")))
assert all(type(o) is torch.Tensor for o in outs), [type(o) for o in outs]
r = Synthesizer(cfg, tts, hif, device="cpu").synthesize("佢", lang="yue", phone="keoi5",
                                                        n_timesteps=1)
np.savez(sys.argv[2] + ".npz", *[o.numpy() for o in outs], wav=r.wav)
print("REAL_TENSORS_OK")
"""


def test_export_first_leaves_no_fake_tensor_in_a_cache(tmp_path):
    """In a fresh process, export before any eager call, then run the eager
    serving graph, a vocoder call and a synthesize: every output is a real
    torch.Tensor and equals a process that never exported."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    got = {}
    for mode in ("export", "eager"):
        proc = subprocess.run([sys.executable, "-c", _TRAP_CHILD, mode, str(tmp_path / mode)],
                              env=env, capture_output=True, timeout=600, text=True, cwd=REPO)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
        assert "REAL_TENSORS_OK" in proc.stdout
        got[mode] = dict(np.load(tmp_path / f"{mode}.npz"))
    assert got["export"].keys() == got["eager"].keys()
    for key, want in got["eager"].items():
        np.testing.assert_array_equal(got["export"][key], want, err_msg=key)


def test_export_traces_an_int8_tree(trees, tmp_path):
    """export_program handed an int8 decoder tree traces it rather than
    refusing: each int8 linear goes into the graph as its plain composition
    (one torch._int_mm node per QuantLinear and step), and the reloaded
    artifact equals the eager serving graph on the export's config (1e-6)."""
    from jyutvoice_tpu_torch.nn.quant import QuantLinear, quantize_estimator

    tts, hift = trees
    qtts = {**tts, "decoder": quantize_estimator(jax.tree_util.tree_map(np.asarray,
                                                                        tts["decoder"]))}
    path = str(tmp_path / "int8.pt2")
    program = serving.export_program(PORT_CFG, qtts, hift, path, t_text=T_TEXT, t_mel=T_MEL,
                                     n_timesteps=1, device="cpu")
    eager = serving.build_serving_fn(serving.export_safe_cfg(PORT_CFG), qtts, hift,
                                     t_text=T_TEXT, t_mel=T_MEL, n_timesteps=1, device="cpu")
    n_q = sum(isinstance(m, QuantLinear) for m in eager.modules())
    mm = [n for n in program.graph.nodes
          if n.op == "call_function" and "_int_mm" in str(n.target)]
    assert n_q and len(mm) == n_q
    args = _t(_inputs(3))
    got = serving.load_program(path)(*args)
    with torch.inference_mode():
        want = eager(*args)
    for o, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(o, w, atol=1e-6, rtol=0)
    assert torch.equal(got[2], want[2])
