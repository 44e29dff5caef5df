"""CosyVoice 3's DiT estimator in the port (`models/dit.py`) against the
plain reference (`tests/reference_dit.py`), on the CPU at a small size:
dim 64, depth 2, 4 heads of 16, conv groups 4, on seeded random weights
whose adaLN linears and proj_out are nonzero.

Tolerance: the largest |port - reference| over valid frames, as a share
of the reference's largest magnitude, at most 1e-4. Both compute in f32
and round the attention at kernel 1's points, so they differ by the order
of f32 sums and, through a last-bit difference, a bf16 rounding of q, k, v
or P flipping here and there: 3e-7 to 1.6e-5 in these tests (the
ragged batch's 1.6e-5 reads the same on the unpacked rows). The same
estimator with bf16 products reads 4.6e-3
(`test_bf16_estimator_fails_the_tolerance`). The two references differ by
the layer norm's own sums and such flips: 5e-6, held to 2e-5.

The blocks run on the packed valid rows wherever a call's mask holds
padding: ragged guidance-doubled batches (a one-frame row, a full row,
one t for every row or one a row) match the reference row by row, with
padded frames exactly 0, and a batch without padding runs unpacked.

Also: the interleaved-pair RoPE by hand, the benchmark's copy of the
reference (`portbench/reference/dit.py`) against this one, the published
widths' parameter count, the spans and the row counter of a call, the
configuration file of the DiT cell, and the clear errors of the paths
that run the U-Net only."""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

import reference_dit as ref
from jyutvoice_tpu_torch import config as C
from jyutvoice_tpu_torch.models.cfm import cfm_forward
from jyutvoice_tpu_torch.models.dit import DiT
from jyutvoice_tpu_torch.nn.attention import apply_rope_pairs, rope_pairs_cos_sin
from jyutvoice_tpu_torch.utils import observability as obs
from jyutvoice_tpu_torch.weights import random_init
from jyutvoice_tpu_torch.weights.from_jax import load_jax_params
from jyutvoice_tpu_torch.weights.noise import rand_noise
from torch_port_setup import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
DIT = C.DiTConfig(dim=64, depth=2, heads=4, dim_head=16, conv_groups=4)
CFG = C.JyutVoiceConfig(
    tts=C.TTSConfig(encoder=C.TextEncoderConfig(n_layers=1, filter_channels=64),
                    cfm=C.CFMConfig(estimator_kind="dit", dit=DIT)),
    hift=C.HiFTConfig(base_channels=64),
)
S = dataclasses.asdict(DIT)


def gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def trees():
    return random_init.init_tts_tree(CFG.tts, seed=3), random_init.init_hift_tree(CFG.hift, 4)


@pytest.fixture(scope="module")
def dit(trees):
    return load_jax_params(DiT(DIT, CFG.tts.cfm.estimator), trees[0]["decoder"]).eval()


@pytest.fixture(scope="module")
def p(trees):
    return ref.tensors(trees[0]["decoder"])


def inputs(b, t, seed=0):
    g = torch.Generator().manual_seed(seed)
    x, mu, cond = (torch.randn(b, t, 80, generator=g) for _ in range(3))
    return x, mu, torch.rand(b, generator=g), torch.randn(b, 80, generator=g), cond


def test_rope_pairs_by_hand():
    t, d = 7, 8
    x = torch.randn(2, t, 3, d)
    cos, sin = rope_pairs_cos_sin(t, d)
    got = apply_rope_pairs(x, cos[:, None], sin[:, None])
    for pos in range(t):
        for i in range(d // 2):
            a = pos * 10000.0 ** (-2 * i / d)
            x0, x1 = x[:, pos, :, 2 * i], x[:, pos, :, 2 * i + 1]
            assert torch.allclose(got[:, pos, :, 2 * i], x0 * math.cos(a) - x1 * math.sin(a),
                                  atol=1e-5)
            assert torch.allclose(got[:, pos, :, 2 * i + 1], x1 * math.cos(a) + x0 * math.sin(a),
                                  atol=1e-5)
    assert torch.allclose(ref.rope(x.transpose(1, 2)).transpose(1, 2), got, atol=1e-6)


def test_published_widths_hold_331m_parameters():
    with torch.device("meta"):
        n = sum(q.numel() for q in DiT(C.DiTConfig(), C.EstimatorConfig()).parameters())
    assert 330e6 < n < 332e6


def test_one_block_matches_reference(dit, p):
    t = 40
    h = torch.randn(1, t, 64)
    st = torch.nn.functional.silu(torch.randn(1, 1, 64))
    cos, sin = rope_pairs_cos_sin(t, 16)
    ctx = {"lengths": torch.tensor([t], dtype=torch.int32), "backend": "flash"}
    with torch.no_grad():
        got = dit.blocks[0](h, dit.blocks[0].ada(st), (cos[:, None], sin[:, None]), ctx)
        want = ref.block(p["blocks"][0], S, h, st)
    assert gap(got, want) <= TOL


def test_estimator_on_a_padded_batch_matches_reference(dit, p):
    t, lengths = 96, (96, 61)
    x, mu, tt, spks, cond = inputs(2, t)
    mask = (torch.arange(t)[None] < torch.tensor(lengths)[:, None]).float()[..., None]
    with torch.no_grad():
        got = dit(x, mask, mu, tt, spks, cond)
        assert float(got[1, lengths[1]:].abs().max()) == 0.0  # padded frames zeroed
        for i, n in enumerate(lengths):
            want = ref.estimator(p, S, x[i:i + 1, :n], mu[i:i + 1, :n], tt[i:i + 1],
                                 spks[i:i + 1], cond[i:i + 1, :n])
            assert gap(got[i:i + 1, :n], want) <= TOL, i


def _cfg_batch(t, lengths, per_row_t, seed):
    """A guidance-doubled batch of requests of `lengths` as `solve_euler_cfg`
    builds it (the unconditioned half with mu, speaker and condition at
    zero): t one value expanded over the rows, or one value per row."""
    b = len(lengths)
    x, mu, tt, spks, cond = inputs(b, t, seed=seed)
    mask = (torch.arange(t)[None] < torch.tensor(lengths)[:, None]).float()[..., None]
    t2 = torch.rand(2 * b, generator=torch.Generator().manual_seed(seed)) if per_row_t \
        else tt[0].expand(2 * b)
    zero = torch.zeros_like(mu)
    return (torch.cat([x, x]), torch.cat([mask, mask]), torch.cat([mu * mask, zero]), t2,
            torch.cat([spks, torch.zeros_like(spks)]), torch.cat([cond * mask, zero]))


@pytest.mark.parametrize("lengths,per_row_t,packed", [
    ((96, 1, 37, 70), False, True),    # ragged, a full row and a one-frame row
    ((1,), False, True),               # a lone one-frame request
    ((96, 96), False, False),          # no padding: the blocks run on (B, T, D)
    ((96, 1, 37, 70), True, True),     # one t a row: each row gathers its modulation
    ((96, 96), True, False),
], ids=["ragged", "one_frame", "full", "ragged_per_row_t", "full_per_row_t"])
def test_packed_rows_of_a_cfg_batch_match_reference(dit, p, monkeypatch, lengths, per_row_t,
                                                    packed):
    from jyutvoice_tpu_torch.models import dit as dit_module

    made = []

    class Spy(dit_module.PackedRows):
        def __init__(self, valid, n, b, t, shared):
            super().__init__(valid, n, b, t, shared)
            made.append((n, shared))

    monkeypatch.setattr(dit_module, "PackedRows", Spy)
    t = 96
    x, mask, mu, tt, spks, cond = _cfg_batch(t, lengths, per_row_t, seed=7)
    with torch.no_grad():
        got = dit(x, mask, mu, tt, spks, cond)
        for i, n in enumerate(lengths * 2):
            assert not got[i, n:].any()  # padded frames exactly 0
            want = ref.estimator(p, S, x[i:i + 1, :n], mu[i:i + 1, :n], tt[i:i + 1],
                                 spks[i:i + 1], cond[i:i + 1, :n])
            assert gap(got[i:i + 1, :n], want) <= TOL, i
    assert made == ([(2 * sum(lengths), not per_row_t)] if packed else [])


def test_cfg_solve_through_cfm_forward_matches_reference(dit, p):
    t, lengths, steps = 80, (80, 53), 3
    _, mu, _, spks, cond = inputs(2, t, seed=1)
    cond = torch.zeros_like(cond)
    mask = (torch.arange(t)[None] < torch.tensor(lengths)[:, None]).float()[..., None]
    noise = rand_noise()
    with torch.no_grad():
        got = cfm_forward(dit, CFG.tts.cfm, mu * mask, mask, spks, cond, n_timesteps=steps,
                          rand_noise=noise)
        for i, n in enumerate(lengths):
            want = ref.cfm_solve(p, S, mu[i:i + 1, :n], spks[i:i + 1], noise, steps)
            assert gap(got[i:i + 1, :n], want) <= TOL, i


def test_batch_dispatch_of_a_group_matches_reference(trees, p):
    from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer

    synth = Synthesizer(CFG, *trees, device="cpu")
    rng = np.random.default_rng(5)
    items = [dict(text=t, lang="yue", phone=ph,
                  spk_embed=rng.standard_normal(192).astype(np.float32))
             for t, ph in (("佢 係 邊 個", "keoi5 hai6 bin1 go3"), ("佢", "keoi5"),
                           ("你 好", "nei5 hou2"))]
    steps, ls = 2, 1.5
    res = synth.synthesize_batch_dispatch(items, n_timesteps=steps, length_scale=ls)()
    for it, r in zip(items, res):
        mu_y, c, y_len = synth.prepare_stream(it["text"], lang="yue", phone=it["phone"],
                                              spk_embed=it["spk_embed"], length_scale=ls)
        assert r.mel_frames == y_len
        want = ref.cfm_solve(p, S, torch.from_numpy(mu_y)[None], torch.from_numpy(c)[None],
                             synth.noise, steps)
        assert gap(torch.from_numpy(r.mel)[None], want) <= TOL, it["text"]


def test_bf16_estimator_fails_the_tolerance(dit, p):
    t = 64
    x, mu, tt, spks, cond = inputs(1, t, seed=2)
    mask = torch.ones(1, t, 1)
    with torch.no_grad():
        want = ref.estimator(p, S, x, mu, tt, spks, cond)
        assert gap(dit(x, mask, mu, tt, spks, cond), want) <= TOL
        with torch.autocast("cpu", dtype=torch.bfloat16):
            low = dit(x, mask, mu, tt, spks, cond)
    assert gap(low.float(), want) > 10 * TOL


def test_benchmark_reference_agrees(p):
    from portbench.reference import dit as bench
    from portbench.reference import model as bench_model

    t = 48
    x, mu, tt, spks, cond = inputs(2, t, seed=4)
    cfm = {"inference_cfg_rate": 0.7, "dit": S}
    with torch.no_grad():
        a = ref.estimator(p, S, x, mu, tt, spks, cond)
        b = bench.estimator(p, S, x, mu, tt, spks, cond, bench_model.Numerics())
        assert gap(b, a) <= 2e-5
        noise = torch.randn(1, t, 80)
        a = ref.cfm_solve(p, S, mu[:1], spks[:1], noise, 2)
        b = bench.cfm_solve(p, cfm, mu[:1], spks[:1], noise, 2, bench_model.Numerics())
        assert gap(b, a) <= 2e-5


def test_spans_and_row_counter_of_a_call(dit):
    t, lengths = 32, (32, 20)
    x, mu, tt, spks, cond = inputs(2, t, seed=6)
    mask = (torch.arange(t)[None] < torch.tensor(lengths)[:, None]).float()[..., None]
    obs.drain()
    obs.ESTIMATOR_ROWS.reset()
    with torch.no_grad():
        dit(x, mask, mu, tt, spks, cond)  # off: nothing recorded or counted
        assert obs.drain() == [] and obs.ESTIMATOR_ROWS.read() == (0, 0)
        obs.enable()
        try:
            cfm_forward(dit, CFG.tts.cfm, mu, mask, spks, cond, n_timesteps=2,
                        rand_noise=rand_noise())
        finally:
            obs.disable()
    spans = obs.drain()
    names = [s.name for s in spans]
    assert names.count("dit.embed") == 2 and names.count("mel.solve") == 1
    assert names.count("dit.attn") == names.count("dit.ff") == 2 * DIT.depth
    solve = next(s for s in spans if s.name == "mel.solve")
    assert all(s.parent == solve.id for s in spans if s.name.startswith("dit."))
    # two steps of 2 x 2 rows (guidance) of 32 frames, 52 of them valid: the
    # blocks computed the valid rows alone
    assert obs.ESTIMATOR_ROWS.read() == (2 * 2 * sum(lengths), 2 * 2 * sum(lengths))
    obs.ESTIMATOR_ROWS.reset()
    full = torch.ones_like(mask)  # no padding: the blocks computed every row
    obs.enable()
    try:
        with torch.no_grad():
            cfm_forward(dit, CFG.tts.cfm, mu, full, spks, cond, n_timesteps=2,
                        rand_noise=rand_noise())
    finally:
        obs.disable()
    obs.drain()
    assert obs.ESTIMATOR_ROWS.read() == (2 * 4 * t, 2 * 4 * t)
    obs.ESTIMATOR_ROWS.reset()


def test_cell_configuration_file():
    path = os.path.join(ROOT, "portbench", "configs", "jyutvoice-cv3dit.json")
    conf = json.load(open(path))
    cfg = C.load_config(path)
    assert conf["reduced"] == [] and not conf["int8"]
    assert cfg.tts.cfm.estimator_kind == "dit"
    d = cfg.tts.cfm.dit
    assert (d.dim, d.depth, d.heads, d.dim_head, d.ff_mult) == (1024, 22, 16, 64, 2)
    # everything but the decoder is jyutvoice-base's
    base = C.load_config(os.path.join(ROOT, "portbench", "configs", "jyutvoice-base.json"))
    assert dataclasses.replace(cfg.tts.cfm, estimator_kind="unet", dit=C.DiTConfig()) \
        == base.tts.cfm
    assert dataclasses.replace(cfg, tts=base.tts) == base
    with pytest.raises(ValueError, match="no fields"):
        C.config_from_dict({"tts": {"cfm": {"estimator_knd": "dit"}}})


def _left_out(name, trees):
    """Call the path `name` on the small DiT configuration."""
    tts, hift = trees
    if name == "streaming":
        from jyutvoice_tpu_torch.pipeline.streaming import StreamingSynthesizer

        StreamingSynthesizer(CFG, tts, hift, device="cpu")
    elif name == "streaming_lane":
        from jyutvoice_tpu_torch.pipeline.server import StreamingLane
        from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer

        StreamingLane(Synthesizer(CFG, tts, hift, device="cpu"))
    elif name == "chunk_masks":
        x, mu, tt, spks, cond = inputs(1, 8)
        DiT(DIT, CFG.tts.cfm.estimator)(x, torch.ones(1, 8, 1), mu, tt, spks, cond,
                                        streaming=True)
    elif name == "int8":
        from jyutvoice_tpu_torch.nn.quant import quantize_estimator

        quantize_estimator(tts["decoder"])
    elif name == "export":
        from jyutvoice_tpu_torch.pipeline import serving

        serving.build_serving_fn(CFG, tts, hift, t_text=32, t_mel=128, device="cpu")
    elif name == "dist_sp":
        from jyutvoice_tpu_torch.dist.sp import sp_cfm_solve

        sp_cfm_solve(None, CFG.tts.cfm, None, n_timesteps=2)
    elif name == "dist_shard":
        from jyutvoice_tpu_torch.dist.sp import shard_params

        shard_params(DiT(DIT, CFG.tts.cfm.estimator), None)
    elif name == "dist_tp":
        from jyutvoice_tpu_torch.dist.tp import tp_shard_estimator

        tp_shard_estimator(DiT(DIT, CFG.tts.cfm.estimator), None)
    elif name == "training":
        from jyutvoice_tpu_torch.models.tts import TTS
        from jyutvoice_tpu_torch.train.step import Trainer

        Trainer(TTS(CFG.tts), CFG.train, torch.Generator())
    elif name == "training_loss":
        x, mu, tt, spks, cond = inputs(1, 8)
        DiT(DIT, CFG.tts.cfm.estimator)(x, torch.ones(1, 8, 1), mu, tt, spks, cond,
                                        training=True)


@pytest.mark.parametrize("name", ["streaming", "streaming_lane", "chunk_masks", "int8", "export",
                                  "dist_sp", "dist_shard", "dist_tp", "training",
                                  "training_loss"])
def test_paths_left_out_refuse_the_dit(trees, name):
    with pytest.raises(NotImplementedError, match="U-Net"):
        _left_out(name, trees)
