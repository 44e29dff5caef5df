"""The DiT cell (`kinds/serve_dit.py`) on the CPU at a small size:
a whole run reads correct; a fault planted in the DiT path after set-up
(a gate's sign, the RoPE layout, the input concatenation's order) reads
not correct; the operation counts of `flops_dit.py` match torch's
FlopCounterMode over the DiT reference; the traced run's readers have
what they read."""

import importlib.util
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import portbench.run as R
from portbench import flops_dit, layout_dit
from portbench.reference import dit as dit_ref
from portbench.reference import model as ref
from portbench.tests.small import adjust

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKLOAD = "dit.offline-b16"


def adjust_dit(conf, traffic):
    """`small.adjust`'s text half, vocoder and traffic with a DiT of dim 64,
    depth 2, 4 heads of 16 and conv groups 4."""
    conf, traffic = adjust(conf, traffic)
    conf["model"]["tts"]["cfm"]["dit"].update(dim=64, depth=2, heads=4, dim_head=16,
                                              conv_groups=4)
    return conf, traffic


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def test_small_run_is_correct():
    res = R.evaluate(WORKLOAD, 2 ** 31 + 77, 1.0, 0, device="cpu", adjust=adjust_dit)
    assert res["attempted"] > 0 and res["failed"] == 0
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"], (name, c)
    assert res["correct"]
    assert set(res["metrics"]) == {"audio_s_per_s", "setup_s"}


def gate_sign(synth):
    """Every block's attention gate g1 enters with the wrong sign."""
    d = synth.tts.decoder.cfg.dim
    with torch.no_grad():
        for blk in synth.tts.decoder.blocks:
            blk.ada.weight[2 * d: 3 * d].neg_()
            blk.ada.bias[2 * d: 3 * d].neg_()


def rope_halves(synth):
    """RoPE turns (i, i + d/2) pairs, the text encoder's layout, in place of
    interleaved pairs."""
    from jyutvoice_tpu_torch.nn.attention import apply_rope, rope_cos_sin

    def rotate(x, cos, sin):
        n = x.shape[-1]
        c, s = rope_cos_sin(x.shape[1], n, device=x.device)
        x[:, :, :1] = apply_rope(x[:, :, :1], c[:, None], s[:, None], n)
        return x

    for blk in synth.tts.decoder.blocks:
        blk.attn.rotate = rotate


def unet_concat_order(synth):
    """The inputs concatenated in the U-Net's order [x, mu, spks, cond]."""
    dec = synth.tts.decoder

    def inputs(x, mu, spks, cond):
        b, t, _ = x.shape
        return torch.cat([x, mu, spks[:, None, :].expand(b, t, -1), cond], dim=-1)

    dec.inputs = inputs


@pytest.mark.parametrize("fault", [gate_sign, rope_halves, unet_concat_order],
                         ids=lambda f: f.__name__)
def test_fault_reads_not_correct(fault):
    def judge_all(conf, traffic):
        conf, traffic = adjust_dit(conf, traffic)
        traffic["check_sample"] = 10 ** 6  # every served request
        return conf, traffic

    res = R.evaluate(WORKLOAD, 2 ** 31 + 5, 0.5, 0, device="cpu", fault=fault, adjust=judge_all)
    assert res["attempted"] > 0
    assert not res["correct"], res["checks"]


def test_estimator_call_matches_flop_counter():
    conf = json.load(open(os.path.join(HERE, "configs", "jyutvoice-cv3dit.json")))
    conf, _ = adjust_dit(conf, {"engine": {}, "warm": {}})
    m = conf["model"]
    tts, _, _ = layout_dit.model_trees(m, 11, "cpu")
    t = 40
    x = torch.randn(1, t, 80)
    with FlopCounterMode(display=False) as fc:
        dit_ref.estimator(tts["decoder"], m["tts"]["cfm"]["dit"], x, x, torch.rand(1),
                          torch.randn(1, 80), x, ref.Numerics())
    n = fc.get_total_flops()
    assert abs(n - flops_dit.estimator_call(m, t)) / n < 0.01


def _reader(name):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_readers_read_the_traced_outputs_and_nothing_else():
    conf = {"model": {"tts": {"cfm": {"dit": {}}}}}
    traffic = {"engine": {"n_timesteps": 10}}
    out = {"spans": {"device_s": {"dit.attn": 2.0, "dit.ff": 1.0}, "audio_s": 100.0},
           "rows": (1000, 560.0), "window_s": 10.0, "served": []}
    ctx = {"conf": conf, "traffic": traffic, "out": out, "peaks": {"bf16_flops": 1e15}}
    assert _reader("dit_attn_ms_per_audio_s")(ctx) == pytest.approx(20.0)
    assert _reader("dit_ff_ms_per_audio_s")(ctx) == pytest.approx(10.0)
    assert _reader("dit_valid_rows_pct")(ctx) == pytest.approx(56.0)
    assert _reader("mfu.dit")(ctx) is None  # nothing served
    # a program without the spans or the counter: nothing to read
    bare = {"conf": conf, "traffic": traffic, "out": {"spans": {"device_s": {}, "audio_s": 1.0}}}
    for name in ("dit_attn_ms_per_audio_s", "dit_ff_ms_per_audio_s", "dit_valid_rows_pct"):
        assert _reader(name)(bare) is None
