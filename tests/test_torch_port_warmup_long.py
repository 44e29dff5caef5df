"""`Synthesizer.warmup_long` and `cli.serve --warmup-long` of the port, on the
CPU at the small configuration.

The count is the JAX package's (tests/test_pipeline.py::test_warmup_long*:
2, 1 and 2, and the JAX function itself on one more case). The shapes warmed
must be the ones `synthesize_long` then picks: a spy records every CFM solve
(t_total, steps), every estimator routing decision (the arguments of
`attention_route`, which fix the route on any device) and every vocoder
length, in the warm-up and in a served long request in the same bucket,
unprompted and cloned, for each attention mode.
"""

import numpy as np
import pytest

from jyutvoice_tpu.pipeline.synthesize import Synthesizer as JaxSynthesizer
from jyutvoice_tpu_torch.cli import serve
from jyutvoice_tpu_torch.models import estimator as pest
from jyutvoice_tpu_torch.models import hift as phift
from jyutvoice_tpu_torch.pipeline import synthesize as psyn
from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer
from jyutvoice_tpu_torch.weights import random_init
from torch_port_setup import JAX_CFG, PORT_CFG, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def trees():
    """Seeded JAX-layout trees (the port's numpy initialisers), which both
    packages load."""
    return (random_init.init_tts_tree(PORT_CFG.tts, seed=0),
            random_init.init_hift_tree(PORT_CFG.hift, seed=1))


@pytest.fixture(scope="module")
def synth(trees):
    return Synthesizer(PORT_CFG, *trees, device="cpu")


@pytest.mark.parametrize("kw,want", [
    (dict(mel_sizes=(128,), text_buckets=(64,), n_timesteps=(1,)), 2),
    (dict(mel_sizes=(128,), text_buckets=(), n_timesteps=(1,), attention="exact"), 1),
    (dict(mel_sizes=(128,), text_buckets=(), n_timesteps=(1,), with_prompt=True), 2),
    (dict(mel_sizes=(128, 256), text_buckets=(32, 64), n_timesteps=(1, 2),
          with_prompt=True, attention="banded", pcm16=True), 2 + 2 * 2 * 2),
])
def test_warmup_long_count(synth, kw, want):
    logs = []
    assert synth.warmup_long(log_fn=logs.append, **kw) == want
    assert len(logs) == want


def test_warmup_long_count_matches_jax(synth, trees):
    kw = dict(mel_sizes=(128,), text_buckets=(64,), n_timesteps=(1,), with_prompt=True)
    jax_n = JaxSynthesizer(JAX_CFG, *trees).warmup_long(**kw)
    assert synth.warmup_long(**kw) == jax_n == 3


def test_warmup_long_rejects_unknown_attention(synth):
    with pytest.raises(ValueError, match="unknown long-form attention"):
        synth.warmup_long(mel_sizes=(128,), text_buckets=(), attention="fast")


@pytest.fixture
def spy(monkeypatch):
    """Records solves (t_total, steps), routing decisions (T, chunk, mode)
    and vocoder lengths."""
    seen = {"solve": [], "route": [], "vocoder": []}
    cfm_forward, route, vocode = psyn.cfm_forward, pest.attention_route, phift.hift_vocode_auto

    def cfm_spy(est, cfg, mu, *a, **kw):
        seen["solve"].append((mu.shape[1], kw["n_timesteps"]))
        return cfm_forward(est, cfg, mu, *a, **kw)

    def route_spy(cfg, t, chunk, attention="auto", on_cuda=True, training=False):
        seen["route"].append((t, chunk, attention, training))
        return route(cfg, t, chunk, attention, on_cuda, training)

    def vocode_spy(model, mel):
        seen["vocoder"].append(mel.shape[1])
        return vocode(model, mel)

    monkeypatch.setattr(psyn, "cfm_forward", cfm_spy)
    monkeypatch.setattr(pest, "attention_route", route_spy)
    monkeypatch.setattr(phift, "hift_vocode_auto", vocode_spy)
    return seen


@pytest.mark.parametrize("attention,prompted,frames,t_mel,on_card_want", [
    ("auto", False, 1900, 2048, "banded"),
    ("exact", True, 1000, 1024, "flash"),  # t_total 512 + 1024: below kernel 3's 2048
    ("banded", False, 1900, 2048, "banded"),
])
def test_warmup_long_drives_the_served_shapes(synth, spy, attention, prompted, frames, t_mel,
                                              on_card_want):
    """A long request of about `frames` frames (a 100-frame prompt when
    cloned) takes exactly the solve, routes and vocoder length the warm-up
    drove at its bucket."""
    text, phone = "佢係邊個", "keoi5 hai6 bin1 go3"
    _, _, y_len = synth.prepare_stream(text, phone=phone)
    scale = frames / y_len
    kw = {}
    if prompted:
        rng = np.random.default_rng(0)
        pf = rng.standard_normal((100, 80)).astype(np.float32)
        kw = dict(prompt_feat=pf, prompt_h=pf)
    head, t_want = psyn.long_form_shapes(frames, prompted, attention)
    assert t_want == t_mel
    n = synth.warmup_long(mel_sizes=(t_mel,), text_buckets=(), n_timesteps=(1,),
                          with_prompt=prompted, attention=attention)
    assert n == 1 + prompted
    warmed = {k: list(v) for k, v in spy.items()}
    for v in spy.values():
        v.clear()
    res = synth.synthesize_long(text, phone=phone, length_scale=scale, n_timesteps=1,
                                attention=attention, **kw)
    assert abs(res.mel_frames - frames) < 50
    assert len(spy["solve"]) == 1 and spy["solve"][0] in warmed["solve"]
    assert spy["solve"][0] == (head + t_mel, 1)
    assert set(spy["route"]) == {(head + t_mel, 0, attention, False)}
    assert set(spy["route"]) <= set(warmed["route"])
    assert spy["vocoder"] == [t_mel] and t_mel in warmed["vocoder"]
    # the route those arguments give on the card
    on_card = pest.attention_route(PORT_CFG.tts.cfm.estimator, head + t_mel, 0, attention,
                                   on_cuda=True)
    assert on_card == on_card_want


def test_warmup_long_text_half_matches_prepare_stream(synth, monkeypatch):
    """Each text bucket drives the encoder, the duration predictor and the
    speaker affine at (1, bucket), as prepare_stream does."""
    shapes = []
    durations = synth._durations

    def spy(arrs, n, spk):
        shapes.append(tuple(a.shape for a in arrs))
        return durations(arrs, n, spk)

    monkeypatch.setattr(synth, "_durations", spy)
    synth.warmup_long(mel_sizes=(), text_buckets=(64, 128))
    assert shapes == [((1, 64),) * 5, ((1, 128),) * 5]
    shapes.clear()
    synth.prepare_stream("佢", phone="keoi5")
    assert shapes == [((1, 32),) * 5]


@pytest.mark.parametrize("extra,attention,prompts", [
    ([], "auto", False),
    (["--long-attention", "exact", "--warmup-long-prompts"], "exact", True),
    (["--long-attention", "banded"], "banded", False),
])
def test_serve_cli_passes_warmup_long_flags(monkeypatch, extra, attention, prompts):
    called = {}

    class Stop(Exception):
        pass

    def spy(self, **kw):
        called.update(kw)
        raise Stop

    monkeypatch.setattr(Synthesizer, "warmup_long", spy)
    with pytest.raises(Stop):
        serve.main(["--random-init", "--device", "cpu", "--warmup-long", "--n-timesteps", "3",
                    *extra], cfg=PORT_CFG)
    assert called["attention"] == attention and called["with_prompt"] is prompts
    assert called["n_timesteps"] == (3,) and called["pcm16"] is True
    assert "mel_sizes" not in called and "text_buckets" not in called  # the defaults
