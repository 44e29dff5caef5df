"""The benchmark's operation and byte counts against independent counts at
one small shape: by hand for kernels 1 and 2, and for the model by torch's
FlopCounterMode over the plain reference's own matmuls and convolutions."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, layout
from portbench.reference import model as ref
from portbench.tests.small import adjust

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small():
    conf = json.load(open(os.path.join(HERE, "configs", "jyutvoice-base.json")))
    conf, _ = adjust(conf, {"engine": {}, "warm": {}})
    m = conf["model"]
    tts, hift, _ = layout.model_trees(m, 11, "cpu")
    return m, tts, hift


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_kernel1_counts_by_hand():
    # rows of 3 and 5 valid keys, 2 heads of 4: q.k and p.v are 2 x 4 flops per pair
    w = flops.attention_fwd([3, 5], heads=2, d=4, t=8)
    assert w["ops"] == 2 * 2 * 4 * 2 * (3 * 3 + 5 * 5)
    assert w["bytes"] == 4 * 4 * (3 + 5) * 2 * 4  # q, k, v in and out, f32, valid rows


def test_kernel2_counts_by_hand():
    h = {"resblock_kernel_sizes": [3, 7], "resblock_dilation_sizes": [[1, 3], [1, 3]]}
    # per branch and dilation a dilated and a plain conv of k x C x C taps per sample
    want = sum(2 * 2 * (2 * 10 * 4 * 4 * k) for k in (3, 7))
    assert flops.resblock_stage(h, 10, 4) == want


def test_estimator_call_matches_flop_counter(small):
    m, tts, _ = small
    s = m["tts"]["cfm"]["estimator"]
    t = 24
    x = torch.randn(1, t, 80)
    n = counted(lambda: ref.estimator(tts["decoder"], s, x, x, torch.rand(1), torch.randn(1, 80),
                                      x, ref.Numerics()))
    assert n == flops.estimator_call(m, t)


def test_banded_keys_by_hand():
    # 5 frames in chunks of 2 with one chunk each side: rows 0-1 see keys 0-3,
    # rows 2-3 keys 0-4, row 4 keys 2-4
    assert flops.banded_keys(5, 2, 1, 1) == (2 * 4 + 2 * 5 + 1 * 3) / 5


def test_text_half_matches_flop_counter(small):
    m, tts, _ = small
    ids = [torch.randint(0, 4, (1, 30)) for _ in range(5)]
    spk = torch.randn(1, 192)
    n = counted(lambda: (ref.durations(tts, m, ids, spk),
                         ref.lin(tts["spk_embed_affine_layer"], spk)))
    assert n == flops.text_half(m, 30)


def test_vocoder_matches_flop_counter(small):
    m, _, hift = small
    t = 12
    mel = torch.randn(1, t, 80)
    n = counted(lambda: ref.vocode(hift, m["hift"], mel))
    # the count leaves out the f0 classifier, the source's harmonic mix and
    # the 16-point STFT and iSTFT: a fraction of a percent
    assert abs(n - flops.vocoder(m, t)) / n < 0.01
