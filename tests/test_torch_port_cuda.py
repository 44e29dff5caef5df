"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips without a CUDA device. It imports nothing of
JAX, so on a GPU machine without JAX it runs without the suite's conftest:
    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest
Tolerances as in test_torch_port_kernels.py: attention atol 5e-3 / rtol 2e-2
on valid rows, ResBlock stage atol 2e-5 / rtol 1e-4; kernel 3 (stock flash)
atol 5e-3 / rtol 1e-2 on every row, as in test_torch_port_longform.py.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from jyutvoice_tpu_torch.pipeline.synthesize import disable_tf32

    disable_tf32()
    return torch.device("cuda")


@pytest.mark.parametrize(
    "t,lengths,chunk,left,d",
    [(256, [256, 200], 0, -1, 64), (576, [576, 333], 0, -1, 64),
     (640, [640, 600], 50, -1, 64), (512, [400, 512], 100, 2, 64),
     (300, [300, 77], 0, -1, 128)],
)
def test_flash_kernel_matches_plain(cuda, t, lengths, chunk, left, d):
    from jyutvoice_tpu_torch.nn.flash_attention import flash_attention, flash_attention_plain

    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(len(lengths), t, 4, d, device=cuda, generator=g) for _ in range(3))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    kw = dict(scale=d ** -0.5, chunk_size=chunk, num_left_chunks=left)
    out = flash_attention(q, k, v, lens, **kw)
    ref = flash_attention_plain(q, k, v, lens, **kw)
    for i, n in enumerate(lengths):
        torch.testing.assert_close(out[i, :n], ref[i, :n], atol=5e-3, rtol=2e-2)


@pytest.mark.parametrize("c,t,b", [(128, 1000, 1), (64, 1537, 2), (16, 701, 1)])
def test_resblock_stage_kernel_matches_plain(cuda, c, t, b):
    from jyutvoice_tpu_torch.nn.resblock_stage import resblock_stage, resblock_stage_plain

    ks, dil = (3, 7, 11), (1, 3, 5)
    g = torch.Generator(device=cuda).manual_seed(1)
    parts = []
    for k in ks:
        for _ in dil:
            for _ in range(2):
                parts += [
                    torch.randn(k * c * c, device=cuda, generator=g) / (k * c) ** 0.5,
                    torch.randn(c, device=cuda, generator=g) * 0.1,
                    torch.rand(c, device=cuda, generator=g) + 0.5,
                ]
    w = torch.cat(parts)
    x = torch.randn(b, t, c, device=cuda, generator=g) * 0.5
    kw = dict(kernel_sizes=ks, dilations=dil)
    torch.testing.assert_close(
        resblock_stage(x, w, **kw), resblock_stage_plain(x, w, **kw), atol=2e-5, rtol=1e-4
    )


@pytest.mark.parametrize(
    "t,lengths,d",
    [(2048, [2048, 1700], 64), (2560, [2560, 2148], 64), (4096, [4096, 3001], 64),
     (512, [1, 512], 64), (640, [0, 333], 64), (1024, [700, 1024], 128)],
)
def test_flash_stock_kernel_matches_plain(cuda, t, lengths, d):
    from jyutvoice_tpu_torch.nn.flash_stock import flash_stock, flash_stock_plain

    g = torch.Generator(device=cuda).manual_seed(2)
    # strided (B, T, H, D) views of one (B, T, 3*H*D) tensor, as the estimator's
    # projections are
    qkv = torch.randn(len(lengths), t, 3 * 8 * d, device=cuda, generator=g)
    q, k, v = (x.view(len(lengths), t, 8, d) for x in qkv.split(8 * d, dim=-1))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    out = flash_stock(q, k, v, lens, scale=d ** -0.5)
    ref = flash_stock_plain(q, k, v, lens, scale=d ** -0.5)
    torch.testing.assert_close(out, ref, atol=5e-3, rtol=1e-2)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from jyutvoice_tpu_torch.nn.flash_attention import flash_attention
    from jyutvoice_tpu_torch.nn.resblock_stage import resblock_stage

    q = torch.zeros(1, 8, 1, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q, torch.tensor([8], dtype=torch.int32, device=cuda), scale=1.0)
    from jyutvoice_tpu_torch.nn.flash_stock import flash_stock

    lens = torch.tensor([100], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 64"):
        z = torch.zeros(1, 100, 2, 64, device=cuda)
        flash_stock(z, z, z, lens, scale=1.0)
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros(1, 128, 2, 32, device=cuda)
        flash_stock(z, z, z, lens, scale=1.0)
    with pytest.raises(ValueError, match="C="):
        resblock_stage(torch.zeros(1, 8, 24, device=cuda), torch.zeros(1, device=cuda),
                       kernel_sizes=(3,), dilations=(1,))


def _small_synth(cuda):
    from jyutvoice_tpu_torch import config as port_config
    from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer
    from jyutvoice_tpu_torch.weights import random_init

    m = port_config
    cfg = m.JyutVoiceConfig(  # the parity tests' small configuration
        tts=m.TTSConfig(
            encoder=m.TextEncoderConfig(n_layers=1, filter_channels=64),
            cfm=m.CFMConfig(estimator=m.EstimatorConfig(n_blocks=1, num_mid_blocks=1)),
        ),
        hift=m.HiFTConfig(base_channels=64),
    )
    return Synthesizer(cfg, random_init.init_tts_tree(cfg.tts),
                       random_init.init_hift_tree(cfg.hift), device=cuda)


def test_small_synthesizer_goes_through_both_kernels(cuda):
    from jyutvoice_tpu_torch import kernels

    synth = _small_synth(cuda)
    cfg = synth.cfg
    kernels.reset_launch_counts()
    res = synth.synthesize("佢", lang="yue", phone="keoi5", n_timesteps=2)
    assert res.wav.shape == (res.mel_frames * 480,)
    est = cfg.tts.cfm.estimator
    assert kernels.LAUNCHES == {
        "flash_attention": 2 * (est.num_mid_blocks + 2) * est.n_blocks,
        "resblock_stage": 3,  # base 64: all three stages have C <= 128
        "flash_stock": 0,
    }


def test_small_long_form_request_goes_through_kernel_3(cuda):
    import numpy as np

    from jyutvoice_tpu_torch import kernels

    synth = _small_synth(cuda)
    arrs, n, _ = synth.prepare_text("佢", "yue", "keoi5")
    frames = synth.duration_frames(arrs, n, synth._spk(None))
    kernels.reset_launch_counts()
    res = synth.synthesize_long("佢", lang="yue", phone="keoi5", n_timesteps=2,
                                attention="exact", length_scale=1900.0 / frames)
    assert 1500 < res.mel_frames <= 2048 and np.isfinite(res.wav).all()
    assert res.wav.shape == (res.mel_frames * 480,)
    est = synth.cfg.tts.cfm.estimator
    assert kernels.LAUNCHES["flash_stock"] == 2 * (est.num_mid_blocks + 2) * est.n_blocks
    assert kernels.LAUNCHES["flash_attention"] == 0
