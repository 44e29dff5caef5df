"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips without a CUDA device. It imports nothing of
JAX, so on a GPU machine without JAX it runs without the suite's conftest:
    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest
Tolerances as in test_torch_port_kernels.py: attention atol 5e-3 / rtol 2e-2
on valid rows, ResBlock stage atol 2e-5 / rtol 1e-4.
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


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from jyutvoice_tpu_torch.nn.flash_attention import flash_attention
    from jyutvoice_tpu_torch.nn.resblock_stage import resblock_stage

    q = torch.zeros(1, 8, 1, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q, torch.tensor([8], dtype=torch.int32, device=cuda), scale=1.0)
    with pytest.raises(ValueError, match="C="):
        resblock_stage(torch.zeros(1, 8, 24, device=cuda), torch.zeros(1, device=cuda),
                       kernel_sizes=(3,), dilations=(1,))


def test_small_synthesizer_goes_through_both_kernels(cuda):
    from jyutvoice_tpu_torch import config as port_config
    from jyutvoice_tpu_torch import kernels
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
    synth = Synthesizer(cfg, random_init.init_tts_tree(cfg.tts),
                        random_init.init_hift_tree(cfg.hift), device=cuda)
    kernels.reset_launch_counts()
    res = synth.synthesize("佢", lang="yue", phone="keoi5", n_timesteps=2)
    assert res.wav.shape == (res.mel_frames * 480,)
    est = cfg.tts.cfm.estimator
    assert kernels.LAUNCHES == {
        "flash_attention": 2 * (est.num_mid_blocks + 2) * est.n_blocks,
        "resblock_stage": 3,  # base 64: all three stages have C <= 128
    }
