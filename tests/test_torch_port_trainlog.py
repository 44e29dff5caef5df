"""The port's training CLI options of the fine-tune workflow, and its
logging and observability utilities, on the CPU at the small configuration
of `torch_port_setup.py`:
  * --pretrain with an `.npz` tree and a Lightning `.ckpt` starts from
    parameters bit-equal to the tree;
  * --tb-dir writes event files with train/* and val/* scalars and the
    validation sample's four images, and exact resume still holds with it
    set (against a run that logs nothing); --wandb-project without wandb
    warns (the tests make `wandb` unimportable: the reference shim of
    other test files stubs it);
  * the validation sample: its generated mel equals a direct
    `synthesize_mel` on the same noise bit for bit, it leaves the model in
    train mode and the trainer's generator untouched;
  * `TrainLogger` without tensorboard or wandb warns and writes nothing;
  * `log_param_counts` / `param_count` equal the JAX package's on the same
    tree (and on the module); `StageTimer` and `debug_nans` as the JAX
    test checks them; `trace` writes a trace file.
"""

import glob
import logging
import os
import sys

import numpy as np
import pytest
import torch

from jyutvoice_tpu_torch.cli import train
from jyutvoice_tpu_torch.models.tts import TTS, synthesize_mel
from jyutvoice_tpu_torch.train import checkpoints as pckpt
from jyutvoice_tpu_torch.train import step as pstep
from jyutvoice_tpu_torch.utils import observability as obs
from jyutvoice_tpu_torch.utils.tb_logging import TrainLogger
from jyutvoice_tpu_torch.weights import random_init
from jyutvoice_tpu_torch.weights.from_jax import load_jax_params, save_pytree_npz
from torch_port_setup import PORT_CFG, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARGS = ["--device", "cpu", "--dummy", "--dummy-rows", "10", "--batch-size", "3",
        "--log-every", "1", "--seed", "3"]


@pytest.fixture(scope="module")
def tree():
    return random_init.init_tts_tree(PORT_CFG.tts, seed=11)


def _start_params(monkeypatch):
    """The model's parameters when the trainer is built."""
    seen = {}
    real = pstep.Trainer.__init__

    def init(self, model, *a, **k):
        seen.update({n: p.detach().clone() for n, p in model.named_parameters()})
        real(self, model, *a, **k)

    monkeypatch.setattr(pstep.Trainer, "__init__", init)
    return seen


@pytest.mark.parametrize("fmt", ["npz", "ckpt"])
def test_pretrain_starts_from_the_tree(tmp_path, tree, monkeypatch, fmt):
    from jyutvoice_tpu_torch.weights.torch_export import save_torch_checkpoint

    path = str(tmp_path / f"init.{fmt}")
    (save_pytree_npz if fmt == "npz" else save_torch_checkpoint)(path, tree)
    seen = _start_params(monkeypatch)
    train.main([*ARGS, "--pretrain", path, "--validate-only", "--ckpt-dir",
                str(tmp_path / "ck")], cfg=PORT_CFG)
    want = load_jax_params(TTS(PORT_CFG.tts), tree)
    assert seen and set(seen) == {n for n, _ in want.named_parameters()}
    for n, p in want.named_parameters():
        assert torch.equal(seen[n], p), n


def _events(tb_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(tb_dir, size_guidance={"images": 0, "scalars": 0})
    acc.Reload()
    return acc.Tags()


def test_tb_dir_logging_keeps_exact_resume(tmp_path, monkeypatch, caplog):
    """A run cut at step 2 and resumed, logging to TensorBoard and asking
    for wandb (absent), ends where a run that logs nothing ends: the
    validation sample after step 3 draws nothing from the trainer's
    generator. Its event files hold the train/* and val/* scalars and the
    sample's four images; the parameter counts are logged."""
    monkeypatch.setitem(sys.modules, "wandb", None)

    def run(d, *extra):
        return train.main([*ARGS, "--max-steps", "4", "--ckpt-dir", str(d), *extra],
                          cfg=PORT_CFG)

    run(tmp_path / "straight")
    straight = pckpt.restore(str(tmp_path / "straight"))
    real_step = pstep.Trainer.step

    def stop_after_two(self, batch):
        out = real_step(self, batch)
        if self.step_count == 2:
            train.request_stop()
        return out

    samples = []
    real_sample = train._log_val_sample
    monkeypatch.setattr(train, "_log_val_sample",
                        lambda *a: samples.append(real_sample(*a)) or samples[-1])
    tb_dir = str(tmp_path / "tb")
    tb = ["--tb-dir", tb_dir, "--wandb-project", "p"]
    monkeypatch.setattr(pstep.Trainer, "step", stop_after_two)
    with caplog.at_level(logging.INFO):
        run(tmp_path / "cut", *tb)
        monkeypatch.setattr(pstep.Trainer, "step", real_step)
        assert run(tmp_path / "cut", "--resume", *tb)["step"] == 4
    assert len(samples) == 1 and samples[0] is not None
    a, b = straight["trainer"], pckpt.restore(str(tmp_path / "cut"))["trainer"]
    for name, t in a["model"].items():
        assert torch.equal(t, b["model"][name]), name
    for key in ("m", "v"):
        for x, y in zip(a["optimizer"][key], b["optimizer"][key]):
            assert torch.equal(x, y)
    assert torch.equal(a["generator"], b["generator"])

    assert glob.glob(os.path.join(tb_dir, "events.out.tfevents.*"))
    tags = _events(tb_dir)
    for k in ("loss", "dur_loss", "prior_loss", "diff_loss", "grad_norm", "lr"):
        assert f"train/{k}" in tags["scalars"], k
    for k in ("loss", "dur_loss", "prior_loss", "diff_loss"):
        assert f"val/{k}" in tags["scalars"], k
    assert set(tags["images"]) == {"val/generated_mel", "val/encoder_mel",
                                   "val/ground_truth_mel", "val/alignment"}
    # wandb does not import: a warning, and TensorBoard only
    assert "wandb requested but unavailable" in caplog.text
    assert "params/total" in caplog.text


class _Recorder:
    """A SummaryWriter stand-in that keeps the images it is given."""

    def __init__(self):
        self.images = {}

    def add_image(self, tag, img, step, dataformats):
        self.images[tag] = (img, step, dataformats)


def test_val_sample_equals_synthesize_mel(tree):
    from jyutvoice_tpu_torch.pipeline import buckets as bkt
    from jyutvoice_tpu_torch.train.datamodule import DataConfig, TextMelDataModule, dummy_rows
    from jyutvoice_tpu_torch.utils.viz import colormap
    from jyutvoice_tpu_torch.weights.noise import rand_noise

    model = load_jax_params(TTS(PORT_CFG.tts), tree)
    trainer = pstep.Trainer(model, PORT_CFG.train, torch.Generator().manual_seed(5))
    gen_before = trainer.generator.get_state()
    dm = TextMelDataModule(dummy_rows(10, seed=3), DataConfig(batch_size=3, seed=3))
    tb = TrainLogger()
    tb.writer = _Recorder()
    model.train()
    out = train._log_val_sample(model, dm, tb, 7)
    assert model.training and torch.equal(trainer.generator.get_state(), gen_before)

    vb = next(iter(dm.valid_batches()))
    n, y = int(vb["x_lengths"][0]), int(vb["y_lengths"][0])
    t_text = bkt.pick_bucket(n, bkt.TEXT_BUCKETS)
    t_mel = bkt.pick_bucket(y + 64, bkt.MEL_BUCKETS)
    ids = {k: torch.zeros((1, t_text), dtype=torch.int64) for k in
           ("x", "lang", "tone", "word_pos", "syllable_pos")}
    for k in ids:
        ids[k][0, :n] = torch.from_numpy(np.asarray(vb[k][0, :n]))
    zero = torch.zeros((1, 0, 80))
    with torch.no_grad():
        ref = synthesize_mel(model.eval(), ids["x"], torch.tensor([n]), ids["lang"], ids["tone"],
                             ids["word_pos"], ids["syllable_pos"],
                             torch.from_numpy(vb["spk_embed"][:1]), zero, zero,
                             torch.zeros(1, dtype=torch.int32), t_mel_max=t_mel,
                             n_timesteps=10, rand_noise=rand_noise(t_mel))
    assert torch.equal(out.mel, ref.mel) and torch.equal(out.attn, ref.attn)
    frames = int(ref.mel_lengths[0])
    imgs = tb.writer.images
    assert set(imgs) == {"val/generated_mel", "val/encoder_mel", "val/ground_truth_mel",
                         "val/alignment"}
    assert all(step == 7 and fmt == "HWC" for _, step, fmt in imgs.values())
    np.testing.assert_array_equal(imgs["val/generated_mel"][0],
                                  colormap(ref.mel[0, :frames].numpy().T[::-1]))
    np.testing.assert_array_equal(imgs["val/alignment"][0],
                                  colormap(ref.attn[0, :n, :frames].numpy()))
    assert imgs["val/ground_truth_mel"][0].shape == (80, y, 3)
    # no image sink: nothing is synthesized
    assert train._log_val_sample(model, dm, TrainLogger(), 7) is None


def test_train_logger_without_its_packages(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "wandb", None)
    with caplog.at_level(logging.WARNING):
        tb = TrainLogger(str(tmp_path / "tb"), wandb_project="p")
    assert tb.writer is None and tb.wandb is None
    assert "tensorboard unavailable" in caplog.text and "wandb requested" in caplog.text
    tb.scalars("train", {"loss": 1.0}, 1)
    tb.mel_image("val/generated_mel", np.zeros((5, 80)), 1)
    tb.close()
    assert not os.path.exists(str(tmp_path / "tb"))


def test_param_counts_match_jax(tree):
    from jyutvoice_tpu.utils import observability as jobs

    want = jobs.log_param_counts(tree)
    assert obs.log_param_counts(tree) == want
    assert set(want) == {"encoder", "dp", "decoder", "spk_embed_affine_layer", "total"}
    assert obs.log_param_counts(load_jax_params(TTS(PORT_CFG.tts), tree)) == want
    assert obs.param_count(tree) == jobs.param_count(tree) == want["total"]


def test_observability_utils(tmp_path):
    timer = obs.StageTimer()
    for name in ("mel", "mel", "voc"):
        with timer.stage(name):
            pass
    report = timer.report(audio_seconds=10.0)
    assert report["mel"]["count"] == 2 and "xrt" in report["voc"]
    assert obs.param_count({"a": {"w": np.ones((3, 4))}, "b": {"w": np.ones(5)}}) == 17

    assert not torch.is_anomaly_enabled()
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    with obs.debug_nans():
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    assert not torch.is_anomaly_enabled()

    with obs.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
