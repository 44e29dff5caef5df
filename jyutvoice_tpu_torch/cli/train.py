"""Train the text encoder and duration predictor against the frozen flow
decoder with the PyTorch port, on one device.

  python -m jyutvoice_tpu_torch.cli.train --dataset prepared \
      --pretrain pretrained_models_tpu/tts_init.npz --tb-dir runs
  python -m jyutvoice_tpu_torch.cli.train --dummy --max-steps 100
  python -m jyutvoice_tpu_torch.cli.train --device cpu --dummy --max-steps 2

The counterpart of the JAX package's `cli/train.py` on one device. Weights
start from --pretrain (an `.npz` tree such as `cli.provision
--assemble-pretrain`'s tts_init.npz, or the reference's `.pt` / `.ckpt`),
else from the seeded random tree (`weights/random_init.py`, --seed);
--dummy trains on synthetic rows (--dummy-mel 1400,2000 lands batches in the
2048 mel bucket, where the estimator takes kernels 3, 4 and 5 on the card).
Each epoch ends with an eval-mode validation pass, whose loss keeps the best
checkpoints in <ckpt-dir>/best. --tb-dir (and --wandb-project, when `wandb`
imports) logs the training losses every --log-every steps, the validation
losses, and after each validation pass one validation row synthesized in
10 steps as four images (generated mel, encoder mel, ground truth,
alignment). SIGTERM, SIGINT or `request_stop()` stop
the run at the next step boundary and save a checkpoint; --resume continues
from the latest checkpoint at the same batch of the same epoch with the same
generator state, so an interrupted and resumed run takes the same steps as
an uninterrupted one. Runs on the GPU unless --device cpu is given.

Data parallel under torchrun, one rank per device:
  torchrun --nproc-per-node 4 -m jyutvoice_tpu_torch.cli.train --dataset prepared
Each rank binds cuda:LOCAL_RANK (an explicit --device cuda:N is kept, so two
ranks may share a card, with --dist-backend gloo: NCCL refuses two ranks on
one GPU). Every rank reads the same global batches and trains its own rows
of each (`train/step.py`, DistributedDataParallel over the trainable half);
a tail batch is padded to the full batch, rounded up to the world size, by
repeating its row 0. A validation batch whose rows do not split over the
ranks is evaluated whole on every rank. Rank 0 alone logs, writes
checkpoints and makes the validation sample; --resume restores into every
rank. --report PATH writes each rank's summary as JSON ("{rank}" in PATH
is replaced by the rank): its steps, last metrics and kernel launches.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import threading
import time

log = logging.getLogger("jyutvoice_tpu_torch.train")

_STOP = threading.Event()


def request_stop() -> None:
    """Ask a running `main` to stop at the next step boundary (what SIGTERM
    and SIGINT do) and save a resumable checkpoint."""
    _STOP.set()


def _install_stop_handlers():
    """SIGTERM/SIGINT -> request_stop; returns the previous handlers, or
    None off the main thread, where signals cannot be handled."""
    if threading.current_thread() is not threading.main_thread():
        return None
    return {sig: signal.signal(sig, lambda *_: request_stop())
            for sig in (signal.SIGTERM, signal.SIGINT)}


def validation_pass(trainer, dm):
    """Row-weighted mean of the eval-mode losses over the validation rows,
    or None when there are none."""
    totals, rows = {}, 0
    for batch in dm.valid_batches():
        b = batch["x"].shape[0]
        for k, v in trainer.evaluate(batch).items():
            totals[k] = totals.get(k, 0.0) + b * float(v)
        rows += b
    return {k: v / rows for k, v in totals.items()} if rows else None


def _log_val_sample(model, dm, tb, step):
    """Synthesize the first validation row at its text and mel buckets (10
    steps, the seed-0 noise) and log its generated mel, encoder mel, ground
    truth and alignment (the reference's on_validation_end images). The
    model runs in eval mode and gets its mode back; nothing is drawn from
    the trainer's generator, so logging leaves the training steps as they
    were. Returns the SynthesisOutput (on the model's device), or None when
    there is no validation row or no image sink."""
    import numpy as np
    import torch

    from jyutvoice_tpu_torch.models.tts import synthesize_mel
    from jyutvoice_tpu_torch.pipeline import buckets as bkt
    from jyutvoice_tpu_torch.weights.noise import rand_noise

    vbatch = next(iter(dm.valid_batches()), None)
    if vbatch is None or (tb.writer is None and tb.wandb is None):
        return None
    i = 0
    n = int(vbatch["x_lengths"][i])
    t_text = bkt.pick_bucket(n, bkt.TEXT_BUCKETS)
    t_mel = bkt.pick_bucket(int(vbatch["y_lengths"][i]) + 64, bkt.MEL_BUCKETS)
    device = next(model.parameters()).device

    def cut(key):
        a = np.zeros((1, t_text), np.int64)
        a[0, :n] = np.asarray(vbatch[key])[i, :n]
        return torch.from_numpy(a).to(device)

    spk = torch.from_numpy(np.asarray(vbatch["spk_embed"], np.float32)[i : i + 1]).to(device)
    zero = torch.zeros((1, 0, 80), device=device)
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            out = synthesize_mel(
                model, cut("x"), torch.tensor([n], device=device), cut("lang"), cut("tone"),
                cut("word_pos"), cut("syllable_pos"), spk, zero, zero,
                torch.zeros((1,), dtype=torch.int32), t_mel_max=t_mel, n_timesteps=10,
                rand_noise=rand_noise(t_mel, device=device),
            )
    finally:
        model.train(was_training)
    mel, enc_mel, attn, lens = (a.cpu().numpy() for a in
                                (out.mel, out.encoder_mel, out.attn, out.mel_lengths))
    frames = int(lens[0])
    tb.mel_image("val/generated_mel", mel[0, :frames], step)
    tb.mel_image("val/encoder_mel", enc_mel[0, :frames], step)
    gt = np.asarray(vbatch["y"])[i, : int(vbatch["y_lengths"][i])]
    tb.mel_image("val/ground_truth_mel", gt, step)
    tb.attn_image("val/alignment", attn[0, :n, :frames], step)
    return out


def pad_tail(batch, batch_size: int, world: int):
    """A batch of b rows padded up to max(batch_size, b), rounded up to the
    world size, by repeating row 0 (the JAX package's tail padding); as it
    is when that adds nothing."""
    import numpy as np

    b = batch["x"].shape[0]
    target = max(batch_size, b)
    target += (-target) % world
    if target == b:
        return batch
    return {k: np.concatenate([np.asarray(v)] + [np.asarray(v)[:1]] * (target - b), axis=0)
            for k, v in batch.items()}


def _stop_everywhere(mesh, device) -> bool:
    """Whether any rank was asked to stop, agreed by every rank."""
    import torch

    stop = _STOP.is_set()
    if mesh is None:
        return stop
    flag = torch.tensor([float(stop)], device=device)
    return bool(mesh.comm().all_reduce(flag)[0] > 0)


def main(argv=None, cfg=None):
    parser = argparse.ArgumentParser(description="JyutVoice training (PyTorch port)")
    parser.add_argument("--dataset", default=None,
                        help="HF dataset directory (needs the `datasets` package)")
    parser.add_argument("--dummy", action="store_true", help="synthetic smoke data")
    parser.add_argument("--dummy-rows", type=int, default=64,
                        help="synthetic row count (with --dummy)")
    parser.add_argument("--dummy-mel", default="48,160",
                        help="LO,HI synthetic mel-frame range (with --dummy)")
    parser.add_argument("--pretrain", default=None,
                        help="pretrained tts weights (.npz tree, or the reference's .pt/.ckpt)")
    parser.add_argument("--ckpt-dir", default="checkpoints")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--tb-dir", default=None, help="TensorBoard log dir")
    parser.add_argument("--wandb-project", default=None,
                        help="optional WandB project (mirrors TensorBoard; only when "
                             "`wandb` imports)")
    parser.add_argument("--save-every", type=int, default=500)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--validate-only", action="store_true",
                        help="run one eval-mode validation pass and exit")
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    parser.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                        help="process-group backend under torchrun (default: nccl on "
                             "cuda, gloo on cpu)")
    parser.add_argument("--report", default=None,
                        help="write this rank's summary as JSON ({rank} -> the rank)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from jyutvoice_tpu_torch.dist.multihost import init_distributed, rank_device
    from jyutvoice_tpu_torch.pipeline.synthesize import disable_tf32

    device = rank_device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but no CUDA device is available; "
                               "pass --device cpu to train on the CPU")
        disable_tf32()
    distributed = init_distributed(device=device, backend=args.dist_backend)
    rank = torch.distributed.get_rank() if distributed else 0
    level = log.level
    try:
        out = _run(args, cfg, device, distributed)
    finally:
        log.setLevel(level)
        if distributed:
            torch.distributed.destroy_process_group()
    if args.report:
        from jyutvoice_tpu_torch import kernels

        report = {**({"val": out} if args.validate_only else out), "rank": rank,
                  "launches": dict(kernels.LAUNCHES)}
        with open(args.report.replace("{rank}", str(rank)), "w") as f:
            json.dump(report, f)
    return out


def _run(args, cfg, device, distributed):
    import dataclasses

    import torch

    from jyutvoice_tpu_torch.config import JyutVoiceConfig
    from jyutvoice_tpu_torch.dist.mesh import make_mesh
    from jyutvoice_tpu_torch.models.tts import TTS
    from jyutvoice_tpu_torch.train import checkpoints as ckpt
    from jyutvoice_tpu_torch.train.datamodule import DataConfig, TextMelDataModule, dummy_rows
    from jyutvoice_tpu_torch.train.prefetch import prefetch
    from jyutvoice_tpu_torch.train.step import Trainer
    from jyutvoice_tpu_torch.utils.observability import log_param_counts
    from jyutvoice_tpu_torch.utils.tb_logging import TrainLogger
    from jyutvoice_tpu_torch.weights import random_init
    from jyutvoice_tpu_torch.weights.from_jax import load_jax_params

    # the job's data mesh; None in a single-process run
    mesh = make_mesh() if distributed else None
    world = mesh.size if mesh else 1
    lead = mesh is None or mesh.rank == 0
    if not lead:
        log.setLevel(logging.WARNING)  # rank 0 alone logs
    else:
        log.info("data mesh: %d rank(s)", world)
    cfg = cfg or JyutVoiceConfig()
    tr = cfg.train
    if args.epochs:
        tr = dataclasses.replace(tr, max_epochs=args.epochs)
    if args.batch_size:
        tr = dataclasses.replace(tr, batch_size=args.batch_size)
    if args.lr:
        tr = dataclasses.replace(tr, learning_rate=args.lr)

    if args.pretrain:
        from jyutvoice_tpu_torch.cli.infer import load_params

        params = load_params(args.pretrain, "tts", cfg)
        log.info("loaded pretrained weights from %s", args.pretrain)
    else:
        params = random_init.init_tts_tree(cfg.tts, seed=args.seed)
        log.warning("training from scratch (no --pretrain): random weights, seed %d",
                    args.seed)
    model = load_jax_params(TTS(cfg.tts), params).to(device)
    dm_cfg = DataConfig(batch_size=tr.batch_size, seed=args.seed)
    if args.dummy or not args.dataset:
        log.warning("using dummy dataset (smoke mode)")
        lo, hi = (int(v) for v in args.dummy_mel.split(","))
        dm = TextMelDataModule(dummy_rows(args.dummy_rows, seed=args.seed, mel_frames=(lo, hi)),
                               dm_cfg)
    else:
        dm = TextMelDataModule(args.dataset, dm_cfg)

    trainer = Trainer(model, tr, torch.Generator(device=device).manual_seed(args.seed),
                      mesh=mesh)
    log.info("trainable parameters: %d tensors, %d values", len(trainer.params),
             sum(p.numel() for p in trainer.params))
    start_epoch, start_batch = 0, 0
    if args.resume:
        state = ckpt.restore(args.ckpt_dir, map_location=device)
        if state is not None:
            trainer.load_state_dict(state["trainer"])
            start_epoch, start_batch = int(state["epoch"]), int(state["batch"])
            log.info("resumed from step %d (epoch %d, batch %d)", trainer.step_count,
                     start_epoch, start_batch)

    if args.validate_only:
        avg = validation_pass(trainer, dm)
        if avg is None:
            log.warning("no validation data")
        else:
            log.info("validate-only | val_loss %.4f (dur %.4f prior %.4f diff %.4f)",
                     avg["loss"], avg["dur_loss"], avg["prior_loss"], avg["diff_loss"])
        return avg

    def snapshot(epoch, batch):
        return {"trainer": trainer.state_dict(), "epoch": epoch, "batch": batch}

    if lead:
        log_param_counts(params)
    tb = TrainLogger(args.tb_dir if lead else None,
                     wandb_project=args.wandb_project if lead else None)
    _STOP.clear()
    previous = _install_stop_handlers()
    metrics, epoch, pos = None, start_epoch, start_batch
    try:
        t_start = time.time()
        stopped = False
        for epoch in range(start_epoch, tr.max_epochs):
            skip = start_batch if epoch == start_epoch else 0
            pos = 0
            for pos, batch in enumerate(prefetch(dm.train_batches(epoch)), start=1):
                if pos <= skip:
                    continue  # trained before the checkpoint this run resumed from
                if world > 1:
                    batch = pad_tail(batch, tr.batch_size, world)
                metrics = trainer.step(batch)
                step = trainer.step_count
                if step % args.log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    tb.scalars("train", m, step)
                    log.info("step %d | loss %.4f (dur %.4f prior %.4f diff %.4f) | grad %.3f "
                             "| lr %.3e | %.2f steps/s", step, m["loss"], m["dur_loss"],
                             m["prior_loss"], m["diff_loss"], m["grad_norm"], m["lr"],
                             args.log_every / max(time.time() - t_start, 1e-9))
                    t_start = time.time()
                if lead and step % args.save_every == 0:
                    ckpt.save(args.ckpt_dir, step, snapshot(epoch, pos))
                stop = _stop_everywhere(mesh, device)
                if (args.max_steps and step >= args.max_steps) or stop:
                    stopped = True
                    if stop:
                        log.warning("stop requested: stopping at step %d (resumable "
                                    "checkpoint follows)", step)
                    break
            if stopped:
                break
            avg = validation_pass(trainer, dm)
            if avg:
                tb.scalars("val", avg, trainer.step_count)
                log.info("epoch %d | val_loss %.4f (dur %.4f prior %.4f diff %.4f)", epoch,
                         avg["loss"], avg["dur_loss"], avg["prior_loss"], avg["diff_loss"])
                if lead:
                    ckpt.save_best(args.ckpt_dir, trainer.step_count, snapshot(epoch + 1, 0),
                                   val_loss=avg["loss"])
            # the validation sample's images (never fatal)
            try:
                if lead:
                    _log_val_sample(model, dm, tb, trainer.step_count)
            except Exception as e:  # noqa: BLE001
                log.warning("val sample logging failed: %s", e)
        # an interrupted run resumes after its last batch; a finished one
        # resumes past its last epoch (and so does nothing more)
        final = snapshot(epoch, pos) if stopped else snapshot(tr.max_epochs, 0)
        if lead:
            ckpt.save(args.ckpt_dir, trainer.step_count, final)
        log.info("done at step %d", trainer.step_count)
    finally:
        # flushes the event file's tail (SummaryWriter flushes every 2 min)
        tb.close()
        if previous is not None:
            for sig, handler in previous.items():
                signal.signal(sig, handler)
    return {"step": trainer.step_count, "world": world,
            "metrics": {k: float(v) for k, v in (metrics or {}).items()}}


if __name__ == "__main__":
    main()
