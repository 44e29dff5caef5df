"""The port's training slice against the JAX package, on the CPU.

Same weights (the JAX package's `init_tts` tree through the bridge) and the
same seeded numpy inputs through both packages, at the small configuration
of `torch_port_setup.py`:
  * MAS: the port's `align.maximum_path` equals `maximum_path_jax` and the
    host `maximum_path` exactly, on ragged batches;
  * kernel 3's backward: `flash_stock_bwd_plain`, and the autograd path on
    CPU tensors, against JAX's `mha_reference_bwd` fed the residuals of
    `mha_reference_no_custom_vjp` (atol 1e-5); kernels 4 and 5's TF32
    rounding (`flash_stock_bwd_rounded`) within 5e-3 of the plain backward
    and 1e-2 of JAX's; the plain layout of their prepared operands;
  * `duration_loss` and `cfm_loss` with fixed overrides, values and the
    gradient with respect to their input;
  * `compute_losses` with dropout off, cond_prob 1 and fixed CFM draws:
    the four losses (rtol 1e-4) and the alignment (equal); the gradients
    of every trainable parameter (rtol 1e-3 / atol 1e-5) and their norm;
  * the optimizer (clip + AdamW + warmup) over 6 steps (1e-6) and the LR
    schedules;
  * the datamodule's examples and batches (equal);
  * dropout, the training attention route, freezing, checkpoints, the
    prefetcher, and the CLI's resume (equal to an uninterrupted run).
The JAX graphs are built once per module.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as jflash

from jyutvoice_tpu import align as jalign
from jyutvoice_tpu.models import cfm as jcfm
from jyutvoice_tpu.models import duration as jdur
from jyutvoice_tpu.models import tts as jtts
from jyutvoice_tpu.train import datamodule as jdm
from jyutvoice_tpu.train import step as jstep
from jyutvoice_tpu_torch import config as pcfg
from jyutvoice_tpu_torch import kernels
from jyutvoice_tpu_torch.align import maximum_path
from jyutvoice_tpu_torch.models import cfm as pcfm
from jyutvoice_tpu_torch.models import duration as pdur
from jyutvoice_tpu_torch.models import estimator as pest
from jyutvoice_tpu_torch.models import tts as ptts
from jyutvoice_tpu_torch.nn import core as pcore
from jyutvoice_tpu_torch.nn.flash_stock import (
    PREP_REGIONS,
    flash_stock,
    flash_stock_bwd,
    flash_stock_bwd_plain,
    flash_stock_bwd_prepare,
    flash_stock_bwd_rounded,
    flash_stock_di,
    flash_stock_plain,
    prep_numel,
)
from jyutvoice_tpu_torch.train import checkpoints as pckpt
from jyutvoice_tpu_torch.train import datamodule as pdm
from jyutvoice_tpu_torch.train import step as pstep
from jyutvoice_tpu_torch.train.prefetch import prefetch
from jyutvoice_tpu_torch.weights.from_jax import load_jax_params
from torch_port_setup import JAX_CFG, PORT_CFG, jax_trees, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOSS_RTOL = 1e-4
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
INT_KEYS = ("x", "tone", "word_pos", "syllable_pos", "lang")


# ---------------------------------------------------------------------------
# MAS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,b,tx,ty", [(0, 3, 17, 60), (1, 4, 30, 95), (2, 2, 8, 8),
                                          (3, 5, 24, 200)])
def test_maximum_path_matches_jax_and_host(seed, b, tx, ty):
    rng = np.random.default_rng(seed)
    value = (rng.standard_normal((b, tx, ty)) * 3).astype(np.float32)
    xl = rng.integers(2, tx + 1, b)
    yl = np.maximum(rng.integers(2, ty + 1, b), xl)
    xl[0], yl[0] = tx, ty
    mask = ((np.arange(tx)[None, :, None] < xl[:, None, None])
            & (np.arange(ty)[None, None, :] < yl[:, None, None])).astype(np.float32)
    ref = np.asarray(jalign.maximum_path_jax(jnp.asarray(value), jnp.asarray(mask)))
    out = maximum_path(torch.from_numpy(value), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, jalign.maximum_path(value, mask))
    # one text position per valid mel frame, monotonic
    np.testing.assert_array_equal(out.sum(axis=1), mask[:, 0, :])


# ---------------------------------------------------------------------------
# Kernel 3's backward (its plain version on the CPU)
# ---------------------------------------------------------------------------


def _to_port(a):
    """(B, H, T, D) numpy -> a (B, T, H, D) view."""
    return torch.from_numpy(a).transpose(1, 2)


BWD_CASES = [(128, [128, 77]), (192, [1, 192]), (256, [0, 129])]


def _mha_reference_bwd(t, lengths):
    """Seeded (B, H, T, D) q, k, v, do, JAX's `mha_reference_bwd` gradients
    (dq, dk, dv) and the residuals o, l, m of `mha_reference_no_custom_vjp`."""
    b, h, d = len(lengths), 2, 64
    scale = d ** -0.5
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(4))
    seg_np = (np.arange(t)[None, :] < np.array(lengths)[:, None]).astype(np.int32)
    seg = jflash.SegmentIds(q=jnp.asarray(seg_np), kv=jnp.asarray(seg_np))
    qs = jnp.asarray(q * scale)  # mha_reference_bwd takes sm_scale=1.0 only
    o_j, l_j, m_j = jflash.mha_reference_no_custom_vjp(
        qs, jnp.asarray(k), jnp.asarray(v), None, seg, save_residuals=True)
    dq_j, dk_j, dv_j, _ = jflash.mha_reference_bwd(
        qs, jnp.asarray(k), jnp.asarray(v), None, seg, o_j, l_j, m_j, jnp.asarray(do))
    ref = [np.array(dq_j) * scale, np.array(dk_j), np.array(dv_j)]
    return (q, k, v, do), ref, [np.array(a) for a in (o_j, l_j, m_j)]


@pytest.mark.parametrize("t,lengths", BWD_CASES)
def test_flash_stock_backward_matches_mha_reference_bwd(t, lengths):
    scale = 64 ** -0.5
    (q, k, v, do), ref, (o_j, l_j, m_j) = _mha_reference_bwd(t, lengths)
    lens = torch.tensor(lengths, dtype=torch.int32)

    # the plain forward's stats are the reference's residuals
    o, m, l = flash_stock_plain(_to_port(q), _to_port(k), _to_port(v), lens, scale=scale,
                                residuals=True)
    np.testing.assert_allclose(o.transpose(1, 2).numpy(), o_j, atol=1e-5)
    np.testing.assert_allclose(m.numpy(), m_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), l_j, rtol=1e-5, atol=1e-5)

    # the plain backward on the reference's residuals
    o_p = _to_port(o_j).contiguous()
    grads = flash_stock_bwd_plain(
        _to_port(q), _to_port(k), _to_port(v), o_p, _to_port(do),
        torch.from_numpy(m_j), torch.from_numpy(l_j), lens, scale=scale)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), r, atol=1e-5)
    # the wrapper takes the plain backward for CPU tensors
    grads_w = flash_stock_bwd(_to_port(q), _to_port(k), _to_port(v), o_p, _to_port(do),
                              torch.from_numpy(m_j), torch.from_numpy(l_j), lens,
                              scale=scale)
    for g, gw in zip(grads, grads_w):
        torch.testing.assert_close(gw, g, rtol=0, atol=0)

    # autograd through flash_stock on CPU tensors
    qt, kt, vt = (_to_port(a).clone().requires_grad_() for a in (q, k, v))
    kernels.reset_launch_counts()
    out = flash_stock(qt, kt, vt, lens, scale=scale)
    out.backward(_to_port(do))
    for x, r in zip((qt, kt, vt), ref):
        np.testing.assert_allclose(x.grad.transpose(1, 2).numpy(), r, atol=1e-5)
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("t,lengths", BWD_CASES)
def test_flash_stock_bwd_rounding_meets_the_bar(t, lengths):
    """Kernels 4 and 5's arithmetic (TF32 operands, `flash_stock_bwd_rounded`)
    stays within 5e-3 (max |err| / max |ref|, per gradient) of the plain f32
    backward, half the kernels' 1e-2 bar, and within the bar of JAX's
    `mha_reference_bwd`."""
    scale = 64 ** -0.5
    (q, k, v, do), ref, (o_j, l_j, m_j) = _mha_reference_bwd(t, lengths)
    q, k, v, do = (_to_port(a) for a in (q, k, v, do))
    lens = torch.tensor(lengths, dtype=torch.int32)
    m, l = torch.from_numpy(m_j), torch.from_numpy(l_j)
    o = _to_port(o_j).contiguous()
    got = flash_stock_bwd_rounded(q, k, v, do, m, l, flash_stock_di(o, do), lens, scale=scale)
    plain = flash_stock_bwd_plain(q, k, v, o, do, m, l, lens, scale=scale)
    for name, x, y, r in zip(("dq", "dk", "dv"), got, plain, ref):
        assert float((x - y).abs().max() / y.abs().max()) <= 5e-3, name
        r = torch.from_numpy(r).transpose(1, 2)
        assert float((x - r).abs().max() / r.abs().max()) <= 1e-2, name


def _tf32_np(x):
    """Round to TF32, ties away from zero, on the bits (numpy)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_stock_bwd_prepare_plain_layout(d):
    """Every element of the prepared buffer where the kernels read it: tile
    t of (b, h) of region r starts at (r B H T + (b H + h) T + 64 t) D;
    natural images hold element (row i, column c) at
    (c // 32) 64 32 + 32 i + ((c % 32) // 4 ^ i % 8) 4 + c % 4; transposed
    ones hold row c, K index j (position 8 (j // 8) + [0,2,4,6,1,3,5,7][j % 8])
    at (j // 32) D 32 + 32 c + ((j % 32) // 4 ^ c % 8) 4 + j % 4; lse2 follows.
    Each slot is written once and the tiles round-trip to the TF32 values."""
    b, t, h = 2, 128, 3
    rng = np.random.default_rng(11)
    qkv = rng.standard_normal((b, t, 3 * h * d)).astype(np.float32)
    ops = {n: torch.from_numpy(qkv).view(b, t, 3, h, d)[:, :, i] for i, n in enumerate("qkv")}
    ops["do"] = torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(np.float32))
    m = torch.from_numpy(rng.standard_normal((b, h, t)).astype(np.float32))
    l = torch.from_numpy(rng.uniform(1.0, 50.0, (b, h, t)).astype(np.float32))
    got = flash_stock_bwd_prepare(ops["q"], ops["k"], ops["v"], ops["do"], m, l).numpy()
    assert got.size == prep_numel(b, t, h, d)

    want = np.full(got.size, np.nan, np.float32)
    i, c = np.meshgrid(np.arange(64), np.arange(d), indexing="ij")  # natural: row, column
    nat = (c // 32) * 64 * 32 + i * 32 + (((c % 32) // 4) ^ (i % 8)) * 4 + c % 4
    j, cc = np.meshgrid(np.arange(64), np.arange(d), indexing="ij")  # transposed: K index, row
    pos = 8 * (j // 8) + np.array([0, 2, 4, 6, 1, 3, 5, 7])[j % 8]
    tr = (j // 32) * d * 32 + cc * 32 + (((j % 32) // 4) ^ (cc % 8)) * 4 + j % 4
    region = b * h * t * d
    for r, name in enumerate(PREP_REGIONS):
        x = _tf32_np(ops[name.removesuffix("_t")].numpy())
        for bi in range(b):
            for hi in range(h):
                for ti in range(t // 64):
                    tile = x[bi, 64 * ti:64 * ti + 64, hi]  # (64, d)
                    base = r * region + ((bi * h + hi) * (t // 64) + ti) * 64 * d
                    if name.endswith("_t"):
                        want[base + tr] = tile[pos, cc]
                    else:
                        want[base + nat] = tile
    want[len(PREP_REGIONS) * region:] = (m * np.float32(1.4426950408889634)
                                         + torch.log2(l)).numpy().reshape(-1)
    assert not np.isnan(want).any()  # every slot written once: the layout is a bijection
    np.testing.assert_array_equal(got, want)


def test_flash_stock_residuals_refuse_autograd():
    q = torch.zeros(1, 64, 1, 64, requires_grad=True)
    with pytest.raises(ValueError, match="residuals"):
        flash_stock(q, q, q, torch.tensor([64], dtype=torch.int32), scale=1.0, residuals=True)


def test_forward_only_kernels_refuse_autograd():
    from jyutvoice_tpu_torch.nn.flash_attention import flash_attention
    from jyutvoice_tpu_torch.nn.resblock_stage import resblock_stage

    q = torch.zeros(1, 8, 1, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(q, q, q, torch.tensor([8], dtype=torch.int32), scale=0.125)
    x = torch.zeros(1, 10, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        resblock_stage(x, torch.zeros(1), kernel_sizes=(3,), dilations=(1,))
    with torch.no_grad():  # no gradient needed: the plain version runs
        assert flash_attention(q, q, q, torch.tensor([8], dtype=torch.int32),
                               scale=0.125).shape == q.shape


# ---------------------------------------------------------------------------
# Losses and gradients
# ---------------------------------------------------------------------------


def test_duration_loss_matches_jax():
    rng = np.random.default_rng(3)
    logw, target = (rng.standard_normal((3, 20, 1)).astype(np.float32) for _ in range(2))
    lengths = np.array([20, 11, 5], np.int32)
    val_j, g_j = jax.value_and_grad(jdur.duration_loss)(
        jnp.asarray(logw), jnp.asarray(target), jnp.asarray(lengths))
    lw = torch.from_numpy(logw).requires_grad_()
    val = pdur.duration_loss(lw, torch.from_numpy(target), torch.from_numpy(lengths))
    val.backward()
    np.testing.assert_allclose(val.item(), float(val_j), rtol=1e-6)
    np.testing.assert_allclose(lw.grad.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def tree():
    return jax_trees()[0]


def _port_model(tree):
    return load_jax_params(ptts.TTS(PORT_CFG.tts), tree)


def test_cfm_loss_matches_jax(tree):
    rng = np.random.default_rng(4)
    b, t = 2, 96
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x1, mu, cond, z = f(b, t, 80), f(b, t, 80), f(b, t, 80), f(b, t, 80)
    spks = f(b, 80)
    mask = (np.arange(t)[None] < np.array([96, 61])[:, None]).astype(np.float32)[..., None]
    ov = dict(t_override=np.array([0.3, 0.8], np.float32), z_override=z,
              cfg_keep_override=np.array([1.0, 0.0], np.float32))

    def jloss(mu_):
        return jcfm.cfm_loss(tree["decoder"], JAX_CFG.tts.cfm, jax.random.PRNGKey(0),
                             jnp.asarray(x1), jnp.asarray(mask), mu_, jnp.asarray(spks),
                             jnp.asarray(cond), **{k: jnp.asarray(v) for k, v in ov.items()})[0]

    val_j, g_j = jax.value_and_grad(jloss)(jnp.asarray(mu))
    model = _port_model(tree)
    mu_t = torch.from_numpy(mu).requires_grad_()
    val, y = pcfm.cfm_loss(model.decoder, PORT_CFG.tts.cfm, None, torch.from_numpy(x1),
                           torch.from_numpy(mask), mu_t, torch.from_numpy(spks),
                           torch.from_numpy(cond),
                           **{k: torch.from_numpy(v) for k, v in ov.items()})
    val.backward()
    np.testing.assert_allclose(val.item(), float(val_j), rtol=LOSS_RTOL)
    np.testing.assert_allclose(mu_t.grad.numpy(), np.asarray(g_j), **GRAD_TOL)
    assert y.shape == x1.shape


def _batch(seed=0, n=3):
    cfg = jdm.DataConfig(batch_size=n)
    rows = jdm.dummy_rows(n, seed=seed, mel_frames=(60, 120), phones=(5, 14))
    return jdm.collate([jdm.row_to_example(r, cfg) for r in rows], cfg)


_ARGS = ("x", "x_lengths", "y", "y_lengths", "lang", "tone", "word_pos", "syllable_pos",
         "spk_embed", "decoder_h")


@pytest.fixture(scope="module")
def losses_and_grads(tree):
    """The JAX package's losses and gradients on one fixed batch (one jit)."""
    batch = _batch()
    b, t = batch["y"].shape[:2]
    rng = np.random.default_rng(5)
    batch["decoder_h"] = rng.standard_normal(batch["y"].shape).astype(np.float32)
    batch["spk_embed"] = rng.standard_normal(batch["spk_embed"].shape).astype(np.float32)
    ov = dict(t_override=rng.uniform(0.1, 0.9, b).astype(np.float32),
              z_override=rng.standard_normal((b, t, 80)).astype(np.float32),
              cfg_keep_override=np.array([1.0, 0.0, 1.0], np.float32)[:b])

    def jloss(params):
        out = jtts.compute_losses(
            params, JAX_CFG.tts, jax.random.PRNGKey(0),
            *(jnp.asarray(batch[k]) for k in _ARGS),
            cond_prob=1.0, cfm_overrides={k: jnp.asarray(v) for k, v in ov.items()},
            train_dropout=False,
        )
        return out.total, out

    (_, out_j), grads_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(tree)
    return batch, ov, jax.device_get(out_j), grads_j


def _port_losses(tree, batch, ov):
    model = _port_model(tree)
    trainable = pstep.freeze(model, PORT_CFG.tts)
    tb = pstep.batch_to_device(batch, "cpu")
    out = ptts.compute_losses(
        model, None, *(tb[k] for k in _ARGS), cond_prob=1.0,
        cfm_overrides={k: torch.from_numpy(v) for k, v in ov.items()}, train_dropout=False,
    )
    out.total.backward()
    return model, trainable, out


def test_compute_losses_match_jax(tree, losses_and_grads):
    batch, ov, out_j, _ = losses_and_grads
    _, _, out = _port_losses(tree, batch, ov)
    for name in ("dur_loss", "prior_loss", "diff_loss", "total"):
        np.testing.assert_allclose(getattr(out, name).item(), float(getattr(out_j, name)),
                                   rtol=LOSS_RTOL, err_msg=name)
    np.testing.assert_array_equal(out.attn.numpy(), np.asarray(out_j.attn))


def test_trainable_gradients_match_jax(tree, losses_and_grads):
    batch, ov, _, grads_j = losses_and_grads
    model, trainable, _ = _port_losses(tree, batch, ov)
    want = dict(_port_model(jax.device_get(grads_j)).named_parameters())  # port layouts
    named = dict(model.named_parameters())
    assert trainable and all(n.split(".")[0] in ("encoder", "dp") for n in trainable)
    for name, p in named.items():
        if name in trainable:
            np.testing.assert_allclose(p.grad.numpy(), want[name].detach().numpy(),
                                       err_msg=name, **GRAD_TOL)
        else:
            assert p.grad is None, name  # frozen: no weight gradient
    mask = jstep.trainable_mask(tree, JAX_CFG.tts)
    norm_j = optax.global_norm(jax.tree.map(
        lambda g, m: g if m else jnp.zeros((), g.dtype), grads_j, mask))
    norm = pstep.global_norm([named[n].grad for n in trainable])
    np.testing.assert_allclose(float(norm), float(norm_j), rtol=1e-4)


# ---------------------------------------------------------------------------
# Optimizer and schedules
# ---------------------------------------------------------------------------


def test_optimizer_matches_optax(tree):
    train_cfg = dict(warmup_steps=3, weight_decay=0.01, learning_rate=1e-3,
                     gradient_clip_val=1.0)
    jtr = dataclasses.replace(JAX_CFG.train, **train_cfg)
    ptr = dataclasses.replace(PORT_CFG.train, **train_cfg)
    rng = np.random.default_rng(6)
    grads_np = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05).astype(np.float32),
                             tree) for _ in range(6)]

    tx = jstep.make_optimizer(tree, JAX_CFG.tts, jtr)
    params_j, state_j = tree, tx.init(tree)
    model = _port_model(tree)
    trainable = pstep.freeze(model, PORT_CFG.tts)
    named = dict(model.named_parameters())
    params = [named[n] for n in trainable]
    opt = pstep.AdamW(params, weight_decay=ptr.weight_decay, max_norm=ptr.gradient_clip_val)
    sched = pstep.lr_schedule(ptr)
    mask = jstep.trainable_mask(tree, JAX_CFG.tts)
    for step, g in enumerate(grads_np):
        norm = float(optax.global_norm(jax.tree.map(
            lambda a, m: a if m else np.zeros((), np.float32), g, mask)))
        assert norm > ptr.gradient_clip_val  # clipping fires
        updates, state_j = tx.update(jax.tree.map(jnp.asarray, g), state_j, params_j)
        params_j = optax.apply_updates(params_j, updates)
        g_port = dict(_port_model(g).named_parameters())
        opt.update([g_port[n].detach().clone() for n in trainable], sched(step))
    want = dict(_port_model(jax.device_get(params_j)).named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert opt.count == 6


@pytest.mark.parametrize("scheduler", [None, "cosine", "exponential"])
def test_lr_schedule_matches_optax(scheduler):
    kw = dict(warmup_steps=5, learning_rate=3e-4, scheduler=scheduler,
              scheduler_decay_steps=20, scheduler_gamma=0.9)
    js = jstep.lr_schedule(dataclasses.replace(JAX_CFG.train, **kw))
    ps = pstep.lr_schedule(dataclasses.replace(PORT_CFG.train, **kw))
    for step in range(40):
        # f32 in the JAX package: relative to the schedule's scale
        np.testing.assert_allclose(ps(step), float(js(jnp.asarray(step))), rtol=1e-6,
                                   atol=1e-6 * kw["learning_rate"], err_msg=f"step {step}")


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def _text_rows():
    rng = np.random.default_rng(8)
    rows = [
        {"text": "佢 係 邊 個", "lang": "yue", "phone": "keoi5 hai6 bin1 go3",
         "mel": rng.standard_normal((91, 80)).astype(np.float32)},
        {"text": "我们是朋友", "lang": "zh", "mel": rng.standard_normal((64, 80)).astype(np.float32),
         "spk_emb": rng.standard_normal(192).astype(np.float32),
         "decoder_h": rng.standard_normal((20, 80)).astype(np.float32)},
        {"text": "好", "lang": "yue", "phone": "hou2", "mel": None},  # no mel: skipped
    ]
    return rows + jdm.dummy_rows(5, seed=9)


@pytest.mark.parametrize("bucket_text", [True, False])
def test_datamodule_matches_jax(bucket_text):
    jc = jdm.DataConfig(batch_size=3, bucket_text=bucket_text, valid_ratio=0.2)
    pc = pdm.DataConfig(batch_size=3, bucket_text=bucket_text, valid_ratio=0.2)
    rows = _text_rows()
    for r in rows:
        ej, ep = jdm.row_to_example(r, jc), pdm.row_to_example(r, pc)
        assert (ej is None) == (ep is None)
        if ej is not None:
            assert ej.keys() == ep.keys()
            for k in ej:
                np.testing.assert_array_equal(ep[k], ej[k], err_msg=k)
    assert pdm.fix_len_compatibility(37) == jdm.fix_len_compatibility(37) == 40
    dj, dp = jdm.TextMelDataModule(rows, jc), pdm.TextMelDataModule(rows, pc)
    np.testing.assert_array_equal(dp.train_idx, dj.train_idx)
    for epoch in (0, 1):
        bj, bp = list(dj.train_batches(epoch)), list(dp.train_batches(epoch))
        assert len(bj) == len(bp) > 0
        for x, y in zip(bj, bp):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(y[k], x[k], err_msg=k)
    for x, y in zip(dj.valid_batches(), dp.valid_batches()):
        for k in x:
            np.testing.assert_array_equal(y[k], x[k])
    assert [r.keys() for r in pdm.dummy_rows(4, seed=2)] == \
        [r.keys() for r in jdm.dummy_rows(4, seed=2)]


def test_dataset_directory_needs_datasets(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_datasets(name, *a, **k):
        if name == "datasets":
            raise ImportError("no datasets here")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_datasets)
    with pytest.raises(RuntimeError, match="datasets"):
        pdm.TextMelDataModule("/nonexistent/dataset", pdm.DataConfig())


def test_prefetch_yields_all_and_raises():
    assert list(prefetch(iter(range(7)), depth=2)) == list(range(7))

    def bad():
        yield 1
        raise KeyError("boom")

    got = []
    with pytest.raises(KeyError, match="boom"):
        for item in prefetch(bad()):
            got.append(item)
    assert got == [1]
    gen = prefetch(iter(range(100)), depth=1)
    assert next(gen) == 0
    gen.close()  # an early stop joins the producer


# ---------------------------------------------------------------------------
# Dropout, routing, freezing
# ---------------------------------------------------------------------------


def test_dropout_is_seeded_and_identity_when_deterministic():
    x = torch.ones(4, 1000)
    a = pcore.dropout(x, 0.3, torch.Generator().manual_seed(1), False)
    b = pcore.dropout(x, 0.3, torch.Generator().manual_seed(1), False)
    c = pcore.dropout(x, 0.3, torch.Generator().manual_seed(2), False)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.7))
    assert abs(kept.float().mean().item() - 0.7) < 0.02
    g = torch.Generator().manual_seed(1)
    assert pcore.dropout(x, 0.3, g, True) is x
    assert pcore.dropout(x, 0.0, g, False) is x
    assert pcore.dropout(x, 0.3, None, False) is x


def test_training_dropout_off_is_inference(tree):
    model = _port_model(tree)
    rng = np.random.default_rng(10)
    ids = torch.from_numpy(rng.integers(1, 90, (2, 32)))
    lens = torch.tensor([32, 19])
    spk = torch.from_numpy(rng.standard_normal((2, 192)).astype(np.float32))
    args = (ids, lens, ids % 3, ids % 7, ids % 4, ids % 4, spk)
    ref = model.encoder(*args)
    gen = torch.Generator().manual_seed(0)
    same = model.encoder(*args, generator=gen, deterministic=True)
    torch.testing.assert_close(same.mu, ref.mu, rtol=0, atol=0)
    torch.testing.assert_close(model.dp(same.x, same.x_mask, spk, generator=gen),
                               model.dp(ref.x, ref.x_mask, spk), rtol=0, atol=0)
    d1 = model.encoder(*args, generator=torch.Generator().manual_seed(3), deterministic=False)
    d2 = model.encoder(*args, generator=torch.Generator().manual_seed(3), deterministic=False)
    torch.testing.assert_close(d1.mu, d2.mu, rtol=0, atol=0)
    assert not torch.allclose(d1.mu, ref.mu)
    w1 = model.dp(ref.x, ref.x_mask, spk, generator=torch.Generator().manual_seed(4),
                  deterministic=False)
    assert not torch.allclose(w1, model.dp(ref.x, ref.x_mask, spk))


def test_attention_route_in_training():
    cfg = pcfg.EstimatorConfig()
    route = lambda *a, **k: pest.attention_route(*a, training=True, **k)  # noqa: E731
    # the stock-flash gate stays, on CUDA, at 512-aligned T >= 2048
    assert route(cfg, 2048, 0) == "flash_stock"
    assert route(cfg, 4096, 0) == "flash_stock"
    assert route(cfg, 2560, 0) == "flash_stock"
    # everything else is plain attention: no banded gate, no kernel 1
    assert route(cfg, 2176, 0) == "plain"
    assert route(cfg, 1536, 0) == "plain"
    assert route(cfg, 512, 0) == "plain"
    assert route(cfg, 4096, 50) == "plain"
    assert route(cfg, 4096, 0, on_cuda=False) == "plain"
    banded = dataclasses.replace(cfg, attention_backend="banded")
    assert route(banded, 2048, 0) == "flash_stock"  # rewritten to "xla"
    assert route(banded, 1024, 0) == "plain"
    assert route(dataclasses.replace(cfg, attention_backend="pallas"), 2048, 0) == "plain"
    assert route(dataclasses.replace(cfg, banded_long_threshold=8192), 2048, 0) == "flash_stock"
    # inference routing is unchanged
    assert pest.attention_route(cfg, 2048, 0) == "banded"
    assert pest.attention_route(cfg, 1024, 0) == "flash"


def test_port_step_freezes_decoder_and_moves_encoder(tree):
    model = _port_model(tree)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = pstep.Trainer(model, PORT_CFG.train, torch.Generator().manual_seed(0))
    metrics = trainer.step(_batch(seed=1))
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert metrics["lr"] == pytest.approx(PORT_CFG.train.learning_rate
                                          / PORT_CFG.train.warmup_steps)
    moved = {n for n, p in model.named_parameters() if not torch.equal(p, before[n])}
    assert not any(n.startswith(("decoder.", "spk_embed_affine_layer.")) for n in moved)
    assert any(n.startswith("encoder.") for n in moved)
    assert any(n.startswith("dp.") for n in moved)
    assert trainer.step_count == 1


# ---------------------------------------------------------------------------
# Checkpoints and the CLI
# ---------------------------------------------------------------------------


def test_checkpoints_keep_latest_and_best(tmp_path):
    d = str(tmp_path)
    assert pckpt.latest_step(d) is None and pckpt.restore(d) is None
    for step in range(1, 5):
        pckpt.save(d, step, {"w": torch.full((2,), float(step))}, max_to_keep=2)
    assert pckpt.latest_step(d) == 4
    assert sorted(p.name for p in tmp_path.glob("step_*.pt")) == ["step_3.pt", "step_4.pt"]
    assert torch.equal(pckpt.restore(d)["w"], torch.full((2,), 4.0))
    assert torch.equal(pckpt.restore(d, 3)["w"], torch.full((2,), 3.0))
    for step, loss in ((1, 0.5), (2, 0.2), (3, 0.9), (4, 0.3)):
        pckpt.save_best(d, step, {"s": step}, val_loss=loss, max_to_keep=2)
    assert pckpt.best_step(d) == 2
    assert pckpt.restore_best(d) == {"s": 2}
    assert sorted(p.name for p in (tmp_path / "best").glob("step_*.pt")) == \
        ["step_2.pt", "step_4.pt"]


def _run(ckpt_dir, *extra):
    from jyutvoice_tpu_torch.cli import train

    return train.main(["--device", "cpu", "--dummy", "--dummy-rows", "10",
                       "--batch-size", "3", "--log-every", "1", "--seed", "3",
                       "--ckpt-dir", str(ckpt_dir), *extra], cfg=PORT_CFG)


def test_resume_matches_an_uninterrupted_run(tmp_path, monkeypatch):
    from jyutvoice_tpu_torch.cli import train

    _run(tmp_path / "straight", "--max-steps", "4")
    straight = pckpt.restore(str(tmp_path / "straight"))

    real_step = pstep.Trainer.step

    def stop_after_two(self, batch):
        out = real_step(self, batch)
        if self.step_count == 2:
            train.request_stop()
        return out

    monkeypatch.setattr(pstep.Trainer, "step", stop_after_two)
    _run(tmp_path / "cut", "--max-steps", "4")
    assert pckpt.latest_step(str(tmp_path / "cut")) == 2
    monkeypatch.setattr(pstep.Trainer, "step", real_step)
    out = _run(tmp_path / "cut", "--max-steps", "4", "--resume")
    assert out["step"] == 4
    resumed = pckpt.restore(str(tmp_path / "cut"))

    a, b = straight["trainer"], resumed["trainer"]
    assert a["step"] == b["step"] == 4 and (straight["epoch"], straight["batch"]) == \
        (resumed["epoch"], resumed["batch"])
    for name, t in a["model"].items():
        assert torch.equal(t, b["model"][name]), name
    assert a["optimizer"]["count"] == b["optimizer"]["count"] == 4
    for key in ("m", "v"):
        for x, y in zip(a["optimizer"][key], b["optimizer"][key]):
            assert torch.equal(x, y)
    assert torch.equal(a["generator"], b["generator"])


def test_validate_only(tmp_path):
    avg = _run(tmp_path, "--validate-only")
    assert set(avg) == {"dur_loss", "prior_loss", "diff_loss", "loss"}
    assert all(np.isfinite(v) for v in avg.values())
