"""The port's voice-cloning slice against the JAX package on the CPU: audio
front ends, relative-position attention, flow encoder, CAM++, S3 tokenizer,
the weight converters, PromptExtractor and a cloned request end to end.

Models are the JAX package's own random trees at small configs (flow
encoder 64-d, 2 + 1 blocks; CAM++ layers (2, 2, 2); S3 64-d, 2 layers),
loaded through `weights/from_jax.py`; inputs come from numpy seeds. Bars:
f32 modules atol 1e-5 / rtol 1e-4 (the log-mels and hidden states, whose
values reach tens, atol 1e-4 / rtol 1e-4 where stated); tokens exact
except values within 1e-4 of an FSQ rounding edge; a cloned request's mel
MAE < 1e-2 (PARITY.md section 2.2).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jyutvoice_tpu import config as jax_config
from jyutvoice_tpu.audio import fbank as jfbank
from jyutvoice_tpu.audio import mel as jmel
from jyutvoice_tpu.audio import resample as jresample
from jyutvoice_tpu.audio import whisper_mel as jwhisper
from jyutvoice_tpu.models import campplus as jcampplus
from jyutvoice_tpu.models import flow_encoder as jflow
from jyutvoice_tpu.models import s3_tokenizer as js3
from jyutvoice_tpu.nn import attention as jattn
from jyutvoice_tpu_torch import config as port_config
from jyutvoice_tpu_torch.audio import fbank, mel, resample, whisper_mel
from jyutvoice_tpu_torch.models import campplus, flow_encoder, s3_tokenizer
from jyutvoice_tpu_torch.nn import attention
from jyutvoice_tpu_torch.weights.from_jax import load_jax_params
from chip_smoke import flow_encoder_state, hift_state
from torch_port_setup import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL, RTOL = 1e-5, 1e-4

FE_KW = dict(input_size=64, output_size=64, attention_heads=2, linear_units=128,
             num_blocks=2, num_up_blocks=1)
CP_KW = dict(num_layers=(2, 2, 2))
S3_KW = dict(n_mels=128, n_audio_ctx=256, n_audio_state=64, n_audio_head=4, n_audio_layer=2)
JFE, PFE = jax_config.FlowEncoderConfig(**FE_KW), port_config.FlowEncoderConfig(**FE_KW)
JCP, PCP = jcampplus.CampPlusConfig(**CP_KW), campplus.CampPlusConfig(**CP_KW)
JS3, PS3 = js3.S3TokenizerConfig(**S3_KW), s3_tokenizer.S3TokenizerConfig(**S3_KW)


# the JAX package's functions, jitted (one compile instead of one per op)
J_CAMPPLUS = jax.jit(jcampplus.apply_campplus, static_argnums=1)
J_FLOW = jax.jit(jflow.apply_flow_encoder, static_argnums=1,
                 static_argnames=("streaming", "exact_pad"))
J_S3_ENC = jax.jit(js3.apply_s3_encoder, static_argnums=1)
J_S3_TOK = jax.jit(js3.apply_s3_tokenizer, static_argnums=1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _speechlike(seconds, sr, seed):
    """A voiced, amplitude-modulated signal with a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(k * phase) / k for k in range(1, 12))
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * 3.1 * t) ** 2
    return (0.2 * x / np.abs(x).max() + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# audio front ends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sr_in,sr_out", [(16000, 24000), (44100, 24000), (24000, 16000),
                                          (44100, 16000)])
def test_resample_matches_jax(sr_in, sr_out):
    x = _speechlike(0.37, sr_in, 0)
    np.testing.assert_array_equal(resample.resample_sinc(x, sr_in, sr_out),
                                  jresample.resample_sinc(x, sr_in, sr_out))


def test_mel_matches_jax():
    np.testing.assert_array_equal(mel.mel_filterbank(24000, 1920, 80, 0.0, 8000.0),
                                  jmel.mel_filterbank(24000, 1920, 80, 0.0, 8000.0))
    y = np.stack([_speechlike(1.3, 24000, s) for s in (1, 2)])
    port, ref = mel.MelSpec(), jmel.MelSpec()
    # log-mel values reach -11.5 (the floor) to about 2: atol 1e-4
    _close(port(torch.from_numpy(y)), ref(jnp.asarray(y)), atol=1e-4)
    _close(mel.stft_magnitude(torch.from_numpy(y), 1920, 480, 1920),
           jmel.stft_magnitude(jnp.asarray(y), 1920, 480, 1920), atol=1e-4)
    yp = np.pad(y, ((0, 0), (720, 720)), mode="reflect")
    _close(port.from_padded(torch.from_numpy(yp)), ref.from_padded(jnp.asarray(yp)), atol=1e-4)


def test_kaldi_fbank_matches_jax():
    wav = _speechlike(1.21, 16000, 3)
    _close(fbank.kaldi_fbank(wav), jfbank.kaldi_fbank(wav))
    rows = [_speechlike(s, 16000, 4 + i) for i, s in enumerate((1.21, 0.8))]
    buf = np.zeros((2, 20000), np.float32)
    for i, r in enumerate(rows):
        buf[i, : len(r)] = r
    lens = np.array([len(r) for r in rows])
    got, got_len = fbank.kaldi_fbank_batch(torch.from_numpy(buf), torch.from_numpy(lens))
    want, want_len = jfbank.kaldi_fbank_batch(jnp.asarray(buf), jnp.asarray(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    for i, n in enumerate(got_len.tolist()):
        _close(got[i, :n], np.asarray(want)[i, :n], atol=1e-4)
        # the device version against the host one
        _close(got[i, :n], fbank.kaldi_fbank(rows[i]), atol=2e-3, rtol=1e-3)


def test_whisper_mel_matches_jax():
    wav = _speechlike(1.07, 16000, 5)
    _close(whisper_mel.whisper_log_mel(wav), jwhisper.whisper_log_mel(wav))
    rows = [_speechlike(s, 16000, 6 + i) for i, s in enumerate((1.07, 0.61))]
    buf = np.zeros((2, 18000), np.float32)
    for i, r in enumerate(rows):
        p = np.pad(r, (200, 200), mode="reflect")
        buf[i, : len(p)] = p
    lens = np.array([len(r) for r in rows])
    got, got_len = whisper_mel.whisper_log_mel_batch(torch.from_numpy(buf), torch.from_numpy(lens))
    want, want_len = jwhisper.whisper_log_mel_batch(jnp.asarray(buf), jnp.asarray(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    for i, n in enumerate(got_len.tolist()):
        _close(got[i, :n], np.asarray(want)[i, :n])
        _close(got[i, :n], whisper_mel.whisper_log_mel(rows[i]).T, atol=1e-4)


# ---------------------------------------------------------------------------
# relative-position attention
# ---------------------------------------------------------------------------


def test_rel_pos_emb_and_shift():
    _close(attention.espnet_rel_pos_emb(37, 64), jattn.espnet_rel_pos_emb(37, 64), atol=1e-6)
    rng = np.random.default_rng(0)
    # the flat path (W = 2T - 1, and a narrower band), and the gather path
    # (one query row whose band is the whole row)
    for t_q, w, t_k in ((9, 17, 9), (5, 12, 6), (1, 3, 1), (1, 4, 4)):
        x = rng.standard_normal((2, 3, t_q, w)).astype(np.float32)
        np.testing.assert_array_equal(
            attention.rel_shift_gather(torch.from_numpy(x), t_q, t_k).numpy(),
            np.asarray(jattn.rel_shift_gather(jnp.asarray(x), t_q, t_k)))


def test_rel_mha_matches_jax():
    tree = _np(jattn.rel_mha_init(jax.random.PRNGKey(0), 64, 2))
    port = load_jax_params(attention.RelMHA(64, 2), tree)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 64)).astype(np.float32)
    pos = np.asarray(jattn.espnet_rel_pos_emb(11, 64))
    lens = np.array([11, 7])
    bias = np.where(np.arange(11)[None, :] < lens[:, None], 0.0, -1e10)[:, None, None, :]
    want = jattn.rel_mha(tree, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(bias), 2)
    got = port(torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(bias).float(), 2)
    _close(got, want)


# ---------------------------------------------------------------------------
# flow encoder
# ---------------------------------------------------------------------------

FE_OPTIONS = {
    "live": {},
    "macaron+conv_bn": dict(macaron_style=True, use_cnn_module=True, cnn_module_kernel=7),
    "conv_ln_causal": dict(use_cnn_module=True, cnn_module_kernel=5,
                           cnn_module_norm="layer_norm", causal_cnn=True),
}


def _flow_pair(opts, seed=2):
    jcfg = dataclasses.replace(JFE, **opts)
    tree = _np(jflow.init_flow_encoder(jax.random.PRNGKey(seed), jcfg))
    _perturb_norms(tree, seed)
    pcfg = dataclasses.replace(PFE, **opts)
    return jcfg, tree, load_jax_params(flow_encoder.FlowEncoder(pcfg), tree)


def _perturb_norms(tree, seed):
    """Give batch norms non-trivial running statistics."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            if "mean" in node and "var" in node:
                node["mean"] = rng.normal(0, 0.2, node["mean"].shape).astype(np.float32)
                node["var"] = rng.uniform(0.5, 1.5, node["var"].shape).astype(np.float32)
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(tree)


def _tokens(lengths, t, seed=3, vocab=6561):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (len(lengths), t)).astype(np.int32)
    for i, n in enumerate(lengths):
        tok[i, n:] = 0
    return tok, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("opts", list(FE_OPTIONS), ids=list(FE_OPTIONS))
@pytest.mark.parametrize("streaming,exact_pad", [(False, False), (True, False), (False, True)])
def test_flow_encoder_matches_jax(opts, streaming, exact_pad):
    jcfg, tree, port = _flow_pair(FE_OPTIONS[opts])
    tok, lens = _tokens([40, 27], 40)
    h_ref, len_ref = J_FLOW(tree, jcfg, jnp.asarray(tok), jnp.asarray(lens),
                            streaming=streaming, exact_pad=exact_pad)
    with torch.no_grad():
        h, h_len = flow_encoder.apply_flow_encoder(
            port, torch.from_numpy(tok), torch.from_numpy(lens), streaming=streaming,
            exact_pad=exact_pad)
    np.testing.assert_array_equal(h_len.numpy(), np.asarray(len_ref))
    _close(h, h_ref, atol=1e-4)


@pytest.mark.parametrize("opts", [{}, dict(macaron_style=True)], ids=["live", "macaron"])
def test_flow_encoder_bucket_padding_is_exact(opts):
    """exact_pad: a bucket-padded run equals the exact-length run (the
    convolution module reads pw1(0) at the padding, as the reference's
    does, so it is left out here)."""
    _, _, port = _flow_pair(opts)
    tok, lens = _tokens([27], 27, seed=4)
    padded = np.zeros((1, 64), np.int32)
    padded[:, :27] = tok
    with torch.no_grad():
        exact, _ = flow_encoder.apply_flow_encoder(port, torch.from_numpy(tok),
                                                   torch.from_numpy(lens), exact_pad=True)
        bucket, _ = flow_encoder.apply_flow_encoder(port, torch.from_numpy(padded),
                                                    torch.from_numpy(lens), exact_pad=True)
    _close(bucket[:, :54], exact, atol=1e-4)


# ---------------------------------------------------------------------------
# CAM++
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def campplus_pair():
    tree = _np(jcampplus.init_campplus(jax.random.PRNGKey(3), JCP))
    _perturb_norms(tree, 3)
    return tree, campplus.build_campplus(tree, PCP)


def _feat(t, seed):
    f = np.random.default_rng(seed).standard_normal((1, t, 80)).astype(np.float32)
    return f - f.mean(axis=1, keepdims=True)


def test_campplus_matches_jax(campplus_pair):
    tree, port = campplus_pair
    feat = _feat(237, 5)  # T=237: a partial last pooling segment
    padded = np.zeros((2, 300, 80), np.float32)
    padded[0, :237] = feat[0]
    padded[1, :150] = feat[0, :150]
    padded[0, 237:] = 123.0  # garbage in the padding must not leak
    t_len = np.array([237, 150])
    with torch.no_grad():
        got = campplus.apply_campplus(port, torch.from_numpy(feat))
        got_pad = campplus.apply_campplus(port, torch.from_numpy(padded), torch.from_numpy(t_len))
    _close(got, J_CAMPPLUS(tree, JCP, jnp.asarray(feat)), atol=1e-4)
    want_pad = J_CAMPPLUS(tree, JCP, jnp.asarray(padded), jnp.asarray(t_len))
    _close(got_pad, want_pad, atol=1e-4)
    # the bucket-padded run equals the exact-length one
    _close(got_pad[:1], got, atol=1e-4)


def test_campplus_builds_optional_biases():
    """A tree converted from a folded ONNX export carries conv biases and an
    affine dense batch norm: the module takes them."""
    tree = _np(jcampplus.init_campplus(jax.random.PRNGKey(4), JCP))
    tree["head"]["conv1"]["b"] = np.full(JCP.m_channels, 0.1, np.float32)
    tree["dense"]["bn"]["gamma"] = np.full(JCP.embedding_size, 2.0, np.float32)
    tree["dense"]["bn"]["beta"] = np.full(JCP.embedding_size, 0.5, np.float32)
    port = campplus.build_campplus(tree, PCP)
    feat = _feat(120, 6)
    with torch.no_grad():
        got = campplus.apply_campplus(port, torch.from_numpy(feat))
    _close(got, J_CAMPPLUS(tree, JCP, jnp.asarray(feat)), atol=1e-4)


# ---------------------------------------------------------------------------
# S3 tokenizer
# ---------------------------------------------------------------------------


def _fsq_edge(model, h):
    """(B, T) bool: a value before FSQ's rounding lies within 1e-4 of a
    rounding edge (+-0.5), where the two packages may round apart."""
    z = torch.tanh(model.fsq(h)) * s3_tokenizer._FSQ_TANH_SCALE
    return (torch.abs(torch.abs(z) - 0.5) < 1e-4).any(dim=-1).numpy()


def _assert_tokens(got, want, edge):
    """Tokens exactly, except at FSQ edges, and those few: at most 1 % of
    them (at least 1)."""
    assert got.shape == want.shape == edge.shape
    differ = got != want
    assert not (differ & ~edge).any()
    assert differ.sum() <= max(1, int(0.01 * differ.size))


def test_s3_matches_jax():
    tree = _np(js3.init_s3_tokenizer(jax.random.PRNGKey(1), JS3))
    port = load_jax_params(s3_tokenizer.S3Tokenizer(PS3), tree)
    rng = np.random.default_rng(7)
    mel_in = rng.standard_normal((2, 203, 128)).astype(np.float32)
    t_len = np.array([203, 150])
    mel_in[1, 150:] = 0.0
    for tl in (None, t_len):
        args = () if tl is None else (torch.from_numpy(tl),)
        jargs = () if tl is None else (jnp.asarray(tl),)
        with torch.no_grad():
            h = s3_tokenizer.apply_s3_encoder(port, torch.from_numpy(mel_in), *args)
            tok = s3_tokenizer.apply_s3_tokenizer(port, torch.from_numpy(mel_in), *args)
            edge = _fsq_edge(port, h)
        h_ref = J_S3_ENC(tree, JS3, jnp.asarray(mel_in), *jargs)
        tok_ref = np.asarray(J_S3_TOK(tree, JS3, jnp.asarray(mel_in), *jargs))
        n = 51 if tl is None else None
        valid = np.ones(tok_ref.shape, bool) if tl is None else (
            np.arange(tok_ref.shape[1])[None, :] < s3_tokenizer.out_len(t_len)[:, None])
        assert n is None or tok_ref.shape[1] == n
        _close(np.asarray(h)[valid], np.asarray(h_ref)[valid], atol=1e-4)
        _assert_tokens(tok.numpy()[valid], tok_ref[valid], edge[valid])
    # bucket padding: a row alone at its exact length equals its padded run
    with torch.no_grad():
        alone = s3_tokenizer.apply_s3_tokenizer(port, torch.from_numpy(mel_in[1:, :150]))
        padded = s3_tokenizer.apply_s3_tokenizer(port, torch.from_numpy(mel_in[1:]),
                                                 torch.tensor([150]))
    np.testing.assert_array_equal(padded[:, : alone.shape[1]].numpy(), alone.numpy())
    # FSQ codes cover the vocabulary's ends, as the export's
    fsq = load_jax_params(s3_tokenizer.core.Linear(8, 8),
                          {"w": np.eye(8, dtype=np.float32) * 100.0, "b": np.zeros(8, np.float32)})
    codes = [int(s3_tokenizer.fsq_encode(fsq, PS3, torch.full((1, 1, 8), v))[0, 0])
             for v in (1.0, -1.0, 0.0)]
    assert codes == [PS3.vocab_size - 1, 0, (PS3.vocab_size - 1) // 2]
    assert s3_tokenizer._FSQ_TANH_SCALE == js3._FSQ_TANH_SCALE


# ---------------------------------------------------------------------------
# weight converters, on stand-ins the tests build
# ---------------------------------------------------------------------------


def _assert_same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), f"{path}: {sorted(a)} vs {sorted(b)}"
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


@pytest.mark.parametrize("opts", ["live", "macaron+conv_bn"])
def test_convert_flow_encoder_matches_jax_and_audits(opts):
    from jyutvoice_tpu.weights import torch_convert as jtc
    from jyutvoice_tpu_torch.weights import torch_convert as tc
    from jyutvoice_tpu_torch.weights.audit import ConversionAuditError, audit_convert

    jcfg, tree, _ = _flow_pair(FE_OPTIONS[opts])
    pcfg = dataclasses.replace(PFE, **FE_OPTIONS[opts])
    sd = flow_encoder_state(tree)
    got, report = audit_convert(tc.convert_flow_encoder, sd, pcfg)
    assert report.ok and len(report.consumed) + len(report.allowed) == len(sd)
    _assert_same_tree(got, _np(jtc.convert_flow_encoder(sd, jcfg)))
    _assert_same_tree(got, tree)  # and the stand-in round-trips
    load_jax_params(flow_encoder.FlowEncoder(pcfg), got)
    with pytest.raises(ConversionAuditError, match="never consumed"):
        audit_convert(tc.convert_flow_encoder, {**sd, "encoder.extra.weight": np.zeros(3)}, pcfg)
    renamed = dict(sd)
    renamed["encoder.after_norm.gain"] = renamed.pop("encoder.after_norm.weight")
    with pytest.raises((ConversionAuditError, KeyError)):
        audit_convert(tc.convert_flow_encoder, renamed, pcfg)


def _s3_standin(seed=0):
    from tests import refshim_s3

    torch.manual_seed(seed)
    m = refshim_s3.S3TokenizerV2(refshim_s3.S3Config(
        n_mels=JS3.n_mels, n_audio_ctx=JS3.n_audio_ctx, n_audio_state=JS3.n_audio_state,
        n_audio_head=JS3.n_audio_head, n_audio_layer=JS3.n_audio_layer))
    with torch.no_grad():  # distinct tensors, as in a real checkpoint
        for p in m.parameters():
            p.add_(torch.randn_like(p) * 0.02)
    return m.eval()


def test_s3_from_torch_matches_jax(tmp_path):
    from jyutvoice_tpu.weights import s3_convert as js3c
    from jyutvoice_tpu_torch.weights import s3_convert

    path = str(tmp_path / "s3.pt")
    torch.save(_s3_standin().state_dict(), path)
    got = s3_convert.s3_from_torch(path, PS3)
    _assert_same_tree(got, _np(js3c.s3_from_torch(path, JS3)))
    load_jax_params(s3_tokenizer.S3Tokenizer(PS3), got)


def _export_onnx(module, example, path, fold=False):
    """torch.onnx export without the `onnx` package (its final onnxscript
    pass is a no-op without custom ops), as tests/test_campplus.py does."""
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes
    try:
        torch.onnx.export(module, example, path, do_constant_folding=fold, dynamo=False)
    finally:
        onnx_proto_utils._add_onnxscript_fn = orig


class _S3Export(torch.nn.Module):
    """The encoder and the FSQ projection under their module-path names."""

    def __init__(self, m):
        super().__init__()
        self.encoder, self.quantizer = m.encoder, m.quantizer

    def forward(self, mel):
        return self.quantizer.project_down(self.encoder(mel))


def test_s3_from_onnx_matches_jax(tmp_path):
    from jyutvoice_tpu.weights import s3_convert as js3c
    from jyutvoice_tpu_torch.weights import s3_convert

    m = _s3_standin(1)
    mel_in = torch.randn(1, JS3.n_mels, 80)
    named, mangled = str(tmp_path / "s3.onnx"), str(tmp_path / "s3_enc.onnx")
    _export_onnx(_S3Export(m), mel_in, named)
    got = s3_convert.s3_from_onnx(named, PS3)
    _assert_same_tree(got, _np(js3c.s3_from_onnx(named, JS3)))
    ref_sd = {k: v.numpy() for k, v in m.state_dict().items()}
    np.testing.assert_array_equal(got["conv1"]["w"], ref_sd["encoder.conv1.weight"].transpose(2, 1, 0))
    # an export without module-path names (the encoder alone) is refused by both
    _export_onnx(m.encoder, mel_in, mangled)
    with pytest.raises(ValueError, match="s3_from_torch"):
        s3_convert.s3_from_onnx(mangled, PS3)
    with pytest.raises(ValueError, match="s3_from_torch"):
        js3c.s3_from_onnx(mangled, JS3)


@pytest.mark.parametrize("component", ["campplus", "tokenizer"])
def test_unreadable_artifact_raises(tmp_path, component):
    """With no onnxruntime backend in the port, an ONNX file that the native
    CAM++ or S3 cannot read raises instead of leaving a zero speaker
    embedding or no tokens."""
    from jyutvoice_tpu_torch.pipeline.prompt import CampPlusEmbedder, SpeechTokenizer

    path = str(tmp_path / "linear.onnx")
    _export_onnx(torch.nn.Linear(4, 4), torch.zeros(1, 4), path)
    if component == "campplus":
        with pytest.raises(ValueError, match="does not match expected slot"):
            CampPlusEmbedder(path, device="cpu")
    else:
        with pytest.raises(ValueError, match="s3_from_torch"):
            SpeechTokenizer(path, device="cpu")


@pytest.mark.parametrize("fold", [False, True], ids=["names", "structural"])
def test_campplus_from_onnx_matches_jax(tmp_path, fold):
    """Unfolded exports keep module-path names (the name map); folded ones
    fold batch norms into convs (the structural binding)."""
    from jyutvoice_tpu.weights import campplus_convert as jcc
    from jyutvoice_tpu_torch.weights import campplus_convert
    from tests.refshim_campplus import CAMPPlus

    torch.manual_seed(2)
    model = CAMPPlus(feat_dim=80, embedding_size=192).eval()
    path = str(tmp_path / "campplus.onnx")
    _export_onnx(model, torch.from_numpy(_feat(150, 1)), path, fold=fold)
    got = campplus_convert.campplus_from_onnx(path)
    _assert_same_tree(got, _np(jcc.campplus_from_onnx(path)))
    port = campplus.build_campplus(got)
    feat = _feat(150, 2)
    with torch.no_grad():
        ref = model(torch.from_numpy(feat)).numpy()
        out = campplus.apply_campplus(port, torch.from_numpy(feat)).numpy()
    # folding rounds the batch norms into the conv weights inside the exporter
    _close(out, ref, atol=5e-3 if fold else 2e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# PromptExtractor and the cloned request
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trees():
    fe = _np(jflow.init_flow_encoder(jax.random.PRNGKey(2), JFE))
    cp = _np(jcampplus.init_campplus(jax.random.PRNGKey(0), JCP))
    s3 = _np(js3.init_s3_tokenizer(jax.random.PRNGKey(1), JS3))
    _perturb_norms(cp, 0)
    return fe, cp, s3


def _small_models(mp):
    """Monkeypatch the port extractor's default CAM++ and S3 configs to the
    reduced ones (the JAX tests set theirs on the built extractor)."""
    from jyutvoice_tpu_torch.pipeline import prompt

    mp.setattr(prompt, "CampPlusConfig", lambda: PCP)
    mp.setattr(prompt, "S3TokenizerConfig", lambda: PS3)


def _extractors(trees):
    from jyutvoice_tpu.pipeline.prompt import PromptExtractor as JaxExtractor
    from jyutvoice_tpu_torch.pipeline.prompt import PromptExtractor

    fe, cp, s3 = trees
    jex = JaxExtractor(flow_encoder_params=fe, flow_encoder_cfg=JFE)
    jex.embedder.cfg, jex.embedder.params = JCP, cp
    jex.tokenizer.cfg, jex.tokenizer.params = JS3, s3
    with pytest.MonkeyPatch.context() as mp:
        _small_models(mp)
        pex = PromptExtractor(flow_encoder_params=fe, flow_encoder_cfg=PFE, device="cpu",
                              campplus_params=cp, tokenizer_params=s3)
    return jex, pex


def _rows():
    # mixed lengths and rates: two rows share a bucket, one lands in a larger
    # one, one is no multiple of the hop, one is too short
    return ([_speechlike(s, sr, i) for i, (s, sr) in
             enumerate(((1.3, 24000), (1.1, 16000), (2.6, 44100), (1.23, 24000), (0.01, 16000)))],
            [24000, 16000, 44100, 24000, 16000])


@torch.no_grad()
def _token_edges(pex, audio, sr):
    """Per token of `audio`: whether the port's S3 puts a value within 1e-4
    of an FSQ rounding edge (on the host whisper mel, exact length)."""
    wav16 = resample.resample_sinc(audio, sr, 16000)
    mel_in = torch.from_numpy(np.ascontiguousarray(whisper_mel.whisper_log_mel(wav16).T[None]))
    model = pex.tokenizer.model
    return _fsq_edge(model, s3_tokenizer.apply_s3_encoder(model, mel_in))[0]


def _assert_features(pex, got, want, audio, sr):
    """The port's features against the JAX extractor's: tokens exactly off
    FSQ edges; prompt_h always, from the port's flow encoder on the JAX
    tokens where the token sequences differ."""
    _close(got.prompt_feat, want.prompt_feat, atol=1e-4)
    _close(got.spk_embed, want.spk_embed, atol=1e-4, rtol=1e-3)
    n = len(want.speech_tokens)
    _assert_tokens(got.speech_tokens, want.speech_tokens, _token_edges(pex, audio, sr)[:n])
    assert got.prompt_h.shape == want.prompt_h.shape == got.prompt_feat.shape
    h = got.prompt_h
    if (got.speech_tokens != want.speech_tokens).any():
        h = pex._encode_tokens(want.speech_tokens)[: len(want.prompt_h)]
    _close(h, want.prompt_h, atol=1e-4)


@pytest.mark.parametrize("device_dsp", [False, True])
def test_extract_batch_matches_jax_and_single(trees, device_dsp):
    from jyutvoice_tpu_torch.pipeline.prompt import PromptFeatures

    jex, pex = _extractors(trees)
    audios, srs = _rows()
    got = pex.extract_batch(audios, srs, device_dsp=device_dsp)
    want = jex.extract_batch(audios, srs, device_dsp=device_dsp)
    assert isinstance(got[-1], ValueError) and isinstance(want[-1], ValueError)
    for g, w, a, sr in zip(got[:-1], want[:-1], audios, srs):
        assert isinstance(g, PromptFeatures), g
        _assert_features(pex, g, w, a, sr)
        single = pex._extract_single(a, sr)
        np.testing.assert_array_equal(g.speech_tokens, single.speech_tokens)
        _close(g.prompt_feat, single.prompt_feat, atol=1e-4)
        _close(g.spk_embed, single.spk_embed, atol=1e-4, rtol=1e-4)
        _close(g.prompt_h, single.prompt_h, atol=1e-4)


def test_extractor_call_and_fallbacks(trees):
    from jyutvoice_tpu_torch.pipeline.prompt import PromptExtractor

    jex, pex = _extractors(trees)
    audio = _speechlike(1.4, 22050, 9)
    _assert_features(pex, pex(audio, 22050), jex(audio, 22050), audio, 22050)
    with pytest.raises(ValueError, match="too short"):
        pex(np.zeros(100, np.float32), 16000)
    # no artifacts: a zero speaker embedding and no tokens, as the JAX package
    bare = PromptExtractor(device="cpu")
    out = bare(audio, 22050)
    assert out.prompt_h is None and out.speech_tokens is None
    np.testing.assert_array_equal(out.spk_embed, np.zeros(192, np.float32))
    _close(out.prompt_feat, jex(audio, 22050).prompt_feat[: out.prompt_feat.shape[0]],
           atol=1e-4)


@pytest.fixture(scope="module")
def clone_setup(trees):
    """Both packages' synthesizers on the small TTS config, the flow
    encoder's projection at its 80 mels."""
    from jyutvoice_tpu.pipeline.synthesize import Synthesizer as JaxSynthesizer
    from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer
    from jyutvoice_tpu_torch.weights import random_init
    from torch_port_setup import JAX_CFG, PORT_CFG

    # the port's numpy trees (same paths and shapes as init_tts / init_hift)
    # feed both packages
    tt = random_init.init_tts_tree(PORT_CFG.tts, seed=5)
    th = random_init.init_hift_tree(PORT_CFG.hift, seed=6)
    return (JaxSynthesizer(JAX_CFG, tt, th), Synthesizer(PORT_CFG, tt, th, device="cpu"),
            tt, th)


def test_cloned_request_matches_jax(trees, clone_setup):
    """Reference audio -> each package's extractor -> its Synthesizer."""
    jax_s, port_s, _, _ = clone_setup
    jex, pex = _extractors(trees)
    audio = _speechlike(1.9, 24000, 11)
    pf, jf = pex(audio, 24000), jex(audio, 24000)
    _assert_features(pex, pf, jf, audio, 24000)
    kw = dict(lang="yue", phone="hou2 sai3 gaai3", n_timesteps=2)
    out = port_s.synthesize("好世界", spk_embed=pf.spk_embed, prompt_feat=pf.prompt_feat,
                            prompt_h=pf.prompt_h, **kw)
    ref = jax_s.synthesize("好世界", spk_embed=jf.spk_embed, prompt_feat=jf.prompt_feat,
                           prompt_h=jf.prompt_h, **kw)
    assert out.mel_frames == ref.mel_frames
    assert np.abs(out.mel - ref.mel).mean() < 1e-2
    assert np.isfinite(out.wav).all() and out.wav.shape == (out.mel_frames * 480,)


def _write_wav(path, audio, sr):
    import wave

    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16).tobytes())


def test_infer_cli_ref_audio_with_torch_checkpoints(tmp_path, trees, clone_setup, monkeypatch):
    """cli.infer --ref-audio on the CPU with .ckpt / .pt trees for --ckpt,
    --hift and --flow-encoder, a torch tokenizer checkpoint and a CAM++ ONNX
    stand-in: the same result as the library path on the same trees."""
    from jyutvoice_tpu.weights.torch_export import save_torch_checkpoint
    from jyutvoice_tpu_torch.cli import infer
    from jyutvoice_tpu_torch.pipeline import prompt
    from jyutvoice_tpu_torch.weights import campplus_convert, s3_convert
    from tests.refshim_campplus import CAMPPlus
    from torch_port_setup import PORT_CFG

    _, port_s, tt, th = clone_setup
    fe, _, _ = trees
    cfg = dataclasses.replace(PORT_CFG, flow_encoder=PFE)
    paths = {k: str(tmp_path / n) for k, n in (("tts", "tts.ckpt"), ("hift", "hift.pt"),
                                                ("fe", "flow.pt"), ("tok", "s3.pt"),
                                                ("cp", "campplus.onnx"),
                                                ("wav", "ref.wav"), ("out", "out.wav"))}
    save_torch_checkpoint(paths["tts"], tt)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in hift_state(th).items()}, paths["hift"])
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in flow_encoder_state(fe).items()}, paths["fe"])
    torch.save(_s3_standin(3).state_dict(), paths["tok"])
    torch.manual_seed(4)
    _export_onnx(CAMPPlus(feat_dim=80, embedding_size=192).eval(),
                 torch.from_numpy(_feat(150, 1)), paths["cp"])
    audio = _speechlike(1.5, 16000, 12)
    _write_wav(paths["wav"], audio, 16000)

    # the reduced tokenizer; CAM++ is at its default config
    monkeypatch.setattr(prompt, "S3TokenizerConfig", lambda: PS3)
    res = infer.main(
        ["--text", "好", "--phone", "hou2", "--n-timesteps", "2", "--device", "cpu",
         "--ckpt", paths["tts"], "--hift", paths["hift"], "--flow-encoder", paths["fe"],
         "--tokenizer-torch", paths["tok"], "--campplus-onnx", paths["cp"],
         "--ref-audio", paths["wav"], "--output", paths["out"]],
        cfg=cfg,
    )
    assert os.path.getsize(paths["out"]) > 44
    ex = prompt.PromptExtractor(
        flow_encoder_params=fe, flow_encoder_cfg=PFE, device="cpu",
        campplus_params=campplus_convert.campplus_from_onnx(paths["cp"]),
        tokenizer_params=s3_convert.s3_from_torch(paths["tok"], PS3))
    wav, sr = infer.load_wav(paths["wav"])
    f = ex(wav, sr)
    assert np.abs(f.spk_embed).max() > 0
    direct = port_s.synthesize("好", lang="yue", phone="hou2", spk_embed=f.spk_embed,
                               prompt_feat=f.prompt_feat, prompt_h=f.prompt_h,
                               n_timesteps=2, length_scale=0.9)
    assert res.mel_frames == direct.mel_frames
    np.testing.assert_allclose(res.wav, direct.wav, atol=1e-6)
