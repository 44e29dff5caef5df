"""The port's streaming encoder pieces against the JAX package on the CPU:
relative-position attention over a KV cache, the chained flow-encoder chunk
step (and a mid-stream state handed over from JAX), `StreamingTokenEncoder`,
HiFT's source cache and `PromptExtractor(streaming_encoder=True)`.

The flow encoder is the JAX package's random tree at a small config (64-d,
2 + 2 blocks, 4 heads, 4-token chunks, as tests/test_flow_encoder_chunk.py);
inputs come from numpy seeds. Bars: attention atol 1e-5 / rtol 1e-4; the
chained chunks rtol 2e-4 / atol 2e-5, the JAX package's own bar for chunks
against the whole streaming forward (tests/test_flow_encoder_chunk.py:92);
HiFT atol 2e-5 / rtol 1e-4; the extractor's prompt_h atol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jyutvoice_tpu import config as jax_config
from jyutvoice_tpu.models import flow_encoder as jflow
from jyutvoice_tpu.models import hift as jhift
from jyutvoice_tpu.nn import attention as jattn
from jyutvoice_tpu.pipeline import streaming as jstream
from jyutvoice_tpu_torch import config as port_config
from jyutvoice_tpu_torch.models import flow_encoder, hift
from jyutvoice_tpu_torch.nn import attention
from jyutvoice_tpu_torch.pipeline import streaming
from jyutvoice_tpu_torch.weights.from_jax import flow_stream_state_from_jax, load_jax_params
from torch_port_setup import JAX_CFG, PORT_CFG, jax_trees

FE_KW = dict(vocab_size=50, input_size=64, output_size=64, proj_size=80, attention_heads=4,
             linear_units=96, num_blocks=2, num_up_blocks=2, static_chunk_size=4)
JFE, PFE = jax_config.FlowEncoderConfig(**FE_KW), port_config.FlowEncoderConfig(**FE_KW)
CHUNK = 4
J_CHUNK = jax.jit(jflow.apply_flow_encoder_chunk, static_argnums=(1,))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def flow_pair():
    tree = _np(jflow.init_flow_encoder(jax.random.PRNGKey(0), JFE))
    return tree, load_jax_params(flow_encoder.FlowEncoder(PFE), tree).eval()


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("chunks_before", [0, 1, 2], ids=["offset0", "offset_c", "offset_2c"])
def test_rel_mha_chunk_matches_jax(chunks_before):
    """One chunk over a cache that already holds chunks_before chunks."""
    c, t_max, h = 5, 20, 2
    tree = _np(jattn.rel_mha_init(jax.random.PRNGKey(0), 64, h))
    port = load_jax_params(attention.RelMHA(64, h), tree)
    rng = np.random.default_rng(chunks_before)
    x = rng.standard_normal((2, c, 64)).astype(np.float32)
    kv = {k: rng.standard_normal((2, h, t_max, 32)).astype(np.float32) for k in ("k", "v")}
    offset = chunks_before * c
    band = np.array(jattn.espnet_rel_pos_emb(t_max, 64))
    bias = np.where(np.arange(t_max) < offset + c, 0.0, -1e10).astype(np.float32)
    bias = bias[None, None, None, :]
    want, want_kv = jattn.rel_mha_chunk(
        tree, jnp.asarray(x), jnp.asarray(band), {k: jnp.asarray(a) for k, a in kv.items()},
        jnp.asarray(offset, jnp.int32), jnp.asarray(bias), h)
    with torch.no_grad():
        got, got_kv = attention.rel_mha_chunk(
            port, torch.from_numpy(x), torch.from_numpy(band),
            {k: torch.from_numpy(a.copy()) for k, a in kv.items()}, offset,
            torch.from_numpy(bias), h)
    _close(got, want, atol=1e-5, rtol=1e-4)
    for k in ("k", "v"):
        _close(got_kv[k], want_kv[k], atol=1e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="capacity"):
        attention.rel_mha_chunk(port, torch.from_numpy(x), torch.from_numpy(band),
                                {k: torch.from_numpy(a) for k, a in kv.items()}, t_max - c + 1,
                                None, h)


def _chunk_inputs(tokens, length, pos):
    """(chunk tokens, n, context, n_ctx) of the chunk at pos, as the JAX
    package's test chains them."""
    pre = PFE.pre_lookahead_len
    n = min(CHUNK, length - pos)
    tok = np.zeros((1, CHUNK), np.int32)
    tok[0, :n] = tokens[pos : pos + n]
    ctx = np.zeros((1, pre), np.int32)
    n_ctx = min(pre, length - (pos + n))
    ctx[0, :n_ctx] = tokens[pos + n : pos + n + n_ctx]
    return tok, n, ctx, n_ctx


def _jax_step(tree, tokens, length, pos, state):
    tok, n, ctx, n_ctx = _chunk_inputs(tokens, length, pos)
    h, state = J_CHUNK(tree, JFE, jnp.asarray(tok), jnp.asarray(n, jnp.int32),
                       jnp.asarray(ctx), jnp.asarray(n_ctx, jnp.int32), state)
    return np.asarray(h)[0, : n * PFE.upsample_stride], state


@torch.no_grad()
def _port_step(model, tokens, length, pos, state):
    tok, n, ctx, n_ctx = _chunk_inputs(tokens, length, pos)
    h, state = flow_encoder.apply_flow_encoder_chunk(
        model, torch.from_numpy(tok), n, torch.from_numpy(ctx), n_ctx, state)
    return h[0, : n * PFE.upsample_stride].numpy(), state


def _tokens(length, seed=3):
    return np.random.default_rng(seed).integers(0, PFE.vocab_size, length).astype(np.int32)


@pytest.mark.parametrize("length", [8, 11])
def test_flow_encoder_chunks_match_jax_and_whole_stream(flow_pair, length):
    tree, model = flow_pair
    tokens = _tokens(length)
    t_pad = -(-length // CHUNK) * CHUNK
    jstate = jflow.init_stream_state(JFE, t_pad)
    pstate = flow_encoder.init_stream_state(PFE, t_pad)
    want, got = [], []
    for pos in range(0, length, CHUNK):
        h, jstate = _jax_step(tree, tokens, length, pos, jstate)
        want.append(h)
        h, pstate = _port_step(model, tokens, length, pos, pstate)
        got.append(h)
    got, want = np.concatenate(got), np.concatenate(want)
    _close(got, want, atol=2e-5, rtol=2e-4)
    assert pstate.offset == int(jstate.offset) == length
    with torch.no_grad():
        whole, _ = flow_encoder.apply_flow_encoder(
            model, torch.from_numpy(tokens[None]), torch.tensor([length]), streaming=True)
    _close(got, whole[0], atol=2e-5, rtol=2e-4)


def test_flow_encoder_state_handed_over_from_jax(flow_pair):
    """Two chunks in the JAX package, the rest in the port from the JAX
    state, against the JAX package all the way."""
    tree, model = flow_pair
    length = 15
    tokens = _tokens(length, seed=4)
    jstate = jflow.init_stream_state(JFE, 16)
    want = []
    for pos in range(0, length, CHUNK):
        h, jstate = _jax_step(tree, tokens, length, pos, jstate)
        want.append(h)
        if pos == CHUNK:
            handed = flow_stream_state_from_jax(_np(jstate))
    assert handed.offset == 2 * CHUNK
    got = []
    for pos in range(2 * CHUNK, length, CHUNK):
        h, handed = _port_step(model, tokens, length, pos, handed)
        got.append(h)
    _close(np.concatenate(got), np.concatenate(want[2:]), atol=2e-5, rtol=2e-4)


def test_flow_encoder_chunk_refuses_the_conformer_options():
    cfg = dataclasses.replace(PFE, macaron_style=True)
    model = flow_encoder.FlowEncoder(cfg)
    state = flow_encoder.init_stream_state(cfg, 8)
    z = torch.zeros((1, CHUNK), dtype=torch.long)
    with pytest.raises(NotImplementedError):
        flow_encoder.apply_flow_encoder_chunk(model, z, CHUNK, z[:, :3], 3, state)


def test_token_encoder_matches_jax(flow_pair):
    """Tokens pushed in uneven pieces, then flushed: each push returns what
    the JAX encoder returns, and the whole equals the whole streaming
    forward."""
    tree, model = flow_pair
    tokens = _tokens(23, seed=5)
    jenc = jstream.StreamingTokenEncoder(tree, JFE, t_max_tokens=23)
    penc = streaming.StreamingTokenEncoder(model, t_max_tokens=23)
    assert penc.t_max == jenc.t_max == 24
    parts = []
    for lo, hi in ((0, 3), (3, 10), (10, 11), (11, 23)):
        got, want = penc.push(tokens[lo:hi]), jenc.push(tokens[lo:hi])
        assert got.shape == want.shape
        _close(got, want, atol=2e-5, rtol=2e-4)
        parts.append(got)
    got, want = penc.flush(), jenc.flush()
    _close(got, want, atol=2e-5, rtol=2e-4)
    parts.append(got)
    with torch.no_grad():
        whole, _ = flow_encoder.apply_flow_encoder(
            model, torch.from_numpy(tokens[None]), torch.tensor([23]), streaming=True)
    _close(np.concatenate(parts), whole[0], atol=2e-5, rtol=2e-4)
    # reset() starts over on the same caches
    penc.reset()
    again = np.concatenate([penc.push(tokens), penc.flush()])
    _close(again, np.concatenate(parts), atol=1e-6, rtol=1e-6)


def test_token_encoder_guards(flow_pair):
    _, model = flow_pair
    enc = streaming.StreamingTokenEncoder(model, t_max_tokens=8)
    enc.push(_tokens(10))  # one chunk encoded (its lookahead arrived)
    with pytest.raises(ValueError, match="stream exceeds capacity"):
        enc.push(_tokens(6))  # a third chunk would pass the 8-token capacity
    enc.reset()
    enc.push(_tokens(2))
    enc.flush()  # a partial chunk: the stream is finalized
    with pytest.raises(ValueError, match="stream already finalized"):
        enc.push(_tokens(7))
    enc.reset()
    assert enc.push(_tokens(7)).shape == (2 * CHUNK, PFE.proj_size)


@pytest.mark.parametrize("cache", ["zero", "nonzero"])
def test_hift_cache_source_matches_jax(cache):
    _, th = jax_trees()
    port = load_jax_params(hift.HiFT(PORT_CFG.hift), th).eval()
    rng = np.random.default_rng(6)
    mel = rng.standard_normal((2, 20, 80)).astype(np.float32) * 0.5
    n = 8 * PORT_CFG.hift.total_upsample
    src = np.zeros((2, n, 1), np.float32)
    if cache == "nonzero":
        src = (0.1 * rng.standard_normal((2, n, 1))).astype(np.float32)
    want_wav, want_s = jax.jit(
        lambda p, m, c: jhift.hift_inference(p, JAX_CFG.hift, m, cache_source=c))(
        th, jnp.asarray(mel), jnp.asarray(src))
    with torch.no_grad():
        wav, s = hift.hift_inference(port, torch.from_numpy(mel),
                                     cache_source=torch.from_numpy(src))
        plain, _ = hift.hift_inference(port, torch.from_numpy(mel))
    np.testing.assert_array_equal(s[:, :n].numpy(), src)
    _close(s, want_s, atol=2e-5, rtol=1e-4)
    _close(wav, want_wav, atol=2e-5, rtol=1e-4)
    # the cache reaches the waveform: a zero cache too (the first chunk's)
    assert not np.allclose(wav.numpy(), plain.numpy(), atol=1e-6)


def test_prompt_extractor_streaming_encoder_matches_jax(monkeypatch):
    """streaming_encoder=True: prompt_h from the KV-cached encoder, against
    the JAX extractor's in the same mode and the port's whole encoder."""
    from test_torch_port_prompt import JCP, JFE as PJFE, JS3, PCP, PFE as PPFE, PS3
    from test_torch_port_prompt import _perturb_norms, _speechlike

    from jyutvoice_tpu.models import campplus as jcampplus
    from jyutvoice_tpu.models import s3_tokenizer as js3
    from jyutvoice_tpu.pipeline.prompt import PromptExtractor as JaxExtractor
    from jyutvoice_tpu_torch.pipeline import prompt

    fe = _np(jflow.init_flow_encoder(jax.random.PRNGKey(2), PJFE))
    cp = _np(jcampplus.init_campplus(jax.random.PRNGKey(0), JCP))
    s3 = _np(js3.init_s3_tokenizer(jax.random.PRNGKey(1), JS3))
    _perturb_norms(cp, 0)
    jex = JaxExtractor(flow_encoder_params=fe, flow_encoder_cfg=PJFE, streaming_encoder=True,
                       streaming_t_max=64)
    jex.embedder.cfg, jex.embedder.params = JCP, cp
    jex.tokenizer.cfg, jex.tokenizer.params = JS3, s3
    monkeypatch.setattr(prompt, "CampPlusConfig", lambda: PCP)
    monkeypatch.setattr(prompt, "S3TokenizerConfig", lambda: PS3)
    pex = prompt.PromptExtractor(flow_encoder_params=fe, flow_encoder_cfg=PPFE, device="cpu",
                                 campplus_params=cp, tokenizer_params=s3,
                                 streaming_encoder=True, streaming_t_max=64)
    audio = _speechlike(1.3, 16000, 3)
    got, want = pex(audio, 16000), jex(audio, 16000)
    np.testing.assert_array_equal(got.speech_tokens, want.speech_tokens)
    assert got.prompt_h.shape == want.prompt_h.shape == got.prompt_feat.shape
    _close(got.prompt_h, want.prompt_h, atol=1e-4, rtol=1e-4)
    # the same tokens through the whole streaming forward
    with torch.no_grad():
        whole, _ = flow_encoder.apply_flow_encoder(
            pex.flow_encoder, torch.from_numpy(got.speech_tokens[None].astype(np.int64)),
            torch.tensor([len(got.speech_tokens)]), streaming=True)
    _close(got.prompt_h, whole[0, : got.prompt_h.shape[0]], atol=1e-4, rtol=1e-4)
    again = pex(audio, 16000)  # the cached encoder, reset between prompts
    np.testing.assert_array_equal(again.prompt_h, got.prompt_h)
