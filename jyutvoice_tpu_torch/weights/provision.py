"""Pretrained-weight provisioning: the reference's torch artifacts ->
parameter trees in the JAX package's layout, saved as `.npz`.

The counterpart of the JAX package's `weights/provision.py` (the reference's
scripts/download_pretrain_weights.py): given the CosyVoice2 artifacts
(flow.pt, hift.pt) it splits the flow checkpoint by key prefix into the
flow encoder and the decoder half (download_pretrain_weights.py:168-215),
converts everything to trees saved as `.npz` (`flow_encoder.npz`,
`flow_decoder.npz`, `hift.npz`, `tts.npz`, `campplus.npz`,
`s3_tokenizer.npz`), and can assemble the fine-tune's starting point
`tts_init.npz`: a random TTS tree with the frozen CosyVoice2 decoder and
speaker affine injected (the reference's pretrain.pt,
download_pretrain_weights.py:52-101). The trees load into this package's
modules through `weights/from_jax.py`, and into the JAX package as they are.

Every torch conversion runs under the key-coverage audit (`weights/audit.py`).
Artifacts can be fetched from the reference's HuggingFace URLs with
download=True (download_pretrain_weights.py:219-236); a failed fetch is
skipped, so local paths work offline. `verify` synthesizes a sentence from
the provisioned trees with this package's `Synthesizer`, on the GPU unless
device="cpu".
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

import numpy as np

from jyutvoice_tpu_torch.config import JyutVoiceConfig
from jyutvoice_tpu_torch.weights import torch_convert as tc
from jyutvoice_tpu_torch.weights.audit import audit_convert
from jyutvoice_tpu_torch.weights.from_jax import load_pytree_npz, save_pytree_npz

log = logging.getLogger(__name__)

# key prefixes of the reference's splitter (download_pretrain_weights.py:182-200)
FLOW_ENCODER_PREFIXES = ("encoder.", "input_embedding.", "encoder_proj.")
FLOW_DECODER_PREFIXES = ("decoder.", "spk_embed_affine_layer.")

# the four reference artifacts (download_pretrain_weights.py:219-226)
ARTIFACT_URLS = {
    "flow.pt": "https://huggingface.co/lucyknada/CosyVoice2-0.5B/resolve/main/flow.pt",
    "hift.pt": "https://huggingface.co/lucyknada/CosyVoice2-0.5B/resolve/main/hift.pt",
    "campplus.onnx": (
        "https://huggingface.co/FunAudioLLM/CosyVoice2-0.5B/resolve/main/campplus.onnx"
    ),
    "speech_tokenizer_v2.onnx": (
        "https://huggingface.co/FunAudioLLM/CosyVoice2-0.5B/resolve/main/"
        "speech_tokenizer_v2.onnx"
    ),
}


def _urllib_fetch(url: str, dest: str) -> None:
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r, open(dest, "wb") as f:
        while True:
            chunk = r.read(1 << 20)
            if not chunk:
                break
            f.write(chunk)


def download_artifacts(
    dest_dir: str,
    urls: Optional[Dict[str, str]] = None,
    fetch=None,
) -> Dict[str, Optional[str]]:
    """Fetch the reference artifacts into dest_dir, skipping any that fail.

    Returns {name: local path or None}. A file already there is never
    fetched again. `fetch(url, dest)` replaces the urllib download (tests
    pass their own)."""
    fetch = fetch or _urllib_fetch
    os.makedirs(dest_dir, exist_ok=True)
    out: Dict[str, Optional[str]] = {}
    for name, url in (urls or ARTIFACT_URLS).items():
        dest = os.path.join(dest_dir, name)
        if os.path.exists(dest):
            log.info("artifact %s already present", dest)
            out[name] = dest
            continue
        # a temporary name and an atomic rename: a killed download must not
        # leave a truncated file that later runs take as present
        part = dest + ".part"
        try:
            fetch(url, part)
            os.replace(part, dest)
            out[name] = dest
            log.info("downloaded %s", name)
        except Exception as e:  # noqa: BLE001 — offline is a supported mode
            if os.path.exists(part):
                os.remove(part)
            out[name] = None
            log.warning("could not download %s (%s); skipping", name, e)
    return out


def assemble_pretrain_tree(decoder_tree: dict, cfg: JyutVoiceConfig, seed: int):
    """A random TTS tree with the converted CosyVoice2 decoder injected, as
    the reference builds pretrain.pt (a random JyutVoiceTTS state_dict with
    load_state_dict(flow_decoder, strict=False)): the encoder and duration
    predictor stay random, the decoder and spk_embed_affine_layer take the
    pretrained values.

    The random half comes from this package's `weights/random_init.py::
    init_tts_tree(cfg.tts, seed)`, not from the JAX package's `init_tts`:
    only the decoder and spk_embed_affine_layer leaves equal those of the
    JAX package's tts_init.npz (bit for bit)."""
    from jyutvoice_tpu_torch.weights.random_init import init_tts_tree

    params = dict(init_tts_tree(cfg.tts, seed=seed))
    params["decoder"] = decoder_tree["decoder"]
    params["spk_embed_affine_layer"] = decoder_tree["spk_embed_affine_layer"]
    return params


def split_flow_state_dict(sd: Dict[str, np.ndarray]):
    """flow.pt -> (flow_encoder_sd, flow_decoder_sd) by key prefix."""
    enc = {k: v for k, v in sd.items() if k.startswith(FLOW_ENCODER_PREFIXES)}
    dec = {k: v for k, v in sd.items() if k.startswith(FLOW_DECODER_PREFIXES)}
    return enc, dec


def provision(
    flow_pt: Optional[str] = None,
    hift_pt: Optional[str] = None,
    tts_ckpt: Optional[str] = None,
    campplus_onnx: Optional[str] = None,
    tokenizer_torch: Optional[str] = None,
    out_dir: str = "pretrained_models_tpu",
    cfg: Optional[JyutVoiceConfig] = None,
    assemble_pretrain: bool = False,
    seed: int = 42,
    download: bool = False,
    download_dir: str = "pretrained_models",
    fetch=None,
    strict_audit: bool = True,
) -> Dict[str, str]:
    """Convert the reference's torch checkpoints into `.npz` trees in out_dir;
    returns {artifact: path}.

    With download=True the reference artifacts are fetched first (skipped
    when offline) and used for every path not given. assemble_pretrain=True
    also writes tts_init.npz (`assemble_pretrain_tree`). campplus.onnx
    converts to campplus.npz, a speech-tokenizer torch checkpoint to
    s3_tokenizer.npz.

    Every torch conversion runs under the key-coverage audit: with
    strict_audit, one source key that no converter reads (a renamed layer,
    an extra tensor), or a flow.pt key outside the split prefixes, aborts
    provisioning with the list of such keys."""
    cfg = cfg or JyutVoiceConfig()
    os.makedirs(out_dir, exist_ok=True)
    written: Dict[str, str] = {}

    def _audited(convert_fn, sd, *args, **kwargs):
        params, report = audit_convert(convert_fn, sd, *args, strict=strict_audit, **kwargs)
        if report.ignored:
            log.warning("%s: %d/%d source keys unconsumed (strict_audit=False): %s",
                        convert_fn.__name__, len(report.ignored), report.total,
                        report.ignored[:10])
        else:
            log.info("%s: consumed %d/%d source keys", convert_fn.__name__,
                     len(report.consumed), report.total)
        return params

    def _save(name, tree):
        path = os.path.join(out_dir, f"{name}.npz")
        save_pytree_npz(path, tree)
        written[name] = path

    if download:
        got = download_artifacts(download_dir, fetch=fetch)
        flow_pt = flow_pt or got.get("flow.pt")
        hift_pt = hift_pt or got.get("hift.pt")
        campplus_onnx = campplus_onnx or got.get("campplus.onnx")
        for name in ("campplus.onnx", "speech_tokenizer_v2.onnx"):
            if got.get(name):
                written[name] = got[name]

    if flow_pt:
        sd = tc.load_torch_state_dict(flow_pt)
        enc_sd, dec_sd = split_flow_state_dict(sd)
        unsplit = set(sd) - set(enc_sd) - set(dec_sd)
        if unsplit:
            msg = (f"flow checkpoint has {len(unsplit)} keys outside the reference's split "
                   f"prefixes (download_pretrain_weights.py:182-200): {sorted(unsplit)[:10]}")
            if strict_audit:
                raise ValueError(msg)
            log.warning("%s", msg)
        _save("flow_encoder", _audited(tc.convert_flow_encoder, enc_sd, cfg.flow_encoder))

        def _convert_decoder_half(dsd):
            return {
                "decoder": tc.convert_estimator(dsd, cfg.tts.cfm.estimator,
                                                prefix="decoder.estimator."),
                "spk_embed_affine_layer": tc._linear(dsd, "spk_embed_affine_layer"),
            }

        decoder_tree = _audited(_convert_decoder_half, dec_sd)
        _save("flow_decoder", decoder_tree)
        if assemble_pretrain:
            _save("tts_init", assemble_pretrain_tree(decoder_tree, cfg, seed))

    if hift_pt:
        _save("hift", _audited(tc.convert_hift, tc.load_torch_state_dict(hift_pt), cfg.hift))

    if tts_ckpt:
        _save("tts", _audited(tc.convert_tts, tc.load_torch_state_dict(tts_ckpt), cfg.tts))

    if campplus_onnx:
        from jyutvoice_tpu_torch.weights.campplus_convert import campplus_from_onnx

        try:
            _save("campplus", campplus_from_onnx(campplus_onnx))
        except Exception as e:  # noqa: BLE001 — keep provisioning usable
            log.warning("campplus conversion failed (%s)", e)

    if tokenizer_torch:
        from jyutvoice_tpu_torch.weights.s3_convert import s3_from_flat

        # under the same strict audit as the other converters: a tokenizer
        # checkpoint of another revision aborts instead of converting wrongly
        _save("s3_tokenizer", _audited(s3_from_flat, tc.load_torch_state_dict(tokenizer_torch)))

    if assemble_pretrain and "tts_init" not in written:
        raise ValueError("assemble_pretrain requires flow_pt (or a successful download "
                         "of flow.pt)")
    return written


def verify(
    flow_pt: Optional[str] = None,
    hift_pt: Optional[str] = None,
    tts_ckpt: Optional[str] = None,
    out_dir: str = "pretrained_models_tpu",
    cfg: Optional[JyutVoiceConfig] = None,
    text: str = "The quick brown fox jumps over the lazy dog.",
    lang: str = "en",
    phone: Optional[str] = None,
    n_timesteps: int = 10,
    reference_mel: Optional[str] = None,
    download: bool = False,
    download_dir: str = "pretrained_models",
    fetch=None,
    device="cuda",
) -> Dict[str, object]:
    """One-command check of real weights (reference infer.py:271-446):
    provision under the strict audit (assembling tts_init.npz when no
    tts_ckpt is given), synthesize the sentence with this package's
    `Synthesizer` on `device` (a warm-up call, then a timed one), and report
    the xRT, plus the mel MAE against `reference_mel` (.npy of shape (T, 80))
    when one is given. Prints the metrics as one JSON line and returns them."""
    cfg = cfg or JyutVoiceConfig()
    written = provision(
        flow_pt=flow_pt, hift_pt=hift_pt, tts_ckpt=tts_ckpt, out_dir=out_dir, cfg=cfg,
        # flow.pt may only arrive inside provision() through the download
        assemble_pretrain=tts_ckpt is None and (flow_pt is not None or download),
        download=download, download_dir=download_dir, fetch=fetch, strict_audit=True,
    )
    tts_path = written.get("tts") or written.get("tts_init")
    hift_path = written.get("hift")
    if not tts_path or not hift_path:
        raise ValueError(
            f"verification needs a TTS checkpoint ({'ok' if tts_path else 'missing'}) "
            f"and hift.pt ({'ok' if hift_path else 'missing'}); provisioned: {sorted(written)}"
        )

    from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer

    synth = Synthesizer(cfg, load_pytree_npz(tts_path), load_pytree_npz(hift_path),
                        device=device)
    synth.synthesize(text, lang=lang, phone=phone, n_timesteps=n_timesteps)  # warm-up
    t0 = time.perf_counter()
    res = synth.synthesize(text, lang=lang, phone=phone, n_timesteps=n_timesteps)
    elapsed = time.perf_counter() - t0
    audio_s = res.timings["audio_seconds"]
    metrics: Dict[str, object] = {
        "audit": "pass (strict, 100% key coverage)",
        "artifacts": {k: str(v) for k, v in written.items()},
        "mel_frames": res.mel_frames,
        "audio_seconds": round(audio_s, 3),
        "xrt": round(audio_s / max(elapsed, 1e-9), 2),
    }
    if reference_mel:
        want = np.load(reference_mel)
        t = min(len(want), len(res.mel))
        mae = float(np.mean(np.abs(res.mel[:t] - want[:t])))
        metrics["mel_mae"] = mae
        metrics["mel_mae_pass"] = bool(mae < 1e-2)
    print(json.dumps(metrics))
    return metrics
