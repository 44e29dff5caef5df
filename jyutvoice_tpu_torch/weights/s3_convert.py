"""S3 speech tokenizer v2 weight conversion -> the JAX package's tree layout
(numpy), a copy of its `weights/s3_convert.py`.

Sources, in preference order:

  * a torch state_dict (the public s3tokenizer project republishes the
    speech_tokenizer checkpoints with whisper-style module names) —
    s3_from_flat();
  * speech_tokenizer_v2.onnx initializers when the export preserved
    module-path names — s3_from_onnx() (reads via weights/onnx_reader.py).
    The known public export mangles initializer names, so s3_from_onnx
    raises with a pointer to the torch checkpoint in that case rather than
    guessing bindings.

Layouts follow repo conventions: conv1d (K, Cin, Cout); linear (Cin, Cout).
Reference consumer: infer.py:98-145 (extract_speech_token).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from jyutvoice_tpu_torch.models.s3_tokenizer import S3TokenizerConfig, sinusoids

Flat = Dict[str, np.ndarray]


def _linear(flat: Flat, name: str) -> dict:
    p = {"w": flat[f"{name}.weight"].T}
    if f"{name}.bias" in flat:
        p["b"] = flat[f"{name}.bias"]
    return p


def _conv1d(flat: Flat, name: str) -> dict:
    p = {"w": flat[f"{name}.weight"].transpose(2, 1, 0)}
    if f"{name}.bias" in flat:
        p["b"] = flat[f"{name}.bias"]
    return p


def _ln(flat: Flat, name: str) -> dict:
    return {"g": flat[f"{name}.weight"], "b": flat[f"{name}.bias"]}


def s3_from_flat(
    flat: Flat, cfg: S3TokenizerConfig = S3TokenizerConfig()
) -> dict:
    enc = "encoder"
    p = {
        "conv1": _conv1d(flat, f"{enc}.conv1"),
        "conv2": _conv1d(flat, f"{enc}.conv2"),
        "blocks": [],
    }
    if f"{enc}.positional_embedding" in flat:
        p["pos"] = np.asarray(flat[f"{enc}.positional_embedding"])
    else:  # deterministic buffer; some checkpoints omit it
        p["pos"] = sinusoids(cfg.n_audio_ctx, cfg.n_audio_state)
    for i in range(cfg.n_audio_layer):
        b = f"{enc}.blocks.{i}"
        p["blocks"].append(
            {
                "attn": {
                    "q": _linear(flat, f"{b}.attn.query"),
                    "k": _linear(flat, f"{b}.attn.key"),
                    "v": _linear(flat, f"{b}.attn.value"),
                    "out": _linear(flat, f"{b}.attn.out"),
                },
                "attn_ln": _ln(flat, f"{b}.attn_ln"),
                "mlp1": _linear(flat, f"{b}.mlp.0"),
                "mlp2": _linear(flat, f"{b}.mlp.2"),
                "mlp_ln": _ln(flat, f"{b}.mlp_ln"),
            }
        )
    for fsq_name in (
        "quantizer.project_down",
        "quantizer._codebook.project_down",
    ):
        if f"{fsq_name}.weight" in flat:
            p["fsq"] = _linear(flat, fsq_name)
            break
    else:
        raise KeyError("no FSQ project_down weights found")
    return p


def s3_from_torch(path: str, cfg: S3TokenizerConfig = S3TokenizerConfig()) -> dict:
    from jyutvoice_tpu_torch.weights.torch_convert import load_torch_state_dict

    return s3_from_flat(load_torch_state_dict(path), cfg)


def s3_from_onnx(path: str, cfg: S3TokenizerConfig = S3TokenizerConfig()) -> dict:
    from jyutvoice_tpu_torch.weights.onnx_reader import read_onnx

    graph = read_onnx(path)
    try:
        return s3_from_flat(graph.initializers, cfg)
    except KeyError as e:
        raise ValueError(
            "speech_tokenizer onnx export does not preserve module-path "
            "initializer names; convert from the torch checkpoint "
            "(s3_from_torch) instead"
        ) from e
