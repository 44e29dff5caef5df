"""Serving export: one bucket's synthesis graph, captured or exported.

The counterpart of the JAX package's `pipeline/serving.py`, itself the
counterpart of the reference's ONNX/TensorRT export path. The bucketed
synthesis graph (`synthesize_mel` then `hift_vocode_auto`, weights closed
over, `build_serving_fn`) is

  * captured ahead of time (`aot_compile`): on a CUDA device one eager warm
    call, then one `torch.cuda.CUDAGraph` capture, so a server pays the
    host's launches of a bucket once and each request replays the whole
    graph, kernels 1 and 2 inside it (`BucketProgram`); and
  * exported (`export_program`): traced with `torch.export` and saved for
    another process to `load_program`. Attention takes the plain path, as
    the JAX export takes "xla_scores": kernels 1 and 3 are launched through
    ctypes and cannot be traced. Kernel 2 stays, as the op
    `jyutvoice::resblock_stage`, which runs on the CPU and on CUDA.

Weights are baked into the exported artifact (like an ONNX file); use one
program or artifact per (text, mel, prompt, steps) bucket. Bucket programs
built on the same `TTS` and `HiFT` modules (a `Synthesizer`'s) share their
weights: each holds its noise, its static buffers and its graph's private
memory pool. Unlike a
StableHLO artifact, the exported program needs `jyutvoice_tpu_torch`
imported where it runs, for its op (`load_program` imports it).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Tuple

import torch
from torch import nn

from jyutvoice_tpu_torch import kernels
from jyutvoice_tpu_torch.config import JyutVoiceConfig, require_unet
from jyutvoice_tpu_torch.models import hift as hift_mod
from jyutvoice_tpu_torch.models import tts as tts_mod
from jyutvoice_tpu_torch.pipeline.synthesize import disable_tf32
from jyutvoice_tpu_torch.weights.from_jax import load_jax_params
from jyutvoice_tpu_torch.weights.noise import rand_noise_extended

Tensor = torch.Tensor

INPUT_NAMES = ("x", "x_lengths", "lang", "tone", "word_pos", "syllable_pos", "spk_embed",
               "prompt_feat", "prompt_h", "prompt_lengths")
# attention backends that would reach a kernel launched through ctypes,
# which torch.export cannot trace (the JAX export rewrites the same names,
# whose kernels are TPU-only custom calls)
_EXPORT_UNSAFE = ("xla", "pallas", "ring")


def example_args(t_text: int, t_prompt: int, device="cpu") -> Tuple[Tensor, ...]:
    """The ten batch-1 inputs of one bucket, in `INPUT_NAMES` order: int32
    ids, lengths, language, tone and position rows, a (1, 192) speaker
    embedding and a (1, t_prompt, 80) prompt pair. Zeros, with x_lengths
    t_text."""
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    ids = [torch.zeros((1, t_text), **i32) for _ in range(5)]
    return (
        ids[0], torch.full((1,), t_text, **i32), *ids[1:],
        torch.zeros((1, 192), **f32),
        torch.zeros((1, t_prompt, 80), **f32), torch.zeros((1, t_prompt, 80), **f32),
        torch.zeros((1,), **i32),
    )


def request_args(arrs, n, *, spk_embed=None, prompt_feat=None, prompt_h=None, t_prompt=0,
                 device="cpu") -> Tuple[Tensor, ...]:
    """One request's ten inputs: `arrs, n` as `Synthesizer.prepare_text`
    returns them (ids, tones, word and syllable positions, languages; the
    true length), a (192,) speaker embedding and a (T_p, 80) prompt pair,
    zero-padded to t_prompt frames."""
    ids, tone, word_pos, syllable_pos, lang = (
        torch.as_tensor(a, dtype=torch.int32, device=device) for a in arrs)
    pf = torch.zeros((1, t_prompt, 80), device=device)
    ph = torch.zeros((1, t_prompt, 80), device=device)
    p_len = 0
    if prompt_feat is not None:
        p_len = prompt_feat.shape[0]
        pf[0, :p_len] = torch.as_tensor(prompt_feat, device=device)
        ph[0, :p_len] = torch.as_tensor(prompt_h, device=device)
    spk = torch.zeros((1, 192), device=device) if spk_embed is None else \
        torch.as_tensor(spk_embed, dtype=torch.float32, device=device).reshape(1, -1)
    return (ids, torch.as_tensor(n, dtype=torch.int32, device=device), lang, tone, word_pos,
            syllable_pos, spk, pf, ph, torch.tensor([p_len], dtype=torch.int32, device=device))


def _module(given, cls, cfg, device: torch.device) -> nn.Module:
    """`given` if it is an already built `cls` on `device` with config `cfg`
    (shared, not copied), else a new frozen `cls` on `device` loaded from
    the JAX-layout tree `given`."""
    if not isinstance(given, nn.Module):
        return load_jax_params(cls(cfg), given).to(device).requires_grad_(False)
    if not isinstance(given, cls) or given.cfg != cfg:
        raise ValueError(f"a shared {cls.__name__} must be built on the graph's config")
    where = next(given.parameters()).device
    if where != device:
        raise ValueError(f"a shared {cls.__name__} lies on {where}, the graph on {device}")
    return given


class ServingGraph(nn.Module):
    """One bucket's synthesis: (the ten inputs) -> (wav, mel, mel_lengths).

    The weights are JAX-layout trees loaded through `weights/from_jax.py`
    into the module's own frozen copies, or already built `TTS` / `HiFT`
    modules on `device` (a `Synthesizer`'s), which it shares. The fixed
    noise of t_prompt + t_mel frames is its own buffer. It is in eval mode,
    and kernel 2's stages are prepared at construction (before any trace)."""

    def __init__(self, cfg: JyutVoiceConfig, params_tts, params_hift, *, t_text: int,
                 t_mel: int, t_prompt: int = 0, n_timesteps: int = 10,
                 length_scale: float = 1.0, device="cuda"):
        super().__init__()
        require_unet(cfg.tts.cfm, "the serving export (bucket graphs and programs)")
        device = torch.device(device)
        if device.type == "cuda":
            disable_tf32()
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        self.cfg = cfg
        self.t_text, self.t_mel, self.t_prompt = t_text, t_mel, t_prompt
        self.n_timesteps, self.length_scale = n_timesteps, length_scale
        self.tts = _module(params_tts, tts_mod.TTS, cfg.tts, device)
        self.hift = _module(params_hift, hift_mod.HiFT, cfg.hift, device)
        self.register_buffer("noise", rand_noise_extended(t_prompt + t_mel).to(device))
        self.eval()
        self.hift.prepare_stages()

    def forward(self, x, x_lengths, lang, tone, word_pos, syllable_pos, spk_embed,
                prompt_feat, prompt_h, prompt_lengths):
        out = tts_mod.synthesize_mel(
            self.tts, x, x_lengths, lang, tone, word_pos, syllable_pos, spk_embed,
            prompt_feat, prompt_h, prompt_lengths, t_mel_max=self.t_mel,
            n_timesteps=self.n_timesteps, rand_noise=self.noise,
            length_scale=self.length_scale,
        )
        wav, _ = hift_mod.hift_vocode_auto(self.hift, out.mel)
        return wav, out.mel, out.mel_lengths


def build_serving_fn(cfg: JyutVoiceConfig, params_tts, params_hift, *, t_text: int,
                     t_mel: int, t_prompt: int = 0, n_timesteps: int = 10,
                     length_scale: float = 1.0, device="cuda") -> ServingGraph:
    """Close over weights: (text features...) -> (wav, mel, mel_lengths).
    params_tts / params_hift: JAX-layout trees, or built modules to share
    (`ServingGraph`)."""
    return ServingGraph(cfg, params_tts, params_hift, t_text=t_text, t_mel=t_mel,
                        t_prompt=t_prompt, n_timesteps=n_timesteps,
                        length_scale=length_scale, device=device)


class BucketProgram:
    """A `ServingGraph` behind a fixed-shape contract: called with the ten
    inputs at `example_args`' shapes and dtypes on its device (anything else
    raises), it returns fresh (wav, mel, mel_lengths) tensors, so a later
    call never overwrites an earlier call's result.

    On a CUDA device the graph is captured at construction: one eager warm
    call on a side stream (it fills the constant caches and prepares the
    kernels' attributes), then one `torch.cuda.CUDAGraph` capture over static
    input and output buffers; a call copies its inputs in and replays. A
    capture that fails raises; there is no eager fallback on CUDA. The
    program keeps every cached constant the graph reads (the vocoder's STFT
    tables and prepared stages, `hift.keep_constants`), so no cache
    eviction frees them under it. `launches` holds what the capture
    launched of each kernel, which every replay launches again
    (`kernels.LAUNCHES` counts Python calls, so it counts the capture and no
    replay); `replays` counts the calls served.
    On the CPU, as the tests run it, a call runs the module eagerly.
    One thread at a time: the static buffers are shared."""

    def __init__(self, graph: ServingGraph):
        self.graph = graph
        self.device = graph.noise.device
        self._inputs = example_args(graph.t_text, graph.t_prompt, self.device)
        self.launches: Dict[str, int] = {}
        self.replays = 0
        self.capture_s = 0.0
        self._cuda_graph = None
        self._outputs: Tuple[Tensor, ...] = ()
        self._constants: list = []
        if self.device.type == "cuda":
            self._capture()

    def _capture(self) -> None:
        disable_tf32()
        t = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side), torch.inference_mode():
            self.graph(*self._inputs)
        main.wait_stream(side)
        before = dict(kernels.LAUNCHES)
        cuda_graph = torch.cuda.CUDAGraph()
        with hift_mod.keep_constants() as self._constants, torch.inference_mode(), \
                torch.cuda.graph(cuda_graph):
            self._outputs = self.graph(*self._inputs)
        torch.cuda.synchronize(self.device)
        self.launches = {k: kernels.LAUNCHES[k] - before[k] for k in before
                         if kernels.LAUNCHES[k] != before[k]}
        self._cuda_graph = cuda_graph
        self.capture_s = time.perf_counter() - t

    def __call__(self, *args: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        if len(args) != len(INPUT_NAMES):
            raise TypeError(f"a bucket program takes {len(INPUT_NAMES)} inputs "
                            f"{INPUT_NAMES}, got {len(args)}")
        for name, a, want in zip(INPUT_NAMES, args, self._inputs):
            if (not isinstance(a, torch.Tensor) or a.shape != want.shape
                    or a.dtype != want.dtype or a.device != want.device):
                got = (f"{tuple(a.shape)} {a.dtype} on {a.device}"
                       if isinstance(a, torch.Tensor) else type(a).__name__)
                raise ValueError(f"bucket program input {name}: want {tuple(want.shape)} "
                                 f"{want.dtype} on {want.device}, got {got}")
        self.replays += 1
        with torch.inference_mode():
            if self._cuda_graph is None:
                return tuple(self.graph(*args))
            for buf, a in zip(self._inputs, args):
                buf.copy_(a)
            self._cuda_graph.replay()
            return tuple(o.clone() for o in self._outputs)


def aot_compile(cfg: JyutVoiceConfig, params_tts, params_hift, *, t_text: int, t_mel: int,
                t_prompt: int = 0, n_timesteps: int = 10, length_scale: float = 1.0,
                device="cuda") -> BucketProgram:
    """Ahead-of-time captured program for one bucket (eager on the CPU); the
    weights as `build_serving_fn` takes them (built modules are shared)."""
    return BucketProgram(build_serving_fn(
        cfg, params_tts, params_hift, t_text=t_text, t_mel=t_mel, t_prompt=t_prompt,
        n_timesteps=n_timesteps, length_scale=length_scale, device=device))


def export_safe_cfg(cfg: JyutVoiceConfig) -> JyutVoiceConfig:
    """cfg with the estimator's attention on "xla_scores" (plain attention)
    where its backend would reach kernel 1 or 3; cfg itself otherwise."""
    est = cfg.tts.cfm.estimator
    if est.attention_backend not in _EXPORT_UNSAFE:
        return cfg
    est = dataclasses.replace(est, attention_backend="xla_scores")
    cfm = dataclasses.replace(cfg.tts.cfm, estimator=est)
    return dataclasses.replace(cfg, tts=dataclasses.replace(cfg.tts, cfm=cfm))


def export_program(cfg: JyutVoiceConfig, params_tts, params_hift, path: str, *, t_text: int,
                   t_mel: int, t_prompt: int = 0, n_timesteps: int = 10,
                   length_scale: float = 1.0, device="cuda"):
    """Trace the bucket graph (weights baked in) with torch.export and save
    it to `path`; returns the ExportedProgram.

    The trace takes plain attention (`export_safe_cfg`; the caller's cfg is
    left as it is) and, for an int8 decoder tree, the int8 linear's plain
    composition (`nn/quant.py::linear_q_plain`, torch._int_mm), so the
    artifact holds no kernel launched through ctypes; kernel 2 stays in it
    as `jyutvoice.resblock_stage` nodes. aot_compile keeps kernel 1 and the
    int8 linear's kernels (same-device use). The weights are JAX-layout
    trees: the export builds its own modules on its own config."""
    graph = build_serving_fn(
        export_safe_cfg(cfg), params_tts, params_hift, t_text=t_text, t_mel=t_mel,
        t_prompt=t_prompt, n_timesteps=n_timesteps, length_scale=length_scale,
        device=device)
    with torch.no_grad():
        program = torch.export.export(graph, example_args(t_text, t_prompt, device))
    torch.export.save(program, path)
    return program


def load_program(path: str):
    """Read an exported bucket graph back; returns a callable with the same
    ten inputs and outputs. Imports the op kernel 2 runs as."""
    import jyutvoice_tpu_torch.nn.resblock_stage  # noqa: F401  registers jyutvoice::resblock_stage

    return torch.export.load(path).module()
