"""The system under test, built from a configuration file: the port's
`JyutVoiceConfig`, its `Synthesizer` on the benchmark's weights (the int8
configuration quantized as README's "Int8 serving" does), and probes
around kernels 1 and 2 that record the shapes each launch saw."""

from __future__ import annotations

import dataclasses
import typing
from typing import Dict, List

from jyutvoice_tpu_torch import config as jvc


def jv_config(model: Dict) -> "jvc.JyutVoiceConfig":
    """A JyutVoiceConfig from the config file's nested "model" object."""

    def build(cls, values):
        hints = typing.get_type_hints(cls)
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in values:
                continue
            v = values[f.name]
            hint = hints[f.name]
            if dataclasses.is_dataclass(hint):
                v = build(hint, v)
            elif isinstance(v, list):
                v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
            kw[f.name] = v
        return cls(**kw)

    return build(jvc.JyutVoiceConfig, model)


def synthesizer(conf: Dict, tts_np, hift_np, device):
    from jyutvoice_tpu_torch.nn.quant import quantize_estimator
    from jyutvoice_tpu_torch.pipeline.synthesize import Synthesizer

    if conf["int8"]:
        tts_np = {**tts_np, "decoder": quantize_estimator(tts_np["decoder"])}
    return Synthesizer(jv_config(conf["model"]), tts_np, hift_np, device=device)


class Probes:
    """Wrap kernel 1's and kernel 2's Python entries (as the program's
    modules import them) to record each call's shapes: kernel 1's
    (B, T, H, D) and its lengths tensor, kernel 2's (B, T, C). The lengths
    are kept as references and read after the window."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.k1: List = []
        self.k2: List = []

    def __enter__(self):
        if not self.enabled:
            return self
        from jyutvoice_tpu_torch.models import hift
        from jyutvoice_tpu_torch.nn import attention

        self._saved = (attention.flash_attention, hift.resblock_stage_prepared)
        fa, rs = self._saved

        def k1(q, k, v, lengths, **kw):
            self.k1.append((tuple(q.shape), lengths))
            return fa(q, k, v, lengths, **kw)

        def k2(x, stage):
            self.k2.append(tuple(x.shape))
            return rs(x, stage)

        attention.flash_attention, hift.resblock_stage_prepared = k1, k2
        return self

    def __exit__(self, *exc):
        if self.enabled:
            from jyutvoice_tpu_torch.models import hift
            from jyutvoice_tpu_torch.nn import attention

            attention.flash_attention, hift.resblock_stage_prepared = self._saved
        return False

    def k1_calls(self):
        """[(B, T, H, D, [lengths])], each lengths tensor read once."""
        seen: Dict[int, list] = {}
        out = []
        for shape, lengths in self.k1:
            if id(lengths) not in seen:
                seen[id(lengths)] = lengths.tolist()
            out.append((*shape, seen[id(lengths)]))
        return out
