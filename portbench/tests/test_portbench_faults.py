"""A run whose timed path is broken underneath reads not correct: the
harness's whole run on the CPU at a small size (the look for a card
skipped), with each fault that a serving cell can have planted in the
program after set-up."""

import numpy as np
import pytest
import torch

import portbench.run as R
from portbench.tests.small import adjust, adjust_long


def step_unchanged(synth):
    """Every Euler step returns its state: the velocity is zero."""
    synth.tts.decoder.forward = lambda x, *a, **k: torch.zeros_like(x)


def half_batch(synth):
    """Only the first half of each dispatch's requests is computed; the
    others are handed the first half's results."""
    dispatch = synth.synthesize_batch_dispatch

    def half(items, **kw):
        n = max(len(items) // 2, 1)
        fin = dispatch(items[:n], **kw)
        return lambda: [r for r in fin() for _ in range(2)][: len(items)]

    synth.synthesize_batch_dispatch = half


def token_altered(synth):
    """One text token's log-duration is off by 0.7 in every request."""
    dp = synth.tts.dp.forward

    def forward(x, x_mask, spk, **kw):
        out = dp(x, x_mask, spk, **kw).clone()
        out[:, 5] += 0.7
        return out

    synth.tts.dp.forward = forward


def answer_altered(synth):
    """One PCM sample of every served waveform is off by 200 steps."""
    for name in ("synthesize_batch_dispatch", "synthesize_long"):
        fn = getattr(synth, name)

        def wrap(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)

            def alter(r):
                r.wav = np.array(r.wav, copy=True)
                r.wav[100] = np.clip(int(r.wav[100]) + 200, -32767, 32767)
                return r

            if _name == "synthesize_long":
                return alter(out)
            return lambda: [alter(r) for r in out()]

        setattr(synth, name, wrap)


CASES = [(w, adjust, f) for w in ("base.offline-b16", "int8.offline-b16")
         for f in (step_unchanged, half_batch, token_altered, answer_altered)]
CASES += [("base.offline-b16", adjust_long, f) for f in (step_unchanged, token_altered, answer_altered)]


@pytest.mark.parametrize("workload,size,fault", CASES,
                         ids=[f"{w}-{'long' if s is adjust_long else 'batch'}-{f.__name__}"
                              for w, s, f in CASES])
def test_fault_reads_not_correct(workload, size, fault):
    torch.set_num_threads(4)

    def judge_all(conf, traffic):
        conf, traffic = size(conf, traffic)
        traffic["check_sample"] = 10 ** 6  # every served request, so the fault's rows are in
        return conf, traffic

    res = R.evaluate(workload, 2 ** 31 + 5, 0.5, 0, device="cpu", fault=fault, adjust=judge_all)
    assert res["attempted"] > 0
    assert not res["correct"], res["checks"]
