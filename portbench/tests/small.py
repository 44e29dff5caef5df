"""A small configuration and traffic for the benchmark's CPU tests: one
encoder layer, one transformer block per estimator stage and one mid
stage, a 64-channel vocoder trunk, short texts, groups of 4, 2 steps;
and a long-form traffic through the engine's long route
(`adjust_long`)."""

import copy

# long-form narration through the engine's long route (synthesize_long),
# one request queued behind the one in flight; the band and the vocoder's
# windows past `banded_past` and `window_past` frames
LONG = {
    "kind": "serve", "tokens": [1700, 1800], "requests": 4, "size_cycle": 2, "calibrate": 2,
    "outstanding": 2, "check_sample": 1, "long_form": True, "banded_past": 0,
    "window_past": 3584,
    # the CPU takes exact attention on the "auto" route: force the band
    "engine": {"max_batch": 16, "split_dispatch_at": 16, "max_wait_ms": 20, "n_timesteps": 10,
               "pcm16": True, "return_mel": True, "long_attention": "banded"},
    "warm": {"long": True, "text_buckets": [2048], "mel_sizes": [4608]},
}


def adjust(conf, traffic):
    conf = copy.deepcopy(conf)
    m = conf["model"]
    m["tts"]["encoder"].update(n_layers=1, filter_channels=64)
    m["tts"]["cfm"]["estimator"].update(n_blocks=1, num_mid_blocks=1)
    m["hift"]["base_channels"] = 64
    traffic = copy.deepcopy(traffic)
    if not traffic.get("long_form"):
        traffic.update(tokens=[40, 80], requests=32, size_cycle=4, calibrate=8, outstanding=8, check_sample=3)
        traffic["engine"].update(max_batch=4, split_dispatch_at=4)
        traffic["warm"].update(text_buckets=[96], mel_buckets=[256])
    traffic["engine"]["n_timesteps"] = 2
    return conf, traffic


def adjust_long(conf, traffic):
    """The small configuration on `LONG`, in place of the cell's traffic."""
    return adjust(conf, copy.deepcopy(LONG))
