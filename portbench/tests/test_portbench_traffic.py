"""Traffic is a function of its file and the seed: the same seed gives the
same requests, every seed the same sizes per cycle, and the reference's
token ids equal the program's front end's."""

import numpy as np
import pytest

from portbench import textgen
from portbench.reference.frontend import token_ids

TRAFFIC = {"tokens": [240, 480], "requests": 40, "size_cycle": 16}
BIG = 2 ** 31 + 12345  # seeds pass 32 signed bits


def test_same_seed_same_requests():
    a = textgen.requests(TRAFFIC, BIG, 192)
    b = textgen.requests(TRAFFIC, BIG, 192)
    assert [(r.text, r.phone, r.tokens) for r in a] == [(r.text, r.phone, r.tokens) for r in b]
    assert all(np.array_equal(x.spk, y.spk) for x, y in zip(a, b))


def test_every_seed_has_the_cycles_sizes():
    a = textgen.requests(TRAFFIC, BIG, 192)
    b = textgen.requests(TRAFFIC, BIG + 1, 192)
    assert [r.text for r in a] != [r.text for r in b]
    want = textgen.sizes(240, 480, 16)
    over = 2 * max(n for _, _, n in textgen.words())  # a text ends at a whole word
    for reqs in (a, b):
        for c in range(2):
            got = sorted(r.tokens for r in reqs[16 * c: 16 * (c + 1)])
            # token counts are odd: an even size is met one below
            assert all(-1 <= g - w <= over for g, w in zip(got, sorted(want)))
    norms = [float(np.linalg.norm(r.spk)) for r in a]  # CAM++'s scale: about sqrt(192)
    assert all(r.spk.shape == (192,) and r.spk.dtype == np.float32 for r in a)
    assert 12.0 < float(np.median(norms)) < 16.0


def test_sized_to_frames_matches_speakers_to_targets():
    traffic = dict(TRAFFIC, max_tokens=490)
    reqs = textgen.requests(traffic, BIG, 192)
    rng = np.random.default_rng(3)
    rates = list(rng.uniform(1.5, 4.0, len(reqs)))
    out = textgen.sized_to_frames(traffic, reqs, rates, 2.5, BIG)
    assert [r.text for r in out] == [r.text for r in textgen.sized_to_frames(traffic, reqs, rates, 2.5, BIG)]
    over = 2 * max(n for _, _, n in textgen.words())
    for c in range(0, 32, 16):
        block, new = reqs[c:c + 16], out[c:c + 16]
        rate_of = {id(r.spk): rates[c + i] for i, r in enumerate(block)}
        # the speakers are the block's own, the fastest on the largest target
        assert sorted(id(r.spk) for r in new) == sorted(rate_of)
        order = sorted(range(16), key=lambda i: block[i].tokens)
        got = [rate_of[id(new[i].spk)] for i in order]
        assert got == sorted(got)
        for i in range(16):
            want = min(round(block[i].tokens * 2.5 / rate_of[id(new[i].spk)]), 490)
            assert -1 <= new[i].tokens - want <= over + 1


def test_reference_front_end_matches_the_program():
    pytest.importorskip("jyutvoice_tpu_torch")
    from jyutvoice_tpu_torch.text import intersperse, text_to_sequence

    for r in textgen.requests(TRAFFIC, BIG, 192)[:8]:
        want = [intersperse(s, 0) for s in text_to_sequence(r.text, "yue", r.phone)]
        assert token_ids(r.text, r.phone) == want
        assert len(want[0]) == r.tokens
