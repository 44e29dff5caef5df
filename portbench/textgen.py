"""Traffic from a traffic file's parameters and a seed.

Every seed gets the same request sizes, in its own order: a cycle of
`size_cycle` sizes, the quantiles (i + 0.5) / n of a log-uniform draw
between the file's bounds, repeated, each repetition shuffled by the seed.
A cycle is an engine group (or, for requests served one at a time, about
the requests of a window), so every group carries the same token counts.
The seed picks the words, the order and the speaker embeddings. An
embedding is drawn standard normal in each of its 192 dimensions, as
CAM++ gives them: its last layer is a batch norm without an affine part,
so each dimension has about zero mean and unit variance over speakers.
The model's encoder and duration predictor take the raw vector, so with
random weights its draw moves a request's frames per token (by about a
quarter between requests), and a group's longest request may pass the
1536-frame mel bucket. A traffic with `size_in_frames` therefore sizes
each request in audio (`sized_to_frames`): its target is its token size
times the assumed frames per token, and its text is drawn anew with the
tokens that its speaker needs for it. Texts are Cantonese words of `traffic/words_yue.tsv` with
their jyutping; a request's size is its token count, the phone symbols with
the pads and the blanks between them, as the model's front end counts it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np

from portbench.reference.frontend import parse

_HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Request:
    text: str
    phone: str
    tokens: int  # blank-interspersed token count
    spk: np.ndarray  # (192,) float32


def words(path: str = os.path.join(_HERE, "traffic", "words_yue.tsv")) -> List[Tuple[str, str, int]]:
    """(word, jyutping, phone symbols) of each line."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            word, jp = line.rstrip("\n").split("\t")
            n = sum(len([p for p in parse(s)[:3] if p]) for s in jp.split())
            out.append((word, jp, n))
    return out


def sizes(lo: int, hi: int, n: int) -> np.ndarray:
    """n log-uniform quantiles between lo and hi, ascending."""
    q = (np.arange(n) + 0.5) / n
    return np.round(lo * (hi / lo) ** q).astype(int)


def text_of(rng: np.random.Generator, vocab, tokens: int) -> Tuple[str, str, int]:
    """Words drawn from vocab until the text reaches `tokens` tokens:
    2 (phones + 2 pads) + 1 tokens for `phones` phone symbols."""
    want = (tokens - 1) // 2 - 2
    ws, js, phones = [], [], 0
    while phones < want:
        w, j, n = vocab[int(rng.integers(len(vocab)))]
        ws.append(w)
        js.append(j)
        phones += n
    return " ".join(ws), " ".join(js), 2 * (phones + 2) + 1


def sized_to_frames(traffic: dict, reqs: List[Request], rates, per_token: float, seed: int,
                    vocab=None) -> List[Request]:
    """The requests sized in frames. A request's target is its token count
    times `per_token`; `rates` are the frames per token that each request's
    speaker gave its first text. Within a cycle the speakers go to the
    targets in the order of their rates (the fastest to the largest), so
    that each text stays short of `max_tokens`, and each text is drawn
    anew with the tokens that its speaker needs for its target."""
    rng = np.random.default_rng([seed, 1])
    vocab = vocab or words()
    cycle, cap = traffic["size_cycle"], traffic["max_tokens"]
    out = []
    for c in range(0, len(reqs), cycle):
        block = reqs[c:c + cycle]
        by_size = sorted(range(len(block)), key=lambda i: block[i].tokens)
        by_rate = sorted(range(len(block)), key=lambda i: rates[c + i])
        for i, k in sorted(zip(by_size, by_rate)):
            want = min(int(round(block[i].tokens * per_token / rates[c + k])), cap)
            text, phone, tok = text_of(rng, vocab, max(want, 9))
            out.append(Request(text, phone, tok, block[k].spk))
    return out


def requests(traffic: dict, seed: int, spk_dim: int, vocab=None) -> List[Request]:
    """The traffic file's `requests` requests, token counts in
    [tokens[0], tokens[1]] (cycles of log-uniform quantiles), in the seed's
    order."""
    rng = np.random.default_rng(seed)
    vocab = vocab or words()
    lo, hi = traffic["tokens"]
    n, cycle = traffic["requests"], traffic["size_cycle"]
    base = sizes(lo, hi, cycle)
    order = np.concatenate([rng.permutation(base) for _ in range(-(-n // cycle))])[:n]
    spk = rng.standard_normal((n, spk_dim)).astype(np.float32)
    out = []
    for i, t in enumerate(order):
        text, phone, tok = text_of(rng, vocab, int(t))
        out.append(Request(text, phone, tok, spk[i]))
    return out
