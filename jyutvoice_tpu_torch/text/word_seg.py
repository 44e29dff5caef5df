"""Chinese word segmentation (word_pos feature support).

The reference segments zh/yue text with the pydips BERT CWS model before g2p
(infer.py:32,233-236; scripts/prepare_dataset.py:55) so multi-character words
get begin/middle/end word-position labels. pydips is an optional host
dependency here; without it a bundled-lexicon greedy longest-match segmenter
recovers B/M/E structure for common words, and only as a last resort does
every character become its own word (all word_pos = 1, weaker prosody).
Both fallbacks announce themselves with a one-time warning so a degraded
word_pos stream is never silent.
"""

from __future__ import annotations

import functools
import logging

_log = logging.getLogger(__name__)

_warned = False


def _warn_once(msg: str) -> None:
    global _warned
    if not _warned:
        _warned = True
        _log.warning(msg)


@functools.lru_cache(maxsize=1)
def _pydips_model():
    try:
        from pydips import BertModel  # type: ignore

        return BertModel()
    except Exception:
        return None


@functools.lru_cache(maxsize=1)
def _lexicon():
    """(set of words, max word length) for greedy longest-match."""
    from jyutvoice_tpu_torch.text.lexicon import COMMON_WORDS

    words = set(COMMON_WORDS)
    return words, max(len(w) for w in words)


def dict_seg(text: str) -> str:
    """Greedy forward-maximum-matching over the bundled mini-lexicon.

    Unmatched characters become single-character words (same as the
    per-char fallback), so this strictly improves on it for any text that
    contains lexicon words.
    """
    words, max_len = _lexicon()
    out = []
    i, n = 0, len(text)
    while i < n:
        match = None
        for l in range(min(max_len, n - i), 1, -1):
            cand = text[i : i + l]
            if cand in words:
                match = cand
                break
        if match is None:
            match = text[i]
        out.append(match)
        i += len(match)
    return " ".join(out)


def word_seg(text: str) -> str:
    """Insert spaces between words.

    Priority: pydips BERT CWS (reference behavior) > bundled-lexicon greedy
    longest-match > per-character.
    """
    if " " in text.strip():
        return text  # already segmented
    model = _pydips_model()
    if model is not None:
        return " ".join(model.cut(text, mode="coarse"))
    _warn_once(
        "pydips is not installed: word segmentation falls back to a bundled "
        "mini-lexicon (greedy longest-match). word_pos features will be "
        "degraded vs a model trained with pydips segmentation; install "
        "pydips for reference-grade prosody."
    )
    return dict_seg(text)
