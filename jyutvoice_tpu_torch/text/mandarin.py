"""Mandarin g2p: text/pinyin -> phones, tones, positions.

Mirrors reference text/mandarin/g2p.py:79-146. Hanzi -> pinyin needs a
pronouncing dictionary (optional `pypinyin`); explicit pinyin input works
self-contained via our strict splitter (pinyin.py).
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

from jyutvoice_tpu_torch.text.pinyin import split_pinyin_syllable
from jyutvoice_tpu_torch.text.symbols import punctuations

try:  # optional host-side dependency
    import pypinyin  # type: ignore
    from pypinyin import Style  # type: ignore

    _HAS_PYPINYIN = True
except Exception:  # pragma: no cover
    _HAS_PYPINYIN = False

_ALPHA_RE = re.compile(r"[a-zA-Z]")


def text_to_pinyin(word: str) -> List[Tuple[str, str]]:
    """Characters -> (initial, final_tone3) via pypinyin (strict=False),
    reference mandarin/g2p.py:13-19 — or, when pypinyin is absent, the
    bundled curated reading table split with the same strict=False
    conventions (readings.py, loud one-time warning)."""
    if not _HAS_PYPINYIN:
        from jyutvoice_tpu_torch.text.readings import (
            pinyin_readings,
            split_pinyin_loose,
        )

        return [split_pinyin_loose(s) for s in pinyin_readings(word)]
    initials = [x[0] for x in pypinyin.pinyin(word, style=Style.INITIALS, strict=False)]
    finals = [
        x[0] for x in pypinyin.pinyin(word, style=Style.FINALS_TONE3, strict=False)
    ]
    return list(zip(initials, finals))


def pinyin_to_phonemes(
    pinyin_syllables: Sequence[Tuple[str, str]],
) -> Tuple[List[str], List[int], List[int], List[int]]:
    """(initial, final+tone) pairs -> (phones, tones, word2ph, syllable_pos),
    reference mandarin/g2p.py:31-77."""
    phones: List[str] = []
    tones: List[int] = []
    word2ph: List[int] = []
    syllable_pos: List[int] = []
    for initial, final in pinyin_syllables:
        if initial in punctuations or (
            initial == final and not _ALPHA_RE.match(initial)
        ):
            phones.append(initial)
            tones.append(0)
            word2ph.append(1)
            syllable_pos.append(0)
            continue
        tone = 0
        if final and final[-1].isdigit():
            tone = int(final[-1])
            final = final[:-1]
        n = 0
        pos = 1
        if initial:
            phones.append(initial)
            tones.append(tone)
            syllable_pos.append(pos)
            pos += 1
            n += 1
        if final:
            phones.append(final)
            tones.append(tone)
            syllable_pos.append(pos)
            pos += 1
            n += 1
        word2ph.append(n)
    return phones, tones, word2ph, syllable_pos


def _word_ws_labels(words: Sequence[str]) -> List[int]:
    labels: List[int] = []
    for word in words:
        if len(word) == 0:
            continue
        if len(word) == 1:
            labels.append(1)
        elif len(word) == 2:
            labels.extend([1, 3])
        else:
            labels.extend([1] + [2] * (len(word) - 2) + [3])
    return labels


def g2p(
    text: str,
    pinyin: Optional[str] = None,
    padding: bool = True,
):
    """Mandarin grapheme-to-phoneme; lang id 1 = Mandarin.
    reference text/mandarin/g2p.py:79-146."""
    words = text.split()
    word_pinyin: List[Tuple[str, List[Tuple[str, str]]]] = []

    if pinyin is None:
        word_pinyin = [(w, text_to_pinyin(w)) for w in words]
    else:
        pinyin_list = [split_pinyin_syllable(s) for s in pinyin.split(" ")]
        n_chars = len([c for w in words for c in w])
        if len(pinyin_list) != n_chars:
            raise ValueError(
                "The number of pinyin syllables does not match the number "
                "of characters in the text."
            )
        index = 0
        for word in words:
            word_pinyin.append((word, pinyin_list[index : index + len(word)]))
            index += len(word)

    phones: List[str] = []
    tones: List[int] = []
    word2ph: List[int] = []
    syllable_pos: List[int] = []
    for _, syls in word_pinyin:
        p, t, w2p, sp = pinyin_to_phonemes(syls)
        phones += p
        tones += t
        word2ph += w2p
        syllable_pos += sp

    ws_labels = _word_ws_labels(words)
    word_pos: List[int] = []
    for i, label in enumerate(ws_labels):
        word_pos.extend([label] * word2ph[i])

    if padding:
        phones = ["_"] + phones + ["_"]
        tones = [0] + tones + [0]
        word_pos = [0] + word_pos + [0]
        syllable_pos = [0] + syllable_pos + [0]
        word2ph = [1] + word2ph + [1]

    assert len(phones) == len(tones) == len(word_pos) == len(syllable_pos)
    lang_ids = [1] * len(phones)
    return phones, tones, word2ph, word_pos, syllable_pos, lang_ids
