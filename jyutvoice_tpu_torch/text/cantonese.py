"""Cantonese g2p: text/jyutping -> phones, tones, positions.

Mirrors reference text/cantonese/g2p.py:97-165. Hanzi -> jyutping conversion
needs a pronouncing dictionary; when the optional `ToJyutping` package is
present we use it, otherwise callers must supply the jyutping string (the
reference's --phone path), which is fully self-contained via our parser.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

from jyutvoice_tpu_torch.text.jyutping import parse_jyutping
from jyutvoice_tpu_torch.text.symbols import punctuations

try:  # optional host-side dependency
    import ToJyutping  # type: ignore

    _HAS_TOJYUTPING = True
except Exception:  # pragma: no cover
    _HAS_TOJYUTPING = False

_PUNCT_CLASS = re.escape("".join(punctuations))
_PUNCT_ONLY_RE = re.compile(r"^[{}]+$".format(_PUNCT_CLASS))
_JYUTPING_SEQ_RE = re.compile(r"^([a-z]+[1-6]+[ ]?)+$")


def get_jyutping(text: str) -> List[str]:
    """Characters -> jyutping syllables via ToJyutping (one entry per char,
    punctuation passed through), reference g2p.py:66-84 — or, when
    ToJyutping is absent, the bundled curated reading table (readings.py,
    loud one-time warning)."""
    if not _HAS_TOJYUTPING:
        from jyutvoice_tpu_torch.text.readings import jyutping_readings

        return jyutping_readings(text)
    out: List[str] = []
    for word, syllable in ToJyutping.get_jyutping_list(text):
        if _PUNCT_ONLY_RE.match(word):
            for punct in re.split(r"([{}])".format(_PUNCT_CLASS), word):
                if punct:
                    out.append(punct)
        else:
            if syllable is None or not _JYUTPING_SEQ_RE.match(syllable):
                raise ValueError(
                    f"Failed to convert {word!r} to jyutping: {syllable!r}"
                )
            out.append(syllable)
    return out


def syllables_to_phones(
    jyutping_syllables: Sequence[str],
) -> Tuple[List[str], List[int], List[int], List[int]]:
    """Jyutping syllables -> (phones, tones, word2ph, syllable_pos).

    Each syllable contributes its present onset/nucleus/coda in order;
    syllable_pos enumerates them 1..3 in emission order; punctuation gets
    tone 0 / pos 0 (reference g2p.py:22-63).
    """
    phones: List[str] = []
    tones: List[int] = []
    word2ph: List[int] = []
    syllable_pos: List[int] = []
    for syllable in jyutping_syllables:
        if syllable in punctuations:
            phones.append(syllable)
            tones.append(0)
            word2ph.append(1)
            syllable_pos.append(0)
            continue
        onset, nucleus, coda, tone = parse_jyutping(syllable)
        n = 0
        pos = 1
        for part in (onset, nucleus, coda):
            if part != "":
                phones.append(part)
                tones.append(int(tone))
                syllable_pos.append(pos)
                pos += 1
                n += 1
        word2ph.append(n)
    return phones, tones, word2ph, syllable_pos


def _word_ws_labels(words: Sequence[str]) -> List[int]:
    """BMES-style word-position labels: 1 begin, 2 middle, 3 end
    (reference g2p.py:131-149)."""
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
    jyutping: Optional[str] = None,
    padding: bool = True,
):
    """Cantonese grapheme-to-phoneme. `text` is space-segmented words.

    Returns (phones, tones, word2ph, word_pos, syllable_pos, lang_ids);
    lang id 0 = Cantonese. reference text/cantonese/g2p.py:97-165.
    """
    words = text.split()
    word_jyutping: List[Tuple[str, List[str]]] = []

    if jyutping is None:
        word_jyutping = [(w, get_jyutping(w)) for w in words]
    else:
        jyutping_list = jyutping.split(" ")
        n_chars = len([c for w in words for c in w])
        if len(jyutping_list) != n_chars:
            raise ValueError(
                "The number of jyutping syllables does not match the number "
                "of characters in the text."
            )
        index = 0
        for word in words:
            word_jyutping.append((word, jyutping_list[index : index + len(word)]))
            index += len(word)

    phones: List[str] = []
    tones: List[int] = []
    word2ph: List[int] = []
    syllable_pos: List[int] = []
    for _, syls in word_jyutping:
        p, t, w2p, sp = syllables_to_phones(syls)
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
    lang_ids = [0] * len(phones)
    return phones, tones, word2ph, word_pos, syllable_pos, lang_ids
