"""Cantonese text with jyutping -> the model's five id sequences, blanks
interspersed: the symbol table and the jyutping grammar of the model's
front end, written out for the reference."""

from __future__ import annotations

import re
from typing import List, Tuple

_ONSETS = "b d g gw z p t k kw c m n ng f h s l w j".split()
_NUCLEI = "aa a i yu u oe e eo o m n ng".split()
_CODAS = "p t k m n ng i u".split()
_MANDARIN = ("b p m f d t n l g k h j q x zh ch sh r z c s i iu ui u v a ia ua o uo e ie "
             "ue ve ai uai ei uei ao iao ou iou an ian uan van en in un uen vn ang iang "
             "uang eng ing ueng ong iong er").split()
_ENGLISH = ("aa ae ah ao aw ay b ch d dh eh er ey f g hh ih iy jh k l m n ng ow oy p r s sh "
            "t th uh uw V w y z zh").split()
_PUNCT = ["!", "?", "…", ",", ".", "'", "-"]
SYMBOLS = ["_", "SP", "UNK"] + _PUNCT + sorted(set(_ONSETS + _NUCLEI + _CODAS + _MANDARIN
                                                   + _ENGLISH))
SYMBOL_ID = {s: i for i, s in enumerate(SYMBOLS)}


def parse(syllable: str) -> Tuple[str, str, str, int]:
    """(onset, nucleus, coda, tone): the longest onset, then the longest
    nucleus, that leave a valid coda; a bare m / ng is a syllabic nucleus."""
    m = re.fullmatch(r"([a-z]+)([1-6])", syllable)
    if not m:
        raise ValueError(f"not a jyutping syllable: {syllable!r}")
    body, tone = m.group(1), int(m.group(2))
    found = []
    for onset in [o for o in _ONSETS if body.startswith(o)] + [""]:
        rest = body[len(onset):]
        if not rest and onset in ("m", "ng"):
            found.append(("", onset, ""))
            continue
        for nucleus in [n for n in _NUCLEI if rest.startswith(n)]:
            coda = rest[len(nucleus):]
            if coda == "" or coda in _CODAS:
                found.append((onset, nucleus, coda))
    if not found:
        raise ValueError(f"not a jyutping syllable: {syllable!r}")
    found.sort(key=lambda c: (len(c[0]), len(c[1])), reverse=True)
    return (*found[0], tone)


def token_ids(text: str, jyutping: str) -> List[List[int]]:
    """[phone ids, tones, word positions, syllable positions, language ids]
    of space-separated words with one syllable per character: begin / middle
    / end word labels 1 / 2 / 3 (a one-character word is 1), syllable
    positions 1.. within a syllable, a pad symbol at both ends, and a blank
    (0) before, between and after every symbol."""
    words = text.split()
    syls = jyutping.split(" ")
    if len(syls) != sum(len(w) for w in words):
        raise ValueError("one jyutping syllable per character is needed")
    phones, tones, wpos, spos = ["_"], [0], [0], [0]
    i = 0
    for word in words:
        n = len(word)
        labels = [1] if n == 1 else [1] + [2] * (n - 2) + [3]
        for label, syl in zip(labels, syls[i: i + n]):
            onset, nucleus, coda, tone = parse(syl)
            parts = [p for p in (onset, nucleus, coda) if p]
            phones += parts
            tones += [tone] * len(parts)
            wpos += [label] * len(parts)
            spos += list(range(1, len(parts) + 1))
        i += n
    phones.append("_")
    tones.append(0)
    wpos.append(0)
    spos.append(0)
    seqs = [[SYMBOL_ID[p] for p in phones], tones, wpos, spos, [0] * len(phones)]
    out = []
    for s in seqs:
        full = [0] * (2 * len(s) + 1)
        full[1::2] = s
        out.append(full)
    return out
