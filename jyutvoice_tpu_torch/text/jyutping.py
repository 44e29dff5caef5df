"""A self-contained jyutping syllable parser.

Replaces the reference's dependency on `pycantonese.parse_jyutping`
(text/cantonese/g2p.py:87-94) with an explicit grammar: a jyutping syllable is
ONSET? NUCLEUS CODA? TONE, with syllabic nasals (m, ng) allowed as a bare
nucleus.  Longest-match with backtracking over the official inventories.
"""

from __future__ import annotations

import re
from typing import Tuple

ONSETS = sorted(
    "b d g gw z p t k kw c m n ng f h s l w j".split(), key=len, reverse=True
)
NUCLEUSES = sorted(
    "aa a i yu u oe e eo o m n ng".split(), key=len, reverse=True
)
CODAS = sorted("p t k m n ng i u".split(), key=len, reverse=True)

_SYLLABLE_RE = re.compile(r"^([a-z]+)([1-6])$")


class JyutpingError(ValueError):
    pass


def parse_jyutping(syllable: str) -> Tuple[str, str, str, str]:
    """Parse one jyutping syllable into (onset, nucleus, coda, tone).

    >>> parse_jyutping("keoi5")
    ('k', 'eo', 'i', '5')
    >>> parse_jyutping("ng5")
    ('', 'ng', '', '5')
    """
    m = _SYLLABLE_RE.match(syllable)
    if not m:
        raise JyutpingError(f"Failed to parse jyutping: {syllable!r}")
    body, tone = m.group(1), m.group(2)

    candidates = []
    for onset in [o for o in ONSETS if body.startswith(o)] + [""]:
        rest = body[len(onset):]
        if not rest and onset in ("m", "ng"):
            # syllabic nasal written with no separate nucleus: treat as nucleus
            candidates.append(("", onset, ""))
            continue
        for nucleus in [n for n in NUCLEUSES if rest.startswith(n)]:
            coda = rest[len(nucleus):]
            if coda == "" or coda in CODAS:
                candidates.append((onset, nucleus, coda))
    if not candidates:
        raise JyutpingError(f"Failed to parse jyutping: {syllable!r}")

    # Prefer longest onset, then longest nucleus (greedy, like pycantonese).
    candidates.sort(key=lambda c: (len(c[0]), len(c[1])), reverse=True)
    onset, nucleus, coda = candidates[0]
    return onset, nucleus, coda, tone


def is_valid_jyutping(syllable: str) -> bool:
    try:
        parse_jyutping(syllable)
        return True
    except JyutpingError:
        return False
