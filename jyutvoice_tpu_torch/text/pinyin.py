"""Self-contained pinyin syllable splitting (initials + strict finals).

Replaces the reference's `pypinyin.style` converters used for user-supplied
pinyin input (text/mandarin/g2p.py:23-29): `initials_convert(strict=True)`
plus `FinalsConverter.to_finals_tone3(strict=True)`.

Strict mode means: y/w are not initials; surface finals are rewritten to the
phonological finals (iu->iou, ui->uei, un->uen, u after j/q/x -> v, the
y-/w- spellings expanded), matching the final inventory in symbols.py.
"""

from __future__ import annotations

import re
from typing import Tuple

INITIALS = sorted(
    [
        "b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h",
        "j", "q", "x", "zh", "ch", "sh", "r", "z", "c", "s",
    ],
    key=len,
    reverse=True,
)

# Whole-syllable spellings with no initial (strict mode): surface -> final
_WHOLE_SYLLABLE = {
    "yi": "i", "ya": "ia", "ye": "ie", "yao": "iao", "you": "iou",
    "yan": "ian", "yin": "in", "yang": "iang", "ying": "ing", "yong": "iong",
    "yu": "v", "yue": "ve", "yuan": "van", "yun": "vn", "yo": "io",
    "wu": "u", "wa": "ua", "wo": "uo", "wai": "uai", "wei": "uei",
    "wan": "uan", "wen": "uen", "wang": "uang", "weng": "ueng",
}

# Abbreviated finals after an initial: surface -> strict
_ABBREV_FINALS = {"iu": "iou", "ui": "uei", "un": "uen"}

# After j/q/x (and y handled above), written u is phonemically v (ü)
_U_TO_V_INITIALS = {"j", "q", "x"}

_SYLLABLE_RE = re.compile(r"^([a-zA-Z]+)([0-9])$")


def split_pinyin_syllable(syllable: str) -> Tuple[str, str]:
    """Split 'hao3' -> ('h', 'ao3'); returns ('', syllable) for non-pinyin.

    Anything not matching letters+digit comes back with an EMPTY initial,
    mirroring the reference's splitter (mandarin/g2p.py:22-28 "Treat as
    punctuation or invalid syllable"). Downstream this is a deliberate
    reference quirk: pinyin_to_phonemes' punctuation branch keys on
    `initial == final`, which ('', '?') does NOT satisfy — so explicit-
    pinyin punctuation takes the syllable branch and gets syllable_pos=1,
    while raw-text punctuation (pypinyin returns the char for BOTH styles)
    gets syllable_pos=0. Replicated, not fixed (cross-checked live in
    tests/test_text_crossref.py).
    """
    m = _SYLLABLE_RE.match(syllable)
    if m is None:
        return "", syllable
    body, tone = m.group(1).lower(), m.group(2)

    if body in _WHOLE_SYLLABLE:
        return "", _WHOLE_SYLLABLE[body] + tone

    initial = ""
    for cand in INITIALS:
        if body.startswith(cand):
            initial = cand
            break
    final = body[len(initial):]

    if initial in _U_TO_V_INITIALS and final.startswith("u"):
        # after j/q/x, written u is phonemically v (ü): u->v, ue->ve,
        # uan->van, un->vn — the un->uen abbreviation does not apply
        final = "v" + final[1:]
    elif final in _ABBREV_FINALS:
        final = _ABBREV_FINALS[final]
    # ü spelled with u-umlaut
    final = final.replace("ü", "v")
    return initial, final + tone
