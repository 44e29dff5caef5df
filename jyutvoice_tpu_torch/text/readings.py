"""Self-contained hanzi -> reading lookup (fallback backends for g2p).

The reference resolves raw Chinese text through external pronouncing
packages: ToJyutping for Cantonese (reference text/cantonese/g2p.py:66-84)
and pypinyin for Mandarin (text/mandarin/g2p.py:13-19). Those are optional
here; when absent, these functions serve readings from the bundled curated
tables (data_jyutping.py / data_pinyin.py) so raw-text synthesis works with
zero optional dependencies — with a loud one-time warning, because coverage
is the high-frequency core, not a full dictionary.

Lookup is greedy longest-match over the word-exception table merged with the
character table (multi-character entries fix heteronyms in context), then
per-character defaults. Unknown characters raise ValueError naming the
character — same failure mode as the reference when ToJyutping returns no
reading.
"""

from __future__ import annotations

import logging
from typing import Dict, List

from jyutvoice_tpu_torch.text import data_jyutping, data_pinyin
from jyutvoice_tpu_torch.text.symbols import punctuations

log = logging.getLogger(__name__)

_warned = set()


def _warn_once(lang: str, package: str) -> None:
    if lang not in _warned:
        _warned.add(lang)
        log.warning(
            "%s is not installed; using the bundled %s reading table "
            "(high-frequency coverage only). Install %s for full-dictionary "
            "readings.",
            package, lang, package,
        )


def _merge(words: Dict[str, str], chars: Dict[str, str]) -> Dict[str, str]:
    merged = dict(chars)
    merged.update(words)  # word exceptions take precedence
    return merged


_JYUTPING_TABLE = _merge(data_jyutping.WORDS, data_jyutping.CHARS)
_PINYIN_TABLE = _merge(data_pinyin.WORDS, data_pinyin.CHARS)
_JYUTPING_MAX = max(len(k) for k in _JYUTPING_TABLE)
_PINYIN_MAX = max(len(k) for k in _PINYIN_TABLE)


def _greedy_readings(
    text: str, table: Dict[str, str], max_key: int, lang: str
) -> List[str]:
    """One reading (syllable string) per character of `text`.

    Greedy longest-match against the merged table; punctuation passes
    through as itself. Multi-character matches contribute their
    space-separated per-character syllables.
    """
    out: List[str] = []
    i = 0
    while i < len(text):
        ch = text[i]
        if ch in punctuations:
            out.append(ch)
            i += 1
            continue
        for n in range(min(max_key, len(text) - i), 0, -1):
            chunk = text[i : i + n]
            reading = table.get(chunk)
            if reading is not None:
                syllables = reading.split()
                if len(syllables) != n:  # defensive: table invariant
                    raise ValueError(
                        f"bundled {lang} table entry {chunk!r} has "
                        f"{len(syllables)} syllables for {n} characters"
                    )
                out.extend(syllables)
                i += n
                break
        else:
            raise ValueError(
                f"Character {ch!r} is not in the bundled {lang} reading "
                f"table. Install the full dictionary package "
                f"({'ToJyutping' if lang == 'jyutping' else 'pypinyin'}) or "
                "pass explicit phonemes (the --phone path)."
            )
    return out


def jyutping_readings(text: str) -> List[str]:
    """Per-character jyutping syllables for raw Cantonese text."""
    _warn_once("jyutping", "ToJyutping")
    return _greedy_readings(text, _JYUTPING_TABLE, _JYUTPING_MAX, "jyutping")


def pinyin_readings(text: str) -> List[str]:
    """Per-character pinyin syllables (pypinyin strict=False conventions,
    neutral tone digit-less) for raw Mandarin text."""
    _warn_once("pinyin", "pypinyin")
    return _greedy_readings(text, _PINYIN_TABLE, _PINYIN_MAX, "pinyin")


# pypinyin strict=False splitting: y/w count as initials, surface finals
# are kept verbatim (you -> y + ou3, ju -> j + u1), neutral tone has no
# digit -> tone 0 downstream (reference text/mandarin/g2p.py:13-19 uses
# Style.INITIALS/FINALS_TONE3 with strict=False).
_INITIALS_LOOSE = [
    "zh", "ch", "sh",
    "b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h",
    "j", "q", "x", "r", "z", "c", "s", "y", "w",
]


def split_pinyin_loose(syllable: str) -> tuple:
    """'wo3' -> ('w', 'o3'); 'an1' -> ('', 'an1'); 'de' -> ('d', 'e').

    Non-pinyin input (punctuation) returns (s, s) — pypinyin passes
    punctuation through identically in both INITIALS and FINALS styles,
    and the g2p punctuation branch keys on initial == final."""
    body = syllable
    if not body or not body[0].isalpha():
        return body, body
    for cand in _INITIALS_LOOSE:
        if body.startswith(cand) and len(body) > len(cand):
            return cand, body[len(cand):]
    return "", body
