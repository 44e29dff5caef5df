"""English g2p: CMUdict lookup with ARPAbet-stress tones.

Mirrors reference text/english/g2p.py:217-305:
  * words come from a subword tokenizer (DebertaV2 sentencepiece when a model
    is available, else a regex fallback),
  * pronunciation = CMU dict lookup (dict file is user-provided data; see
    `find_cmudict`), with a rule-based letter-to-sound fallback for OOV,
  * tone = ARPAbet stress digit + 1 (no digit -> 3),
  * syllable_pos = 1/2/3 for first/middle/last phone of a word,
  * word_pos = 1 always, lang id 2 = English,
  * `distribute_phone` spreads a word's phones evenly over its subword tokens.
"""

from __future__ import annotations

import functools
import os
import re
from typing import List, Optional, Sequence

from jyutvoice_tpu_torch.text.symbols import punctuations, symbols

_symbols_set = set(symbols)

# Standard search locations for the CMU pronouncing dictionary data file.
_CMUDICT_ENV = "JYUTVOICE_CMUDICT"
_CMUDICT_CANDIDATES = [
    os.path.join(os.path.dirname(__file__), "data", "cmudict.rep"),
]

_DEBERTA_ENV = "JYUTVOICE_DEBERTA"
_DEBERTA_CANDIDATES = [
    "./bert/deberta-v3-large",
]

_POST_REPLACE = {
    "：": ",", "；": ",", "，": ",", "。": ".", "！": "!", "？": "?",
    "\n": ".", "·": ",", "、": ",", "…": "...", "···": "...",
    "・・・": "...", "v": "V",
}

# Minimal rule-based letter-to-sound for OOV words (used only when the word
# is missing from CMUdict; a coarse but deterministic stand-in for g2p_en).
_LTS = {
    "a": [("ah", 3)], "b": [("b", 0)], "c": [("k", 0)], "d": [("d", 0)],
    "e": [("eh", 3)], "f": [("f", 0)], "g": [("g", 0)], "h": [("hh", 0)],
    "i": [("ih", 3)], "j": [("jh", 0)], "k": [("k", 0)], "l": [("l", 0)],
    "m": [("m", 0)], "n": [("n", 0)], "o": [("ow", 3)], "p": [("p", 0)],
    "q": [("k", 0)], "r": [("r", 0)], "s": [("s", 0)], "t": [("t", 0)],
    "u": [("ah", 3)], "V": [("V", 0)], "v": [("V", 0)], "w": [("w", 0)],
    "x": [("k", 0), ("s", 0)], "y": [("y", 0)], "z": [("z", 0)],
}
_LTS_DIGRAPHS = {
    "ch": [("ch", 0)], "sh": [("sh", 0)], "th": [("th", 0)],
    "ph": [("f", 0)], "ng": [("ng", 0)], "ee": [("iy", 3)],
    "oo": [("uw", 3)], "qu": [("k", 0), ("w", 0)],
}


def find_cmudict() -> Optional[str]:
    path = os.environ.get(_CMUDICT_ENV)
    if path and os.path.exists(path):
        return path
    for cand in _CMUDICT_CANDIDATES:
        if os.path.exists(cand):
            return cand
    return None


def _read_cmudict(path: str) -> dict:
    """Parse cmudict.rep: entries start at line 49, 'WORD  SYL - SYL' with
    phones space-separated (reference english/g2p.py:116-137)."""
    g2p_dict = {}
    with open(path, encoding="latin-1") as f:
        for line_index, line in enumerate(f, start=1):
            if line_index < 49:
                continue
            line = line.strip()
            if not line:
                continue
            parts = line.split("  ")
            if len(parts) < 2:
                continue
            word = parts[0]
            g2p_dict[word] = [syl.split(" ") for syl in parts[1].split(" - ")]
    return g2p_dict


@functools.lru_cache(maxsize=1)
def get_dict() -> dict:
    # parsed once per process and kept in memory; nothing is written to disk
    path = find_cmudict()
    if path is None:
        return {}
    return _read_cmudict(path)


def post_replace_ph(ph: str) -> str:
    ph = _POST_REPLACE.get(ph, ph)
    return ph if ph in _symbols_set else "UNK"


def refine_ph(phn: str):
    """ARPAbet phone -> (lowercase phone, tone): stress digit + 1, else 3
    (reference english/g2p.py:159-166)."""
    if re.search(r"\d$", phn):
        return phn[:-1].lower(), int(phn[-1]) + 1
    return phn.lower(), 3


def refine_syllables(syllables: Sequence[Sequence[str]]):
    phones, tones = [], []
    for phn_list in syllables:
        for phn in phn_list:
            p, t = refine_ph(phn)
            phones.append(p)
            tones.append(t)
    return phones, tones


def distribute_phone(n_phone: int, n_word: int) -> List[int]:
    """Spread n_phone phones as evenly as possible over n_word tokens
    (reference english/g2p.py:181-187)."""
    per = [0] * n_word
    for _ in range(n_phone):
        per[per.index(min(per))] += 1
    return per


def _letter_to_sound(word: str):
    """OOV pronunciation: trained decision-list LTS distilled from CMUdict
    (text/lts.py — the stand-in for the reference's neural g2p_en,
    reference english/g2p.py:244-254), with the crude rule map as the last
    resort when the trained artifact is unavailable."""
    from jyutvoice_tpu_torch.text import lts

    model = lts.load_model()
    if model is not None:
        # morphology over the dictionary first (inflections/compounds of
        # in-dictionary words), then the trained decision-list LTS
        phns = lts.predict_pron(word, get_dict(), model)
        if phns:
            out = [refine_ph(p) for p in phns]
            return [p for p, _ in out], [t for _, t in out]
    phones: List[str] = []
    tones: List[int] = []
    w = word.lower()
    i = 0
    while i < len(w):
        pair = w[i : i + 2]
        if pair in _LTS_DIGRAPHS:
            for p, t in _LTS_DIGRAPHS[pair]:
                phones.append(p)
                tones.append(t)
            i += 2
            continue
        ch = w[i]
        for p, t in _LTS.get(ch, []):
            phones.append(p)
            tones.append(t)
        i += 1
    if not phones:
        phones, tones = ["UNK"], [0]
    return phones, tones


@functools.lru_cache(maxsize=1)
def _get_deberta_tokenizer():
    path = os.environ.get(_DEBERTA_ENV)
    candidates = ([path] if path else []) + _DEBERTA_CANDIDATES
    for cand in candidates:
        if cand and os.path.isdir(cand):
            try:
                from transformers import DebertaV2Tokenizer  # type: ignore

                return DebertaV2Tokenizer.from_pretrained(cand)
            except Exception:
                continue
    return None


def _group_subword_tokens(tokens: List[str]) -> List[List[str]]:
    """Group sentencepiece tokens into word units
    (reference english/g2p.py:190-214)."""
    words: List[List[str]] = []
    for idx, t in enumerate(tokens):
        if t.startswith("▁"):
            words.append([t[1:]])
        elif t in punctuations:
            if idx == len(tokens) - 1:
                words.append([t])
            else:
                nxt = tokens[idx + 1]
                if not nxt.startswith("▁") and nxt not in punctuations:
                    if idx == 0:
                        words.append([])
                    words[-1].append(t)
                else:
                    words.append([t])
        else:
            if idx == 0:
                words.append([])
            words[-1].append(t)
    return words


_FALLBACK_TOKEN_RE = re.compile(
    r"[A-Za-z']+|[{}]".format(re.escape("".join(punctuations)))
)


def text_to_words(text: str) -> List[List[str]]:
    """Tokenize into word units: DebertaV2 sentencepiece when available,
    regex word/punct split otherwise."""
    tok = _get_deberta_tokenizer()
    if tok is not None:
        return _group_subword_tokens(tok.tokenize(text))
    return [[t] for t in _FALLBACK_TOKEN_RE.findall(text)]


def g2p(text: str, phoneme=None, padding: bool = True):
    if phoneme is not None:
        raise NotImplementedError("Phoneme input is not supported for English.")

    eng_dict = get_dict()
    words = text_to_words(text)

    phones: List[str] = []
    tones: List[int] = []
    syllable_pos: List[int] = []
    phone_len: List[int] = []
    ws_labels: List[int] = []

    for word in words:
        temp_phones: List[str] = []
        temp_tones: List[int] = []
        if len(word) > 1 and "'" in word:
            word = ["".join(word)]
        for w in word:
            if w in punctuations:
                temp_phones.append(w)
                temp_tones.append(0)
                continue
            if w.upper() in eng_dict:
                phns, tns = refine_syllables(eng_dict[w.upper()])
            else:
                phns, tns = _letter_to_sound(w)
            temp_phones += [post_replace_ph(p) for p in phns]
            temp_tones += tns
        phones += temp_phones
        tones += temp_tones
        phone_len.append(len(temp_phones))
        ws_labels.append(1)  # English words are single units

        if len(temp_phones) == 1 and temp_phones[0] in punctuations:
            syllable_pos.append(0)
        else:
            for j in range(len(temp_phones)):
                if j == 0:
                    syllable_pos.append(1)
                elif j == len(temp_phones) - 1:
                    syllable_pos.append(3)
                else:
                    syllable_pos.append(2)

    word2ph: List[int] = []
    for token, pl in zip(words, phone_len):
        word2ph += distribute_phone(pl, len(token))

    assert len(phones) == len(tones), text
    assert len(phones) == sum(word2ph), text

    word_pos: List[int] = []
    idx = 0
    for word_idx, word in enumerate(words):
        label = ws_labels[word_idx]
        for _ in range(len(word)):
            word_pos.extend([label] * word2ph[idx])
            idx += 1

    if padding:
        phones = ["_"] + phones + ["_"]
        tones = [0] + tones + [0]
        word_pos = [0] + word_pos + [0]
        syllable_pos = [0] + syllable_pos + [0]
        word2ph = [1] + word2ph + [1]

    lang_ids = [2] * len(phones)
    return phones, tones, word2ph, word_pos, syllable_pos, lang_ids
