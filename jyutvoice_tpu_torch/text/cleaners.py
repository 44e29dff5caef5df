"""Text normalization + g2p dispatch (reference text/cleaners.py)."""

from __future__ import annotations

import re

from jyutvoice_tpu_torch.text import cantonese, english, mandarin, multilingual
from jyutvoice_tpu_torch.text.symbols import punctuations

rep_map = {
    "：": ",", "；": ",", "，": ",", "。": ".", "！": "!", "？": "?",
    "\n": ".", "·": ",", "、": ",", "…": "...", "⋯": "…", "$": ".",
    "“": "'", "”": "'", '"': "'", "‘": "'", "’": "'", "（": "'",
    "）": "'", "(": "'", ")": "'", "《": "'", "》": "'", "【": "'",
    "】": "'", "[": "'", "]": "'", "—": "-", "～": "-", "~": "-",
    "「": "'", "」": "'",
}

_REP_PATTERN = re.compile("|".join(re.escape(p) for p in rep_map))


def is_chinese(char: str) -> bool:
    if "一" <= char <= "鿿":
        return True
    if "㐀" <= char <= "䶿":
        return True
    return False


def replace_punctuation(text: str, lang: str = "yue") -> str:
    replaced = _REP_PATTERN.sub(lambda m: rep_map[m.group()], text)
    if lang == "en":
        keep = lambda c: (c.isalpha() or c in punctuations) and not c.isspace()
    elif lang == "multilingual":
        keep = lambda c: (
            is_chinese(c) or c.isalpha() or c in punctuations
        ) and not c.isspace()
    elif lang in ("yue", "zh"):
        keep = lambda c: (is_chinese(c) or c in punctuations) and not c.isspace()
    else:
        raise ValueError(f"Language {lang} not supported for punctuation replacement.")
    return "".join(c for c in replaced if keep(c))


def text_normalize(text: str, lang: str = "yue") -> str:
    return replace_punctuation(text.strip(), lang=lang)


_G2P = {
    "yue": cantonese.g2p,
    "zh": mandarin.g2p,
    "en": english.g2p,
    "multilingual": multilingual.g2p,
}


def clean_text(text: str, lang: str = "yue", phoneme=None, padding: bool = True):
    norm_text = " ".join(text_normalize(w, lang=lang) for w in text.split())
    try:
        g2p_fn = _G2P[lang]
    except KeyError:
        raise ValueError(f"Language {lang} not supported for text cleaning.")
    phones, tones, word2ph, word_pos, syllable_pos, lang_ids = g2p_fn(
        norm_text, phoneme, padding=padding
    )
    return norm_text, phones, tones, word_pos, syllable_pos, lang_ids
