"""Multilingual (mixed CJK/Latin) g2p (reference text/multilingual.py)."""

from __future__ import annotations

from typing import List, Tuple

from jyutvoice_tpu_torch.text import cantonese, english, mandarin


def is_chinese(char: str) -> bool:
    if "一" <= char <= "鿿":
        return True
    if "㐀" <= char <= "䶿":
        return True
    return False


def split_text(text: str) -> List[Tuple[str, bool]]:
    """Split into runs of consecutive Chinese / non-Chinese characters."""
    segments: List[Tuple[str, bool]] = []
    current = ""
    last = None
    for char in text:
        cur = is_chinese(char)
        if last is None or cur == last:
            current += char
            last = cur
        else:
            if current:
                segments.append((current, last))
            current = char
            last = cur
    if current:
        segments.append((current, last))
    return segments


def g2p(text: str, phoneme=None, padding: bool = True, lang: str = "yue"):
    """Route CJK runs to yue/zh g2p, the rest to English, then concatenate.

    Multilingual padding differs from monolingual: leading '-' instead of '_'
    (reference multilingual.py:101-108). Chunk lang ids come from each g2p.
    """
    if phoneme is not None:
        raise NotImplementedError("Phoneme input not supported for multilingual G2P.")

    all_phones: List[str] = []
    all_tones: List[int] = []
    all_word2ph: List[int] = []
    all_word_pos: List[int] = []
    all_syllable_pos: List[int] = []
    all_lang: List[int] = []

    for chunk, chunk_is_chinese in split_text(text):
        if not chunk:
            continue
        if chunk_is_chinese:
            if lang == "yue":
                res = cantonese.g2p(chunk, padding=False)
            elif lang == "zh":
                res = mandarin.g2p(chunk, padding=False)
            else:
                raise ValueError(f"Invalid lang {lang!r} for Chinese. Use 'yue' or 'zh'.")
        else:
            res = english.g2p(chunk, padding=False)
        phones, tones, word2ph, word_pos, syllable_pos, lang_ids = res
        all_phones += phones
        all_tones += tones
        all_word2ph += word2ph
        all_word_pos += word_pos
        all_syllable_pos += syllable_pos
        all_lang += lang_ids

    if padding:
        all_phones = ["-"] + all_phones + ["_"]
        all_tones = [0] + all_tones + [0]
        all_word2ph = [1] + all_word2ph + [1]
        all_word_pos = [0] + all_word_pos + [0]
        all_syllable_pos = [0] + all_syllable_pos + [0]
        all_lang = [0] + all_lang + [0]

    return all_phones, all_tones, all_word2ph, all_word_pos, all_syllable_pos, all_lang
