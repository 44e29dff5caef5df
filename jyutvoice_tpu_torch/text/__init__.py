"""Host-side text frontend: text -> token id tuples.

Mirrors reference jyutvoice/text/__init__.py. All heavy lifting is pure
Python; the outputs feed the jittable models as int arrays.
"""

from __future__ import annotations

from typing import List, Sequence

from jyutvoice_tpu_torch.text.cleaners import clean_text
from jyutvoice_tpu_torch.text.symbols import id_to_symbol, symbol_to_id, symbols

LANGUAGE_CODES = {
    "yue": 0,
    "zh": 1,
    "en": 2,
}


def text_to_sequence(text: str, lang: str, phone=None):
    """Text -> (phone_ids, tones, word_pos, syllable_pos, lang_ids)."""
    _, phones, tones, word_pos, syllable_pos, lang_ids = clean_text(
        text, lang=lang, phoneme=phone, padding=True
    )
    return cleaned_text_to_sequence(phones), tones, word_pos, syllable_pos, lang_ids


def cleaned_text_to_sequence(cleaned_text: Sequence[str]) -> List[int]:
    return [symbol_to_id[s] for s in cleaned_text]


def sequence_to_text(sequence: Sequence[int]) -> str:
    return "".join(id_to_symbol[i] for i in sequence)


def intersperse(lst: Sequence, item) -> List:
    """Insert `item` between every element (reference utils/utils.py:131-135)."""
    result = [item] * (len(lst) * 2 + 1)
    result[1::2] = lst
    return result
