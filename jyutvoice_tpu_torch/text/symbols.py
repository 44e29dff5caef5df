"""Phone symbol inventory: union of Cantonese, Mandarin and English sets.

Produces the same 97-symbol table as the reference (text/symbols.py:1-14 and
the per-language symbol files) so token ids are interchangeable: pad `_`,
`SP`, `UNK`, 7 punctuation marks, then the sorted union of phone strings.
"""

# Cantonese (jyutping) phones — text/cantonese/symbols.py
CANTONESE_ONSETS = "b d g gw z p t k kw c m n ng f h s l w j".split()
CANTONESE_NUCLEUSES = "aa a i yu u oe e eo o m n ng".split()
CANTONESE_CODAS = "p t k m n ng i u".split()
cantonese_symbols = sorted(
    set(CANTONESE_ONSETS + CANTONESE_NUCLEUSES + CANTONESE_CODAS)
)

# Mandarin (pinyin) phones — text/mandarin/symbols.py
MANDARIN_INITIALS = [
    "b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h",
    "j", "q", "x", "zh", "ch", "sh", "r", "z", "c", "s",
]
MANDARIN_FINALS = [
    "i", "iu", "ui", "u", "v", "a", "ia", "ua", "o", "uo", "e", "ie", "ue",
    "ve", "ai", "uai", "ei", "uei", "ao", "iao", "ou", "iou", "an", "ian",
    "uan", "van", "en", "in", "un", "uen", "vn", "ang", "iang", "uang",
    "eng", "ing", "ueng", "ong", "iong", "er",
]
mandarin_symbols = MANDARIN_INITIALS + MANDARIN_FINALS

# English (lowercased ARPAbet, 'v' capitalized) — text/english/symbols.py
english_symbols = [
    "aa", "ae", "ah", "ao", "aw", "ay", "b", "ch", "d", "dh", "eh", "er",
    "ey", "f", "g", "hh", "ih", "iy", "jh", "k", "l", "m", "n", "ng", "ow",
    "oy", "p", "r", "s", "sh", "t", "th", "uh", "uw", "V", "w", "y", "z",
    "zh",
]

punctuations = ["!", "?", "…", ",", ".", "'", "-"]
pu_symbols = ["SP", "UNK"] + punctuations
pad = "_"

_all_symbols = sorted(set(cantonese_symbols + english_symbols + mandarin_symbols))

symbols = [pad] + pu_symbols + _all_symbols
symbol_to_id = {s: i for i, s in enumerate(symbols)}
id_to_symbol = {i: s for i, s in enumerate(symbols)}
