"""English number expansion without external dependencies.

Re-implements the reference's tacotron-derived normalizer
(text/number_utils.py:64-71) with a built-in number-to-words engine that
reproduces `inflect`'s rendering conventions (inflect is not installable
here, so the engine mirrors its enword/hundfn/tenfn semantics):

  * hyphenated tens-units compounds ('fifty-six', 'twenty-first'),
  * ', ' between 3-digit scale groups ('three thousand, four hundred
    fifty-six') — the comma is a real g2p pause token, so keeping it
    matters for parity,
  * the and-word joins the final sub-hundred group and splices between
    'hundred' and its remainder; the reference passes andword='' for
    cardinals ('one thousand one') and the inflect DEFAULT 'and' for
    ordinals ('101st' -> 'one hundred and first'),
  * ordinals by suffix rewrite on the last word ('twenty-one' ->
    'twenty-first', 'sixty' -> 'sixtieth').

Flow parity matters more than it looks: the reference expands dollars/
pounds/decimals to DIGIT strings and lets the final `_number_re` pass
render words — so '$1,234' reads year-style ('twelve thirty-four
dollars'), '3.14' reads 'three point fourteen' (fraction as a cardinal,
'0.05' loses its leading zero), and '1 dollar, 1 cent' keeps the comma.
This module follows the same two-phase flow.
(The reference's own tests/test_number_utils.py expects strings its code
never produces — e.g. '1st' -> 'one' where inflect renders 'first' — we
match the code, which is what a user runs. Note the reference never wires
normalize_numbers into a cleaner: it is a tested standalone utility there,
and here.)

Known divergence: inflect raises OutOfRange past decillion (10^36); we
render the overflow head as a recursive decillion multiple instead of
crashing text normalization.
"""

from __future__ import annotations

import re

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
# scale word per 3-digit group index (inflect's mill table)
_SCALE_WORDS = [
    "", "thousand", "million", "billion", "trillion", "quadrillion",
    "quintillion", "sextillion", "septillion", "octillion", "nonillion",
    "decillion",
]
# inflect ordinalizes words by rewriting the longest matching suffix of the
# LAST word ('twenty-one' -> 'twenty-first', 'sixty' -> 'sixtieth')
_ORDINAL_SUFFIXES = [
    ("ty", "tieth"), ("one", "first"), ("two", "second"),
    ("three", "third"), ("five", "fifth"), ("eight", "eighth"),
    ("nine", "ninth"), ("twelve", "twelfth"),
]

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _tens_units(n: int) -> str:
    """1..99 with inflect's hyphen: 56 -> 'fifty-six'."""
    if n < 20:
        return _UNITS[n]
    tens, unit = divmod(n, 10)
    return _TENS[tens] + ("-" + _UNITS[unit] if unit else "")


def _group_words(n: int, andword: str) -> str:
    """1..999; andword splices between 'hundred' and the remainder
    (inflect hundfn): 101 -> 'one hundred and one' / 'one hundred one'."""
    h, r = divmod(n, 100)
    if h and r:
        sep = f" {andword} " if andword else " "
        return f"{_UNITS[h]} hundred{sep}{_tens_units(r)}"
    if h:
        return f"{_UNITS[h]} hundred"
    return _tens_units(r)


def number_to_words(n: int, andword: str = "") -> str:
    """Integer -> English words, inflect-style: 3-digit groups joined by
    ', ', except a final group < 100 joins via the andword ('one thousand
    and one' / andword='': 'one thousand one'). 1234 -> 'one thousand,
    two hundred thirty-four' (andword='')."""
    if n < 0:
        return "minus " + number_to_words(-n, andword)
    if n == 0:
        return "zero"
    if n >= 10 ** (3 * len(_SCALE_WORDS)):
        head, rest = divmod(n, 10 ** (3 * (len(_SCALE_WORDS) - 1)))
        out = number_to_words(head, andword) + " " + _SCALE_WORDS[-1]
        return out + (", " + number_to_words(rest, andword) if rest else "")

    groups = []  # (value, scale_index), most-significant first
    idx = 0
    while n:
        n, g = divmod(n, 1000)
        if g:
            groups.append((g, idx))
        idx += 1
    groups.reverse()

    parts = []
    for g, i in groups:
        words = _group_words(g, andword)
        parts.append(words + (" " + _SCALE_WORDS[i] if i else ""))
    if len(parts) > 1 and groups[-1][1] == 0 and groups[-1][0] < 100:
        # final bare sub-hundred group: ', one' -> ' and one' (inflect's
        # COMMA_WORD rule; single hyphenated compounds count as one word)
        last_sep = f" {andword} " if andword else " "
        return ", ".join(parts[:-1]) + last_sep + parts[-1]
    return ", ".join(parts)


def ordinalize_words(words: str) -> str:
    """Suffix rewrite on the final word (inflect.ordinal word path)."""
    for suf, rep in _ORDINAL_SUFFIXES:
        if words.endswith(suf):
            return words[: -len(suf)] + rep
    return words + "th"


def number_to_ordinal_words(n: int) -> str:
    # the reference's _expand_ordinal calls number_to_words with DEFAULT
    # arguments, so ordinals keep inflect's andword='and'
    return ordinalize_words(number_to_words(n, andword="and"))


def _two_digit_groups(n: int) -> str:
    """Year-style reading by 2-digit groups: 1984 -> 'nineteen eighty-four'
    (inflect group=2, zero='oh'; the reference strips the group commas)."""
    s = str(n)
    if len(s) % 2:
        s = "0" + s
    groups = [int(s[i : i + 2]) for i in range(0, len(s), 2)]
    words = []
    for g in groups:
        words.append("oh " + _UNITS[g] if 0 < g < 10 else _tens_units(g))
    return " ".join(words)


def _remove_commas(m):
    return m.group(1).replace(",", "")


def _expand_decimal_point(m):
    # digits stay: '3.14' -> '3 point 14'; the final number pass renders
    # 'three point fourteen' (reference flow — NOT digit-by-digit)
    return m.group(1).replace(".", " point ")


def _expand_dollars(m):
    # digits stay (final pass renders words, year-style in (1000, 3000))
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        du = "dollar" if dollars == 1 else "dollars"
        cu = "cent" if cents == 1 else "cents"
        return f"{dollars} {du}, {cents} {cu}"
    if dollars:
        du = "dollar" if dollars == 1 else "dollars"
        return f"{dollars} {du}"
    if cents:
        cu = "cent" if cents == 1 else "cents"
        return f"{cents} {cu}"
    return "zero dollars"


def _expand_pounds(m):
    # digits stay (commas were already stripped by the comma pass)
    return m.group(1) + " pounds"


def _expand_ordinal(m):
    return number_to_ordinal_words(int(m.group(0)[:-2]))


def _expand_number(m):
    num = int(m.group(0))
    # year-style handling in (1000, 3000) as in the reference
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return _two_digit_groups(num)
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, _expand_pounds, text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
