"""The port's LTS trainer (`jyutvoice_tpu_torch/text/lts.py`) against the JAX
package's on a small synthetic dictionary: CMUdict is in neither package, so
nothing here trains on it. For the same seed, holdout and iterations the
rule table, the held-out words and `phone_accuracy` (LTS-only and the
dictionary-backed hybrid, with and without stress) must be equal, and
`main` must write the same model to `--out` (a temporary path: the shipped
artifact is never written) and raise "no CMUdict found" without a
dictionary."""

import gzip
import os
import pickle
import random

import pytest

from jyutvoice_tpu.text import english as jenglish
from jyutvoice_tpu.text import lts as jlts
from jyutvoice_tpu_torch.text import english as penglish
from jyutvoice_tpu_torch.text import lts as plts

# a toy spelling: one or two ARPAbet phones per letter, vowels stressed
_SOUNDS = {
    "a": ["AE1"], "b": ["B"], "c": ["K"], "d": ["D"], "e": ["EH1"], "f": ["F"],
    "g": ["G"], "h": ["HH"], "i": ["IH1"], "k": ["K"], "l": ["L"], "m": ["M"],
    "n": ["N"], "o": ["OW1"], "p": ["P"], "r": ["R"], "s": ["S"], "t": ["T"],
    "u": ["AH0"], "v": ["V"], "w": ["W"], "x": ["K", "S"], "y": ["IY0"], "z": ["Z"],
}


def _dictionary(n=400, seed=7):
    """{UPPERCASE word: [syllable phone lists]} in english.get_dict's format,
    with silent final e's and a few irregular entries the EM must absorb."""
    rng = random.Random(seed)
    letters = sorted(_SOUNDS)
    out = {}
    while len(out) < n:
        word = "".join(rng.choice(letters) for _ in range(rng.randint(2, 8)))
        phones = [p for c in word for p in _SOUNDS[c]]
        if rng.random() < 0.2:
            word += "e"  # silent
        if rng.random() < 0.05:
            phones = phones[::-1]  # an irregular one
        half = max(1, len(phones) // 2)
        out[word.upper()] = [phones[:half], phones[half:]] if len(phones) > 1 else [phones]
    out["IT'S"] = [["IH1", "T", "S"]]
    out["R2D2"] = [["AA1", "R"]]  # not alphabetic: dropped by both trainers
    return out


@pytest.mark.parametrize("iterations,holdout,seed", [(3, 0.1, 0), (1, 0.0, 3), (2, 0.25, 1)])
def test_train_matches_jax(iterations, holdout, seed):
    entries = _dictionary()
    pm, ph = plts.train(entries, iterations=iterations, seed=seed, holdout=holdout)
    jm, jh = jlts.train(entries, iterations=iterations, seed=seed, holdout=holdout)
    assert pm == jm and ph == jh
    assert len(ph) == int(holdout * (len(entries) - 1))
    assert sum(len(r) for r in pm["rules"]) > 0
    held = ph or jh or [(w.lower(), plts._word_phones(e)) for w, e in list(entries.items())[:40]]
    train_dict = {k: v for k, v in entries.items() if k.lower() not in {w for w, _ in held}}
    for kw in ({}, {"dictionary": train_dict}, {"dictionary": train_dict, "stress": False}):
        assert plts.phone_accuracy(pm, held, **kw) == jlts.phone_accuracy(jm, held, **kw)
    word = held[0][0]
    assert plts.predict(pm, word) == jlts.predict(jm, word)


def test_viterbi_and_init_match_jax():
    entries = _dictionary(60)
    pairs = [(w.lower(), plts._word_phones(e)) for w, e in entries.items() if w.isalpha()]
    assert plts._init_logp(pairs) == jlts._init_logp(pairs)
    logp = plts._init_logp(pairs)
    for word, phones in pairs:
        assert plts._viterbi_align(word, phones, logp) == jlts._viterbi_align(word, phones, logp)
    assert plts._viterbi_align("ab", ["B"] * 9, logp) == []  # no alignment fits


def _write_cmudict(path, entries):
    """cmudict.rep's layout: 48 header lines, then 'WORD  SYL - SYL'."""
    with open(path, "w", encoding="latin-1") as f:
        f.write("#\n" * 48)
        for word, syls in entries.items():
            f.write(f"{word}  {' - '.join(' '.join(s) for s in syls)}\n")


@pytest.fixture
def cmudict_env(monkeypatch):
    """Point both packages' get_dict at a path (or nothing) for one test."""

    def point(path):
        monkeypatch.setenv("JYUTVOICE_CMUDICT", path)
        for mod in (penglish, jenglish):
            monkeypatch.setattr(mod, "_CMUDICT_CANDIDATES", [])
            mod.get_dict.cache_clear()

    yield point
    for mod in (penglish, jenglish):
        mod.get_dict.cache_clear()


def test_main_writes_the_jax_model(tmp_path, cmudict_env, capsys):
    entries = {k: v for k, v in _dictionary(200).items() if k != "R2D2"}
    _write_cmudict(tmp_path / "cmudict.rep", entries)
    cmudict_env(str(tmp_path / "cmudict.rep"))
    with open(plts.MODEL_PATH, "rb") as f:
        shipped = f.read()
    args = ["--train", "--iterations", "2", "--holdout", "0.1"]
    plts.main(args + ["--out", str(tmp_path / "port.pkl.gz")])
    port_line = capsys.readouterr().out
    jlts.main(args + ["--out", str(tmp_path / "jax.pkl.gz")])
    jax_line = capsys.readouterr().out
    assert port_line.replace("port.pkl.gz", "X") == jax_line.replace("jax.pkl.gz", "X")
    assert "held-out phone accuracy" in port_line
    with gzip.open(tmp_path / "port.pkl.gz", "rb") as a, gzip.open(tmp_path / "jax.pkl.gz", "rb") as b:
        assert pickle.load(a) == pickle.load(b)
    with open(plts.MODEL_PATH, "rb") as f:
        assert f.read() == shipped  # the shipped artifact is untouched


def test_main_without_a_dictionary_raises(tmp_path, cmudict_env):
    cmudict_env(str(tmp_path / "missing.rep"))
    with pytest.raises(SystemExit, match="no CMUdict found"):
        plts.main(["--train", "--out", str(tmp_path / "never.pkl.gz")])
    assert not os.path.exists(tmp_path / "never.pkl.gz")
