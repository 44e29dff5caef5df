"""The port's dataset preparation (`cli/prepare_dataset.py`) against the JAX
package's, on the CPU: `process_row` and `process_batch` over the same rows
with both packages' `PromptExtractor` on the same small trees (flow
encoder 64-d, CAM++ layers (2, 2, 2), S3 64-d: `test_torch_port_prompt.py`'s
set-up). The same columns and `audio_processed` flags, ids exact, speech
tokens equal, `mel` / `spk_emb` / `decoder_h` within the bars that
`test_torch_port_prompt.py` holds the extractor to (atol 1e-4; spk_emb
rtol 1e-3); failing rows (unknown text, too-short audio) carry the same
empty columns. `main` runs on a tiny HF dataset directory when `datasets`
imports (per row and batched, sharded, merged) and raises a clear error
without it.
"""

import sys

import numpy as np
import pytest

from jyutvoice_tpu.cli import prepare_dataset as jprep
from jyutvoice_tpu_torch.cli import prepare_dataset as pprep
from test_torch_port_prompt import _extractors, _perturb_norms, _speechlike
from torch_port_setup import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

IDS = ("phone_ids", "tones", "word_pos", "syllable_pos", "lang_ids")


@pytest.fixture(scope="module")
def extractors():
    """(JAX extractor, port extractor) on the same numpy trees (the paths
    and shapes of init_flow_encoder / init_campplus / init_s3_tokenizer)."""
    from jyutvoice_tpu_torch.weights import random_init
    from test_torch_port_prompt import PCP, PFE, PS3

    fe = random_init.init_flow_encoder_tree(PFE, seed=2)
    cp = random_init.init_campplus_tree(PCP, seed=0)
    s3 = random_init.init_s3_tree(PS3, seed=1)
    _perturb_norms(cp, 0)
    return _extractors((fe, cp, s3))


def _rows():
    """Two good rows of different rates, one whose text has a character no
    reading covers, one too short for the mel front end."""
    return {
        "text": ["佢 好", "好 世 界", "龘", "佢"],
        "phone": ["keoi5 hou2", "hou2 sai3 gaai3", None, "keoi5"],
        "lang": ["yue", "yue", "yue", "yue"],
        "audio": [
            {"array": _speechlike(1.3, 24000, 1), "sampling_rate": 24000},
            {"array": _speechlike(1.1, 16000, 2), "sampling_rate": 16000},
            {"array": _speechlike(1.0, 24000, 3), "sampling_rate": 24000},
            {"array": np.zeros(100, np.float32), "sampling_rate": 16000},
        ],
    }


def _assert_row(got, want):
    assert set(got) == set(want)
    assert got["audio_processed"] == want["audio_processed"]
    for k in IDS + ("speech_tokens",):
        assert got[k] == want[k], k
    if not want["audio_processed"]:
        for k in ("mel", "spk_emb", "decoder_h"):
            assert got[k] == want[k] == [], k
        return
    np.testing.assert_allclose(got["mel"], want["mel"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got["spk_emb"], want["spk_emb"], atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(got["decoder_h"], want["decoder_h"], atol=1e-4, rtol=1e-4)
    # the flow encoder upsamples tokens x2; mel and decoder_h trim to the shorter
    assert len(got["decoder_h"]) == len(got["mel"]) <= 2 * len(got["speech_tokens"])


def test_capability_columns(extractors):
    jex, pex = extractors
    assert pprep._capability_columns(pex) == jprep._capability_columns(jex)
    assert pprep._capability_columns(pex)[0][-2:] == ["decoder_h", "speech_tokens"]


def test_process_batch_matches_jax(extractors):
    jex, pex = extractors
    rows = _rows()
    got = pprep.process_batch(rows, pex)
    want = jprep.process_batch(rows, jex)
    assert set(got) == set(want)
    assert got["audio_processed"] == want["audio_processed"] == [True, True, False, False]
    for i in range(len(rows["text"])):
        _assert_row({k: v[i] for k, v in got.items() if k != "audio"},
                    {k: v[i] for k, v in want.items() if k != "audio"})


def test_process_row_matches_jax_and_the_batch(extractors):
    jex, pex = extractors
    rows = _rows()
    batch = pprep.process_batch(rows, pex)
    for i in (0, 2):
        row = {k: v[i] for k, v in rows.items()}
        got = pprep.process_row(row, pex)
        _assert_row({k: v for k, v in got.items() if k != "audio"},
                    {k: v for k, v in jprep.process_row(row, jex).items() if k != "audio"})
        _assert_row({k: v for k, v in got.items() if k != "audio"},
                    {k: v[i] for k, v in batch.items() if k != "audio"})


def _dataset(datasets, path):
    rng = np.random.default_rng(0)
    rows = {
        "text": ["佢 好"] * 4, "phone": ["keoi5 hou2"] * 4, "lang": ["yue"] * 4,
        "audio": [{"array": rng.uniform(-0.3, 0.3, n).astype(np.float32),
                   "sampling_rate": 24000} for n in (24000, 36000, 100, 24000)],
    }
    datasets.Dataset.from_dict(rows).save_to_disk(path)


def test_main_prepares_merges_and_trains(tmp_path):
    """No artifacts (zero speaker embeddings, no decoder_h): per row and
    batched give the same rows, the too-short row is dropped, two shards
    merge back, and the datamodule reads the result."""
    datasets = pytest.importorskip("datasets")
    from jyutvoice_tpu_torch.train.datamodule import DataConfig, TextMelDataModule

    raw = str(tmp_path / "raw")
    _dataset(datasets, raw)
    out = {}
    for name, extra in (("row", []), ("batch", ["--device-batch", "2"]),
                        ("s0", ["--worlds", "2", "--rank", "0"]),
                        ("s1", ["--worlds", "2", "--rank", "1"])):
        out[name] = str(tmp_path / name)
        pprep.main(["--input", raw, "--output", out[name], "--device", "cpu", *extra])
    pprep.main(["--merge", out["s0"], out["s1"], "--output", str(tmp_path / "merged")])
    row, batch = datasets.load_from_disk(out["row"]), datasets.load_from_disk(out["batch"])
    merged = datasets.load_from_disk(str(tmp_path / "merged"))
    assert len(row) == len(batch) == len(merged) == 3
    assert "decoder_h" not in row.column_names
    for a, b in zip(row, batch):
        assert a["phone_ids"] == b["phone_ids"] and np.allclose(a["mel"], b["mel"], atol=1e-5)
    assert len(row[0]["mel"]) == 50 and row[0]["spk_emb"] == [0.0] * 192
    dm = TextMelDataModule(out["row"], DataConfig(batch_size=2, valid_ratio=0.25))
    assert next(iter(dm.train_batches()))["y"].shape[-1] == 80


def test_main_without_datasets(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(RuntimeError, match="needs the `datasets` package"):
        pprep.main(["--input", str(tmp_path), "--output", str(tmp_path / "o")])
