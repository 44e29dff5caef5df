"""Data pipeline: dataset rows -> padded training batches.

The port's own copy of the JAX package's `train/datamodule.py`:
  * rows come from an in-memory list of dicts, or an HF `datasets` directory
    where that package is installed. A row has `text`/`lang` (or precomputed
    `phone_ids`/`tones`/`word_pos`/`syllable_pos`/`lang_ids` int lists), a
    precomputed `mel` (T, 80), and optional `spk_emb` (192) and `decoder_h`
    (T, 80), which default to zeros;
  * mel frames are trimmed to a multiple of token_mel_ratio;
  * the collator zero-pads text features to the batch max and mels to a
    factor-4 length (`fix_len_compatibility`), then rounds both up to the
    bucket tables, so a run meets a few shapes only.
Batches are dicts of numpy arrays, as in the JAX package; the trainer moves
them to its device.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from jyutvoice_tpu_torch.pipeline import buckets as bkt
from jyutvoice_tpu_torch.text import intersperse, text_to_sequence

_TEXT_KEYS = ("x", "tone", "word_pos", "syllable_pos", "lang")

_log = logging.getLogger(__name__)


def fix_len_compatibility(length: int, num_downsamplings_in_unet: int = 2) -> int:
    factor = 2**num_downsamplings_in_unet
    return int(np.ceil(length / factor) * factor)


@dataclasses.dataclass
class DataConfig:
    batch_size: int = 8
    add_blank: bool = True
    n_feats: int = 80
    token_mel_ratio: int = 2
    spk_embed_dim: int = 192
    seed: int = 42
    valid_ratio: float = 0.001
    bucket_text: bool = True  # round pads up to the bucket tables


def row_to_example(row: Dict, cfg: DataConfig, mel_fn=None) -> Optional[Dict]:
    """One dataset row -> numpy example dict, or None if it is unusable.

    A row's columns may be present with a None value (HF `load_from_disk`
    gives every row every column), so presence is judged on the value."""
    if row.get("phone_ids") is not None:
        ids = list(row["phone_ids"])

        def _ints(key):
            v = row.get(key)
            return list(v) if v is not None else [0] * len(ids)

        tones = _ints("tones")
        word_pos = _ints("word_pos")
        syllable_pos = _ints("syllable_pos")
        lang_ids = _ints("lang_ids")
    else:
        try:
            ids, tones, word_pos, syllable_pos, lang_ids = text_to_sequence(
                row["text"], lang=row.get("lang") or "yue", phone=row.get("phone"),
            )
        except (KeyError, ValueError) as e:
            _log.debug("skipping a row whose text does not convert: %s", e)
            return None

    if cfg.add_blank:
        ids, tones, word_pos, syllable_pos, lang_ids = (
            intersperse(s, 0) for s in (ids, tones, word_pos, syllable_pos, lang_ids)
        )

    if row.get("mel") is not None:
        mel = np.asarray(row["mel"], np.float32)  # (T, 80)
    elif row.get("audio") is not None and mel_fn is not None:
        wav = np.asarray(row["audio"], np.float32)[None, :]
        mel = np.asarray(mel_fn(wav))[0]
    else:
        return None

    spk_raw = row.get("spk_emb")
    spk = np.asarray(spk_raw if spk_raw is not None else np.zeros(cfg.spk_embed_dim), np.float32)
    dh = row.get("decoder_h")
    decoder_h = (
        np.asarray(dh, np.float32) if dh is not None
        else np.zeros((mel.shape[0], cfg.n_feats), np.float32)
    )

    # trim to a token_mel_ratio multiple, capped by the decoder_h length (the
    # cap compares mel frames / ratio with decoder_h frames, as the
    # reference does: a short decoder_h shortens mel to ratio * its frames)
    t = cfg.token_mel_ratio * min(mel.shape[0] // cfg.token_mel_ratio, decoder_h.shape[0])
    if t == 0:
        return None
    mel = mel[:t]
    decoder_h = decoder_h[:t]
    if decoder_h.shape[0] < t:
        decoder_h = np.pad(decoder_h, ((0, t - decoder_h.shape[0]), (0, 0)))

    # over-long rows are skipped like other unusable rows: collate would
    # find no bucket for them
    if len(ids) > bkt.TEXT_BUCKETS[-1] or t > bkt.MEL_BUCKETS[-1]:
        _log.warning("skipping an over-long row: text %d tokens / mel %d frames exceed "
                     "the largest buckets (%d / %d)", len(ids), t,
                     bkt.TEXT_BUCKETS[-1], bkt.MEL_BUCKETS[-1])
        return None

    return {
        "x": np.asarray(ids, np.int32),
        "tone": np.asarray(tones, np.int32),
        "word_pos": np.asarray(word_pos, np.int32),
        "syllable_pos": np.asarray(syllable_pos, np.int32),
        "lang": np.asarray(lang_ids, np.int32),
        "mel": mel,
        "spk_emb": spk,
        "decoder_h": decoder_h,
    }


def collate(examples: Sequence[Dict], cfg: DataConfig) -> Dict[str, np.ndarray]:
    """Zero-pad a list of examples into one batch."""
    b = len(examples)
    x_max = max(e["x"].shape[0] for e in examples)
    y_max = fix_len_compatibility(max(e["mel"].shape[0] for e in examples))
    if cfg.bucket_text:
        x_max = bkt.pick_bucket(x_max, bkt.TEXT_BUCKETS)
        y_max = bkt.pick_bucket(y_max, bkt.MEL_BUCKETS)

    batch = {k: np.zeros((b, x_max), np.int32) for k in _TEXT_KEYS}
    batch["y"] = np.zeros((b, y_max, cfg.n_feats), np.float32)
    batch["decoder_h"] = np.zeros((b, y_max, cfg.n_feats), np.float32)
    batch["spk_embed"] = np.zeros((b, cfg.spk_embed_dim), np.float32)
    batch["x_lengths"] = np.zeros((b,), np.int32)
    batch["y_lengths"] = np.zeros((b,), np.int32)

    for i, e in enumerate(examples):
        n = e["x"].shape[0]
        t = e["mel"].shape[0]
        for k in _TEXT_KEYS:
            batch[k][i, :n] = e[k]
        batch["y"][i, :t] = e["mel"]
        batch["decoder_h"][i, :t] = e["decoder_h"]
        batch["spk_embed"][i] = e["spk_emb"]
        batch["x_lengths"][i] = n
        batch["y_lengths"][i] = t
    return batch


class TextMelDataModule:
    """Rows (a list of dicts, or an HF dataset directory) -> batch iterators.

    The split is a seeded permutation: the first valid_ratio of the rows
    (at least one, when there are two or more) validate. Training batches
    follow a shuffle seeded by seed + epoch, so an epoch's order is fixed."""

    def __init__(self, source, cfg: DataConfig, mel_fn=None):
        self.cfg = cfg
        self.mel_fn = mel_fn
        if isinstance(source, str):
            try:
                import datasets
            except ImportError as e:
                raise RuntimeError(
                    f"reading the dataset directory {source!r} needs the `datasets` "
                    "package, which is not installed; pass in-memory rows instead"
                ) from e
            ds = datasets.load_from_disk(source)
            if hasattr(ds, "keys") and "train" in ds:
                ds = ds["train"]
            self.rows = ds
        else:
            self.rows = list(source)
        n = len(self.rows)
        perm = np.random.default_rng(cfg.seed).permutation(n)
        n_valid = max(1, int(n * cfg.valid_ratio)) if n > 1 else 0
        self.valid_idx = perm[:n_valid]
        self.train_idx = perm[n_valid:]

    def _iter(self, indices: np.ndarray, shuffle: bool, seed: int) -> Iterator[Dict]:
        order = indices.copy()
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        buf: List[Dict] = []
        for i in order:
            ex = row_to_example(self.rows[int(i)], self.cfg, self.mel_fn)
            if ex is None:
                continue
            buf.append(ex)
            if len(buf) == self.cfg.batch_size:
                yield collate(buf, self.cfg)
                buf = []
        if buf:
            yield collate(buf, self.cfg)

    def train_batches(self, epoch: int = 0) -> Iterator[Dict]:
        return self._iter(self.train_idx, True, self.cfg.seed + epoch)

    def valid_batches(self) -> Iterator[Dict]:
        return self._iter(self.valid_idx, False, 0)


def dummy_rows(
    n: int = 16,
    seed: int = 0,
    mel_frames: Tuple[int, int] = (48, 160),
    phones: Tuple[int, int] = (6, 20),
) -> List[Dict]:
    """Synthetic rows for smoke training: random phone features and random
    mels; mel_frames and phones bound each row's sizes (mels of 1400-2000
    frames land batches in the 2048 bucket, where the stock-flash gate
    fires)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        n_ph = int(rng.integers(phones[0], phones[1]))
        t = int(rng.integers(mel_frames[0] // 2, mel_frames[1] // 2)) * 2
        rows.append(
            {
                "phone_ids": rng.integers(1, 97, n_ph).tolist(),
                "tones": rng.integers(0, 7, n_ph).tolist(),
                "word_pos": rng.integers(0, 4, n_ph).tolist(),
                "syllable_pos": rng.integers(0, 4, n_ph).tolist(),
                "lang_ids": rng.integers(0, 3, n_ph).tolist(),
                "mel": rng.standard_normal((t, 80)).astype(np.float32),
            }
        )
    return rows
