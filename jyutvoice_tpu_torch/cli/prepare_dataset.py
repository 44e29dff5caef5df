"""Prepare a dataset for fine-tuning with the PyTorch port: the counterpart of
the JAX package's `cli/prepare_dataset.py` (the reference's
scripts/prepare_dataset{,2}.py and merge_dataset_shards.py).

  python -m jyutvoice_tpu_torch.cli.prepare_dataset --input raw --output prepared \\
      --flow-encoder pretrained_models_tpu/flow_encoder.npz \\
      --campplus-onnx campplus.onnx --tokenizer-torch s3.pt --device-batch 16

Per row: g2p to id lists, then the 24 kHz mel, the CAM++ speaker embedding
and, from the speech tokens, the flow encoder's hidden states (`decoder_h`,
the prior loss's target) through `pipeline/prompt.py::PromptExtractor` on
the GPU (--device cpu for the CPU). Rows carry `decoder_h` only when both a
tokenizer and a flow encoder are given; the datamodule trims `mel` to it.
--rank/--worlds shard the input (prepare_dataset2.py:429-458); --merge
concatenates shard outputs (merge_dataset_shards.py:14-65). A failed row is
marked `audio_processed=False` and filtered out instead of stopping the run
(reference prepare_dataset.py:305-371).

`process_row` and `process_batch` work on plain dicts (a row, or a batch of
columns); only `main` needs the `datasets` package.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from jyutvoice_tpu_torch.text import text_to_sequence

log = logging.getLogger("jyutvoice_tpu_torch.prepare")


def _capability_columns(extractor):
    """The optional output columns, decided by what the extractor can make
    (its tokenizer's model and its flow encoder), not by what a row made, so
    every row, failed ones included, has the same columns."""
    cap_tok = extractor.tokenizer.model is not None
    cap_h = cap_tok and extractor.flow_encoder is not None
    cols = ["phone_ids", "tones", "word_pos", "syllable_pos", "lang_ids", "mel", "spk_emb"]
    if cap_h:
        cols.append("decoder_h")
    if cap_tok:
        cols.append("speech_tokens")
    return cols, cap_tok, cap_h


def process_row(row, extractor, lang_default="yue"):
    """One row (a dict with text, lang, phone and audio {array,
    sampling_rate}) -> the row with its prepared columns."""
    out = dict(row)
    cols, cap_tok, cap_h = _capability_columns(extractor)
    # the failure defaults first: a failed row carries the same columns
    for c in cols:
        out[c] = []
    out["audio_processed"] = False
    try:
        ids, tones, word_pos, syllable_pos, lang_ids = text_to_sequence(
            row["text"], lang=row.get("lang", lang_default), phone=row.get("phone"))
        out.update(phone_ids=ids, tones=tones, word_pos=word_pos, syllable_pos=syllable_pos,
                   lang_ids=lang_ids)
        audio = np.asarray(row["audio"]["array"], np.float32)
        sr = int(row["audio"]["sampling_rate"])
        feats = extractor(audio, sr)
        out["mel"] = feats.prompt_feat.tolist()
        out["spk_emb"] = feats.spk_embed.tolist()
        if cap_h and feats.prompt_h is not None:
            out["decoder_h"] = feats.prompt_h.tolist()
        if cap_tok and feats.speech_tokens is not None:
            out["speech_tokens"] = feats.speech_tokens.tolist()
        out["audio_processed"] = True
    except Exception as e:  # noqa: BLE001 — the reference's row tolerance
        log.warning("row failed: %s", e)
    return out


def process_batch(rows, extractor, lang_default="yue"):
    """A batch of columns -> the same with the prepared columns: text per
    row, then ONE `PromptExtractor.extract_batch` call for the batch's audio
    (grouped by length bucket inside). A failed row gets
    `audio_processed=False` and empty lists in the prepared columns."""
    n = len(rows["text"])
    langs = rows.get("lang") or [lang_default] * n
    phones = rows.get("phone") or [None] * n
    out = {k: list(v) for k, v in rows.items()}
    ok = [True] * n
    text_feats = [None] * n
    audios, srs, audio_rows = [], [], []
    for i in range(n):
        try:
            text_feats[i] = text_to_sequence(rows["text"][i], lang=langs[i] or lang_default,
                                             phone=phones[i])
            audios.append(np.asarray(rows["audio"][i]["array"], np.float32))
            srs.append(int(rows["audio"][i]["sampling_rate"]))
            audio_rows.append(i)
        except Exception as e:  # noqa: BLE001 — the reference's row tolerance
            log.warning("row failed: %s", e)
            ok[i] = False

    feats = dict(zip(audio_rows, extractor.extract_batch(audios, srs))) if audio_rows else {}

    cols, cap_tok, cap_h = _capability_columns(extractor)
    for c in cols:
        out[c] = [[] for _ in range(n)]
    out["audio_processed"] = [False] * n
    for i in range(n):
        f = feats.get(i)
        if not ok[i] or f is None or isinstance(f, Exception):
            if isinstance(f, Exception):
                log.warning("row failed: %s", f)
            continue
        ids, tones, word_pos, syllable_pos, lang_ids = text_feats[i]
        out["phone_ids"][i] = ids
        out["tones"][i] = tones
        out["word_pos"][i] = word_pos
        out["syllable_pos"][i] = syllable_pos
        out["lang_ids"][i] = lang_ids
        out["mel"][i] = f.prompt_feat.tolist()
        out["spk_emb"][i] = f.spk_embed.tolist()
        if cap_h and f.prompt_h is not None:
            out["decoder_h"][i] = f.prompt_h.tolist()
        if cap_tok and f.speech_tokens is not None:
            out["speech_tokens"][i] = f.speech_tokens.tolist()
        out["audio_processed"][i] = True
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="prepare a JyutVoice dataset (PyTorch port)")
    parser.add_argument("--input", help="HF dataset dir / hub id")
    parser.add_argument("--output", required=True)
    parser.add_argument("--lang", default="yue")
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--worlds", type=int, default=1)
    parser.add_argument("--flow-encoder", default=None,
                        help="flow encoder (.npz tree, or the reference's flow.pt)")
    parser.add_argument("--campplus-onnx", default=None)
    parser.add_argument("--tokenizer-onnx", default=None)
    parser.add_argument("--tokenizer-torch", default=None,
                        help="speech_tokenizer_v2 torch checkpoint")
    parser.add_argument("--merge", nargs="*", default=None,
                        help="shard dirs to concatenate instead of preparing")
    parser.add_argument("--device-dsp", action="store_true",
                        help="with --device-batch: compute the kaldi fbank and whisper mel on "
                             "the device")
    parser.add_argument("--device-batch", type=int, default=0,
                        help="rows per extract_batch call (0 = one row at a time)")
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.merge is not None and not args.merge:
        parser.error("--merge requires at least one shard directory")
    if args.merge is None and args.input is None:
        parser.error("--input is required (or use --merge SHARD...)")

    try:
        import datasets
    except ImportError as e:
        raise RuntimeError("preparing a dataset needs the `datasets` package, which is not "
                           "installed; process_row / process_batch take plain dicts") from e

    if args.merge:
        merged = datasets.concatenate_datasets([datasets.load_from_disk(p) for p in args.merge])
        merged.save_to_disk(args.output)
        log.info("merged %d shards -> %s (%d rows)", len(args.merge), args.output, len(merged))
        return

    from jyutvoice_tpu_torch.config import JyutVoiceConfig
    from jyutvoice_tpu_torch.pipeline.prompt import PromptExtractor

    cfg = JyutVoiceConfig()
    fe_params = None
    if args.flow_encoder:
        from jyutvoice_tpu_torch.cli.infer import load_params

        fe_params = load_params(args.flow_encoder, "flow_encoder", cfg)
    extractor = PromptExtractor(
        flow_encoder_params=fe_params, flow_encoder_cfg=cfg.flow_encoder,
        campplus_onnx=args.campplus_onnx, tokenizer_onnx=args.tokenizer_onnx,
        tokenizer_torch=args.tokenizer_torch, device_dsp=args.device_dsp, device=args.device,
    )

    ds = (datasets.load_from_disk(args.input) if os.path.isdir(args.input)
          else datasets.load_dataset(args.input, split="train"))
    if args.worlds > 1:
        ds = ds.shard(num_shards=args.worlds, index=args.rank)
        log.info("shard %d/%d: %d rows", args.rank, args.worlds, len(ds))
    if args.device_batch > 1:
        ds = ds.map(lambda rows: process_batch(rows, extractor, args.lang), batched=True,
                    batch_size=args.device_batch)
    else:
        ds = ds.map(lambda row: process_row(row, extractor, args.lang))
    ds = ds.filter(lambda row: row["audio_processed"])
    ds.save_to_disk(args.output)
    log.info("wrote %s (%d rows)", args.output, len(ds))


if __name__ == "__main__":
    main()
