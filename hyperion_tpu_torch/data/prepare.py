"""Dataset preparation CLI — `hyperion_tpu/data/prepare.py`.

WikiText-2 raw text → drop empty lines → byte-level BPE with pad = eos
→ truncate or right-pad to 128 tokens with attention masks → native
recordio (`data/recordio.py`) → reload-verify; or, with `--cifar`, the
CIFAR-10 source (pickle batches, else the synthetic split) → recordio →
reload-verify. The files are byte-identical to the JAX package's for
the same tokenizer and source.

Usage:
  python -m hyperion_tpu_torch.data.prepare --raw-dir data/wikitext2_raw
  python -m hyperion_tpu_torch.data.prepare --input corpus.txt --split-name train
  python -m hyperion_tpu_torch.data.prepare --cifar [--base-dir DIR]

Raw layout: `{raw_dir}/wiki.{train,valid,test}.tokens` or one text file
via `--input`. The tokenizer is loaded from `--tokenizer-dir` when it
holds vocab.json/merges.txt (GPT-2-format files work as-is), else
trained on the train split and saved there. Output:
`{base}/wikitext2_tokenized/{split}.ids.rio` + `{split}.mask.rio` and
`prepare_meta.json`, which `data/text.py` `load_wikitext2` reads first;
`{base}/cifar10_prepared/{split}.{images,labels}.rio`, which
`data/vision.py` `load_cifar10` reads first.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from hyperion_tpu_torch.data.bpe import ByteBPE, train_bpe
from hyperion_tpu_torch.data.recordio import write_records
from hyperion_tpu_torch.data.text import DEFAULT_SEQ_LEN, TextSplit

_WIKITEXT_SPLITS = {"train": "wiki.train.tokens",
                    "validation": "wiki.valid.tokens",
                    "test": "wiki.test.tokens"}


def filter_nonempty(lines) -> list[str]:
    """The reference's empty-line filter (cell 3: `filter_nonempty`)."""
    return [ln for ln in lines if ln.strip()]


def encode_split(
    tok: ByteBPE, lines: list[str], seq_len: int = DEFAULT_SEQ_LEN
) -> TextSplit:
    """Encode, truncate to seq_len, right-pad with eos, build masks —
    the reference's `tokenize_function` semantics (truncation=True,
    padding='max_length', pad = eos)."""
    n = len(lines)
    ids = np.full((n, seq_len), tok.eos_id, np.int32)
    mask = np.zeros((n, seq_len), np.int8)
    for i, line in enumerate(lines):
        enc = tok.encode(line)[:seq_len]
        ids[i, : len(enc)] = enc
        mask[i, : len(enc)] = 1
    return TextSplit(ids, mask, source="prepared")


def write_split(split: TextSplit, out_dir: Path, name: str) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    write_records(out_dir / f"{name}.ids.rio", split.input_ids)
    write_records(out_dir / f"{name}.mask.rio", split.attention_mask)


def prepare(
    raw_splits: dict[str, list[str]],
    base_dir: str | Path = "data",
    seq_len: int = DEFAULT_SEQ_LEN,
    tokenizer_dir: str | Path | None = None,
    vocab_size: int = 8192,
    verbose: bool = True,
) -> dict[str, TextSplit]:
    """Full pipeline over already-read raw lines, returning the encoded
    splits after a reload-verify pass."""
    base = Path(base_dir)
    tok_dir = Path(tokenizer_dir or base / "tokenizer")

    filtered = {k: filter_nonempty(v) for k, v in raw_splits.items()}
    if verbose:
        for k, v in filtered.items():
            print(f"[prepare] {k}: {len(raw_splits[k])} lines -> "
                  f"{len(v)} non-empty")

    if (tok_dir / "vocab.json").exists() and (tok_dir / "merges.txt").exists():
        tok = ByteBPE.load(tok_dir)
        if verbose:
            print(f"[prepare] loaded tokenizer from {tok_dir} "
                  f"(vocab {tok.vocab_size})")
    else:
        # train on the train split if it has content, else the first
        # non-empty split — never on an empty list (a base-vocab-only
        # tokenizer would be saved and silently poison later runs)
        train_lines = filtered.get("train") or next(
            (v for v in filtered.values() if v), None
        )
        if not train_lines:
            raise ValueError(
                "no non-empty lines in any split to train the tokenizer on"
            )
        tok = train_bpe(train_lines, vocab_size=vocab_size, verbose=verbose)
        tok.save(tok_dir)
        if verbose:
            print(f"[prepare] trained BPE on {len(train_lines)} lines "
                  f"(vocab {tok.vocab_size}) -> {tok_dir}")

    out_dir = base / "wikitext2_tokenized"
    out: dict[str, TextSplit] = {}
    for name, lines in filtered.items():
        split = encode_split(tok, lines, seq_len)
        write_split(split, out_dir, name)
        out[name] = split
        if verbose:
            real = int(split.attention_mask.sum())
            print(f"[prepare] {name}: [{len(split)}, {seq_len}] "
                  f"({real} real tokens) -> {out_dir}/{name}.*.rio")

    (out_dir / "prepare_meta.json").write_text(json.dumps({
        "seq_len": seq_len,
        "vocab_size": tok.vocab_size,
        "eos_id": tok.eos_id,
        "tokenizer_dir": str(tok_dir),
        "splits": {k: len(v) for k, v in out.items()},
    }, indent=2))

    # reload-verify, as the reference does post-save (cell 3:52-61)
    from hyperion_tpu_torch.data.text import load_wikitext2

    reloaded = load_wikitext2(base, splits=tuple(out), seq_len=seq_len)
    for name, split in out.items():
        r = reloaded[name]
        assert r.source.startswith("recordio"), r.source
        np.testing.assert_array_equal(r.input_ids, split.input_ids)
        np.testing.assert_array_equal(r.attention_mask, split.attention_mask)
    if verbose:
        print(f"[prepare] reload-verify OK ({', '.join(out)})")
    return out


def prepare_cifar(base_dir: str | Path = "data", verbose: bool = True) -> None:
    """C19's vision pipeline as a command: read CIFAR-10 pickle batches
    (or the synthetic fallback), normalize + validity-filter, serialize
    to native recordio, reload-verify."""
    from hyperion_tpu_torch.data.vision import (
        load_cifar10_source, load_recordio_splits, save_recordio,
    )

    base = Path(base_dir)
    # read the SOURCE (pickles or synthetic), never prior prepared
    # output — fresh pickles must always win over stale recordio
    splits = load_cifar10_source(base)
    out = base / "cifar10_prepared"
    save_recordio(splits, out)
    reloaded = load_recordio_splits(out)
    for name, s in splits.items():
        r = reloaded[name]
        np.testing.assert_array_equal(r.images, s.images)
        np.testing.assert_array_equal(r.labels, s.labels)
        r.verify()
        if verbose:
            print(f"[prepare] cifar {name}: {len(s)} images "
                  f"(src {s.source}) -> {out}/{name}.*.rio")
    if verbose:
        print(f"[prepare] cifar reload-verify OK ({', '.join(splits)})")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--raw-dir", default=None,
                   help="directory with wiki.{train,valid,test}.tokens")
    p.add_argument("--input", default=None, help="single raw text file")
    p.add_argument("--split-name", default="train",
                   help="split name for --input")
    p.add_argument("--cifar", action="store_true",
                   help="prepare the CIFAR-10 pipeline instead of text")
    p.add_argument("--base-dir", default="data")
    p.add_argument("--seq-len", type=int, default=DEFAULT_SEQ_LEN)
    p.add_argument("--tokenizer-dir", default=None,
                   help="load (GPT-2-format) or save the tokenizer here "
                        "(default {base}/tokenizer)")
    p.add_argument("--vocab-size", type=int, default=8192)
    args = p.parse_args(argv)

    if args.cifar:
        prepare_cifar(args.base_dir)
        return

    raw: dict[str, list[str]] = {}
    if args.raw_dir:
        for split, fname in _WIKITEXT_SPLITS.items():
            f = Path(args.raw_dir) / fname
            if f.exists():
                raw[split] = f.read_text(encoding="utf-8").splitlines()
    if args.input:
        raw[args.split_name] = Path(args.input).read_text(
            encoding="utf-8").splitlines()
    if not raw:
        raise SystemExit("nothing to prepare: pass --raw-dir, --input, "
                         "or --cifar")
    if all(not filter_nonempty(v) for v in raw.values()):
        raise SystemExit(
            "every input split is empty after dropping blank lines — "
            "check the --raw-dir/--input paths"
        )

    prepare(raw, args.base_dir, args.seq_len, args.tokenizer_dir,
            args.vocab_size)


if __name__ == "__main__":
    main()
