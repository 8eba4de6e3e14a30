"""Tokenized-text pipeline (WikiText-2-shaped) —
`hyperion_tpu/data/text.py:28-230`, numpy only.

Sources behind one interface, searched per split in the reference's
order under `{base}/wikitext2_tokenized/`:

  1. `{split}.ids.rio` — the native recordio pair `data.prepare` writes.
     Its reader is not ported (ROADMAP A7): when the files are present
     this raises rather than read another source in their place.
  2. `{split}/data-*.arrow` — an HF-datasets arrow split, read with
     pyarrow, imported lazily as the reference does. Without pyarrow
     this raises: a split that exists on disk is never replaced by
     synthetic data.
  3. `{split}.npz` — a token file (`input_ids`, `attention_mask`).
  4. synthetic — `synthetic_lm_split`, bit-identical to the reference's
     arrays for the same seed.

The reference's IO retry and chaos seams around each read
(`utils/retry.py`) are not ported (ROADMAP A7).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

GPT2_VOCAB_SIZE = 50257  # the LM's vocabulary (the GPT-2 tokenizer's)
GPT2_EOS_ID = 50256      # pad = eos
DEFAULT_SEQ_LEN = 128    # tokenization window


@dataclasses.dataclass
class TextSplit:
    """One split of a tokenized corpus: [N, seq] ids + mask."""

    input_ids: np.ndarray       # int32 [N, seq]
    attention_mask: np.ndarray  # int8  [N, seq]
    source: str = "synthetic"

    def __post_init__(self):
        if self.input_ids.shape != self.attention_mask.shape:
            raise ValueError(f"ids {self.input_ids.shape} and mask "
                             f"{self.attention_mask.shape} differ")
        self.input_ids = np.ascontiguousarray(self.input_ids, dtype=np.int32)
        self.attention_mask = np.ascontiguousarray(self.attention_mask,
                                                   dtype=np.int8)

    def __len__(self) -> int:
        return self.input_ids.shape[0]

    def arrays(self) -> dict[str, np.ndarray]:
        return {"input_ids": self.input_ids,
                "attention_mask": self.attention_mask}

    def verify(self, vocab_size: int = GPT2_VOCAB_SIZE) -> None:
        """Ids in range, a 0/1 mask, right padding."""
        if len(self) == 0:
            raise ValueError("empty split")
        if self.input_ids.min() < 0 or self.input_ids.max() >= vocab_size:
            raise ValueError(
                f"token ids outside [0,{vocab_size}): "
                f"[{self.input_ids.min()}, {self.input_ids.max()}]")
        if not np.isin(self.attention_mask, (0, 1)).all():
            raise ValueError("attention mask must be 0/1")
        if (np.diff(self.attention_mask.astype(np.int8), axis=1) > 0).any():
            raise ValueError("attention mask is not right-padded")


def load_arrow_split(split_dir: str | Path) -> TextSplit:
    """Read an HF-datasets arrow split directory (`data-*.arrow` stream
    files with `input_ids` / `attention_mask` list columns) with
    pyarrow's IPC reader, without the `datasets` library."""
    try:
        import pyarrow as pa
        import pyarrow.ipc as ipc
    except ImportError as e:
        raise ModuleNotFoundError(
            f"{split_dir} holds an arrow split, which needs pyarrow; the "
            "numpy reader of the arrow stream is ROADMAP A7. Point "
            "data_dir elsewhere to train on synthetic data.") from e

    split_dir = Path(split_dir)
    files = sorted(split_dir.glob("data-*.arrow"))
    if not files:
        raise FileNotFoundError(f"no data-*.arrow under {split_dir}")
    tables = []
    for f in files:
        with pa.memory_map(str(f)) as src:
            tables.append(ipc.open_stream(src).read_all())
    table = pa.concat_tables(tables)

    def column(name: str, dtype) -> np.ndarray:
        col = table[name].combine_chunks()
        lengths = np.diff(col.offsets.to_numpy())
        flat = col.flatten().to_numpy(zero_copy_only=False)
        if lengths.size and (lengths == lengths[0]).all():
            return flat.reshape(len(lengths), lengths[0]).astype(dtype)
        # ragged rows: row i fills its first lengths[i] columns, in the
        # row-major order `flat` concatenates them in
        width = int(lengths.max())
        out = np.zeros((len(lengths), width), dtype)
        out[np.arange(width)[None, :] < lengths[:, None]] = flat
        return out

    return TextSplit(column("input_ids", np.int32),
                     column("attention_mask", np.int8),
                     source=f"arrow:{split_dir}")


def synthetic_lm_split(n_examples: int, seq_len: int = DEFAULT_SEQ_LEN,
                       vocab_size: int = GPT2_VOCAB_SIZE, seed: int = 0,
                       eos_id: int = GPT2_EOS_ID) -> TextSplit:
    """Deterministic WikiText-shaped synthetic corpus: Zipf-like token
    ranks by inverse-CDF sampling, a random true length per example and
    eos right-padding. The draws are the reference's, in its order, so
    the arrays are bit-identical for the same arguments."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size, dtype=np.float64)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    cdf = probs.cumsum()
    cdf /= cdf[-1]
    ids = cdf.searchsorted(rng.random((n_examples, seq_len)),
                           side="right").astype(np.int32)
    lengths = rng.integers(seq_len // 4, seq_len + 1, size=n_examples)
    mask = np.arange(seq_len)[None, :] < lengths[:, None]
    ids = np.where(mask, ids, eos_id).astype(np.int32)
    return TextSplit(ids, mask.astype(np.int8), source="synthetic")


def load_token_file(path: str | Path) -> TextSplit:
    with np.load(path) as z:
        return TextSplit(z["input_ids"], z["attention_mask"],
                         source=f"npz:{path}")


def load_wikitext2(base_dir: str | Path = "data",
                   splits: tuple[str, ...] = ("train", "validation"),
                   synthetic_sizes: dict[str, int] | None = None,
                   seq_len: int = DEFAULT_SEQ_LEN,
                   seed: int = 0) -> dict[str, TextSplit]:
    """Load the tokenized corpus, preferring on-disk data and falling
    back per split to synthetic, in the reference's search order (see
    the module docstring). Synthetic sizes are the reference's (the
    post-filter split sizes scaled down 8x); `synthetic_sizes`
    overrides them. Split i of `splits` draws from seed + i."""
    base = Path(base_dir) / "wikitext2_tokenized"
    sizes = {"train": 4590, "validation": 470, "test": 545}
    if synthetic_sizes:
        sizes.update(synthetic_sizes)
    out: dict[str, TextSplit] = {}
    for i, split in enumerate(splits):
        arrow_dir = base / split
        npz = base / f"{split}.npz"
        if (base / f"{split}.ids.rio").exists():
            raise NotImplementedError(
                f"{base / split}.ids.rio is a recordio split; its reader "
                "is not ported yet (ROADMAP A7)")
        if arrow_dir.is_dir() and list(arrow_dir.glob("data-*.arrow")):
            s = load_arrow_split(arrow_dir)
        elif npz.exists():
            s = load_token_file(npz)
        else:
            s = synthetic_lm_split(sizes.get(split, 512), seq_len=seq_len,
                                   seed=seed + i)
        s.verify()
        out[split] = s
    return out
