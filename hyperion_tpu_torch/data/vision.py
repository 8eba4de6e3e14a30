"""The CIFAR-10 pipeline — `hyperion_tpu/data/vision.py`, numpy only.

Images are NHWC float32, normalized as the reference's ToTensor +
Normalize((.5,)*3, (.5,)*3); labels int32. Sources, in `load_cifar10`'s
search order: `{base}/cifar10_prepared/` (native recordio, written by
`python -m hyperion_tpu_torch.data.prepare --cifar`), the standard
`{base}/cifar-10-batches-py/` pickle batches read with numpy, and a
deterministic class-structured synthetic split (`synthetic_cifar_split`,
bit-identical to the reference's for the same seed). The trainer
permutes a batch to NCHW once, on the device (`models/resnet.py`).
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path

import numpy as np

CIFAR_SHAPE = (32, 32, 3)  # NHWC
CIFAR_CLASSES = 10
_MEAN = 0.5
_STD = 0.5


@dataclasses.dataclass
class VisionSplit:
    images: np.ndarray  # float32 [N, 32, 32, 3], normalized
    labels: np.ndarray  # int32   [N]
    source: str = "synthetic"

    def __post_init__(self):
        self.images = np.ascontiguousarray(self.images, dtype=np.float32)
        self.labels = np.ascontiguousarray(self.labels, dtype=np.int32)
        assert self.images.shape[0] == self.labels.shape[0]

    def __len__(self) -> int:
        return self.images.shape[0]

    def arrays(self) -> dict[str, np.ndarray]:
        return {"images": self.images, "labels": self.labels}

    def verify(self) -> None:
        """Reload-verify, mirroring cell 5:54-57's shape check."""
        if len(self) == 0:
            raise ValueError("empty split")
        if self.images.shape[1:] != CIFAR_SHAPE:
            raise ValueError(f"bad image shape {self.images.shape[1:]}")
        if self.labels.min() < 0 or self.labels.max() >= CIFAR_CLASSES:
            raise ValueError("labels outside [0,10)")


def _normalize(u8_nchw: np.ndarray) -> np.ndarray:
    """uint8 [N,3,32,32] → normalized float32 NHWC, the reference's
    ToTensor + Normalize((.5,)*3, (.5,)*3) transform."""
    x = u8_nchw.astype(np.float32) / 255.0
    x = (x - _MEAN) / _STD
    return x.transpose(0, 2, 3, 1)


def filter_valid(raw_u8: np.ndarray, labels: np.ndarray):
    """Validity filter from the reference (cell 5:20-24): keep images with
    any nonzero pixel. Applied to the *raw uint8* data — the reference
    checks after Normalize, where a normalized pixel can never be exactly
    0 and the filter provably never fires (a bug not worth replicating)."""
    keep = raw_u8.reshape(len(raw_u8), -1).max(axis=1) > 0
    return raw_u8[keep], labels[keep]


def load_cifar_batches(data_dir: str | Path) -> dict[str, "VisionSplit"]:
    """Read the standard `cifar-10-batches-py` pickle files with NumPy."""
    d = Path(data_dir)
    train_imgs, train_labels = [], []
    for i in range(1, 6):
        with open(d / f"data_batch_{i}", "rb") as f:
            b = pickle.load(f, encoding="bytes")
        train_imgs.append(np.asarray(b[b"data"]).reshape(-1, 3, 32, 32))
        train_labels.append(np.asarray(b[b"labels"]))
    with open(d / "test_batch", "rb") as f:
        b = pickle.load(f, encoding="bytes")
    out = {}
    for name, (imgs, labels) in {
        "train": (np.concatenate(train_imgs), np.concatenate(train_labels)),
        "test": (np.asarray(b[b"data"]).reshape(-1, 3, 32, 32), np.asarray(b[b"labels"])),
    }.items():
        raw, y = filter_valid(imgs, labels.astype(np.int32))
        out[name] = VisionSplit(_normalize(raw), y, source=f"cifar:{d}")
    return out


def synthetic_cifar_split(n: int, seed: int = 0) -> VisionSplit:
    """Deterministic class-structured synthetic CIFAR: each class gets a
    distinct low-frequency template plus noise, so accuracy curves are
    meaningful (a model can actually learn the mapping)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32.0
    templates = np.stack(
        [
            np.stack(
                [
                    np.sin(2 * np.pi * ((c % 3 + 1) * xx + (c // 3) * yy + c / 10 + ch / 3))
                    for ch in range(3)
                ],
                axis=-1,
            )
            for c in range(CIFAR_CLASSES)
        ]
    )  # [10, 32, 32, 3]
    labels = rng.integers(0, CIFAR_CLASSES, size=n).astype(np.int32)
    images = templates[labels] * 0.5 + rng.normal(0, 0.3, size=(n, *CIFAR_SHAPE))
    return VisionSplit(np.clip(images, -1, 1).astype(np.float32), labels)


def save_recordio(splits: dict[str, VisionSplit], out_dir: str | Path) -> None:
    """Serialize splits as native recordio (the torch.save-tuple-list
    analogue, cell 5:40-48, on the framework's own store)."""
    from hyperion_tpu_torch.data.recordio import write_records

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for name, s in splits.items():
        write_records(out / f"{name}.images.rio", s.images)
        write_records(out / f"{name}.labels.rio", s.labels.reshape(-1, 1))


def load_recordio_splits(rec_dir: str | Path) -> dict[str, VisionSplit]:
    from hyperion_tpu_torch.data.recordio import RecordFile

    rec_dir = Path(rec_dir)
    out = {}
    for f in sorted(rec_dir.glob("*.images.rio")):
        name = f.name.removesuffix(".images.rio")
        with RecordFile(f) as imgs, \
             RecordFile(rec_dir / f"{name}.labels.rio") as labels:
            out[name] = VisionSplit(
                imgs.read_all(), labels.read_all().reshape(-1),
                source=f"recordio:{rec_dir / name}",
            )
    return out


def load_cifar10_source(
    base_dir: str | Path = "data",
    synthetic_sizes: dict[str, int] | None = None,
    seed: int = 0,
) -> dict[str, VisionSplit]:
    """The *source* data only — pickle batches if present, else
    synthetic. `prepare --cifar` must read this, never its own prior
    recordio output (or stale prepared data would shadow freshly
    downloaded pickles forever)."""
    d = Path(base_dir) / "cifar-10-batches-py"
    if d.is_dir() and (d / "data_batch_1").exists():
        out = load_cifar_batches(d)
    else:
        sizes = {"train": 5000, "test": 1000}
        if synthetic_sizes:
            sizes.update(synthetic_sizes)
        out = {
            name: synthetic_cifar_split(sz, seed=seed + i)
            for i, (name, sz) in enumerate(sizes.items())
        }
    for s in out.values():
        s.verify()
    return out


def load_cifar10(
    base_dir: str | Path = "data",
    synthetic_sizes: dict[str, int] | None = None,
    seed: int = 0,
) -> dict[str, VisionSplit]:
    """Load CIFAR-10. Search order: `{base}/cifar10_prepared` (native
    recordio, from `data.prepare --cifar`), `{base}/cifar-10-batches-py`
    (standard pickles), synthetic (default sizes 50000/10000 scaled
    down 10x)."""
    rec = Path(base_dir) / "cifar10_prepared"
    if rec.is_dir() and list(rec.glob("*.images.rio")):
        try:
            out = load_recordio_splits(rec)
            for s in out.values():
                s.verify()
            return out
        # OSError: missing/short files; ValueError covers a truncated
        # JSON sidecar (JSONDecodeError); KeyError a sidecar missing
        # fields — all mean "half-written prepare output, fall through"
        except (OSError, ValueError, KeyError) as e:
            print(f"[load_cifar10] recordio unreadable ({e}); falling back")
    return load_cifar10_source(base_dir, synthetic_sizes, seed)
