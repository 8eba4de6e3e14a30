"""The native recordio store — `hyperion_tpu/data/recordio.py`.

Fixed-size records in one file (`native/recordio.cpp`, a copy of the
JAX package's source, built by g++ on first use into the git-ignored
`native/_build/`), memory-mapped by C++, with batches assembled by one
native gather call. Records are raw C-order array rows; the dataset
schema (dtype, row shape) lives in a JSON sidecar `<path>.json`. The
files and sidecars are byte-identical to the JAX package's, so each
package reads what the other writes.
"""

from __future__ import annotations

import ctypes
import json
from pathlib import Path

import numpy as np

from hyperion_tpu_torch.native import build


class _Lib:
    _cdll: ctypes.CDLL | None = None

    @classmethod
    def get(cls) -> ctypes.CDLL:
        if cls._cdll is None:
            lib = build.load("recordio")
            lib.hyprec_write.restype = ctypes.c_int
            lib.hyprec_write.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64,
                ctypes.c_uint64,
            ]
            lib.hyprec_open.restype = ctypes.c_void_p
            lib.hyprec_open.argtypes = [ctypes.c_char_p]
            lib.hyprec_count.restype = ctypes.c_uint64
            lib.hyprec_count.argtypes = [ctypes.c_void_p]
            lib.hyprec_record_bytes.restype = ctypes.c_uint64
            lib.hyprec_record_bytes.argtypes = [ctypes.c_void_p]
            lib.hyprec_gather.restype = ctypes.c_int
            lib.hyprec_gather.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_uint64, ctypes.c_void_p,
            ]
            lib.hyprec_close.restype = None
            lib.hyprec_close.argtypes = [ctypes.c_void_p]
            cls._cdll = lib
        return cls._cdll


def write_records(path: str | Path, rows: np.ndarray) -> None:
    """Write a [N, ...] array as N fixed-size records + JSON sidecar."""
    rows = np.ascontiguousarray(rows)
    record_bytes = rows.dtype.itemsize * int(np.prod(rows.shape[1:],
                                                     dtype=int))
    rc = _Lib.get().hyprec_write(
        str(path).encode(), rows.ctypes.data_as(ctypes.c_void_p),
        rows.shape[0], record_bytes,
    )
    if rc != 0:
        raise OSError(f"recordio write failed ({rc}) for {path}")
    Path(f"{path}.json").write_text(json.dumps({
        "dtype": rows.dtype.name, "row_shape": list(rows.shape[1:]),
    }))


class RecordFile:
    """Memory-mapped reader; `gather(indices)` returns a [n, *row_shape]
    batch copied straight out of the mapping by native code."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        meta = json.loads(Path(f"{path}.json").read_text())
        self.dtype = np.dtype(meta["dtype"])
        self.row_shape = tuple(meta["row_shape"])
        self._lib = _Lib.get()
        self._handle = self._lib.hyprec_open(str(path).encode())
        if not self._handle:
            raise OSError(f"recordio open failed for {path}")
        expected = self.dtype.itemsize * int(np.prod(self.row_shape,
                                                     dtype=int))
        actual = self._lib.hyprec_record_bytes(self._handle)
        if actual != expected:
            self.close()
            raise OSError(
                f"{path}: sidecar says {expected} B/record, file has {actual}")

    def __len__(self) -> int:
        return int(self._lib.hyprec_count(self._handle))

    def gather(self, indices: np.ndarray) -> np.ndarray:
        idx = np.ascontiguousarray(indices, np.uint64)
        out = np.empty((idx.shape[0], *self.row_shape), self.dtype)
        rc = self._lib.hyprec_gather(
            self._handle,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            idx.shape[0],
            out.ctypes.data_as(ctypes.c_void_p),
        )
        if rc != 0:
            raise IndexError(f"recordio gather out of range (max {len(self)})")
        return out

    def read_all(self) -> np.ndarray:
        return self.gather(np.arange(len(self), dtype=np.uint64))

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.hyprec_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
