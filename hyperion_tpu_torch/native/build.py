"""Build on first use for the port's native (C++) components —
`hyperion_tpu/native/build.py`.

The components are plain C-ABI shared objects compiled with g++ and
loaded with `ctypes`. A build lands in this package's own `_build/`
(listed in `.gitignore`), named by a hash of its source, so an edited
source rebuilds and an unchanged one loads at once. Concurrent first
uses (test workers, ranks of one job) each compile into a private
temporary name and rename it into place, so no process ever loads a
half-written object.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR / "_build"
_CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-Wall"]


class NativeBuildError(RuntimeError):
    pass


def _source_hash(src: Path) -> str:
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    h.update(src.read_bytes())
    return h.hexdigest()[:16]


def shared_object(name: str) -> Path:
    """Compile `<name>.cpp` into `_build/<name>-<hash>.so` unless it is
    there; return its path."""
    src = _DIR / f"{name}.cpp"
    if not src.exists():
        raise NativeBuildError(f"no such native source: {src}")
    out = BUILD_DIR / f"{name}-{_source_hash(src)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *_CXX_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"g++ failed for {src.name}:\n{proc.stderr[-2000:]}")
    os.replace(tmp, out)
    for old in BUILD_DIR.glob(f"{name}-*.so"):  # stale builds of the unit
        if old != out:
            old.unlink(missing_ok=True)
    return out


def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(shared_object(name)))
