"""Build and load the port's CUDA kernels.

Each source in `ops/csrc/*.cu` has a plain C interface and becomes its
own shared library, compiled by `nvcc` for Hopper (`sm_90a`) on first
use and loaded with `ctypes`. Every source's `nvcc` starts at once, so
a build costs the slowest file, not the sum. Libraries land in
`build/hyperion_tpu_torch/<hash>/` at the root of the checkout (listed
in `.gitignore`), keyed by a hash of every source and the flags, so an
edited kernel rebuilds and an unchanged one loads in milliseconds.
`set_cache_dir` moves that root (`train --compile-cache DIR`, else the
`HYPERION_COMPILE_CACHE` variable: `resolve_cache_dir`), so that
supervised restarts and other checkouts of the same sources load the
libraries instead of building them.

Nothing here runs at import. A missing `nvcc` or a failed build
raises: there is no plain fallback for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "hyperion_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")
# the library cache's variable, as the reference's persistent compile
# cache (`hyperion_tpu/cli/main.py` COMPILE_CACHE_ENV)
COMPILE_CACHE_ENV = "HYPERION_COMPILE_CACHE"

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_cache_dir: Path | None = None        # set_cache_dir's root, else BUILD_ROOT
build_seconds: float | None = None   # wall time of the last build


def resolve_cache_dir(cache_dir: str | None) -> Path | None:
    """The library cache a run asked for: `cache_dir` (the flag), else
    the HYPERION_COMPILE_CACHE variable, else None (BUILD_ROOT)."""
    cache_dir = cache_dir or os.environ.get(COMPILE_CACHE_ENV, "")
    return Path(cache_dir).absolute() if cache_dir else None


def set_cache_dir(cache_dir: Path | None) -> None:
    """Build into and load from `cache_dir/<hash>/` (None: BUILD_ROOT),
    in this process only: the environment is left as it is."""
    global _cache_dir
    _cache_dir = cache_dir


def build_root() -> Path:
    return BUILD_ROOT if _cache_dir is None else _cache_dir


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME or "
        "/usr/local/cuda): the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every source that has no library yet, in parallel; return
    {source stem: library path}. Raises on any failed compile, with the
    compiler's output."""
    global build_seconds
    sources = _sources()
    out_dir = build_root() / _digest(sources)
    libs = {s.stem: out_dir / f"lib{s.stem}.so" for s in sources}
    todo = [s for s in sources if not libs[s.stem].exists()]
    if not todo:
        return libs
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = out_dir / f"lib{src.stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, libs[src.stem])  # atomic against a racing build
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return libs


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<stem>.cu`, building first if
    needed."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            paths = build_all()
            if stem not in paths:
                raise RuntimeError(f"no CUDA source csrc/{stem}.cu")
            lib = ctypes.CDLL(str(paths[stem]))
            _libs[stem] = lib
        return lib


def function(stem: str, name: str, argtypes: list, restype=ctypes.c_int):
    """C entry point `name` of `csrc/<stem>.cu`, its signature set once:
    after the first call a launch pays one dict lookup, not the build
    lock and the ctypes set-up."""
    fn = _fns.get((stem, name))
    if fn is None:
        fn = getattr(load(stem), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _fns[(stem, name)] = fn
    return fn


def check(status: int, what: str) -> None:
    """Raise on a non-zero `cudaError_t` returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: cudaError_t {status}")
