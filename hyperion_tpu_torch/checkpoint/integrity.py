"""Checkpoint integrity: manifests, verification, quarantine —
`hyperion_tpu/checkpoint/integrity.py`, with the same `manifest.json`.

The failure this kills: a crash *during* a save leaves a partial
`step_*` dir, `latest_step` happily picks it, and every future resume
bricks on the same unreadable checkpoint. The fix is a commit marker
with teeth:

  * `write_manifest`  — after a save commits, `manifest.json` goes into
    the step dir: file list with sizes + sha256 checksums, the step,
    the device the state was saved from and the kernels' revision.
  * `verify`          — a dir is *verified* iff its manifest parses and
    every listed file exists with the recorded size (and, in `deep`
    mode, the recorded checksum). No manifest = the save never
    committed = not a checkpoint.
  * `quarantine`      — rename a failed dir to `step_X.corrupt` (never
    delete: the bytes are evidence) with a `QUARANTINE_REASON.txt` and
    a trace event, so `restore`'s walk-back skips it forever.

The manifest's schema is the reference's (`v` 1, `step`, `files` with
`path`/`bytes`/`sha256`, `mesh_shape`, `kernel_rev`, `written_at`), so
either package's `verify` passes the other's step dirs. `device` names
the card (or "cpu"); a single process's save has a null `mesh_shape`,
a sharded one (`checkpoint/io.py`) the mesh's axis sizes and its
`world`; `kernel_rev` is the hash that keys the CUDA build.

The module imports nothing heavy at import time: the restart
supervisor quarantines with it and never imports torch.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path

MANIFEST_NAME = "manifest.json"
REASON_NAME = "QUARANTINE_REASON.txt"
SCHEMA_VERSION = 1
CORRUPT_SUFFIX = ".corrupt"


def _sha256(path: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with path.open("rb") as f:
        while block := f.read(chunk):
            h.update(block)
    return h.hexdigest()


def device_of(state) -> str:
    """The device the state's tensors live on, by name: the card's
    (`torch.cuda.get_device_name`) or "cpu": the manifest's provenance
    beside the mesh's shape."""
    try:
        dev = next(state.model.parameters()).device
        if dev.type == "cuda":
            import torch

            return torch.cuda.get_device_name(dev)
        return dev.type
    except Exception:  # noqa: BLE001 — provenance is best-effort
        return "unknown"


def _kernel_rev() -> str | None:
    """The hand kernels' revision: the hash that keys their build
    (every CUDA source and the nvcc flags, `ops/build.py`)."""
    try:
        from hyperion_tpu_torch.ops import build

        return build._digest(build._sources())
    except Exception:  # noqa: BLE001
        return None


def write_manifest(step_dir: str | Path, step: int, state=None,
                   extra: dict | None = None) -> Path:
    """Write `manifest.json` for a COMMITTED step dir (call only after
    the save's files are written). Hashing reads back everything just
    written — for a test-scale checkpoint that is noise; for a 7B tree
    it is one extra sequential read per epoch save, the price of a
    resume that can prove its inputs."""
    step_dir = Path(step_dir)
    files = []
    for p in sorted(step_dir.rglob("*")):
        if not p.is_file() or p.name == MANIFEST_NAME:
            continue
        files.append({
            "path": p.relative_to(step_dir).as_posix(),
            "bytes": p.stat().st_size,
            "sha256": _sha256(p),
        })
    manifest = {
        "v": SCHEMA_VERSION,
        "step": int(step),
        "files": files,
        "mesh_shape": None,
        "device": device_of(state) if state is not None else None,
        "kernel_rev": _kernel_rev(),
        "written_at": time.time(),
        **(extra or {}),
    }
    # atomic: a reader (or a crash mid-write) must never see a torn
    # manifest — a partial manifest would quarantine a good checkpoint
    path = step_dir / MANIFEST_NAME
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(manifest, indent=1))
    os.replace(tmp, path)
    return path


def read_manifest(step_dir: str | Path) -> dict | None:
    try:
        m = json.loads((Path(step_dir) / MANIFEST_NAME).read_text())
    except (OSError, json.JSONDecodeError, ValueError):
        return None
    return m if isinstance(m, dict) else None


def verify(step_dir: str | Path, deep: bool = True) -> tuple[bool, str]:
    """(verified, reason). `deep=True` checks sha256s (restore-time:
    about to read the bytes anyway); `deep=False` checks existence +
    sizes only (prune-time protection: O(stat), not O(bytes))."""
    step_dir = Path(step_dir)
    if not step_dir.is_dir():
        return False, "not a directory"
    m = read_manifest(step_dir)
    if m is None:
        if (Path(step_dir) / MANIFEST_NAME).exists():
            return False, "unreadable manifest"
        return False, "missing manifest (save never committed)"
    files = m.get("files")
    if not isinstance(files, list):
        return False, "manifest has no file list"
    for entry in files:
        rel = entry.get("path", "")
        p = step_dir / rel
        if not p.is_file():
            return False, f"missing file {rel!r}"
        if p.stat().st_size != entry.get("bytes"):
            return False, (f"size mismatch on {rel!r}: "
                           f"{p.stat().st_size} != {entry.get('bytes')}")
        if deep and entry.get("sha256") and _sha256(p) != entry["sha256"]:
            return False, f"checksum mismatch on {rel!r}"
    return True, "ok"


def quarantine(step_dir: str | Path, reason: str, tracer=None,
               primary: bool = True) -> Path | None:
    """Rename a failed step dir to `step_X.corrupt` (suffixing `.N` on
    collision), drop a reason file inside, emit a trace event. Returns
    the quarantine path, or None when another process owns the rename
    (non-primary) or the dir vanished under us.

    `primary=False` (a non-primary process of a multi-process run) does
    nothing; the port runs one process, the primary."""
    step_dir = Path(step_dir)
    if not primary or not step_dir.exists():
        return None
    dest = step_dir.with_name(step_dir.name + CORRUPT_SUFFIX)
    n = 0
    while dest.exists():
        n += 1
        dest = step_dir.with_name(f"{step_dir.name}{CORRUPT_SUFFIX}.{n}")
    os.replace(step_dir, dest)
    try:
        (dest / REASON_NAME).write_text(
            f"quarantined at {time.strftime('%Y-%m-%dT%H:%M:%S%z')}\n"
            f"reason: {reason}\n"
        )
    except OSError:
        pass  # the rename already protects resume; the note is best-effort
    if tracer is not None:
        tracer.event("checkpoint_quarantined", path=str(dest), reason=reason)
    print(f"[checkpoint] quarantined {step_dir.name} -> {dest.name}: {reason}")
    return dest
