"""Train-state checkpoints with verified resume, and the gathered export
— `hyperion_tpu/checkpoint/io.py` on one device, without orbax.

  * `save` / `restore`   — one `step_{N:08d}/` directory per save under
    a run's checkpoint root, holding `state.pt` (`torch.save`, loaded
    with `weights_only=True`), the writer's own commit marker
    `COMMITTED` and the integrity manifest (`checkpoint/integrity.py`,
    the reference's schema). `state.pt` holds everything the next step
    reads: every parameter as the state holds it (the fp32 masters
    under the bf16 policy; LoRA's frozen base too, as the reference's
    orbax tree holds it), the AdamW moments and counts, the update
    count and `state.step` (and, from a mid-epoch save, the interrupted
    epoch's per-step losses, for its CSV row). The learning-rate schedule is a function of
    the update count (`train/state.py`) and dropout reseeds from
    (seed, step) (`train/step.py`), so nothing else is needed for an
    exact resume: a run restored at step N trains step N bit for bit as
    the uninterrupted run did.
  * **async saves**      — `save(..., wait=False)` snapshots the state to
    host memory and returns; only the disk write runs on a background
    thread. The optimizer updates the parameters in place, so the
    snapshot must be taken before the next step's kernels write: the
    device-to-host copies are queued on the compute stream (into pinned
    host buffers, reused across saves), so stream order puts them ahead
    of every later kernel, and the writer waits on an event recorded
    after them before it reads the buffers. `wait_pending()` is the
    commit point: it joins the writer and only then writes the
    manifest. At most ONE save is in flight: a new `save` (and
    `restore`) finalizes the previous one first, and every trainer exit
    drains via `wait_pending`.
  * **commit marker**    — the writer stages into `.step_{N:08d}.tmp`
    (a name the `step_*` pattern never matches), renames it into place
    and writes `COMMITTED` last. A kill before the rename leaves no
    resume candidate; a kill after the rename but before the marker
    leaves a dir with neither marker nor manifest, which the walk-back
    quarantines as a partial save; a kill after the marker but before
    the manifest (an async save whose commit point never ran) leaves a
    finished save, which the walk-back adopts and backfills with a
    manifest, as the reference adopts an orbax save with its
    `_CHECKPOINT_METADATA`.
  * **verified resume**  — `restore` walks back from the newest step to
    the newest *verified* one, quarantining failures as
    `step_X.corrupt`.
  * **retry/backoff**    — checkpoint IO routes through
    `utils.retry.retry_call` (chaos seams `ckpt_save`, `ckpt_restore`).
  * `latest_step` + `prune(keep=2)` — health evidence snapshots live
    under a `health/` subdir, which the root-level scans never see.
  * `load_gathered` / `export_gathered` — the `.npz` interchange with
    the JAX package: `np.savez` of the param tree flattened with
    `/`-joined keys, which either package's `load_gathered` reads.
"""

from __future__ import annotations

import re
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from hyperion_tpu_torch.checkpoint import integrity
from hyperion_tpu_torch.obs import trace as obs_trace
from hyperion_tpu_torch.train.state import TrainState
from hyperion_tpu_torch.utils.retry import IO_RETRY, fault_point, retry_call

_STEP_DIR = re.compile(r"^step_(\d+)$")
STATE_FILE = "state.pt"
COMMIT_MARKER = "COMMITTED"

# The one in-flight async save: its writer thread, the step dir it
# commits and the manifest provenance captured at dispatch.
_PENDING: dict | None = None
# pinned host buffers by tree path, reused by every save (one is in
# flight at a time, so a new save's copies never race the last write)
_HOST_BUFFERS: dict[str, torch.Tensor] = {}


def wait_pending(tracer=None) -> Path | None:
    """Block until the in-flight async save (if any) has written, then
    write its manifest — the ONLY place a manifest follows an async
    dispatch, so "manifest present" means "the bytes all landed".
    Returns the committed path, or None when nothing was pending or
    the write failed (the dir is left unverified for the walk-back to
    arbitrate, exactly like a crash would). `overlap_s` on the
    `ckpt_commit` span is the wall time training ran while the write
    streamed."""
    global _PENDING
    if _PENDING is None:
        return None
    pend, _PENDING = _PENDING, None
    tr = tracer or obs_trace.null_tracer()
    with tr.span("ckpt_commit", step=pend["step"]) as sp:
        sp.set(overlap_s=round(time.perf_counter() - pend["t_dispatch"], 4))
        pend["thread"].join()
        err = pend["error"]
        if err:
            sp.set(error=type(err[0]).__name__)
            tr.event("ckpt_commit_failed", step=pend["step"],
                     error=repr(err[0]))
            print(f"[checkpoint] async save at step {pend['step']} failed "
                  f"to commit ({err[0]!r}); {pend['path'].name} stays "
                  "unverified")
            return None
        integrity.write_manifest(pend["path"], step=pend["step"],
                                 extra={"device": pend["device"]})
    return pend["path"]


def join_pending() -> None:
    """Block until the in-flight async save's write has finished, and
    leave its commit point to `wait_pending` (the chaos kill hook: the
    process dies with the save written but not manifested)."""
    if _PENDING is not None:
        _PENDING["thread"].join()


def release_host_buffers() -> None:
    """Drop the pinned snapshot buffers (a trainer's exit, after its
    last `wait_pending`): a 7B state's stay pinned otherwise."""
    _HOST_BUFFERS.clear()


def _step_path(root: str | Path, step: int) -> Path:
    return Path(root).absolute() / f"step_{step:08d}"


def _step_dirs(root: Path) -> list[tuple[int, Path]]:
    """(step, path) for every live step dir, ascending. `step_X.corrupt`
    quarantine dirs, staging dirs and the `health/` evidence subdir
    don't match."""
    root = Path(root).absolute()
    if not root.is_dir():
        return []
    return sorted(
        (int(m.group(1)), p)
        for p in root.iterdir()
        if (m := _STEP_DIR.match(p.name)) and p.is_dir()
    )


def state_tree(state: TrainState) -> dict:
    """What a checkpoint holds, as live tensors (no copy)."""
    opt = state.optimizer
    return {"step": int(state.step), "count": int(opt.count),
            "model": state.model.state_dict(),
            "adamw": opt.adamw.state_dict(),
            "epoch_losses": state.epoch_losses}


def _snapshot(tree, path: str = ""):
    """Host copy of every tensor in `tree` (dicts, lists, tuples of
    tensors and plain values). A card tensor is copied on the current
    stream into a pinned buffer (stream order makes it the state as of
    now, whatever later kernels write); a host tensor is cloned."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type != "cuda":
            return tree.detach().clone()
        buf = _HOST_BUFFERS.get(path)
        if buf is None or buf.shape != tree.shape or buf.dtype != tree.dtype:
            buf = torch.empty(tree.shape, dtype=tree.dtype, pin_memory=True)
            _HOST_BUFFERS[path] = buf
        buf.copy_(tree.detach(), non_blocking=True)
        return buf
    if isinstance(tree, dict):
        return {k: _snapshot(v, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v, f"{path}/{i}")
                          for i, v in enumerate(tree))
    return tree


def _write_step(path: Path, host_tree: dict, ready, force: bool) -> None:
    """Stage, rename into place, mark committed — one attempt. `ready`
    is the event the snapshot's copies complete on (None on the
    host)."""
    fault_point("ckpt_save")
    if ready is not None:
        ready.synchronize()
    if path.exists():
        if not force:
            raise ValueError(f"checkpoint {path} exists (force=False)")
        shutil.rmtree(path)
    tmp = path.with_name(f".{path.name}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    torch.save(host_tree, tmp / STATE_FILE)
    tmp.rename(path)
    (path / COMMIT_MARKER).write_text(f"{host_tree['step']}\n")


def save(root: str | Path, state: TrainState, force: bool = False,
         wait: bool = True, tracer=None) -> Path:
    """Write a checkpoint at the state's current step and commit it with
    a manifest. A dir without a manifest is, by definition, a save that
    never finished — restore's walk-back arbitrates it by the commit
    marker.

    `wait=False` returns once the host snapshot is queued: the write
    runs on a background thread and the manifest lands at the next
    `wait_pending()` (called here first, so one save is in flight at a
    time, and by every trainer exit path). The default `wait=True`
    writes, commits and returns."""
    global _PENDING
    wait_pending(tracer=tracer)  # at most one save in flight
    step = int(state.step)
    path = _step_path(root, step)
    tr = tracer or obs_trace.null_tracer()
    attempt = {"n": 0}

    with tr.span("ckpt_dispatch", step=step) as sp:
        sp.set(wait=wait)
        host_tree = _snapshot(state_tree(state))
        ready = None
        if next(state.model.parameters()).device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()

    def _write():
        # a retried attempt may land on the dir the failed one left
        # behind: overwrite there even when the caller didn't ask
        f = force or attempt["n"] > 0
        attempt["n"] += 1
        _write_step(path, host_tree, ready, f)

    def _write_retried():
        retry_call(_write, policy=IO_RETRY,
                   on_retry=lambda a, e, d: print(
                       f"[checkpoint] save attempt {a + 1} failed ({e}); "
                       f"retrying in {d:.2f}s"))

    if wait:
        _write_retried()
        with tr.span("ckpt_commit", step=step) as sp:
            sp.set(overlap_s=0.0)
            integrity.write_manifest(path, step=step, state=state)
        return path

    error: list[BaseException] = []

    def _background():
        try:
            _write_retried()
        except BaseException as e:  # noqa: BLE001 — reported at commit
            error.append(e)

    thread = threading.Thread(target=_background, name="hyperion-ckpt",
                              daemon=True)
    _PENDING = {"thread": thread, "error": error, "path": path,
                "step": step, "device": integrity.device_of(state),
                "t_dispatch": time.perf_counter()}
    thread.start()
    return path


def prune(root: str | Path, keep: int = 2) -> None:
    """Delete all but the newest `keep` step directories. Quarantined
    `*.corrupt` dirs are never touched, the `health/` subdir is
    invisible here, and the newest VERIFIED dir survives even when
    `keep` would doom it."""
    root = Path(root)
    dirs = _step_dirs(root)
    if not dirs:
        return
    # shallow verification (manifest + sizes): O(stat) per dir
    newest_verified = next(
        (step for step, p in reversed(dirs)
         if integrity.verify(p, deep=False)[0]),
        None,
    )
    doomed = dirs[:-keep] if keep else dirs
    for step, p in doomed:
        if step == newest_verified:
            continue
        shutil.rmtree(p, ignore_errors=True)


def latest_step(root: str | Path) -> int | None:
    steps = [step for step, _ in _step_dirs(Path(root))]
    return max(steps, default=None)


def _check_fits(saved: dict, live: dict, what: str) -> None:
    """Every key of `live` in `saved` at the same shape and dtype, and no
    other: checked before a single tensor is copied, so a checkpoint of
    another model leaves the template untouched."""
    if set(saved) != set(live):
        missing = sorted(set(live) - set(saved))[:3]
        extra = sorted(set(saved) - set(live))[:3]
        raise ValueError(f"{what} keys differ: missing {missing}, "
                         f"unexpected {extra}")
    for k, t in live.items():
        s = saved[k]
        if s.shape != t.shape or s.dtype != t.dtype:
            raise ValueError(f"{what} {k}: saved {tuple(s.shape)} "
                             f"{s.dtype}, live {tuple(t.shape)} {t.dtype}")


def _restore_step(path: Path, template: TrainState) -> TrainState:
    def _read():
        fault_point("ckpt_restore")
        return torch.load(path / STATE_FILE, map_location="cpu",
                          weights_only=True, mmap=True)

    blob = retry_call(_read, policy=IO_RETRY,
                      on_retry=lambda a, e, d: print(
                          f"[checkpoint] restore attempt {a + 1} failed "
                          f"({e}); retrying in {d:.2f}s"))
    _check_fits(blob["model"], template.model.state_dict(), "model")
    opt = template.optimizer
    if len(blob["adamw"]["state"]) > len(opt.params):
        raise ValueError("optimizer state for more parameters than the "
                         "template trains")
    template.model.load_state_dict(blob["model"])
    opt.adamw.load_state_dict(blob["adamw"])
    opt.count = int(blob["count"])
    template.step = int(blob["step"])
    template.epoch_losses = blob.get("epoch_losses")
    return template


def restore(root: str | Path, template: TrainState, step: int | None = None,
            tracer=None) -> TrainState | None:
    """Restore the newest VERIFIED step into `template` (a freshly
    initialized state, filled in place and returned).

    Walk-back: steps are tried newest-first; a dir that fails
    verification (partial save, bit rot, chaos) or errors mid-restore
    is quarantined as `step_X.corrupt` with a reason file and a
    `checkpoint_quarantined` trace event, and the walk continues to the
    prior step. Returns None when nothing restorable remains (fresh
    run). An explicit `step` is verified and restored with no fallback
    — the caller asked for those exact bytes, so failure raises."""
    wait_pending(tracer=tracer)
    tr = tracer or obs_trace.null_tracer()
    root = Path(root)

    def committed(path: Path, reason: str) -> bool:
        # a finished save whose manifest never landed (the async commit
        # point did not run): the writer's marker arbitrates
        return (reason.startswith("missing manifest")
                and (path / COMMIT_MARKER).exists())

    if step is not None:
        path = _step_path(root, step)
        ok, reason = integrity.verify(path)
        if not (ok or committed(path, reason)):
            raise ValueError(f"checkpoint step {step} at {path} failed "
                             f"verification: {reason}")
        with tr.span("ckpt_restore", step=step):
            return _restore_step(path, template)
    for step, path in reversed(_step_dirs(root)):
        ok, reason = integrity.verify(path)
        adopt = committed(path, reason)
        if ok or adopt:
            try:
                with tr.span("ckpt_restore", step=step):
                    restored = _restore_step(path, template)
            except Exception as e:  # noqa: BLE001 — quarantine + walk on
                reason = (f"{reason}; restore failed: {e!r}" if not ok
                          else f"verified but restore failed: {e!r}")
            else:
                if adopt:
                    print(f"[checkpoint] adopted {path.name} (no manifest, "
                          "commit marker present); backfilling a manifest")
                    integrity.write_manifest(path, step=step, state=restored)
                return restored
        elif reason.startswith("missing manifest"):
            reason += " and no commit marker — partial save"
        integrity.quarantine(path, reason, tracer=tracer)
    return None


def load_gathered(path: str | Path) -> dict:
    """Read an exported `.npz` into a nested param dict."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def export_gathered(path: str | Path, params: dict) -> Path:
    """Write a nested dict of arrays as one `.npz` with `/`-joined
    keys."""
    flat: dict[str, np.ndarray] = {}

    def walk(node: dict, prefix: str) -> None:
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = np.asarray(v)

    walk(params, "")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)
    return path
