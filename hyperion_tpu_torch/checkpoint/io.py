"""Train-state checkpoints with verified resume, and the gathered export
— `hyperion_tpu/checkpoint/io.py`, without orbax.

  * `save` / `restore`   — one `step_{N:08d}/` directory per save under
    a run's checkpoint root, holding one `shard-<rank>-of-<world>.pt`
    per rank (`torch.save`, loaded with `weights_only=True`; one file in
    a single process), the commit marker `COMMITTED` and the integrity
    manifest (`checkpoint/integrity.py`, the reference's schema). The
    shards hold everything the next step
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
  * **commit marker**    — the writers stage into `.step_{N:08d}.tmp`
    (a name the `step_*` pattern never matches); the dir is renamed into
    place and `COMMITTED` written last, by the writer itself in a single
    process, by the primary at the commit point under several ranks
    (below). A kill before the rename leaves no
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
  * **sharded saves**     — the shards are the SHARDED_STATE_DICT the JAX
    package writes through orbax: each rank writes the local shard of
    every parameter and AdamW moment (FSDP2's and tensor parallelism's
    DTensors, or plain tensors) with its global shape and offset (a
    replicated tensor is written by the rank at coordinate 0 of its
    replicated axes, once), plus the update count and step. The primary
    prepares the staging dir, every rank writes (in the background
    under `wait=False`), and at the commit point every rank reports its
    write (`any_rank`), meets at a host barrier, and the primary renames
    the dir into place (under several ranks), writes `COMMITTED` and the
    manifest (with the mesh's shape), before a last barrier. `restore`
    reshards: each rank assembles its own shard of every tensor from
    the saved pieces that overlap it, so a save at one world size or
    layout restores at another (the JAX docstring's promise,
    `hyperion_tpu/checkpoint/io.py:13-14`). Under several ranks the
    primary walks back and quarantines, and every rank restores the
    step it chose.
  * `load_gathered` / `export_gathered` — the `.npz` interchange with
    the JAX package: `np.savez` of the param tree flattened with
    `/`-joined keys, which either package's `load_gathered` reads. A
    sharded model is gathered first on every rank (`gathered_state`);
    only the primary writes.
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
from hyperion_tpu_torch.runtime import dist
from hyperion_tpu_torch.train.state import TrainState
from hyperion_tpu_torch.utils.retry import IO_RETRY, fault_point, retry_call

_STEP_DIR = re.compile(r"^step_(\d+)$")
SHARD_FILE = "shard-{rank:05d}-of-{world:05d}.pt"
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
        if pend["error"]:
            sp.set(error=type(pend["error"][0]).__name__)
        return _commit(pend, tr)


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


def _mesh_shape() -> dict | None:
    from hyperion_tpu_torch.runtime.mesh import active_mesh, axis_sizes

    mesh = active_mesh()
    return None if mesh is None else axis_sizes(mesh)


def _placement(t) -> tuple[tuple, tuple, torch.Tensor, bool]:
    """(global shape, global offset, local tensor, written here) of a
    DTensor or a plain (replicated) tensor."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset,
        )

        _, offset = compute_local_shape_and_global_offset(
            t.shape, t.device_mesh, t.placements)
        coord = t.device_mesh.get_coordinate()
        owner = all(c == 0 for c, pl in zip(coord, t.placements)
                    if not pl.is_shard())
        return tuple(t.shape), tuple(offset), t._local_tensor, owner
    return tuple(t.shape), (0,) * t.dim(), t, dist.is_primary()


def _named_entries(state: TrainState) -> dict[str, torch.Tensor]:
    """Every tensor a checkpoint holds, by stable name: `model/<name>`
    for the state dict, `adamw/<param name>/<key>` for the moments and
    step of each trained parameter."""
    model, opt = state.model, state.optimizer
    out = {f"model/{k}": v for k, v in model.state_dict().items()}
    names = {id(p): n for n, p in model.named_parameters()}
    for p in opt.params:
        for k, v in opt.adamw.state.get(p, {}).items():
            out[f"adamw/{names[id(p)]}/{k}"] = v
    return out


def _shard_tree(state: TrainState) -> dict:
    """What this rank's shard file holds, as live tensors (no copy)."""
    entries = {}
    for key, t in _named_entries(state).items():
        shape, offset, loc, owner = _placement(t)
        if owner and loc.numel():
            entries[key] = {"shape": shape, "offset": offset,
                            "dtype": str(t.dtype), "data": loc.detach()}
    return {"step": int(state.step), "count": int(state.optimizer.count),
            "epoch_losses": state.epoch_losses,
            "epoch_counts": state.epoch_counts, "entries": entries,
            "world": dist.process_count()}


def _write_shard(tmp: Path, host_tree: dict, ready) -> Path:
    """Write this rank's shard into the staging dir `tmp`, once the
    snapshot's copies have landed (`ready`: their event, None on the
    host)."""
    if ready is not None:
        ready.synchronize()
    tmp.mkdir(parents=True, exist_ok=True)
    out = tmp / SHARD_FILE.format(rank=dist.process_index(),
                                  world=dist.process_count())
    torch.save(host_tree, out)
    return out


def _publish(tmp: Path, path: Path, step: int) -> None:
    """Rename the staging dir into place and mark it committed."""
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)
    (path / COMMIT_MARKER).write_text(f"{step}\n")


def save(root: str | Path, state: TrainState, force: bool = False,
         wait: bool = True, tracer=None) -> Path:
    """Write a checkpoint at the state's current step and commit it with
    a manifest (every rank calls it). A dir without a manifest is, by
    definition, a save that never finished — restore's walk-back
    arbitrates it by the commit marker.

    `wait=False` returns once the host snapshot is queued: the write
    runs on a background thread and the manifest lands at the next
    `wait_pending()` (called here first, so one save is in flight at a
    time, and by every trainer exit path). A single process's writer
    renames and marks its own save, so a kill after the write leaves a
    save the walk-back adopts; under several ranks the rename waits for
    every rank's write, at the commit point. The default `wait=True`
    writes, commits and returns."""
    global _PENDING
    wait_pending(tracer=tracer)  # at most one save in flight
    step = int(state.step)
    path = _step_path(root, step)
    tmp = path.with_name(f".{path.name}.tmp")
    rank, world = dist.process_index(), dist.process_count()
    tr = tracer or obs_trace.null_tracer()
    if dist.is_primary():
        if path.exists() and not force:
            raise ValueError(f"checkpoint {path} exists (force=False)")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
    dist.host_sync(f"ckpt_stage_{step}")
    with tr.span("ckpt_dispatch", step=step) as sp:
        sp.set(wait=wait)
        host_tree = _snapshot(_shard_tree(state))
        ready = None
        if next(state.model.parameters()).device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()

    def _write():
        fault_point("ckpt_save")
        _write_shard(tmp, host_tree, ready)
        if world == 1:
            _publish(tmp, path, step)

    error: list[BaseException] = []

    def _write_retried():
        try:
            retry_call(_write, policy=IO_RETRY,
                       on_retry=lambda a, e, d: print(
                           f"[checkpoint] rank {rank} save attempt {a + 1} "
                           f"failed ({e}); retrying in {d:.2f}s"))
        except BaseException as e:  # noqa: BLE001 — reported at commit
            error.append(e)

    pend = {"error": error, "path": path, "tmp": tmp, "step": step,
            "device": integrity.device_of(state),
            "mesh_shape": _mesh_shape(), "world": world,
            "t_dispatch": time.perf_counter()}
    if wait:
        _write_retried()
        with tr.span("ckpt_commit", step=step) as sp:
            sp.set(overlap_s=0.0)
            if _commit(pend, tr) is None:
                raise error[0] if error else RuntimeError(
                    f"checkpoint step {step} failed on a rank")
        return path
    pend["thread"] = threading.Thread(target=_write_retried,
                                      name="hyperion-ckpt", daemon=True)
    _PENDING = pend
    pend["thread"].start()
    return path


def _commit(pend: dict, tr) -> Path | None:
    """Every rank: report this rank's write, meet, and let the primary
    rename the staging dir into place (under several ranks) and write
    the marker and the manifest. None (on every rank) when any rank's
    write failed: the save stays uncommitted."""
    step, path = pend["step"], pend["path"]
    failed = dist.any_rank(bool(pend["error"]))
    dist.host_sync(f"ckpt_written_{step}")
    if failed:
        if pend["error"]:
            tr.event("ckpt_commit_failed", step=step,
                     error=repr(pend["error"][0]))
        if dist.is_primary():
            print(f"[checkpoint] save at step {step} failed to commit; "
                  f"{path.name} stays uncommitted")
        return None
    if dist.is_primary():
        if pend["world"] > 1:
            _publish(pend["tmp"], path, step)
        integrity.write_manifest(
            path, step=step, extra={"device": pend["device"],
                                    "mesh_shape": pend["mesh_shape"],
                                    "world": pend["world"]})
    dist.host_sync(f"ckpt_committed_{step}")
    return path


def _saved_pieces(path: Path) -> tuple[dict, dict]:
    """({key: (global shape, dtype, [(offset, tensor), ...])}, meta) of
    a step dir's shards, keyed as `_named_entries`."""
    pieces: dict[str, tuple] = {}
    shards = sorted(path.glob("shard-*-of-*.pt"))
    if not shards:
        raise ValueError(f"{path} holds no shard")
    meta = None
    for f in shards:
        blob = torch.load(f, map_location="cpu", weights_only=True,
                          mmap=True)
        meta = meta or blob
        for key, e in blob["entries"].items():
            entry = pieces.setdefault(key, (tuple(e["shape"]),
                                            e["dtype"], []))
            entry[2].append((tuple(e["offset"]), e["data"]))
    return pieces, meta


def _assemble(dst: torch.Tensor, offset: tuple, parts: list) -> None:
    """Fill `dst` (a shard at `offset` of the global tensor) from saved
    parts that tile the global tensor; raise if any element is not
    covered."""
    covered = 0
    for poff, data in parts:
        lo = [max(a, b) for a, b in zip(offset, poff)]
        hi = [min(a + n, b + m) for a, n, b, m in
              zip(offset, dst.shape, poff, data.shape)]
        if any(h <= l for l, h in zip(lo, hi)):
            continue
        d = tuple(slice(l - a, h - a) for l, h, a in zip(lo, hi, offset))
        s = tuple(slice(l - b, h - b) for l, h, b in zip(lo, hi, poff))
        dst[d].copy_(data[s])
        covered += int(np.prod([h - l for l, h in zip(lo, hi)]))
    if covered != dst.numel():
        raise ValueError(f"saved shards cover {covered} of {dst.numel()} "
                         "elements")


def _fill(template: TrainState, pieces: dict, meta: dict) -> TrainState:
    """Restore `template` in place from `_saved_pieces`: each rank
    assembles its own shard of every tensor."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    model, opt = template.model, template.optimizer
    live_model = {f"model/{k}": v for k, v in model.state_dict().items()}
    saved_model = {k for k in pieces if k.startswith("model/")}
    if set(live_model) != saved_model:
        missing = sorted(set(live_model) - saved_model)[:3]
        extra = sorted(saved_model - set(live_model))[:3]
        raise ValueError(f"model keys differ: missing {missing}, "
                         f"unexpected {extra}")
    for key, t in live_model.items():
        # checked before a single tensor is copied, so a checkpoint of
        # another model leaves the template untouched
        shape, dtype, _ = pieces[key]
        if shape != tuple(t.shape) or dtype != str(t.dtype):
            raise ValueError(f"{key}: saved {shape} {dtype}, live "
                             f"{tuple(t.shape)} {t.dtype}")
    names = {n: p for n, p in model.named_parameters()}
    trained = {id(p) for p in opt.params}
    for key in pieces:
        if key.startswith("adamw/"):
            pname = key[len("adamw/"):].rpartition("/")[0]
            if pname not in names or id(names[pname]) not in trained:
                raise ValueError(f"optimizer state for {pname!r}, which the "
                                 "template does not train")

    def place(key: str, t: torch.Tensor) -> None:
        shape, dtype, parts = pieces[key]
        if shape != tuple(t.shape) or dtype != str(t.dtype):
            raise ValueError(f"{key}: saved {shape} {dtype}, live "
                             f"{tuple(t.shape)} {t.dtype}")
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            _, offset = compute_local_shape_and_global_offset(
                t.shape, t.device_mesh, t.placements)
            dst = t._local_tensor
        else:
            offset, dst = (0,) * t.dim(), t
        _assemble(dst, tuple(offset), parts)

    with torch.no_grad():
        for key, t in live_model.items():
            place(key, t)
        for p in opt.params:
            n = next(k for k, v in names.items() if v is p)
            keys = [k for k in pieces if k.startswith(f"adamw/{n}/")
                    and k.count("/") == n.count("/") + 2]
            if not keys:
                continue
            st = opt.adamw.state[p]
            for key in keys:
                leaf = key.rpartition("/")[2]
                if leaf not in st:
                    shape = pieces[key][0]
                    st[leaf] = (torch.zeros_like(p) if shape == tuple(p.shape)
                                else torch.zeros(shape, dtype=getattr(
                                    torch, pieces[key][1].removeprefix(
                                        "torch."))))
                place(key, st[leaf])
    opt.count = int(meta["count"])
    template.step = int(meta["step"])
    template.epoch_losses = meta.get("epoch_losses")
    template.epoch_counts = meta.get("epoch_counts")
    return template


def prune(root: str | Path, keep: int = 2) -> None:
    """Delete all but the newest `keep` step directories. Quarantined
    `*.corrupt` dirs are never touched, the `health/` subdir is
    invisible here, and the newest VERIFIED dir survives even when
    `keep` would doom it."""
    if not dist.is_primary():
        return
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


def _restore_step(path: Path, template: TrainState) -> TrainState:
    def _read_pieces():
        fault_point("ckpt_restore")
        return _saved_pieces(path)

    pieces, meta = retry_call(
        _read_pieces, policy=IO_RETRY,
        on_retry=lambda a, e, d: print(
            f"[checkpoint] restore attempt {a + 1} failed ({e}); "
            f"retrying in {d:.2f}s"))
    return _fill(template, pieces, meta)


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

    if dist.process_count() > 1:
        return _restore_ranks(root, template, step, tr, committed)

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


def _restore_ranks(root: Path, template: TrainState, step, tr,
                   committed) -> TrainState | None:
    """`restore` under several ranks: the primary verifies (walking back
    and quarantining), every rank restores the step it chose."""
    choice = None
    if dist.is_primary():
        if step is not None:
            path = _step_path(root, step)
            ok, reason = integrity.verify(path)
            if not (ok or committed(path, reason)):
                choice = ("error", f"checkpoint step {step} at {path} "
                                   f"failed verification: {reason}")
            else:
                choice = (step, not ok)
        else:
            for s, path in reversed(_step_dirs(root)):
                ok, reason = integrity.verify(path)
                if ok or committed(path, reason):
                    choice = (s, not ok)
                    break
                if reason.startswith("missing manifest"):
                    reason += " and no commit marker — partial save"
                integrity.quarantine(path, reason, tracer=tr)
    choice = dist.broadcast(choice)
    if choice is None:
        return None
    if choice[0] == "error":
        raise ValueError(choice[1])
    s, adopt = choice
    path = _step_path(root, s)
    with tr.span("ckpt_restore", step=s):
        restored = _restore_step(path, template)
    if adopt and dist.is_primary():
        print(f"[checkpoint] adopted {path.name} (no manifest, commit "
              "marker present); backfilling a manifest")
        integrity.write_manifest(path, step=s, state=restored)
    dist.host_sync(f"ckpt_restored_{s}")
    return restored


def gathered_state(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The model's state dict with every DTensor gathered whole (a
    collective: every rank calls it), on the CPU."""
    from torch.distributed.tensor import DTensor

    return {k: (v.full_tensor() if isinstance(v, DTensor) else v)
            .detach().cpu() for k, v in model.state_dict().items()}


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


def export_gathered(path: str | Path, params: dict) -> Path | None:
    """Write a nested dict of arrays as one `.npz` with `/`-joined
    keys, on the primary (None elsewhere)."""
    if not dist.is_primary():
        return None
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
