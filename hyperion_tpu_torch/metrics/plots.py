"""PNG artifacts for the benchmark suites — `hyperion_tpu/metrics/plots.py`.

Every function takes a benchmark's row dicts (the exact CSV rows) and
writes one PNG; matplotlib is imported lazily with the Agg backend.
Plotting is best effort: `try_plot` returns None when a plot cannot be
made (matplotlib absent, as on the card's machine, or any other
failure), as the reference's does, and no number depends on a plot.
"""

from __future__ import annotations

from pathlib import Path


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finite(rows, key):
    out = []
    for r in rows:
        try:
            v = float(r[key])
        except (KeyError, TypeError, ValueError):
            continue
        if v == v:
            out.append((r, v))
    return out


def plot_compile_tiers(rows: list[dict], out_path: str | Path) -> Path | None:
    """Two-panel bars: per-model tier latency, and speedup vs the jit
    tier (the reference's plot_speed/plot_mem pair, adapted to the
    jit-centric tier table). Variants are derived from the rows so a new
    tier in compile_bench.VARIANTS shows up without touching this file."""
    plt = _plt()
    models = sorted({r["model"] for r in rows})
    order = {"op_by_op": 0, "jit": 1, "jit_pallas": 2}
    variants = sorted({r["variant"] for r in rows},
                      key=lambda v: order.get(v, 99))
    fig, (ax1, ax2, ax3) = plt.subplots(1, 3, figsize=(18, 5))

    def grouped_bars(ax, variants, key):
        width = 0.8 / max(len(variants), 1)
        any_bar = False
        for vi, variant in enumerate(variants):
            xs, ys = [], []
            offset = (vi - (len(variants) - 1) / 2) * width
            for mi, m in enumerate(models):
                sub = [r for r in rows
                       if r["model"] == m and r["variant"] == variant]
                vals = _finite(sub, key)
                if vals:
                    xs.append(mi + offset)
                    ys.append(vals[0][1])
            if xs:
                ax.bar(xs, ys, width, label=variant)
                any_bar = True
        ax.set_xticks(range(len(models)))
        ax.set_xticklabels(models, rotation=20, ha="right", fontsize=8)
        if any_bar:
            ax.legend()

    grouped_bars(ax1, variants, "median_ms")
    ax1.set_ylabel("latency (ms)")
    ax1.set_yscale("log")
    ax1.set_title("compilation tiers: latency")

    for mi, m in enumerate(models):
        sub = {r["variant"]: r for r in rows if r["model"] == m}
        base = _finite([sub.get("jit", {})], "median_ms")
        pallas = _finite([sub.get("jit_pallas", {})], "median_ms")
        if base and pallas and pallas[0][1] > 0:
            ax2.bar(mi, base[0][1] / pallas[0][1], 0.5, color="tab:green")
    ax2.axhline(1.0, color="gray", lw=1, ls="--")
    ax2.set_xticks(range(len(models)))
    ax2.set_xticklabels(models, rotation=20, ha="right", fontsize=8)
    ax2.set_ylabel("speedup of the hand kernels over jit (x)")
    ax2.set_title("hand-kernel speedup")

    # the reference's plot_mem analogue: the allocator's peak above the
    # resident state, per tier
    grouped_bars(ax3, variants, "temp_memory_gb")
    ax3.set_ylabel("peak memory above the inputs (GB)")
    ax3.set_title("per-tier temp memory")

    fig.tight_layout()
    out_path = Path(out_path)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_matmul_tflops(rows: list[dict], out_path: str | Path) -> Path | None:
    """TFLOPS vs matrix size, one line per dtype, with the chip's
    nominal peak marked (the reference's precision sweep plot, plus the
    MFU context it lacked)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 5))
    dtypes = sorted({r["dtype"] for r in rows})
    peaks: dict[float, list[str]] = {}
    for dt in dtypes:
        pts = sorted(
            (int(r["size"]), v)
            for r, v in _finite([r for r in rows if r["dtype"] == dt], "tflops")
        )
        if pts:
            ax.plot(*zip(*pts), marker="o", label=dt)
        for r, v in _finite([r for r in rows if r["dtype"] == dt], "peak_tflops"):
            peaks.setdefault(v, []).append(dt)
    # one dashed line per distinct nominal peak, labeled with the dtypes
    # it bounds (int8 peaks 2x bf16 — a single "bf16 peak" label would lie)
    for v, dts in sorted(peaks.items()):
        ax.axhline(v, color="gray", ls="--", lw=1,
                   label=f"nominal peak {v:.0f} ({','.join(sorted(set(dts)))})")
    ax.set_xscale("log", base=2)
    ax.set_xlabel("matrix size N (NxN @ NxN)")
    ax.set_ylabel("sustained TFLOPS")
    ax.set_title("matmul throughput")
    ax.legend()
    fig.tight_layout()
    out_path = Path(out_path)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_bandwidth(rows: list[dict], out_path: str | Path) -> Path | None:
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 5))
    hbm = [(int(r["elements"]), v) for r, v in _finite(rows, "gb_per_s")
           if not r.get("note")]
    cached = [(int(r["elements"]), v) for r, v in _finite(rows, "gb_per_s")
              if r.get("note")]
    if hbm:
        ax.plot(*zip(*sorted(hbm)), marker="o", label="HBM-resident")
    if cached:
        ax.plot(*zip(*sorted(cached)), marker="x", ls=":",
                label="cache-resident (not HBM)")
    ax.set_xscale("log")
    ax.set_xlabel("elements")
    ax.set_ylabel("GB/s (12 B/element accounting)")
    ax.set_title("memory bandwidth (z = x + y)")
    ax.legend()
    fig.tight_layout()
    out_path = Path(out_path)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_baseline_models(rows: list[dict], out_path: str | Path) -> Path | None:
    """Three panels per model: stacked fwd/bwd/opt time, peak memory,
    throughput (the reference's remaining panel — batch scaling — is
    `plot_batch_scaling`)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    models = [r["model"] for r in rows]
    x = range(len(models))

    fwd = [float(r["forward_ms"]) for r in rows]
    bwd = [float(r["backward_ms"]) for r in rows]
    opt = [float(r["optimizer_ms"]) for r in rows]
    axes[0].bar(x, fwd, label="forward")
    axes[0].bar(x, bwd, bottom=fwd, label="backward")
    axes[0].bar(x, opt, bottom=[a + b for a, b in zip(fwd, bwd)],
                label="optimizer")
    axes[0].set_ylabel("ms / step")
    axes[0].set_title("train-step decomposition")
    axes[0].legend()

    axes[1].bar(x, [float(r["peak_memory_mb"]) for r in rows],
                color="tab:purple")
    axes[1].set_ylabel("peak memory (MB)")
    axes[1].set_title("peak device memory")

    axes[2].bar(x, [float(r["samples_per_s"]) for r in rows],
                color="tab:green")
    axes[2].set_ylabel("samples / s")
    axes[2].set_title("throughput")

    for ax in axes:
        ax.set_xticks(list(x))
        ax.set_xticklabels(models, rotation=20, ha="right", fontsize=8)
    fig.tight_layout()
    out_path = Path(out_path)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_batch_scaling(
    sweeps: dict[str, list[dict]], out_path: str | Path
) -> Path | None:
    """Throughput and memory vs batch size, one line per model (the
    reference's batch-scaling viz)."""
    plt = _plt()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
    for model, rows in sorted(sweeps.items()):
        bs = [int(r["batch_size"]) for r in rows]
        ax1.plot(bs, [float(r["samples_per_s"]) for r in rows],
                 marker="o", label=model)
        ax2.plot(bs, [float(r["peak_memory_mb"]) for r in rows],
                 marker="o", label=model)
    ax1.set_xlabel("batch size")
    ax1.set_ylabel("samples / s")
    ax1.set_xscale("log", base=2)
    ax1.set_title("batch-size scaling: throughput")
    ax1.legend()
    ax2.set_xlabel("batch size")
    ax2.set_ylabel("peak memory (MB)")
    ax2.set_xscale("log", base=2)
    ax2.set_title("batch-size scaling: memory")
    fig.tight_layout()
    out_path = Path(out_path)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def try_plot(fn, *args, **kwargs):
    """Best-effort wrapper: benchmarks never fail because of plotting
    (None when the plot could not be made)."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001
        print(f"[plots] skipped {getattr(fn, '__name__', fn)}: {e}")
        return None
