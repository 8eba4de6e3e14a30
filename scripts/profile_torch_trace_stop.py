"""An on-demand trace that stops while the engine serves, on the card.

    python3 scripts/profile_torch_trace_stop.py [--iters 24]

A port engine (Llama-2-7B widths, 2 layers, fp32, random weights from a
seed, the introspect phase's model in `chip_smoke.py`) serves on the
main thread while `torch.profiler` traces start and stop on their own
thread, alternately for 2.0 s (serving 2.5 s, across the stop) and
0.3 s (serving 0.9 s). Two modes, each in a child process:

  * `raw`   — `utils/profiling.on_demand_trace` with no tick gate: the
    profiler starts and stops whenever its timer says;
  * `gated` — the engine's `profile` control verb: the profiler starts
    and stops only between ticks (the engine's tick gate).

A child whose iteration takes over 150 s dumps every thread's stack
(`faulthandler`) and exits; the parent reports, per mode, the
iterations that finished and whether one hung. Prints one JSON line a
mode, after the card's name and power limit. Writes under
`build/profile_torch_trace_stop/`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "profile_torch_trace_stop"
HANG_S = 150


def child(mode: str, iters: int) -> None:
    import faulthandler

    import numpy as np
    import torch

    from hyperion_tpu_torch.checkpoint.io import export_gathered, load_gathered
    from hyperion_tpu_torch.infer.generate import model_from_npz
    from hyperion_tpu_torch.models.llama import (
        Llama,
        llama2_7b_config,
        params_to_jax,
    )
    from hyperion_tpu_torch.serve.engine import Engine, EngineConfig
    from hyperion_tpu_torch.serve.queue import Request
    from hyperion_tpu_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    base = OUT / mode
    base.mkdir(parents=True, exist_ok=True)
    ckpt = base / "llama.npz"
    src = Llama(llama2_7b_config(n_layers=2, max_len=256, dtype="float32"),
                device="cuda").init_params(
        torch.Generator(device="cuda").manual_seed(3))
    export_gathered(ckpt, params_to_jax(src))
    del src
    model = model_from_npz(load_gathered(ckpt), 256, dtype="float32",
                           device="cuda")
    eng = Engine(model, EngineConfig(slots=4, max_len=256), device="cuda")
    eng.warmup([64])
    rng = np.random.default_rng(7)
    n = 0

    def serve_for(seconds: float) -> None:
        nonlocal n
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            while len(eng.queue) + eng.n_active < 4:
                eng.submit(Request(prompt_ids=rng.integers(1, 32000, 40)
                                   .astype(np.int32), max_new_tokens=64,
                                   id=f"x{n}"))
                n += 1
            eng.step()

    serve_for(0.5)
    for i in range(iters):
        faulthandler.dump_traceback_later(HANG_S, exit=True)
        window, serve = (2.0, 2.5) if i % 2 == 0 else (0.3, 0.9)
        out = base / f"p{i}"
        t0 = time.perf_counter()
        if mode == "raw":
            res = profiling.on_demand_trace(str(out), window)
        else:
            res = eng.control({"cmd": "profile", "out": str(out),
                               "seconds": window})
        assert res["status"] == "started", res
        serve_for(serve)
        trace = out / profiling.TRACE_NAME
        while not trace.exists() or profiling._TRACE_ACTIVE:
            eng.step()
        events = json.loads(trace.read_text()).get("traceEvents", [])
        paged = sum(1 for e in events
                    if "paged_attention_kernel" in str(e.get("name", "")))
        print(json.dumps({"mode": mode, "i": i, "window_s": window,
                          "iter_s": time.perf_counter() - t0,
                          "paged": paged}), flush=True)
        assert paged, "no paged kernel in the trace"
    faulthandler.cancel_dump_traceback_later()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--child", choices=("raw", "gated"))
    args = ap.parse_args()
    if args.child:
        child(args.child, args.iters)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    for mode in ("raw", "gated"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, __file__, "--child", mode,
             "--iters", str(args.iters)], capture_output=True, text=True,
            timeout=120 + args.iters * 20 + HANG_S)
        (OUT / f"{mode}.log").write_text(proc.stdout + proc.stderr)
        rows = [json.loads(x) for x in proc.stdout.splitlines()
                if x.startswith('{"mode"')]
        print(json.dumps({
            "mode": mode, "rc": proc.returncode,
            "iters_done": len(rows), "iters": args.iters,
            "hung": "Timeout (" in proc.stderr,
            "iter_s_max": max((r["iter_s"] for r in rows), default=None),
            "seconds": time.perf_counter() - t0}), flush=True)
        if proc.returncode and "Timeout (" in proc.stderr:
            print(proc.stderr[proc.stderr.index("Timeout ("):][:3000],
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
