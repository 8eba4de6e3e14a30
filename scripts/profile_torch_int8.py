"""The weight-only int8 kernels on one CUDA card, against the kernels
they replaced and against bf16, in turns within one call.

    python3 scripts/profile_torch_int8.py [--turns 2] [--only decode]
        [--lib build/variants/NAME/libint8_matmul.so]

  * `Baseline`: builds `scripts/int8_matmul_baseline.cu` (the int8
    kernels before their Hopper redesign: a quantize launch a dense, then
    mma.sync from a cp.async ring, one block walking the whole K) with
    `ops/build.py`'s nvcc flags into `build/profile_torch_int8/`, and
    wraps its C entry points, which have the port's interface.
  * `cases`: the 7B's decode denses at M 4 (q/k/v/o 4096→4096, gate/up
    4096→11008, down 11008→4096, lm_head 4096→32000) from bf16 rows:
    this checkout's fused kernel (one launch) against the baseline's
    quantize-then-product (two launches), the baseline's product alone
    and bf16 `F.linear`; the prefill product [512, 4096→11008] against
    the baseline's, `torch._int_mm` plus the same epilogue, and bf16;
    the row quantizer at [4, 4096], [4, 11008], [512, 4096] and the
    weight [11008, 4096]. Each time is `chip_smoke.time_ms` (a CUDA
    graph of launches replayed on inputs colder than the L2).
  * `host`: host microseconds a dense at the decode tick (M 1,
    4096→4096), this checkout's, the baseline's and bf16's, the calls
    queued behind a device sleep so their dispatch alone is timed.
  * `forward`: the 225 denses of one batch-4 decode forward of
    Llama-2-7B (32 layers of q, k, v, o, gate, up, down, then the head)
    on distinct seeded weights (6.6 GB int8, 13.2 GB bf16), each way
    captured in one CUDA graph and replayed: this checkout's
    `quantized_dense`, the baseline's, bf16 `F.linear`.

Turns go baseline, this, this, baseline (with `--turns 2`), bf16 once a
turn. `--only decode` times the four decode denses alone; `--lib` loads
the int8 kernels from another build of `ops/csrc/int8_matmul.cu` (a
variant: a copy under `build/variants/` with other constants, built
with `ops/build.py`'s flags) in place of this checkout's. Every int8
output is checked bit-identical between this checkout and the baseline
before it is timed. Prints one JSON line a section and the card's name
and power limit (`nvidia-smi`). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from hyperion_tpu_torch.ops import build  # noqa: E402
from hyperion_tpu_torch.ops import int8_matmul as im  # noqa: E402

BASELINE_SRC = REPO / "scripts" / "int8_matmul_baseline.cu"
OUT_DIR = REPO / "build" / "profile_torch_int8"
# the 7B's decode denses: (name, K, N)
DENSES_7B = (("qkvo", 4096, 4096), ("gate_up", 4096, 11008),
             ("down", 11008, 4096), ("lm_head", 4096, 32000))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Baseline:
    """The baseline kernels, built on construction in the background
    (`load` waits for nvcc and binds the library)."""

    def __init__(self):
        h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
        h.update(BASELINE_SRC.read_bytes())
        self.path = OUT_DIR / f"libint8_baseline_{h.hexdigest()[:16]}.so"
        self.proc = None
        self.lib = None
        if not self.path.exists():
            OUT_DIR.mkdir(parents=True, exist_ok=True)
            self.tmp = self.path.with_suffix(f".{os.getpid()}.tmp.so")
            self.proc = subprocess.Popen(
                [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(self.tmp),
                 str(BASELINE_SRC)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)

    def load(self) -> "Baseline":
        if self.lib is not None:
            return self
        if self.proc is not None:
            log, _ = self.proc.communicate()
            if self.proc.returncode != 0:
                raise RuntimeError(f"baseline int8 build failed:\n{log}")
            os.replace(self.tmp, self.path)
            self.proc = None
        self.lib = ctypes.CDLL(str(self.path))
        self._q = self.lib.hyperion_quantize_rows
        self._q.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        self._mm = self.lib.hyperion_int8_matmul
        self._mm.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        return self

    def quantize_rows(self, x: torch.Tensor):
        K = x.shape[-1]
        q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        s = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        build.check(self._q(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                            x.numel() // K, K, im._IN_DTYPES[x.dtype],
                            im._stream(x)), "baseline quantize_rows")
        return q, s

    def int8_matmul(self, xq, wq, sx, sw, out_dtype=torch.bfloat16,
                    bias=None):
        M, N, K = im._check_mm(xq, wq, sx, sw, out_dtype, bias)
        out = torch.empty(M, N, dtype=out_dtype, device=xq.device)
        build.check(self._mm(xq.data_ptr(), wq.data_ptr(), sx.data_ptr(),
                             sw.data_ptr(),
                             None if bias is None else bias.data_ptr(),
                             out.data_ptr(), M, N, K,
                             im._OUT_DTYPES[out_dtype], im._stream(xq)),
                    "baseline int8_matmul")
        return out

    def dense(self, x, wq, sw, out_dtype=torch.bfloat16, bias=None):
        """The baseline's `quantized_dense`: two launches."""
        xq, sx = self.quantize_rows(x)
        return self.int8_matmul(xq, wq, sx, sw, out_dtype, bias)


def _smoke():
    """`chip_smoke` for its timing helpers (imported here, not at the
    top: `chip_smoke` itself loads this module)."""
    import chip_smoke

    return chip_smoke


def _turns(fns: dict, args: tuple, nbytes: float, turns: int) -> dict:
    """`time_ms` of each way, in turns: baseline first and last, this in
    the middle, the others once a turn."""
    cs = _smoke()
    out = {k: [] for k in fns}
    for r in range(turns):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for k in order:
            out[k].append(cs.time_ms(fns[k], args, nbytes))
    return out


def _operands(M, K, N, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
    w = (0.02 * torch.randn(N, K, generator=g, device="cuda")).to(
        torch.bfloat16)
    wq, sw = im.quantize_rows(w)
    return x, w, wq, sw


def cases(base: Baseline, turns: int, smi: str,
          decode_only: bool = False) -> list[dict]:
    cs = _smoke()
    recs = []
    for i, (name, K, N) in enumerate(DENSES_7B):
        M = 4
        x, w, wq, sw = _operands(M, K, N, 100 + i)
        got = im.quantized_dense_decode(x, wq, sw)
        if not torch.equal(got, base.dense(x, wq, sw)):
            raise AssertionError(f"{name}: fused decode != baseline")
        xq, sx = base.quantize_rows(x)
        nbytes = K * N + 2 * M * K + 2 * M * N + 4 * N
        t = _turns({"baseline_dense": lambda a, b, c: base.dense(a, b, c),
                    "this_fused": lambda a, b, c: im.quantized_dense_decode(
                        a, b, c)}, (x, wq, sw), nbytes, turns)
        t["baseline_product"] = [cs.time_ms(
            lambda a, b, c, d: base.int8_matmul(a, b, c, d),
            (xq, wq, sx, sw), nbytes)]
        t["this_product"] = [cs.time_ms(
            lambda a, b, c, d: im.int8_matmul(a, b, c, d),
            (xq, wq, sx, sw), nbytes)]
        t["bf16_linear"] = [cs.time_ms(F.linear, (x, w), 2 * (M * K + N * K
                                                             + M * N))]
        bound, by = cs.bound(nbytes, 2.0 * M * N * K, torch.int8)
        recs.append({"section": "case", "case": f"decode_{name}",
                     "shape": [M, K, N], "ms": t, "bound_ms": bound,
                     "bound_by": by, "nvidia_smi": smi,
                     **im.kernel_attrs("decode_fused", torch.bfloat16, K, N)})
        emit(recs[-1])
    if decode_only:
        return recs
    M, K, N = 512, 4096, 11008
    x, w, wq, sw = _operands(M, K, N, 120)
    xq, sx = im.quantize_rows(x)
    if not torch.equal(im.int8_matmul(xq, wq, sx, sw),
                       base.int8_matmul(xq, wq, sx, sw)):
        raise AssertionError("prefill: wgmma product != baseline")
    nbytes = K * N + M * K + 2 * M * N + 4 * (M + N)
    t = _turns({"baseline_product": lambda *a: base.int8_matmul(*a),
                "this_product": lambda *a: im.int8_matmul(*a)},
               (xq, wq, sx, sw), nbytes, turns)
    t["int_mm_epilogue"] = [cs.time_ms(
        lambda a, b, c, d: (torch._int_mm(a, b.t()).float() * c[:, None]
                            * d[None, :]).to(torch.bfloat16),
        (xq, wq, sx, sw), nbytes)]
    t["bf16_linear"] = [cs.time_ms(F.linear, (x, w),
                                   2 * (M * K + N * K + M * N))]
    bound, by = cs.bound(nbytes, 2.0 * M * N * K, torch.int8)
    recs.append({"section": "case", "case": "prefill_gate_up",
                 "shape": [M, K, N], "ms": t, "bound_ms": bound,
                 "bound_by": by, "nvidia_smi": smi,
                 **im.kernel_attrs("prefill_wgmma", torch.bfloat16, K)})
    emit(recs[-1])
    g = torch.Generator(device="cuda").manual_seed(130)
    for name, shape in (("decode_4x4096", (4, 4096)),
                        ("decode_4x11008", (4, 11008)),
                        ("prefill_512x4096", (512, 4096)),
                        ("weight_11008x4096", (11008, 4096))):
        x = (3 * torch.randn(*shape, generator=g, device="cuda")).to(
            torch.bfloat16)
        a, b = im.quantize_rows(x), base.quantize_rows(x)
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"quantize {name}: != baseline")
        nbytes = x.numel() * 3 + 4 * shape[0]
        t = _turns({"baseline": base.quantize_rows,
                    "this": im.quantize_rows}, (x,), nbytes, turns)
        recs.append({"section": "case", "case": f"quantize_{name}",
                     "shape": list(shape), "ms": t,
                     "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes", "path": im.quantize_rows_path(x),
                     "nvidia_smi": smi})
        emit(recs[-1])
    return recs


def host_us(base: Baseline, calls: int = 300) -> dict:
    """Host microseconds a call, each way, at the decode tick's widest
    dense count (M 1, 4096→4096): the calls queue behind a long device
    sleep, so the clock times their dispatch alone."""
    from hyperion_tpu_torch.precision.quant import quantized_dense

    x, w, wq, sw = _operands(1, 4096, 4096, 160)
    ways = {"this": lambda: quantized_dense(x, wq, sw, torch.bfloat16),
            "baseline": lambda: base.dense(x, wq, sw),
            "bf16": lambda: F.linear(x, w)}
    out = {}
    for name, fn in ways.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000_000)  # cycles: ~1 s of a queue that holds
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    return out


def graph_ms(calls: list, reps: int = 5) -> float:
    """ms of one pass over `calls` (closures of no arguments), captured
    in one CUDA graph on the warm-up stream and replayed `reps` times
    between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for c in calls:
            c()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def forward_turns(denses: list, base: Baseline, turns: int,
                  seed: int = 140) -> dict:
    """One batch-4 decode forward's denses, `denses` = [(wq [N, K], sw
    [N], w bf16 [N, K], bias or None)] in forward order: ms a forward
    this checkout's way (`quantized_dense`: one fused launch a dense),
    the baseline's (two) and bf16 `F.linear`, in turns; the int8 outputs
    of the first layer's denses and the head checked bit-identical
    between the two first."""
    from hyperion_tpu_torch.precision.quant import quantized_dense

    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = {K: torch.randn(4, K, generator=g, device="cuda").to(torch.bfloat16)
          for K in sorted({wq.shape[1] for wq, *_ in denses})}
    for wq, sw, _, b in (*denses[:7], denses[-1]):
        x = xs[wq.shape[1]]
        if not torch.equal(quantized_dense(x, wq, sw, torch.bfloat16, b),
                           base.dense(x, wq, sw, torch.bfloat16, b)):
            raise AssertionError("forward dense: this != baseline")
    ways = {
        "baseline": [lambda wq=wq, sw=sw, b=b: base.dense(
            xs[wq.shape[1]], wq, sw, torch.bfloat16, b)
            for wq, sw, _, b in denses],
        "this": [lambda wq=wq, sw=sw, b=b: quantized_dense(
            xs[wq.shape[1]], wq, sw, torch.bfloat16, b)
            for wq, sw, _, b in denses],
        "bf16": [lambda w=w: F.linear(xs[w.shape[1]], w)
                 for _, _, w, _ in denses]}
    out = {k: [] for k in ways}
    for r in range(turns):
        order = ("baseline", "this", "bf16") if r % 2 == 0 else \
            ("bf16", "this", "baseline")
        for k in order:
            out[k].append(graph_ms(ways[k]))
    return out


def random_7b_denses(layers: int = 32, seed: int = 150) -> list:
    """Seeded weights of the 7B's 225 denses (no model): int8 with
    scales, and a bf16 copy's worth of random bf16 for `F.linear`."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = [*[(4096, 4096)] * 4, (4096, 11008), (4096, 11008),
              (11008, 4096)] * layers + [(4096, 32000)]
    out = []
    for K, N in shapes:
        wq = torch.randint(-127, 128, (N, K), generator=g, device="cuda",
                           dtype=torch.int8)
        sw = torch.rand(N, generator=g, device="cuda") * 1e-3 + 1e-5
        w = (0.02 * torch.randn(N, K, generator=g, device="cuda")).to(
            torch.bfloat16)
        out.append((wq, sw, w, None))
    return out


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--only", choices=("all", "decode"), default="all")
    p.add_argument("--lib", help="the int8 kernels' library to time")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_int8: needs a CUDA card", file=sys.stderr)
        return 1
    smi = smi_line()
    print(smi, flush=True)
    base = Baseline()
    if args.lib:
        build._libs["int8_matmul"] = ctypes.CDLL(args.lib)
        emit({"section": "lib", "path": args.lib})
    else:
        build.load("int8_matmul")
    base.load()
    cases(base, args.turns, smi, decode_only=args.only == "decode")
    emit({"section": "host", "us_per_call": host_us(base), "nvidia_smi": smi})
    if args.only == "decode":
        return 0
    denses = random_7b_denses()
    emit({"section": "forward", "batch": 4, "denses": len(denses),
          "ms": forward_turns(denses, base, args.turns), "nvidia_smi": smi,
          "int8_weight_bytes": sum(d[0].numel() for d in denses)})
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
