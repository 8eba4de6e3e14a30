"""Time the fp32 flash kernels past head_dim 256 with one piece of their
work taken out at a time, to show what holds them: each variant is this
checkout's `csrc/flash_attention_wide.cu` with one textual change,
compiled with the port's nvcc flags into a library of its own and
called through its C entry points on the same inputs, at lm_d512's
layer ([2, 4096, 2, 512] fp32, causal, `chip_smoke.ragged_pad`'s
padding).

    python3 scripts/ablate_wide_fp32.py

Variants (every one but `base` computes wrong values: they are timed,
never used):
  base             the source as it is
  local_exchange   the partial logits read from the block's own slots,
                   not from every block's (no distributed shared memory
                   reads; the cluster barrier stays)
  no_tile_barrier  the cluster barrier of every tile a block barrier
                   (the remote reads stay, unordered)
  one_tf32_pass    each product hi.hi only (lo.hi and hi.lo dropped)
  no_split         the streamed tiles copied into the planes unsplit
Each variant's forward, dq and dk/dv run in turns with the others (base
first and last), 20 times each, timed with CUDA events. Prints
one JSON line a variant (medians and the spread of each kernel's ms),
then the card's name and power limit. Needs nvcc and the card.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from hyperion_tpu_torch.ops import build  # noqa: E402
from hyperion_tpu_torch.ops import flash_attention as fa  # noqa: E402

CSRC = HERE / "hyperion_tpu_torch" / "ops" / "csrc"
SOURCE = "flash_attention_wide.cu"
DIMS = (2, 4096, 2, 512)  # chip_smoke.LM_D512_SHAPE
REPS = 20
# name: [(text, replacement, occurrences)]
VARIANTS = {
    "base": [],
    "local_exchange": [("const uint32_t ra = map_rank(a, r0 + j);",
                        "const uint32_t ra = a;", 1)],
    "no_tile_barrier": [("    cluster_sync();\n    if (active) {",
                         "    __syncthreads();\n    if (active) {", 3)],
    "one_tf32_pass": [("  mma(c, a.lo, b.hi);\n  mma(c, a.hi, b.lo);\n", "",
                       1)],
    "no_split": [("    split(x, h, l);\n",
                  "    for (int i = 0; i < 4; ++i) {\n"
                  "      h[i] = __float_as_uint(x[i]);\n"
                  "      l[i] = 0u;\n"
                  "    }\n", 1)],
}


def variant_source(name: str) -> str:
    text = (CSRC / SOURCE).read_text()
    for old, new, count in VARIANTS[name]:
        if text.count(old) != count:
            raise RuntimeError(f"{name}: {old!r} occurs {text.count(old)} "
                               f"times, not {count}")
        text = text.replace(old, new)
    return text


def compile_variant(name: str, work: Path) -> Path:
    """The variant's library, built in `work/name` beside copies of the
    headers it includes."""
    d = work / name
    d.mkdir()
    for h in CSRC.glob("*.cuh"):
        shutil.copy(h, d)
    (d / SOURCE).write_text(variant_source(name))
    lib = d / "lib.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                           str(lib), str(d / SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {name}:\n{proc.stdout}{proc.stderr}")
    return lib


def entry_points(lib_path: Path) -> dict:
    lib = ctypes.CDLL(str(lib_path))
    fns = {"fwd": (lib.hyperion_flash_wide_fwd, fa._FWD_ARGTYPES),
           "dq": (lib.hyperion_flash_wide_dq, fa._DQ_ARGTYPES),
           "dkv": (lib.hyperion_flash_wide_dkv, fa._DKV_ARGTYPES)}
    for fn, argtypes in fns.values():
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return {k: fn for k, (fn, _) in fns.items()}


def load_smoke():
    spec = importlib.util.spec_from_file_location("smoke_here",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launches(fns: dict, t: dict, dims) -> dict:
    """{kernel: a call launching it} on the tensors `t`."""
    B, T, H, D = dims
    stream = torch.cuda.current_stream().cuda_stream
    scale = fa._scale(D)
    p = lambda x: x.data_ptr()  # noqa: E731
    common = (B, T, T, H, D, D, 1, scale, 0, stream)

    def run(which, *ptrs):
        def call():
            build.check(fns[which](*ptrs, *common), f"{which} launch")
        return call

    return {"fwd": run("fwd", p(t["q"]), p(t["k"]), p(t["v"]), p(t["pad"]),
                       p(t["o_out"]), p(t["lse_out"])),
            "dq": run("dq", p(t["q"]), p(t["k"]), p(t["v"]), p(t["pad"]),
                      p(t["do"]), p(t["o"]), p(t["lse"]), p(t["delta"]),
                      p(t["dq"])),
            "dkv": run("dkv", p(t["q"]), p(t["k"]), p(t["v"]), p(t["pad"]),
                       p(t["do"]), p(t["lse"]), p(t["delta_base"]),
                       p(t["dk"]), p(t["dv"]))}


def time_ms(call, reps: int) -> list[float]:
    call()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        call()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    names, dims = list(VARIANTS), DIMS
    B, T, H, D = dims
    cs = load_smoke()
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(names)) as ex:
            libs = dict(zip(names, ex.map(
                lambda n: compile_variant(n, Path(tmp)), names)))
        fns = {n: entry_points(libs[n]) for n in names}
        seed = cs.SEED + 81
        q, k, v, do = cs.flash_case(B, T, H, D, torch.float32, 0.0,
                                    seed)[:4]
        pad = cs.ragged_pad(B, T, seed).to(torch.int32).contiguous()
        stats = torch.empty(B, H, T, device=q.device)
        t = {"q": q, "k": k, "v": v, "do": do, "pad": pad,
             "o": torch.empty_like(q), "lse": stats.clone(),
             "o_out": torch.empty_like(q), "lse_out": stats.clone(),
             "delta": stats.clone(), "delta_base": stats.clone(),
             "dq": torch.empty_like(q), "dk": torch.empty_like(k),
             "dv": torch.empty_like(v)}
        calls = {n: launches(fns[n], t, dims) for n in names}
        # the backward's inputs from the unchanged source: o and lse from
        # its forward, delta from its dq
        calls["base"]["fwd"]()
        t["o"].copy_(t["o_out"])
        t["lse"].copy_(t["lse_out"])
        calls["base"]["dq"]()
        t["delta_base"].copy_(t["delta"])
        times = {n: {w: [] for w in ("fwd", "dq", "dkv")} for n in names}
        for n in [*names, "base"]:  # base first and last
            for w, call in calls[n].items():
                times[n][w] += time_ms(call, REPS)
        for n in names:
            rec = {"variant": n, "shape": list(dims), "reps": REPS}
            for w, ts in times[n].items():
                ts = sorted(ts)
                rec[f"{w}_ms"] = ts[len(ts) // 2]
                rec[f"{w}_ms_range"] = [ts[0], ts[-1]]
            rec["bwd_ms"] = rec["dq_ms"] + rec["dkv_ms"]
            print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
