"""Compile one kernel source of this checkout and of another with the
port's own nvcc flags, and compare what the compiler made of each
function: ptxas's registers and spill bytes, and the SASS
(`cuobjdump -sass`) of every function whose name matches `--match`.

    python3 scripts/compare_kernel_builds.py --root DIR \\
        [--source flash_attention_wide] [--match kernel_wide]

Prints one JSON line a function present in either build (named without
its anonymous namespace's hash): its ptxas figures in each, whether the
two SASS listings are the same text and, where not, how many lines
differ and the first of them.
Needs nvcc and cuobjdump (the machine with the card); writes its
objects under a temporary directory.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from hyperion_tpu_torch.ops import build  # noqa: E402

_PTXAS_FN = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_SASS_FN = re.compile(r"^\s*Function : (\S+)", re.M)
# an anonymous namespace's mangled name carries a hash of its file's
# contents: drop it, so that one function pairs across two versions
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_")


def _name(mangled: str) -> str:
    return _ANON.sub("_GLOBAL__N_", mangled)


def compile_source(src: Path, out: Path) -> tuple[dict, dict]:
    """({mangled: ptxas figures}, {mangled: SASS text}) of `src`."""
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared",)]
    cubin = out / (src.stem + ".cubin")
    proc = subprocess.run(
        [build.find_nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
         str(cubin), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {src}:\n{proc.stderr}")
    ptxas, fn = {}, None
    for line in proc.stderr.splitlines():
        if m := _PTXAS_FN.search(line):
            fn = _name(m.group(1))
            ptxas[fn] = {}
        elif fn and (m := _PTXAS_USED.search(line)):
            ptxas[fn]["registers"] = int(m.group(1))
        elif fn and (m := _PTXAS_SPILL.search(line)):
            ptxas[fn]["spill_stores"] = int(m.group(1))
            ptxas[fn]["spill_loads"] = int(m.group(2))
    dump = shutil.which("cuobjdump") or str(
        Path(build.find_nvcc()).with_name("cuobjdump"))
    text = subprocess.run([dump, "-sass", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    starts = [(m.start(), m.group(1)) for m in _SASS_FN.finditer(text)]
    sass = {}
    for i, (at, name) in enumerate(starts):
        end = starts[i + 1][0] if i + 1 < len(starts) else len(text)
        # cuobjdump pads every line to the file's widest: compare the
        # instructions and their encodings, not the padding
        sass[_name(name)] = "\n".join(
            " ".join(line.split())
            for line in _ANON.sub("", text[at:end]).splitlines())
    return ptxas, sass


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True,
                    help="the other checkout (e.g. a git archive)")
    ap.add_argument("--source", default="flash_attention_wide")
    ap.add_argument("--match", default="kernel_wide")
    args = ap.parse_args()
    rel = Path("hyperion_tpu_torch/ops/csrc") / f"{args.source}.cu"
    with tempfile.TemporaryDirectory() as tmp:
        builds = {}
        for who, root in (("this", HERE), ("root", Path(args.root))):
            out = Path(tmp) / who
            out.mkdir()
            builds[who] = compile_source(root / rel, out)
    names = sorted(n for n in set(builds["this"][0]) | set(builds["root"][0])
                   if args.match in n)
    for n in names:
        a, b = builds["this"][1].get(n), builds["root"][1].get(n)
        rec = {"function": n, "this": builds["this"][0].get(n),
               "root": builds["root"][0].get(n),
               "same_sass": a is not None and a == b}
        if a is not None and b is not None and a != b:
            la, lb = a.splitlines(), b.splitlines()
            diff = [(x, y) for x, y in zip(la, lb) if x != y]
            rec.update(sass_lines=[len(la), len(lb)],
                       differing_lines=len(diff) + abs(len(la) - len(lb)),
                       first_differences=diff[:3])
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
