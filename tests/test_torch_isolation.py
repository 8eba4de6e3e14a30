"""The port stands alone: `hyperion_tpu_torch`, `chip_smoke.py` and
the port's profiling scripts import neither jax nor anything of the JAX package `hyperion_tpu`,
nor `ml_dtypes` (the card's machine has none: bf16 host buffers stay
raw bits), nor `regex` (also absent there: the BPE pre-tokenizer scans
`unicodedata` categories).

On the card a CUDA jax would compete with torch for device memory, and
importing any `hyperion_tpu.utils.*` or `hyperion_tpu.serve.*` module
loads jax, so the port keeps its own copies of the host modules it
needs. This keeps a later slice from importing the reference by
accident: once in a fresh interpreter, once by reading the sources.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "hyperion_tpu_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"] \
    + sorted((REPO / "scripts").glob("profile_torch_*.py"))

_PROBE = """
import importlib, pkgutil, sys
import hyperion_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                               "hyperion_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "ml_dtypes",
                                    "regex", "hyperion_tpu"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_fresh_interpreter_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 15, proc.stdout  # every module was walked


_IMPORT_JAX = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|ml_dtypes|regex)\b", re.M)
_IMPORT_REF = re.compile(r"^\s*(import|from)\s+hyperion_tpu\b", re.M)
_DOTTED_REF = re.compile(r"\bhyperion_tpu\.")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_names_no_jax_and_no_reference_module(path):
    text = path.read_text()
    for pattern in (_IMPORT_JAX, _IMPORT_REF, _DOTTED_REF):
        hit = pattern.search(text)
        assert hit is None, f"{path.name}: {hit.group(0)!r}"


def test_router_spawns_port_replicas(tmp_path):
    """The port's router runs port replicas, never the reference's."""
    from hyperion_tpu_torch.serve.replica import ReplicaHandle
    from hyperion_tpu_torch.serve.router import build_parser, replica_argv

    args = build_parser().parse_args(["--ckpt", "m.npz"])
    argv = replica_argv(args, ReplicaHandle.under(tmp_path, 0))
    assert argv[1:4] == ["-m", "hyperion_tpu_torch.cli.main", "serve"]
    assert "hyperion_tpu.cli.main" not in argv
    assert argv[argv.index("--device") + 1] == "cuda"
