"""Checkpoint interchange with the JAX package.

`load_gathered` reads the `.npz` that the JAX trainers write with
`hyperion_tpu/checkpoint/io.py:export_gathered` — `np.savez` of the
param tree flattened with `/`-joined keys — back into the nested dict
of numpy arrays, without flax. `export_gathered` writes the same file
from a nested dict (e.g. `models.transformer_lm.params_to_jax`), so the
JAX package's `load_gathered` reads the port's exports. The train-state
checkpoints (orbax in the reference) and their integrity manifests wait
for ROADMAP A7.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


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
