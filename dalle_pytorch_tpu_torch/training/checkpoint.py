"""The reference's single-file checkpoint format (numpy only).

The format is the JAX package's `training/checkpoint.py:save_params_npz`:
an `.npz` whose keys are '/'-joined parameter paths, plus a
`__metadata__` entry holding JSON. Written and read here without it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np


def save_params_npz(path: str, params: dict, metadata: Optional[dict] = None) -> None:
    """Write a nested dict of arrays and a JSON metadata dict (numpy
    appends ".npz" to a path without it, as the reference's writer does)."""
    arrays = {}

    def walk(node, prefix):
        for key, val in node.items():
            name = f"{prefix}{key}"
            if isinstance(val, dict):
                walk(val, name + "/")
            else:
                arrays[name] = np.asarray(val)

    walk(params, "")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, __metadata__=json.dumps(metadata or {}), **arrays)


def load_params_npz(path: str):
    """Returns (nested dict of numpy arrays, metadata dict)."""
    with np.load(path, allow_pickle=False) as data:
        metadata = json.loads(str(data["__metadata__"]))
        params: dict = {}
        for key in data.files:
            if key == "__metadata__":
                continue
            node = params
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return params, metadata
