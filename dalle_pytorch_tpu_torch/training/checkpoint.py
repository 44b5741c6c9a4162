"""Reader for the reference's single-file checkpoint (numpy only).

The format is the JAX package's `training/checkpoint.py:save_params_npz`:
an `.npz` whose keys are '/'-joined parameter paths, plus a
`__metadata__` entry holding JSON.
"""

from __future__ import annotations

import json

import numpy as np


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
