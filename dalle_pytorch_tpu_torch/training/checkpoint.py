"""The reference's single-file checkpoint format (numpy only), and the
trainer's step checkpoints.

The format is the JAX package's `training/checkpoint.py:save_params_npz`:
an `.npz` whose keys are '/'-joined parameter paths, plus a
`__metadata__` entry holding JSON. Written and read here without it.

`CheckpointManager` has the JAX class's interface (`save(step, state,
metadata)`, `restore`, `latest_step`, `keep_n` rotation, `wait`), but
not Orbax's directory format: each step is one such npz,
`<directory>/step_<step>.npz`, holding the state (the trainer's: the
DALLE tree and the optimizer leaves) and the metadata. The state is
copied to the host by the caller; the file is written by a background
thread, to a temporary name and then renamed, so a crash never leaves a
partial checkpoint under a step's name.
"""

from __future__ import annotations

import json
import os
import re
import threading
from pathlib import Path
from typing import Optional

import numpy as np


def _arrays(params: dict) -> dict:
    arrays = {}

    def walk(node, prefix):
        for key, val in node.items():
            name = f"{prefix}{key}"
            if isinstance(val, dict):
                walk(val, name + "/")
            else:
                arrays[name] = np.asarray(val)

    walk(params, "")
    return arrays


def save_params_npz(path: str, params: dict, metadata: Optional[dict] = None) -> None:
    """Write a nested dict of arrays and a JSON metadata dict (numpy
    appends ".npz" to a path without it, as the reference's writer does)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, __metadata__=json.dumps(metadata or {}), **_arrays(params))


def load_params_npz(path: str, skip: tuple = ()):
    """Returns (nested dict of numpy arrays, metadata dict); entries under
    a top-level key in `skip` are not read."""
    with np.load(path, allow_pickle=False) as data:
        metadata = json.loads(str(data["__metadata__"]))
        params: dict = {}
        for key in data.files:
            if key == "__metadata__" or key.split("/", 1)[0] in skip:
                continue
            node = params
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return params, metadata


class CheckpointManager:
    """Numbered step checkpoints in one directory, the newest `keep_n`
    kept (all when None)."""

    _NAME = re.compile(r"step_(\d+)\.npz$")

    def __init__(self, directory: str, keep_n: Optional[int] = None):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step:08d}.npz"

    def steps(self) -> list:
        found = (self._NAME.match(p.name) for p in self.directory.iterdir())
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, state: dict, metadata: Optional[dict] = None) -> None:
        """Write `state` (a nested dict of host arrays) and `metadata` as
        step `step`, in the background; the previous write is waited for
        first."""
        self.wait()
        arrays = _arrays(state)
        meta = json.dumps(metadata or {})

        def write():
            try:
                final = self._path(step)
                tmp = final.with_name(final.name + ".tmp")
                with open(tmp, "wb") as f:
                    np.savez(f, __metadata__=meta, **arrays)
                os.replace(tmp, final)
                if self.keep_n is not None:
                    for old in self.steps()[: -self.keep_n]:
                        self._path(old).unlink(missing_ok=True)
            except Exception as exc:  # raised again by wait()
                self._error = exc

        self._writer = threading.Thread(target=write, name=f"checkpoint-{step}", daemon=True)
        self._writer.start()

    def restore(self, step: Optional[int] = None):
        """(state, metadata, step) of step `step` (the latest when None),
        or (None, None, None) when there is none."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None, None
        state, metadata = load_params_npz(str(self._path(step)))
        return state, metadata, step

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Block until the last write is on disk; raise its error if it
        failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
