"""Worker-thread stacks for the engine-state dump.

The `thread_stacks` part of the JAX package's `obs/vitals.py` (host code,
copied so the port imports nothing of that package): `/debug/state`
carries the batcher worker's Python stack, the first thing to read when a
server stops answering. The vitals sampler, stall watchdog, program cost
table and SLO tracker are not ported yet; the server runs with vitals off,
as the reference's does by default.
"""

from __future__ import annotations

import sys
import threading
import traceback
from typing import Dict, List


def thread_stacks(name_contains: str = "batcher") -> Dict[str, List[str]]:
    """Python stacks of the live threads whose name holds `name_contains`,
    from `sys._current_frames()` (host introspection, safe on any
    thread)."""
    frames = sys._current_frames()
    out: Dict[str, List[str]] = {}
    for t in threading.enumerate():
        if name_contains not in t.name:
            continue
        frame = frames.get(t.ident)
        if frame is not None:
            out[t.name] = [line.rstrip("\n") for line in traceback.format_stack(frame)]
    return out
