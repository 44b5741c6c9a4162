"""Process-wide record of the port's kernel builds.

Counterpart of the JAX package's `utils/compile_guard.py`, whose events
are XLA compilations. The port compiles nothing per shape: its one-time
cost is each CUDA kernel library that `kernels.py` builds with nvcc or
loads from disk. Each such event is recorded here with the library's
name, its seconds and whether it was built, so

  * `recent_events()` shows them in `/debug/state` (a build on the
    serving path is the port's "unexpected compile");
  * `compile_count()` is the counter the span tracer (`obs/tracing.py`)
    reads at a span's start and end, to attribute the libraries built
    while a span was open (process-wide, like the reference's).

CUDA-graph captures, when the port has them, are events of the same kind.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List

_lock = threading.Lock()
_compile_count = 0
#: the most recent events, bounded so a long-lived process keeps a window
_recent_events: Deque[Dict] = deque(maxlen=32)


def record_build(name: str, seconds: float, built: bool) -> None:
    """Record one kernel library made ready: built by nvcc (`built`) or
    loaded from an earlier build on disk."""
    global _compile_count
    with _lock:
        _compile_count += 1
        _recent_events.append({
            "kernel": str(name),
            "seconds": round(float(seconds), 3),
            "built": bool(built),
            "ts": round(time.time(), 3),
        })


def compile_count() -> int:
    """Kernel libraries made ready so far in this process (a delta source:
    the tracer reads it at a span's start and end)."""
    return _compile_count


def recent_events() -> List[Dict]:
    """The most recent kernel-library events, oldest first."""
    with _lock:
        return list(_recent_events)
