"""Process-wide record of the port's kernel builds, and the guard over them.

Counterpart of the JAX package's `utils/compile_guard.py`, whose events
are XLA compilations. The port compiles nothing per shape: its one-time
cost is each CUDA kernel library that `kernels.py` makes ready, built with
nvcc, loaded from an earlier build on disk, or loaded from an installed
compile cache (`utils/compile_cache.py`). Each such event is recorded
here with the library's name, its seconds and where it came from, so

  * `recent_events()` shows them in `/debug/state` (a build on the
    serving path is the port's "unexpected compile");
  * `compile_count()` is the counter the span tracer (`obs/tracing.py`)
    reads at a span's start and end, to attribute the libraries made
    ready while a span was open (process-wide, like the reference's);
  * `cache_hit_count()` counts the loads from the compile cache, and the
    uncached count the libraries that paid for being made ready while a
    cache was installed: an nvcc build, or a load from outside the cache.
    `track_compiles()` / `assert_no_recompiles()` read them over a block
    (`CompileTally`); the warm-boot contract is `uncached == 0`.

CUDA-graph captures, when the port has them, are events of the same kind.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Iterator, List

#: where a library came from: the compile cache, an earlier build on disk,
#: or an nvcc build of this process
SOURCES = ("cache", "disk", "built")

_lock = threading.Lock()
_compile_count = 0
_cache_hit_count = 0
_uncached_count = 0
#: the most recent events, bounded so a long-lived process keeps a window
_recent_events: Deque[Dict] = deque(maxlen=32)


def record_build(name: str, seconds: float, source: str, cache_installed: bool = False) -> None:
    """Record one kernel library made ready from `source` ("cache",
    "disk" or "built"); `cache_installed` says whether a compile cache was
    installed, which makes a "disk" or "built" library an uncached one."""
    global _compile_count, _cache_hit_count, _uncached_count
    if source not in SOURCES:
        raise ValueError(f"source {source!r} is not one of {SOURCES}")
    with _lock:
        _compile_count += 1
        if source == "cache":
            _cache_hit_count += 1
        elif cache_installed or source == "built":
            _uncached_count += 1
        _recent_events.append({
            "kernel": str(name),
            "seconds": round(float(seconds), 3),
            "built": source == "built",
            "source": source,
            "ts": round(time.time(), 3),
        })


def compile_count() -> int:
    """Kernel libraries made ready so far in this process (a delta source:
    the tracer reads it at a span's start and end)."""
    return _compile_count


def cache_hit_count() -> int:
    """Kernel libraries loaded from the installed compile cache so far."""
    return _cache_hit_count


def uncached_count() -> int:
    """Kernel libraries that paid for being made ready: every nvcc build,
    and every load from outside the cache while one was installed."""
    return _uncached_count


def recent_events() -> List[Dict]:
    """The most recent kernel-library events, oldest first."""
    with _lock:
        return list(_recent_events)


class RecompileError(AssertionError):
    """A guarded region made a kernel library ready."""


@dataclass
class CompileTally:
    """Live view of the kernel-library events inside a guard block."""

    _start: int = 0
    allowed: int = 0
    _start_hits: int = 0
    _start_uncached: int = 0

    @property
    def count(self) -> int:
        return _compile_count - self._start

    @property
    def cache_hits(self) -> int:
        """Libraries in the block loaded from the compile cache."""
        return _cache_hit_count - self._start_hits

    @property
    def uncached(self) -> int:
        """Libraries in the block that paid for being made ready (an nvcc
        build, or a load from outside an installed cache): the warm-boot
        contract pins this at zero on a second boot."""
        return _uncached_count - self._start_uncached

    @property
    def events(self) -> List[Dict]:
        """The block's most recent events (a bounded window: context for
        the error message, not a complete ledger)."""
        return recent_events()[-self.count:] if self.count > 0 else []


def _tally(allowed: int = 0) -> CompileTally:
    with _lock:
        return CompileTally(_compile_count, allowed, _cache_hit_count, _uncached_count)


@contextlib.contextmanager
def track_compiles() -> Iterator[CompileTally]:
    """Count the kernel-library events of a block without asserting."""
    yield _tally()


@contextlib.contextmanager
def assert_no_recompiles(allowed: int = 0) -> Iterator[CompileTally]:
    """Raise `RecompileError` if the block makes more than `allowed` kernel
    libraries ready (default zero: the steady-state contract)."""
    tally = _tally(allowed)
    yield tally
    if tally.count > allowed:
        raise RecompileError(
            f"guarded region made {tally.count} kernel librar{'y' if tally.count == 1 else 'ies'} ready "
            f"(allowed {allowed}): a kernel first launched outside warmup. Recent events: {tally.events}"
        )
