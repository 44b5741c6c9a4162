"""Deterministic fault injection for engine dispatches.

Counterpart of the JAX package's `serving/faults.py` (host code, copied
so the port imports nothing of that package). The recovery claims of the
serving layer (a failed dispatch leaves a clean engine, the page pool,
prefix cache and slot allocator stay consistent, suspended rows survive)
are only worth anything if tests can make dispatches fail at chosen
points. `FaultInjector` is that seam: every engine dispatch calls
`engine._fault_point(program)` (a no-op until an injector is attached to
`engine.faults`), and the injector fails or stalls the Nth dispatch of a
named program, deterministically.

The engines fire the point inside their state-rebuild `try`, before the
dispatch touches the slot state, so an injected failure takes the path a
real CUDA error would: the state (and, paged, the page tables) is rebuilt
clean, and the batcher retries or fails the requests in flight. Dispatch
counting includes warmup dispatches: attach the injector after warmup so
rule indices count serving traffic only.

The program names are the JAX engines': "generate:<shape>", "prefill",
"admit_hit", "resume", "chunk", "release", "harvest", "decode_pixels",
"preview". `crash_nth` aborts the process at the Nth dispatch (a replica
dying mid-request as an OOM-killed container would); the serve twin arms
it from `DALLE_SERVE_CRASH=program:nth` for restart drills under the
supervisor (`serving/supervisor.py`). `corrupt_cache` truncates or
garbles a compile-cache artifact on disk the Nth time the cache is about
to read it (`utils/compile_cache.py` calls `on_artifact_load` before
every read), which must end in a counted reject, never a failed boot.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional


class InjectedFault(RuntimeError):
    """The deliberate failure a fail-Nth rule raises."""


class FaultInjector:
    """Fail or stall the Nth dispatch of a named engine program.

    Rules are one-shot and deterministic: `fail_nth("chunk", 3)` raises
    `InjectedFault` on the third chunk dispatch after attachment and never
    again; `stall_nth("prefill", 1, seconds=2)` sleeps inside the first
    prefill dispatch, then lets it proceed. `fired` records every rule
    that triggered.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        # program -> {nth: rule}; one rule per (program, nth)
        self._rules: Dict[str, Dict[int, dict]] = {}
        # artifact-load rules count in their own namespace: cache reads
        # are boot-time events, not dispatches
        self._cache_counts: Dict[str, int] = {}
        self._cache_rules: Dict[str, Dict[int, dict]] = {}
        self.fired: List[dict] = []

    def _add(self, program: str, nth: int, rule: dict) -> "FaultInjector":
        if nth < 1:
            raise ValueError(f"nth counts dispatches from 1, got {nth}")
        with self._lock:
            self._rules.setdefault(program, {})[int(nth)] = rule
        return self

    def fail_nth(self, program: str, nth: int, exc: Optional[BaseException] = None) -> "FaultInjector":
        return self._add(program, nth, {"kind": "fail", "exc": exc})

    def stall_nth(self, program: str, nth: int, seconds: float = 0.0, until=None) -> "FaultInjector":
        """Stall the Nth dispatch of `program`: `seconds` of sleep, or until
        `until` (a `threading.Event`) is set, with `seconds` (default 120)
        bounding that wait."""
        if seconds < 0:
            raise ValueError(f"a stall of {seconds} s")
        return self._add(program, nth, {"kind": "stall", "seconds": float(seconds), "until": until})

    def crash_nth(self, program: str, nth: int, exit_code: int = 70) -> "FaultInjector":
        """Hard process abort at the Nth dispatch of `program`. `_abort` is
        the seam: unit tests override it; real chaos lets it `os._exit`."""
        return self._add(program, nth, {"kind": "crash", "exit_code": int(exit_code)})

    def corrupt_cache(self, artifact: str, nth: int = 1, mode: str = "truncate") -> "FaultInjector":
        """Truncate (`mode="truncate"`: a torn write) or garble (`"garble"`:
        flipped payload bytes, the length kept) the named compile-cache
        artifact the Nth time the cache is about to read it (attach the
        injector as `CompileCache.faults`)."""
        if nth < 1:
            raise ValueError(f"nth counts artifact reads from 1, got {nth}")
        if mode not in ("truncate", "garble"):
            raise ValueError(f"mode must be 'truncate' or 'garble', got {mode!r}")
        with self._lock:
            self._cache_rules.setdefault(artifact, {})[int(nth)] = {"kind": "corrupt_cache", "mode": mode}
        return self

    def dispatches(self, program: str) -> int:
        with self._lock:
            return self._counts.get(program, 0)

    def _abort(self, program: str, nth: int, exit_code: int) -> None:
        """The crash rule's exit: `os._exit`, so no atexit hook, drain or
        socket flush runs (overridable so tests observe the call)."""
        import os
        import sys

        print(
            f"[faults] crash rule fired: {program} dispatch #{nth} -> os._exit({exit_code})",
            file=sys.stderr, flush=True,
        )
        os._exit(exit_code)

    def on_dispatch(self, program: str) -> None:
        """Called by the engine at every dispatch of `program`: raises for a
        fail rule, sleeps for a stall rule, aborts the process for a crash
        rule, counts and returns otherwise."""
        with self._lock:
            n = self._counts.get(program, 0) + 1
            self._counts[program] = n
            rule = self._rules.get(program, {}).pop(n, None)
            if rule is not None:
                self.fired.append({"program": program, "nth": n, **rule})
        if rule is None:
            return
        if rule["kind"] == "stall":
            if rule["until"] is not None:
                rule["until"].wait(rule["seconds"] or 120.0)
            else:
                time.sleep(rule["seconds"])
            return
        if rule["kind"] == "crash":
            self._abort(program, n, rule["exit_code"])
            return  # only reachable with a stubbed _abort
        exc = rule["exc"]
        if exc is None:
            exc = InjectedFault(f"injected failure: {program} dispatch #{n}")
        raise exc

    def on_artifact_load(self, artifact: str, path) -> None:
        """Called by `CompileCache` before it reads `artifact` at `path`. A
        matching corrupt_cache rule changes the file on disk (a missing
        file stays missing: that is a miss, not a reject), then the read
        goes on into the validator."""
        with self._lock:
            n = self._cache_counts.get(artifact, 0) + 1
            self._cache_counts[artifact] = n
            rule = self._cache_rules.get(artifact, {}).pop(n, None)
            if rule is not None:
                self.fired.append({"artifact": artifact, "nth": n, **rule})
        if rule is None:
            return
        try:
            raw = path.read_bytes()
        except FileNotFoundError:
            return
        if rule["mode"] == "truncate":
            path.write_bytes(raw[: max(1, len(raw) // 2)])
        else:  # flip a run of bytes mid-file, keeping the length
            mid = len(raw) // 2
            garbled = bytearray(raw)
            for i in range(mid, min(mid + 16, len(garbled))):
                garbled[i] ^= 0xFF
            path.write_bytes(bytes(garbled))
