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
supervisor (`serving/supervisor.py`). Not here: the reference's
compile-cache rule (`corrupt_cache`; the port has no compile cache yet).
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
