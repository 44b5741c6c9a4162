"""Structured JSON logging for the serving path.

Counterpart of the JAX package's `obs/logging.py` (host code, copied so
the port imports nothing of that package). One JSON object per line
(stdout by default): a `request` line per completed request (trace ID,
outcome, HTTP status, latency, per-stage breakdown) plus lifecycle
`event` lines (warmup, drain, shutdown, preemptions, dispatch retries).
The one human-first line is `serve.py`'s `[serve] listening on ...`
readiness line, which orchestrators and tests pattern-match.

Request-line schema (keys always present):

    {"ts": <unix seconds>, "event": "request", "trace_id": str,
     "site": str, "pid": int, "host": str,
     "outcome": "ok" | "rejected" | "shed" | "quota" | "timeout"
               | "migrated" | "quarantined" | "error" | "shutdown" | ...,
     "status": <http code>, "latency_ms": float,
     "stages": {"queue": ms, "prefill": ms, "chunk": ms, ...}}

plus the caller's extra fields. `stages` is empty with tracing off. Every
line carries the process identity `site` / `pid` / `host`.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time
from typing import Dict, Optional

from dalle_pytorch_tpu_torch.obs.aggregate import default_site, sanitize_site


class StructuredLog:
    """Thread-safe JSONL writer. Failures to write never raise into the
    serving path (a closed pipe must not fail a request).

    File-backed mode (`path=`) adds size-capped rotation: once the file
    exceeds `max_mb`, it is renamed to `<path>.1` (replacing any prior
    one — keep-one policy, so disk use is bounded at ~2x the cap) and a
    fresh file is started. Rotation failures are swallowed like write
    failures: a long-lived replica must not fail a request over its own
    log housekeeping."""

    def __init__(self, stream=None, component: str = "dalle.serving",
                 site: Optional[str] = None, path: Optional[str] = None,
                 max_mb: Optional[float] = None):
        if stream is not None and path is not None:
            raise ValueError("pass a stream or a file path, not both")
        self._path = str(path) if path is not None else None
        self._max_bytes = (
            int(float(max_mb) * 1024 * 1024)
            if max_mb is not None and self._path is not None else None
        )
        if self._path is not None:
            stream = open(self._path, "a", encoding="utf-8")
        self._stream = stream if stream is not None else sys.stdout
        self._component = component
        self._lock = threading.Lock()
        # stamped once: identity must be stable across every line this
        # process writes, or downstream joins fracture mid-run
        self._identity = {
            "site": sanitize_site(site) if site else default_site(),
            "pid": os.getpid(),
            # the host through the same clamp as the site
            "host": sanitize_site(socket.gethostname() or "localhost"),
        }

    def _rotate_locked(self) -> None:
        """Caller holds the lock. Rename the full file to `<path>.1`
        (keep one) and start fresh; any failure leaves the current
        stream writable and is retried implicitly at the next cap
        crossing."""
        try:
            self._stream.close()
        except (ValueError, OSError):
            pass
        try:
            os.replace(self._path, self._path + ".1")
        except OSError:
            pass  # rename failed: reopen appends to the oversized file
        try:
            self._stream = open(self._path, "a", encoding="utf-8")
        except OSError:
            # can't reopen (dir vanished?): swallow writes from now on
            # rather than raise into the request path
            self._stream = None

    def _emit(self, record: Dict) -> None:
        record = {**self._identity, **record}
        line = json.dumps(record, default=str)
        try:
            with self._lock:
                if self._stream is None:
                    return
                self._stream.write(line + "\n")
                self._stream.flush()
                if (
                    self._max_bytes is not None
                    and self._stream.tell() >= self._max_bytes
                ):
                    self._rotate_locked()
        except (ValueError, OSError):
            pass  # stream closed mid-shutdown; the request already succeeded

    def event(self, event: str, **fields) -> None:
        """Free-form lifecycle line (warmup, listening, shutdown, ...)."""
        self._emit({
            "ts": round(time.time(), 3),
            "component": self._component,
            "event": event,
            **fields,
        })

    def request(
        self,
        trace_id: str,
        outcome: str,
        status: int,
        latency_ms: float,
        stages: Optional[Dict[str, float]] = None,
        **fields,
    ) -> None:
        """One line per completed (or failed) request."""
        self._emit({
            "ts": round(time.time(), 3),
            "component": self._component,
            "event": "request",
            "trace_id": trace_id,
            "outcome": outcome,
            "status": int(status),
            "latency_ms": round(float(latency_ms), 2),
            "stages": {
                k: round(v * 1000.0, 2) for k, v in (stages or {}).items()
            },
            **fields,
        })
