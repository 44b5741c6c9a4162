"""Cross-process tracing: the `x-dalle-trace` header and the trace exporter.

Counterpart of the JAX package's `obs/aggregate.py` (host code, copied
so the port imports nothing of that package). A caller sends
`x-dalle-trace: <trace_id>[/<parent span uid>]`; the server adopts a valid
one as its request's trace ID (and records the caller's span as the
remote parent), so the caller's spans and the server's join on one ID.
Process identity (`default_site`, `sanitize_site`) is shared with the
structured log; the router parents its dispatch spans with
`format_trace_header` and names them with `span_uid_for`.

`TraceExporter` ships every finished trace of one process to the fleet
collector (`obs/collector.py`) as batched JSONL (`POST /ingest`) from a
background thread. A request thread's `Trace.finish()` does one bounded
append (the oldest trace dropped and counted in
`dalle_obs_export_dropped_total` when the buffer is full) and never
serializes or touches a socket, so serving does not depend on the
collector's health. One wire record a trace, one line each:

    {"schema": 1, "trace_id": str, "site": str, "pid": int, "host": str,
     "run": str, "outcome": str|null, "parent_uid": str|null,
     "spans": [{"sid": int, "parent": int|null, "name": str,
                "t0": unix_s, "t1": unix_s, "args": {...}}]}

`run` is a nonce of the trace instance: the collector dedupes an
exporter's retry on it, and keeps a client's retry that reuses its
header. Timestamps are unix seconds (`Tracer.to_unix`), one axis for
every process.
"""

from __future__ import annotations

import json
import os
import re
import socket
import threading
import time
import urllib.request
from collections import deque
from typing import Dict, List, Optional, Tuple

from dalle_pytorch_tpu_torch.obs.tracing import Span, Trace

#: the one propagation header (http.server looks headers up without case)
TRACE_HEADER = "x-dalle-trace"

SCHEMA_VERSION = 1

_TRACE_ID_RE = re.compile(r"^[0-9a-f]{8,32}$")
_SPAN_UID_RE = re.compile(r"^[A-Za-z0-9_.:\-]{1,128}$")


def format_trace_header(trace_id: str, parent_uid: Optional[str] = None) -> str:
    """`x-dalle-trace` value of an outbound hop: the trace ID, or
    `<trace_id>/<parent_uid>` when the caller has a span for the callee's
    root to parent into."""
    return trace_id if parent_uid is None else f"{trace_id}/{parent_uid}"


def parse_trace_header(value) -> Optional[Tuple[str, Optional[str]]]:
    """Parse an inbound `x-dalle-trace` header into (trace_id, parent_uid).

    Total and strict: None (mint a fresh context) for a missing header, a
    trace ID that is not 8-32 lowercase hex digits, or a span UID that is
    too long or holds other characters."""
    if not value or not isinstance(value, str):
        return None
    trace_id, sep, parent_uid = value.strip().partition("/")
    if not _TRACE_ID_RE.match(trace_id):
        return None
    if not sep:
        return trace_id, None
    if not _SPAN_UID_RE.match(parent_uid):
        return None
    return trace_id, parent_uid


def sanitize_site(site: str) -> str:
    """Clamp a site name to the span-UID alphabet (no '/', spaces or ':'),
    at most 64 characters."""
    return re.sub(r"[^A-Za-z0-9_.\-]", "-", str(site))[:64] or "proc"


def default_site() -> str:
    """The process's default site name: $DALLE_TRACE_SITE, else the
    hostname, sanitized."""
    return sanitize_site(os.environ.get("DALLE_TRACE_SITE") or socket.gethostname() or "proc")


def span_uid_for(site: str, host: str, pid: int, span_id: int) -> str:
    """The span-UID identity format `site:host:pid:span_id`, one
    definition for every producer (host is part of it: two containerized
    replicas sharing a site both run as pid 1)."""
    return f"{site}:{host}:{pid}:{span_id}"


class TraceExporter:
    """Background JSONL shipper from one process's tracer to a collector.

    `TraceExporter(url, site=...).attach(tracer)` starts the thread and
    hooks `Tracer._record`; every finished trace is enqueued (O(1),
    bounded) and shipped in batches of up to `max_batch` traces per POST.
    Transport failures retry with exponential backoff (`backoff_s`
    doubling to `backoff_max_s`, reset on success); the unsent batch goes
    back to the FRONT of the buffer so arrival order survives a retry,
    and whatever the bound then evicts is dropped oldest-first with a
    counter. `stop()` is called at server shutdown and makes one final
    best-effort flush (bounded by the transport timeout).

    The `_post` seam is the only socket touch — tests stub it for
    deterministic backoff/overflow coverage, and `flush()` drives the
    same `_flush_once` the thread runs for synchronous draining.
    """

    def __init__(
        self,
        url: str,
        site: Optional[str] = None,
        registry=None,
        max_buffer: int = 256,
        max_batch: int = 64,
        flush_interval_s: float = 0.5,
        backoff_s: float = 0.5,
        backoff_max_s: float = 30.0,
        timeout_s: float = 2.0,
        thread: bool = True,
    ):
        self.url = str(url).rstrip("/")
        self.site = sanitize_site(site) if site else default_site()
        self.pid = os.getpid()
        # sanitized like site: the host rides inside span UIDs, which
        # must stay within the header codec's alphabet
        self.host = sanitize_site(socket.gethostname() or "localhost")
        self.max_buffer = int(max_buffer)
        self.max_batch = int(max_batch)
        self.flush_interval_s = float(flush_interval_s)
        self.backoff_base_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.timeout_s = float(timeout_s)
        #: thread=False skips the shipper thread entirely — intake and
        #: overflow accounting run unchanged on export(), and callers
        #: drive delivery synchronously via `flush()`/`_flush_once()`.
        #: The deterministic mode tests use so their timing budgets
        #: never ride on thread-scheduling under CPU contention.
        self._thread_enabled = bool(thread)
        self.enabled = True
        self._buf: deque = deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._tracer = None
        # batches popped from the buffer but not yet posted/re-queued:
        # flush() must wait these out — "buffer empty" alone races the
        # shipper thread mid-POST and under-reports delivery
        self._inflight_batches = 0
        # live state the tests (and /debug introspection) read
        self.spans_serialized = 0
        self.traces_sent = 0
        self.posts_sent = 0
        self.dropped = 0
        self.retries = 0
        self.consecutive_failures = 0
        self.current_backoff_s = 0.0
        self.last_error: Optional[str] = None
        self._m_dropped = self._m_sent = self._m_retries = None
        if registry is not None:
            self._m_dropped = registry.counter(
                "dalle_obs_export_dropped_total",
                "finished traces dropped because the export buffer was "
                "full (collector down/slow; serving is unaffected)",
            )
            self._m_sent = registry.counter(
                "dalle_obs_export_traces_total",
                "finished traces shipped to the trace collector",
            )
            self._m_retries = registry.counter(
                "dalle_obs_export_retries_total",
                "export POST failures (each schedules a backoff retry)",
            )

    def __bool__(self) -> bool:
        return True

    # ------------------------------------------------------------ identity

    def span_uid(self, span: Span) -> str:
        """Globally-unique reference for one of THIS process's spans —
        what an outbound `x-dalle-trace` header carries as parent_uid and
        what the collector joins against (`span_uid_for`, the shared
        format definition)."""
        return span_uid_for(self.site, self.host, self.pid, span.span_id)

    def context_header(self, trace: Trace, span: Span) -> str:
        """Ready-to-send `x-dalle-trace` value parenting the callee's
        root into `span` of `trace`."""
        return format_trace_header(trace.trace_id, self.span_uid(span))

    # ----------------------------------------------------------- lifecycle

    def attach(self, tracer) -> "TraceExporter":
        """Hook a tracer's finish path and start the shipper thread."""
        self._tracer = tracer
        tracer.exporter = self
        if self._thread is None and self._thread_enabled:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="dalle-trace-export", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, final_flush: bool = True) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout_s + 5.0)
            self._thread = None
        if final_flush:
            # best-effort FULL drain, not one batch: stop on the first
            # transport failure (a dead collector costs exactly one POST
            # timeout) and bound the healthy-path drain by a deadline so
            # a slow collector cannot wedge shutdown either
            deadline = time.monotonic() + max(self.timeout_s * 4, 5.0)
            while self.buffered and time.monotonic() < deadline:
                if not self._flush_once():
                    break
        if self._tracer is not None and self._tracer.exporter is self:
            from dalle_pytorch_tpu_torch.obs.tracing import NULL_EXPORTER

            self._tracer.exporter = NULL_EXPORTER

    # -------------------------------------------------------------- intake

    def export(self, trace: Trace) -> None:
        """Called from `Trace.finish()` on request threads: ONE bounded
        append, never a socket, never serialization — the serving path
        must be unaffected however sick the collector is."""
        with self._lock:
            if len(self._buf) >= self.max_buffer:
                self._buf.popleft()  # oldest out: fresh traces win
                self.dropped += 1
                if self._m_dropped is not None:
                    self._m_dropped.inc()
            self._buf.append(trace)
            full_batch = len(self._buf) >= self.max_batch
        if full_batch:
            # wake early only when a full batch is ready; otherwise the
            # interval tick ships the partial batch. Waking per trace
            # would turn a 50 req/s replica into 50 POSTs/s of
            # single-trace batches — the batching exists to keep
            # collector socket churn proportional to batches, not
            # fleet request rate.
            self._wake.set()

    @property
    def buffered(self) -> int:
        with self._lock:
            return len(self._buf)

    # ------------------------------------------------------------ shipping

    def serialize_trace(self, trace: Trace) -> Dict:
        """One wire record for one finished trace (exporter thread only).
        `closed_spans()` is the tracer's consistent snapshot; finish()
        already closed every span (abandoned ones included), so the
        snapshot is total for any trace that reaches the exporter."""
        tracer = trace._tracer
        # per-trace-INSTANCE nonce, minted lazily (only exporter-attached
        # traces pay) and cached so an exporter retry re-sends the same
        # value: the collector dedupes on (process, run, sid). Without
        # it, a client retrying a timed-out request with the SAME
        # x-dalle-trace header against the same server would have the
        # second attempt's spans discarded as duplicates of the first
        # (both attempts' span ids start at 0).
        run = getattr(trace, "_export_run", None)
        if run is None:
            import uuid

            run = uuid.uuid4().hex[:8]
            try:
                trace._export_run = run
            except AttributeError:  # exotic trace stand-ins: ship uncached
                pass
        spans: List[Dict] = []
        for s in trace.closed_spans():
            spans.append({
                "sid": s.span_id,
                "parent": s.parent_id,
                "name": s.name,
                "t0": round(tracer.to_unix(s.t0), 6),
                "t1": round(tracer.to_unix(s.t1), 6),
                "args": s.args,
            })
        with self._lock:  # flush() callers run concurrently with the
            self.spans_serialized += len(spans)  # shipper thread
        return {
            "schema": SCHEMA_VERSION,
            "trace_id": trace.trace_id,
            "site": self.site,
            "pid": self.pid,
            "host": self.host,
            "run": run,
            "outcome": trace.outcome,
            "parent_uid": trace.parent_uid,
            "spans": spans,
        }

    def _post(self, body: bytes) -> None:
        """The one socket touch (stubbed in tests): POST the JSONL batch
        to the collector's /ingest. Raises on any transport failure."""
        req = urllib.request.Request(
            self.url + "/ingest",
            data=body,
            headers={"Content-Type": "application/x-ndjson"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            resp.read()

    def _flush_once(self) -> bool:
        """Ship one batch. True when the batch landed (or nothing was
        buffered); False schedules a backoff in the thread loop."""
        with self._lock:
            n = min(len(self._buf), self.max_batch)
            batch = [self._buf.popleft() for _ in range(n)]
            if batch:
                self._inflight_batches += 1
        if not batch:
            return True
        try:
            # default=str like StructuredLog for odd scalar types, plus a
            # per-trace guard for what default= cannot rescue (circular
            # refs): one poisoned trace drops WITH a counter instead of
            # killing the batch — or worse, the shipper thread
            lines, shippable = [], []
            for t in batch:
                try:
                    lines.append(
                        json.dumps(self.serialize_trace(t), default=str)
                    )
                    shippable.append(t)
                except Exception as exc:
                    with self._lock:
                        self.last_error = repr(exc)
                        self.dropped += 1
                    if self._m_dropped is not None:
                        self._m_dropped.inc()
            if not lines:
                return True
            body = ("\n".join(lines) + "\n").encode("utf-8")
            try:
                self._post(body)
            except Exception as exc:
                if self._m_retries is not None:
                    self._m_retries.inc()
                # bookkeeping + requeue under ONE lock hold: flush()
                # callers race the shipper thread on every counter here,
                # and the backoff derivation must read its own increment
                with self._lock:
                    self.last_error = repr(exc)
                    self.retries += 1
                    self.consecutive_failures += 1
                    self.current_backoff_s = min(
                        self.backoff_base_s
                        * (2 ** (self.consecutive_failures - 1)),
                        self.backoff_max_s,
                    )
                    # unsent batch back to the FRONT (arrival order
                    # survives the retry); the bound still holds —
                    # overflow drops oldest-first
                    for trace in reversed(shippable):
                        self._buf.appendleft(trace)
                    dropped_now = 0
                    while len(self._buf) > self.max_buffer:
                        self._buf.popleft()
                        self.dropped += 1
                        dropped_now += 1
                if dropped_now and self._m_dropped is not None:
                    self._m_dropped.inc(dropped_now)
                return False
        finally:
            with self._lock:
                self._inflight_batches -= 1
        with self._lock:
            self.consecutive_failures = 0
            self.current_backoff_s = 0.0
            self.last_error = None
            self.traces_sent += len(shippable)
            self.posts_sent += 1
        if self._m_sent is not None:
            self._m_sent.inc(len(shippable))
        return True

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.flush_interval_s)
            self._wake.clear()
            while not self._stop.is_set():
                try:
                    ok = self._flush_once()
                except Exception as exc:
                    # belt and braces: the shipper thread must NEVER die
                    # — a dead shipper silently turns every future trace
                    # into an overflow drop for the process lifetime
                    self.last_error = repr(exc)
                    break
                if not ok:
                    # backoff on the STOP event so shutdown never waits
                    # out a 30s backoff window
                    self._stop.wait(self.current_backoff_s)
                    continue
                if self.buffered == 0:
                    break

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Synchronously drain the buffer AND wait out batches the
        shipper thread already holds (bench/tests): True only when
        everything enqueued so far has been delivered. Drives the same
        `_flush_once` the thread runs — concurrent calls are safe,
        batches just interleave."""
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            done = self._flush_once()
            with self._lock:
                idle = not self._buf and self._inflight_batches == 0
            if done and idle:
                return True
            time.sleep(min(0.05, self.current_backoff_s or 0.05))
        with self._lock:
            return not self._buf and self._inflight_batches == 0

    # ------------------------------------------------------------- detail

    def detail(self) -> Dict:
        with self._lock:
            # counters are mutated under the lock from both the shipper
            # thread and export() callers — snapshot them coherently
            # (self.buffered would re-acquire the non-reentrant lock, so
            # read the buffer length directly here)
            counters = {
                "buffered": len(self._buf),
                "traces_sent": self.traces_sent,
                "spans_serialized": self.spans_serialized,
                "dropped": self.dropped,
                "retries": self.retries,
                "consecutive_failures": self.consecutive_failures,
            }
        return {
            "url": self.url,
            "site": self.site,
            "pid": self.pid,
            "host": self.host,
            "max_buffer": self.max_buffer,
            **counters,
            "current_backoff_s": self.current_backoff_s,
            "last_error": self.last_error,
        }
