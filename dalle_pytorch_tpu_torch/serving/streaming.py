"""Per-request event streams for streamed generation (SSE).

Counterpart of the JAX package's `serving/streaming.py` (host code,
copied so the port imports nothing of that package). The decode loop
advances in `chunk_tokens`-token chunks with a host snapshot at every
boundary; this module turns those boundaries into Server-Sent-Events:

  * `RequestStream`: one bounded, absolutely-sequenced event channel per
    streamed request. The continuous batcher's worker is the only writer
    (progress at every chunk boundary, a preview every `preview_every`
    chunks); the reader is whoever serves the client. Events carry the
    request-level chunk index (the least decode position across the
    request's rows, in chunks), with a monotonic high water, so a request
    that re-decodes from position 0 replays silently: a reader never sees
    a duplicated or regressing chunk.
  * `StreamRegistry`: request key -> live stream. A re-dispatched request
    re-attaches to its live stream; attachment is generational, so a
    superseded reader knows it was replaced.
  * the wire codec: `encode_sse` (writer) and the incremental `SSEParser`
    (reader).

Pixels ride events as arrays; encoding them is the reader's work, never
the worker's.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

#: SSE comment line the writer emits on idle timeouts so proxies and
#: clients can distinguish "decode is slow" from "connection is dead"
KEEPALIVE = b": keep-alive\n\n"

#: event types a stream can carry; terminal types end the stream
TERMINAL_TYPES = ("result", "error", "migrated")


def encode_sse(etype: str, data: Dict[str, Any],
               seq: Optional[int] = None) -> bytes:
    """One SSE frame: optional `id:` (the absolute event sequence — a
    re-attaching client resumes with `Last-Event-ID`), `event:`, one
    `data:` line of compact JSON, blank-line terminator."""
    lines = []
    if seq is not None:
        lines.append(f"id: {int(seq)}")
    lines.append(f"event: {etype}")
    lines.append(
        "data: " + json.dumps(data, separators=(",", ":"), sort_keys=True)
    )
    return ("\n".join(lines) + "\n\n").encode("utf-8")


class SSEParser:
    """Incremental SSE decoder for the router's stream splice: feed raw
    socket bytes, collect completed `(etype, data, seq)` frames. Comment
    lines (keep-alives) are dropped; `data:` lines accumulate per the
    SSE spec and parse as JSON at frame end. Single-threaded by design —
    one parser per upstream connection, owned by the proxying handler."""

    def __init__(self):
        self._buf = b""
        self._etype: Optional[str] = None
        self._data: List[str] = []
        self._seq: Optional[int] = None

    def feed(self, chunk: bytes) -> List[Tuple[str, dict, Optional[int]]]:
        self._buf += chunk
        out: List[Tuple[str, dict, Optional[int]]] = []
        while b"\n" in self._buf:
            line, self._buf = self._buf.split(b"\n", 1)
            text = line.decode("utf-8", errors="replace").rstrip("\r")
            if not text:  # blank line: frame boundary
                if self._etype is not None or self._data:
                    try:
                        data = json.loads("\n".join(self._data) or "{}")
                    except ValueError:
                        data = {"raw": "\n".join(self._data)}
                    out.append((self._etype or "message", data, self._seq))
                self._etype, self._data, self._seq = None, [], None
                continue
            if text.startswith(":"):
                continue  # comment / keep-alive
            field, _, value = text.partition(":")
            value = value[1:] if value.startswith(" ") else value
            if field == "event":
                self._etype = value
            elif field == "data":
                self._data.append(value)
            elif field == "id":
                try:
                    self._seq = int(value)
                except ValueError:
                    self._seq = None
        return out


class RequestStream:
    """Per-request event channel between the batcher worker (writer) and
    the SSE handler thread that owns the client socket (reader).

    Lock discipline: every mutable field is guarded by `_cond`'s lock;
    `emit`/`finish` are called from the worker thread only, reader-side
    methods from whichever handler thread currently holds the attachment
    generation. Events keep ABSOLUTE sequence numbers even after the
    bounded buffer trims its prefix, so a re-attaching reader's
    `Last-Event-ID` cursor stays meaningful across the trim."""

    def __init__(
        self,
        key: Optional[str],
        trace_id: Optional[str] = None,
        max_events: int = 1024,
    ):
        self.key = key
        self.trace_id = trace_id
        self.created_at = time.monotonic()
        self._cond = threading.Condition()
        self._events: List[Tuple[int, str, dict]] = []
        self._base = 0  # absolute seq of _events[0]
        self._dropped = 0
        self.max_events = max(8, int(max_events))
        self._finished = False
        self._woken = False  # a wake not yet seen by the reader
        self._gen = 0  # reader attachment generation
        self._orphaned = False  # current reader's socket died
        # monotonic high-water marks: request-level chunk indices already
        # emitted — a non-resume re-decode replays below them silently
        self._progress_chunk = -1
        self._preview_chunk = -1
        self.previews_sent = 0
        self.reattaches = 0
        self.events_emitted = 0
        #: the GenRequest this stream narrates (set by
        #: `ContinuousBatcher.submit`)
        self.request = None

    # ------------------------------------------------------- writer side

    def emit(self, etype: str, **data) -> bool:
        """Append one event (worker thread). Returns False when the
        stream already finished (late boundary after a terminal)."""
        with self._cond:
            if self._finished:
                return False
            self._append(etype, data)
            return True

    def progress(self, chunk: int, **data) -> bool:
        """Chunk-boundary progress, deduplicated: only a chunk index
        ABOVE the high water emits (re-decoded chunks after a restart
        replay silently — readers never see a duplicate)."""
        with self._cond:
            if self._finished or chunk <= self._progress_chunk:
                return False
            self._progress_chunk = int(chunk)
            self._append("progress", dict(data, chunk=int(chunk)))
            return True

    def preview_due(self, chunk: int, every: int) -> bool:
        """Would a preview at `chunk` emit? (worker asks BEFORE paying
        the snapshot + preview dispatch for this request's rows)."""
        with self._cond:
            return (
                not self._finished
                and every > 0
                and chunk > 0
                and chunk % every == 0
                and chunk > self._preview_chunk
            )

    def preview(self, chunk: int, **data) -> bool:
        with self._cond:
            if self._finished or chunk <= self._preview_chunk:
                return False
            self._preview_chunk = int(chunk)
            self.previews_sent += 1
            self._append("preview", dict(data, chunk=int(chunk)))
            return True

    def finish(self, etype: str, **data) -> bool:
        """Terminal event; exactly one wins (the resolving handler and a
        re-attached handler may race here)."""
        with self._cond:
            if self._finished:
                return False
            self._append(etype, data)
            self._finished = True
            return True

    def wake(self) -> None:
        """Nudge the reader without an event (its request's future
        resolved): its `next_events` returns at once, empty, so it can
        write the terminal event. Sticky: a wake before the reader waits
        ends that wait. (The reference's `wake` only notifies, so a reader
        sleeps out its keep-alive timeout before finishing.)"""
        with self._cond:
            self._woken = True
            self._cond.notify_all()

    def _append(self, etype: str, data: dict) -> None:
        # caller holds the lock
        self._events.append((self._base + len(self._events), etype, data))
        self.events_emitted += 1
        if len(self._events) > self.max_events:
            trim = len(self._events) - self.max_events
            self._events = self._events[trim:]
            self._base += trim
            self._dropped += trim
        self._cond.notify_all()

    # ------------------------------------------------------- reader side

    def attach(self, mark_reattach: bool = True) -> int:
        """Claim the stream for this reader; any previous reader's
        generation is superseded (it exits without cancelling)."""
        with self._cond:
            self._gen += 1
            self._orphaned = False
            if self._gen > 1 and mark_reattach:
                self.reattaches += 1
            self._cond.notify_all()
            return self._gen

    def current(self, gen: int) -> bool:
        with self._cond:
            return gen == self._gen

    def orphan(self, gen: int) -> bool:
        """Reader's socket died. True when it was still the CURRENT
        reader (caller then cancels the request — a superseded reader
        must never cancel the request its successor is streaming)."""
        with self._cond:
            if gen != self._gen:
                return False
            self._orphaned = True
            return True

    @property
    def orphaned(self) -> bool:
        with self._cond:
            return self._orphaned

    @property
    def finished(self) -> bool:
        with self._cond:
            return self._finished

    def next_events(
        self, since: int, timeout: Optional[float] = None
    ) -> Tuple[List[Tuple[int, str, dict]], bool]:
        """Events with seq >= `since` (after the trim floor), blocking up
        to `timeout` for the first one. Returns (events, finished-and-
        drained) — an empty batch with False means keep-alive time."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                start = max(int(since), self._base)
                batch = self._events[start - self._base:]
                drained = self._finished and not batch
                if batch or drained:
                    return list(batch), drained
                if self._woken:
                    self._woken = False
                    return [], False
                if deadline is not None:
                    remain = deadline - time.monotonic()
                    if remain <= 0:
                        return [], False
                    self._cond.wait(remain)
                else:
                    self._cond.wait()

    def end_seq(self) -> int:
        with self._cond:
            return self._base + len(self._events)

    def detail(self) -> dict:
        """healthz / debug snapshot."""
        with self._cond:
            return {
                "key": self.key,
                "trace_id": self.trace_id,
                "events": self.events_emitted,
                "dropped": self._dropped,
                "previews_sent": self.previews_sent,
                "reattaches": self.reattaches,
                "progress_chunk": self._progress_chunk,
                "finished": self._finished,
                "orphaned": self._orphaned,
                "age_s": round(time.monotonic() - self.created_at, 3),
            }


class StreamRegistry:
    """Request-key → live `RequestStream` map (one per server). Keyed by
    the router's content key (`x-dalle-request-key`), the fleet-wide
    join identity — a re-dispatched request re-attaches here instead of
    double-submitting. Bounded: past `max_streams`, finished/orphaned
    streams evict oldest-first; live attached streams are never evicted —
    a registry full of live streams refuses new registrations instead,
    which the server surfaces as backpressure (503)."""

    def __init__(self, max_streams: int = 256, gauge=None):
        self._lock = threading.Lock()
        self._streams: Dict[str, RequestStream] = {}
        self.max_streams = max(1, int(max_streams))
        self._gauge = gauge  # streams_active gauge setter (optional)
        self.total_opened = 0
        self.total_reattached = 0

    def _set_gauge(self) -> None:
        # caller holds the lock
        if self._gauge is not None:
            try:
                self._gauge(len(self._streams))
            except Exception:
                pass

    def register(self, stream: RequestStream) -> bool:
        """Add a fresh stream under its key (anonymous streams — no
        request key — are tracked under a synthetic id so the gauge and
        healthz still see them). False when the registry is full of
        LIVE streams (caller sheds)."""
        key = stream.key or f"anon-{id(stream):x}"
        stream.key = key
        with self._lock:
            self._evict_locked()
            if len(self._streams) >= self.max_streams:
                return False
            self._streams[key] = stream
            self.total_opened += 1
            self._set_gauge()
            return True

    def get(self, key: Optional[str]) -> Optional[RequestStream]:
        if not key:
            return None
        with self._lock:
            return self._streams.get(key)

    def reattach(self, key: Optional[str]) -> Optional[RequestStream]:
        """The live (unfinished) stream for `key`, if any — the caller
        then `attach()`es, stealing the reader generation."""
        if not key:
            return None
        with self._lock:
            st = self._streams.get(key)
            if st is None or st.finished:
                return None
            self.total_reattached += 1
            return st

    def discard(self, stream: RequestStream) -> None:
        with self._lock:
            key = stream.key
            if key is not None and self._streams.get(key) is stream:
                del self._streams[key]
                self._set_gauge()

    def _evict_locked(self) -> None:
        if len(self._streams) < self.max_streams:
            return
        dead = sorted(
            (
                (st.created_at, key)
                for key, st in self._streams.items()
                if st.finished or st.orphaned
            ),
        )
        for _, key in dead:
            if len(self._streams) < self.max_streams:
                break
            del self._streams[key]
        self._set_gauge()

    def active(self) -> int:
        with self._lock:
            return len(self._streams)

    def detail(self, limit: int = 8) -> dict:
        """/healthz streaming block: counts plus the oldest few streams'
        snapshots (bounded so a busy server's health body stays small)."""
        with self._lock:
            streams = sorted(
                self._streams.values(), key=lambda s: s.created_at
            )
            opened, reattached = self.total_opened, self.total_reattached
        return {
            "active": len(streams),
            "opened_total": opened,
            "reattached_total": reattached,
            "max_streams": self.max_streams,
            "streams": [s.detail() for s in streams[:limit]],
        }
