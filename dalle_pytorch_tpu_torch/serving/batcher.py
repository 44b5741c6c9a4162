"""Continuous batcher: token-boundary admission over a `ContinuousEngine`'s
cache slots.

Counterpart of the core of the JAX package's `serving/batcher.py:
ContinuousBatcher`. A worker thread runs, while there is work:

    admit   pop queued requests whole (all of a request's rows or none)
            into free slots, and prefill them in waves of the engine's
            `prefill_batch`;
    chunk   advance every live slot by `chunk_tokens` (`step_chunk`);
    retire  at the chunk boundary, harvest the rows that completed
            `image_seq_len` tokens, decode their pixels, release their
            slots and resolve each request whose rows are all done.

A request arriving mid-decode waits at most one chunk to be admitted, and
freed slots are refilled while other rows are still decoding. An engine
with a block pool (`PagedContinuousEngine`: `admission_headroom`,
`admission_demand`, `can_ever_admit`) also gates on KV pages: a request
whose pages do not fit stays queued until releases return them, one that
could never fit is rejected at submit, and each wave's prefix hits are
pinned (`protect_admission_wave`) across its `prefill_batch` splits. An
engine error fails the requests in flight and leaves the worker serving. Not
ported yet: QoS classes and tenants, deadline shedding, preemption,
streaming, migration, tracing and metrics, and the HTTP server.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from dalle_pytorch_tpu_torch.serving.engine import SampleSpec, SlotAllocator


class QueueFullError(RuntimeError):
    """The bounded queue is at capacity, or a request has more rows than
    the engine has slots: rejected, not buffered."""


class RequestTimeout(RuntimeError):
    """No result within the caller's timeout."""


class ShuttingDownError(RuntimeError):
    """The batcher no longer accepts work."""


class _Future:
    """Minimal thread-safe one-shot result slot."""

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._exception: Optional[BaseException] = None

    def set_result(self, result) -> None:
        self._result = result
        self._event.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exception = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """(tokens [rows, image_seq_len] int32, pixels [rows, H, W, 3] or
        None), or the request's error."""
        if not self._event.wait(timeout):
            raise RequestTimeout("timed out waiting for the generation result")
        if self._exception is not None:
            raise self._exception
        return self._result


class GenRequest:
    """One client request: rows that are admitted together and resolved
    together (e.g. several samples of one prompt)."""

    def __init__(self, specs: Sequence[SampleSpec]):
        if not specs:
            raise ValueError("a request needs at least one sample row")
        self.specs: List[SampleSpec] = list(specs)
        self.rows = len(self.specs)
        self.future = _Future()
        self.enqueued_at = time.monotonic()
        self.first_token_at: Optional[float] = None


class ContinuousBatcher:
    """Admission, chunking and retirement over `engine`'s slots (anything
    with the `ContinuousEngine` slot surface: `max_batch`,
    `prefill_batch`, `image_seq_len`, `prefill_slots`, `step_chunk`,
    `harvest`, `release`, `decode_pixels`). At most `max_queue_rows`
    rows wait in the queue."""

    def __init__(self, engine, max_queue_rows: int = 64):
        self.engine = engine
        self.max_batch = int(engine.max_batch)
        self.max_queue_rows = int(max_queue_rows)
        self.allocator = SlotAllocator(self.max_batch)
        self._queue: collections.deque = collections.deque()
        self._queued_rows = 0
        self._cond = threading.Condition()
        self._closed = False
        self.last_error: Optional[BaseException] = None
        # plain counters
        self.admitted_rows = 0
        self.prefill_waves = 0
        self.chunks = 0
        self.images = 0
        self.errors = 0
        self._worker = threading.Thread(target=self._run, name="continuous-batcher", daemon=True)
        self._worker.start()

    # -------------------------------------------------------------- intake

    def submit(self, specs: Sequence[SampleSpec]) -> GenRequest:
        """Enqueue one request and return it (`req.future.result()` gives
        its tokens and pixels). Raises `QueueFullError` when it has more
        rows than the engine has slots or the queue would overflow, and
        `ShuttingDownError` after `shutdown`."""
        req = GenRequest(specs)
        with self._cond:
            if self._closed:
                raise ShuttingDownError("batcher is shutting down")
            if req.rows > self.max_batch:
                raise QueueFullError(
                    f"request of {req.rows} rows exceeds the engine's {self.max_batch} slots"
                )
            can_ever = getattr(self.engine, "can_ever_admit", None)
            if can_ever is not None and not can_ever(req.specs):
                raise QueueFullError(
                    f"request of {req.rows} rows exceeds the engine's KV block pool capacity"
                )
            if self._queued_rows + req.rows > self.max_queue_rows:
                raise QueueFullError(
                    f"queue full ({self._queued_rows}/{self.max_queue_rows} rows)"
                )
            self._queue.append(req)
            self._queued_rows += req.rows
            self._cond.notify_all()
        return req

    @property
    def inflight_rows(self) -> int:
        """Rows decoding in cache slots now."""
        return self.allocator.n_active

    # -------------------------------------------------------------- worker

    def _run(self) -> None:
        inflight: dict = {}  # slot -> (request, row index)
        partial: dict = {}  # request -> {"tokens": [rows], "remaining": n}
        headroom = getattr(self.engine, "admission_headroom", None)
        wave_guard = getattr(self.engine, "protect_admission_wave", None)
        while True:
            admitted = []  # (slot, spec) owed a prefill this iteration
            with self._cond:
                while not self._queue and not inflight:
                    if self._closed:
                        return
                    self._cond.wait()
                # whole requests in arrival order, while their rows (and,
                # paged, their pages) fit. Pages move only at prefill and
                # release, on this thread, so one headroom snapshot serves
                # the whole wave and each request's demand is summed once
                budget = headroom() if headroom is not None else 0
                wave_demand = 0
                while self._queue and self.allocator.n_free >= self._queue[0].rows:
                    if headroom is not None:
                        need = self.engine.admission_demand(self._queue[0].specs)
                        if wave_demand + need > budget:
                            break  # stays queued until releases return pages
                        wave_demand += need
                    req = self._queue.popleft()
                    self._queued_rows -= req.rows
                    partial[req] = {"tokens": [None] * req.rows, "remaining": req.rows}
                    for i, spec in enumerate(req.specs):
                        slot = self.allocator.alloc()
                        inflight[slot] = (req, i)
                        admitted.append((slot, spec))
                if not admitted and not inflight:
                    # the head waits for pages that no live row holds (the
                    # prefix cache's): nothing to decode, so wait
                    self._cond.wait(0.01)
                    continue
            try:
                wave = max(1, int(self.engine.prefill_batch))
                # the wave was budgeted against one headroom snapshot: its
                # prefix hits stay pinned across all of its splits
                keys = wave_guard(admitted) if wave_guard is not None and admitted else None
                try:
                    for i in range(0, len(admitted), wave):
                        self.engine.prefill_slots(admitted[i : i + wave])
                        self.prefill_waves += 1
                finally:
                    if keys:
                        self.engine.unprotect_admission_wave(keys)
                self.admitted_rows += len(admitted)
                img_pos, _active = self.engine.step_chunk()
                self.chunks += 1
                now = time.monotonic()
                finished = []
                for slot, (req, _i) in inflight.items():
                    if req.first_token_at is None and img_pos[slot] > 0:
                        req.first_token_at = now
                    if img_pos[slot] >= self.engine.image_seq_len:
                        finished.append(slot)
                if finished:
                    self._retire(finished, inflight, partial)
            except Exception as exc:
                self._fail_all(exc, inflight, partial)

    def _retire(self, finished, inflight, partial) -> None:
        """Harvest finished slots, free them, and resolve the requests whose
        rows are all done (one pixel decode for all of them)."""
        tokens = self.engine.harvest(finished)
        self.engine.release(finished)
        done = []  # (request, stacked token rows)
        for slot, row in zip(finished, tokens):
            req, idx = inflight.pop(slot)
            self.allocator.free(slot)
            info = partial[req]
            info["tokens"][idx] = row
            info["remaining"] -= 1
            if info["remaining"] == 0:
                del partial[req]
                done.append((req, np.stack(info["tokens"])))
        if not done:
            return
        try:
            pixels = self.engine.decode_pixels(np.concatenate([t for _, t in done]))
        except Exception as exc:
            # only the completing requests are lost; rows still decoding
            # are untouched
            self._record_error(exc)
            for req, _ in done:
                req.future.set_exception(exc)
            return
        offset = 0
        for req, toks in done:
            pix = None if pixels is None else pixels[offset : offset + req.rows]
            offset += req.rows
            self.images += req.rows
            req.future.set_result((toks, pix))
        self.last_error = None

    def _record_error(self, exc: BaseException) -> None:
        self.last_error = exc
        self.errors += 1

    def _fail_all(self, exc, inflight, partial) -> None:
        """An engine failure: fail every request in flight, free every slot
        and reset the engine's slots (best effort) for the next admission."""
        self._record_error(exc)
        for req in partial:
            req.future.set_exception(exc)
        for slot in list(inflight):
            self.allocator.free(slot)
        inflight.clear()
        partial.clear()
        try:
            self.engine.release(range(self.max_batch))
        except Exception:
            pass

    # ------------------------------------------------------------ shutdown

    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop intake. `drain=True` serves every queued and in-flight
        request first; `drain=False` fails the queued ones with
        `ShuttingDownError` (rows in flight still finish)."""
        with self._cond:
            self._closed = True
            if not drain:
                while self._queue:
                    req = self._queue.popleft()
                    self._queued_rows -= req.rows
                    req.future.set_exception(ShuttingDownError("batcher shutting down"))
            self._cond.notify_all()
        self._worker.join(timeout=timeout)
