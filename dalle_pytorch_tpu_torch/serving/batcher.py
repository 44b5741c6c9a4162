"""Continuous batcher: token-boundary admission over a `ContinuousEngine`'s
cache slots.

Counterpart of the core of the JAX package's `serving/batcher.py:
ContinuousBatcher`. A worker thread runs, while there is work:

    admit   pop queued requests whole (all of a request's pending rows or
            none) into free slots, and prefill them in waves of the
            engine's `prefill_batch`; rows carrying a resume prefix go
            through the engine's `resume_slots` when it `supports_resume`;
    chunk   advance every live slot by `chunk_tokens` (`step_chunk`);
    stream  at the chunk boundary, progress events for streamed requests
            and, every `preview_every` chunks, one shared preview decode;
    retire  harvest the rows that completed `image_seq_len` tokens, decode
            their pixels, release their slots and resolve each request
            whose rows are all done.

A request arriving mid-decode waits at most one chunk to be admitted, and
freed slots are refilled while other rows are still decoding. An engine
with a block pool (`PagedContinuousEngine`: `admission_headroom`,
`admission_demand`, `can_ever_admit`) also gates on KV pages: a request
whose pages do not fit stays queued until releases return them, one that
could never fit is rejected at submit, and each wave's prefix hits are
pinned (`protect_admission_wave`) across its `prefill_batch` splits. An
engine error fails the requests in flight and leaves the worker serving.

Decode-state migration (`serving/migrate.py`): `migrate_out` exports
every queued and in-flight request as a `RequestCheckpoint` at the next
chunk boundary and fails its future with `MigratedError`;
`peek_checkpoints` takes the same snapshot and lets the requests decode
on; `submit(resume=...)` installs a checkpoint (finished rows restored
verbatim, unfinished ones continuing from their position on an engine
with `supports_resume`, from 0 otherwise, to the same tokens) and queues
the request first; with a `spool`, a crash beacon journals the in-flight
checkpoints every `spool_every` chunks. The counters carry the JAX
package's names (`dalle_serving_decoded_tokens_total`, ...) in
`registry`. Not ported yet: QoS classes and tenants, deadline shedding,
cancellation and preemption, tracing, and the HTTP server.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from dalle_pytorch_tpu_torch.serving.engine import SampleSpec, SlotAllocator
from dalle_pytorch_tpu_torch.serving.migrate import (
    CheckpointCorrupt,
    CheckpointMismatch,
    MigratedError,
    RequestCheckpoint,
    RowCheckpoint,
    decode_checkpoint,
    encode_checkpoint,
    from_wire,
    to_wire,
)
from dalle_pytorch_tpu_torch.training.metrics import MetricsRegistry


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
        self._callbacks: List = []

    def add_done_callback(self, fn) -> None:
        """Run `fn()` once the future resolves (at once if it has).
        Callbacks must not block; their errors are swallowed."""
        self._callbacks.append(fn)
        if self._event.is_set():
            fn()

    def _notify(self) -> None:
        for fn in list(self._callbacks):
            try:
                fn()
            except Exception:
                pass

    def set_result(self, result) -> None:
        self._result = result
        self._event.set()
        self._notify()

    def set_exception(self, exc: BaseException) -> None:
        self._exception = exc
        self._event.set()
        self._notify()

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
        self.future = _Future()
        self.enqueued_at = time.monotonic()
        self.first_token_at: Optional[float] = None
        #: rows a checkpoint restored complete: never decoded again
        self.resume_tokens: Dict[int, np.ndarray] = {}
        #: generated-so-far tokens of the checkpoint's unfinished rows: a
        #: resumed row's final tokens start with exactly this prefix
        self.preempt_snapshots: Dict[int, np.ndarray] = {}
        # migration identity (serving/migrate.py)
        self.priority = "normal"
        self.tenant = ""
        self.request_key: Optional[str] = None
        self.migrated = False
        self.migrated_from: Optional[str] = None
        self.resumed_at_chunk: Optional[int] = None
        self.checkpoint_bytes: Optional[int] = None
        self._migrate_counted = False
        #: the streamed request's `serving/streaming.RequestStream`, or None
        self.stream = None

    @property
    def rows(self) -> int:
        return len(self.specs)

    @property
    def pending_rows(self) -> int:
        """Rows still to decode (the rows a checkpoint completed take no
        slot)."""
        return len(self.specs) - len(self.resume_tokens)

    def pending_row_specs(self) -> List:
        """(row index, spec) of every row still to decode."""
        return [(i, s) for i, s in enumerate(self.specs) if i not in self.resume_tokens]

    def apply_resume(self, checkpoint: RequestCheckpoint, nbytes: Optional[int] = None) -> None:
        """Install a decode-state checkpoint as this request's resume
        state: finished rows go to `resume_tokens` (restored verbatim),
        unfinished rows' prefixes to `preempt_snapshots` and to their
        spec's `resume_tokens` / `resume_pos` (an engine with resume
        support continues them there; others decode from 0, to the same
        tokens). The caller has validated the checkpoint against this
        request (`ContinuousBatcher.validate_resume`)."""
        for row in checkpoint.rows:
            i = int(row.row_index)
            if not 0 <= i < len(self.specs):
                continue
            toks = np.asarray(row.tokens, np.int32)
            if row.done:
                self.resume_tokens[i] = toks
            elif len(toks):
                self.preempt_snapshots[i] = toks
                self.specs[i] = dataclasses.replace(
                    self.specs[i], resume_tokens=toks, resume_pos=len(toks)
                )
        self.migrated = True
        self.migrated_from = checkpoint.site
        self.resumed_at_chunk = int(checkpoint.chunk_index)
        self.checkpoint_bytes = nbytes


def _unique_requests(reqs) -> List[GenRequest]:
    """First-seen-order dedup by identity (a request of several rows owns
    several slots)."""
    return list(dict.fromkeys(reqs))


def _finish_stream(req: GenRequest) -> None:
    """The streamed request's one terminal event, from its resolved
    future: "result" (tokens), "migrated" (the wire checkpoint) or
    "error"."""
    stream = req.stream
    try:
        tokens, pixels = req.future.result(timeout=0)
    except MigratedError as exc:
        cp = exc.checkpoint
        data = dict(resumed_at_chunk=int(cp.chunk_index), migrated_from=cp.site)
        if cp.encoded is not None:
            data["checkpoint"] = to_wire(cp.encoded)
        stream.finish("migrated", **data)
        return
    except Exception as exc:
        stream.finish("error", error=f"generation failed: {exc}")
        return
    stream.finish(
        "result",
        num_images=req.rows,
        tokens=np.asarray(tokens).tolist(),
        shape=None if pixels is None else list(np.asarray(pixels).shape),
    )


class ContinuousBatcher:
    """Admission, chunking and retirement over `engine`'s slots (anything
    with the `ContinuousEngine` slot surface: `max_batch`,
    `prefill_batch`, `image_seq_len`, `prefill_slots`, `step_chunk`,
    `harvest`, `release`, `decode_pixels`; migration and streaming also
    use `snapshot_rows`, `supports_resume` / `resume_slots`,
    `chunk_index`, `chunk_tokens` and `preview_pixels` where the engine
    has them). At most `max_queue_rows` rows wait in the queue.

    `registry` (a `training/metrics.MetricsRegistry`, a fresh one by
    default) receives the counters; `spool` (a `migrate.CheckpointSpool`)
    arms the crash beacon every `spool_every` chunks; `preview_every`
    sets the preview cadence of streamed requests (0: progress only).
    Exported checkpoints carry `checkpoint_fingerprint`, the engine's
    `resume_fingerprint()` when it has one."""

    def __init__(
        self,
        engine,
        max_queue_rows: int = 64,
        registry: Optional[MetricsRegistry] = None,
        spool=None,
        spool_every: int = 8,
        preview_every: int = 4,
    ):
        self.engine = engine
        self.max_batch = int(engine.max_batch)
        self.max_queue_rows = int(max_queue_rows)
        self.allocator = SlotAllocator(self.max_batch)
        self.registry = MetricsRegistry() if registry is None else registry
        self.spool = spool
        self.spool_every = max(1, int(spool_every))
        self.preview_every = max(0, int(preview_every))
        fingerprint = getattr(engine, "resume_fingerprint", None)
        #: build identity stamped into exported checkpoints
        self.checkpoint_fingerprint = fingerprint() if callable(fingerprint) else "unfingerprinted"
        #: exporting replica identity (a checkpoint's `site`)
        self.checkpoint_site: Optional[str] = None
        #: the last beacon ({"ts", "chunk_index", "checkpoints": {key: wire}})
        self.last_beacon: Optional[dict] = None
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
        # worker-owned (the migration export reads them at a boundary)
        self._inflight: dict = {}  # slot -> (request, row index)
        self._partial: dict = {}  # request -> {"tokens": [rows], "remaining": n}
        self._slot_pos: dict = {}  # slot -> decode position at the last boundary
        self._last_img_pos: Optional[np.ndarray] = None
        self._migrate_request: Optional[dict] = None
        p = "dalle_serving"
        reg = self.registry
        self._m_decoded = reg.counter(
            f"{p}_decoded_tokens_total",
            "image tokens decoded by chunk dispatches (re-decoded work after a "
            "failover counts again)",
        )
        self._m_resumed = reg.counter(
            f"{p}_resumed_tokens_total",
            "image tokens restored from migrated decode-state checkpoints (work "
            "not re-decoded)",
        )
        self._m_migrated = reg.counter(
            f"{p}_migrated_out_total",
            "requests exported as decode-state checkpoints at a chunk boundary",
        )
        self._m_resumptions = reg.counter_family(
            f"{p}_resumptions_total",
            "suspended or migrated requests re-admitted into slots, by reason",
            label_name="reason",
        )
        self._m_resume_rejects = reg.counter_family(
            f"{p}_resume_rejects_total",
            "resume checkpoints refused (mismatch, corrupt, inconsistent); the "
            "request restarted at position 0",
            label_name="reason",
        )
        self._m_admitted = reg.counter(f"{p}_admitted_total", "rows admitted into cache slots")
        self._m_images = reg.counter(f"{p}_images_total", "images completed")
        self._m_errors = reg.counter(f"{p}_engine_errors_total", "failed engine dispatches")
        self._m_ttft = reg.histogram(
            f"{p}_ttft_seconds", "enqueue-to-first-token latency per request (chunk boundaries)"
        )
        self._m_ttfp = reg.histogram(
            f"{p}_ttfp_seconds",
            "enqueue-to-first-preview latency per streamed request (chunk boundaries)",
        )
        self._m_chunk_seconds = reg.histogram(f"{p}_chunk_seconds", "engine wall time per decode chunk")
        self._m_stream_events = reg.counter_family(
            f"{p}_stream_events_total", "stream events emitted, by type", label_name="type"
        )
        self._m_boundary_failures = reg.counter_family(
            f"{p}_boundary_failures_total",
            "best-effort chunk-boundary work that failed without touching decode "
            "(preview, spool), by kind",
            label_name="kind",
        )
        #: the last such failure, for a stall report
        self.last_boundary_error: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, name="continuous-batcher", daemon=True)
        self._worker.start()

    # -------------------------------------------------------------- intake

    def validate_resume(self, wire, specs):
        """Decode and check one checkpoint (wire text or blob) against this
        build's fingerprint and the request's specs. Returns
        (RequestCheckpoint, size in bytes), or (None, None) after
        counting the refusal by reason in
        `dalle_serving_resume_rejects_total` ("mismatch": another build;
        "corrupt"; "inconsistent": rows, prompts or sampling parameters
        that are not this request's): the caller then submits without
        it, a clean restart at position 0."""

        def reject(reason: str):
            self._m_resume_rejects.labels(reason).inc()
            return None, None

        try:
            blob = from_wire(wire) if isinstance(wire, str) else bytes(wire)
            cp = decode_checkpoint(blob, self.checkpoint_fingerprint)
        except CheckpointMismatch:
            return reject("mismatch")
        except CheckpointCorrupt:
            return reject("corrupt")
        if len(cp.rows) != len(specs):
            return reject("inconsistent")
        seq = int(self.engine.image_seq_len)
        seen = set()
        for row in cp.rows:
            i = int(row.row_index)
            if not 0 <= i < len(specs) or i in seen:
                return reject("inconsistent")
            seen.add(i)
            spec, n = specs[i], len(row.tokens)
            same = (
                np.array_equal(np.asarray(row.prompt_ids, np.int32), np.asarray(spec.text_ids, np.int32))
                and int(row.seed) == int(spec.seed)
                and float(row.temperature) == float(spec.temperature)
                and float(row.top_k) == float(spec.top_k)
            )
            if not same or (row.done and n != seq) or (not row.done and n >= seq):
                return reject("inconsistent")
        return cp, len(blob)

    def submit(
        self,
        specs: Sequence[SampleSpec],
        request_key: Optional[str] = None,
        resume: Optional[RequestCheckpoint] = None,
        resume_bytes: Optional[int] = None,
        stream=None,
    ) -> GenRequest:
        """Enqueue one request and return it (`req.future.result()` gives
        its tokens and pixels). `resume`, a checkpoint validated against
        these specs (`validate_resume`), installs a migrated request's
        decode state; it is queued first, and only its pending rows
        count against slots, pages and the queue. `stream` (a
        `streaming.RequestStream`) receives the chunk-boundary events and
        the terminal one. Raises `QueueFullError` when the request has
        more rows than the engine has slots (or pages) or the queue would
        overflow, and `ShuttingDownError` after `shutdown`."""
        req = GenRequest(specs)
        req.request_key = request_key
        if resume is not None:
            req.apply_resume(resume, nbytes=resume_bytes)
        if stream is not None:
            req.stream = stream
            stream.request = req
            req.future.add_done_callback(lambda: _finish_stream(req))
        with self._cond:
            if self._closed:
                raise ShuttingDownError("batcher is shutting down")
            if req.pending_rows > self.max_batch:
                raise QueueFullError(
                    f"request of {req.pending_rows} rows exceeds the engine's {self.max_batch} slots"
                )
            can_ever = getattr(self.engine, "can_ever_admit", None)
            if can_ever is not None and not can_ever([s for _, s in req.pending_row_specs()]):
                raise QueueFullError(
                    f"request of {req.pending_rows} rows exceeds the engine's KV block pool capacity"
                )
            if self._queued_rows + req.pending_rows > self.max_queue_rows:
                raise QueueFullError(
                    f"queue full ({self._queued_rows}/{self.max_queue_rows} rows)"
                )
            if resume is not None:
                # it waited (and decoded) once already, elsewhere
                self._queue.appendleft(req)
            else:
                self._queue.append(req)
            self._queued_rows += req.pending_rows
            self._cond.notify_all()
        return req

    @property
    def inflight_rows(self) -> int:
        """Rows decoding in cache slots now."""
        return self.allocator.n_active

    # -------------------------------------------------------------- worker

    def _run(self) -> None:
        inflight, partial = self._inflight, self._partial
        headroom = getattr(self.engine, "admission_headroom", None)
        wave_guard = getattr(self.engine, "protect_admission_wave", None)
        resumes = bool(getattr(self.engine, "supports_resume", False))
        while True:
            if self._migrate_request is not None:
                # the last chunk dispatch has returned: a chunk boundary
                self._serve_migration(inflight, partial)
                continue
            admitted = []  # (slot, spec) owed a prefill or resume
            restored = []  # requests a checkpoint completed
            with self._cond:
                while not self._queue and not inflight and self._migrate_request is None:
                    if self._closed:
                        return
                    self._cond.wait()
                if self._migrate_request is not None:
                    continue
                # whole requests in arrival order, while their pending rows
                # (and, paged, their pages) fit. Pages move only at prefill
                # and release, on this thread, so one headroom snapshot
                # serves the whole wave and each request's demand is summed
                # once
                budget = headroom() if headroom is not None else 0
                wave_demand = 0
                while self._queue and self.allocator.n_free >= self._queue[0].pending_rows:
                    head = self._queue[0]
                    pend = head.pending_row_specs()
                    if headroom is not None and pend:
                        need = self.engine.admission_demand([s for _, s in pend])
                        if wave_demand + need > budget:
                            break  # stays queued until releases return pages
                        wave_demand += need
                    self._queue.popleft()
                    self._queued_rows -= head.pending_rows
                    if head.migrated and not head._migrate_counted:
                        # the work this engine does not decode again: the
                        # finished rows, and the prefixes it resumes
                        head._migrate_counted = True
                        self._m_resumptions.labels("migrate").inc()
                        saved = sum(len(t) for t in head.resume_tokens.values())
                        if resumes:
                            saved += sum(int(s.resume_pos or 0) for _, s in pend)
                        self._m_resumed.inc(saved)
                    if not pend:
                        restored.append(head)
                        continue
                    partial[head] = {
                        "tokens": [head.resume_tokens.get(i) for i in range(head.rows)],
                        "remaining": len(pend),
                    }
                    for i, spec in pend:
                        slot = self.allocator.alloc()
                        inflight[slot] = (head, i)
                        # decoded-token accounting starts at the resume
                        # position where the engine restores the prefix
                        self._slot_pos[slot] = int(spec.resume_pos or 0) if resumes else 0
                        admitted.append((slot, spec))
                    self._m_admitted.inc(len(pend))
                if not admitted and not inflight and not restored:
                    # the head waits for pages that no live row holds (the
                    # prefix cache's): nothing to decode, so wait
                    self._cond.wait(0.01)
                    continue
            if restored:
                self._complete_restored(restored)
            if not admitted and not inflight:
                continue
            try:
                self._admit(admitted, resumes, wave_guard)
                t0 = time.monotonic()
                img_pos, _active = self.engine.step_chunk()
                self._m_chunk_seconds.observe(time.monotonic() - t0)
                self.chunks += 1
                now = time.monotonic()
                finished = []
                for slot, (req, _i) in inflight.items():
                    if req.first_token_at is None and img_pos[slot] > 0:
                        req.first_token_at = now
                        self._m_ttft.observe(now - req.enqueued_at)
                    cur = int(img_pos[slot])
                    if cur > self._slot_pos.get(slot, 0):
                        self._m_decoded.inc(cur - self._slot_pos.get(slot, 0))
                        self._slot_pos[slot] = cur
                    if cur >= self.engine.image_seq_len:
                        finished.append(slot)
                self._last_img_pos = img_pos
                # before _retire: the final boundary's progress event still
                # sees the finished rows' slots
                self._emit_stream_events(inflight, img_pos, now)
                if finished:
                    self._retire(finished, inflight, partial)
                if self.spool is not None and self.chunks % self.spool_every == 0:
                    self._maybe_beacon(inflight)
            except Exception as exc:
                self._fail_all(exc, inflight, partial)

    def _admit(self, admitted, resumes: bool, wave_guard) -> None:
        """Prefill (or resume) one admission wave in `prefill_batch`
        splits."""
        if not admitted:
            return
        wave = max(1, int(self.engine.prefill_batch))
        if resumes:
            resume_wave = [(s, sp) for s, sp in admitted if sp.resume_pos]
            fresh = [(s, sp) for s, sp in admitted if not sp.resume_pos]
        else:
            resume_wave, fresh = [], admitted
        # the wave was budgeted against one headroom snapshot: its prefix
        # hits stay pinned across all of its splits
        keys = wave_guard(fresh) if wave_guard is not None and fresh else None
        try:
            for i in range(0, len(fresh), wave):
                self.engine.prefill_slots(fresh[i : i + wave])
                self.prefill_waves += 1
        finally:
            if keys:
                self.engine.unprotect_admission_wave(keys)
        for i in range(0, len(resume_wave), wave):
            self.engine.resume_slots(resume_wave[i : i + wave])
            self.prefill_waves += 1
        self.admitted_rows += len(admitted)

    def _retire(self, finished, inflight, partial) -> None:
        """Harvest finished slots, free them, and resolve the requests whose
        rows are all done (one pixel decode for all of them)."""
        tokens = self.engine.harvest(finished)
        self.engine.release(finished)
        done = []  # (request, stacked token rows)
        for slot, row in zip(finished, tokens):
            req, idx = inflight.pop(slot)
            self.allocator.free(slot)
            self._slot_pos.pop(slot, None)
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
            self._m_images.inc(req.rows)
            req.future.set_result((toks, pix))
        self.last_error = None

    def _complete_restored(self, reqs) -> None:
        """Requests whose every row a checkpoint completed: resolved with
        one pixel decode each, no slot, no chunk."""
        for req in reqs:
            toks = np.stack([np.asarray(req.resume_tokens[i], np.int32) for i in range(req.rows)])
            try:
                pixels = self.engine.decode_pixels(toks)
            except Exception as exc:
                self._record_error(exc)
                req.future.set_exception(exc)
                continue
            now = time.monotonic()
            req.first_token_at = now
            self._m_ttft.observe(now - req.enqueued_at)
            self.images += req.rows
            self._m_images.inc(req.rows)
            req.future.set_result((toks, pixels))
            self.last_error = None

    def _record_error(self, exc: BaseException) -> None:
        self.last_error = exc
        self.errors += 1
        self._m_errors.inc()

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
        self._slot_pos.clear()
        try:
            self.engine.release(range(self.max_batch))
        except Exception:
            pass

    # ------------------------------------------------ streaming (boundary)

    def _emit_stream_events(self, inflight, img_pos, now) -> None:
        """Chunk-boundary events of streamed requests (worker thread): a
        progress event per request, keyed by its request-level chunk index
        (the least position of its rows in flight, in chunks; the
        stream's high water swallows replays), and for the requests whose
        index reached a `preview_every` multiple one shared
        `snapshot_rows` read and one `preview_pixels` decode. A preview
        failure drops this boundary's previews and touches no decode."""
        per_req: dict = {}
        for slot, (req, idx) in inflight.items():
            if req.stream is not None:
                per_req.setdefault(req, []).append((slot, idx))
        if not per_req:
            return
        chunk_tokens = max(1, int(getattr(self.engine, "chunk_tokens", 1)))
        seq = int(self.engine.image_seq_len)
        due = []  # (request, chunk index, {slot: position}, {row: slot})
        for req, rows in per_req.items():
            info = self._partial.get(req)
            done_rows = sum(1 for t in (info["tokens"] if info else ()) if t is not None)
            positions = {slot: int(img_pos[slot]) for slot, _ in rows}
            chunk = min(positions.values()) // chunk_tokens
            if req.stream.progress(
                chunk,
                tokens=sum(positions.values()) + done_rows * seq,
                total_tokens=req.rows * seq,
                rows=req.rows,
                slots=sorted(positions),
            ):
                self._m_stream_events.labels("progress").inc()
            if req.stream.preview_due(chunk, self.preview_every):
                due.append((req, chunk, positions, {idx: slot for slot, idx in rows}))
        previewer = getattr(self.engine, "preview_pixels", None)
        snap_fn = getattr(self.engine, "snapshot_rows", None)
        if not due or previewer is None or snap_fn is None or not getattr(
            self.engine, "preview_enabled", True
        ):
            return
        try:
            slots = sorted(s for _, _, positions, _ in due for s in positions)
            snap = dict(zip(slots, snap_fn(slots)))
            toks, pos, layout = [], [], []
            for req, chunk, positions, slot_of in due:
                info = self._partial.get(req)
                order = []
                for i in range(req.rows):
                    slot = slot_of.get(i)
                    if slot is not None:
                        toks.append(np.asarray(snap[slot], np.int32))
                        pos.append(positions[slot])
                    elif info is not None and info["tokens"][i] is not None:
                        toks.append(np.asarray(info["tokens"][i], np.int32))  # finished earlier
                        pos.append(seq)
                    else:
                        continue
                    order.append(i)
                layout.append((req, chunk, order))
            pixels = previewer(np.stack(toks), np.asarray(pos, np.int64))
        except Exception as exc:  # this boundary's previews are lost, the decode is not
            self._boundary_failure("preview", exc)
            return
        if pixels is None:
            return
        offset = 0
        for req, chunk, order in layout:
            pix = pixels[offset : offset + len(order)]
            offset += len(order)
            first = req.stream.previews_sent == 0
            if req.stream.preview(chunk, rows=list(order), pixels=np.asarray(pix)):
                self._m_stream_events.labels("preview").inc()
                if first:
                    self._m_ttfp.observe(now - req.enqueued_at)

    # ------------------------------------------- migration (chunk boundary)

    def migrate_out(self, timeout_s: float = 30.0):
        """Export every queued and in-flight request's decode-state
        checkpoint at the next chunk boundary, fail each one's future with
        `MigratedError` (carrying its checkpoint, encoded once under
        `checkpoint_fingerprint`) and free the slots. Returns the list of
        `RequestCheckpoint`s, or None when the worker reached no boundary
        within `timeout_s` (nothing was exported)."""
        return self._request_export(destructive=True, timeout_s=timeout_s)

    def peek_checkpoints(self, timeout_s: float = 30.0):
        """`migrate_out`'s snapshot without the export: the requests keep
        decoding here, the caller gets a copy of their state."""
        return self._request_export(destructive=False, timeout_s=timeout_s)

    def _request_export(self, destructive: bool, timeout_s: float):
        deadline = time.monotonic() + float(timeout_s)
        ev = threading.Event()
        pend = {"event": ev, "out": [], "destructive": bool(destructive)}
        # exports serialize: a later caller waits out the earlier one
        while True:
            with self._cond:
                if self._migrate_request is None:
                    self._migrate_request = pend
                    self._cond.notify_all()
                    break
                other = self._migrate_request["event"]
            if not other.wait(max(0.0, deadline - time.monotonic())):
                return None
        if not ev.wait(max(0.0, deadline - time.monotonic())):
            # the worker is stuck in a chunk: withdraw the request if it is
            # still ours (the worker claims it under the lock, so a
            # withdrawn export is never half-served)
            with self._cond:
                if self._migrate_request is pend:
                    self._migrate_request = None
                    ev.set()
                    return None
            return pend["out"] if ev.wait(5.0) else None
        return pend["out"]

    def _serve_migration(self, inflight, partial) -> None:
        """Worker thread, at a chunk boundary. Destructive: pop every
        queued request, snapshot every in-flight row, release the slots
        and fail the futures with `MigratedError`. Otherwise build the
        same checkpoints and touch nothing."""
        with self._cond:
            pend = self._migrate_request
            self._migrate_request = None
            if pend is None:
                return
            queued = list(self._queue)
            if pend["destructive"]:
                self._queue.clear()
                self._queued_rows = 0
        live = _unique_requests(req for req, _ in inflight.values())
        cps = self._collect_checkpoints(live + queued, inflight, "drain")
        if pend["destructive"]:
            slots = list(inflight)
            if slots:
                try:
                    self.engine.release(slots)
                except Exception:
                    pass  # a failed dispatch rebuilt a clean engine state
                for slot in slots:
                    inflight.pop(slot)
                    self.allocator.free(slot)
                    self._slot_pos.pop(slot, None)
            for req in live + queued:
                partial.pop(req, None)
                self._m_migrated.inc()
                cp = cps[req]
                try:
                    cp.encoded = encode_checkpoint(cp, self.checkpoint_fingerprint)
                except Exception:
                    cp.encoded = None
                req.future.set_exception(MigratedError(cp))
        pend["out"] = [cps[r] for r in live + queued]
        pend["event"].set()

    def _collect_checkpoints(self, reqs, inflight, reason: str) -> dict:
        """Worker thread, chunk boundary only: one `RequestCheckpoint` per
        request, from host bookkeeping plus one `snapshot_rows` read of
        all the rows in flight."""
        img_pos = self._last_img_pos
        wanted = {id(r) for r in reqs}
        slot_of = {(id(r), idx): slot for slot, (r, idx) in inflight.items()}
        live_slots = [s for s, (r, _) in inflight.items() if id(r) in wanted]
        snap: dict = {}
        if live_slots:
            snap_fn = getattr(self.engine, "snapshot_rows", self.engine.harvest)
            snap = dict(zip(live_slots, snap_fn(live_slots)))
        chunk_index = int(getattr(self.engine, "chunk_index", self.chunks))
        out: dict = {}
        for req in reqs:
            info = self._partial.get(req)
            rows = []
            for i, spec in enumerate(req.specs):
                done_toks = None
                if info is not None and info["tokens"][i] is not None:
                    done_toks = info["tokens"][i]
                elif i in req.resume_tokens:
                    done_toks = req.resume_tokens[i]
                if done_toks is not None:
                    toks, done = np.asarray(done_toks, np.int32), True
                else:
                    slot = slot_of.get((id(req), i))
                    if slot is not None and slot in snap:
                        pos = max(0, int(img_pos[slot])) if img_pos is not None else 0
                        toks = np.asarray(snap[slot][:pos], np.int32)
                    else:  # a queued row: at most the prefix it arrived with
                        toks = np.asarray(req.preempt_snapshots.get(i, np.zeros(0, np.int32)), np.int32)
                    done = False
                rows.append(RowCheckpoint(
                    row_index=i,
                    prompt_ids=np.asarray(spec.text_ids, np.int32),
                    tokens=toks,
                    done=done,
                    seed=int(spec.seed),
                    temperature=float(spec.temperature),
                    top_k=float(spec.top_k),
                ))
            out[req] = RequestCheckpoint(
                rows=rows,
                chunk_index=chunk_index,
                priority=req.priority,
                tenant=req.tenant,
                site=self.checkpoint_site,
                request_key=req.request_key,
                reason=reason,
            )
        return out

    def _maybe_beacon(self, inflight) -> None:
        """Crash beacon (every `spool_every` chunks): journal every
        in-flight request's checkpoint to the spool in one atomic rewrite
        and keep the wire bundle as `last_beacon`. A spool write failure
        never stops decode."""
        live = _unique_requests(req for req, _ in inflight.values())
        cps = self._collect_checkpoints(live, inflight, "beacon")
        bundle, wires = {}, {}
        for req, cp in cps.items():
            key = cp.request_key or f"local-{id(req):x}"
            bundle[key] = encode_checkpoint(cp, self.checkpoint_fingerprint)
            wires[key] = to_wire(bundle[key])
        self.last_beacon = {
            "ts": time.time(),
            "chunk_index": int(getattr(self.engine, "chunk_index", self.chunks)),
            "checkpoints": wires,
        }
        try:
            self.spool.write(bundle)
        except OSError as exc:  # a full or lost disk must not stop decode
            self._boundary_failure("spool", exc)

    def _boundary_failure(self, kind: str, exc: BaseException) -> None:
        self._m_boundary_failures.labels(kind).inc()
        self.last_boundary_error = exc

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
                    self._queued_rows -= req.pending_rows
                    req.future.set_exception(ShuttingDownError("batcher shutting down"))
            self._cond.notify_all()
        self._worker.join(timeout=timeout)
