"""Request batching for the serving engines: the `MicroBatcher` and the
`ContinuousBatcher`.

Counterpart of the JAX package's `serving/batcher.py` (host code; the
port keeps its own copy). Requests from many clients wait in a bounded
queue that is weighted-fair over priority classes and tenants
(`serving/qos.py`: a tenant flooding the low class cannot starve other
tenants or classes). One worker thread serves it:

  * `MicroBatcher` flushes a micro-batch to `engine.generate` when either
    `max_batch` rows wait or the oldest request has waited `max_delay_ms`
    (deadline-or-capacity); a request's rows stay in one batch.
  * `ContinuousBatcher` runs admit / chunk / retire over a
    `ContinuousEngine`'s cache slots: whole requests are admitted into
    free slots in waves of the engine's `prefill_batch` (rows carrying a
    resume prefix through `resume_slots` where the engine
    `supports_resume`; an engine with a page pool also gates on pages),
    every live slot advances `chunk_tokens` per chunk, and at each chunk
    boundary finished rows are harvested and their slots refilled.

Overload is explicit:

  * queue full  -> `submit` raises `QueueFullError` (503 + Retry-After at
    the HTTP layer); the bound counts only rows of the request's class or
    better, so a low-class flood refuses itself;
  * over quota  -> a tenant past `tenant_quota_rows` queued rows gets
    `TenantQuotaError` (429);
  * unmeetable  -> (continuous) with `deadline_shed`, a request whose
    estimated completion (from the chunk-wall EMA) exceeds its own
    timeout gets `ShedError` (503) instead of a certain 504;
  * too old     -> a request past its timeout fails with `RequestTimeout`
    when it reaches the head of the queue, or (continuous) at the next
    chunk boundary mid-decode, which releases its slots (`_reap`);
  * cancelled   -> `GenRequest.cancel()` skips a queued request and
    (continuous) retires a decoding one at the next boundary;
  * overloaded  -> (continuous) priority preemption: when the
    scheduler's head is blocked on slots or pages and a lower-class
    request is decoding, the youngest such request is released at the
    chunk boundary and re-queued at the front of its own class. On an
    engine with resume it re-admits at its position through
    `resume_slots`, its prefix snapshotted by `snapshot_rows`; on others
    it decodes again from 0 to the same tokens ((seed, position)-keyed
    noise). `reserve_slots` keeps slots for the high class;
  * engine error-> (continuous) one bounded retry: the failed dispatch
    left the engine's state rebuilt clean, so every request in flight is
    suspended and re-admitted from position 0 (the same tokens); a
    request already retried fails with the error. Each failure mints an
    incident id on the requests in flight (the HTTP layer's 422
    quarantine). A micro-batch fails fast. `last_error` feeds /healthz;
  * shutdown    -> `shutdown(drain=True)` serves what is queued first;
    `drain=False` fails the queue with `ShuttingDownError`.

Decode-state migration (`serving/migrate.py`): `migrate_out` exports every
queued and in-flight request as a `RequestCheckpoint` at the next chunk
boundary and fails its future with `MigratedError`; `peek_checkpoints`
takes the same snapshot and lets the requests decode on; `submit(resume=)`
installs a checkpoint validated by `validate_resume` and queues the
request at the front of its own (class, tenant) queue; with a `spool`, a
crash beacon journals the in-flight checkpoints every `spool_every`
chunks. Streamed requests (`serving/streaming.py`) get progress events at
every chunk boundary and a preview every `preview_every` chunks; their
one terminal event is written by the stream's reader (the HTTP server)
once the future resolves.

Each request's trace (`obs/tracing.py`) gets a span per stage: queue,
prefill, chunk, harvest, preview, preempted (micro: queue, generate), and
`registry` the reference's instruments (`dalle_serving_*`). The
continuous batcher's `slo_burn` hook (the server wires the vitals'
`SLOTracker.max_burn` into it) tightens the deadline shed and switches
the preemption victim to the least-progressed request while an SLO burns
its error budget, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from dalle_pytorch_tpu_torch.obs.tracing import NULL_SPAN, NULL_TRACE
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
from dalle_pytorch_tpu_torch.serving.qos import (
    ShedError,
    TenantQuotaError,
    WeightedFairQueue,
    priority_class,
)
from dalle_pytorch_tpu_torch.training.metrics import MetricsRegistry


class QueueFullError(RuntimeError):
    """The bounded queue is at capacity, or a request could never admit:
    rejected, not buffered. `retry_after_s` carries the batcher's drain
    estimate for a Retry-After header (None without a basis)."""

    retry_after_s: Optional[float] = None


class RequestTimeout(RuntimeError):
    """The request spent longer than its timeout queued or in flight."""


class RequestCancelled(RuntimeError):
    """The client cancelled the request."""


class ShuttingDownError(RuntimeError):
    """The batcher no longer accepts work."""


class _Future:
    """Minimal thread-safe one-shot result slot. Not
    `concurrent.futures.Future`: cancellation here is a flag the worker
    acts on later (`GenRequest.cancel`), and a cancelled stdlib future
    refuses the worker's late `set_exception`."""

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._exception: Optional[BaseException] = None
        self._callbacks: List = []

    def add_done_callback(self, fn) -> None:
        """Run `fn()` once the future resolves (at once if it has).
        Callbacks must be idempotent and must not block; their errors are
        swallowed."""
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
    """One client request: rows admitted together and resolved together
    (several samples of one prompt), with its timeout, trace, priority
    class and tenant."""

    def __init__(
        self,
        specs: Sequence[SampleSpec],
        timeout_s: float = 120.0,
        trace=NULL_TRACE,
        priority: str = "normal",
        tenant: str = "",
    ):
        if not specs:
            raise ValueError("a request needs at least one sample row")
        self.specs: List[SampleSpec] = list(specs)
        self.timeout_s = float(timeout_s)
        self.enqueued_at = time.monotonic()
        self.future = _Future()
        self._cancelled = threading.Event()
        # QoS identity; an unknown priority raises ValueError (HTTP 400)
        self.priority = str(priority)
        self.klass = priority_class(self.priority)
        self.tenant = str(tenant or "")
        #: rows completed before a suspension or restored complete from a
        #: checkpoint: never decoded again
        self.resume_tokens: Dict[int, np.ndarray] = {}
        #: generated-so-far tokens of rows suspended (or migrated)
        #: mid-decode: a resumed row's final tokens start with this prefix
        self.preempt_snapshots: Dict[int, np.ndarray] = {}
        self.preemptions = 0
        self.dispatch_retries = 0
        #: incident ids of the consecutive failed dispatches this request
        #: was in flight for (a successful chunk clears the streak)
        self.incidents: List[str] = []
        #: admission order stamp: preemption releases the youngest victim
        self.admitted_seq: Optional[int] = None
        self._preempt_span = NULL_SPAN
        self._suspend_reason: Optional[str] = None
        # migration identity (serving/migrate.py)
        self.request_key: Optional[str] = None
        self.migrated = False
        self.migrated_from: Optional[str] = None
        self.resumed_at_chunk: Optional[int] = None
        self.checkpoint_bytes: Optional[int] = None
        #: tokens of the checkpoint's unfinished rows (an engine with
        #: resume restores them instead of decoding them)
        self.restored_prefix_tokens = 0
        self._migrate_counted = False
        self.trace = trace
        self._queue_span = trace.begin("queue", rows=len(self.specs))
        self._stage_span = NULL_SPAN
        #: when the first token existed on the host (continuous: the chunk
        #: boundary after admission; micro: the batch's end)
        self.first_token_at: Optional[float] = None
        #: True when every row admitted through the prefix cache (paged
        #: engine); None when the engine reports no admission stats
        self.prefix_hit: Optional[bool] = None
        #: the streamed request's `serving/streaming.RequestStream`, or None
        self.stream = None

    @property
    def rows(self) -> int:
        return len(self.specs)

    @property
    def pending_rows(self) -> int:
        """Rows still to decode: the scheduler's and allocator's unit."""
        return len(self.specs) - len(self.resume_tokens)

    def pending_row_specs(self) -> List:
        """(row index, spec) of every row still to decode."""
        return [(i, s) for i, s in enumerate(self.specs) if i not in self.resume_tokens]

    def _set_resume(self, i: int, prefix: np.ndarray) -> None:
        """Row `i` continues from `prefix` on an engine with resume (others
        decode it from 0, to the same tokens). The spec is replaced, not
        mutated: the caller's spec objects stay as they were."""
        self.specs[i] = dataclasses.replace(self.specs[i], resume_tokens=prefix, resume_pos=len(prefix))

    def apply_resume(self, checkpoint: RequestCheckpoint, nbytes: Optional[int] = None) -> None:
        """Install a decode-state checkpoint: finished rows go to
        `resume_tokens` (restored verbatim), unfinished rows' prefixes to
        `preempt_snapshots` and their spec's resume fields. The caller has
        validated the checkpoint against this request
        (`validate_resume`)."""
        for row in checkpoint.rows:
            i = int(row.row_index)
            if not 0 <= i < len(self.specs):
                continue
            toks = np.asarray(row.tokens, np.int32)
            if row.done:
                self.resume_tokens[i] = toks
            elif len(toks):
                self.preempt_snapshots[i] = toks
                self.restored_prefix_tokens += len(toks)
                self._set_resume(i, toks)
        self.migrated = True
        self.migrated_from = checkpoint.site
        self.resumed_at_chunk = int(checkpoint.chunk_index)
        self.checkpoint_bytes = nbytes

    def cancel(self) -> None:
        """Best effort: a queued request is skipped, a decoding one retired
        at the next chunk boundary; a micro-batch in flight completes."""
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def expired(self, now: float) -> bool:
        return now - self.enqueued_at > self.timeout_s


def _unique_requests(reqs) -> List[GenRequest]:
    """First-seen-order dedup by identity (a request of several rows owns
    several slots)."""
    return list(dict.fromkeys(reqs))


def _first_trace_id(reqs) -> Optional[str]:
    """Exemplar of a shared dispatch: the first traced request's ID."""
    for req in reqs:
        if req.trace:
            return req.trace.trace_id
    return None


class MicroBatcher:
    """Deadline-or-capacity micro-batching over `engine.generate`.

    `engine` needs `.generate(list[SampleSpec]) -> (tokens, pixels)` and,
    unless `max_batch` is given, `.max_batch`. `tenant_quota_rows` caps
    one tenant's queued rows (None: no quota); `class_weights` and
    `tenant_weights` set the weighted-fair shares (`serving/qos.py`);
    `log` (an `obs/logging.StructuredLog`) receives lifecycle events.
    Instruments go to `registry` (a fresh one by default).
    """

    def __init__(
        self,
        engine,
        max_batch: Optional[int] = None,
        max_delay_ms: float = 25.0,
        max_queue_rows: int = 64,
        registry: Optional[MetricsRegistry] = None,
        name: str = "dalle_serving",
        tenant_quota_rows: Optional[int] = None,
        class_weights: Optional[dict] = None,
        tenant_weights: Optional[dict] = None,
        log=None,
    ):
        self.engine = engine
        self.max_batch = int(engine.max_batch if max_batch is None else max_batch)
        engine_cap = getattr(engine, "max_batch", None)
        if self.max_batch < 1 or (engine_cap is not None and self.max_batch > engine_cap):
            raise ValueError(
                f"max_batch={self.max_batch} outside [1, the engine's largest batch {engine_cap}]"
            )
        self.max_delay_s = float(max_delay_ms) / 1000.0
        self.max_queue_rows = int(max_queue_rows)
        self.tenant_quota_rows = None if tenant_quota_rows is None else int(tenant_quota_rows)
        self.log = log
        self._cond = threading.Condition()
        self._queue = WeightedFairQueue(class_weights, tenant_weights)
        #: rows in the worker's hands (micro: popped for the batch being
        #: flushed) - the drain hook
        self._inflight_rows = 0
        self._closed = False
        self.last_error: Optional[BaseException] = None
        self._last_error_at: Optional[float] = None
        self.errors = 0
        self._incident_seq = 0
        fingerprint = getattr(engine, "resume_fingerprint", None)
        #: build identity a resume checkpoint must carry
        self.checkpoint_fingerprint = fingerprint() if callable(fingerprint) else "unfingerprinted"
        self.registry = MetricsRegistry() if registry is None else registry
        self._name = p = name
        reg = self.registry
        self._m_depth = reg.gauge(f"{p}_queue_depth_rows", "request rows waiting in the batcher queue")
        self._m_rejected = reg.counter(f"{p}_rejected_total", "requests rejected because the queue was full")
        self._m_timeouts = reg.counter(f"{p}_timeouts_total", "requests failed by per-request timeout")
        self._m_cancelled = reg.counter(f"{p}_cancelled_total", "requests cancelled by the client")
        self._m_errors = reg.counter(
            f"{p}_engine_errors_total",
            "generation dispatches (flushed batches / slot chunks) failed by an engine exception",
        )
        self._m_requests = reg.counter(f"{p}_requests_total", "requests accepted into the queue")
        self._m_images = reg.counter(f"{p}_images_total", "images generated (batch rows completed)")
        self._m_latency = reg.histogram(f"{p}_request_latency_seconds", "enqueue-to-result latency per request")
        self._m_depth_by_class = reg.gauge_family(
            f"{p}_queue_depth_rows_by_class",
            "request rows waiting in the batcher queue, by priority class",
            label_name="class",
        )
        self._m_shed = reg.counter_family(
            f"{p}_shed_total",
            "requests rejected at admission by the QoS layer, by reason (deadline: the cost "
            "model said the timeout was unmeetable; quota: the tenant was over its quota)",
            label_name="reason",
        )
        self._m_retries = reg.counter(
            f"{p}_dispatch_retries_total",
            "in-flight requests re-admitted after a failed continuous dispatch (one retry each)",
        )
        self._m_resume_rejects = reg.counter_family(
            f"{p}_resume_rejects_total",
            "resume checkpoints refused (mismatch: another build; corrupt; inconsistent: not "
            "this request's rows or sampling) and restarted at position 0",
            label_name="reason",
        )
        #: per-stage wall time, the aggregate of the traces' stage spans
        #: (observed with tracing off too; exemplars carry a trace ID)
        self.stage_seconds = reg.histogram_family(
            f"{p}_stage_seconds",
            "wall time per request stage (queue/prefill/chunk/harvest/preview for the "
            "continuous engine; queue/generate for micro-batches; respond by the HTTP layer)",
            label_name="stage",
        )
        self._post_init()  # the mode's instruments and state exist before the worker runs
        self._worker = threading.Thread(target=self._run, name=f"{name}-batcher", daemon=True)
        self._worker.start()

    def _post_init(self) -> None:
        """The flush path's instruments (`ContinuousBatcher` registers its
        slot path's instead, so neither exposes empty series)."""
        if self.max_queue_rows < self.max_batch:
            raise ValueError(
                f"max_queue_rows={self.max_queue_rows} < max_batch={self.max_batch}: a full "
                "micro-batch could never enqueue"
            )
        reg, p = self.registry, self._name
        occupancy = tuple(float(b) for b in range(1, min(self.max_batch, 32) + 1))
        self._m_batches = reg.counter(f"{p}_batches_total", "micro-batches flushed to the engine")
        self._m_occupancy = reg.histogram(
            f"{p}_batch_occupancy_rows", "real (unpadded) rows per flushed micro-batch", buckets=occupancy
        )
        self._m_batch_seconds = reg.histogram(f"{p}_batch_seconds", "engine wall time per flushed micro-batch")
        self._m_occupancy_by_shape = reg.histogram_family(
            f"{p}_batch_occupancy_rows_by_shape",
            "real rows per flushed micro-batch, by batch shape",
            label_name="shape", buckets=occupancy,
        )
        self._m_batch_seconds_by_shape = reg.histogram_family(
            f"{p}_batch_seconds_by_shape",
            "engine wall time per flushed micro-batch, by batch shape",
            label_name="shape",
        )

    # -------------------------------------------------------------- intake

    def validate_resume(self, wire, specs):
        """Decode and check one checkpoint (wire text or blob) against
        `checkpoint_fingerprint` and the request's specs. Returns
        (RequestCheckpoint, size in bytes), or (None, None) after counting
        the refusal in `dalle_serving_resume_rejects_total` by reason
        ("mismatch", "corrupt", "inconsistent") and logging it: the caller
        then submits without it, a clean restart at position 0."""

        def reject(reason: str, detail: str):
            self._m_resume_rejects.labels(reason).inc()
            if self.log is not None:
                self.log.event("resume_rejected", reason=reason, detail=detail)
            return None, None

        try:
            blob = from_wire(wire) if isinstance(wire, str) else bytes(wire)
            cp = decode_checkpoint(blob, self.checkpoint_fingerprint)
        except CheckpointMismatch as exc:
            return reject("mismatch", str(exc))
        except CheckpointCorrupt as exc:
            return reject("corrupt", str(exc))
        if len(cp.rows) != len(specs):
            return reject("inconsistent", f"{len(cp.rows)} checkpoint rows != {len(specs)} request rows")
        seq = getattr(self.engine, "image_seq_len", None)
        seen = set()
        for row in cp.rows:
            i = int(row.row_index)
            if not 0 <= i < len(specs) or i in seen:
                return reject("inconsistent", f"bad row index {i}")
            seen.add(i)
            spec, n = specs[i], len(row.tokens)
            if not np.array_equal(np.asarray(row.prompt_ids, np.int32), np.asarray(spec.text_ids, np.int32)):
                return reject("inconsistent", f"row {i} prompt differs from the request")
            if (
                int(row.seed) != int(spec.seed)
                or float(row.temperature) != float(spec.temperature)
                or float(row.top_k) != float(spec.top_k)
            ):
                # another sampling identity would not regenerate the prefix
                return reject("inconsistent", f"row {i} sampling parameters differ from the request")
            if seq is not None and ((row.done and n != int(seq)) or (not row.done and n >= int(seq))):
                return reject("inconsistent", f"row {i} holds {n} tokens (done={row.done})")
        return cp, len(blob)

    def submit(
        self,
        specs: Sequence[SampleSpec],
        timeout_s: float = 120.0,
        trace=NULL_TRACE,
        priority: str = "normal",
        tenant: str = "",
        request_key: Optional[str] = None,
        resume: Optional[RequestCheckpoint] = None,
        resume_bytes: Optional[int] = None,
        stream=None,
    ) -> GenRequest:
        """Enqueue one request and return it (`req.future.result()` gives
        its tokens and pixels).

        Raises at once instead of blocking: `QueueFullError` (backpressure,
        or a request that could never admit), `TenantQuotaError`,
        `ShedError` or `ShuttingDownError`. `trace` (`obs/tracing.Trace`)
        receives the stage spans; `priority` ("high" / "normal" / "low")
        and `tenant` feed the weighted-fair queue. `resume`, a checkpoint
        validated against these specs (`validate_resume`), installs a
        migrated request's decode state: it enters at the front of its own
        (class, tenant) queue and only its pending rows count. `stream` (a
        `streaming.RequestStream`) receives the chunk-boundary events."""
        req = GenRequest(specs, timeout_s=timeout_s, trace=trace, priority=priority, tenant=tenant)
        req.request_key = request_key
        if stream is not None:
            req.stream = stream
            stream.request = req
            # whatever resolves the future, the blocked reader wakes to
            # write the terminal event
            req.future.add_done_callback(stream.wake)
        if resume is not None:
            req.apply_resume(resume, nbytes=resume_bytes)
        with self._cond:
            if self._closed:
                raise ShuttingDownError("batcher is shutting down")
            cap = self._admission_cap(req)
            if req.pending_rows > cap:
                # it could never admit, and all-or-nothing admission would
                # block its class behind it forever
                self._m_rejected.inc()
                raise QueueFullError(
                    f"request of {req.pending_rows} rows exceeds max batch {cap} admissible at "
                    f"priority {req.priority!r} (the engine's {self.max_batch} rows or slots, "
                    "less any high-class reserve)"
                )
            can_ever = getattr(self.engine, "can_ever_admit", None)
            if can_ever is not None and not can_ever([s for _, s in req.pending_row_specs()]):
                self._m_rejected.inc()
                raise QueueFullError(
                    f"request of {req.pending_rows} rows exceeds the engine's KV block pool capacity"
                )
            ahead = self._queue.rows_at_or_better(req.klass)
            if ahead + req.pending_rows > self.max_queue_rows:
                self._m_rejected.inc()
                exc = QueueFullError(
                    f"queue full ({ahead}/{self.max_queue_rows} rows at priority {req.priority!r} or better)"
                )
                exc.retry_after_s = self.retry_after_s()
                raise exc
            if self.tenant_quota_rows is not None and (
                self._queue.tenant_rows(req.tenant) + req.pending_rows > self.tenant_quota_rows
            ):
                self._m_shed.labels("quota").inc()
                raise TenantQuotaError(
                    f"tenant {req.tenant!r} already has {self._queue.tenant_rows(req.tenant)} rows "
                    f"queued (quota {self.tenant_quota_rows})",
                    retry_after_s=self.retry_after_s(),
                )
            shed = self._shed_check(req)
            if shed is not None:
                self._m_shed.labels(shed.reason).inc()
                raise shed
            if resume is not None:
                self._queue.push_front(req)  # it waited (and decoded) once already, elsewhere
            else:
                self._queue.push(req)
            self._m_requests.inc()
            self._set_depth_gauges()
            self._cond.notify_all()
        return req

    def retry_after_s(self) -> float:
        """Seconds a refused client should wait: 1 here (no service-time
        model); the continuous batcher estimates the queue's drain."""
        return 1.0

    def _record_error(self, exc: BaseException) -> None:
        """A failed dispatch: /healthz reads `last_error` and its age."""
        self._last_error_at = time.monotonic()  # first: readers check last_error, then its age
        self.last_error = exc
        self.errors += 1
        self._m_errors.inc()

    def _mint_incident(self, reqs, exc: BaseException) -> str:
        """Attribute one failed dispatch to every request in flight for it
        (worker thread only)."""
        self._incident_seq += 1
        inc_id = f"disp-{self._incident_seq:06d}"
        reqs = _unique_requests(reqs)
        for req in reqs:
            req.incidents.append(inc_id)
        if self.log is not None:
            self.log.event("dispatch_incident", incident=inc_id, error=repr(exc), implicated=len(reqs))
        return inc_id

    def _admission_cap(self, req) -> int:
        """The most rows `req` could ever admit with."""
        return self.max_batch

    def _shed_check(self, req) -> Optional[ShedError]:
        """Admission-time deadline shed (None: admit); no cost model here."""
        return None

    def _set_depth_gauges(self) -> None:
        """Caller holds the lock."""
        self._m_depth.set(self._queue.rows)
        for name, rows in self._queue.class_depths().items():
            self._m_depth_by_class.labels(name).set(rows)

    @property
    def queue_depth_rows(self) -> int:
        with self._cond:
            return self._queue.rows

    @property
    def inflight_rows(self) -> int:
        """Rows the engine is serving now (the drain hook)."""
        with self._cond:
            return self._inflight_rows

    @property
    def quiesced(self) -> bool:
        """Nothing queued and nothing in flight: safe to restart."""
        with self._cond:
            return not len(self._queue) and self.inflight_rows == 0

    def class_depths(self) -> Dict[str, int]:
        """{priority class: queued rows}."""
        with self._cond:
            return self._queue.class_depths()

    def head_age_s(self) -> Optional[float]:
        """Age of the oldest queued request (None when empty): the vitals
        sampler's queue-staleness signal."""
        with self._cond:
            oldest = self._queue.oldest_enqueued_at()
        return None if oldest is None else time.monotonic() - oldest

    def state_summary(self) -> dict:
        """Queue-side state for `/debug/state`."""
        with self._cond:
            reqs = self._queue.requests()
            rows = self._queue.rows
            by_class = self._queue.class_depths()
            oldest = self._queue.oldest_enqueued_at()
        out = {
            "queue_requests": len(reqs),
            "queue_depth_rows": rows,
            "queue_depth_by_class": by_class,
            "max_queue_rows": self.max_queue_rows,
            "queue_head_age_s": None if oldest is None else round(time.monotonic() - oldest, 3),
            "queued_trace_ids": [req.trace.trace_id for req in reqs if req.trace][:16],
            "closed": self._closed,
        }
        if self.last_error is not None:
            out["last_error"] = repr(self.last_error)
        return out

    def error_age_s(self) -> Optional[float]:
        """Seconds since the last failed dispatch, None once a dispatch has
        succeeded since: /healthz decays an error instead of latching."""
        if self.last_error is None or self._last_error_at is None:
            return None
        return time.monotonic() - self._last_error_at

    # -------------------------------------------------------------- worker

    def _close_preempt_span(self, req, **kw) -> None:
        """End a suspended request's open `preempted` span, if any."""
        if req._preempt_span is not NULL_SPAN:
            req.trace.end(req._preempt_span, **kw)
            req._preempt_span = NULL_SPAN

    def _viable_head(self, now: float) -> Optional[GenRequest]:
        """The scheduler's next request, not popped, after failing expired
        and dropping cancelled heads (uncharged pops: a dead request used
        no capacity). Caller holds the lock."""
        while True:
            head = self._queue.peek()
            if head is None:
                return None
            if head.cancelled:
                self._queue.pop(charge=False)
                self._m_cancelled.inc()
                self._close_preempt_span(head, outcome="cancelled")
                head.trace.end(head._queue_span, outcome="cancelled")
                self._observe_queue_stage(head, now)
                head.future.set_exception(RequestCancelled("cancelled"))
                continue
            if head.expired(now):
                self._queue.pop(charge=False)
                self._m_timeouts.inc()
                self._close_preempt_span(head, outcome="timeout")
                head.trace.end(head._queue_span, outcome="timeout")
                self._observe_queue_stage(head, now)
                head.future.set_exception(RequestTimeout(f"spent >{head.timeout_s:.1f}s queued; overloaded?"))
                continue
            return head

    def _observe_queue_stage(self, req, now: float) -> None:
        """The queue stage of a request dying queued, unless it observed it
        at an earlier admission (a suspended request's wait is its
        `preempted` span)."""
        if req._suspend_reason is None:
            self.stage_seconds.labels("queue").observe(now - req.enqueued_at, exemplar=req.trace.trace_id or None)

    def _pop_head(self, head: GenRequest) -> None:
        """Pop the request `_viable_head` just returned (caller holds the
        lock; the stride scheduler is deterministic, so it cannot move)."""
        popped = self._queue.pop()
        assert popped is head, "queue mutated between peek and pop"

    def _pop_ready(self, batch: List[GenRequest]) -> None:
        """Move queued requests into `batch` while they fit. Caller holds
        the lock."""
        now = time.monotonic()
        rows = sum(r.rows for r in batch)
        while True:
            head = self._viable_head(now)
            if head is None or rows + head.rows > self.max_batch:
                break
            self._pop_head(head)
            rows += head.rows
            batch.append(head)
            # counted from the pop: the drain predicate must not see an
            # idle batcher while these rows are in the worker's hands
            self._inflight_rows += head.rows
        self._set_depth_gauges()

    def _assemble(self) -> Optional[List[GenRequest]]:
        """Block until a batch is ready (deadline or capacity); None at
        shutdown with nothing left to serve."""
        with self._cond:
            while not len(self._queue):
                if self._closed:
                    return None
                self._cond.wait()
            batch: List[GenRequest] = []
            self._pop_ready(batch)
            if not batch:  # everything queued was expired or cancelled
                return []
            deadline = batch[0].enqueued_at + self.max_delay_s  # from the oldest request
            while sum(r.rows for r in batch) < self.max_batch and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=min(remaining, 0.05))
                self._pop_ready(batch)
            return batch

    def _run(self) -> None:
        while True:
            batch = self._assemble()
            if batch is None:
                return
            if batch:
                try:
                    self._flush(batch)
                finally:
                    with self._cond:
                        self._inflight_rows = 0

    def _flush(self, batch: List[GenRequest]) -> None:
        specs: List[SampleSpec] = [s for req in batch for s in req.specs]
        t0 = time.monotonic()
        for req in batch:
            req.trace.end(req._queue_span)
            self.stage_seconds.labels("queue").observe(t0 - req.enqueued_at, exemplar=req.trace.trace_id or None)
            req._stage_span = req.trace.begin("generate", rows=req.rows, batch_rows=len(specs))
        try:
            tokens, pixels = self.engine.generate(specs)
        except Exception as exc:  # fail fast: every waiter gets the error
            failed_at = time.monotonic()
            self._record_error(exc)
            self._mint_incident(batch, exc)
            self.stage_seconds.labels("generate").observe(failed_at - t0, exemplar=_first_trace_id(batch))
            for req in batch:
                req.trace.end(req._stage_span, error=repr(exc))
                req.future.set_exception(exc)
            return
        self.last_error = None
        self._m_batches.inc()
        self._m_occupancy.observe(len(specs))
        batch_s = time.monotonic() - t0
        self._m_batch_seconds.observe(batch_s)
        pick = getattr(self.engine, "pick_shape", None)
        shape = pick(len(specs)) if pick is not None else len(specs)
        ex = _first_trace_id(batch)
        self._m_occupancy_by_shape.labels(shape).observe(len(specs), exemplar=ex)
        self._m_batch_seconds_by_shape.labels(shape).observe(batch_s, exemplar=ex)
        self.stage_seconds.labels("generate").observe(batch_s, exemplar=ex)
        offset = 0
        now = time.monotonic()
        for req in batch:
            toks = tokens[offset : offset + req.rows]
            pix = None if pixels is None else pixels[offset : offset + req.rows]
            offset += req.rows
            self._m_images.inc(req.rows)
            self._m_latency.observe(now - req.enqueued_at)
            req.trace.end(req._stage_span, shape=shape)
            req.first_token_at = now
            req.future.set_result((toks, pix))

    # ------------------------------------------------------------ shutdown

    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop intake; `drain=True` serves what is queued first,
        `drain=False` fails it with `ShuttingDownError` (rows in flight
        still finish)."""
        with self._cond:
            self._closed = True
            if not drain:
                for req in self._queue.drain():
                    self._close_preempt_span(req, outcome="shutdown")
                    req.trace.end(req._queue_span, outcome="shutdown")
                    self._observe_queue_stage(req, time.monotonic())
                    req.future.set_exception(ShuttingDownError("server shutting down"))
                self._set_depth_gauges()
            self._cond.notify_all()
        self._worker.join(timeout=timeout)


class ContinuousBatcher(MicroBatcher):
    """Admission, chunking and retirement over `engine`'s cache slots.

    `engine` has the `ContinuousEngine` slot surface: `max_batch`,
    `image_seq_len`, `prefill_slots` + `prefill_batch` (or `prefill_slot`),
    `step_chunk`, `harvest`, `release`, `decode_pixels`; preemption,
    migration and streaming also use `snapshot_rows`, `supports_resume` /
    `resume_slots`, `chunk_index`, `chunk_tokens` and `preview_pixels`
    where it has them, and page gating `admission_headroom` /
    `admission_demand` / `can_ever_admit` / `protect_admission_wave`.
    `preempt` turns decode-time preemption on, `deadline_shed` the
    admission shed (both on by default); `reserve_slots` keeps slots for
    the high class. `spool` (`migrate.CheckpointSpool`) arms the crash
    beacon every `spool_every` chunks; `preview_every` sets the preview
    cadence of streamed requests (0: progress only). Exported checkpoints
    carry `checkpoint_fingerprint`, the engine's `resume_fingerprint()`
    when it has one.
    """

    def __init__(
        self,
        engine,
        max_queue_rows: int = 64,
        registry: Optional[MetricsRegistry] = None,
        name: str = "dalle_serving",
        tenant_quota_rows: Optional[int] = None,
        class_weights: Optional[dict] = None,
        tenant_weights: Optional[dict] = None,
        log=None,
        preempt: bool = True,
        deadline_shed: bool = True,
        reserve_slots: int = 0,
        spool=None,
        spool_every: int = 8,
        preview_every: int = 4,
    ):
        self.preview_every = max(0, int(preview_every))
        self.preempt = bool(preempt)
        self.deadline_shed = bool(deadline_shed)
        #: a callable giving the SLO tracker's max burn rate (the server
        #: wires it); above 1 the deadline shed tightens and preemption
        #: evicts the least-progressed victim. None: burn-blind
        self.slo_burn = None
        self.reserve_slots = int(reserve_slots)
        self.spool = spool
        self.spool_every = max(1, int(spool_every))
        if not 0 <= self.reserve_slots < int(engine.max_batch):
            raise ValueError(
                f"reserve_slots={reserve_slots} must leave at least one of {engine.max_batch} "
                "slots to every class"
            )
        super().__init__(
            engine,
            max_queue_rows=max_queue_rows,
            registry=registry,
            name=name,
            tenant_quota_rows=tenant_quota_rows,
            class_weights=class_weights,
            tenant_weights=tenant_weights,
            log=log,
        )

    def _post_init(self) -> None:
        self.allocator = SlotAllocator(self.max_batch)
        reg, p = self.registry, self._name
        self._m_ttft = reg.histogram(
            f"{p}_ttft_seconds", "enqueue-to-first-token latency per request (chunk boundaries)"
        )
        self._m_chunk_seconds = reg.histogram(f"{p}_chunk_seconds", "engine wall time per decode chunk")
        self._m_chunks = reg.counter(f"{p}_chunks_total", "decode chunks dispatched")
        self._m_slots = reg.gauge(f"{p}_slots_active", "cache slots holding a decoding row")
        self._m_admitted = reg.counter(f"{p}_admitted_total", "rows admitted into cache slots")
        self._m_preempt = reg.counter_family(
            f"{p}_preemptions_total",
            "decoding requests suspended at a chunk boundary for a higher class, by reason "
            "(priority)",
            label_name="reason",
        )
        self._m_resume = reg.counter_family(
            f"{p}_resumptions_total",
            "suspended or migrated requests re-admitted into slots, by reason",
            label_name="reason",
        )
        self._m_resumed_tokens = reg.counter(
            f"{p}_resumed_tokens_total",
            "image tokens restored from migrated decode-state checkpoints (work not re-decoded)",
        )
        self._m_decoded_tokens = reg.counter(
            f"{p}_decoded_tokens_total",
            "image tokens decoded by chunk dispatches (re-decoded work after a failover counts again)",
        )
        self._m_migrated = reg.counter(
            f"{p}_migrated_out_total",
            "requests exported as decode-state checkpoints at a chunk boundary",
        )
        self._m_ttfp = reg.histogram(
            f"{p}_ttfp_seconds",
            "enqueue-to-first-preview latency per streamed request (chunk boundaries)",
        )
        self._m_stream_events = reg.counter_family(
            f"{p}_stream_events_total",
            "stream events emitted, by type (progress/preview from the worker; "
            "open/result/error/migrated from the HTTP layer)",
            label_name="type",
        )
        self._m_boundary_failures = reg.counter_family(
            f"{p}_boundary_failures_total",
            "best-effort chunk-boundary work that failed without touching decode "
            "(preview, spool), by kind",
            label_name="kind",
        )
        #: the last such failure, for a stall report
        self.last_boundary_error: Optional[BaseException] = None
        # plain counters
        self.admitted_rows = 0
        self.prefill_waves = 0
        self.chunks = 0  # chunk dispatches, failed ones too
        self.images = 0
        self._admit_seq = 0
        #: EMA of chunk wall seconds: the cost model of deadline shedding
        #: and Retry-After (None before the first chunk)
        self._chunk_ema: Optional[float] = None
        # worker-owned; /debug/state and the migration export read them
        self._inflight: dict = {}  # slot -> (request, row index)
        self._partial: dict = {}  # request -> {"tokens": [rows], "remaining": n}
        self._slot_pos: dict = {}  # slot -> decode position at the last boundary
        self._last_img_pos: Optional[np.ndarray] = None
        self._migrate_request: Optional[dict] = None
        #: exporting replica identity (a checkpoint's `site`)
        self.checkpoint_site: Optional[str] = None
        #: the last beacon ({"ts", "chunk_index", "checkpoints": {key: wire}})
        self.last_beacon: Optional[dict] = None

    def state_summary(self) -> dict:
        """The queue summary plus the slot table. The worker mutates
        `_inflight` without a lock (it is the only writer), so the copy
        retries around a concurrent resize: a debug view."""
        out = super().state_summary()
        now = time.monotonic()
        snap: dict = {}
        for _ in range(4):
            try:
                snap = dict(self._inflight)
                break
            except RuntimeError:
                continue
        out["slots_inflight"] = {
            int(slot): {
                "trace_id": req.trace.trace_id if req.trace else None,
                "rows": req.rows,
                "row_index": idx,
                "age_s": round(now - req.enqueued_at, 3),
            }
            for slot, (req, idx) in snap.items()
        }
        out["slots_active"] = self.allocator.n_active
        out["slots_free"] = self.allocator.n_free
        return out

    @property
    def inflight_rows(self) -> int:
        """Rows decoding in cache slots now (the drain hook)."""
        return self.allocator.n_active

    def _free(self, slot: int) -> None:
        """Host side of a slot's release (worker thread)."""
        self._inflight.pop(slot, None)
        self.allocator.free(slot)
        self._slot_pos.pop(slot, None)

    def _set_slots_gauge(self) -> None:
        self._m_slots.set(self.allocator.n_active)

    # -------------------------------------------------------------- worker

    def _run(self) -> None:
        inflight, partial = self._inflight, self._partial
        resumes = bool(getattr(self.engine, "supports_resume", False))
        headroom_fn = getattr(self.engine, "admission_headroom", None)
        demand_fn = getattr(self.engine, "admission_demand", None)
        can_admit = getattr(self.engine, "can_admit", None)
        while True:
            if self._migrate_request is not None:
                # the last chunk dispatch has returned: a chunk boundary
                self._serve_migration(inflight, partial)
                continue
            admitted: List = []  # (slot, spec) owed a prefill or resume
            restored: List = []  # requests a checkpoint completed
            with self._cond:
                while True:
                    head = self._viable_head(time.monotonic())
                    self._set_depth_gauges()
                    if self._migrate_request is not None or head is not None or inflight:
                        break
                    if self._closed:
                        return
                    self._cond.wait()
                if self._migrate_request is not None:
                    continue  # serve the export at the loop top
                # whole requests in scheduler order while their pending
                # rows (and, paged, their pages) fit. Pages move only at
                # prefill and release, on this thread, so one headroom
                # snapshot serves the wave and each head's demand is
                # summed once
                budget = headroom_fn() if headroom_fn is not None and demand_fn is not None else 0
                wave_demand = 0
                wave_specs: List = []
                while head is not None and self.allocator.n_free >= head.pending_rows + self._reserve_for(head):
                    pend = head.pending_row_specs()
                    if headroom_fn is not None and demand_fn is not None:
                        need = demand_fn([s for _, s in pend])
                        if wave_demand + need > budget:
                            break  # stays queued until releases return pages
                        wave_demand += need
                    elif can_admit is not None and not can_admit(wave_specs + [s for _, s in pend]):
                        break
                    self._pop_head(head)
                    if head.migrated and not head._migrate_counted:
                        # the work this engine does not decode again: the
                        # finished rows, and the prefixes it resumes
                        head._migrate_counted = True
                        self._m_resume.labels("migrate").inc()
                        saved = sum(len(t) for t in head.resume_tokens.values())
                        if resumes:
                            saved += sum(int(s.resume_pos or 0) for _, s in pend)
                        self._m_resumed_tokens.inc(saved)
                    if not pend:
                        head.trace.end(head._queue_span)
                        self.stage_seconds.labels("queue").observe(
                            time.monotonic() - head.enqueued_at, exemplar=head.trace.trace_id or None
                        )
                        restored.append(head)
                        head = self._viable_head(time.monotonic())
                        continue
                    wave_specs.extend(s for _, s in pend)
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
                    head.admitted_seq = self._admit_seq
                    self._admit_seq += 1
                    self._m_admitted.inc(len(pend))
                    if head._suspend_reason is not None:
                        # a resumption: the suspension was its preempted span
                        self._m_resume.labels(head._suspend_reason).inc()
                        self._close_preempt_span(head, outcome="resumed")
                        head._suspend_reason = None
                    else:
                        head.trace.end(head._queue_span)
                        self.stage_seconds.labels("queue").observe(
                            time.monotonic() - head.enqueued_at, exemplar=head.trace.trace_id or None
                        )
                    head._stage_span = head.trace.begin("prefill")
                    head = self._viable_head(time.monotonic())
                self._set_depth_gauges()
            if restored:
                self._complete_restored(restored)
            if not admitted and not inflight:
                if not restored:
                    # the head waits for pages no live row holds (the
                    # prefix cache's): nothing to decode, so wait
                    with self._cond:
                        self._cond.wait(0.01)
                continue
            # the dispatch in flight, so a failure still observes its stage
            stage_name, stage_t0 = None, 0.0
            try:
                if admitted:
                    stage_name, stage_t0 = "prefill", time.monotonic()
                    self._admit(admitted, resumes)
                    stage_name = None
                chunk_reqs = _unique_requests(req for req, _ in inflight.values())
                self.chunks += 1
                self._m_chunks.inc()
                spans = [(req, req.trace.begin("chunk", slots_active=len(inflight))) for req in chunk_reqs]
                t0 = time.monotonic()
                stage_name, stage_t0 = "chunk", t0
                img_pos, _active = self.engine.step_chunk()
                chunk_s = time.monotonic() - t0
                stage_name = None
                for req in chunk_reqs:
                    # a streak of incidents ends on decode progress
                    req.incidents.clear()
                chunk_index = getattr(self.engine, "chunk_index", self.chunks)
                for req, sp in spans:
                    req.trace.end(sp, chunk_index=chunk_index)
                self._m_chunk_seconds.observe(chunk_s)
                self._chunk_ema = chunk_s if self._chunk_ema is None else 0.2 * chunk_s + 0.8 * self._chunk_ema
                self.stage_seconds.labels("chunk").observe(chunk_s, exemplar=_first_trace_id(chunk_reqs))
                now = time.monotonic()
                finished = []
                for slot, (req, _i) in inflight.items():
                    if req.first_token_at is None and img_pos[slot] > 0:
                        req.first_token_at = now
                        self._m_ttft.observe(now - req.enqueued_at)
                    cur = int(img_pos[slot])
                    if cur > self._slot_pos.get(slot, 0):
                        self._m_decoded_tokens.inc(cur - self._slot_pos.get(slot, 0))
                        self._slot_pos[slot] = cur
                    if cur >= self.engine.image_seq_len:
                        finished.append(slot)
                self._last_img_pos = img_pos
                # before _retire: the final boundary's progress event still
                # sees the finished rows' slots
                self._emit_stream_events(inflight, img_pos, now)
                if finished:
                    self._retire(finished, inflight, partial)
                # boundary housekeeping, in order: retire cancelled and
                # expired rows, then reclaim a slot for a blocked head
                self._reap(inflight, partial)
                self._maybe_preempt(inflight, partial, img_pos)
                if self.spool is not None and self.chunks % self.spool_every == 0:
                    self._maybe_beacon(inflight)
            except Exception as exc:
                if stage_name is not None:
                    self.stage_seconds.labels(stage_name).observe(
                        time.monotonic() - stage_t0,
                        exemplar=_first_trace_id(_unique_requests(req for req, _ in inflight.values())),
                    )
                self._recover(exc, inflight, partial)
                continue
            self._set_slots_gauge()

    def _admit(self, admitted, resumes: bool) -> None:
        """Prefill (or resume) one admission wave in `prefill_batch`
        splits, then close the admitted requests' prefill spans."""
        t0 = time.monotonic()
        dispatches = resumed_rows = blocks_reused = suffix_tokens = 0
        hit_slots: set = set()
        have_stats = False
        prefill_slots = getattr(self.engine, "prefill_slots", None)
        if prefill_slots is None:  # an engine with the one-row surface only
            for slot, spec in admitted:
                self.engine.prefill_slot(slot, spec)
                dispatches += 1
        else:
            wave = max(1, int(getattr(self.engine, "prefill_batch", 1)))
            if resumes:
                resume_wave = [(s, sp) for s, sp in admitted if sp.resume_pos]
                fresh = [(s, sp) for s, sp in admitted if not sp.resume_pos]
            else:
                resume_wave, fresh = [], admitted
            # the wave was budgeted against one headroom snapshot: its
            # prefix hits stay pinned across all of its splits
            guard = getattr(self.engine, "protect_admission_wave", None)
            keys = guard(fresh) if guard is not None and fresh else None
            try:
                for i in range(0, len(fresh), wave):
                    prefill_slots(fresh[i : i + wave])
                    st = getattr(self.engine, "last_admission_stats", None)
                    if st is not None:
                        have_stats = True
                        dispatches += st.get("dispatches", 1)
                        hit_slots.update(st.get("hit_slots", ()))
                        blocks_reused += st.get("prefix_blocks_reused", 0)
                        suffix_tokens += st.get("suffix_tokens_computed", 0)
                    else:
                        dispatches += 1
                    self.prefill_waves += 1
            finally:
                if keys:
                    self.engine.unprotect_admission_wave(keys)
            for i in range(0, len(resume_wave), wave):
                self.engine.resume_slots(resume_wave[i : i + wave])
                dispatches += 1
                resumed_rows += len(resume_wave[i : i + wave])
                self.prefill_waves += 1
        self.admitted_rows += len(admitted)
        prefill_s = time.monotonic() - t0
        slots_of: dict = {}
        for slot, _ in admitted:
            slots_of.setdefault(self._inflight[slot][0], []).append(slot)
        for req, slots in slots_of.items():
            extra: dict = {}
            if have_stats:
                req.prefix_hit = all(s in hit_slots for s in slots)
                extra = dict(
                    prefix_blocks_reused=blocks_reused,
                    suffix_tokens_computed=suffix_tokens,
                    prefix_hit=req.prefix_hit,
                )
            if resumed_rows:
                extra["resumed_rows"] = resumed_rows
            req.trace.end(req._stage_span, wave_rows=len(admitted), dispatches=dispatches, **extra)
        self.stage_seconds.labels("prefill").observe(prefill_s, exemplar=_first_trace_id(slots_of))

    def _retire(self, finished, inflight, partial) -> None:
        """Harvest finished slots, free them, and resolve the requests whose
        rows are all done (one pixel decode for all of them)."""
        t0 = time.monotonic()
        touched = _unique_requests(inflight[s][0] for s in finished)
        hspans = [(req, req.trace.begin("harvest")) for req in touched]
        tokens = self.engine.harvest(finished)
        self.engine.release(finished)
        done: List = []  # (request, stacked token rows)
        for slot, row in zip(finished, tokens):
            req, idx = inflight[slot]
            self._free(slot)
            info = partial[req]
            info["tokens"][idx] = row
            info["remaining"] -= 1
            if info["remaining"] == 0:
                del partial[req]
                done.append((req, np.stack(info["tokens"])))
        done_reqs = {req for req, _ in done}
        for req, sp in hspans:
            if req not in done_reqs:
                req.trace.end(sp, slots=len(finished), partial=True)
        if not done:
            self.stage_seconds.labels("harvest").observe(time.monotonic() - t0, exemplar=_first_trace_id(touched))
            return
        now = time.monotonic()
        try:
            pixels = self.engine.decode_pixels(np.concatenate([t for _, t in done]))
        except Exception as exc:
            # only the completing requests are lost; rows still decoding
            # are untouched
            self._record_error(exc)
            self._mint_incident([req for req, _ in done], exc)
            self.stage_seconds.labels("harvest").observe(time.monotonic() - t0, exemplar=_first_trace_id(touched))
            for req, sp in hspans:
                if req in done_reqs:
                    req.trace.end(sp, error=repr(exc))
            for req, _ in done:
                req.future.set_exception(exc)
            return
        self.stage_seconds.labels("harvest").observe(
            time.monotonic() - t0, exemplar=_first_trace_id([req for req, _ in done])
        )
        done_spans = {req: sp for req, sp in hspans if req in done_reqs}
        offset = 0
        for req, toks in done:
            pix = None if pixels is None else pixels[offset : offset + req.rows]
            offset += req.rows
            self.images += req.rows
            self._m_images.inc(req.rows)
            self._m_latency.observe(now - req.enqueued_at)
            req.trace.end(done_spans.get(req, NULL_SPAN), slots=len(finished), rows=req.rows)
            req.future.set_result((toks, pix))
            self.last_error = None  # a request completed: healthy

    def _complete_restored(self, reqs) -> None:
        """Requests whose every row a checkpoint completed: resolved with one
        pixel decode each, no slot, no chunk."""
        for req in reqs:
            toks = np.stack([np.asarray(req.resume_tokens[i], np.int32) for i in range(req.rows)])
            try:
                pixels = self.engine.decode_pixels(toks)
            except Exception as exc:
                self._record_error(exc)
                self._mint_incident([req], exc)
                req.future.set_exception(exc)
                continue
            now = time.monotonic()
            self.images += req.rows
            self._m_images.inc(req.rows)
            self._m_latency.observe(now - req.enqueued_at)
            req.first_token_at = now
            self._m_ttft.observe(now - req.enqueued_at)
            req.future.set_result((toks, pixels))
            self.last_error = None

    # ------------------------------------------------ streaming (boundary)

    def _boundary_failure(self, kind: str, exc: BaseException) -> None:
        self._m_boundary_failures.labels(kind).inc()
        self.last_boundary_error = exc
        if self.log is not None:
            self.log.event(f"{kind}_failed", error=repr(exc))

    def _emit_stream_events(self, inflight, img_pos, now) -> None:
        """Chunk-boundary events of streamed requests (worker thread): a
        progress event per request, keyed by its request-level chunk index
        (the least position of its rows in flight, in chunks; the stream's
        high water swallows replays), and for the requests whose index
        reached a `preview_every` multiple one shared `snapshot_rows` read
        and one `preview_pixels` decode. Pixels ride the event raw: the
        reader encodes them. A preview failure drops this boundary's
        previews and touches no decode."""
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
                trace_id=req.trace.trace_id or None,
            ):
                self._m_stream_events.labels("progress").inc()
            if req.stream.preview_due(chunk, self.preview_every):
                due.append((req, chunk, positions, {idx: slot for slot, idx in rows}))
        previewer = getattr(self.engine, "preview_pixels", None)
        snap_fn = getattr(self.engine, "snapshot_rows", None)
        if not due or previewer is None or snap_fn is None or not getattr(self.engine, "preview_enabled", True):
            return
        t0 = time.monotonic()
        spans = [(req, req.trace.begin("preview", chunk=chunk)) for req, chunk, _, _ in due]
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
            for req, sp in spans:
                req.trace.end(sp, error=repr(exc))
            self._boundary_failure("preview", exc)
            return
        if pixels is None:
            for req, sp in spans:
                req.trace.end(sp, rows=0)
            return
        span_of = {id(req): sp for req, sp in spans}
        offset = 0
        for req, chunk, order in layout:
            pix = pixels[offset : offset + len(order)]
            offset += len(order)
            first = req.stream.previews_sent == 0
            if req.stream.preview(chunk, rows=list(order), pixels=np.asarray(pix), trace_id=req.trace.trace_id or None):
                self._m_stream_events.labels("preview").inc()
                if first:
                    self._m_ttfp.observe(now - req.enqueued_at, exemplar=req.trace.trace_id or None)
            req.trace.end(span_of[id(req)], rows=len(order), previews=req.stream.previews_sent)
        self.stage_seconds.labels("preview").observe(
            time.monotonic() - t0, exemplar=_first_trace_id([req for req, _, _ in layout])
        )

    # --------------------------------------------------- QoS / preemption

    def _image_time_s(self) -> Optional[float]:
        """Estimated wall seconds to decode one image, from the chunk EMA."""
        if self._chunk_ema is None:
            return None
        chunk_tokens = max(1, int(getattr(self.engine, "chunk_tokens", 1)))
        return -(-int(self.engine.image_seq_len) // chunk_tokens) * self._chunk_ema

    def _est_wait_s(self) -> Optional[float]:
        """Rough wait of a new row for a slot: the rows in the system drain
        at ~`max_batch` rows per image time. Coarse on purpose: it gates
        shedding, where a 2x error sheds a little early or late."""
        image_time = self._image_time_s()
        if image_time is None:
            return None
        return (self._queue.rows + self.allocator.n_active) / self.max_batch * image_time

    def retry_after_s(self) -> float:
        """The backlog's drain estimate for Retry-After, clamped to [1, 60]."""
        wait = self._est_wait_s()
        return 1.0 if wait is None else min(max(1.0, wait), 60.0)

    def _burn_factor(self) -> float:
        """The SLO-burn pessimism of the `slo_burn` hook: 1 at or under
        budget (or unwired), the burn rate above it, capped at 4 so a burn
        spike cannot shed every request."""
        fn = self.slo_burn
        if fn is None:
            return 1.0
        try:
            burn = float(fn())
        except Exception:
            return 1.0  # a broken burn source must not break admission
        return max(1.0, min(burn, 4.0))

    def _shed_check(self, req) -> Optional[ShedError]:
        """Deadline shed: when the backlog estimate says `req` cannot finish
        inside its own timeout, refuse it now (503 + Retry-After) instead
        of queueing it to a certain 504. While an SLO burns its budget the
        margin tightens by the burn factor (reason `slo_burn`)."""
        if not self.deadline_shed:
            return None
        wait, image_time = self._est_wait_s(), self._image_time_s()
        if wait is None or image_time is None:
            return None  # no measured basis yet: admit
        est = wait + image_time
        factor = self._burn_factor()
        budget_s = req.timeout_s / factor
        if est <= budget_s:
            return None
        return ShedError(
            f"estimated completion {est:.1f}s exceeds the admission budget {budget_s:.1f}s "
            f"(timeout {req.timeout_s:.1f}s / burn factor {factor:.2f}; "
            f"{self._queue.rows} rows queued, {self.allocator.n_active} decoding)",
            retry_after_s=min(max(1.0, est - budget_s), 60.0),
            reason="deadline" if est > req.timeout_s else "slo_burn",
        )

    def _suspend_host(self, req, inflight, partial, reason: str) -> None:
        """Host half of a suspension: strip the request's rows from the slot
        table, fold its finished rows into its resume state, open its
        `preempted` span and re-queue it at the front of its own (class,
        tenant) queue. The caller has dealt with the device side."""
        for slot in [s for s, (r, _) in inflight.items() if r is req]:
            self._free(slot)
        info = partial.pop(req, None)
        if info is not None:
            for idx, toks in enumerate(info["tokens"]):
                if toks is not None:
                    req.resume_tokens[idx] = toks
        req._suspend_reason = reason
        req._preempt_span = req.trace.begin("preempted", reason=reason, pending_rows=req.pending_rows)
        with self._cond:
            self._queue.push_front(req)
            self._set_depth_gauges()
            self._cond.notify_all()

    def _reserve_for(self, head) -> int:
        """Free slots `head` must leave: classes below high cannot use the
        high-class reserve."""
        return self.reserve_slots if head.klass > 0 else 0

    def _admission_cap(self, req) -> int:
        return self.max_batch - self._reserve_for(req)

    def _admission_blocked(self, head) -> bool:
        """Would the scheduler's head fail to admit now? The admission
        loop's slot and page gates."""
        if self.allocator.n_free < head.pending_rows + self._reserve_for(head):
            return True
        specs = [s for _, s in head.pending_row_specs()]
        demand_fn = getattr(self.engine, "admission_demand", None)
        headroom_fn = getattr(self.engine, "admission_headroom", None)
        if demand_fn is not None and headroom_fn is not None:
            return demand_fn(specs) > headroom_fn()
        can_admit = getattr(self.engine, "can_admit", None)
        return can_admit is not None and not can_admit(specs)

    def _maybe_preempt(self, inflight, partial, img_pos) -> None:
        """Chunk-boundary preemption: while the scheduler's head is blocked
        on slots or pages and a strictly lower-class request decodes,
        release the youngest such request and re-queue it. Keyed on the
        scheduler's own next pick, which the deterministic stride
        scheduler returns again next iteration, so the freed capacity goes
        to the request it was reclaimed for."""
        if not self.preempt:
            return
        while inflight and self._preempt_one(inflight, partial, img_pos):
            pass

    def _preempt_one(self, inflight, partial, img_pos) -> bool:
        """Release one victim for the blocked head; True if it did."""
        with self._cond:
            head = self._queue.peek()
            if (
                head is None or head.cancelled or head.expired(time.monotonic())
                or not self._admission_blocked(head)
            ):
                return False
        victims = {req for req, _ in inflight.values() if req.klass > head.klass}
        if not victims:
            return False
        if self._burn_factor() > 1.0 and img_pos is not None:
            # a burning SLO budget: evict the least-progressed victim, the
            # cheapest redo (ties: the youngest, the default's pick)
            def progress(r):
                return sum(int(img_pos[s]) for s, (rr, _) in inflight.items() if rr is r)

            victim = min(victims, key=lambda r: (progress(r), -r.admitted_seq))
        else:
            victim = max(victims, key=lambda r: r.admitted_seq)
        slot_rows = {s: idx for s, (r, idx) in inflight.items() if r is victim}
        slots = list(slot_rows)
        # the generated-so-far prefix, before the slots are released
        snap_fn = getattr(self.engine, "snapshot_rows", self.engine.harvest)
        resumable = bool(getattr(self.engine, "supports_resume", False))
        for slot, row_toks in zip(slots, snap_fn(slots)):
            pos = int(img_pos[slot]) if img_pos is not None else len(row_toks)
            prefix = np.asarray(row_toks[:pos], np.int32)
            victim.preempt_snapshots[slot_rows[slot]] = prefix
            if resumable:
                # re-admitted at this position: one resume dispatch instead
                # of a whole re-decode
                victim._set_resume(slot_rows[slot], prefix)
        # a failed release propagates to the recovery path with the victim
        # still in flight
        self.engine.release(slots)
        victim.preemptions += 1
        self._m_preempt.labels("priority").inc()
        if self.log is not None:
            self.log.event(
                "preempt", trace_id=victim.trace.trace_id or None, reason="priority", rows=len(slots),
                for_class=head.priority, victim_class=victim.priority,
            )
        self._suspend_host(victim, inflight, partial, reason="priority")
        self._set_slots_gauge()
        return True

    def _reap(self, inflight, partial) -> None:
        """Retire cancelled and expired decoding requests at the boundary,
        releasing their slots instead of decoding them to the end."""
        now = time.monotonic()
        doomed: dict = {}
        for slot, (req, _idx) in inflight.items():
            if req.cancelled or req.expired(now):
                doomed.setdefault(req, []).append(slot)
        if not doomed:
            return
        # one release for the boundary; a failure goes to recovery
        self.engine.release([s for ss in doomed.values() for s in ss])
        for req, slots in doomed.items():
            for s in slots:
                self._free(s)
            partial.pop(req, None)
            if req.cancelled:
                self._m_cancelled.inc()
                exc: Exception = RequestCancelled("cancelled mid-decode; slot released at the chunk boundary")
            else:
                self._m_timeouts.inc()
                exc = RequestTimeout(
                    f"exceeded {req.timeout_s:.1f}s mid-decode; slot released at the chunk boundary"
                )
            req.future.set_exception(exc)
        self._set_slots_gauge()

    def _recover(self, exc, inflight, partial) -> None:
        """A failed dispatch left the engine's state rebuilt clean: every
        request in flight with retry budget is suspended and re-admitted
        from position 0 (the same tokens); requests retried once already
        fail with the error. Every request in flight carries the incident
        id: a repeat is the poison signal of the HTTP layer's 422."""
        self._mint_incident(list(partial), exc)
        self._record_error(exc)
        retryable = [r for r in partial if r.dispatch_retries < 1]
        doomed = [r for r in partial if r.dispatch_retries >= 1]
        for req in doomed:
            for slot in [s for s, (r, _) in inflight.items() if r is req]:
                self._free(slot)
            partial.pop(req, None)
            req.future.set_exception(exc)
        for req in retryable:
            req.dispatch_retries += 1
            self._m_retries.inc()
            self._suspend_host(req, inflight, partial, reason="dispatch_retry")
        for slot in list(inflight):  # admitted rows of no request in `partial`
            self._free(slot)
        if self.log is not None:
            self.log.event("dispatch_retry", error=repr(exc), retried=len(retryable), failed=len(doomed))
        try:  # the engine may be wedged; the release is best effort
            self.engine.release(range(self.max_batch))
        except Exception:
            pass
        self._set_slots_gauge()

    # ------------------------------------------- migration (chunk boundary)

    def migrate_out(self, timeout_s: float = 30.0):
        """Export every queued and in-flight request's decode-state
        checkpoint at the next chunk boundary, fail each one's future with
        `MigratedError` (its checkpoint encoded once under
        `checkpoint_fingerprint`) and free the slots. Returns the
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
        """Worker thread, at a chunk boundary. Destructive: pop every live
        queued request, snapshot every in-flight row, release the slots
        and fail the futures with `MigratedError`. Otherwise build the
        same checkpoints and touch nothing."""
        with self._cond:
            pend = self._migrate_request
            self._migrate_request = None
        if pend is None:
            return
        now = time.monotonic()
        with self._cond:
            if pend["destructive"]:
                queued = []
                while True:
                    head = self._viable_head(now)
                    if head is None:
                        break
                    self._queue.pop(charge=False)  # it used no capacity here
                    queued.append(head)
                self._set_depth_gauges()
            else:
                queued = [r for r in self._queue.requests() if not r.cancelled and not r.expired(now)]
        live = _unique_requests(req for req, _ in inflight.values())
        cps = self._collect_checkpoints(live + queued, inflight, "drain")
        if pend["destructive"]:
            slots = list(inflight)
            if slots:
                try:
                    self.engine.release(slots)
                except Exception:
                    pass  # a failed dispatch rebuilt a clean state; the host maps clear below
                for slot in slots:
                    self._free(slot)
            for req in live + queued:
                partial.pop(req, None)
                self._close_preempt_span(req, outcome="migrated")
                if req in queued:
                    req.trace.end(req._queue_span, outcome="migrated")
                    self._observe_queue_stage(req, now)
                self._m_migrated.inc()
                cp = cps[req]
                try:
                    cp.encoded = encode_checkpoint(cp, self.checkpoint_fingerprint)
                except Exception:
                    cp.encoded = None  # consumers encode it themselves
                req.future.set_exception(MigratedError(cp))
            if self.log is not None and (live or queued):
                self.log.event("migrate_out", requests=len(live) + len(queued), inflight=len(live), queued=len(queued))
            self._set_slots_gauge()
        pend["out"] = [cps[r] for r in live + queued]
        pend["event"].set()

    def _collect_checkpoints(self, reqs, inflight, reason: str) -> dict:
        """Worker thread, chunk boundary only: one `RequestCheckpoint` per
        request, from host bookkeeping plus one `snapshot_rows` read of
        all its rows in flight."""
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
                    else:  # a queued row: at most the prefix it holds
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
                trace_id=req.trace.trace_id or None,
                site=self.checkpoint_site,
                request_key=req.request_key or (req.trace.trace_id or None),
                reason=reason,
            )
        return out

    def _maybe_beacon(self, inflight) -> None:
        """Crash beacon (every `spool_every` chunks): journal every
        in-flight request's checkpoint to the spool in one atomic rewrite
        and keep the wire bundle as `last_beacon`. A spool failure never
        stops decode."""
        live = _unique_requests(req for req, _ in inflight.values())
        cps = self._collect_checkpoints(live, inflight, "beacon")
        bundle, wires = {}, {}
        for req, cp in cps.items():
            key = cp.request_key or f"local-{id(req):x}"
            if key in bundle and self.log is not None:
                # two identical requests share a content key: last wins
                self.log.event("beacon_key_collision", key=key)
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
