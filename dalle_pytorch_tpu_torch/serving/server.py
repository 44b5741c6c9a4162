"""Stdlib-only JSON HTTP front end of the serving engines.

Counterpart of the JAX package's `serving/server.py`, with its wire
protocol. Endpoints:

  POST /generate   {"prompt": str, "num_images": int=1, "seed": int?,
                    "temperature": float=1.0, "top_k": float=0.9,
                    "rerank": bool=false, "timeout_s": float?,
                    "priority": "high"|"normal"|"low", "tenant": str?,
                    "resume": checkpoint?, "stream": bool=false}
                -> {"prompt", "num_images", "seed", "latency_ms",
                    "usage": {"rows", "decoded_tokens", "resumed_tokens"},
                    "trace_id"?, "shape"?, "images_png_b64"?,
                    "clip_scores"?, "tokens": [[int]]}
  GET  /healthz -> {"status": "ok" | "degraded", ...}; 503 while draining
                   and for a while after an engine failure (the error
                   decays); "degraded" (still 200) after a recent watchdog
                   stall or while an SLO burns its error budget
  GET  /metrics -> Prometheus text of the shared registry; `?exemplars=1`
                   the OpenMetrics flavour with trace-ID exemplars
  GET  /debug/traces -> Perfetto `trace_event` JSON of the recent request
                   traces (`?n=` bounds it, `?trace_id=` one trace, 404
                   once it left the ring)
  GET  /debug/vitals -> the vitals sampler's ring (`obs/vitals.py`): queue
                   depth, slots / pages active, the dispatch in flight,
                   device memory, watchdog stalls, SLO burn, the device;
                   `?n=` tails it
  GET  /debug/programs -> the per-program cost table: counted FLOPs and
                   bytes (a sharded engine's summed over its shards),
                   warmup memory, kernel launches, EMA wall, MFU and GB/s
  GET  /debug/state -> engine state (slot and page tables), the batcher's
                   queue and slot table, recent kernel-library events and
                   the process's tally of them (`utils/compile_guard`),
                   the compile cache's plan and verdicts, the trace
                   exporter's health, the profiler's state and the worker
                   thread's stack
  POST /debug/profile?seconds=N -> an on-demand `torch.profiler` capture
                   of N seconds of live traffic (`obs/profiler.py`): 200
                   with the trace directory; a bad `seconds` or body 400,
                   a rank other than 0 403, a capture in flight 409, a
                   failed capture 500
  POST /admin/drain -> pause intake (new requests 503 + Retry-After,
                   /healthz 503 "draining"); in-flight work completes.
                   `?migrate=1` exports every queued and in-flight request
                   as a decode-state checkpoint at the next chunk boundary:
                   each waiting client gets a 409 carrying its checkpoint
                   (re-POST it as "resume"), and the bundle rides this reply
  POST /admin/undrain -> resume intake
  GET  /admin/checkpoints -> a chunk-boundary snapshot of every in-flight
                   request's decode state, the requests decoding on (the
                   last crash beacon's bundle when the worker is stuck)

Every /generate request gets a trace: adopted from a valid `x-dalle-trace`
header (`obs/aggregate.py`), minted otherwise; its ID comes back as
`trace_id`; with a `TraceExporter` attached (`exporter=`, `serve
--trace_export URL`) the finished trace ships to the fleet collector
(`obs/collector.py`). `x-dalle-route` and `x-dalle-request-key`
(`serving/router.py`) are parsed into the request's log line; the key also
names its checkpoints and lets a streamed request re-attach. With a
`StructuredLog`, one JSON line per request.

Status mapping: a bad or oversized body 400; unknown path 404; queue full
or deadline shed 503 + Retry-After (the batcher's drain estimate); tenant
over quota 429 + Retry-After; timeout 504 (the request is cancelled, its
slot released at the next chunk boundary); engine error 500; a request in
flight for `quarantine_after` consecutive failed dispatches 422 with the
incident ids; migrated by `drain?migrate=1` 409 with the checkpoint.

`"stream": true` (continuous engine) answers with Server-Sent Events
(`serving/streaming.py`): `open`, a `progress` event at every chunk
boundary, a `preview` (base64 PNGs) every `preview_every` chunks, keep-alive
comments when idle, and one terminal event that this server writes from
the resolved request: `result` (the buffered payload), `migrated` (the
409's checkpoint) or `error`. A streamed client's disconnect cancels its
request (the batcher's `_reap` frees its slots); a re-POST with the same
`x-dalle-request-key` re-attaches to the live stream.

Vitals are off by default (an inert `EngineVitals`): pass an enabled one
(`vitals=`) to run the sampler, the stall watchdog and the SLO tracker,
whose max burn also feeds the continuous batcher's deadline shed and
preemption victim choice. PNGs are written with zlib (`utils/images.py`).
"""

from __future__ import annotations

import base64
import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs

import numpy as np

from dalle_pytorch_tpu_torch.obs.aggregate import TRACE_HEADER, default_site, parse_trace_header, sanitize_site
from dalle_pytorch_tpu_torch.obs.logging import StructuredLog
from dalle_pytorch_tpu_torch.obs.profiler import ProfilerBusy, ProfilerCapture
from dalle_pytorch_tpu_torch.obs.tracing import Tracer
from dalle_pytorch_tpu_torch.obs.vitals import EngineVitals, thread_stacks
from dalle_pytorch_tpu_torch.serving.batcher import (
    ContinuousBatcher,
    MicroBatcher,
    QueueFullError,
    RequestTimeout,
    ShuttingDownError,
)
from dalle_pytorch_tpu_torch.serving.engine import SampleSpec
from dalle_pytorch_tpu_torch.serving.migrate import CheckpointSpool, MigratedError, encode_checkpoint, to_wire
from dalle_pytorch_tpu_torch.serving.qos import PRIORITY_CLASSES, ShedError, TenantQuotaError
from dalle_pytorch_tpu_torch.serving.router import (
    REQUEST_KEY_HEADER,
    ROUTE_HEADER,
    parse_request_key,
    parse_route_header,
)
from dalle_pytorch_tpu_torch.serving.streaming import KEEPALIVE, RequestStream, StreamRegistry, encode_sse
from dalle_pytorch_tpu_torch.training.metrics import MetricsRegistry
from dalle_pytorch_tpu_torch.utils import compile_guard
from dalle_pytorch_tpu_torch.utils.images import encode_png, to_uint8

MAX_BODY_BYTES = 1 << 20  # prompts are tiny; anything bigger is refused


def _usage_block(engine, req, num_images: int) -> dict:
    """The request's token accounting: tokens this server decoded against
    tokens a resume checkpoint restored. The reference counts the
    checkpoint's finished rows; on an engine with resume the unfinished
    rows' prefixes are restored too, not decoded, and count here."""
    seq = int(getattr(engine, "image_seq_len", 0) or 0)
    resumed = sum(len(t) for t in (getattr(req, "resume_tokens", None) or {}).values())
    if getattr(engine, "supports_resume", False):
        resumed += int(getattr(req, "restored_prefix_tokens", 0))
    return {
        "rows": int(num_images),
        "decoded_tokens": max(0, int(num_images) * seq - resumed),
        "resumed_tokens": int(resumed),
    }


def _png_b64(img: np.ndarray) -> str:
    return base64.b64encode(encode_png(to_uint8(img))).decode("ascii")


def _require(ok: bool, msg: str) -> None:
    """Validate a request field (a 400 when it fails)."""
    if not ok:
        raise ValueError(msg)


def _flag(params, name: str) -> bool:
    return params.get(name, ["0"])[0] in ("1", "true")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # bounds idle keep-alive connections and slow bodies: the server runs
    # one thread per connection
    timeout = 120
    #: seconds of silence on an event stream before a keep-alive comment
    KEEPALIVE_S = 10.0

    def log_message(self, fmt, *args):
        if self.server.owner.verbose:
            super().log_message(fmt, *args)

    # ------------------------------------------------------------ helpers

    def _reply(self, code: int, payload: dict, extra_headers=()) -> None:
        # default=str: debug dumps carry numpy scalars; degrade, not 500
        body = json.dumps(payload, default=str).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if code >= 400:
            # an error path may not have read the body: close rather than
            # parse its leftover bytes as the next request
            self.send_header("Connection", "close")
            self.close_connection = True
        for k, v in extra_headers:
            self.send_header(k, v)
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _profile(self, owner, query: str) -> None:
        """POST /debug/profile?seconds=N: a blocking on-demand capture."""
        if not self._drain_body():  # the endpoint takes no body
            return
        try:
            seconds = float(parse_qs(query).get("seconds", ["2"])[0])
        except (TypeError, ValueError):
            self._reply(400, {"error": "seconds must be a number"})
            return
        # the answer and the log name what was captured: capture() clamps
        if seconds > 0:
            seconds = min(seconds, owner.profiler.max_seconds)
        try:
            trace_dir = owner.profiler.capture(seconds)
        except ProfilerBusy as exc:
            self._reply(409, {"error": str(exc)})
            return
        except PermissionError as exc:
            self._reply(403, {"error": str(exc)})
            return
        except ValueError as exc:
            self._reply(400, {"error": f"bad request: {exc}"})
            return
        except Exception as exc:
            self._reply(500, {"error": f"profiler capture failed: {exc}"})
            return
        if owner.log is not None:
            owner.log.event("profile_capture", trace_dir=str(trace_dir), seconds=seconds,
                            stop_s=owner.profiler.last_stop_s)
        self._reply(200, {"trace_dir": str(trace_dir), "seconds": seconds})

    def _drain_body(self) -> bool:
        """Read and drop a bounded body (admin POSTs take none); False
        after a 400 for a bad length."""
        try:
            length = int(self.headers.get("Content-Length", "0") or 0)
            _require(0 <= length <= MAX_BODY_BYTES, f"bad Content-Length {length}")
        except ValueError as exc:
            self._reply(400, {"error": f"bad request: {exc}"})
            return False
        if length:
            self.rfile.read(length)
        return True

    # -------------------------------------------------------------- GETs

    def do_GET(self):
        owner = self.server.owner
        path, _, query = self.path.partition("?")
        params = parse_qs(query)
        if path == "/healthz":
            healthy, detail = owner.health()
            self._reply(200 if healthy else 503, detail)
        elif path == "/metrics":
            exemplars = _flag(params, "exemplars")
            text = owner.registry.render(exemplars=exemplars).encode("utf-8")
            self.send_response(200)
            self.send_header(
                "Content-Type",
                "application/openmetrics-text; version=1.0.0; charset=utf-8" if exemplars
                else "text/plain; version=0.0.4; charset=utf-8",
            )
            self.send_header("Content-Length", str(len(text)))
            self.end_headers()
            try:
                self.wfile.write(text)
            except (BrokenPipeError, ConnectionResetError):
                pass
        elif path == "/debug/traces":
            trace_id = params.get("trace_id", [None])[0]
            if trace_id is not None:
                trace = owner.tracer.find(trace_id)
                if trace is None:
                    self._reply(404, {"error": f"trace {trace_id} not retained (evicted from the ring or never minted)"})
                else:
                    self._reply(200, owner.tracer.trace_events(traces=[trace]))
                return
            try:
                n = params.get("n", [None])[0]
                n = None if n is None else int(n)
                _require(n is None or n > 0, "n must be positive")
            except ValueError:
                self._reply(400, {"error": "n must be a positive integer"})
                return
            self._reply(200, owner.tracer.trace_events(n))
        elif path == "/debug/vitals":
            try:
                n = params.get("n", [None])[0]
                n = None if n is None else int(n)
                _require(n is None or n > 0, "n must be positive")
            except ValueError:
                self._reply(400, {"error": "n must be a positive integer"})
                return
            self._reply(200, owner.vitals.detail(n))
        elif path == "/debug/programs":
            table = getattr(owner.engine, "cost_table", None)
            if table is None:
                self._reply(200, {
                    "programs": [],
                    "note": "no ProgramCostTable attached (set engine.cost_table before warmup)",
                })
            else:
                self._reply(200, table.detail())
        elif path == "/debug/state":
            self._reply(200, owner.state_dump())
        elif path == "/admin/checkpoints":
            self._reply(200, owner.checkpoints_snapshot())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    # -------------------------------------------------------------- POSTs

    def do_POST(self):
        owner = self.server.owner
        path, _, query = self.path.partition("?")
        if path == "/debug/profile":
            self._profile(owner, query)
            return
        if path == "/admin/drain":
            if self._drain_body():
                self._reply(200, owner.drain_intake(migrate=_flag(parse_qs(query), "migrate")))
            return
        if path == "/admin/undrain":
            if self._drain_body():
                self._reply(200, owner.undrain_intake())
            return
        if path != "/generate":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        if owner.intake_paused:
            # refused before the body is read or a trace minted
            self._reply(503, {"error": "replica draining (admin)"}, [("Retry-After", "5")])
            return
        max_batch = owner.engine.max_batch
        try:
            length = int(self.headers.get("Content-Length", "0"))
            _require(0 < length <= MAX_BODY_BYTES, f"bad Content-Length {length}")
            body = json.loads(self.rfile.read(length))
            _require(isinstance(body, dict), "the body must be a JSON object")
            prompt = body["prompt"]
            _require(isinstance(prompt, str) and bool(prompt.strip()), "empty prompt")
            num_images = int(body.get("num_images", 1))
            _require(1 <= num_images <= max_batch, f"num_images must be in [1, {max_batch}]")
            temperature = float(body.get("temperature", 1.0))
            # NaN fails every comparison, so this refuses it too
            _require(0.0 <= temperature <= 100.0, "temperature must be a finite value in [0, 100]")
            top_k = float(body.get("top_k", 0.9))
            _require(0.0 <= top_k <= 1.0, "top_k is a fraction in [0, 1]")
            seed = body.get("seed")
            if seed is not None:
                _require(not isinstance(seed, (list, dict, bool)), "seed must be an int")
                seed = int(seed)
            timeout_s = float(body.get("timeout_s", owner.request_timeout_s))
            _require(
                0.0 < timeout_s <= owner.request_timeout_s,
                f"timeout_s must be in (0, {owner.request_timeout_s}]",
            )
            do_rerank = bool(body.get("rerank", False))
            _require(
                not do_rerank or getattr(owner.engine, "clip", None) is not None,
                "rerank requested but no CLIP checkpoint is loaded (start the server with --clip_path)",
            )
            priority = body.get("priority", "normal")
            _require(priority in PRIORITY_CLASSES, f"priority must be one of {list(PRIORITY_CLASSES)}")
            tenant = body.get("tenant", "")
            _require(isinstance(tenant, str) and len(tenant) <= 128, "tenant must be a string of at most 128 characters")
            resume_wire = body.get("resume")
            _require(resume_wire is None or isinstance(resume_wire, str), "resume must be a wire-encoded checkpoint string")
            stream_mode = bool(body.get("stream", False))
            _require(
                not stream_mode or isinstance(owner.batcher, ContinuousBatcher),
                "stream=true requires the continuous engine (start the server with --engine continuous)",
            )
        except Exception as exc:
            self._reply(400, {"error": f"bad request: {exc}"})
            return

        if seed is None:
            seed = owner.next_seed(num_images)
        t0 = time.monotonic()
        ctx = parse_trace_header(self.headers.get(TRACE_HEADER))
        trace = owner.tracer.start_trace(
            "request",
            trace_id=ctx[0] if ctx else None,
            parent_uid=ctx[1] if ctx else None,
            rows=num_images, seed=int(seed), prompt_chars=len(prompt),
        )
        # the request's log context: the router's decision, then the load
        # it met at submit
        admission: dict = dict(parse_route_header(self.headers.get(ROUTE_HEADER)) or {})

        def closed_out(outcome: str, status: int, **fields):
            trace.finish(outcome=outcome)
            owner.log_request(
                trace, outcome=outcome, status=status,
                latency_ms=(time.monotonic() - t0) * 1000.0, rows=num_images, **admission, **fields,
            )

        stream = None
        try:
            try:
                text_ids = owner.engine.tokenize(prompt)
            except Exception as exc:  # a tokenizer failure is the server's
                closed_out("error", 500, error=repr(exc))
                self._reply(500, {"error": f"tokenization failed: {exc}"})
                return
            specs = [
                SampleSpec(text_ids=text_ids, seed=int(seed) + i, temperature=temperature, top_k=top_k)
                for i in range(num_images)
            ]
            # a checkpoint that fails validation is a counted clean restart
            # at position 0, never a client error
            resume_cp = resume_bytes = None
            if resume_wire is not None:
                resume_cp, resume_bytes = owner.validate_resume(resume_wire, specs)
                if resume_cp is not None:
                    admission["migrated_from"] = resume_cp.site
                    admission["resumed_at_chunk"] = int(resume_cp.chunk_index)
                    admission["checkpoint_bytes"] = resume_bytes
                else:
                    admission["resume_rejected"] = True
            request_key = parse_request_key(self.headers.get(REQUEST_KEY_HEADER))
            admission.update(owner.admission_context())
            admission["priority"] = priority
            if tenant:
                admission["tenant"] = tenant
            if stream_mode:
                existing = owner.streams.reattach(request_key)
                if existing is not None and existing.request is not None:
                    # this server already decodes this request: take over
                    # the live stream instead of decoding it twice
                    admission["stream_reattach"] = True
                    self._stream_serve(
                        existing, existing.attach(), existing.request, prompt=prompt,
                        do_rerank=do_rerank, timeout_s=timeout_s, t0=t0, trace=trace,
                        closed_out=closed_out, reattach=True,
                    )
                    return
                stream = RequestStream(key=request_key, trace_id=trace.trace_id or None)
                if not owner.streams.register(stream):
                    closed_out("rejected", 503, streamed=True, error="stream registry full")
                    self._reply(503, {"error": "stream registry full"}, [("Retry-After", "1")])
                    return
            req = owner.batcher.submit(
                specs, timeout_s=timeout_s, trace=trace, priority=priority, tenant=tenant,
                request_key=request_key, resume=resume_cp, resume_bytes=resume_bytes, stream=stream,
            )
        except (QueueFullError, ShedError, TenantQuotaError, ShuttingDownError) as exc:
            if stream is not None:
                owner.streams.discard(stream)
            if isinstance(exc, QueueFullError):
                outcome, status = "rejected", 503
                retry = getattr(exc, "retry_after_s", None) or 1.0
            elif isinstance(exc, ShedError):
                outcome, status, retry = "shed", 503, exc.retry_after_s
            elif isinstance(exc, TenantQuotaError):
                outcome, status, retry = "quota", 429, exc.retry_after_s
            else:
                outcome, status, retry = "shutdown", 503, None
            if retry is None:
                closed_out(outcome, status)
                self._reply(status, {"error": str(exc)})
            else:
                closed_out(outcome, status, error=str(exc))
                self._reply(status, {"error": str(exc)}, [("Retry-After", str(int(round(retry))))])
            return

        if stream is not None:
            self._stream_serve(
                stream, stream.attach(mark_reattach=False), req, prompt=prompt, do_rerank=do_rerank,
                timeout_s=timeout_s, t0=t0, trace=trace, closed_out=closed_out, reattach=False,
            )
            return

        try:
            tokens, pixels = req.future.result(timeout=timeout_s + 5.0)
        except RequestTimeout as exc:
            req.cancel()
            closed_out("timeout", 504)
            self._reply(504, {"error": str(exc)})
            return
        except MigratedError as exc:
            blob = exc.checkpoint.encoded or encode_checkpoint(exc.checkpoint, owner.resume_fingerprint)
            closed_out(
                "migrated", 409, resumed_at_chunk=int(exc.checkpoint.chunk_index), checkpoint_bytes=len(blob),
            )
            self._reply(409, {
                "error": "request migrated out (replica draining); re-dispatch with the attached "
                "resume checkpoint",
                "migrated": True,
                "checkpoint": to_wire(blob),
                "resumed_at_chunk": int(exc.checkpoint.chunk_index),
                "migrated_from": exc.checkpoint.site,
            })
            return
        except Exception as exc:
            status, outcome, data = owner.failure(req, exc)
            closed_out(outcome, status, error=repr(exc), incidents=list(req.incidents))
            self._reply(status, data)
            return
        try:
            payload = self._payload(owner, req, tokens, pixels, prompt, do_rerank, t0, trace)
        except Exception as exc:  # rerank or PNG failure: a 500, not an EOF
            closed_out("error", 500, error=repr(exc))
            self._reply(500, {"error": f"response encoding failed: {exc}"})
            return
        closed_out("ok", 200, **self._lifecycle(req))
        self._reply(200, payload)

    @staticmethod
    def _lifecycle(req) -> dict:
        """The request's QoS history for its log line."""
        out = {} if req.prefix_hit is None else {"prefix_hit": req.prefix_hit}
        if req.preemptions:
            out["preemptions"] = req.preemptions
        if req.dispatch_retries:
            out["dispatch_retries"] = req.dispatch_retries
        return out

    def _payload(self, owner, req, tokens, pixels, prompt, do_rerank, t0, trace) -> dict:
        """The success payload (buffered reply and `result` event alike),
        timed as the `respond` stage."""
        tr0 = time.monotonic()
        span = trace.begin("respond")
        try:
            tokens = np.asarray(tokens)
            payload = {
                "prompt": prompt,
                "num_images": len(req.specs),
                "seed": int(req.specs[0].seed),
                "latency_ms": round((time.monotonic() - t0) * 1000.0, 2),
                "usage": _usage_block(owner.engine, req, len(req.specs)),
            }
            if trace:
                payload["trace_id"] = trace.trace_id
            if pixels is not None:
                clip_scores = None
                if do_rerank:
                    pixels, scores, order = owner.engine.rerank(prompt, pixels)
                    tokens = tokens[order]  # tokens[i] stays paired with image i
                    clip_scores = np.asarray(scores).tolist()
                payload["shape"] = list(np.asarray(pixels).shape)
                payload["images_png_b64"] = [_png_b64(img) for img in pixels]
                if clip_scores is not None:
                    payload["clip_scores"] = clip_scores
            payload["tokens"] = tokens.tolist()
        except Exception as exc:
            trace.end(span, error=repr(exc))
            raise
        finally:
            owner.batcher.stage_seconds.labels("respond").observe(
                time.monotonic() - tr0, exemplar=trace.trace_id or None
            )
        trace.end(span)
        return payload

    # ------------------------------------------------------ SSE streaming

    @staticmethod
    def _stream_payload(data: dict) -> dict:
        """Event data -> JSON: a preview's raw pixels become base64 PNGs
        here, on the thread that owns the socket, never on the worker."""
        pixels = data.get("pixels")
        if pixels is None:
            return data
        out = {k: v for k, v in data.items() if k != "pixels"}
        try:
            out["previews_png_b64"] = [_png_b64(img) for img in np.asarray(pixels)]
        except Exception as exc:  # degrade, do not end the stream
            out["preview_error"] = repr(exc)
        return out

    def _stream_serve(self, stream, gen, req, *, prompt, do_rerank, timeout_s, t0, trace, closed_out, reattach) -> None:
        """Serve one streamed /generate: SSE frames from the request's
        `RequestStream` until its terminal event, which this reader writes
        (`_stream_finish`) once the future resolves. A failed write means
        the client left: the request is cancelled (freed at the next chunk
        boundary), unless a re-dispatch of the same key took the stream
        over, whose request this reader must not cancel."""
        owner = self.server.owner
        try:
            cursor = int(self.headers.get("Last-Event-ID", "0"))
        except (TypeError, ValueError):
            cursor = 0
        # a backstop only: the worker's `_reap` times the request out itself
        deadline = t0 + timeout_s + 30.0
        logged = False  # one request-log line per handler

        def fields(**extra):
            return dict(streamed=True, previews_sent=stream.previews_sent, stream_reattaches=stream.reattaches, **extra)

        try:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")  # the stream ends with the connection
            self.close_connection = True
            self.end_headers()
            self.wfile.write(encode_sse("open", {
                "request_key": stream.key,
                "trace_id": stream.trace_id,
                "site": owner.identity.get("site"),
                "reattach": bool(reattach),
                "cursor": int(cursor),
            }))
            self.wfile.flush()
            owner.count_stream_event("open")
            while True:
                if not stream.current(gen):
                    if not logged:
                        closed_out("superseded", 200, **fields())
                    return
                events, drained = stream.next_events(cursor, timeout=self.KEEPALIVE_S)
                for seq, etype, data in events:
                    self.wfile.write(encode_sse(etype, self._stream_payload(data), seq=seq))
                    cursor = seq + 1
                self.wfile.flush()
                if drained:
                    break
                if stream.finished:
                    continue  # the terminal is queued above the cursor
                if req.future.done():
                    logged = self._stream_finish(stream, req, prompt, do_rerank, t0, trace, closed_out, fields) or logged
                    continue
                if not events:
                    if time.monotonic() > deadline:
                        req.cancel()
                        if stream.finish("error", status=504, error="stream deadline exceeded"):
                            owner.count_stream_event("error")
                            closed_out("timeout", 504, **fields())
                            logged = True
                        continue
                    self.wfile.write(KEEPALIVE)
                    self.wfile.flush()
        except OSError as exc:  # BrokenPipe, ConnectionReset and kin
            if stream.orphan(gen) and not req.future.done():
                req.cancel()
            if not logged:
                closed_out("disconnected", 200, **fields(error=repr(exc)))
            return
        owner.streams.discard(stream)
        if not logged:
            # this reader replayed a terminal another reader wrote and logged
            closed_out("streamed", 200, **fields())

    def _stream_finish(self, stream, req, prompt, do_rerank, t0, trace, closed_out, fields) -> bool:
        """Turn the resolved future into the stream's one terminal event,
        with the buffered path's status mapping. True when this reader
        wrote it (and the log line); False when another reader had."""
        owner = self.server.owner
        try:
            tokens, pixels = req.future.result(timeout=0)
        except RequestTimeout as exc:
            req.cancel()
            if not stream.finish("error", status=504, error=str(exc)):
                return False
            owner.count_stream_event("error")
            closed_out("timeout", 504, **fields())
            return True
        except MigratedError as exc:
            blob = exc.checkpoint.encoded or encode_checkpoint(exc.checkpoint, owner.resume_fingerprint)
            if not stream.finish(
                "migrated", checkpoint=to_wire(blob), resumed_at_chunk=int(exc.checkpoint.chunk_index),
                migrated_from=exc.checkpoint.site,
            ):
                return False
            owner.count_stream_event("migrated")
            closed_out("migrated", 409, **fields(
                resumed_at_chunk=int(exc.checkpoint.chunk_index), checkpoint_bytes=len(blob),
            ))
            return True
        except Exception as exc:
            status, outcome, data = owner.failure(req, exc)
            if not stream.finish("error", status=status, **data):
                return False
            owner.count_stream_event("error")
            extra = fields(error=repr(exc))
            if req.incidents:
                extra["incidents"] = list(req.incidents)
            closed_out(outcome, status, **extra)
            return True
        try:
            payload = self._payload(owner, req, tokens, pixels, prompt, do_rerank, t0, trace)
        except Exception as exc:
            if not stream.finish("error", status=500, error=f"response encoding failed: {exc}"):
                return False
            owner.count_stream_event("error")
            closed_out("error", 500, **fields(error=repr(exc)))
            return True
        if not stream.finish("result", **payload):
            return False
        owner.count_stream_event("result")
        closed_out("ok", 200, **fields(**self._lifecycle(req)))
        return True


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, owner: "ServingServer"):
        self.owner = owner
        super().__init__(addr, _Handler)


class ServingServer:
    """Engine + batcher + HTTP listener with a graceful lifecycle.

    An engine with the slot surface (`step_chunk`: `ContinuousEngine`,
    `PagedContinuousEngine`) is served by a `ContinuousBatcher`, anything
    else with `generate` by a `MicroBatcher` (`max_delay_ms` applies to it
    only). `start()` binds and serves on a background thread (port 0
    picks a free port: read `.port`); `serve_forever()` blocks instead.
    `shutdown()` stops intake, serves what is queued, then closes the
    listener. The metrics registry is the engine's `registry` when it has
    one, a fresh one otherwise; `tracer` defaults to a bounded on tracer,
    `log` to none, `profiler` to a `ProfilerCapture` on the engine's
    device writing under `profiles/`; an `exporter` (`TraceExporter`)
    attaches to the tracer here and is stopped, after a final flush, at
    shutdown.
    """

    #: how long a failed dispatch keeps /healthz at 503: decayed, so a
    #: health-gated router does not starve the server of the success that
    #: would clear it
    error_window_s: float = 60.0

    def __init__(
        self,
        engine,
        host: str = "127.0.0.1",
        port: int = 8000,
        max_delay_ms: float = 25.0,
        max_queue_rows: int = 64,
        request_timeout_s: float = 120.0,
        verbose: bool = False,
        tracer: Optional[Tracer] = None,
        log: Optional[StructuredLog] = None,
        log_requests: bool = True,
        profiler: Optional[ProfilerCapture] = None,
        exporter=None,
        trace_dump_path: Optional[str] = None,
        vitals: Optional[EngineVitals] = None,
        tenant_quota_rows: Optional[int] = None,
        tenant_weights: Optional[dict] = None,
        preempt: bool = True,
        deadline_shed: bool = True,
        reserve_slots: int = 0,
        quarantine_after: int = 2,
        checkpoint_spool=None,
        spool_every: int = 8,
        preview_every: int = 4,
        max_streams: int = 256,
    ):
        self.engine = engine
        registry = getattr(engine, "registry", None)
        self.registry = MetricsRegistry() if registry is None else registry
        self.request_timeout_s = float(request_timeout_s)
        self.verbose = verbose
        # a request that died carrying this many incident ids gets a
        # terminal 422: with the batcher's one retry, 2 means both of its
        # attempts failed. 0 turns it off
        self.quarantine_after = int(quarantine_after)
        self._m_quarantined = self.registry.counter(
            "dalle_serving_quarantined_total",
            "requests failed as poison: in flight for quarantine_after+ consecutive failed "
            "engine dispatches (terminal 422)",
        )
        # vitals default off: the inert sampler (no thread, nothing sampled)
        self.vitals = vitals if vitals is not None else EngineVitals(enabled=False)
        self.tracer = tracer if tracer is not None else Tracer(max_traces=128)
        # the server owns the exporter's lifecycle: attached here, stopped
        # (with a final flush) at shutdown
        self.exporter = exporter
        if exporter is not None:
            exporter.attach(self.tracer)
        self.profiler = (
            profiler if profiler is not None else ProfilerCapture(device=getattr(engine, "device", None))
        )
        self.log = log
        self.log_requests = bool(log_requests)
        self.trace_dump_path = trace_dump_path
        self._trace_dumped = False
        fp_fn = getattr(engine, "resume_fingerprint", None)
        self.resume_fingerprint = fp_fn() if callable(fp_fn) else "unfingerprinted"
        self.spool = (
            checkpoint_spool
            if checkpoint_spool is None or isinstance(checkpoint_spool, CheckpointSpool)
            else CheckpointSpool(checkpoint_spool)
        )
        self._m_streams_active = self.registry.gauge(
            "dalle_serving_streams_active", "live SSE event streams currently registered"
        )
        self.streams = StreamRegistry(max_streams=max_streams, gauge=self._m_streams_active.set)
        qos = dict(
            max_queue_rows=max_queue_rows, registry=self.registry, tenant_quota_rows=tenant_quota_rows,
            tenant_weights=tenant_weights, log=log,
        )
        if hasattr(engine, "step_chunk"):
            self.batcher = ContinuousBatcher(
                engine, preempt=preempt, deadline_shed=deadline_shed, reserve_slots=reserve_slots,
                spool=self.spool, spool_every=spool_every, preview_every=preview_every, **qos,
            )
        else:
            self.batcher = MicroBatcher(engine, max_delay_ms=max_delay_ms, **qos)
        self.batcher.checkpoint_fingerprint = self.resume_fingerprint
        # the sampler's host-state sources, then its thread (a no-op when
        # off); binding also hands the engine its dispatch clock
        self.vitals.bind(engine=engine, batcher=self.batcher, log=log, state_dump_fn=self.state_dump).start()
        if self.vitals.slo is not None and hasattr(self.batcher, "slo_burn"):
            # a replica burning its error budget sheds earlier and preempts
            # the cheapest-to-redo victim
            self.batcher.slo_burn = self.vitals.slo.max_burn
        #: process identity (site / pid / host), shared with the log lines
        self.identity = (
            dict(log._identity) if log is not None else {
                "site": default_site(),
                "pid": os.getpid(),
                "host": sanitize_site(socket.gethostname() or "localhost"),
            }
        )
        if isinstance(self.batcher, ContinuousBatcher):
            self.batcher.checkpoint_site = self.identity["site"]
        try:
            self._httpd = _Server((host, port), self)
        except OSError:
            self.vitals.stop()  # do not leak the sampler, the worker or the shipper
            self.batcher.shutdown(drain=False)
            if self.exporter is not None:
                self.exporter.stop(final_flush=False)
            raise
        self._thread: Optional[threading.Thread] = None
        self._state_lock = threading.Lock()
        self._serving = False
        self._closed = False
        self._draining = False
        #: the reversible admin drain (POST /admin/drain)
        self._intake_paused = False
        self._started_at = time.time()
        self._seed_lock = threading.Lock()
        self._seed_counter = int(time.time()) & 0x7FFFFFFF

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def intake_paused(self) -> bool:
        return self._intake_paused

    def next_seed(self, n: int) -> int:
        """n consecutive seeds for a request that pinned none."""
        with self._seed_lock:
            s = self._seed_counter
            self._seed_counter = (self._seed_counter + n) & 0x7FFFFFFF
            return s

    def failure(self, req, exc: BaseException):
        """(status, outcome, reply) of a request that failed in the engine:
        a 500, or a 422 carrying its incident ids once it was in flight for
        `quarantine_after` consecutive failed dispatches (it plausibly
        causes them; a 4xx tells a router not to re-dispatch it)."""
        incidents = list(getattr(req, "incidents", ()) or ())
        if self.quarantine_after and len(incidents) >= self.quarantine_after:
            self._m_quarantined.inc()
            return 422, "quarantined", {
                "error": f"request quarantined after {len(incidents)} failed engine dispatches: {exc}",
                "incidents": incidents,
            }
        return 500, "error", {"error": f"generation failed: {exc}"}

    def count_stream_event(self, etype: str) -> None:
        """Open and terminal events, minted by the handlers, in the
        batcher's `dalle_serving_stream_events_total` (continuous only)."""
        fam = getattr(self.batcher, "_m_stream_events", None)
        if fam is not None:
            fam.labels(etype).inc()

    def log_request(self, trace, outcome: str, status: int, latency_ms: float, **fields) -> None:
        """One structured line per finished request (with a log and
        `log_requests`); the stage breakdown is its trace's."""
        if self.log is None or not self.log_requests:
            return
        self.log.request(
            trace_id=trace.trace_id, outcome=outcome, status=status, latency_ms=latency_ms,
            stages=trace.stage_seconds(), **fields,
        )

    def validate_resume(self, wire: str, specs):
        """(RequestCheckpoint, bytes) of a valid checkpoint for this build
        and request, else (None, None), counted and logged by reason
        (`MicroBatcher.validate_resume`)."""
        return self.batcher.validate_resume(wire, specs)

    # --------------------------------------------------------------- drain

    def drain_status(self) -> dict:
        return {
            "draining": self._intake_paused or self._draining,
            "inflight_rows": self.batcher.inflight_rows,
            "queue_depth_rows": self.batcher.queue_depth_rows,
            "quiesced": self.batcher.quiesced,
        }

    def drain_intake(self, migrate: bool = False) -> dict:
        """POST /admin/drain: stop admissions reversibly (503 to new
        /generate, 503 "draining" on /healthz); in-flight rows complete.
        `migrate` also exports every queued and in-flight request at the
        next chunk boundary: each waiting client gets a 409 with its
        checkpoint, and the bundle rides this reply."""
        self._intake_paused = True
        out = self.drain_status()
        if migrate:
            export = getattr(self.batcher, "migrate_out", None)
            if export is None:
                out["migrate"] = {
                    "supported": False,
                    "note": "micro engine holds no resumable decode state; drain waits out the in-flight batch",
                }
            else:
                cps = export(timeout_s=30.0)
                if cps is None:
                    out["migrate"] = {
                        "supported": True, "timeout": True,
                        "note": "worker never reached a chunk boundary; nothing was exported",
                    }
                else:
                    out["migrate"] = {
                        "supported": True,
                        "migrated": len(cps),
                        "fingerprint": self.resume_fingerprint,
                        "checkpoints": self._bundle(cps, reuse=True),
                    }
            out.update(self.drain_status())
        if self.log is not None:
            self.log.event(
                "drain_intake", migrate=migrate, migrated=(out.get("migrate") or {}).get("migrated"),
                **self.drain_status(),
            )
        return out

    def _bundle(self, cps, reuse: bool) -> dict:
        """{request key: wire checkpoint} of exported checkpoints."""
        bundle = {}
        for cp in cps:
            key = cp.request_key or f"anon-{len(bundle)}"
            blob = cp.encoded if reuse and cp.encoded else encode_checkpoint(cp, self.resume_fingerprint)
            bundle[key] = to_wire(blob)
        return bundle

    def undrain_intake(self) -> dict:
        """POST /admin/undrain: resume admissions."""
        self._intake_paused = False
        if self.log is not None:
            self.log.event("undrain_intake")
        return self.drain_status()

    def checkpoints_snapshot(self) -> dict:
        """GET /admin/checkpoints: the in-flight requests' decode state at
        the next chunk boundary, or the last crash beacon's bundle when
        the worker reaches none."""
        peek = getattr(self.batcher, "peek_checkpoints", None)
        if peek is None:
            return {"checkpoints": {}, "note": "micro engine holds no resumable decode state"}
        cps = peek(timeout_s=10.0)
        if cps is None:
            beacon = getattr(self.batcher, "last_beacon", None) or {}
            return {
                "stale": True,
                "note": "worker never reached a chunk boundary; serving the last beacon bundle",
                "checkpoints": beacon.get("checkpoints", {}),
                "beacon_ts": beacon.get("ts"),
                "fingerprint": self.resume_fingerprint,
            }
        bundle = self._bundle(cps, reuse=False)
        return {"checkpoints": bundle, "count": len(bundle), "fingerprint": self.resume_fingerprint}

    # --------------------------------------------------------------- views

    def health(self):
        """(healthy, detail) for /healthz."""
        err = self.batcher.last_error
        err_age = self.batcher.error_age_s()
        erroring = err_age is not None and err_age < self.error_window_s
        draining = self._draining or self._intake_paused
        healthy = not draining and not erroring
        # the degraded tier sits between ok and 503: the replica serves
        # (200: a health-gated router keeps it), but a recent stall or a
        # burning SLO says shed load. Hard failures stay 503.
        degraded_reasons = self.vitals.degraded_reasons() if healthy else []
        stats = self.engine.stats
        # eager PyTorch compiles nothing per shape: the rungs warmup ran
        compiled = getattr(stats, "compiled_shapes", None)
        if compiled is None:
            compiled = self.engine.batch_shapes if getattr(stats, "warmup_batches", 0) else ()
        detail = {
            "status": ("degraded" if degraded_reasons else "ok") if healthy else "unhealthy",
            "uptime_s": round(time.time() - self._started_at, 1),
            "queue_depth_rows": self.batcher.queue_depth_rows,
            "compiled_shapes": list(compiled),
            "batch_shapes": list(self.engine.batch_shapes),
        }
        work = {
            "warmup_batches": int(getattr(stats, "warmup_batches", 0) or 0),
            "image_seq_len": int(getattr(self.engine, "image_seq_len", 0) or 0),
            "max_batch": int(getattr(self.engine, "max_batch", 0) or 0),
        }
        for key, name in (
            ("decoded_tokens", "dalle_serving_decoded_tokens_total"),
            ("resumed_tokens", "dalle_serving_resumed_tokens_total"),
        ):
            counter = self.registry.get(name)
            if counter is not None and hasattr(counter, "value"):
                work[key] = int(counter.value)
        detail["work"] = work
        if degraded_reasons:
            detail["degraded_reasons"] = degraded_reasons
        if self.vitals.slo is not None:
            detail["slo"] = self.vitals.slo.status()
        if isinstance(self.batcher, ContinuousBatcher):
            detail["engine"] = "continuous"
            detail["slots_active"] = self.batcher.allocator.n_active
            detail["chunk_tokens"] = self.engine.chunk_tokens
            detail["qos"] = self.qos_detail()
            detail["streaming"] = dict(self.streams.detail(), preview_every=self.batcher.preview_every)
            kv_detail = getattr(self.engine, "kv_detail", None)
            if kv_detail is not None:
                detail["kv"] = kv_detail()
            mesh_detail = getattr(self.engine, "mesh_detail", None)
            if mesh_detail is not None:
                # a sharded engine: the axes and each shard's bytes
                detail["mesh"] = mesh_detail()
            sparsity_detail = getattr(self.engine, "sparsity_detail", None)
            sp = sparsity_detail() if sparsity_detail is not None else None
            if sp is not None:
                detail["sparsity"] = sp
        if err is not None:
            detail["last_error"] = repr(err)
            if err_age is not None:
                detail["last_error_age_s"] = round(err_age, 1)
        if draining:
            detail["draining"] = True
            detail["drain"] = self.drain_status()
        return healthy, detail

    def state_dump(self) -> dict:
        """GET /debug/state: host-side reads only, so it answers while the
        engine is stuck, which is when it matters."""
        engine_dump = getattr(self.engine, "state_dump", None)
        summary = getattr(self.batcher, "state_summary", None)
        dump = {
            "ts": round(time.time(), 3),
            "uptime_s": round(time.time() - self._started_at, 1),
            "draining": self._draining or self._intake_paused,
            "identity": self.identity,
            "engine": engine_dump() if engine_dump is not None else {"engine": type(self.engine).__name__},
            "batcher": summary() if summary is not None else {},
            "recent_compiles": compile_guard.recent_events(),
            # the process's kernel-library events: uncached == 0 on a warm boot
            "compiles": {
                "count": compile_guard.compile_count(),
                "cache_hits": compile_guard.cache_hit_count(),
                "uncached": compile_guard.uncached_count(),
            },
            "profiler": self.profiler.detail(),
            "worker_stacks": thread_stacks("batcher"),
        }
        cache = getattr(self.engine, "compile_cache", None)
        if cache is not None:
            dump["compile_cache"] = cache.detail()
        if self.exporter is not None:
            # did this replica's traces reach the collector
            dump["trace_export"] = self.exporter.detail()
        if self.spool is not None:
            dump["checkpoint_spool"] = self.spool.detail()
        return dump

    def qos_detail(self) -> dict:
        """Per-class queue depth and the preempt / resume / shed tallies."""
        out: dict = {
            "queue_by_class": self.batcher.class_depths(),
            "preempt_enabled": getattr(self.batcher, "preempt", False),
            "deadline_shed": getattr(self.batcher, "deadline_shed", False),
        }
        for key, metric in (
            ("preemptions", "dalle_serving_preemptions_total"),
            ("resumptions", "dalle_serving_resumptions_total"),
            ("shed", "dalle_serving_shed_total"),
        ):
            fam = self.registry.get(metric)
            if fam is not None:
                out[key] = {label: int(child.value) for label, child in fam.items()}
        retries = self.registry.get("dalle_serving_dispatch_retries_total")
        if retries is not None:
            out["dispatch_retries"] = int(retries.value)
        return out

    def admission_context(self) -> dict:
        """The load a request met at submit, for its log line."""
        ctx = {"queue_depth_rows": self.batcher.queue_depth_rows}
        alloc = getattr(self.batcher, "allocator", None)
        if alloc is not None:
            ctx["slots_active"] = alloc.n_active
        kv = getattr(self.engine, "kv", None)
        if kv is not None:
            ctx["blocks_free"] = kv.blocks_free
        return ctx

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "ServingServer":
        with self._state_lock:
            if self._thread is not None or self._closed:
                raise RuntimeError("server already started or shut down")
            self._serving = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.05},
            name="dalle-serving-http", daemon=True,
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Foreground serving for the CLI: blocks until `shutdown()`, and
        returns at once when that already ran (a signal during start-up)."""
        with self._state_lock:
            if self._thread is not None:
                raise RuntimeError("server already serving in the background")
            if self._closed:
                return
            self._serving = True
        self._httpd.serve_forever(poll_interval=0.05)

    def _dump_traces(self) -> None:
        if not self.trace_dump_path or self._trace_dumped:
            return
        self._trace_dumped = True
        try:
            out = self.tracer.dump(self.trace_dump_path)
            if self.log is not None:
                self.log.event("trace_dump", path=str(out), traces=len(self.tracer.recent()))
        except OSError as exc:  # a bad path must not block shutdown
            if self.log is not None:
                self.log.event("trace_dump_failed", error=repr(exc))

    def shutdown(self, drain: bool = True) -> None:
        """Stop intake, serve (`drain`) or fail what is queued, stop the
        listener, then write the trace dump."""
        self._draining = True
        self.vitals.stop()
        self.batcher.shutdown(drain=drain)
        with self._state_lock:
            first_close = not self._closed
            self._closed = True
            serving = self._serving
            self._serving = False
        if serving:
            # socketserver's shutdown() waits for serve_forever to return;
            # on a never-served listener it would block forever
            self._httpd.shutdown()
        if first_close:
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        # last, so handlers still responding have finished their traces
        self._dump_traces()
        if self.exporter is not None and first_close:
            # every finished trace is buffered by now: one final flush,
            # bounded by the POST timeout
            self.exporter.stop()
            if self.log is not None:
                self.log.event("trace_export_stopped", **self.exporter.detail())
        if first_close and self.log is not None:
            self.log.event("shutdown", drain=drain)
