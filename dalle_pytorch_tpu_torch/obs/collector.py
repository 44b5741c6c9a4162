"""Fleet trace collector: joins spans from N processes into one trace.

Counterpart of the JAX package's `obs/collector.py` (stdlib host code,
copied so the port imports nothing of that package; the wire format,
HTTP paths and answers are the reference's, so either package's
exporters ship to either collector). The receiving half of
`obs/aggregate.py`: every serving process (and the
replica router, and a bench client) ships finished traces as JSONL; the collector joins them on `trace_id` and assembles ONE merged
Perfetto trace per request — one track per process identity
(`site`+`host`+`pid`), cross-process parent edges rendered as flow
arrows — plus fleet-wide critical-path analytics.

Join semantics (the part distributed tracing systems get wrong first):

  * out-of-order — spans join by `trace_id` whenever they arrive; the
    server's half landing before the client's (or vice versa) assembles
    identically (test-pinned both ways);
  * duplicate — span records dedupe on `(process identity, run, span
    id)`, where `run` is the exporter's per-trace-instance nonce (an
    exporter retry that half-landed re-sends its batch with the SAME
    run → first copy wins, counted, never double-rendered — while a
    client RETRYING a request with the same x-dalle-trace header mints
    a fresh run, so the second attempt's spans are kept, not discarded
    as duplicates of the first);
  * late — a trace is `settling` until it has been idle for `grace_s`,
    then `sealed`; arrivals during settling merge silently, arrivals
    after sealing still merge (one trace, not two) but are counted in
    `late_spans` so a fleet with a slow exporter is visible;
  * bounded — at most `max_traces` bundles are retained, evicted
    oldest-first; a span for an evicted trace starts a fresh bundle
    (counted, documented, and harmless: the ring is sized for the
    debugging window, not for history).

Run it standalone:

    python -m dalle_pytorch_tpu_torch.obs.collector --port 9500

or embed it in-process (bench/tests): construct `TraceCollector` and
call `ingest_lines` directly, or wrap it in a `CollectorServer` bound to
port 0.

HTTP surface (stdlib, same idioms as serving/server.py):

  POST /ingest         JSONL trace records -> {"accepted": n, "rejected": m}
  GET  /traces         merged Perfetto trace_event JSON of retained
                       traces; `?trace_id=` exact lookup (404 once
                       evicted), `?n=` most recent n
  GET  /critical_path  fleet-wide per-stage p50/p95 + dominant-critical-
                       path stage attribution (`?n=` bounds the window)
  GET  /healthz        {"status": "ok", ...ingest counters...}
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple


def _percentile(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, max(0, int(q * len(ordered))))]


def _span_uid(proc_info: Dict, sid: int) -> str:
    """Collector-side reconstruction of a producer's span UID from an
    ingested record's identity fields — built by the SAME
    `aggregate.span_uid_for` every producer uses, so the join format
    cannot drift."""
    from dalle_pytorch_tpu_torch.obs.aggregate import span_uid_for

    return span_uid_for(
        proc_info["site"], proc_info["host"], proc_info["pid"], sid
    )


class _Bundle:
    """All spans seen so far for one trace_id, across processes."""

    __slots__ = (
        "trace_id", "procs", "spans", "first_at", "last_at", "sealed",
        "late_spans",
    )

    def __init__(self, trace_id: str, now: float):
        self.trace_id = trace_id
        #: proc_key -> {"site", "host", "pid", "outcome", "parent_uid"}
        self.procs: Dict[str, Dict] = {}
        #: (proc_key, run, sid) -> span record (first copy wins)
        self.spans: Dict[Tuple[str, str, int], Dict] = {}
        self.first_at = now
        self.last_at = now
        self.sealed = False
        self.late_spans = 0

    def span_t0(self) -> Optional[float]:
        return min((s["t0"] for s in self.spans.values()), default=None)


class TraceCollector:
    """Embeddable span-joining store + analytics (no sockets here; the
    HTTP face is `CollectorServer`). All methods are thread-safe: ingest
    runs on handler threads while exports read."""

    def __init__(self, grace_s: float = 2.0, max_traces: int = 512):
        self.grace_s = float(grace_s)
        self.max_traces = int(max_traces)
        self._lock = threading.Lock()
        self._bundles: "OrderedDict[str, _Bundle]" = OrderedDict()
        self.started_at = time.time()
        # ingest counters (healthz + tests)
        self.records_ingested = 0
        self.spans_ingested = 0
        self.duplicate_spans = 0
        self.late_spans = 0
        self.bad_records = 0
        self.bad_spans = 0
        self.traces_evicted = 0

    # -------------------------------------------------------------- ingest

    def ingest_lines(self, payload, now: Optional[float] = None) -> Dict:
        """Parse a JSONL payload (bytes/str/iterable of lines) and ingest
        every record. Malformed lines are counted, never fatal — one bad
        exporter must not poison the batch."""
        if isinstance(payload, bytes):
            payload = payload.decode("utf-8", errors="replace")
        if isinstance(payload, str):
            lines: Iterable[str] = payload.splitlines()
        else:
            lines = payload
        accepted = rejected = 0
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                rec = None
            if self.ingest_record(rec, now=now):
                accepted += 1
            else:
                rejected += 1
        return {"accepted": accepted, "rejected": rejected}

    def ingest_record(self, rec, now: Optional[float] = None) -> bool:
        """Join one exporter record into its trace bundle. `now` is a
        monotonic override for deterministic grace-window tests."""
        now = time.monotonic() if now is None else now
        if not isinstance(rec, dict):
            with self._lock:  # handler threads ingest concurrently
                self.bad_records += 1
            return False
        trace_id = rec.get("trace_id")
        site = rec.get("site")
        spans = rec.get("spans")
        if (
            not isinstance(trace_id, str) or not trace_id
            or not isinstance(site, str) or not site
            or not isinstance(spans, list)
        ):
            with self._lock:
                self.bad_records += 1
            return False
        pid = rec.get("pid", 0)
        host = rec.get("host", "")
        run = rec.get("run")
        run = run if isinstance(run, str) else ""
        proc_key = f"{site}@{host}:{pid}"
        with self._lock:
            bundle = self._bundles.get(trace_id)
            if bundle is None:
                bundle = _Bundle(trace_id, now)
                self._bundles[trace_id] = bundle
                while len(self._bundles) > self.max_traces:
                    self._bundles.popitem(last=False)
                    self.traces_evicted += 1
            elif not bundle.sealed and now - bundle.last_at >= self.grace_s:
                # targeted O(1) seal check of THIS bundle only (a full
                # sweep per record is O(max_traces) inside the lock per
                # line of a batch); reads and sweep() still seal the rest
                bundle.sealed = True
            was_sealed = bundle.sealed
            proc = bundle.procs.setdefault(proc_key, {
                "site": site, "host": host, "pid": pid,
                "outcome": None, "parent_uid": None,
            })
            if rec.get("outcome") is not None:
                proc["outcome"] = rec["outcome"]
            if rec.get("parent_uid") is not None:
                proc["parent_uid"] = rec["parent_uid"]
            merged = 0
            for s in spans:
                if not isinstance(s, dict):
                    self.bad_spans += 1
                    continue
                sid = s.get("sid")
                t0, t1 = s.get("t0"), s.get("t1")
                if (
                    not isinstance(sid, int)
                    or not isinstance(s.get("name"), str)
                    or not isinstance(t0, (int, float))
                    or not isinstance(t1, (int, float))
                ):
                    self.bad_spans += 1
                    continue
                key = (proc_key, run, sid)
                if key in bundle.spans:
                    self.duplicate_spans += 1
                    continue
                parent = s.get("parent")
                bundle.spans[key] = {
                    "sid": sid,
                    "run": run,
                    "parent": parent if isinstance(parent, int) else None,
                    "name": s["name"],
                    "t0": float(t0),
                    "t1": float(t1),
                    "args": s.get("args") if isinstance(s.get("args"), dict)
                    else {},
                    "proc": proc_key,
                }
                merged += 1
            if was_sealed and merged:
                # one trace, not two — but a post-grace arrival means an
                # exporter is lagging the window; make that visible
                bundle.late_spans += merged
                self.late_spans += merged
            bundle.last_at = now
            self.records_ingested += 1
            self.spans_ingested += merged
        return True

    # --------------------------------------------------------- grace window

    def _sweep_locked(self, now: float) -> int:
        sealed = 0
        for bundle in self._bundles.values():
            if not bundle.sealed and now - bundle.last_at >= self.grace_s:
                bundle.sealed = True
                sealed += 1
        return sealed

    def sweep(self, now: Optional[float] = None) -> int:
        """Seal every bundle idle past the grace window; returns how many
        sealed this call. Runs implicitly on ingest and reads — public
        for deterministic tests."""
        with self._lock:
            return self._sweep_locked(
                time.monotonic() if now is None else now
            )

    # -------------------------------------------------------------- queries

    @staticmethod
    def _snapshot_locked(bundle: _Bundle) -> _Bundle:
        """Read-consistent clone (caller holds the lock): the containers
        are copied, the span records shared — they are never mutated
        after insertion. Exporters iterate the clone while ingest keeps
        mutating the live bundle on handler threads."""
        snap = _Bundle(bundle.trace_id, bundle.first_at)
        snap.procs = {k: dict(v) for k, v in bundle.procs.items()}
        snap.spans = dict(bundle.spans)
        snap.last_at = bundle.last_at
        snap.sealed = bundle.sealed
        snap.late_spans = bundle.late_spans
        return snap

    def _select(self, trace_id: Optional[str], n: Optional[int],
                now: Optional[float] = None) -> List[_Bundle]:
        with self._lock:
            self._sweep_locked(time.monotonic() if now is None else now)
            if trace_id is not None:
                bundle = self._bundles.get(trace_id)
                return (
                    [self._snapshot_locked(bundle)]
                    if bundle is not None else []
                )
            bundles = list(self._bundles.values())
            if n is not None:
                bundles = bundles[-n:]
            return [self._snapshot_locked(b) for b in bundles]

    def find(self, trace_id: str) -> Optional[_Bundle]:
        """LIVE bundle reference (existence probes, single-threaded test
        introspection) — concurrent-safe iteration goes through the
        exporters, which read `_select`'s snapshots."""
        with self._lock:
            return self._bundles.get(trace_id)

    def __len__(self) -> int:
        with self._lock:
            return len(self._bundles)

    def reset(self) -> None:
        """Drop every bundle (bench: analytics over the measured window
        only). Counters keep accumulating — they are process-lifetime."""
        with self._lock:
            self._bundles.clear()

    # ------------------------------------------------------ perfetto export

    def trace_events(self, trace_id: Optional[str] = None,
                     n: Optional[int] = None) -> Dict:
        """Merged Chrome/Perfetto `trace_event` JSON: per trace, one
        synthetic Perfetto process PER EXPORTING PROCESS (named
        `site (host:pid)`), every span a `ph:"X"` event on its process's
        track, and a flow arrow (`ph:"s"`/`ph:"f"`) from each propagated
        parent span to the remote root it parented — the header hop is
        visible in the UI, not just in args. Timestamps are microseconds
        from the bundle's earliest span."""
        events: List[Dict] = []
        pid_counter = 0
        flow_id = 0
        for bundle in self._select(trace_id, n):
            base = bundle.span_t0() or 0.0
            # stable track order: processes by their earliest span, so
            # the caller (bench client / router) renders above the
            # servers it fanned into
            proc_first: Dict[str, float] = {}
            for span in bundle.spans.values():
                k = span["proc"]
                proc_first[k] = min(proc_first.get(k, span["t0"]), span["t0"])
            proc_pids: Dict[str, int] = {}
            uid_to_span: Dict[str, Dict] = {}
            # bucket once per bundle — the inner loop must not re-sort
            # the whole span dict per process (hundreds of chunk spans
            # per continuous trace, on the endpoint's hot path)
            by_proc: Dict[str, List[Tuple[int, Dict]]] = {}
            for (pk, _run, sid), span in sorted(bundle.spans.items()):
                by_proc.setdefault(pk, []).append((sid, span))
            for proc_key in sorted(proc_first, key=proc_first.get):
                pid_counter += 1
                proc_pids[proc_key] = pid_counter
                info = bundle.procs[proc_key]
                events.append({
                    "ph": "M", "name": "process_name",
                    "pid": pid_counter, "tid": 1,
                    "args": {"name": f"{info['site']} "
                             f"({info['host']}:{info['pid']})"},
                })
                for sid, span in by_proc.get(proc_key, ()):
                    uid = _span_uid(info, sid)
                    uid_to_span[uid] = span
                    events.append({
                        "name": span["name"],
                        "cat": "fleet",
                        "ph": "X",
                        "ts": round((span["t0"] - base) * 1e6, 1),
                        "dur": round((span["t1"] - span["t0"]) * 1e6, 1),
                        "pid": pid_counter,
                        "tid": 1,
                        "args": {
                            "trace_id": bundle.trace_id,
                            "uid": uid,
                            **span["args"],
                        },
                    })
            # cross-process parent edges: proc root -> remote parent span
            for proc_key, info in bundle.procs.items():
                parent_uid = info.get("parent_uid")
                parent = uid_to_span.get(parent_uid) if parent_uid else None
                if parent is None:
                    continue
                roots = [
                    s for (pk, _, _), s in bundle.spans.items()
                    if pk == proc_key and s["parent"] is None
                ]
                if not roots:
                    continue
                child_root = min(roots, key=lambda s: s["t0"])
                flow_id += 1
                ts = round((child_root["t0"] - base) * 1e6, 1)
                events.append({
                    "ph": "s", "id": flow_id, "name": "propagate",
                    "cat": "fleet", "pid": proc_pids[parent["proc"]],
                    "tid": 1, "ts": max(
                        round((parent["t0"] - base) * 1e6, 1), 0.0
                    ),
                })
                events.append({
                    "ph": "f", "bp": "e", "id": flow_id, "name": "propagate",
                    "cat": "fleet", "pid": proc_pids[proc_key], "tid": 1,
                    "ts": ts,
                })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    # ----------------------------------------------------------- analytics

    @staticmethod
    def _leaves(bundle: _Bundle) -> List[Dict]:
        """Spans with no children — the stage spans. Parents (per-process
        roots, enclosing request spans) cover their children's time and
        would double-count."""
        has_child = set()
        uid_of = {}
        for (pk, run, sid), span in bundle.spans.items():
            uid_of[(pk, run, sid)] = _span_uid(bundle.procs[pk], sid)
        uids = set(uid_of.values())
        for (pk, run, sid), span in bundle.spans.items():
            if span["parent"] is not None:
                # parent linkage is within one trace INSTANCE: a retry's
                # spans parent among themselves, never across attempts
                has_child.add((pk, run, span["parent"]))
        for pk, info in bundle.procs.items():
            parent_uid = info.get("parent_uid")
            if parent_uid and parent_uid in uids:
                for key, uid in uid_of.items():
                    if uid == parent_uid:
                        has_child.add(key)
        return [
            span for key, span in bundle.spans.items()
            if key not in has_child
        ]

    @staticmethod
    def _critical_cover(root_t0: float, root_t1: float,
                        leaves: List[Dict]) -> Dict[str, float]:
        """Greedy interval cover of the request window by leaf spans: at
        each point pick the already-started span reaching furthest, and
        attribute the covered stretch to its stage. Gaps (host time no
        span claims) are attributed to "(untraced)" so the percentages
        always total the end-to-end latency."""
        out: Dict[str, float] = {}
        spans = sorted(
            (s for s in leaves if s["t1"] > root_t0 and s["t0"] < root_t1),
            key=lambda s: s["t0"],
        )
        t = root_t0
        i = 0
        started: List[Tuple[float, str]] = []  # (t1, name) candidates
        while t < root_t1:
            while i < len(spans) and spans[i]["t0"] <= t:
                started.append((spans[i]["t1"], spans[i]["name"]))
                i += 1
            started = [(t1, nm) for t1, nm in started if t1 > t]
            if started:
                t1, nm = max(started)
                end = min(t1, root_t1)
                out[nm] = out.get(nm, 0.0) + (end - t)
                t = end
            elif i < len(spans):
                gap_end = min(spans[i]["t0"], root_t1)
                out["(untraced)"] = out.get("(untraced)", 0.0) + (gap_end - t)
                t = gap_end
            else:
                out["(untraced)"] = out.get("(untraced)", 0.0) + (root_t1 - t)
                break
        return out

    def critical_path(self, n: Optional[int] = None,
                      trace_id: Optional[str] = None) -> Dict:
        """Fold assembled traces into fleet-wide per-stage latency and
        dominant-critical-path attribution:

          * `stages`: per-trace stage TOTALS (all leaf spans of that
            name summed — many chunk spans count once per trace), with
            fleet p50/p95/mean over traces that saw the stage;
          * `critical_path.attributed_ms`: per-stage time ON the greedy
            critical cover of each trace's end-to-end window;
          * `critical_path.dominant`: per stage, how many traces (and
            what fraction) had that stage as their largest critical-path
            contributor — "where does the fleet's latency live".
        """
        stage_totals: Dict[str, List[float]] = {}
        crit_totals: Dict[str, List[float]] = {}
        dominant: Dict[str, int] = {}
        bundles = self._select(trace_id, n)
        traced = 0
        for bundle in bundles:
            if not bundle.spans:
                continue
            traced += 1
            leaves = self._leaves(bundle)
            per_stage: Dict[str, float] = {}
            for s in leaves:
                per_stage[s["name"]] = (
                    per_stage.get(s["name"], 0.0) + (s["t1"] - s["t0"])
                )
            for name, total in per_stage.items():
                stage_totals.setdefault(name, []).append(total)
            roots = [s for s in bundle.spans.values() if s["parent"] is None]
            root = min(roots or bundle.spans.values(), key=lambda s: s["t0"])
            if not leaves:
                continue
            # the attribution window runs root-start -> LAST LEAF end
            # (clamped by the root): a client that finishes its trace
            # late — the bench harvests completions after the whole
            # arrival replay — must not smear an artificial untraced
            # tail over the cover; for a server trace the respond leaf
            # ends at the root anyway, so the clamp is a no-op
            window_end = min(root["t1"], max(s["t1"] for s in leaves))
            cover = self._critical_cover(root["t0"], window_end, leaves)
            for name, covered in cover.items():
                crit_totals.setdefault(name, []).append(covered)
            if cover:
                top = max(cover.items(), key=lambda kv: kv[1])[0]
                dominant[top] = dominant.get(top, 0) + 1

        def pct_block(values: List[float]) -> Dict:
            return {
                "count": len(values),
                "p50_ms": round(1000.0 * _percentile(values, 0.5), 3),
                "p95_ms": round(1000.0 * _percentile(values, 0.95), 3),
                "mean_ms": round(1000.0 * sum(values) / len(values), 3),
            }

        return {
            "traces": traced,
            "stages": {
                name: pct_block(vals)
                for name, vals in sorted(stage_totals.items())
            },
            "critical_path": {
                "attributed_ms": {
                    name: pct_block(vals)
                    for name, vals in sorted(crit_totals.items())
                },
                "dominant": {
                    name: {
                        "traces": count,
                        "fraction": round(count / traced, 3),
                    }
                    for name, count in sorted(
                        dominant.items(), key=lambda kv: -kv[1]
                    )
                },
            },
        }

    # -------------------------------------------------------------- status

    def stats(self) -> Dict:
        with self._lock:
            self._sweep_locked(time.monotonic())
            sealed = sum(1 for b in self._bundles.values() if b.sealed)
            total = len(self._bundles)
            # counters are bumped under the lock by concurrent ingest
            # handler threads — snapshot them coherently here too
            counters = {
                "records_ingested": self.records_ingested,
                "spans_ingested": self.spans_ingested,
                "duplicate_spans": self.duplicate_spans,
                "late_spans": self.late_spans,
                "bad_records": self.bad_records,
                "bad_spans": self.bad_spans,
                "traces_evicted": self.traces_evicted,
            }
        return {
            "traces": total,
            "sealed": sealed,
            "settling": total - sealed,
            "grace_s": self.grace_s,
            "max_traces": self.max_traces,
            **counters,
        }


# --------------------------------------------------------------- HTTP face


#: ingest batches are many traces x many spans; far roomier than the
#: serving server's prompt bound, still finite
MAX_INGEST_BYTES = 32 << 20


def _build_handler():
    """Handler class built lazily inside CollectorServer so embedding a
    bare TraceCollector never touches http.server."""
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qs

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        timeout = 120

        def log_message(self, fmt, *args):
            if self.server.owner.verbose:
                super().log_message(fmt, *args)

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload, default=str).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if code >= 400:
                # undrained request bytes must not corrupt keep-alive
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            try:
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                pass

        def do_POST(self):
            collector = self.server.owner.collector
            path = self.path.partition("?")[0]
            if path != "/ingest":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if not 0 < length <= MAX_INGEST_BYTES:
                    raise ValueError(f"bad Content-Length {length}")
            except ValueError as exc:
                self._reply(400, {"error": f"bad request: {exc}"})
                return
            body = self.rfile.read(length)
            self._reply(200, collector.ingest_lines(body))

        def do_GET(self):
            collector = self.server.owner.collector
            path, _, query = self.path.partition("?")
            params = parse_qs(query)
            n_param = params.get("n", [None])[0]
            try:
                n = None if n_param is None else int(n_param)
                if n is not None and n <= 0:
                    raise ValueError(n)
            except ValueError:
                self._reply(400, {"error": "n must be a positive integer"})
                return
            trace_id = params.get("trace_id", [None])[0]
            if path == "/traces":
                if trace_id is not None and collector.find(trace_id) is None:
                    self._reply(404, {
                        "error": f"trace {trace_id} not retained "
                        "(evicted or never ingested)"
                    })
                    return
                self._reply(200, collector.trace_events(trace_id, n))
            elif path == "/critical_path":
                self._reply(200, collector.critical_path(n, trace_id))
            elif path == "/healthz":
                self._reply(200, {"status": "ok", **collector.stats()})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

    return Handler


class CollectorServer:
    """Stdlib HTTP wrapper around a TraceCollector (the `python -m`
    service, and the in-process collector bench/tests bind to port 0).
    Same lifecycle shape as ServingServer: `start()` serves on a daemon
    thread, `serve_forever()` blocks for the CLI, `shutdown()` closes."""

    def __init__(
        self,
        collector: Optional[TraceCollector] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        verbose: bool = False,
        grace_s: float = 2.0,
        max_traces: int = 512,
    ):
        from http.server import ThreadingHTTPServer

        self.collector = (
            collector if collector is not None
            else TraceCollector(grace_s=grace_s, max_traces=max_traces)
        )
        self.verbose = verbose

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._httpd = _Server((host, port), _build_handler())
        self._httpd.owner = self
        self._thread: Optional[threading.Thread] = None
        self._state_lock = threading.Lock()
        self._serving = False
        self._closed = False

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def start(self) -> "CollectorServer":
        assert self._thread is None, "already started"
        with self._state_lock:
            assert not self._closed, "collector already shut down"
            self._serving = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="dalle-collector-http",
            daemon=True,
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        assert self._thread is None, "already started in background"
        with self._state_lock:
            if self._closed:
                return
            self._serving = True
        self._httpd.serve_forever(poll_interval=0.05)

    def shutdown(self) -> None:
        with self._state_lock:
            first_close = not self._closed
            self._closed = True
            serving = self._serving
        if serving:
            self._httpd.shutdown()
            self._serving = False
        if first_close:
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None


def main(argv=None) -> int:
    import argparse
    import signal
    import sys as _sys

    p = argparse.ArgumentParser(
        description="fleet trace collector (see obs/collector.py)"
    )
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=9500,
                   help="0 picks a free port")
    p.add_argument("--grace_s", type=float, default=2.0,
                   help="idle seconds before a trace seals (late spans "
                   "after that still merge, but are counted)")
    p.add_argument("--max_traces", type=int, default=512,
                   help="retained trace bound; evicted oldest-first")
    p.add_argument("--verbose", action="store_true", help="HTTP access logs")
    args = p.parse_args(argv)

    server = CollectorServer(
        host=args.host, port=args.port, verbose=args.verbose,
        grace_s=args.grace_s, max_traces=args.max_traces,
    )

    def _stop(signum, frame):
        # shutdown() joins the serve loop; run it off the main thread
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    # parseable readiness line, like serve.py's
    print(f"[collector] listening on http://{args.host}:{server.port} "
          f"(grace_s={args.grace_s}, max_traces={args.max_traces})",
          flush=True)
    server.serve_forever()
    print("[collector] shutdown complete", flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

