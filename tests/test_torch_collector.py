"""The port's fleet trace plane against the JAX package's (CPU).

* The collector: the same seeded JSONL records (numpy-made: several
  processes a trace, parent edges across them, exporter retries with the
  same `run`, client retries with a new one) go through the JAX
  `TraceCollector` and the port's in orders that stress the join (forward,
  reversed, duplicated, late after sealing, past `max_traces`): the merged
  `trace_events()`, `critical_path()` and `stats()` must be equal, with
  no tolerance.
* The wire: a port `TraceExporter` ships to a JAX `CollectorServer` and a
  JAX exporter to the port's, each on port 0; a client trace from one
  package and a server trace from the other join into one bundle with the
  parent edge.
* `serialize_trace`: one span tree serialized by both exporters, the
  process identity pinned, gives equal records.
* A CPU fleet end to end (after `tests/test_aggregate.py::TestFleetE2E`):
  the port's router and two `device="cpu"` port replicas, each with an
  exporter, ship to one collector; every routed request is one merged
  trace holding the router's dispatch span and the replica's spans on
  separate tracks, joined by a parent edge, and `/critical_path` answers.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.obs import aggregate as jagg
from dalle_pytorch_tpu.obs import collector as jcol
from dalle_pytorch_tpu.obs.tracing import Tracer as JTracer
from dalle_pytorch_tpu_torch.data.tokenizer import ByteTokenizer
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.obs import aggregate as pagg
from dalle_pytorch_tpu_torch.obs import collector as pcol
from dalle_pytorch_tpu_torch.obs.tracing import Tracer as PTracer
from dalle_pytorch_tpu_torch.serving import router as prouter
from dalle_pytorch_tpu_torch.serving.engine import ContinuousEngine
from dalle_pytorch_tpu_torch.serving.server import ServingServer
from dalle_pytorch_tpu_torch.training.metrics import MetricsRegistry

SITES = ("router", "replica-a", "replica-b")


def seeded_records(seed, n_traces=10):
    """Exporter records of `n_traces` requests: a router record whose
    dispatch span parents one replica's root (sometimes a second
    attempt's, on the other replica, with a fresh run), stage spans of
    random lengths, unix times from 1.7e9. Returns a list of dicts."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n_traces):
        trace_id = f"{rng.integers(1 << 62):016x}"
        t0 = 1.7e9 + float(rng.uniform(0, 100))
        dur = float(rng.uniform(0.05, 2.0))
        attempts = 1 + int(rng.integers(2))
        spans = [{"sid": 0, "parent": None, "name": "request", "t0": t0, "t1": t0 + dur, "args": {}}]
        replica_recs = []
        for a in range(attempts):
            sid = 1 + a
            d0 = t0 + dur * (0.05 + 0.45 * a)
            d1 = d0 + dur * 0.4
            spans.append({"sid": sid, "parent": 0, "name": "dispatch", "t0": d0, "t1": d1,
                          "args": {"replica": SITES[1 + a], "attempt": a}})
            stages, c = [], d0 + 0.01 * dur
            for k, name in enumerate(["queue", "prefill"] + ["chunk"] * int(rng.integers(1, 5)) + ["respond"]):
                w = float(rng.uniform(0.01, 0.06)) * dur
                stages.append({"sid": 1 + k, "parent": 0, "name": name, "t0": c, "t1": c + w,
                               "args": {"chunk": k} if name == "chunk" else {}})
                c += w * float(rng.uniform(1.0, 1.3))
            stages.insert(0, {"sid": 0, "parent": None, "name": "request", "t0": d0 + 0.005 * dur, "t1": c,
                              "args": {}})
            replica_recs.append({
                "schema": 1, "trace_id": trace_id, "site": SITES[1 + a], "pid": 100 + a, "host": "h1",
                "run": f"{rng.integers(1 << 30):08x}", "outcome": "ok" if a == attempts - 1 else "error",
                "parent_uid": jagg.span_uid_for("router", "h0", 7, sid), "spans": stages,
            })
        out.append({"schema": 1, "trace_id": trace_id, "site": "router", "pid": 7, "host": "h0",
                    "run": f"{t:08x}", "outcome": "ok", "parent_uid": None, "spans": spans})
        out.extend(replica_recs)
    return out


def drive(collector_mod, order, seed=5):
    """One collector of `collector_mod` fed the seeded records in `order`;
    returns (trace_events, critical_path, stats, the ingest answers)."""
    recs = seeded_records(seed)
    col = collector_mod.TraceCollector(grace_s=1.0, max_traces=6 if order == "evict" else 512)
    answers = []
    lines = [json.dumps(r) for r in recs]
    if order == "forward":
        answers.append(col.ingest_lines("\n".join(lines), now=0.0))
    elif order == "reversed":
        answers.append(col.ingest_lines("\n".join(reversed(lines)).encode(), now=0.0))
    elif order == "duplicated":
        # an exporter retry re-sends its batch whole: same run, first copy wins
        answers.append(col.ingest_lines("\n".join(lines[::2]), now=0.0))
        answers.append(col.ingest_lines("\n".join(lines), now=0.5))
        answers.append(col.ingest_lines(lines[:3] + ["not json", "{}", json.dumps({"trace_id": 1})], now=0.6))
    elif order == "late":
        early, late = lines[: len(lines) // 2], lines[len(lines) // 2:]
        answers.append(col.ingest_lines("\n".join(early), now=0.0))
        answers.append(col.sweep(now=5.0))
        # the later halves land after their traces sealed: merged, counted
        answers.append(col.ingest_lines("\n".join(late + early[-3:]), now=9.0))
    elif order == "evict":
        for i, line in enumerate(lines):
            answers.append(col.ingest_lines(line, now=float(i)))
    else:
        raise ValueError(order)
    return col.trace_events(), col.critical_path(), col.stats(), answers


@pytest.mark.parametrize("order", ["forward", "reversed", "duplicated", "late", "evict"])
def test_collector_matches_the_reference(order):
    port, ref = drive(pcol, order), drive(jcol, order)
    assert port[3] == ref[3]
    assert port[2] == ref[2]
    assert port[1] == ref[1]
    assert port[0] == ref[0]
    events, critical, stats, _ = port
    assert stats["traces"] == (6 if order == "evict" else 10) and critical["traces"] == stats["traces"]
    if order == "late":
        assert stats["late_spans"] > 0
    if order == "duplicated":
        assert stats["duplicate_spans"] > 0 and stats["bad_records"] == 3
    if order == "evict":
        assert stats["traces_evicted"] > 0
    # the replica's root parents into the router's dispatch span: flow arrows
    assert {e["ph"] for e in events["traceEvents"]} >= {"M", "X", "s", "f"}


def test_reversed_arrival_assembles_as_forward():
    """A trace assembles the same whichever half lands first: the same
    events and parent edges (listed in arrival order, the flow ids with
    them), the same critical path."""
    def canon(events):
        return sorted(json.dumps({k: v for k, v in e.items() if k != "id"}, sort_keys=True)
                      for e in events["traceEvents"])

    cols = [pcol.TraceCollector(), pcol.TraceCollector()]
    recs = [json.dumps(r) for r in seeded_records(5)]
    cols[0].ingest_lines(recs)
    cols[1].ingest_lines(recs[::-1])
    for tid in {r["trace_id"] for r in seeded_records(5)}:
        assert canon(cols[0].trace_events(trace_id=tid)) == canon(cols[1].trace_events(trace_id=tid))
        assert cols[0].critical_path(trace_id=tid) == cols[1].critical_path(trace_id=tid)


def _tree(tracer_cls):
    tracer = tracer_cls()
    trace = tracer.start_trace("request", trace_id="0123456789abcdef", parent_uid="router:h0:7:3", prompt="x")
    with trace.span("queue", rows=1):
        pass
    chunk = trace.begin("chunk", index=0)
    trace.end(chunk, tokens=4)
    trace.begin("respond")  # left open: finish() closes it as abandoned
    trace.finish("ok", status=200)
    return trace


@pytest.mark.parametrize("tree_side", ["port", "jax"])
def test_serialize_trace_matches_the_reference(tree_side):
    trace = _tree(PTracer if tree_side == "port" else JTracer)
    pexp = pagg.TraceExporter("http://unused", site="replica-a", thread=False)
    jexp = jagg.TraceExporter("http://unused", site="replica-a", thread=False)
    jexp.host, jexp.pid = pexp.host, pexp.pid
    first = pexp.serialize_trace(trace)
    assert first == jexp.serialize_trace(trace)  # the run nonce is cached on the trace
    assert [s["name"] for s in first["spans"]] == ["request", "queue", "chunk", "respond"]
    assert first["spans"][3]["args"] == {"abandoned": True} and first["parent_uid"] == "router:h0:7:3"
    assert pexp.spans_serialized == jexp.spans_serialized == 4


@pytest.mark.parametrize("collector_side", ["port", "jax"])
def test_the_wire_crosses_packages(collector_side):
    """A client trace exported by one package and the server trace it
    parents exported by the other, both into one collector on port 0."""
    server_mod, other = (pcol, jagg) if collector_side == "port" else (jcol, pagg)
    same = pagg if collector_side == "port" else jagg
    col = server_mod.CollectorServer(port=0, grace_s=0.05).start()
    try:
        client_tracer = (JTracer if other is jagg else PTracer)()
        client_exp = other.TraceExporter(col.url, site="bench", thread=False).attach(client_tracer)
        trace = client_tracer.start_trace("client")
        span = trace.begin("client_request")
        tid, parent = same.parse_trace_header(client_exp.context_header(trace, span))
        server_tracer = (PTracer if same is pagg else JTracer)()
        server_exp = same.TraceExporter(col.url, site="srv", thread=False).attach(server_tracer)
        served = server_tracer.start_trace("request", trace_id=tid, parent_uid=parent)
        with served.span("generate"):
            pass
        served.finish("ok")
        assert server_exp.flush(timeout_s=10.0)  # the server's half lands first
        trace.end(span)
        trace.finish("ok")
        assert client_exp.flush(timeout_s=10.0)
        assert len(col.collector) == 1
        bundle = col.collector.find(tid)
        assert sorted(p["site"] for p in bundle.procs.values()) == ["bench", "srv"]
        events = col.collector.trace_events(trace_id=tid)["traceEvents"]
        assert len([e for e in events if e["ph"] == "M"]) == 2 and {e["ph"] for e in events} >= {"s", "f"}
        assert {"client_request", "request", "generate"} <= {e["name"] for e in events if e["ph"] == "X"}
        with urllib.request.urlopen(col.url + "/healthz", timeout=10) as resp:
            assert json.loads(resp.read())["records_ingested"] == 2
        client_exp.stop(final_flush=False)
        server_exp.stop(final_flush=False)
    finally:
        col.shutdown()


# ------------------------------------------------- a CPU fleet end to end

TINY = dict(dim=32, depth=2, heads=2, dim_head=16, num_image_tokens=32, image_fmap_size=4, num_text_tokens=257,
            text_seq_len=8, attn_types=("full",), shift_tokens=True, rotary_emb=True)
BODIES = [{"prompt": "red circle", "seed": s, "timeout_s": 60} for s in (201, 202, 203, 204)]


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return DALLE(**TINY, attn_impl="flash").eval()


def _http(method, url, body=None, timeout=120):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), json.loads(resp.read())


@pytest.mark.parametrize("collector_side", ["port", "jax"])
def test_cpu_fleet_exports_one_trace_a_request(model, collector_side):
    col = (pcol if collector_side == "port" else jcol).CollectorServer(port=0, grace_s=0.05).start()
    replicas, exporters = [], []
    try:
        for name in ("a", "b"):
            eng = ContinuousEngine(model, None, max_batch=2, chunk_tokens=2, prefill_batch=2,
                                   tokenizer=ByteTokenizer(), device="cpu")
            eng.warmup()
            exp = pagg.TraceExporter(col.url, site=f"replica-{name}", registry=MetricsRegistry(), thread=False)
            exporters.append(exp)
            replicas.append(ServingServer(eng, port=0, request_timeout_s=60, exporter=exp).start())
        rexp = pagg.TraceExporter(col.url, site="router", thread=False)
        exporters.append(rexp)
        router = prouter.FleetRouter([f"{n}=http://127.0.0.1:{s.port}" for n, s in zip("ab", replicas)],
                                     registry=MetricsRegistry(), exporter=rexp, site="router")
        front = prouter.RouterServer(router, port=0, probes=False).start()
        try:
            out = [None] * len(BODIES)

            def one(i):
                out[i] = _http("POST", f"http://127.0.0.1:{front.port}/generate", BODIES[i])

            threads = [threading.Thread(target=one, args=(i,)) for i in range(len(BODIES))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
        finally:
            front.shutdown()
            for s in replicas:
                s.shutdown()  # each exporter's final flush
        assert [r[0] for r in out] == [200] * 4
        assert sorted({r[1]["x-dalle-replica"] for r in out}) == ["a", "b"]
        for exp in exporters:
            assert exp.flush(timeout_s=10.0) and exp.dropped == 0
        sites = {}
        for status, headers, payload in out:
            bundle = col.collector.find(payload["trace_id"])
            assert bundle is not None
            by_site = {p["site"]: p for p in bundle.procs.values()}
            replica = f"replica-{headers['x-dalle-replica']}"
            assert set(by_site) == {"router", replica}
            # the replica's root parents into one of the router's spans
            router_uids = {pagg.span_uid_for("router", p["host"], p["pid"], s["sid"])
                           for (k, _, _), s in bundle.spans.items() for p in [bundle.procs[k]]
                           if p["site"] == "router"}
            assert by_site[replica]["parent_uid"] in router_uids
            events = col.collector.trace_events(trace_id=payload["trace_id"])["traceEvents"]
            assert len([e for e in events if e["ph"] == "M"]) == 2 and {e["ph"] for e in events} >= {"s", "f"}
            for site in by_site:
                sites[site] = sites.get(site, 0) + sum(1 for (k, _, _) in bundle.spans
                                                        if bundle.procs[k]["site"] == site)
        assert sites["router"] > 0 and sites["replica-a"] > 0 and sites["replica-b"] > 0
        with urllib.request.urlopen(col.url + "/critical_path", timeout=10) as resp:
            critical = json.loads(resp.read())
        assert critical["traces"] == 4 and critical["stages"]["chunk"]["count"] == 4
        assert all(v["p50_ms"] <= v["p95_ms"] for v in critical["stages"].values())
    finally:
        col.shutdown()
