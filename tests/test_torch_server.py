"""The port's HTTP `ServingServer` against the JAX package's (CPU).

* Tokens over the wire: both servers, over the same tiny weights (micro
  engines, `attn_impl="flash"`: the port's plain versions, Pallas in
  interpret mode), answer the same greedy requests (`top_k=1.0`) with
  identical tokens and payloads with the same keys; every step's top-2
  image-logit gap is asserted above 1e-3 (`tests/test_torch_engine.py`),
  so identity is meaningful.
* Wire parity on one numpy fake engine: a scripted sequence gives the
  same status codes, the same presence of Retry-After, the same JSON key
  sets and the same request-log key sets from both servers: a bad body
  and an oversized one (400), a bad priority (400), `x-dalle-trace`
  adopted, unknown paths (404), the tenant quota (429), queue full
  (503), a queued timeout (504), an engine error (500) with /healthz 503
  and its recovery, drain then undrain, /metrics counters.
* The port's continuous server over its tiny engine: SSE event order, the
  terminal `result` equal to a buffered payload, a disconnect that
  cancels the request and frees its slot, a re-dispatch with the same
  `x-dalle-request-key` that re-attaches to the live stream; `drain?migrate=1` gives a 409
  whose checkpoint the port resumes to the uninterrupted tokens;
  `/debug/traces` holds the request's trace and adopts a valid
  `x-dalle-trace`; `/debug/state` has the slot table and the batcher's
  thread stack; `/debug/vitals` and `/debug/programs` answer with vitals
  off (the default); `/debug/profile`, not ported, answers 404.
"""

import base64
import http.client
import io
import json
import threading
import time
import types

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from dalle_pytorch_tpu.obs.logging import StructuredLog as JLog
from dalle_pytorch_tpu.serving.engine import GenerationEngine as JEngine
from dalle_pytorch_tpu.serving.server import ServingServer as JServer
from dalle_pytorch_tpu.training.metrics import MetricsRegistry as JRegistry
from dalle_pytorch_tpu_torch.data.tokenizer import ByteTokenizer
from dalle_pytorch_tpu_torch.obs.logging import StructuredLog
from dalle_pytorch_tpu_torch.serving.engine import ContinuousEngine, GenerationEngine
from dalle_pytorch_tpu_torch.serving.migrate import decode_checkpoint, from_wire
from dalle_pytorch_tpu_torch.serving.server import MAX_BODY_BYTES, ServingServer
from dalle_pytorch_tpu_torch.serving.streaming import SSEParser
from dalle_pytorch_tpu_torch.training.metrics import MetricsRegistry
from dalle_pytorch_tpu_torch.utils.images import decode_png
from test_torch_batcher import Stepper
from test_torch_dalle import TINY, _dalle_pair, _vae_pair
from test_torch_engine import MIN_GAP, _jax_image_logit_gaps

torch.set_num_threads(2)

MODEL = dict(num_text_tokens=257, attn_types=("full",), shift_tokens=True, rotary_emb=True)
IMG_SEQ = TINY["image_fmap_size"] ** 2
TRACE_ID = "0123456789abcdef"


def _request(port, method, path, body=None, headers=None, timeout=60):
    """(status, headers, parsed JSON or text) of one request; `body` is
    bytes or a dict sent as JSON."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = json.dumps(body).encode() if isinstance(body, dict) else body
        conn.request(method, path, body=data, headers=dict(headers or {}))
        resp = conn.getresponse()
        raw = resp.read()
        kind = resp.getheader("Content-Type", "")
        payload = json.loads(raw) if kind.startswith("application/json") else raw.decode()
        return resp.status, dict(resp.getheaders()), payload
    finally:
        conn.close()


def _post(port, body, headers=None, timeout=60):
    return _request(port, "POST", "/generate", body, headers, timeout)


def _oversized(port):
    """A /generate whose Content-Length is past the bound (no body sent)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.putrequest("POST", "/generate")
        conn.putheader("Content-Length", str(MAX_BODY_BYTES + 1))
        conn.endheaders()
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), json.loads(resp.read())
    finally:
        conn.close()


def _in_thread(fn, *args, **kw):
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("r", fn(*args, **kw)), daemon=True)
    t.start()
    return t, out


# --------------------------------------------------- tokens over the wire


@pytest.fixture(scope="module")
def pair():
    jm, variables, pm = _dalle_pair(seed=11, **MODEL)
    jv, vparams, pv = _vae_pair(seed=12)
    return jm, variables, pm, jv, vparams, pv


def test_greedy_tokens_over_the_wire_equal_the_reference(pair):
    jm, variables, pm, jv, vparams, pv = pair
    jeng = JEngine(jm, variables, vae=jv, vae_params=vparams["params"], batch_shapes=(1, 2),
                   tokenizer=JByteTokenizer())
    peng = GenerationEngine(pm, pv, batch_shapes=(1, 2), tokenizer=ByteTokenizer(), device="cpu")
    bodies = [
        {"prompt": "a red cube", "seed": 3, "top_k": 1.0},
        {"prompt": "blue sky", "seed": 5, "top_k": 1.0, "num_images": 2},
    ]
    payloads = {}
    for name, server in (("jax", JServer(jeng, port=0)), ("port", ServingServer(peng, port=0))):
        server.start()
        try:
            payloads[name] = [_post(server.port, b, timeout=300) for b in bodies]
        finally:
            server.shutdown()
    for body, (js, _, jp), (ps, _, pp) in zip(bodies, payloads["jax"], payloads["port"]):
        assert js == ps == 200
        assert sorted(pp) == sorted(jp)
        assert pp["usage"] == jp["usage"] == {
            "rows": body.get("num_images", 1), "decoded_tokens": body.get("num_images", 1) * IMG_SEQ,
            "resumed_tokens": 0,
        }
        assert pp["shape"] == jp["shape"] == [body.get("num_images", 1), 32, 32, 3]
        np.testing.assert_array_equal(np.asarray(pp["tokens"]), np.asarray(jp["tokens"]))
        text = peng.tokenize(body["prompt"])
        for toks in jp["tokens"]:
            gaps, argmaxes = _jax_image_logit_gaps(jm, variables, text, toks)
            assert argmaxes == list(toks) and gaps.min() >= MIN_GAP
        for b64 in pp["images_png_b64"]:  # zlib PNGs of the image shape
            assert decode_png(base64.b64decode(b64)).shape == (32, 32, 3)


# ------------------------------------------------------- wire parity


class WireFake:
    """The micro engine's surface, numpy only: a row's tokens carry its
    seed; `gate` parks `generate` until the test sets it."""

    image_seq_len = 4
    max_batch = 1
    batch_shapes = (1,)
    clip = None

    def __init__(self, registry):
        self.registry = registry
        self.stats = types.SimpleNamespace(compiled_shapes=(1,), warmup_batches=1)
        self.gate, self.fail, self.entered = None, False, threading.Event()

    def tokenize(self, prompt):
        return np.zeros(8, np.int32)

    def generate(self, specs):
        self.entered.set()
        if self.gate is not None:
            assert self.gate.wait(30)
        if self.fail:
            raise RuntimeError("the device fell over")
        return np.stack([np.full(self.image_seq_len, s.seed, np.int32) for s in specs]), None


def _wire_script(server_cls, registry_cls, log_cls):
    """Run the script against one server; returns (steps, log lines)."""
    eng = WireFake(registry_cls())
    buf = io.StringIO()
    server = server_cls(eng, port=0, max_queue_rows=1, request_timeout_s=30, tenant_quota_rows=1,
                        log=log_cls(stream=buf)).start()
    port, steps = server.port, []

    def rec(name, result):
        status, headers, body = result
        keys = sorted(body) if isinstance(body, dict) else None
        steps.append((name, status, "Retry-After" in headers, keys))
        return body

    try:
        rec("healthz", _request(port, "GET", "/healthz"))
        rec("not json", _post(port, b"not json"))
        rec("oversized", _oversized(port))
        rec("empty prompt", _post(port, {"prompt": ""}))
        rec("bad priority", _post(port, {"prompt": "a", "priority": "urgent"}))
        body = rec("ok traced", _post(port, {"prompt": "a", "seed": 1}, headers={
            "x-dalle-trace": f"{TRACE_ID}/client:1", "x-dalle-route": "r1;2;1",
            "x-dalle-request-key": "key-1",
        }))
        steps.append(("adopted", body["trace_id"] == TRACE_ID, body["tokens"] == [[1] * 4], None))
        body = rec("bad trace header", _post(port, {"prompt": "a", "seed": 2}, headers={"x-dalle-trace": "XYZ"}))
        steps.append(("minted", len(body["trace_id"]) == 16 and body["trace_id"] != TRACE_ID, None, None))
        rec("get unknown", _request(port, "GET", "/nope"))
        rec("post unknown", _request(port, "POST", "/nope", b""))
        # a parked engine: A in flight, B queued (tenant t, timeout 0.3 s)
        eng.gate, eng.entered = threading.Event(), threading.Event()
        ta, a = _in_thread(_post, port, {"prompt": "a", "seed": 3, "tenant": "t"})
        assert eng.entered.wait(30)
        tb, b = _in_thread(_post, port, {"prompt": "b", "seed": 4, "tenant": "t", "timeout_s": 0.3})
        deadline = time.monotonic() + 30
        while server.batcher.queue_depth_rows < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        rec("tenant quota", _post(port, {"prompt": "c", "priority": "high", "tenant": "t"}))
        rec("queue full", _post(port, {"prompt": "d", "tenant": "u"}))
        time.sleep(0.4)
        eng.gate.set()
        ta.join(30)
        tb.join(30)
        rec("in flight", a["r"])
        rec("queued timeout", b["r"])
        eng.gate = None
        eng.fail = True
        rec("engine error", _post(port, {"prompt": "e", "seed": 5}))
        rec("healthz after error", _request(port, "GET", "/healthz"))
        eng.fail = False
        rec("recovered", _post(port, {"prompt": "f", "seed": 6}))
        rec("healthz recovered", _request(port, "GET", "/healthz"))
        rec("drain", _request(port, "POST", "/admin/drain", b""))
        rec("drained generate", _post(port, {"prompt": "g"}))
        rec("healthz draining", _request(port, "GET", "/healthz"))
        rec("undrain", _request(port, "POST", "/admin/undrain", b""))
        rec("healthz undrained", _request(port, "GET", "/healthz"))
        rec("after undrain", _post(port, {"prompt": "h", "seed": 7}))
        status, headers, text = _request(port, "GET", "/metrics")
        values = {}
        for name in ("requests_total", "rejected_total", "timeouts_total", "engine_errors_total",
                     "batches_total", "images_total"):
            line = next(ln for ln in text.splitlines() if ln.startswith(f"dalle_serving_{name} "))
            values[name] = float(line.split()[1])
        steps.append(("metrics", status, values, 'dalle_serving_shed_total{reason="quota"} 1' in text))
    finally:
        server.shutdown()
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    requests = [(ln["outcome"], ln["status"], sorted(ln)) for ln in lines if ln["event"] == "request"]
    return steps, requests


def test_wire_parity_on_one_fake_engine():
    ours, ours_log = _wire_script(ServingServer, MetricsRegistry, StructuredLog)
    ref, ref_log = _wire_script(JServer, JRegistry, JLog)
    assert ours == ref
    assert sorted(ours_log) == sorted(ref_log)  # lines of concurrent requests come in either order
    status = {name: code for name, code, _, _ in ours}
    assert [status[k] for k in ("not json", "oversized", "empty prompt", "bad priority")] == [400] * 4
    assert (status["get unknown"], status["post unknown"]) == (404, 404)
    assert (status["tenant quota"], status["queue full"], status["queued timeout"]) == (429, 503, 504)
    assert (status["engine error"], status["healthz after error"]) == (500, 503)
    assert (status["healthz recovered"], status["drained generate"], status["healthz draining"]) == (200, 503, 503)
    assert status["after undrain"] == 200 and status["adopted"] is True and status["minted"] is True
    retry = {name: r for name, _, r, _ in ours}
    assert retry["tenant quota"] and retry["queue full"] and retry["drained generate"]
    assert ours[-1][2] == dict(
        requests_total=7, rejected_total=1, timeouts_total=1, engine_errors_total=1, batches_total=5,
        images_total=5,
    )
    routed = [keys for outcome, _, keys in ours_log if "replica" in keys]
    assert len(routed) == 1 and {"attempt", "hedged", "trace_id", "stages"} <= set(routed[0])


# --------------------------------------- the port's continuous server


@pytest.fixture(scope="module")
def cont(pair):
    _, _, pm, _, _, pv = pair
    return pm, pv


def _cont_engine(cont, resume=False, chunk_tokens=2):
    pm, pv = cont
    return ContinuousEngine(pm, pv, max_batch=2, chunk_tokens=chunk_tokens, prefill_batch=2,
                            tokenizer=ByteTokenizer(), device="cpu", resume_enabled=resume, preview_enabled=True)


class SSEClient:
    """A streamed /generate read event by event."""

    def __init__(self, port, body, headers=None):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        self.conn.request("POST", "/generate", body=json.dumps(dict(body, stream=True)).encode(),
                          headers=dict(headers or {}))
        self.resp = self.conn.getresponse()
        self.parser, self.events = SSEParser(), []

    def next(self):
        while True:
            line = self.resp.readline()
            if not line:
                return None
            for ev in self.parser.feed(line):
                self.events.append(ev)
                return ev

    def read_all(self):
        while self.next() is not None:
            pass
        self.conn.close()
        return self.events


def test_sse_events_and_the_terminal_result(cont):
    eng = _cont_engine(cont)
    server = ServingServer(eng, port=0, preview_every=2).start()
    try:
        body = {"prompt": "a red cube", "seed": 21, "top_k": 0.5}
        status, _, buffered = _post(server.port, body)
        client = SSEClient(server.port, body, headers={"x-dalle-request-key": "s1"})
        assert client.resp.status == 200 and client.resp.getheader("Content-Type") == "text/event-stream"
        events = client.read_all()
    finally:
        server.shutdown()
    kinds = [t for t, _, _ in events]
    assert status == 200 and kinds[0] == "open" and kinds[-1] == "result"
    assert kinds.count("result") == 1 and not {"error", "migrated"} & set(kinds)
    progress = [d["chunk"] for t, d, _ in events if t == "progress"]
    assert progress == list(range(1, IMG_SEQ // 2 + 1))
    previews = [d for t, d, _ in events if t == "preview"]
    assert [d["chunk"] for d in previews] == [c for c in progress if c % 2 == 0]
    for d in previews:
        assert [decode_png(base64.b64decode(p)).shape for p in d["previews_png_b64"]] == [(32, 32, 3)]
    seqs = [s for _, _, s in events[1:]]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    result = events[-1][1]
    assert result["tokens"] == buffered["tokens"] and sorted(result) == sorted(buffered)
    assert result["usage"] == buffered["usage"] and result["images_png_b64"] == buffered["images_png_b64"]
    assert events[0][1]["request_key"] == "s1"
    counts = {k: int(c.value) for k, c in server.registry.get("dalle_serving_stream_events_total").items()}
    assert counts == {"open": 1, "progress": len(progress), "preview": len(previews), "result": 1}


def test_sse_disconnect_cancels_the_request(cont):
    eng = _cont_engine(cont, chunk_tokens=1)  # 16 boundaries: room to see the write fail
    stepper = Stepper(eng)
    server = ServingServer(eng, port=0, preview_every=0).start()
    try:
        client = SSEClient(server.port, {"prompt": "blue sky", "seed": 3})
        assert client.next()[0] == "open"
        assert stepper.entered.wait(30)
        stepper.step()
        assert client.next()[0] == "progress"
        client.resp.close()
        client.conn.close()  # the client goes away mid-decode
        req = next(iter(server.batcher._inflight.values()))[0]
        deadline = time.monotonic() + 60
        while not req.future.done():
            assert time.monotonic() < deadline, "the disconnect never cancelled the request"
            stepper.permits.release()
            time.sleep(0.01)
        assert req.cancelled and server.batcher.allocator.n_active == 0
        assert server.registry.get("dalle_serving_cancelled_total").value == 1
        assert server.registry.get("dalle_serving_slots_active").value == 0
    finally:
        stepper.permits.release(64)
        server.shutdown()


def test_sse_redispatch_reattaches_to_the_live_stream(cont):
    eng = _cont_engine(cont, chunk_tokens=1)
    stepper = Stepper(eng)
    server = ServingServer(eng, port=0, preview_every=0).start()
    body, key = {"prompt": "blue sky", "seed": 8}, {"x-dalle-request-key": "again-1"}
    try:
        first = SSEClient(server.port, body, headers=key)
        assert first.next()[0] == "open"
        assert stepper.entered.wait(30)
        stepper.step(2)
        assert first.next()[0] == "progress"
        second = SSEClient(server.port, body, headers=key)  # the same request, dispatched again
        opened = second.next()
        assert opened[0] == "open" and opened[1]["reattach"] is True
        stepper.permits.release(64)
        events = second.read_all()
        first.read_all()  # the superseded reader ends without a terminal of its own
    finally:
        stepper.permits.release(64)
        server.shutdown()
    kinds = [t for t, _, _ in events]
    assert kinds[-1] == "result" and kinds.count("result") == 1
    assert server.registry.get("dalle_serving_requests_total").value == 1  # decoded once
    assert len(events[-1][1]["tokens"][0]) == IMG_SEQ
    assert not {"result", "error"} & {t for t, _, _ in first.events}


def test_drain_migrate_409_and_the_resume(cont):
    body = {"prompt": "a red cube", "seed": 31, "top_k": 0.5}
    eng = _cont_engine(cont, resume=True)
    server = ServingServer(eng, port=0).start()
    try:
        _, _, reference = _post(server.port, body)
        chunks_before = eng.stats.chunks
        stepper = Stepper(eng)
        t, out = _in_thread(_post, server.port, body, headers={"x-dalle-request-key": "m1"})
        assert stepper.entered.wait(30)
        stepper.step(3)  # parked at the fourth chunk's entry: three chunks decoded
        td, drained = _in_thread(_request, server.port, "POST", "/admin/drain?migrate=1", b"")
        deadline = time.monotonic() + 30
        while server.batcher._migrate_request is None and time.monotonic() < deadline:
            time.sleep(0.002)
        stepper.permits.release(64)
        td.join(60)
        t.join(60)
        status, _, payload = out["r"]
        assert status == 409 and payload["migrated"] is True and payload["resumed_at_chunk"] == chunks_before + 4
        d_status, _, d_body = drained["r"]
        assert d_status == 200 and d_body["migrate"]["migrated"] == 1
        assert d_body["migrate"]["checkpoints"]["m1"] == payload["checkpoint"]
        cp = decode_checkpoint(from_wire(payload["checkpoint"]), server.resume_fingerprint)
        assert cp.rows[0].pos == 8 and not cp.rows[0].done
        h_status, _, health = _request(server.port, "GET", "/healthz")
        assert h_status == 503 and health["draining"] is True
        assert _request(server.port, "POST", "/admin/undrain", b"")[0] == 200
        status, _, resumed = _post(server.port, dict(body, resume=payload["checkpoint"]))
    finally:
        server.shutdown()
    assert status == 200 and resumed["tokens"] == reference["tokens"]
    assert resumed["usage"] == {"rows": 1, "decoded_tokens": IMG_SEQ - 8, "resumed_tokens": 8}
    assert eng.stats.resume_dispatches == 1


def test_debug_endpoints(cont):
    eng = _cont_engine(cont)
    server = ServingServer(eng, port=0).start()
    try:
        port = server.port
        _, _, minted = _post(port, {"prompt": "x", "seed": 1})
        _, _, adopted = _post(port, {"prompt": "y", "seed": 2}, headers={"x-dalle-trace": TRACE_ID})
        assert adopted["trace_id"] == TRACE_ID and len(minted["trace_id"]) == 16
        status, _, traces = _request(port, "GET", "/debug/traces")
        ids = {e["args"].get("trace_id") for e in traces["traceEvents"] if e["ph"] == "X"}
        assert status == 200 and {minted["trace_id"], TRACE_ID} <= ids
        names = [e["name"] for e in traces["traceEvents"] if e["ph"] == "X" and e["args"]["trace_id"] == TRACE_ID]
        assert {"request", "queue", "prefill", "chunk", "harvest", "respond"} <= set(names)
        assert names.count("chunk") == IMG_SEQ // 2
        status, _, one = _request(port, "GET", f"/debug/traces?trace_id={TRACE_ID}")
        assert status == 200 and {e["args"]["trace_id"] for e in one["traceEvents"] if e["ph"] == "X"} == {TRACE_ID}
        assert _request(port, "GET", "/debug/traces?trace_id=ffffffffffffffff")[0] == 404
        assert _request(port, "GET", "/debug/traces?n=0")[0] == 400
        # a request held mid-decode shows in the slot table
        stepper = Stepper(eng)
        t, _ = _in_thread(_post, port, {"prompt": "z", "seed": 3})
        assert stepper.entered.wait(30)
        status, _, state = _request(port, "GET", "/debug/state")
        stepper.permits.release(64)
        t.join(60)
        assert status == 200
        assert [v["rows"] for v in state["batcher"]["slots_inflight"].values()] == [1]
        stacks = state["worker_stacks"]
        assert any("batcher" in name for name in stacks) and any("step_chunk" in ln for s in stacks.values() for ln in s)
        assert state["engine"]["max_batch"] == 2 and "recent_compiles" in state
        status, _, text = _request(port, "GET", "/metrics?exemplars=1")
        assert status == 200 and text.rstrip().endswith("# EOF") and '# {trace_id="' in text
        # vitals off by default: the inert sampler's empty ring, no cost table
        status, _, vitals = _request(port, "GET", "/debug/vitals")
        assert status == 200 and vitals["enabled"] is False and vitals["samples_taken"] == 0
        status, _, programs = _request(port, "GET", "/debug/programs")
        assert status == 200 and programs["programs"] == [] and "note" in programs
        # /debug/profile answers (its captures: tests/test_torch_profiler.py)
        assert _request(port, "POST", "/debug/profile?seconds=0", b"")[0] == 400
        assert state["profiler"]["captures"] == 0 and set(state["compiles"]) == {"count", "cache_hits", "uncached"}
    finally:
        server.shutdown()
