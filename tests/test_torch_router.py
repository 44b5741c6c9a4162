"""The port's replica fleet router against the JAX package's (CPU).

* Differential: the same scripted replica answers (200, 503 with
  Retry-After, 429, 500, transport failures, slow answers for hedging,
  409 migrations) and probe results go through the JAX `FleetRouter` and
  the port's, each on its own stepped clock through the `_post` / `_probe`
  seams. They must agree with no tolerance on every reply (status, body,
  headers), every dispatch (replica, body, `x-dalle-route`,
  `x-dalle-request-key`), the replicas' states and breaker fields, the
  retry budget, the quarantine outcome, the checkpoint registry and the
  `dalle_router_*` (and usage) exposition; `request_fingerprint` and the
  header codecs agree on the same inputs.
* The slice as a whole: two in-process port replicas (a tiny
  `ContinuousEngine` behind `ServingServer`, on the CPU) behind the port's
  `RouterServer` and behind the JAX one give the tokens of a direct run; a
  replica wedged mid-decode (an event-held stall) still leaves every
  request complete with the same tokens; a crash-spool hand-off
  (`POST /admin/spool` with a real beacon of a request held mid-decode)
  resumes the request on the other replica at its journaled position with
  the same tokens; `serve --router` runs as a subprocess without torch,
  prints its readiness line and exits 0 on SIGTERM.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.request
from pathlib import Path

import pytest
import torch

from dalle_pytorch_tpu.serving import router as jrouter
from dalle_pytorch_tpu.training.metrics import MetricsRegistry as JRegistry
from dalle_pytorch_tpu_torch.data.tokenizer import ByteTokenizer
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.obs.aggregate import TraceExporter
from dalle_pytorch_tpu_torch.serving import router as prouter
from dalle_pytorch_tpu_torch.serving.engine import ContinuousEngine
from dalle_pytorch_tpu_torch.serving.faults import FaultInjector
from dalle_pytorch_tpu_torch.serving.migrate import CheckpointSpool, to_wire
from dalle_pytorch_tpu_torch.serving.server import ServingServer
from dalle_pytorch_tpu_torch.training.metrics import MetricsRegistry

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)

SIDES = {
    "jax": (jrouter.FleetRouter, JRegistry),
    "port": (prouter.FleetRouter, MetricsRegistry),
}


class Clock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += float(s)


class Script:
    """Scripted replicas: each name's queue of answers, consumed one a
    dispatch ("ok" past its end), and of probe results ("ok" past its
    end). Answers: ok[:sleep s], busy (503 + Retry-After 7), quota (429 +
    Retry-After 3), error (500), reset (a transport failure), migrate (a
    409 carrying a checkpoint)."""

    def __init__(self, plan=None, probes=None):
        self.plan = {k: list(v) for k, v in (plan or {}).items()}
        self.probes = {k: list(v) for k, v in (probes or {}).items()}
        self.calls = []
        self.lock = threading.Lock()

    def post(self, rep, payload, headers, timeout_s, conns):
        body = json.loads(payload)
        with self.lock:
            self.calls.append((rep.name, body, headers.get("x-dalle-route"), headers.get("x-dalle-request-key")))
            queue = self.plan.get(rep.name, [])
            answer = queue.pop(0) if queue else "ok"
        kind, _, arg = answer.partition(":")
        if kind == "ok":
            if arg:
                time.sleep(float(arg))
            resumed = 4 if "resume" in body else 0
            return 200, json.dumps({
                "tokens": [[int(body["seed"]) % 97] * 4], "seed": body["seed"], "latency_ms": 12.5,
                "usage": {"rows": 1, "decoded_tokens": 16 - resumed, "resumed_tokens": resumed},
            }).encode(), {}
        if kind == "busy":
            return 503, b'{"error": "queue full"}', {"Retry-After": "7"}
        if kind == "quota":
            return 429, b'{"error": "tenant over quota"}', {"Retry-After": "3"}
        if kind == "error":
            return 500, b'{"error": "engine fell over"}', {}
        if kind == "migrate":
            return 409, json.dumps({"migrated": True, "checkpoint": "CKPT-" + rep.name,
                                    "resumed_at_chunk": 3}).encode(), {}
        if kind == "reset":
            raise ConnectionResetError("scripted reset")
        raise AssertionError(answer)

    def probe(self, rep):
        with self.lock:
            queue = self.probes.get(rep.name, [])
            answer = queue.pop(0) if queue else "ok"
        if answer == "down":
            raise ConnectionRefusedError("scripted probe failure")
        if answer == "degraded":
            return 200, {"status": "degraded"}
        if answer == "503":
            return 503, {}
        return 200, {"status": "ok"}


def make_router(side, script, clock, n=2, **kw):
    cls, registry = SIDES[side]
    kw.setdefault("probe_interval_s", 0.5)
    router = cls([f"r{i}=http://127.0.0.1:{9000 + i}" for i in range(n)], registry=registry(), time_fn=clock, **kw)
    router._seed_counter = 4242  # pinned seeds: equal on both sides
    router._post = script.post
    router._probe = script.probe
    return router


def route(router, body, headers=None):
    status, raw, extra = router.handle_generate(json.dumps(body).encode(), headers or {})
    return status, json.loads(raw) if raw else None, sorted(extra)


def _scrub(obj):
    """Drop the fields that read a wall clock or the process identity."""
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items() if k not in ("ts", "site", "pid", "host", "at")}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


def observe(router, script):
    """Everything both routers must agree on after a scenario."""
    lines = sorted(
        ln for ln in router.registry.render().splitlines()
        if ln.startswith(("dalle_router_", "dalle_fleet_")) or ln.startswith("# TYPE dalle_")
    )
    health = router.health()
    return dict(
        calls=script.calls, detail=_scrub(router.detail()), budget=router.budget.balance,
        health=(health[0], _scrub({k: v for k, v in health[1].items() if k != "uptime_s"})),
        usage=router.usage.summary(), exposition=lines,
    )


# ------------------------------------------------------------ scenarios


def sc_spread(router, script, clock):
    return [route(router, {"prompt": "x", "seed": s}) for s in range(4)]


def sc_seed_pinned(router, script, clock):
    return [route(router, {"prompt": "no seed", "num_images": 2}), route(router, {"prompt": "again"})]


def sc_degraded_serves_high_not_low(router, script, clock):
    script.probes["r0"] = ["degraded"]
    router.probe_once()
    out = [route(router, {"prompt": "lo", "seed": s, "priority": "low"}) for s in range(3)]
    out += [route(router, {"prompt": "hi", "seed": s, "priority": "high"}) for s in range(3)]
    return out


def sc_retry_after_cools_class_only(router, script, clock):
    script.plan["r0"] = ["busy"]
    out = [route(router, {"prompt": "n", "seed": 1})]
    out += [route(router, {"prompt": "n", "seed": s}) for s in (2, 3)]
    out += [route(router, {"prompt": "h", "seed": 4, "priority": "high"})]
    clock.advance(8)
    out += [route(router, {"prompt": "n", "seed": s}) for s in (5, 6)]
    return out


def sc_quota_passes_through(router, script, clock):
    script.plan["r0"] = ["quota", "quota"]
    script.plan["r1"] = ["quota"]
    return [route(router, {"prompt": "q", "seed": s, "tenant": "flood"}) for s in range(4)]


def sc_error_fails_over_once(router, script, clock):
    script.plan["r0"] = ["error"]
    script.plan["r1"] = ["error", "error"]
    return [route(router, {"prompt": "e", "seed": s}) for s in range(3)]


def sc_bad_requests(router, script, clock):
    out = [route(router, {"prompt": "p", "priority": "urgent"}), route(router, {"prompt": "p", "num_images": 0})]
    out.append(route(router, {"prompt": "p", "timeout_s": 1e9}))
    status, raw, _ = router.handle_generate(b"not json", {})
    return out + [(status, json.loads(raw))]


def sc_breaker_and_trial(router, script, clock):
    script.plan["r0"] = ["error"] * 4
    out = [route(router, {"prompt": "b", "seed": s}) for s in range(4)]
    clock.advance(1.5)
    router.probe_once()  # ejected -> half-open
    out += [route(router, {"prompt": "t", "seed": s}) for s in (10, 11, 12)]
    return out


def sc_failed_trial_deepens_backoff(router, script, clock):
    script.plan["r0"] = ["error"] * 4 + ["reset"]
    out = [route(router, {"prompt": "b", "seed": s}) for s in range(4)]
    clock.advance(1.5)
    router.probe_once()
    out += [route(router, {"prompt": "t", "seed": s}) for s in (20, 21)]
    clock.advance(1.5)
    router.probe_once()
    clock.advance(1.0)
    router.probe_once()
    return out


def sc_probe_failures_eject_and_cap(router, script, clock):
    script.probes["r1"] = ["down"] * 12
    for _ in range(12):
        router.probe_once()
        clock.advance(0.6)
    out = [route(router, {"prompt": "p", "seed": s}) for s in range(2)]
    for _ in range(8):
        clock.advance(40)
        router.probe_once()
    return out


def sc_outage_budget(router, script, clock):
    script.plan = {"r0": ["reset"] * 40, "r1": ["reset"] * 40}
    out = [route(router, {"prompt": "o", "seed": s}) for s in range(8)]
    script.plan = {}
    for _ in range(4):
        clock.advance(31)
        router.probe_once()
    out += [route(router, {"prompt": "back", "seed": s}) for s in range(4)]
    return out


def sc_all_ejected_unroutable(router, script, clock):
    script.probes = {"r0": ["down"] * 3, "r1": ["down"] * 3}
    for _ in range(3):
        router.probe_once()
        clock.advance(0.6)
    return [route(router, {"prompt": "u", "seed": 1}), route(router, {"prompt": "u", "seed": 2, "priority": "high"})]


def sc_quarantine(router, script, clock):
    body = {"prompt": "poison", "seed": 66}
    script.plan = {"r0": ["reset"], "r1": ["reset"]}
    out = [route(router, body)]
    clock.advance(10)
    script.plan = {"r0": ["reset"], "r1": ["reset"]}
    out.append(route(router, body))
    out.append(route(router, body))  # refused at ingress
    out.append(route(router, {"prompt": "innocent", "seed": 67}))
    return out


def sc_drain_undrain(router, script, clock):
    out = [route(router, {"prompt": "d", "seed": 1})]
    out.append(_scrub(router.drain("r0")))
    out += [route(router, {"prompt": "d", "seed": s}) for s in (2, 3)]
    out.append(router.drain("nope"))
    out.append(_scrub(router.undrain("r0")))
    out += [route(router, {"prompt": "d", "seed": s}) for s in (4, 5)]
    return out


def sc_spool_crash_resume(router, script, clock):
    body = {"prompt": "crash me", "seed": 911}
    key = SIDES_FP[type(router).__module__](body)
    out = [router.ingest_spool("r0-host", {key: "WIRE-911", "bad/key": "x", "k2": 5})]
    script.plan = {"r0": ["reset"], "r1": ["reset"]}
    out.append(route(router, body))
    out.append([(c[0], c[1].get("resume"), c[3]) for c in script.calls])
    return out


def sc_drain_migrate_409(router, script, clock):
    script.plan = {"r0": ["migrate"]}
    return [route(router, {"prompt": "m", "seed": 5}), [(c[0], c[1].get("resume")) for c in script.calls]]


def sc_hedge(router, script, clock):
    script.plan = {"r0": ["ok:0.6"]}
    out = [route(router, {"prompt": "h", "seed": 7})]
    script.plan = {"r0": ["ok"], "r1": ["ok"]}
    out.append(route(router, {"prompt": "h", "seed": 8}))
    time.sleep(0.8)  # the losing primary settles its own result
    return out


SIDES_FP = {
    jrouter.FleetRouter.__module__: jrouter.request_fingerprint,
    prouter.FleetRouter.__module__: prouter.request_fingerprint,
}

SCENARIOS = {
    "spread": (sc_spread, {}),
    "seed_pinned": (sc_seed_pinned, {}),
    "degraded_serves_high_not_low": (sc_degraded_serves_high_not_low, {}),
    "retry_after_cools_class_only": (sc_retry_after_cools_class_only, {}),
    "quota_passes_through": (sc_quota_passes_through, {}),
    "error_fails_over_once": (sc_error_fails_over_once, {}),
    "bad_requests": (sc_bad_requests, {}),
    "breaker_and_trial": (sc_breaker_and_trial, {}),
    "failed_trial_deepens_backoff": (sc_failed_trial_deepens_backoff, {}),
    "probe_failures_eject_and_cap": (sc_probe_failures_eject_and_cap, {}),
    "outage_budget": (sc_outage_budget, {"retry_budget_initial": 3.0}),
    "all_ejected_unroutable": (sc_all_ejected_unroutable, {}),
    "quarantine": (sc_quarantine, {"quarantine_after": 2}),
    "drain_undrain": (sc_drain_undrain, {}),
    "spool_crash_resume": (sc_spool_crash_resume, {}),
    "drain_migrate_409": (sc_drain_migrate_409, {}),
    "hedge": (sc_hedge, {"hedge_after_ms": 100.0}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_decisions_match_the_reference(name):
    fn, kw = SCENARIOS[name]
    seen = {}
    for side in SIDES:
        script, clock = Script(), Clock()
        router = make_router(side, script, clock, **kw)
        transcript = fn(router, script, clock)
        seen[side] = dict(transcript=transcript, **observe(router, script))
    for key in seen["jax"]:
        assert seen["port"][key] == seen["jax"][key], key
    if name == "hedge":  # the slow primary lost to its hedge on both sides
        assert any(ln.startswith("dalle_router_hedge_wins_total 1") for ln in seen["port"]["exposition"])
    if name == "quarantine":
        assert seen["port"]["transcript"][2][0] == 422
    if name == "spool_crash_resume":
        assert ("r1", "WIRE-911") in [(c[0], c[1]) for c in seen["port"]["transcript"][2]]


@pytest.mark.parametrize("body", [
    {"prompt": "a", "seed": 1},
    {"seed": 1, "prompt": "a", "timeout_s": 5},
    {"prompt": "a", "seed": 1, "resume": "xyz"},
    {"prompt": "a"},
    {"prompt": "a", "num_images": 3, "tenant": "t", "priority": "low", "top_k": 0.5},
])
def test_request_fingerprint_matches(body):
    assert prouter.request_fingerprint(dict(body)) == jrouter.request_fingerprint(dict(body))


@pytest.mark.parametrize("value", ["r0;1;0", "west-1;12;1", "bad;;;", "x" * 70 + ";1;0", "", None, "r;99999;0"])
def test_route_header_codec_matches(value):
    assert prouter.parse_route_header(value) == jrouter.parse_route_header(value)
    assert prouter.format_route_header("we st/1", 3, True) == jrouter.format_route_header("we st/1", 3, True)


def test_retry_budget_and_registry_units_match():
    pb, jb = prouter.RetryBudget(ratio=0.5, initial=2.0, cap=3.0), jrouter.RetryBudget(ratio=0.5, initial=2.0, cap=3.0)
    ops = ["w", "w", "w", "d", "d", "d", "d", "w", "d"] * 3
    got = [(getattr(b, {"w": "withdraw", "d": "deposit"}[o])(), b.balance) for b in (pb, jb) for o in ops]
    half = len(got) // 2
    assert got[:half] == got[half:]
    assert (pb.withdrawn, pb.denied) == (jb.withdrawn, jb.denied)
    pr_, jr_ = prouter.CheckpointRegistry(capacity=2), jrouter.CheckpointRegistry(capacity=2)
    for reg in (pr_, jr_):
        for k in "abc":
            reg.put(k, "w" + k)
    assert [pr_.take(k) and pr_.take(k) for k in "abc"] == [jr_.take(k) and jr_.take(k) for k in "abc"]
    assert pr_.detail() == jr_.detail()


# ------------------------------------------------- the slice as a whole

TINY = dict(dim=32, depth=2, heads=2, dim_head=16, num_image_tokens=32, image_fmap_size=4, num_text_tokens=257,
            text_seq_len=8, attn_types=("full",), shift_tokens=True, rotary_emb=True)


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return DALLE(**TINY, attn_impl="flash").eval()


def replica(model, **kw):
    eng = ContinuousEngine(model, None, max_batch=2, chunk_tokens=2, prefill_batch=2, tokenizer=ByteTokenizer(),
                           device="cpu", resume_enabled=True)
    eng.warmup()
    return eng, ServingServer(eng, port=0, request_timeout_s=60, **kw).start()


def http(method, port, path, body=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as err:
        resp = err
    with resp:
        return resp.status, dict(resp.headers), json.loads(resp.read() or b"{}")


def fleet(side, servers, **kw):
    cls, registry = SIDES[side]
    server_cls = jrouter.RouterServer if side == "jax" else prouter.RouterServer
    router = cls([f"r{i}=http://127.0.0.1:{s.port}" for i, s in enumerate(servers)], registry=registry(), **kw)
    return router, server_cls(router, port=0, probes=False).start()


def wave(port, bodies):
    out = [None] * len(bodies)

    def one(i):
        out[i] = http("POST", port, "/generate", bodies[i], timeout=120)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    return out


BODIES = [{"prompt": "red circle", "seed": s, "timeout_s": 60} for s in (101, 102, 103, 104)]


@pytest.fixture(scope="module")
def direct(model):
    """The tokens of a direct run of BODIES on one replica."""
    _, server = replica(model)
    try:
        return [http("POST", server.port, "/generate", b, timeout=120)[2]["tokens"] for b in BODIES]
    finally:
        server.shutdown()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_fleet_of_port_replicas_matches_a_direct_run(model, direct, side):
    servers = [replica(model)[1] for _ in range(2)]
    router, front = fleet(side, servers)
    try:
        replies = wave(front.port, BODIES)
        assert [r[0] for r in replies] == [200] * 4
        assert [r[2]["tokens"] for r in replies] == direct
        assert sorted({r[1]["x-dalle-replica"] for r in replies}) == ["r0", "r1"]
    finally:
        front.shutdown()
        for s in servers:
            s.shutdown()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_replica_wedged_mid_decode_all_complete_bit_identical(model, direct, side):
    servers = [replica(model)[1] for _ in range(2)]
    unwedge = threading.Event()
    servers[0].engine.faults = FaultInjector().stall_nth("chunk", 1, until=unwedge)
    router, front = fleet(side, servers, attempt_timeout_s=4.0)
    try:
        replies = wave(front.port, BODIES)
        assert [r[0] for r in replies] == [200] * 4
        assert [r[2]["tokens"] for r in replies] == direct
        failovers = dict(router.registry.get("dalle_router_failovers_total").items())
        assert int(failovers["transport"].value) >= 1
        assert all(r[1]["x-dalle-replica"] == "r1" for r in replies)
    finally:
        unwedge.set()
        front.shutdown()
        for s in servers:
            s.shutdown()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_crash_spool_handoff_resumes_at_the_journaled_position(model, direct, side, tmp_path):
    """A request held mid-decode on replica 0 journals a real beacon (every
    chunk); replica 0 then dies (its listener gone: connection refused),
    the beacon is handed to the router as the supervisor would, and the
    request routed again resumes on replica 1 at the journaled position
    with the direct run's tokens."""
    body = BODIES[2]
    key = prouter.request_fingerprint(dict(body))
    servers = [replica(model, checkpoint_spool=str(tmp_path / "spool0"), spool_every=1)[1], replica(model)[1]]
    hold = threading.Event()
    servers[0].engine.faults = FaultInjector().stall_nth("chunk", 3, until=hold)
    try:
        # the router's dispatch carries the request key; a direct client's
        # beacon is keyed the same way when it sends the header
        req = urllib.request.Request(f"http://127.0.0.1:{servers[0].port}/generate", method="POST",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json", "x-dalle-request-key": key})
        held = threading.Thread(target=lambda: urllib.request.urlopen(req, timeout=120).read(), daemon=True)
        held.start()
        spool = CheckpointSpool(tmp_path / "spool0")
        deadline = time.monotonic() + 30
        while key not in spool.read() and time.monotonic() < deadline:
            time.sleep(0.01)
        beacon = {key: to_wire(spool.read()[key])}
        hold.set()
        held.join(60)
        servers[0].shutdown(drain=False)  # the corpse: connection refused
        router, front = fleet(side, servers)
        try:
            router.replicas[1].requests = 5  # the next dispatch meets the corpse first
            status, _, out = http("POST", front.port, "/admin/spool", {"replica": "r0", "checkpoints": beacon})
            assert (status, out["ingested"]) == (200, 1)
            status, headers, payload = http("POST", front.port, "/generate", body, timeout=120)
            assert status == 200 and headers["x-dalle-replica"] == "r1"
            assert payload["tokens"] == direct[2]
            assert payload["usage"]["resumed_tokens"] >= 2  # at the journaled position, not 0
            migs = dict(router.registry.get("dalle_router_migrations_total").items())
            assert int(migs["crash"].value) == 1
        finally:
            front.shutdown()
    finally:
        hold.set()
        for s in servers:
            s.shutdown()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_streamed_request_through_the_router(model, direct, side):
    """`"stream": true` through the router: the splice forwards the
    replica's events, the terminal `result` carries the direct run's
    tokens."""
    from dalle_pytorch_tpu_torch.serving.streaming import SSEParser

    servers = [replica(model)[1] for _ in range(2)]
    router, front = fleet(side, servers)
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{front.port}/generate", method="POST",
                                     data=json.dumps(dict(BODIES[1], stream=True)).encode(),
                                     headers={"Content-Type": "application/json"})
        parser, events = SSEParser(), []
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.headers["Content-Type"] == "text/event-stream"
            for line in resp:
                events += parser.feed(line)
        kinds = [e[0] for e in events]
        assert kinds[0] == "open" and "progress" in kinds and kinds[-1] == "result"
        assert events[-1][1]["tokens"] == direct[1]
    finally:
        front.shutdown()
        for s in servers:
            s.shutdown()


def test_trace_export_is_refused_naming_the_later_slice(capsys):
    """`--trace_export` was refused until the fleet exporter was ported:
    now it is refused only as the reference refuses it, beside
    `--no_tracing`, and otherwise wires a `TraceExporter` to the router's
    tracer."""
    with pytest.raises(SystemExit) as err:
        prouter.main(["--replicas", "http://127.0.0.1:1", "--trace_export", "http://collector:1", "--no_tracing"])
    assert err.value.code == 2 and "--no_tracing" in capsys.readouterr().err
    args = types.SimpleNamespace(
        trace_export="http://collector:1", trace_site="edge", replicas="http://127.0.0.1:1", attempt_timeout_s=1.0,
        hedge_after_ms=None, probe_interval_s=1.0, eject_after=3, error_rate_threshold=0.5, error_min_samples=4,
        retry_budget_ratio=0.2, retry_budget_initial=10.0,
    )
    router = prouter.router_from_args(args)
    try:
        assert isinstance(router.exporter, TraceExporter) and router.tracer.exporter is router.exporter
        assert router.exporter.url == "http://collector:1" and router.exporter.site == "edge"
        assert router.registry.get("dalle_obs_export_dropped_total") is not None
    finally:
        router.exporter.stop(final_flush=False)


def test_serve_router_subprocess_without_torch(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "dalle_pytorch_tpu_torch.serve", "--router", "--port", "0", "--replicas",
         "a=http://127.0.0.1:1", "--probe_interval_s", "0.2", "--request_log_path", str(tmp_path / "r.jsonl")],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(REPO)}, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("[router] listening on http://127.0.0.1:"), line
        port = int(line.split("http://")[1].split()[0].rsplit(":", 1)[1])
        status, _, health = http("GET", port, "/healthz")
        assert status in (200, 503) and health["role"] == "router"
        assert "libtorch" not in Path(f"/proc/{proc.pid}/maps").read_text()
        status, _, usage = http("GET", port, "/debug/usage")
        assert status == 200 and usage["tenants"] == []
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0 and "[router] shutdown complete" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
