"""The port's on-demand profiler (CPU), after the reference's
`tests/test_obs.py` profiler tests.

* The guard rails of `ProfilerCapture` with its torch seams stubbed:
  single flight (`ProfilerBusy`), the root gate (`PermissionError`), the
  `max_seconds` clamp, a directory for every attempt (a failed one too).
* The `POST /debug/profile` contract: the same script of requests against
  the port's `ServingServer` and the JAX one, each with its stubbed
  capture, gives the same statuses and answer keys (200, 409, 400, 403,
  500), and `/debug/state` shows the profiler.
* One real CPU `torch.profiler` capture through the endpoint while the
  engine's thread runs tensor ops: the Chrome trace parses and holds
  those ops (every thread is recorded, not only the capturing one).
"""

import json
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.obs.profiler import ProfilerCapture as JProfilerCapture
from dalle_pytorch_tpu.serving.server import ServingServer as JServer
from dalle_pytorch_tpu.training.metrics import MetricsRegistry as JRegistry
from dalle_pytorch_tpu_torch.obs.profiler import TRACE_FILE, ProfilerBusy, ProfilerCapture
from dalle_pytorch_tpu_torch.serving.server import ServingServer
from dalle_pytorch_tpu_torch.training.metrics import MetricsRegistry


class FakeEngine:
    """The micro engine's surface, numpy only; `work` runs in `generate`
    (on the batcher's thread)."""

    image_seq_len = 4
    max_batch = 1
    batch_shapes = (1,)
    clip = None
    device = "cpu"

    def __init__(self, registry, work=None):
        self.registry = registry
        self.work = work
        self.stats = types.SimpleNamespace(compiled_shapes=(1,), warmup_batches=1)

    def tokenize(self, prompt):
        return np.zeros(8, np.int32)

    def generate(self, specs):
        if self.work is not None:
            self.work()
        return np.stack([np.full(self.image_seq_len, s.seed, np.int32) for s in specs]), None


def stubbed(base):
    """`base` with its torch (or jax) touchpoints stubbed: a marker file
    instead of a trace, a settable process index, a settable failure."""

    class Stub(base):
        index = 0
        fail = False

        def _process_index(self):
            return self.index

        def _start(self, trace_dir):
            if self.fail:
                raise RuntimeError("the profiler would not start")
            (trace_dir / "stub.trace").write_text("x")

        def _stop(self):
            pass

    return Stub


def test_guard_rails(tmp_path):
    p = stubbed(ProfilerCapture)(out_dir=str(tmp_path), max_seconds=0.05)
    t0 = time.monotonic()
    first = p.capture(30.0)  # clamped to max_seconds
    assert time.monotonic() - t0 < 5.0 and (first / "stub.trace").exists() and p.last_dir == first
    with pytest.raises(ValueError):
        p.capture(0)
    p.index = 1
    with pytest.raises(PermissionError, match="process 1"):
        p.capture(0.01)
    p.index, p.fail = 0, True
    with pytest.raises(RuntimeError):
        p.capture(0.01)
    assert not p.busy and p.captures == 2  # the failed attempt counted
    p.fail = False
    third = p.capture(0.01)
    dirs = sorted(d.name for d in tmp_path.iterdir())
    assert len(dirs) == 3 and third.name.endswith("_2") and first.name.endswith("_0")


def test_single_flight(tmp_path):
    p = stubbed(ProfilerCapture)(out_dir=str(tmp_path), max_seconds=5.0)
    started = threading.Event()
    p._start = lambda d: started.set()
    t = threading.Thread(target=p.capture, args=(0.5,))
    t.start()
    assert started.wait(10)
    assert p.busy and p.detail()["capturing"]
    with pytest.raises(ProfilerBusy):
        p.capture(0.1)
    t.join(10)
    assert not p.busy and p.captures == 1


def _script(server_cls, registry_cls, profiler_cls, tmp_path):
    """The request script against one server; returns [(step, status, keys)]."""
    profiler = stubbed(profiler_cls)(out_dir=str(tmp_path / "prof"))
    server = server_cls(FakeEngine(registry_cls()), port=0, max_delay_ms=5, profiler=profiler).start()
    steps = []

    def post(step, query, data=b""):
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/debug/profile{query}", data=data,
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                status, body = resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as err:
            status, body = err.code, json.loads(err.read())
        steps.append((step, status, sorted(body)))
        return body

    try:
        body = post("capture", "?seconds=0.05")
        assert Path(body["trace_dir"]).parent == tmp_path / "prof" and body["seconds"] == 0.05
        body = post("clamped", "?seconds=1e9")
        assert body["seconds"] == profiler.max_seconds
        assert profiler._lock.acquire(blocking=False)
        try:
            post("in flight", "?seconds=1")
        finally:
            profiler._lock.release()
        post("bad seconds", "?seconds=abc")
        post("negative seconds", "?seconds=-1")
        post("a body", "?seconds=0.01", data=b"{}")
        profiler.index = 1
        post("not root", "?seconds=1")
        profiler.index, profiler.fail = 0, True
        post("failed capture", "?seconds=0.01")
    finally:
        server.shutdown()
    return steps


def test_profile_endpoint_matches_the_reference(tmp_path, monkeypatch):
    # the clamped capture's 60 s are not waited out
    monkeypatch.setattr(time, "sleep", lambda s: None)
    ours = _script(ServingServer, MetricsRegistry, ProfilerCapture, tmp_path / "port")
    ref = _script(JServer, JRegistry, JProfilerCapture, tmp_path / "jax")
    assert ours == ref
    assert [s[1] for s in ours] == [200, 200, 409, 400, 400, 200, 403, 500]


def test_real_cpu_capture_through_the_endpoint(tmp_path):
    stop = threading.Event()

    def work():  # the engine's thread: tensor ops the trace must hold
        a = torch.randn(32, 32)
        for _ in range(200):
            a = torch.tanh(a @ a)
        stop.set()

    server = ServingServer(FakeEngine(MetricsRegistry(), work=work), port=0, max_delay_ms=5,
                           profiler=ProfilerCapture(out_dir=str(tmp_path / "prof"), device="cpu")).start()
    try:
        def generate():
            req = urllib.request.Request(f"http://127.0.0.1:{server.port}/generate",
                                         data=json.dumps({"prompt": "x", "seed": 1}).encode(), method="POST",
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 200

        def when_capturing():
            deadline = time.monotonic() + 60
            while not server.profiler.capturing and time.monotonic() < deadline:
                time.sleep(0.01)
            generate()

        t = threading.Thread(target=when_capturing)
        t.start()
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/debug/profile?seconds=1", data=b"",
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = json.loads(resp.read())
        t.join(60)
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/debug/state", timeout=30) as resp:
            state = json.loads(resp.read())
    finally:
        server.shutdown()
    assert stop.is_set() and state["profiler"]["captures"] == 1 and state["profiler"]["last_dir"] == body["trace_dir"]
    events = json.loads((Path(body["trace_dir"]) / TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"aten::mm", "aten::tanh"} <= names
