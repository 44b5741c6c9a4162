"""The port's crash-fast replica supervisor against the JAX package's (CPU).

* The restart policy: the same exit sequences (exit codes, clock, uptime,
  readiness) through both `_on_exit`s give the same delays, states,
  streaks, crash-loop hold-downs, events and `dalle_supervisor_*`
  counters; `backoff_schedule` agrees at every n.
* The run loop through the `spawn_fn` / `probe_fn` seams with scripted
  children: an abnormal exit restarts, a hung boot is recycled at the
  ready timeout, readiness waits for the probe; the spool hand-off after a
  restart POSTs the same payload as the JAX supervisor's (a journal the
  dead child left, keyed by request, handed over once and cleared), and a
  first boot clears a stale journal without handing it over.
* The serve twin's supervised child is `python -m
  dalle_pytorch_tpu_torch.serve` with the supervisor's own flags removed;
  the supervisor module imports no torch.
"""

import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from dalle_pytorch_tpu.serving.migrate import CheckpointSpool as JSpool
from dalle_pytorch_tpu.serving.migrate import RequestCheckpoint as JRequestCheckpoint
from dalle_pytorch_tpu.serving.migrate import RowCheckpoint as JRowCheckpoint
from dalle_pytorch_tpu.serving.migrate import encode_checkpoint as jencode
from dalle_pytorch_tpu.serving.supervisor import ReplicaSupervisor as JSupervisor
from dalle_pytorch_tpu.training.metrics import MetricsRegistry as JRegistry
from dalle_pytorch_tpu_torch.serve import parse_args
from dalle_pytorch_tpu_torch.serving import supervisor as psup
from dalle_pytorch_tpu_torch.serving.migrate import CheckpointSpool, RequestCheckpoint, RowCheckpoint, encode_checkpoint
from dalle_pytorch_tpu_torch.training.metrics import MetricsRegistry

SIDES = {"jax": (JSupervisor, JRegistry), "port": (psup.ReplicaSupervisor, MetricsRegistry)}


class Log:
    def __init__(self):
        self.events = []

    def event(self, name, **fields):
        self.events.append({"event": name, **fields})

    def of(self, name):
        return [e for e in self.events if e["event"] == name]


def make(side, **kw):
    cls, registry = SIDES[side]
    kw.setdefault("argv", ["true"])
    kw.setdefault("backoff_base_s", 0.5)
    kw.setdefault("backoff_max_s", 8.0)
    kw.setdefault("crash_loop_exits", 3)
    kw.setdefault("crash_loop_window_s", 60.0)
    kw.setdefault("hold_down_s", 300.0)
    return cls(registry=registry(), log=Log(), **kw)


# (exit code, now, uptime, was ready) sequences
SEQUENCES = {
    "doubling": [(1, 0.0, 1.0, False), (1, 100.0, 1.0, False), (1, 200.0, 1.0, False), (1, 300.0, 1.0, False)],
    "stable_run_resets": [(1, 0.0, 1.0, True), (1, 70.0, 1.0, True), (1, 200.0, 120.0, True)],
    "crash_loop": [(70, 0.0, 1.0, False), (70, 5.0, 1.0, False), (70, 9.0, 1.0, False), (70, 400.0, 1.0, False)],
    "outside_window": [(-9, 0.0, 1.0, True), (-9, 61.0, 1.0, True), (-9, 122.0, 1.0, True), (-9, 183.0, 1.0, True)],
    "clean_exit": [(3, 0.0, 1.0, True), (0, 10.0, 5.0, True)],
    "signals_and_codes": [(-9, 0.0, 0.5, False), (-15, 1.0, 0.5, False), (137, 100.0, 0.5, False)],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_on_exit_policy_matches_the_reference(name):
    seen = {}
    for side in SIDES:
        sup = make(side)
        steps = []
        for code, now, uptime, ready in SEQUENCES[name]:
            delay = sup._on_exit(code, now, uptime, ready)
            steps.append((delay, sup.state, sup.last_exit_code, sup.last_exit_reason, sup._consec_failures,
                          sup.crash_loops, sup.last_backoff_s))
        counters = {n: sup._m_crash_loops.value for n in ("crash_loops",)}
        seen[side] = (steps, sup.log.events, counters, sup.detail())
    assert seen["port"] == seen["jax"]


@pytest.mark.parametrize("base, cap", [(0.5, 8.0), (0.25, 30.0), (1.0, 1.0)])
def test_backoff_schedule_matches(base, cap):
    port, jax_ = make("port", backoff_base_s=base, backoff_max_s=cap), make("jax", backoff_base_s=base, backoff_max_s=cap)
    assert [port.backoff_schedule(n) for n in range(1, 12)] == [jax_.backoff_schedule(n) for n in range(1, 12)]


class FakeProc:
    """A scripted child: alive until `die(code)`."""

    def __init__(self, pid):
        self.pid = pid
        self._code = None
        self._died = threading.Event()
        self.terminated = False

    def die(self, code):
        self._code = code
        self._died.set()

    def poll(self):
        return self._code

    def wait(self, timeout=None):
        if not self._died.wait(timeout):
            raise subprocess.TimeoutExpired("fake", timeout)
        return self._code

    def terminate(self):
        self.terminated = True
        self.die(0)

    def kill(self):
        self.die(-9)


def _until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_restart_after_abnormal_exit_then_stop(side):
    procs = []

    def spawn():
        procs.append(FakeProc(100 + len(procs)))
        return procs[-1]

    sup = make(side, spawn_fn=spawn, probe_fn=lambda: True, backoff_base_s=0.01, probe_interval_s=0.01)
    t = threading.Thread(target=sup.run, daemon=True)
    t.start()
    assert _until(lambda: procs)
    procs[0].die(70)
    assert _until(lambda: len(procs) == 2 and sup.state == "serving")
    sup.stop()
    t.join(10)
    assert not t.is_alive() and procs[1].terminated and sup.restarts == 1
    events = [e["event"] for e in sup.log.events]
    assert events[:5] == ["replica_start", "replica_ready", "replica_exit", "replica_start", "replica_ready"]
    assert sup.log.of("replica_exit")[0]["code"] == 70 and sup._m_restarts.value == 1


@pytest.mark.parametrize("side", sorted(SIDES))
def test_hung_boot_is_recycled_and_readiness_waits_for_the_probe(side):
    procs = []

    def spawn():
        procs.append(FakeProc(300 + len(procs)))
        return procs[-1]

    sup = make(side, spawn_fn=spawn, probe_fn=lambda: False, ready_timeout_s=0.2, probe_interval_s=0.02,
               backoff_base_s=0.01)
    t = threading.Thread(target=sup.run, daemon=True)
    t.start()
    assert _until(lambda: len(procs) >= 2)
    assert procs[0].terminated and sup.restarts >= 1 and sup.log.of("replica_ready_timeout")
    sup.stop()
    t.join(10)
    ok = threading.Event()
    sup = make(side, spawn_fn=lambda: FakeProc(1), probe_fn=ok.is_set, probe_interval_s=0.01)
    t = threading.Thread(target=sup.run, daemon=True)
    t.start()
    time.sleep(0.1)
    assert sup.state == "starting" and sup.last_ready_s is None
    ok.set()
    assert _until(lambda: sup.state == "serving") and sup.last_ready_s >= 0.0
    sup.stop()
    t.join(10)


def _checkpoint(side):
    rows_cls, req_cls, enc = (
        (RowCheckpoint, RequestCheckpoint, encode_checkpoint) if side == "port"
        else (JRowCheckpoint, JRequestCheckpoint, jencode)
    )
    row = rows_cls(row_index=0, prompt_ids=np.arange(8, dtype=np.int32), tokens=np.asarray([3, 1, 4], np.int32),
                   done=False, seed=7, temperature=0.9, top_k=0.8)
    return enc(req_cls(rows=[row], chunk_index=5, priority="normal", site="replica-a", request_key="key1"), "fp")


@pytest.mark.parametrize("side", sorted(SIDES))
def test_first_boot_clears_a_stale_spool(side, tmp_path):
    spool = (CheckpointSpool if side == "port" else JSpool)(tmp_path)
    spool.write({"stale": _checkpoint(side)})
    posted = []
    sup = make(side, spawn_fn=lambda: FakeProc(1), probe_fn=lambda: True, spool_dir=tmp_path,
               spool_notify_url="http://router:1")
    sup._post_spool = posted.append
    t = threading.Thread(target=sup.run, daemon=True)
    t.start()
    assert _until(lambda: not spool.read())
    sup.stop()
    t.join(10)
    assert not posted


def test_spool_handoff_payload_matches_the_reference(tmp_path):
    """Each supervisor's child journals a checkpoint (after the first-boot
    clear) and dies; after the restart each POSTs its hand-off, once."""
    posted = {}
    for side in SIDES:
        d = tmp_path / side
        spool = (CheckpointSpool if side == "port" else JSpool)(d)
        procs, got = [], []

        def spawn(spool=spool, procs=procs):
            procs.append(FakeProc(len(procs)))
            if len(procs) == 1:
                def crash(p=procs[0]):
                    time.sleep(0.2)
                    spool.write({"key1": _checkpoint("port")})
                    p.die(70)

                threading.Thread(target=crash, daemon=True).start()
            return procs[-1]

        sup = make(side, spawn_fn=spawn, probe_fn=lambda: True, backoff_base_s=0.05, backoff_max_s=0.1,
                   spool_dir=d, spool_notify_url="http://127.0.0.1:8100/", max_restarts=1,
                   health_url="http://127.0.0.1:8001/healthz")
        sup._post_spool = got.append
        t = threading.Thread(target=sup.run, daemon=True)
        t.start()
        assert _until(lambda: got, 15)
        sup.stop()
        t.join(10)
        assert sup.spool_handoffs == 1 and spool.read() == {}
        posted[side] = (got, sup.log.of("spool_handoff"), sup.spool_notify_url)
    assert posted["port"] == posted["jax"]
    assert posted["port"][0][0]["replica"] == "127.0.0.1-8001"


def test_handoff_failure_keeps_the_capture(tmp_path):
    seen = {}
    for side in SIDES:
        sup = make(side, spool_dir=tmp_path / side, spool_notify_url="http://r:1")
        sup._pending_spool = {"k": "w"}

        def refuse(payload):
            raise ConnectionRefusedError("router down")

        sup._post_spool = refuse
        sup._handoff_spool()
        seen[side] = (sup.spool_handoff_errors, dict(sup._pending_spool), [e["event"] for e in sup.log.events])
    assert seen["port"] == seen["jax"] == (1, {"k": "w"}, ["spool_handoff_failed"])


@pytest.mark.parametrize("argv, child", [
    (["--dalle_path", "d.npz", "--supervise", "--port", "8001"], ["--dalle_path", "d.npz", "--port", "8001"]),
    (["--supervise", "--spool_notify", "http://r:1", "--checkpoint_spool", "s", "--port", "9"],
     ["--checkpoint_spool", "s", "--port", "9"]),
    (["--spool_notify=http://r:1", "--supervise", "--engine", "continuous"], ["--engine", "continuous"]),
])
def test_child_command_runs_the_serve_module(argv, child):
    assert psup.child_command(argv) == [sys.executable, "-m", "dalle_pytorch_tpu_torch.serve", *child]


def test_supervise_serve_spawns_the_module_and_no_torch(monkeypatch):
    made = {}

    class Recorder(psup.ReplicaSupervisor):
        def __init__(self, argv, **kw):
            made.update(argv=argv, **kw)
            super().__init__(argv, **kw)

        def run(self):
            return 0

    monkeypatch.setattr(psup, "ReplicaSupervisor", Recorder)
    monkeypatch.setattr(psup, "_run_with_signals", lambda sup, tag: sup.run())
    argv = ["--dalle_path", "d.npz", "--engine", "continuous", "--port", "8123", "--supervise",
            "--checkpoint_spool", "sp", "--spool_notify", "http://127.0.0.1:8100"]
    assert psup.supervise_serve(parse_args(argv), argv) == 0
    assert made["argv"][1:3] == ["-m", "dalle_pytorch_tpu_torch.serve"] and "--supervise" not in made["argv"]
    assert made["health_url"] == "http://127.0.0.1:8123/healthz" and made["spool_dir"] == "sp"
    code = ("import sys; import dalle_pytorch_tpu_torch.serving.supervisor, dalle_pytorch_tpu_torch.serve; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60)
    assert out.stdout.strip() == "False", out.stderr


def test_supervisor_cli_restarts_a_real_child(tmp_path):
    """`python -m dalle_pytorch_tpu_torch.serving.supervisor -- cmd`: a
    child that fails once restarts, then its clean exit ends supervision."""
    marker = tmp_path / "ran"
    child = (f"import pathlib, sys; p = pathlib.Path({str(marker)!r}); n = int(p.read_text()) if p.exists() else 0; "
             "p.write_text(str(n + 1)); sys.exit(3 if n == 0 else 0)")
    out = subprocess.run(
        [sys.executable, "-m", "dalle_pytorch_tpu_torch.serving.supervisor", "--backoff_base_s", "0.05", "--",
         sys.executable, "-c", child], capture_output=True, text=True, timeout=60,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert marker.read_text() == "2"
    assert '"event": "replica_exit"' in out.stdout and '"restarts": 1' in out.stdout
