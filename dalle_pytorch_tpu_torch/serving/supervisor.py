"""Replica supervisor: crash-fast restart with backoff and crash-loop
hold-down.

Counterpart of the JAX package's `serving/supervisor.py` (host code,
copied so the port imports nothing of that package). The router makes a
replica's death invisible to clients; the supervisor makes it short. It
owns one replica subprocess end to end:

  * spawn it, then gate "serving" on a real `/healthz` probe: a replica
    still loading its checkpoint or building its kernels holds a closed
    port, so the router keeps it ejected until it can serve, and the
    probe's flip is the edge that walks the router's half-open trial.
  * on an abnormal exit, restart with capped exponential backoff
    (`backoff_base_s * 2^(n-1)`, capped at `backoff_max_s`; the streak
    resets once a child served healthily for `stable_reset_s`). The child
    keeps every serve flag but the supervisor's own, `--compile_cache`
    among them, so a restarted replica loads its kernel libraries from
    the cache and builds nothing.
  * detect crash loops: `crash_loop_exits` abnormal exits inside
    `crash_loop_window_s` hold the replica down for `hold_down_s` with a
    structured `crash_loop` event instead of a restart storm.
  * hand the crash beacon over: between the dead child's exit and the
    respawn (the one window where nobody writes it) the replica's
    `--checkpoint_spool` journal is read and cleared; once the restarted
    child is ready, the bundle is POSTed to the router's `/admin/spool`,
    and the requests the crash interrupted resume at their journaled
    chunk instead of from position 0.

The supervisor itself imports no torch and never initializes CUDA: the
child pays for the runtime (and pays it again after each restart). The
child runs in the supervisor's own process group (a plain `Popen`), so a
signal to the group reaches both.

Deterministic under test: the clock (`time_fn`), the child factory
(`spawn_fn`) and the health probe (`probe_fn`) are injectable, and
`_on_exit`, the whole restart policy, is a function of (exit code, now,
uptime) that tests drive directly.

Run it: `python -m dalle_pytorch_tpu_torch.serve --supervise --port 8000
...` (the supervisor runs `python -m dalle_pytorch_tpu_torch.serve` with
the same flags minus its own as the child) or `python -m
dalle_pytorch_tpu_torch.serving.supervisor --health_url URL -- cmd
args...` for any replica command.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
import urllib.request
from collections import deque
from typing import Callable, List, Optional


class ReplicaSupervisor:
    """Supervise one replica subprocess; see the module docstring for
    the policy. `run()` blocks until the child exits cleanly, `stop()`
    is requested, or a crash-loop hold-down is interrupted."""

    def __init__(
        self,
        argv: List[str],
        health_url: Optional[str] = None,
        registry=None,
        log=None,
        backoff_base_s: float = 0.5,
        backoff_max_s: float = 30.0,
        crash_loop_exits: int = 3,
        crash_loop_window_s: float = 60.0,
        hold_down_s: float = 300.0,
        stable_reset_s: Optional[float] = None,
        ready_timeout_s: float = 900.0,
        probe_interval_s: float = 0.25,
        probe_timeout_s: float = 2.0,
        time_fn: Callable[[], float] = time.monotonic,
        spawn_fn: Optional[Callable] = None,
        probe_fn: Optional[Callable[[], bool]] = None,
        max_restarts: Optional[int] = None,
        spool_dir=None,
        spool_notify_url: Optional[str] = None,
    ):
        assert argv, "supervisor needs a child command"
        assert backoff_base_s > 0 and backoff_max_s >= backoff_base_s
        assert crash_loop_exits >= 2, (
            "crash_loop_exits < 2 would hold down on the FIRST crash — "
            "use a plain non-restarting runner for that"
        )
        self.argv = list(argv)
        self.health_url = health_url
        self.log = log
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.crash_loop_exits = int(crash_loop_exits)
        self.crash_loop_window_s = float(crash_loop_window_s)
        self.hold_down_s = float(hold_down_s)
        # a child that served healthily this long has broken the streak:
        # the next failure backs off from the base again
        self.stable_reset_s = (
            float(crash_loop_window_s) if stable_reset_s is None
            else float(stable_reset_s)
        )
        self.ready_timeout_s = float(ready_timeout_s)
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self._now = time_fn
        self._spawn_fn = spawn_fn
        self._probe_fn = probe_fn
        self.max_restarts = max_restarts
        # decode-state migration (serving/migrate.py): the replica's
        # crash-beacon spool directory and the router URL it is handed
        # to once the restarted child is READY — a SIGKILLed replica's
        # in-flight progress then resumes fleet-side instead of being
        # re-decoded from scratch
        self.spool_dir = spool_dir
        self.spool_notify_url = (
            spool_notify_url.rstrip("/") if spool_notify_url else None
        )
        self.spool_handoffs = 0
        self.spool_handoff_errors = 0
        #: the DEAD child's journal, captured between its exit and the
        #: respawn (the only window where nobody writes the file): the
        #: restarted child's own first beacon wholesale-replaces the
        #: journal, so reading after it serves would lose the crash
        #: checkpoints — and clearing after it serves would delete the
        #: NEW child's live progress
        self._pending_spool: dict = {}

        self._stop = threading.Event()
        self.child = None
        self.state = "idle"  # starting|serving|backoff|held_down|stopped
        #: respawns after an abnormal exit (restart #N is the Nth respawn)
        self.restarts = 0
        self.crash_loops = 0
        self.last_exit_code: Optional[int] = None
        self.last_exit_reason: Optional[str] = None
        #: spawn-to-/healthz-200 of the most recent (re)start — the
        #: time-to-rejoin number the restart bench reports
        self.last_ready_s: Optional[float] = None
        self.last_backoff_s: Optional[float] = None
        self._consec_failures = 0
        self._exit_times: deque = deque()

        self._m_restarts = self._m_crash_loops = self._m_ready = None
        if registry is not None:
            self._m_restarts = registry.counter(
                "dalle_supervisor_restarts_total",
                "replica subprocess respawns after an abnormal exit",
            )
            self._m_crash_loops = registry.counter(
                "dalle_supervisor_crash_loops_total",
                "crash-loop hold-downs (N abnormal exits inside the "
                "window; the replica is held out of rotation)",
            )
            self._m_ready = registry.gauge(
                "dalle_supervisor_time_to_ready_seconds",
                "spawn-to-healthy of the most recent replica (re)start",
            )

    # ------------------------------------------------------------- seams

    def _spawn(self):
        if self._spawn_fn is not None:
            return self._spawn_fn()
        return subprocess.Popen(self.argv)

    def _probe(self) -> bool:
        """One readiness probe: /healthz 200. A missing health_url
        degrades to process-aliveness gating (readiness = spawned)."""
        if self._probe_fn is not None:
            return bool(self._probe_fn())
        if self.health_url is None:
            return True
        try:
            with urllib.request.urlopen(
                self.health_url, timeout=self.probe_timeout_s
            ) as resp:
                return resp.status == 200
        except Exception:
            return False

    def _event(self, event: str, **fields) -> None:
        if self.log is not None:
            self.log.event(event, **fields)

    # ------------------------------------------------------------ policy

    def backoff_schedule(self, n: int) -> float:
        """Delay before the nth consecutive restart (1-based): capped
        exponential."""
        assert n >= 1
        return min(
            self.backoff_base_s * (2 ** (n - 1)), self.backoff_max_s
        )

    def _on_exit(self, code: int, now: float, uptime_s: float,
                 was_ready: bool) -> Optional[float]:
        """The whole restart policy, clock-driven and directly testable:
        record one child exit, return the restart delay in seconds — or
        None for a clean exit (the supervisor is done)."""
        self.last_exit_code = code
        self.last_exit_reason = (
            "clean" if code == 0
            else f"signal {-code}" if code < 0
            else f"exit {code}"
        )
        if code == 0:
            return None
        if was_ready and uptime_s >= self.stable_reset_s:
            # a long-healthy child failing is a fresh incident, not the
            # continuation of a boot-failure streak
            self._consec_failures = 0
        self._consec_failures += 1
        self._exit_times.append(now)
        while (
            self._exit_times
            and now - self._exit_times[0] > self.crash_loop_window_s
        ):
            self._exit_times.popleft()
        if len(self._exit_times) >= self.crash_loop_exits:
            self.crash_loops += 1
            if self._m_crash_loops is not None:
                self._m_crash_loops.inc()
            self._event(
                "crash_loop",
                exits=len(self._exit_times),
                window_s=self.crash_loop_window_s,
                hold_down_s=self.hold_down_s,
                last_exit=self.last_exit_reason,
            )
            self._exit_times.clear()
            self.state = "held_down"
            self.last_backoff_s = self.hold_down_s
            return self.hold_down_s
        self.state = "backoff"
        self.last_backoff_s = self.backoff_schedule(self._consec_failures)
        return self.last_backoff_s

    # -------------------------------------------------------------- loop

    def _wait_ready(self, spawned_at: float) -> bool:
        """Poll /healthz until the child answers 200, dies, or the ready
        timeout passes. Returns readiness; sets `last_ready_s`."""
        deadline = spawned_at + self.ready_timeout_s
        while not self._stop.is_set():
            if self.child is not None and self.child.poll() is not None:
                return False  # died while booting
            if self._probe():
                self.last_ready_s = self._now() - spawned_at
                if self._m_ready is not None:
                    self._m_ready.set(self.last_ready_s)
                return True
            if self._now() >= deadline:
                return False
            self._stop.wait(self.probe_interval_s)
        return False

    def run(self) -> int:
        """Supervise until the child exits cleanly or `stop()` — returns
        the child's final exit code (or 0 when stopped)."""
        while not self._stop.is_set():
            self.state = "starting"
            if self.restarts == 0 and self.spool_dir is not None:
                # first boot: a leftover journal is a PREVIOUS process
                # lifetime's state whose clients are long gone — clear
                # it BEFORE the child can serve (not at the ready probe,
                # which may lag the child's first own beacon)
                self._clear_spool()
            spawned_at = self._now()
            self.child = self._spawn()
            self._event(
                "replica_start",
                pid=getattr(self.child, "pid", None),
                restarts=self.restarts,
            )
            was_ready = self._wait_ready(spawned_at)
            if was_ready:
                self.state = "serving"
                self._event(
                    "replica_ready",
                    pid=getattr(self.child, "pid", None),
                    time_to_ready_s=round(self.last_ready_s or 0.0, 3),
                    restarts=self.restarts,
                )
                if self.restarts > 0:
                    # hand the crash-captured journal (read between the
                    # dead child's exit and this respawn — see
                    # _pending_spool) to the fleet router the moment the
                    # RESTARTED child serves again: in-flight requests
                    # the crash interrupted resume from the journaled
                    # checkpoints instead of from scratch
                    self._handoff_spool()
            hung_boot = False
            if not was_ready and not self._stop.is_set() \
                    and self.child.poll() is None:
                # HUNG boot: the child is alive but never answered
                # /healthz inside ready_timeout_s (wedged checkpoint
                # load, dead NFS). Recycle it through the normal
                # abnormal-exit path — without this kill, _wait_exit
                # would block forever and the crash-fast machinery
                # (backoff, crash-loop hold-down) never engages for
                # hung (vs crashed) children.
                hung_boot = True
                self._event(
                    "replica_ready_timeout",
                    pid=getattr(self.child, "pid", None),
                    ready_timeout_s=self.ready_timeout_s,
                )
                self._kill_child()
            code = self._wait_exit()
            now = self._now()
            uptime = now - spawned_at
            if self._stop.is_set():
                break
            if hung_boot and code == 0:
                # a recycled hung boot must count as a FAILURE even when
                # the child honored SIGTERM — exit 0 here would end
                # supervision with the replica never having served
                code = 1
            delay = self._on_exit(code, now, uptime, was_ready)
            self._event(
                "replica_exit",
                code=code, reason=self.last_exit_reason,
                uptime_s=round(uptime, 3), was_ready=was_ready,
                restart_in_s=delay,
                crash_loop=self.state == "held_down",
            )
            if delay is None:
                self.state = "stopped"
                return code
            if self.spool_dir is not None:
                # capture the dead child's journal NOW — the only window
                # where nobody writes the file — and clear it so the
                # restarted child's beacons start fresh; the captured
                # bundle is handed to the router once the restart is
                # ready (new entries merge over older pending ones)
                self._pending_spool.update(self._read_spool())
                self._clear_spool()
            if (
                self.max_restarts is not None
                and self.restarts >= self.max_restarts
            ):
                self.state = "stopped"
                return code
            self._stop.wait(delay)
            if self._stop.is_set():
                break
            self.restarts += 1
            if self._m_restarts is not None:
                self._m_restarts.inc()
        self.state = "stopped"
        return 0

    def _wait_exit(self) -> int:
        """Block until the child exits; interruptible by stop() (which
        terminates the child)."""
        child = self.child
        while not self._stop.is_set():
            code = child.poll()
            if code is not None:
                return code
            # short poll keeps stop() responsive without a second thread
            try:
                return child.wait(timeout=0.2)
            except subprocess.TimeoutExpired:
                continue
            except Exception:
                time.sleep(0.05)
        return child.poll() if child.poll() is not None else 0

    def _kill_child(self, term_timeout_s: float = 15.0) -> None:
        """SIGTERM the child (the serve twin drains on it), escalate to
        SIGKILL past the timeout. Best-effort, never raises."""
        child = self.child
        if child is None or child.poll() is not None:
            return
        try:
            child.terminate()
            try:
                child.wait(timeout=term_timeout_s)
            except Exception:
                child.kill()
                child.wait(timeout=5.0)
        except Exception:
            pass

    def stop(self, term_timeout_s: float = 15.0) -> None:
        """Graceful stop: end supervision and take the child down."""
        self._stop.set()
        if self.child is None or self.child.poll() is not None:
            return
        self._kill_child(term_timeout_s)
        self._event("supervisor_stop", exit_code=self.child.poll())

    # ----------------------------------------------------- spool hand-off

    def _read_spool(self):
        """{key: wire} from the replica's crash-beacon journal; {} when
        unarmed/empty. Never raises (a sick spool volume must not stop
        supervision)."""
        if self.spool_dir is None:
            return {}
        try:
            from dalle_pytorch_tpu_torch.serving.migrate import (
                CheckpointSpool,
                to_wire,
            )

            spool = CheckpointSpool(self.spool_dir)
            return {k: to_wire(b) for k, b in spool.read().items()}
        except Exception as exc:
            self._event("spool_read_failed", error=repr(exc))
            return {}

    def _clear_spool(self) -> None:
        if self.spool_dir is None:
            return
        try:
            from dalle_pytorch_tpu_torch.serving.migrate import CheckpointSpool

            CheckpointSpool(self.spool_dir).clear()
        except Exception:
            pass

    def _replica_identity(self) -> Optional[str]:
        """The supervised replica's fleet identity for spool attribution:
        `host-port` derived from the health URL — the same name the
        router derives for a bare replica URL, so `migrated_from` on
        crash-path resumes joins /debug/replicas instead of carrying a
        /healthz URL."""
        if not self.health_url:
            return None
        try:
            from urllib.parse import urlsplit

            parts = urlsplit(self.health_url)
            return f"{parts.hostname}-{parts.port or 80}"
        except Exception:
            return None

    def _post_spool(self, payload: dict) -> None:
        """The one hand-off socket touch (stubbed in tests): POST the
        spool bundle to the router's /admin/spool."""
        req = urllib.request.Request(
            self.spool_notify_url + "/admin/spool",
            data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.probe_timeout_s):
            pass

    def _handoff_spool(self) -> None:
        """Hand the crash-captured journal (`_pending_spool`, read
        between the dead child's exit and the respawn) to the fleet
        router. The capture survives an unreachable router — the next
        ready cycle tries again; it is dropped only after a successful
        POST (each entry resumes at most once)."""
        bundle = dict(self._pending_spool)
        if not bundle or self.spool_notify_url is None:
            if bundle:
                self._event(
                    "spool_handoff_skipped", checkpoints=len(bundle),
                    reason="no --spool_notify router URL",
                )
            return
        try:
            self._post_spool({
                "replica": self._replica_identity(),
                "checkpoints": bundle,
            })
        except Exception as exc:
            self.spool_handoff_errors += 1
            self._event(
                "spool_handoff_failed", checkpoints=len(bundle),
                error=repr(exc),
            )
            return
        self.spool_handoffs += 1
        self._event("spool_handoff", checkpoints=len(bundle))
        self._pending_spool.clear()

    # ------------------------------------------------------------- views

    def detail(self) -> dict:
        return {
            "state": self.state,
            "pid": getattr(self.child, "pid", None),
            "restarts": self.restarts,
            "crash_loops": self.crash_loops,
            "consecutive_failures": self._consec_failures,
            "last_exit_code": self.last_exit_code,
            "last_exit_reason": self.last_exit_reason,
            "last_ready_s": self.last_ready_s,
            "last_backoff_s": self.last_backoff_s,
            "spool_handoffs": self.spool_handoffs,
            "spool_handoff_errors": self.spool_handoff_errors,
        }


#: the replica module the supervised child runs
SERVE_MODULE = "dalle_pytorch_tpu_torch.serve"


def child_command(argv: List[str]) -> List[str]:
    """The supervised child's command: the serve twin as a module
    (`python -m`; its file does not import as a script) with `argv` minus
    the supervisor-only flags. The child keeps `--checkpoint_spool`: the
    journal is its job, the hand-off the supervisor's."""
    child: List[str] = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "--supervise" or a.startswith("--spool_notify="):
            continue
        if a == "--spool_notify":
            skip = True
            continue
        child.append(a)
    return [sys.executable, "-m", SERVE_MODULE] + child


def supervise_serve(args, argv: Optional[List[str]]) -> int:
    """`serve --supervise`: run the serve twin minus the supervisor's
    flags as the supervised child, health-gated on the replica's own
    /healthz. Needs an explicit --port (the supervisor must know where to
    probe)."""
    from dalle_pytorch_tpu_torch.obs.logging import StructuredLog

    raw = list(sys.argv[1:] if argv is None else argv)
    child_argv = child_command(raw)
    log = StructuredLog(
        component="dalle.supervisor",
        site=getattr(args, "trace_site", None),
    )
    sup = ReplicaSupervisor(
        child_argv,
        health_url=f"http://{args.host}:{args.port}/healthz",
        log=log,
        spool_dir=getattr(args, "checkpoint_spool", None),
        spool_notify_url=getattr(args, "spool_notify", None),
    )
    return _run_with_signals(sup, "supervisor")


def _run_with_signals(sup: ReplicaSupervisor, tag: str) -> int:
    import signal

    def _stop(signum, frame):
        print(f"[{tag}] signal {signum}: stopping replica", flush=True)
        threading.Thread(target=sup.stop, daemon=True).start()

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    code = sup.run()
    print(f"[{tag}] done: {json.dumps(sup.detail())}", flush=True)
    return code


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Supervise a replica command: restart on abnormal "
        "exit with capped exponential backoff, crash-loop hold-down, "
        "readiness gated on /healthz."
    )
    p.add_argument("--health_url", type=str, default=None,
                   help="replica /healthz URL; readiness (and "
                   "time-to-rejoin accounting) gates on it answering 200")
    p.add_argument("--backoff_base_s", type=float, default=0.5)
    p.add_argument("--backoff_max_s", type=float, default=30.0)
    p.add_argument("--crash_loop_exits", type=int, default=3,
                   help="abnormal exits inside the window that trigger "
                   "a hold-down instead of another fast restart")
    p.add_argument("--crash_loop_window_s", type=float, default=60.0)
    p.add_argument("--hold_down_s", type=float, default=300.0)
    p.add_argument("--ready_timeout_s", type=float, default=900.0)
    p.add_argument("--spool_dir", type=str, default=None,
                   help="the replica's --checkpoint_spool directory; "
                   "after a restart reaches ready, its journaled "
                   "decode-state checkpoints are handed to the router")
    p.add_argument("--spool_notify", type=str, default=None, metavar="URL",
                   help="fleet router base URL to POST the spool to "
                   "(/admin/spool) after a restart")
    p.add_argument("--site", type=str, default=None,
                   help="structured-log site identity")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="replica command after `--`, e.g. "
                   "-- python -m dalle_pytorch_tpu_torch.serve --dalle_path ... "
                   "--port 8000")
    args = p.parse_args(argv)
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        p.error("need a replica command after --")

    from dalle_pytorch_tpu_torch.obs.logging import StructuredLog

    sup = ReplicaSupervisor(
        cmd,
        health_url=args.health_url,
        log=StructuredLog(component="dalle.supervisor", site=args.site),
        backoff_base_s=args.backoff_base_s,
        backoff_max_s=args.backoff_max_s,
        crash_loop_exits=args.crash_loop_exits,
        crash_loop_window_s=args.crash_loop_window_s,
        hold_down_s=args.hold_down_s,
        ready_timeout_s=args.ready_timeout_s,
        spool_dir=args.spool_dir,
        spool_notify_url=args.spool_notify,
    )
    return _run_with_signals(sup, "supervisor")


if __name__ == "__main__":
    sys.exit(main())
