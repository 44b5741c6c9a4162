"""On-demand `torch.profiler` capture for a live server.

Counterpart of the JAX package's `obs/profiler.py`, which holds a
`jax.profiler` trace open; this one holds a `torch.profiler` trace. A
serving hotspot shows on a process that has been up for days and must not
be restarted to attach a profiler: `POST /debug/profile?seconds=N`
(`serving/server.py`) starts a trace, holds it open for N seconds of live
traffic, stops it and writes it as Chrome trace JSON (`trace.json`, which
chrome://tracing and ui.perfetto.dev load) into a directory
`profile_<ts>_<n>/` under `out_dir`. On the card it records CPU and CUDA
activities: every kernel launched in the window, from any thread, is an
event with its name and device time, beside its launch call. The CPU ops
of threads other than the capturing one (the engine's worker) are
recorded for an engine on the CPU only, where they are all there is to
see: turning a busy worker's ops into a trace holds the interpreter for
seconds at the capture's end. The card's kernels alone take seconds too
(`chip_smoke.py` phase 16 (h): 5.0-6.3 s after 2 s of a depth-2
flagship-width replica decoding on an H100, 49k-67k kernels), which the
replica's stall watchdog reports as a stuck dispatch.

Guard rails, because the profiler is process-wide state:

  * single flight: one capture at a time; a second request while one is
    in flight raises `ProfilerBusy` (HTTP 409);
  * root-gated: only rank 0 of an initialized `torch.distributed` group
    captures (a process outside any group is rank 0); another rank raises
    `PermissionError` (HTTP 403);
  * bounded: `seconds` is clamped to `max_seconds`.

`_process_index`, `_start` and `_stop` are the seams the HTTP tests stub.
Importing this module imports no torch.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Optional

#: the Chrome trace file inside each capture's directory
TRACE_FILE = "trace.json"


def _all_threads():
    """A profiler config that records the ops of every thread (the engine's
    worker, not only the capturing HTTP handler), None on a torch without
    the option."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


class ProfilerBusy(RuntimeError):
    """A capture is already in flight (single-flight contract)."""


class ProfilerCapture:
    """Blocking captures of `torch.profiler` traces, one at a time.
    `device` names the device the served engine runs on: a CUDA device
    adds the CUDA activities, another the CPU ops of every thread (None:
    CUDA when a card is available)."""

    def __init__(self, out_dir: str = "profiles", max_seconds: float = 60.0, device=None):
        self.out_dir = Path(out_dir)
        self.max_seconds = float(max_seconds)
        self.device = device
        self._lock = threading.Lock()  # held for the whole capture
        self._prof = None
        self._trace_dir: Optional[Path] = None
        self.last_dir: Optional[Path] = None
        self.captures = 0
        #: True between the profiler's start and its stop
        self.capturing = False
        #: seconds the last capture's stop and export took (the trace's
        #: events turned into its file, the interpreter held meanwhile)
        self.last_stop_s: Optional[float] = None

    @property
    def busy(self) -> bool:
        return self._lock.locked()

    def _on_card(self) -> bool:
        import torch

        if self.device is None:
            return torch.cuda.is_available()
        return torch.device(self.device).type == "cuda"

    # torch touchpoints behind override seams: the HTTP tests drive the
    # guard rails with these stubbed

    def _process_index(self) -> int:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
        return 0

    def _start(self, trace_dir: Path) -> None:
        from torch.profiler import ProfilerActivity, profile

        if self._on_card():
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        else:
            prof = profile(activities=[ProfilerActivity.CPU], experimental_config=_all_threads())
        prof.start()
        self._prof = prof

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        if prof is None:
            return
        if self._on_card():
            import torch

            # kernels still queued when the window closes land in the trace
            torch.cuda.synchronize(self.device)
        prof.stop()
        prof.export_chrome_trace(str(self._trace_dir / TRACE_FILE))

    def capture(self, seconds: float) -> Path:
        """Start the trace, sleep `seconds` of live traffic, stop, return
        the trace directory. Raises `ProfilerBusy` / `PermissionError` /
        `ValueError` per the guard rails above."""
        seconds = float(seconds)
        if not seconds > 0:
            raise ValueError(f"seconds must be > 0, got {seconds}")
        seconds = min(seconds, self.max_seconds)
        index = self._process_index()
        if index != 0:
            raise PermissionError(f"profiler capture is root-gated; this is process {index}")
        if not self._lock.acquire(blocking=False):
            raise ProfilerBusy("a profiler capture is already in flight; retry when it completes")
        try:
            trace_dir = self.out_dir / f"profile_{time.strftime('%Y%m%d_%H%M%S')}_{self.captures}"
            # counted per attempt, not per success: a failed capture's
            # same-second retry gets a directory of its own
            self.captures += 1
            trace_dir.mkdir(parents=True, exist_ok=True)
            self._trace_dir = trace_dir
            self._start(trace_dir)
            self.capturing = True
            try:
                time.sleep(seconds)
            finally:
                self.capturing = False
                t_stop = time.perf_counter()
                self._stop()
                self.last_stop_s = round(time.perf_counter() - t_stop, 3)
            self.last_dir = trace_dir
            return trace_dir
        finally:
            self._lock.release()

    def detail(self) -> dict:
        return {
            "out_dir": str(self.out_dir),
            "busy": self.busy,
            "capturing": self.capturing,
            "captures": self.captures,
            "last_dir": None if self.last_dir is None else str(self.last_dir),
            "last_stop_s": self.last_stop_s,
        }
