"""Device telemetry and self-diagnosis for the serving engines.

Counterpart of the JAX package's `obs/vitals.py` (host code, copied so the
port imports nothing of that package; torch is imported only inside the
functions that read the card). The span pipeline says where one
request's time went; this module says whether the device is healthy and
well used, with four cooperating pieces:

  * `ProgramCostTable`: per-program cost accounting and live MFU. The
    reference reads XLA's `cost_analysis()` / `memory_analysis()` of each
    compiled program; PyTorch has no counterpart, and
    `torch.utils.flop_counter` does not see the ctypes-launched kernels.
    So each row's FLOPs and bytes are a count of the program's work at
    its warmup shape from the model's configuration
    (`utils/flops.forward_cost`: the matrix products, 4 * D flops a
    visible (query, key) pair a head, the logits head; weights and the
    K/V read once, K/V written once; the dVAE decode by
    `torch.utils.flop_counter`, which sees its convolutions), its memory
    fields are the torch.cuda allocator's readings around the warmup
    dispatch, and each row carries the launches of the hand-written
    kernels its dispatches made, read from the wrappers' counters
    (`kernel_launch_counts`). The peaks are the card's (`device_peaks`:
    `utils/flops.peak_flops` and the same part's memory rate), never a TPU
    figure; a device with no peak in the table (the CPU) has rows without
    MFU unless the caller passes one. Measured dispatch walls feed an EMA,
    and synced walls only export `dalle_serving_mfu{program=}` and
    `dalle_serving_hbm_gbps{program=}`.

  * `EngineVitals`: a background sampler thread snapshotting queue depth,
    slots / pages active, prefix-cache size, the age of the dispatch in
    flight and the device's allocator readings into a bounded ring
    (`GET /debug/vitals`, `/metrics` gauges). The device seam
    (`_device_memory_stats`) is overridable, so tests stub it. Off, it
    starts no thread and `samples_taken` stays 0; engines hold
    `NULL_VITALS` until a real instance binds itself.

  * `StallWatchdog`: on the sampler's tick, a dispatch older than an
    EMA-based multiple of its program's wall, a queue head older than its
    budget, or a frozen chunk index with slots active emits one `stall`
    event with the engine-state dump and the worker's stack, bumps
    `dalle_serving_stalls_total{reason=}` and marks /healthz degraded.

  * `SLOTracker`: latency targets (`--slo_ttft_ms`, `--slo_request_ms`)
    with a rolling-window burn rate from the existing histograms' bucket
    counts; a burn above 1 degrades /healthz (still 200) and tightens the
    batcher's deadline shed.

Everything here reads host state (allocator counts, page tables,
monotonic clocks) and the allocator's counters; nothing in the sampler
path launches device work.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from dalle_pytorch_tpu_torch.utils import compile_guard
from dalle_pytorch_tpu_torch.utils.flops import hbm_bytes_per_s, peak_flops


def thread_stacks(name_contains: str = "batcher") -> Dict[str, List[str]]:
    """Python stacks of the live threads whose name holds `name_contains`,
    from `sys._current_frames()` (host introspection, safe on any
    thread): the watchdog's answer to where the worker is stuck."""
    frames = sys._current_frames()
    out: Dict[str, List[str]] = {}
    for t in threading.enumerate():
        if name_contains not in t.name:
            continue
        frame = frames.get(t.ident)
        if frame is not None:
            out[t.name] = [line.rstrip("\n") for line in traceback.format_stack(frame)]
    return out


# ------------------------------------------------------- counted work


def device_peaks(device_name: Optional[str]) -> Tuple[Optional[float], Optional[float]]:
    """(dense bf16 peak FLOP/s, memory bytes/s) of the card named
    `device_name` (`torch.cuda.get_device_name`), each None for a device
    the tables do not hold."""
    if not device_name:
        return None, None
    return peak_flops(device_name), hbm_bytes_per_s(device_name)


#: the hand-written kernels' wrappers whose counters a cost row reads:
#: (module under `dalle_pytorch_tpu_torch.ops`, wrapper, counter attributes)
_KERNEL_COUNTERS = (
    ("flash_decode", "flash_decode_attention",
     ("launches", "int8_launches", "tile_launches", "tile_int8_launches", "tile_f32_launches",
      "tile_f32_int8_launches")),
    ("flash_decode", "block_sparse_flash_decode_attention",
     ("launches", "int8_launches", "tile_launches", "tile_int8_launches", "tile_f32_launches",
      "tile_f32_int8_launches")),
    ("flash_decode", "paged_flash_decode_attention",
     ("launches", "int8_launches", "tile_launches", "tile_int8_launches", "tile_f32_launches",
      "tile_f32_int8_launches")),
    ("flash_decode", "block_sparse_paged_flash_decode_attention",
     ("launches", "int8_launches", "tile_launches", "tile_int8_launches", "tile_f32_launches",
      "tile_f32_int8_launches")),
    ("wide_head", "wide_decode",
     ("launches", "split_launches", "tile_launches", "tile_f32_launches")),
)


def kernel_launch_counts() -> Dict[str, int]:
    """Every serving kernel wrapper's launch counters, keyed
    "wrapper.counter" (each counts launches on the card only: 0 on the
    CPU). Imports the wrappers, and with them torch."""
    from importlib import import_module

    out: Dict[str, int] = {}
    for module, name, attrs in _KERNEL_COUNTERS:
        fn = getattr(import_module(f"dalle_pytorch_tpu_torch.ops.{module}"), name)
        for attr in attrs:
            out[f"{name}.{attr}"] = int(getattr(fn, attr, 0))
    return out


def launch_delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    """The counters that moved between two `kernel_launch_counts` readings."""
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def device_identity(engine) -> Optional[Dict]:
    """{"type", "name"} of an engine's device: "cuda" and the card's name,
    or "cpu"; None without an engine."""
    device = getattr(engine, "device", None)
    if device is None:
        return None
    kind = getattr(device, "type", str(device))
    out = {"type": kind, "name": kind}
    if kind == "cuda":
        try:
            import torch

            out["name"] = torch.cuda.get_device_name(device)
        except Exception:
            pass
    return out


class _ProgramRow:
    """Counted cost of one warmed program plus its measured dispatch-wall
    EMA and kernel launches."""

    __slots__ = (
        "name", "flops", "bytes_accessed", "memory", "wall_ema_s", "last_wall_s",
        "dispatches", "synced", "launches", "launches_per_dispatch",
    )

    def __init__(self, name: str, flops: float, bytes_accessed: float, memory: Dict[str, int]):
        self.name = name
        self.flops = float(flops)
        self.bytes_accessed = float(bytes_accessed)
        self.memory = memory
        self.wall_ema_s: Optional[float] = None
        self.last_wall_s: Optional[float] = None
        self.dispatches = 0
        #: False until a wall that includes a device sync lands: MFU from
        #: an asynchronous launch's host wall would be fiction
        self.synced = False
        #: kernel counter -> launches summed over the recorded dispatches
        self.launches: Dict[str, int] = {}
        #: kernel counter -> launches of the most recent dispatch
        self.launches_per_dispatch: Dict[str, int] = {}


class ProgramCostTable:
    """Counted per-program cost plus live MFU and bandwidth.

    `add(name, flops, bytes_accessed, memory, launches)` records one
    program's counted work at its warmup shape (the engines do it during
    `warmup()` when a table is attached as `engine.cost_table`);
    `record_wall(name, seconds, synced, launches)` feeds a measured
    dispatch wall into an EMA, accumulates the dispatch's kernel launches
    and, for synced walls with a registry attached, sets
    `dalle_serving_mfu{program=}` and `dalle_serving_hbm_gbps{program=}`.

    The peaks: `peak_flops` / `hbm_bps` as given, else the card's from
    `device_name` (`device_peaks`). Without a peak (the CPU) rows carry no
    MFU and no gauge is set.
    """

    def __init__(
        self,
        peak_flops: Optional[float] = None,
        hbm_bps: Optional[float] = None,
        registry=None,
        ema_alpha: float = 0.2,
        device_name: Optional[str] = None,
    ):
        card_flops, card_bps = device_peaks(device_name)
        self.device_name = device_name
        self.peak_flops = float(peak_flops) if peak_flops is not None else card_flops
        self.hbm_bps = float(hbm_bps) if hbm_bps is not None else card_bps
        self.ema_alpha = float(ema_alpha)
        self._rows: Dict[str, _ProgramRow] = {}
        self._errors: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._m_mfu = self._m_bw = None
        if registry is not None:
            self._m_mfu = registry.gauge_family(
                "dalle_serving_mfu",
                "model-FLOPs-utilization of the most recent synced dispatches per program "
                "(counted FLOPs over the EMA wall, against the card's peak)",
                label_name="program",
            )
            self._m_bw = registry.gauge_family(
                "dalle_serving_hbm_gbps",
                "achieved memory bandwidth (counted bytes / EMA wall) per program, GB/s",
                label_name="program",
            )

    # ------------------------------------------------------------ capture

    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._rows

    def add(
        self,
        name: str,
        flops: float,
        bytes_accessed: float,
        memory: Optional[Dict[str, int]] = None,
        launches: Optional[Dict[str, int]] = None,
    ) -> None:
        """Register one program's counted cost (a tensor-parallel engine's
        summed over its shards); `launches` are the kernel launches of the
        dispatch it was counted at."""
        row = _ProgramRow(name, flops, bytes_accessed, dict(memory or {}))
        row.launches_per_dispatch = dict(launches or {})
        with self._lock:
            self._rows[name] = row
            self._errors.pop(name, None)

    def record_error(self, name: str, exc: BaseException) -> None:
        """Record a failed count: kept on the row's place in `rows()`,
        never raised into the warmup."""
        with self._lock:
            self._errors[name] = repr(exc)

    # ---------------------------------------------------------- live wall

    def _mfu(self, flops: float, wall_s: float) -> Optional[float]:
        if not self.peak_flops or not wall_s:
            return None
        return min(1.0, flops / (wall_s * self.peak_flops))

    def record_wall(
        self, name: str, seconds: float, synced: bool = True, launches: Optional[Dict[str, int]] = None
    ) -> None:
        with self._lock:
            row = self._rows.get(name)
            if row is None:
                return
            row.dispatches += 1
            row.last_wall_s = float(seconds)
            row.wall_ema_s = (
                float(seconds) if row.wall_ema_s is None
                else (1 - self.ema_alpha) * row.wall_ema_s + self.ema_alpha * float(seconds)
            )
            row.synced = row.synced or bool(synced)
            if launches is not None:
                row.launches_per_dispatch = dict(launches)
                for k, v in launches.items():
                    row.launches[k] = row.launches.get(k, 0) + int(v)
            export = row.synced and row.wall_ema_s > 0
            if export:
                mfu = self._mfu(row.flops, row.wall_ema_s)
                bw = row.bytes_accessed / row.wall_ema_s / 1e9
        if export:
            if self._m_mfu is not None and mfu is not None:
                self._m_mfu.labels(name).set(mfu)
            if self._m_bw is not None:
                self._m_bw.labels(name).set(bw)

    def mfu(self, name: str) -> Optional[float]:
        with self._lock:
            row = self._rows.get(name)
        if row is None or not row.synced or not row.wall_ema_s:
            return None
        return self._mfu(row.flops, row.wall_ema_s)

    # ------------------------------------------------------------- export

    def rows(self) -> List[Dict]:
        """JSON-ready rows of `GET /debug/programs`."""
        with self._lock:
            rows = list(self._rows.values())
            errors = dict(self._errors)
            launch_totals = [(dict(r.launches), dict(r.launches_per_dispatch)) for r in rows]
        out = []
        for r, (launches, per_dispatch) in zip(rows, launch_totals):
            ai = r.flops / r.bytes_accessed if r.bytes_accessed else None
            row = {
                "program": r.name,
                "flops": r.flops,
                "bytes_accessed": r.bytes_accessed,
                "arithmetic_intensity": round(ai, 2) if ai else None,
                "memory": r.memory,
                "dispatches": r.dispatches,
                "launches": launches,
                "launches_per_dispatch": per_dispatch,
            }
            live = r.wall_ema_s is not None
            if live:
                row["wall_ema_ms"] = round(r.wall_ema_s * 1e3, 3)
                row["wall_includes_sync"] = r.synced
                if r.synced and r.wall_ema_s > 0:
                    # significant figures, not decimal places: a toy CPU
                    # engine's MFU against a given peak is ~1e-7
                    mfu = self._mfu(r.flops, r.wall_ema_s)
                    if mfu is not None:
                        row["mfu"] = float(f"{mfu:.4g}")
                    row["hbm_gbps"] = float(f"{r.bytes_accessed / r.wall_ema_s / 1e9:.4g}")
            out.append(row)
        for name, err in errors.items():
            out.append({"program": name, "error": err})
        return out

    def detail(self) -> Dict:
        return {
            "device": self.device_name,
            "peak_flops": self.peak_flops,
            "hbm_bps": self.hbm_bps,
            "programs": self.rows(),
        }


class _NullVitals:
    """Shared no-op stand-in engines hold by default: dispatch-clock calls
    in the hot path cost one attribute lookup and nothing else, and no
    object is ever allocated (the tracer's NULL_TRACE pattern)."""

    __slots__ = ()
    enabled = False
    samples_taken = 0

    def __bool__(self) -> bool:
        return False

    def dispatch_begin(self, name: str) -> None:
        pass

    def dispatch_end(self, name: str, seconds: float) -> None:
        pass


NULL_VITALS = _NullVitals()


class StallWatchdog:
    """Stall detectors evaluated on the vitals tick (host state only).

    `check(snapshot)` returns the list of stall records it fired this
    tick (for tests and for the caller to log); state needed across ticks
    (per-reason cooldowns, progress tracking) lives here so the sampler
    stays stateless about stalls.
    """

    #: detector names — the `reason` label on dalle_serving_stalls_total
    DISPATCH_STUCK = "dispatch_stuck"
    QUEUE_HEAD_STALE = "queue_head_stale"
    NO_PROGRESS = "no_progress"

    def __init__(
        self,
        dispatch_mult: float = 8.0,
        dispatch_min_s: float = 1.0,
        queue_age_budget_s: Optional[float] = None,
        no_progress_ticks: int = 3,
        cooldown_s: float = 30.0,
        first_dispatch_budget_s: float = 600.0,
        registry=None,
        log=None,
        state_dump_fn: Optional[Callable[[], Dict]] = None,
    ):
        self.dispatch_mult = float(dispatch_mult)
        self.dispatch_min_s = float(dispatch_min_s)
        self.queue_age_budget_s = queue_age_budget_s
        self.no_progress_ticks = int(no_progress_ticks)
        self.cooldown_s = float(cooldown_s)
        # a program's first dispatch may legitimately be compiling, so
        # it gets this LARGE fixed budget instead of the EMA-based one —
        # large, not unlimited: a deadlocked first dispatch must still
        # eventually fire (nothing else would catch it: no-progress is
        # suppressed while a dispatch is in flight)
        self.first_dispatch_budget_s = float(first_dispatch_budget_s)
        self.log = log
        self.state_dump_fn = state_dump_fn
        # guards recent/_last_fired: _fire runs on the sampler thread
        # while /healthz and /debug/vitals handlers read them (deque/dict
        # iteration during mutation raises RuntimeError)
        self._lock = threading.Lock()
        self._m_stalls = None
        if registry is not None:
            self._m_stalls = registry.counter_family(
                "dalle_serving_stalls_total",
                "watchdog stall detections by reason",
                label_name="reason",
            )
        self._last_fired: Dict[str, float] = {}
        self._progress_mark = None  # (chunk_index, consecutive stuck ticks)
        self.stalls_fired = 0
        #: most recent stall summaries (reason + detail, no dump), newest
        #: last — /debug/vitals and the degraded healthz read these
        self.recent: deque = deque(maxlen=16)

    def last_stall_age_s(self) -> Optional[float]:
        with self._lock:
            if not self._last_fired:
                return None
            return time.monotonic() - max(self._last_fired.values())

    def recent_stalls(self) -> List[Dict]:
        """Snapshot of the recent-stall ring for exporters (the sampler
        thread appends concurrently)."""
        with self._lock:
            return list(self.recent)

    # ------------------------------------------------------------- checks

    def _fire(self, reason: str, now: float, **detail) -> Optional[Dict]:
        record = {"reason": reason, **detail}
        with self._lock:
            last = self._last_fired.get(reason)
            if last is not None and now - last < self.cooldown_s:
                return None
            self._last_fired[reason] = now
            self.stalls_fired += 1
            self.recent.append({"ts": round(time.time(), 3), **record})
        if self._m_stalls is not None:
            self._m_stalls.labels(reason).inc()
        if self.log is not None:
            dump = None
            if self.state_dump_fn is not None:
                try:
                    dump = self.state_dump_fn()
                except Exception as exc:  # the dump must not kill the tick
                    dump = {"error": repr(exc)}
            extra = {}
            if not (isinstance(dump, dict) and "worker_stacks" in dump):
                # the server's state_dump already captures worker stacks;
                # only fall back to our own capture when the dump didn't
                # (standalone watchdogs, custom dump fns) — one
                # sys._current_frames pass per stall, not two, under ONE
                # schema key wherever the stacks land
                extra["worker_stacks"] = thread_stacks("batcher")
            self.log.event("stall", **record, state=dump, **extra)
        return record

    def check(self, snapshot: Dict, wall_ema: Dict[str, float]) -> List[Dict]:
        """Evaluate every detector against one vitals snapshot. `wall_ema`
        maps program name -> typical dispatch wall (the EMA the dispatch
        clock keeps), the baseline for "this dispatch is taking too long".
        """
        now = time.monotonic()
        fired = []

        inflight = snapshot.get("dispatch_inflight")
        if inflight is not None:
            name, age = inflight["program"], inflight["age_s"]
            if inflight.get("first"):
                # may be paying a legitimate kernel build (--no_warmup
                # cold start): a large fixed budget, not the EMA one
                ema = None
                budget = self.first_dispatch_budget_s
            else:
                ema = wall_ema.get(name)
                budget = max(
                    self.dispatch_min_s,
                    self.dispatch_mult * ema if ema else 0.0,
                )
            if age > budget:
                rec = self._fire(
                    self.DISPATCH_STUCK, now, program=name,
                    age_s=round(age, 3), budget_s=round(budget, 3),
                    wall_ema_s=round(ema, 4) if ema else None,
                )
                if rec:
                    fired.append(rec)

        head_age = snapshot.get("queue_head_age_s")
        if (
            self.queue_age_budget_s is not None
            and head_age is not None
            and head_age > self.queue_age_budget_s
        ):
            rec = self._fire(
                self.QUEUE_HEAD_STALE, now,
                head_age_s=round(head_age, 3),
                budget_s=self.queue_age_budget_s,
                queue_depth_rows=snapshot.get("queue_depth_rows"),
            )
            if rec:
                fired.append(rec)

        # zero decode progress with slots active and NO dispatch in
        # flight: the worker is wedged somewhere host-side (the stuck-
        # dispatch detector owns the in-flight case)
        chunk_index = snapshot.get("chunk_index")
        slots = snapshot.get("slots_active") or 0
        if chunk_index is not None and slots > 0 and inflight is None:
            mark, stuck = self._progress_mark or (None, 0)
            stuck = stuck + 1 if mark == chunk_index else 0
            self._progress_mark = (chunk_index, stuck)
            if stuck >= self.no_progress_ticks:
                rec = self._fire(
                    self.NO_PROGRESS, now, chunk_index=chunk_index,
                    slots_active=slots, ticks=stuck,
                )
                if rec:
                    fired.append(rec)
        else:
            self._progress_mark = (chunk_index, 0)
        return fired


class SLOTarget:
    """One declarative latency objective over an existing histogram."""

    __slots__ = ("name", "threshold_s", "objective", "histogram")

    def __init__(self, name: str, threshold_s: float, histogram: str,
                 objective: float = 0.99):
        assert 0.0 < objective < 1.0
        self.name = name
        self.threshold_s = float(threshold_s)
        self.objective = float(objective)
        self.histogram = histogram  # registry metric name to read

    def describe(self) -> Dict:
        return {
            "slo": self.name,
            "threshold_ms": round(self.threshold_s * 1e3, 1),
            "objective": self.objective,
            "histogram": self.histogram,
        }


class SLOTracker:
    """Rolling-window SLO burn rate from cumulative histogram buckets.

    Each `update()` diffs the target histogram's bucket counts against
    the previous tick and classifies the delta as compliant (buckets
    whose bound <= threshold) or violating — bucket-granular and
    CONSERVATIVE: a threshold that falls between bounds counts its
    straddling bucket as violating, so a misaligned target over-alerts
    rather than silently never alerting (stated in `status()`). It keeps
    a deque of per-tick deltas spanning `window_s`. Burn rate is
    the window's violation fraction over the allowed error budget
    (1 - objective): 1.0 means exactly on budget, above it the budget is
    burning and /healthz degrades.
    """

    def __init__(self, targets: Sequence[SLOTarget], registry,
                 window_s: float = 300.0):
        self.targets = list(targets)
        self.registry = registry
        self.window_s = float(window_s)
        self._m_burn = registry.gauge_family(
            "dalle_slo_burn_rate",
            "rolling-window error-budget burn rate per SLO (>1 = budget "
            "burning; /healthz degrades)",
            label_name="slo",
        )
        self._prev: Dict[str, tuple] = {}  # slo -> (counts, total)
        self._window: Dict[str, deque] = {
            t.name: deque() for t in self.targets
        }
        self._burn: Dict[str, float] = {t.name: 0.0 for t in self.targets}
        # update() runs on the sampler thread; status()/burning() on
        # /healthz handler threads — the window deques need the lock
        # (iteration during append raises RuntimeError)
        self._lock = threading.Lock()

    @staticmethod
    def _split(buckets, counts, threshold_s):
        """(ok, total) of a bucket snapshot: compliant = observations in
        buckets whose bound <= threshold (provably <= threshold). A
        threshold between bounds leaves its straddling bucket ambiguous —
        counted VIOLATING, so off-bucket thresholds fail conservative
        (burn over-reports) instead of silently never alerting; align
        thresholds with bucket bounds for exact accounting."""
        ok = 0
        for bound, n in zip(buckets, counts):
            if bound > threshold_s:
                break
            ok += n
        return ok, sum(counts)

    def update(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        burns = {}
        for t in self.targets:
            hist = self.registry.get(t.histogram)
            if hist is None or not hasattr(hist, "bucket_counts"):
                continue
            buckets, counts, total, _ = hist.bucket_counts()
            ok, _ = self._split(buckets, counts, t.threshold_s)
            with self._lock:
                prev_ok, prev_total = self._prev.get(t.name, (0, 0))
                d_total = total - prev_total
                d_viol = (total - ok) - (prev_total - prev_ok)
                self._prev[t.name] = (ok, total)
                win = self._window[t.name]
                if d_total > 0:
                    win.append((now, max(d_viol, 0), d_total))
                while win and now - win[0][0] > self.window_s:
                    win.popleft()
                viol = sum(v for _, v, _ in win)
                seen = sum(n for _, _, n in win)
                burn = (
                    (viol / seen) / (1.0 - t.objective) if seen else 0.0
                )
                self._burn[t.name] = burn
            burns[t.name] = burn
        for name, burn in burns.items():  # gauges have their own locks
            self._m_burn.labels(name).set(burn)

    def burning(self) -> List[str]:
        with self._lock:
            return [name for name, b in self._burn.items() if b > 1.0]

    def max_burn(self) -> float:
        """Worst burn rate across every tracked SLO — the scalar the
        batcher's preemption-aware shed consults (0.0 with no targets
        or no observations yet)."""
        with self._lock:
            return max(self._burn.values(), default=0.0)

    def status(self) -> List[Dict]:
        out = []
        for t in self.targets:
            with self._lock:
                win_viol = sum(v for _, v, _ in self._window[t.name])
                win_seen = sum(n for _, _, n in self._window[t.name])
                burn = self._burn[t.name]
            out.append({
                **t.describe(),
                "window_s": self.window_s,
                "burn_rate": round(burn, 3),
                "window_violations": win_viol,
                "window_observations": win_seen,
                "granularity": "histogram buckets (off-bound thresholds "
                               "count the straddling bucket as violating)",
            })
        return out


class EngineVitals:
    """Bounded-ring vitals sampler + dispatch clock for one serving stack.

    Construction is cheap and inert; `bind(engine, batcher, ...)` wires
    the host-state sources and `start()` launches the daemon sampler
    thread (no-ops when `enabled=False` — the counter-gated
    zero-allocation path). Engines call `dispatch_begin/dispatch_end`
    around every device dispatch; both are plain attribute stores, and
    `dispatch_end` feeds the per-program wall EMA the watchdog's
    stuck-dispatch budget derives from.
    """

    def __init__(
        self,
        enabled: bool = True,
        interval_s: float = 1.0,
        max_samples: int = 512,
        registry=None,
        log=None,
        watchdog: Optional[StallWatchdog] = None,
        slo: Optional[SLOTracker] = None,
    ):
        self.enabled = bool(enabled)
        self.interval_s = float(interval_s)
        self._ring: deque = deque(maxlen=int(max_samples))
        self._lock = threading.Lock()
        #: vitals snapshots actually allocated — the counter-gated
        #: zero-overhead-when-off contract, like Tracer.spans_created
        self.samples_taken = 0
        self.registry = registry
        self.log = log
        self.watchdog = watchdog
        self.slo = slo
        self._engine = None
        self._batcher = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # dispatch clock: written by the engine thread, read (torn reads
        # tolerated — monotonic floats) by the sampler thread
        self._inflight_name: Optional[str] = None
        self._inflight_t0 = 0.0
        self._inflight_first = False
        self._inflight_c0 = 0
        self._wall_ema: Dict[str, float] = {}
        #: programs that have completed >= 1 dispatch since this sampler
        #: bound: a program's first dispatch may be paying a legitimate
        #: kernel build (--no_warmup), so the stuck detector exempts it;
        #: whether its wall seeds the EMA is decided by whether a build
        #: actually landed (the compile_guard counter delta)
        self._seen_programs: set = set()
        self._m_inflight_age = self._m_head_age = self._m_mem = None
        self._m_hbm = None
        if self.enabled and registry is not None:
            # per-device memory gauge family: "the device is full" is
            # useless until it names which one
            self._m_hbm = registry.gauge_family(
                "dalle_serving_hbm_bytes",
                "torch.cuda allocated bytes per device of the engine "
                "(absent on the CPU, which reports no memory stats)",
                label_name="device",
            )
            self._m_inflight_age = registry.gauge(
                "dalle_serving_dispatch_inflight_age_seconds",
                "age of the engine dispatch currently in flight (0 when "
                "idle)",
            )
            self._m_head_age = registry.gauge(
                "dalle_serving_queue_head_age_seconds",
                "age of the oldest queued request (0 when the queue is "
                "empty)",
            )
            self._m_mem = registry.gauge(
                "dalle_serving_device_bytes_in_use",
                "torch.cuda allocated bytes on the engine's first device "
                "(0 on the CPU)",
            )

    # ------------------------------------------------------ dispatch clock

    def dispatch_begin(self, name: str) -> None:
        self._inflight_first = name not in self._seen_programs
        self._inflight_c0 = compile_guard.compile_count()
        self._inflight_t0 = time.monotonic()
        self._inflight_name = name

    def dispatch_end(self, name: str, seconds: float) -> None:
        self._inflight_name = None
        self._seen_programs.add(name)
        if compile_guard.compile_count() > self._inflight_c0:
            # a kernel build landed during this dispatch (--no_warmup cold
            # start): the wall is build latency, and folding it in would
            # inflate the watchdog's stuck budget by dispatch_mult * build_s
            return
        # under the lock: the sampler thread snapshots this dict per tick
        # while engine dispatch threads land EMA updates here
        with self._lock:
            ema = self._wall_ema.get(name)
            self._wall_ema[name] = (
                seconds if ema is None else 0.8 * ema + 0.2 * seconds
            )

    def inflight(self) -> Optional[Dict]:
        name = self._inflight_name
        if name is None:
            return None
        return {
            "program": name,
            "age_s": time.monotonic() - self._inflight_t0,
            # True while the program's FIRST dispatch is in flight — it
            # may be compiling, so the stuck detector exempts it
            "first": self._inflight_first,
        }

    # ------------------------------------------------------------ lifecycle

    def bind(self, engine=None, batcher=None, log=None,
             state_dump_fn=None) -> "EngineVitals":
        self._engine = engine
        self._batcher = batcher
        if log is not None:
            self.log = log
        if self.watchdog is not None:
            if log is not None and self.watchdog.log is None:
                self.watchdog.log = log
            if state_dump_fn is not None:
                self.watchdog.state_dump_fn = state_dump_fn
        if engine is not None and getattr(engine, "vitals", None) is not None:
            engine.vitals = self if self.enabled else NULL_VITALS
        return self

    def start(self) -> "EngineVitals":
        if not self.enabled or self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="dalle-vitals", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # a bad source must not kill the sampler
                pass

    # ------------------------------------------------------------ sampling

    def _engine_devices(self) -> List:
        """The engine's distinct torch devices, in shard order (one for an
        unsharded engine; two shards may share a card)."""
        engine = self._engine
        tp = getattr(engine, "tp_model", None)
        devices = list(getattr(tp, "devices", None) or [getattr(engine, "device", None)])
        out = []
        for d in devices:
            if d is not None and str(d) not in [str(o) for o in out]:
                out.append(d)
        return out

    def _device_memory_stats(self, device=None) -> Optional[Dict]:
        """Overridable device seam: the torch.cuda allocator's readings for
        `device` (default: the engine's first device) as
        {"bytes_in_use", "peak_bytes_in_use", "bytes_reserved",
        "bytes_limit"}; None on the CPU, which has none. Tests stub this,
        so no test touches a card."""
        if device is None:
            devices = self._engine_devices()
            device = devices[0] if devices else None
        if device is None or getattr(device, "type", str(device).split(":")[0]) != "cuda":
            return None
        try:
            import torch

            stats = torch.cuda.memory_stats(device)
            return {
                "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
                "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
                "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
            }
        except Exception:
            return None

    def _device_memory_stats_all(self) -> Dict[str, Dict]:
        """`_device_memory_stats` for every device of the engine, keyed by
        the device's name ("cuda:0"). An unsharded engine goes through the
        single-device seam, one query a tick."""
        devices = self._engine_devices()
        if len(devices) <= 1:
            stats = self._device_memory_stats()
            return {str(devices[0]) if devices else "device:0": stats} if stats else {}
        out: Dict[str, Dict] = {}
        for d in devices:
            stats = self._device_memory_stats(d)
            if stats:
                out[str(d)] = stats
        return out

    def sample(self) -> Dict:
        """One vitals snapshot from host state (never dispatches)."""
        snap: Dict = {"ts": round(time.time(), 3)}
        batcher = self._batcher
        if batcher is not None:
            snap["queue_depth_rows"] = batcher.queue_depth_rows
            head_age = getattr(batcher, "head_age_s", None)
            if head_age is not None:
                snap["queue_head_age_s"] = head_age()
            class_depths = getattr(batcher, "class_depths", None)
            if class_depths is not None:
                # per-priority-class queue split: under overload the
                # headline depth hides WHICH class is backing up
                snap["queue_depth_by_class"] = class_depths()
            alloc = getattr(batcher, "allocator", None)
            if alloc is not None:
                snap["slots_active"] = alloc.n_active
        engine = self._engine
        if engine is not None:
            chunk_index = getattr(engine, "chunk_index", None)
            if chunk_index is not None:
                snap["chunk_index"] = int(chunk_index)
            kv = getattr(engine, "kv", None)
            if kv is not None:
                snap["blocks_active"] = kv.blocks_active
                snap["blocks_free"] = kv.blocks_free
                snap["prefix_entries"] = len(kv.cache)
        snap["dispatch_inflight"] = self.inflight()
        snap["compile_count"] = compile_guard.compile_count()
        per_dev = self._device_memory_stats_all()
        if per_dev:
            snap["memory_stats_per_device"] = {
                dev: {
                    k: int(v) for k, v in stats.items()
                    if isinstance(v, (int, float))
                }
                for dev, stats in per_dev.items()
            }
            snap["bytes_in_use_total"] = sum(
                s.get("bytes_in_use", 0)
                for s in snap["memory_stats_per_device"].values()
            )
            # the legacy single-device block is the FIRST device's stats
            # — derived, not re-queried (one memory_stats pass per device
            # per tick, not two for device 0)
            snap["memory_stats"] = next(
                iter(snap["memory_stats_per_device"].values())
            )
        return snap

    def tick(self) -> Dict:
        """Sample once, run the watchdog and SLO updates, update gauges.
        Public so tests drive deterministic ticks without the thread."""
        snap = self.sample()
        with self._lock:
            self._ring.append(snap)
            self.samples_taken += 1
            # snapshot the EMA table while no dispatch thread is mid-update
            # (dispatch_end mutates it under this lock)
            wall_ema = dict(self._wall_ema)
        if self._m_inflight_age is not None:
            inflight = snap.get("dispatch_inflight")
            self._m_inflight_age.set(inflight["age_s"] if inflight else 0.0)
        if self._m_head_age is not None:
            self._m_head_age.set(snap.get("queue_head_age_s") or 0.0)
        if self._m_mem is not None:
            self._m_mem.set(
                (snap.get("memory_stats") or {}).get("bytes_in_use", 0)
            )
        if self._m_hbm is not None:
            for dev, stats in (
                snap.get("memory_stats_per_device") or {}
            ).items():
                self._m_hbm.labels(dev).set(stats.get("bytes_in_use", 0))
        if self.watchdog is not None:
            self.watchdog.check(snap, wall_ema)
        if self.slo is not None:
            self.slo.update()  # the tracker guards its windows with its own lock
        return snap

    # ------------------------------------------------------------- export

    def recent(self, n: Optional[int] = None) -> List[Dict]:
        with self._lock:
            samples = list(self._ring)
        return samples if n is None else samples[-n:]

    def reset_window(self) -> None:
        """Drop ring contents (bench: measure only the open-loop window)."""
        with self._lock:
            self._ring.clear()

    def window_summary(self) -> Dict:
        """mean/peak aggregates over the current ring — the bench's
        `vitals` block and a quick /debug/vitals headline."""
        samples = self.recent()
        out: Dict = {"samples": len(samples)}
        for key in ("slots_active", "blocks_active", "queue_depth_rows"):
            vals = [s[key] for s in samples if key in s]
            if vals:
                out[key] = {
                    "mean": round(sum(vals) / len(vals), 2),
                    "peak": max(vals),
                }
        return out

    def detail(self, n: Optional[int] = None) -> Dict:
        """JSON payload for `GET /debug/vitals`."""
        with self._lock:  # ticked by the sampler thread under this lock
            samples_taken = self.samples_taken
        out = {
            "enabled": self.enabled,
            "interval_s": self.interval_s,
            "samples_taken": samples_taken,
            "device": device_identity(self._engine),
            "summary": self.window_summary(),
            "samples": self.recent(n),
        }
        mesh_detail = getattr(self._engine, "mesh_detail", None)
        if mesh_detail is not None:
            # sharded engine: axis geometry and per-shard bytes beside
            # the per-device memory readings the samples carry
            out["mesh"] = mesh_detail()
        if self.watchdog is not None:
            out["stalls"] = self.watchdog.recent_stalls()
        if self.slo is not None:
            out["slo"] = self.slo.status()
        return out

    # ------------------------------------------------------------- health

    def degraded_reasons(self, window_s: float = 60.0) -> List[str]:
        """Why /healthz should report `degraded` (empty = fully ok):
        a watchdog stall within `window_s`, or an SLO burning."""
        reasons = []
        if self.watchdog is not None:
            age = self.watchdog.last_stall_age_s()
            if age is not None and age < window_s:
                stalls = self.watchdog.recent_stalls()
                last = stalls[-1] if stalls else {}
                reasons.append(
                    f"stall:{last.get('reason', 'unknown')}"
                )
        if self.slo is not None:
            reasons.extend(f"slo_burn:{name}" for name in self.slo.burning())
        return reasons
