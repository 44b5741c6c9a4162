"""Prometheus-style metric instruments for the serving layer, and the
trainer's logger, throughput meter and profiler hook.

Counterpart of the JAX package's `training/metrics.py`:

* `Counter`, `Gauge`, `Histogram`, the one-label `Family` and
  `MetricsRegistry`, which renders the Prometheus text exposition and,
  with `render(exemplars=True)`, the OpenMetrics flavour whose histogram
  buckets carry the trace ID of their most recent exemplar-carrying
  observation (`GET /metrics?exemplars=1`). Stdlib only and thread-safe:
  the batcher's worker and the HTTP handlers observe concurrently. The
  instrument names the serving layer registers are the reference's
  (`dalle_serving_*`).
* `parse_exposition` (with `ParsedSample` / `ParsedFamily`), the inverse
  of `render` in either flavour, and the reset-aware `counter_delta`,
  `merge_histogram_points` and `render_histogram_point` the fleet scraper
  (`obs/fleetmetrics.py`) federates replicas' `/metrics` with.
* `MetricsLogger`: scalars and images to wandb when it imports, else to
  `<out_dir>/metrics.jsonl` and PNG grids (`utils/images.py`, no PIL);
  `ThroughputMeter`: samples a second over interval crossings;
  `ProfilerHook`: a `torch.profiler` trace of one step, written as a
  Chrome trace, after which the trainer stops.
"""

from __future__ import annotations

import bisect
import json
import re
import threading
import time
from collections import deque
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple


def _fmt(v: float) -> str:
    """Prometheus number formatting: integers without a trailing .0."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class Counter:
    """Monotonically increasing counter."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def render(self, exemplars: bool = False) -> List[str]:
        # OpenMetrics reserves the _total suffix for the sample: the
        # family name drops it there, the classic text keeps it
        fam = self.name[: -len("_total")] if exemplars and self.name.endswith("_total") else self.name
        return [
            f"# HELP {fam} {self.help}",
            f"# TYPE {fam} counter",
            f"{self.name} {_fmt(self._value)}",
        ]


class Gauge:
    """Instantaneous value (queue depth, rows in flight, ...)."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def render(self, exemplars: bool = False) -> List[str]:
        return [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} gauge",
            f"{self.name} {_fmt(self._value)}",
        ]


# default buckets suit latencies in seconds and small counts
_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Histogram:
    """Cumulative-bucket histogram plus a reservoir of the last
    `reservoir_size` observations for ready-made percentiles, and the most
    recent observation that carried an exemplar (a trace ID)."""

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = _DEFAULT_BUCKETS,
        reservoir_size: int = 1024,
    ):
        self.name, self.help = name, help
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +inf bucket last
        self._sum = 0.0
        self._count = 0
        self._recent: deque = deque(maxlen=reservoir_size)
        #: (value, trace ID, unix time) of the last exemplar observation
        self._exemplar = None
        self._lock = threading.Lock()

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        v = float(value)
        with self._lock:
            self._counts[bisect.bisect_left(self.buckets, v)] += 1
            self._sum += v
            self._count += 1
            self._recent.append(v)
            if exemplar:
                self._exemplar = (v, str(exemplar), time.time())

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def bucket_counts(self):
        """A consistent snapshot for rolling-window readers (the SLO burn
        tracker diffs these between ticks): (bucket bounds, per-bucket
        counts with +Inf last, total count, sum)."""
        with self._lock:
            return self.buckets, tuple(self._counts), self._count, self._sum

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the reservoir (0.0 when empty)."""
        with self._lock:
            if not self._recent:
                return 0.0
            ordered = sorted(self._recent)
            return ordered[min(len(ordered) - 1, max(0, int(q * len(ordered))))]

    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def render(self, exemplars: bool = False) -> List[str]:
        with self._lock:
            lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
            # an exemplar annotates the one bucket its value falls in
            ex_idx, ex_suffix = None, ""
            if exemplars and self._exemplar is not None:
                ev, etid, ets = self._exemplar
                ex_idx = bisect.bisect_left(self.buckets, ev)
                ex_suffix = f' # {{trace_id="{etid}"}} {_fmt(ev)} {round(ets, 3)}'
            cum = 0
            for i, (bound, n) in enumerate(zip(self.buckets, self._counts)):
                cum += n
                suffix = ex_suffix if i == ex_idx else ""
                lines.append(f'{self.name}_bucket{{le="{_fmt(bound)}"}} {cum}{suffix}')
            suffix = ex_suffix if ex_idx == len(self.buckets) else ""
            lines.append(f'{self.name}_bucket{{le="+Inf"}} {self._count}{suffix}')
            lines.append(f"{self.name}_sum {_fmt(self._sum)}")
            lines.append(f"{self.name}_count {self._count}")
        for q, suffix in ((0.5, "p50"), (0.95, "p95")):
            lines.append(f"# TYPE {self.name}_{suffix} gauge")
            lines.append(f"{self.name}_{suffix} {_fmt(self.percentile(q))}")
        return lines


class Family:
    """One metric name with one label: `labels(value)` gets or creates
    the child instrument, `labels_extra(value, **more)` one that carries
    further label dimensions (`dalle_serving_mfu{program=,device=}`);
    `render` emits one HELP/TYPE header and every child's samples tagged
    with its labels."""

    def __init__(self, cls, name: str, help: str, label_name: str, **kw):
        self.cls, self.name, self.help = cls, name, help
        self.label_name = label_name
        self._kw = kw
        self._children: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _child(self, key: str, suffix: str):
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self.cls(self.name, self.help, **self._kw)
                child._label_suffix = suffix
                self._children[key] = child
            return child

    def labels(self, value) -> object:
        key = str(value)
        return self._child(key, f'{self.label_name}="{key}"')

    def labels_extra(self, value, **extra) -> object:
        """The child with the family label plus `extra` label dimensions,
        keyed by its full rendered label set (so it sits beside the plain
        `labels(value)` children under one header)."""
        pairs = [f'{self.label_name}="{value}"'] + [f'{k}="{v}"' for k, v in sorted(extra.items())]
        suffix = ",".join(pairs)
        return self._child(suffix, suffix)

    def items(self) -> List:
        """(label key, child) pairs, sorted by key."""
        with self._lock:
            return sorted(self._children.items())

    def render(self, exemplars: bool = False) -> List[str]:
        kind = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}[self.cls]
        fam = (
            self.name[: -len("_total")]
            if exemplars and self.cls is Counter and self.name.endswith("_total")
            else self.name
        )
        lines = [f"# HELP {fam} {self.help}", f"# TYPE {fam} {kind}"]
        for _, child in self.items():
            label = child._label_suffix
            for line in child.render(exemplars=exemplars):
                name, _, value = line.partition(" ")
                if line.startswith("#") or "_p50" in name or "_p95" in name:
                    continue
                if "{" in name:  # histogram bucket: merge the labels
                    base, rest = name.split("{", 1)
                    name = f"{base}{{{label},{rest}"
                else:
                    name = f"{name}{{{label}}}"
                lines.append(f"{name} {value}")
        return lines


class MetricsRegistry:
    """Named instruments, get-or-create by name (so independently built
    components share them), rendered as Prometheus text."""

    def __init__(self):
        self._instruments: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, help, **kw)
                self._instruments[name] = inst
        if not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} already registered as {type(inst).__name__}")
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "", buckets: Sequence[float] = _DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def _family(self, cls, name: str, help: str, label_name: str, **kw) -> Family:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = Family(cls, name, help, label_name, **kw)
                self._instruments[name] = inst
        if not (isinstance(inst, Family) and inst.cls is cls):
            raise TypeError(f"metric {name!r} already registered as {type(inst).__name__}")
        return inst

    def counter_family(self, name: str, help: str = "", label_name: str = "name") -> Family:
        """Labeled counter series (events by type, resumptions by reason)."""
        return self._family(Counter, name, help, label_name)

    def gauge_family(self, name: str, help: str = "", label_name: str = "name") -> Family:
        """Labeled gauge series (queue depth by priority class)."""
        return self._family(Gauge, name, help, label_name)

    def histogram_family(
        self, name: str, help: str = "", label_name: str = "shape",
        buckets: Sequence[float] = _DEFAULT_BUCKETS,
    ) -> Family:
        """Labeled histogram series (wall time by stage, occupancy by batch
        shape); its children render no p50 / p95 gauges."""
        return self._family(Histogram, name, help, label_name, buckets=buckets)

    def get(self, name: str):
        return self._instruments.get(name)

    def render(self, exemplars: bool = False) -> str:
        """Prometheus text exposition of every instrument. `exemplars=True`
        gives the OpenMetrics flavour: exemplar annotations (`#
        {trace_id="..."}`) on the histogram buckets that recorded one and
        the closing `# EOF` (serve it as `application/openmetrics-text`;
        classic text parsers reject it)."""
        with self._lock:
            instruments = sorted(self._instruments.items())
        lines: List[str] = []
        for _, inst in instruments:
            lines.extend(inst.render(exemplars=exemplars))
        if exemplars:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"


# ------------------------------------------------ exposition parsing
#
# The inverse of `MetricsRegistry.render()`, for the fleet scraper
# (obs/fleetmetrics.py): a router pulls each replica's GET /metrics body
# and needs the samples back as typed values to federate, delta and roll
# up. Both flavours parse (OpenMetrics' `_total`-stripped counter family
# names, `# {...}` bucket exemplars, `# EOF`), and so do the `_p50` /
# `_p95` gauges, which carry a TYPE line but no HELP.


class ParsedSample(NamedTuple):
    """One sample line: full rendered name (`foo_total`, `foo_bucket`,
    ...), label dict, value."""

    name: str
    labels: Dict[str, str]
    value: float

    def key(self) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
        """Hashable series identity (name + sorted labels): the join key
        of cross-scrape deltas and cross-replica rollups."""
        return self.name, tuple(sorted(self.labels.items()))


class ParsedFamily:
    """All samples of one metric family with its TYPE / HELP."""

    __slots__ = ("name", "type", "help", "samples")

    def __init__(self, name: str, type: str = "untyped", help: str = ""):
        self.name, self.type, self.help = name, type, help
        self.samples: List[ParsedSample] = []

    def histogram_series(self) -> Dict[Tuple[Tuple[str, str], ...], Dict]:
        """`_bucket` / `_sum` / `_count` samples reassembled into one point
        per non-`le` label set: `{"bounds", "cum", "count", "sum"}` with
        cumulative bucket counts and `+Inf` folded into `count`."""
        out: Dict[Tuple[Tuple[str, str], ...], Dict] = {}

        def point(labels: Dict[str, str]) -> Dict:
            k = tuple(sorted((n, v) for n, v in labels.items() if n != "le"))
            return out.setdefault(k, {"bounds": [], "cum": [], "count": 0, "sum": 0.0})

        for s in self.samples:
            if s.name == f"{self.name}_bucket":
                le = s.labels.get("le", "+Inf")
                if le == "+Inf":
                    point(s.labels)["count"] = int(s.value)
                else:
                    p = point(s.labels)
                    p["bounds"].append(float(le))
                    p["cum"].append(int(s.value))
            elif s.name == f"{self.name}_sum":
                point(s.labels)["sum"] = float(s.value)
            elif s.name == f"{self.name}_count":
                point(s.labels)["count"] = int(s.value)
        for p in out.values():
            order = sorted(range(len(p["bounds"])), key=p["bounds"].__getitem__)
            p["bounds"] = [p["bounds"][i] for i in order]
            p["cum"] = [p["cum"][i] for i in order]
        return out


_SAMPLE_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
#: suffixes that attach a sample to a declared family: classic counters
#: match the family name, OpenMetrics ones add `_total`, histograms fan
#: out into bucket / sum / count
_FAMILY_SUFFIXES = ("", "_total", "_bucket", "_sum", "_count")


def _unescape_label(v: str) -> str:
    return v.replace('\\"', '"').replace("\\n", "\n").replace("\\\\", "\\")


def _parse_sample_line(line: str) -> ParsedSample:
    """`name[{labels}] value[ # exemplar...]` -> ParsedSample; ValueError
    on anything malformed (the scraper counts that as a failed scrape,
    not a partial one)."""
    name, labels_part, rest = line, "", ""
    brace = line.find("{")
    if brace >= 0:
        close = line.find("}", brace)
        if close < 0:
            raise ValueError(f"unterminated label block: {line!r}")
        name = line[:brace]
        labels_part = line[brace + 1 : close]
        rest = line[close + 1 :].strip()
    else:
        try:
            name, rest = line.split(None, 1)
        except ValueError:
            raise ValueError(f"sample line without a value: {line!r}")
    if not _SAMPLE_NAME_RE.match(name):
        raise ValueError(f"bad sample name in line: {line!r}")
    labels: Dict[str, str] = {}
    if labels_part:
        matched = _LABEL_RE.findall(labels_part)
        if _LABEL_RE.sub("", labels_part).replace(",", "").strip():
            raise ValueError(f"bad label block: {labels_part!r}")
        labels = {k: _unescape_label(v) for k, v in matched}
    # an OpenMetrics exemplar trails the value as ` # {...} v ts`
    value_token = rest.split(" # ", 1)[0].strip().split()
    if len(value_token) != 1:
        raise ValueError(f"bad sample value in line: {line!r}")
    tok = value_token[0]
    try:
        value = float("inf") if tok == "+Inf" else float(tok)
    except ValueError:
        raise ValueError(f"non-numeric sample value {tok!r} in {line!r}")
    return ParsedSample(name, labels, value)


def parse_exposition(text: str) -> Dict[str, ParsedFamily]:
    """Prometheus text exposition (either flavour `render` emits) back
    into `{family name: ParsedFamily}`. Strict on sample lines (a
    truncated or garbage body raises ValueError rather than returning half
    a scrape), lenient on metadata: unknown comments are skipped, TYPE
    without HELP is fine, and samples of no declared family land in an
    `untyped` one."""
    families: Dict[str, ParsedFamily] = {}

    def family_for(sample_name: str) -> ParsedFamily:
        for suffix in _FAMILY_SUFFIXES:
            if suffix and not sample_name.endswith(suffix):
                continue
            base = sample_name[: len(sample_name) - len(suffix)] if suffix else sample_name
            fam = families.get(base)
            if fam is not None:
                return fam
        return families.setdefault(sample_name, ParsedFamily(sample_name))

    for raw_line in text.splitlines():
        line = raw_line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                fam = families.setdefault(parts[2], ParsedFamily(parts[2]))
                fam.type = parts[3] if len(parts) > 3 else "untyped"
            elif len(parts) >= 3 and parts[1] == "HELP":
                fam = families.setdefault(parts[2], ParsedFamily(parts[2]))
                fam.help = parts[3] if len(parts) > 3 else ""
            continue  # `# EOF` and stray comments are skippable metadata
        sample = _parse_sample_line(line)
        family_for(sample.name).samples.append(sample)
    return families


def counter_delta(prev: Optional[float], cur: float) -> float:
    """Reset-aware counter delta: a counter that went down means the
    replica restarted, so the delta clamps to 0 (the restarted process's
    increments land from the next scrape); `prev=None` (first sight of the
    series) also reads 0, so a scraper joining mid-life does not claim the
    replica's whole history as one interval."""
    if prev is None or cur < prev:
        return 0.0
    return float(cur - prev)


def merge_histogram_points(points: Iterable[Dict]) -> Dict:
    """Per-replica histogram points (`histogram_series()`'s shape) merged
    into one. Equal bounds merge exactly; mismatched ones on the union
    grid, each histogram's cumulative count at an unknown bound floored to
    its nearest lower known bound (an undercount, never an overcount)."""
    points = [p for p in points if p is not None]
    if not points:
        return {"bounds": [], "cum": [], "count": 0, "sum": 0.0}
    bounds: List[float] = sorted({b for p in points for b in p["bounds"]})

    def cum_at(p: Dict, bound: float) -> int:
        idx = bisect.bisect_right(p["bounds"], bound) - 1
        return int(p["cum"][idx]) if idx >= 0 else 0

    return {
        "bounds": bounds,
        "cum": [sum(cum_at(p, b) for p in points) for b in bounds],
        "count": int(sum(p["count"] for p in points)),
        "sum": float(sum(p["sum"] for p in points)),
    }


def render_histogram_point(name: str, point: Dict, labels: str = "") -> List[str]:
    """Bucket / sum / count lines of one merged point (no HELP / TYPE:
    the caller owns the header). `labels` is a rendered `k="v"` list
    spliced in before `le`."""
    prefix = f"{labels}," if labels else ""
    lines = [f'{name}_bucket{{{prefix}le="{_fmt(b)}"}} {int(c)}' for b, c in zip(point["bounds"], point["cum"])]
    lines.append(f'{name}_bucket{{{prefix}le="+Inf"}} {int(point["count"])}')
    suffix = f"{{{labels}}}" if labels else ""
    lines.append(f'{name}_sum{suffix} {_fmt(point["sum"])}')
    lines.append(f'{name}_count{suffix} {int(point["count"])}')
    return lines


# ------------------------------------------------------------ training logs


class MetricsLogger:
    """The trainer's scalars and sample images: to a wandb run when wandb
    imports and starts (disabled under `debug`), else to
    `<out_dir>/metrics.jsonl` (one JSON object a `log`) and
    `<out_dir>/<name>_<step>.png` grids. Nothing when not `enabled`."""

    def __init__(
        self,
        project: str,
        config: Optional[dict] = None,
        enabled: bool = True,
        debug: bool = False,
        run_name: Optional[str] = None,
        out_dir: str = "logs",
        entity: Optional[str] = None,
    ):
        self.enabled = enabled
        self.out_dir = Path(out_dir)
        self.run = None
        self._jsonl = None
        if not enabled:
            return
        try:
            import wandb

            self.run = wandb.init(
                project=project, name=run_name, entity=entity, config=config or {},
                mode="disabled" if debug else "online",
            )
        except Exception:
            self.out_dir.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(self.out_dir / "metrics.jsonl", "a")

    def log(self, data: dict, step: Optional[int] = None) -> None:
        if not self.enabled:
            return
        scalars = {
            k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v)
            for k, v in data.items()
        }
        if self.run is not None:
            self.run.log(scalars, step=step)
        elif self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
            self._jsonl.flush()

    def log_images(self, images, caption: str, name: str, step: int) -> None:
        """`images` [H, W, C] or [N, H, W, C], about [0, 1]."""
        if not self.enabled:
            return
        if self.run is not None:
            import wandb

            self.run.log({name: wandb.Image(images, caption=caption)}, step=step)
            return
        import numpy as np

        from dalle_pytorch_tpu_torch.utils.images import save_image_grid

        imgs = np.asarray(images)
        if imgs.ndim == 3:
            imgs = imgs[None]
        save_image_grid(imgs, self.out_dir / f"{name}_{step}.png")

    def log_model_artifact(self, path, name: str = "trained-dalle") -> None:
        """Upload a checkpoint as a run artifact; nothing without a live
        wandb run (the file is on disk already)."""
        if not self.enabled or self.run is None:
            return
        try:
            import wandb

            art = wandb.Artifact(name, type="model")
            art.add_file(str(path))
            self.run.log_artifact(art)
        except Exception as e:  # an upload must never stop training
            print(f"[metrics] artifact upload failed: {e}")

    def finish(self) -> None:
        if self.run is not None:
            self.run.finish()
        if self._jsonl is not None:
            self._jsonl.close()


class StepTimer:
    """The time of each optimizer step: CUDA event pairs on a card (read
    once, after the run's last synchronize), host-clock spans elsewhere.
    `start()` before a step, `stop()` after it."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self._spans = []
        self._start = None

    def _mark(self):
        if not self.on_card:
            return time.perf_counter()
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start(self) -> None:
        self._start = self._mark()

    def stop(self) -> None:
        self._spans.append((self._start, self._mark()))

    def step_ms(self) -> list:
        return [a.elapsed_time(b) if self.on_card else 1e3 * (b - a) for a, b in self._spans]


class ThroughputMeter:
    """Samples a second, at each crossing of a multiple of `interval`
    steps, over the true step delta (a window may advance several)."""

    def __init__(self, interval: int = 10):
        self.interval = interval
        self._t0 = None
        self._step0 = None

    def update(self, step: int, batch_size: int) -> Optional[float]:
        if self._t0 is None:  # starts at the first call, whatever its step
            self._t0 = time.time()
            self._step0 = step
            return None
        if step // self.interval > self._step0 // self.interval:
            now = time.time()
            rate = batch_size * (step - self._step0) / (now - self._t0)
            self._t0 = now
            self._step0 = step
            return rate
        return None


class ProfilerHook:
    """A `torch.profiler` trace (CPU and, on a card, CUDA activity) of the
    first step at or after `profile_step`, written to
    `<out_dir>/trace_step_<step>.json`; `after_step` then says stop."""

    def __init__(self, enabled: bool, profile_step: int = 200, out_dir: str = "profiles"):
        self.enabled = enabled
        self.profile_step = profile_step
        self.out_dir = out_dir
        self._prof = None
        self._done = False

    def before_step(self, step: int) -> None:
        if self.enabled and not self._done and self._prof is None and step >= self.profile_step:
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()

    def after_step(self, step: int) -> bool:
        """True when training should stop (the trace is written)."""
        if self._prof is not None:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            Path(self.out_dir).mkdir(parents=True, exist_ok=True)
            path = Path(self.out_dir) / f"trace_step_{step}.json"
            self._prof.export_chrome_trace(str(path))
            self._prof = None
            self._done = True
            print(f"[profiler] trace for step {step} written to {path}")
        return self.enabled and self._done
