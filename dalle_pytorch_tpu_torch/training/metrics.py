"""Prometheus-style metric instruments for the serving layer.

Counterpart of the registry half of the JAX package's
`training/metrics.py`: `Counter`, `Gauge`, `Histogram`, the one-label
`Family` and `MetricsRegistry`, which renders the Prometheus text
exposition. Stdlib only and thread-safe: the batcher's worker and the
callers' threads observe concurrently. The instrument names the serving
layer registers are the reference's (`dalle_serving_*`). The training
loggers, throughput meter and profiler hook of that module are not ported
yet.
"""

from __future__ import annotations

import bisect
import threading
from collections import deque
from typing import Dict, List, Sequence


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

    def render(self) -> List[str]:
        return [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} counter",
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

    def render(self) -> List[str]:
        return [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} gauge",
            f"{self.name} {_fmt(self._value)}",
        ]


# default buckets suit latencies in seconds and small counts
_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Histogram:
    """Cumulative-bucket histogram plus a reservoir of the last
    `reservoir_size` observations for ready-made percentiles."""

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
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._counts[bisect.bisect_left(self.buckets, v)] += 1
            self._sum += v
            self._count += 1
            self._recent.append(v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

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

    def render(self) -> List[str]:
        with self._lock:
            lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
            cum = 0
            for bound, n in zip(self.buckets, self._counts):
                cum += n
                lines.append(f'{self.name}_bucket{{le="{_fmt(bound)}"}} {cum}')
            lines.append(f'{self.name}_bucket{{le="+Inf"}} {self._count}')
            lines.append(f"{self.name}_sum {_fmt(self._sum)}")
            lines.append(f"{self.name}_count {self._count}")
        for q, suffix in ((0.5, "p50"), (0.95, "p95")):
            lines.append(f"# TYPE {self.name}_{suffix} gauge")
            lines.append(f"{self.name}_{suffix} {_fmt(self.percentile(q))}")
        return lines


class Family:
    """One metric name with one label: `labels(value)` gets or creates
    the child instrument; `render` emits one HELP/TYPE header and every
    child's samples tagged `{label_name="value"}`."""

    def __init__(self, cls, name: str, help: str, label_name: str, **kw):
        self.cls, self.name, self.help = cls, name, help
        self.label_name = label_name
        self._kw = kw
        self._children: Dict[str, object] = {}
        self._lock = threading.Lock()

    def labels(self, value) -> object:
        key = str(value)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self.cls(self.name, self.help, **self._kw)
                self._children[key] = child
            return child

    def items(self) -> List:
        """(label value, child) pairs, sorted by label."""
        with self._lock:
            return sorted(self._children.items())

    def render(self) -> List[str]:
        kind = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}[self.cls]
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {kind}"]
        for key, child in self.items():
            label = f'{self.label_name}="{key}"'
            for line in child.render():
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

    def counter_family(self, name: str, help: str = "", label_name: str = "name") -> Family:
        """Labeled counter series (events by type, resumptions by reason)."""
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = Family(Counter, name, help, label_name)
                self._instruments[name] = inst
        if not (isinstance(inst, Family) and inst.cls is Counter):
            raise TypeError(f"metric {name!r} already registered as {type(inst).__name__}")
        return inst

    def get(self, name: str):
        return self._instruments.get(name)

    def render(self) -> str:
        """Prometheus text exposition of every instrument."""
        with self._lock:
            instruments = sorted(self._instruments.items())
        lines: List[str] = []
        for _, inst in instruments:
            lines.extend(inst.render())
        return "\n".join(lines) + "\n"
