"""Fleet telemetry plane: federation, usage accounting, capacity signal.

Counterpart of the JAX package's `obs/fleetmetrics.py` (host code, copied
so the port imports nothing of that package; no torch). Every replica
exports its own telemetry (/metrics, /debug/vitals, /healthz); this
module assembles the fleet's view on the router's side:

  * `FleetScraper`: a background thread (injectable clock, one socket
    seam, never on the dispatch path) polling each replica's `/metrics`,
    `/healthz` and `/debug/vitals` on an interval. A failed scrape (dead
    replica, garbage body, hung socket) marks the replica's generation
    stale and counts in `dalle_fleet_scrape_errors_total{replica=}`;
    routing never waits on a scrape. Each sweep also reads the replicas'
    `/debug/programs` (optional: a replica without a cost table simply
    has no rows) and hands the usage ledger the fleet's measured FLOP
    rate per card (`note_flops_rate`), from the cost rows' counted FLOPs
    over their synced dispatch walls.
  * federation: `GET /fleet/metrics` re-exports every replica sample
    with a `replica=` label plus rollups (`<name>:fleet_sum` for
    counters, reset-corrected since the scraper started; sum and max for
    gauges; bucket-merged `<name>:fleet` histograms); `GET /debug/fleet`
    is the structured JSON view.
  * `UsageLedger`: per-tenant / per-priority card-seconds and FLOPs from
    the router's own request accounting
    (`dalle_fleet_chip_seconds_total{tenant=,priority=}`,
    `GET /debug/usage`); tenants past `max_tenants` fold into
    `__other__`.
  * `CapacityModel.assess()`: a pure function over the latest scrape:
    per-replica MFU headroom, queue depth, SLO burn, the fleet goodput
    fraction (useful decoded tokens against re-decoded, discarded and
    warmup work) and an advisory `suggested_replicas`.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from dalle_pytorch_tpu_torch.training.metrics import (
    MetricsRegistry,
    ParsedFamily,
    counter_delta,
    merge_histogram_points,
    parse_exposition,
    render_histogram_point,
    _fmt,
)


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n"
    )


def _render_labels(labels: List[Tuple[str, str]]) -> str:
    return ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)


# --------------------------------------------------------------- scrapes


class ReplicaScrape:
    """Latest known telemetry for one replica: parsed metric families,
    /healthz detail, a vitals summary, and freshness bookkeeping. A
    failed scrape keeps the previous payload and flips `stale` — a
    consumer must treat a stale generation as history, not truth."""

    __slots__ = (
        "name", "url", "generation", "ts", "stale", "error",
        "families", "health", "vitals", "monotonic",
    )

    def __init__(self, name: str, url: str):
        self.name, self.url = name, url
        self.generation = 0          # successful scrapes only
        self.ts: Optional[float] = None
        self.stale = True            # nothing scraped yet
        self.error: Optional[str] = None
        self.families: Dict[str, ParsedFamily] = {}
        self.health: Dict = {}
        self.vitals: Dict = {}
        #: reset-corrected per-series counter totals since scraper start
        #: ({(sample name, sorted labels): float})
        self.monotonic: Dict[Tuple, float] = {}


class FleetScraper:
    """Background poller assembling the fleet view. Lifecycle mirrors
    the router's probe loop: `start()`/`stop()` own a daemon thread,
    `scrape_once()` is the thread body and the test seam (drive it with
    a stubbed clock), `_fetch()` is the single socket touch."""

    def __init__(
        self,
        replicas: List[Tuple[str, str]],
        registry: Optional[MetricsRegistry] = None,
        usage: Optional["UsageLedger"] = None,
        interval_s: float = 2.0,
        timeout_s: float = 2.0,
        time_fn: Callable[[], float] = time.monotonic,
        log=None,
    ):
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.registry = registry if registry is not None else MetricsRegistry()
        self.usage = usage
        self.log = log
        self._now = time_fn
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sweep = 0
        self._scrapes: Dict[str, ReplicaScrape] = {
            name: ReplicaScrape(name, url) for name, url in replicas
        }
        self._prev: Dict[Tuple, float] = {}  # (replica, series) → raw value
        r = self.registry
        self._m_scrapes = r.counter_family(
            "dalle_fleet_scrapes_total",
            "successful replica scrapes by the fleet telemetry poller",
            label_name="replica",
        )
        self._m_errors = r.counter_family(
            "dalle_fleet_scrape_errors_total",
            "failed replica scrapes (dead replica, garbage exposition "
            "body, timeout) — the generation goes stale, routing is "
            "unaffected",
            label_name="replica",
        )
        self._m_generation = r.gauge_family(
            "dalle_fleet_scrape_generation",
            "successful-scrape generation per replica",
            label_name="replica",
        )
        self._m_stale = r.gauge_family(
            "dalle_fleet_scrape_stale",
            "1 when the replica's latest scrape attempt failed and the "
            "carried generation is history, not truth",
            label_name="replica",
        )
        self._m_goodput = r.gauge(
            "dalle_fleet_goodput_fraction",
            "useful decoded tokens over total decode work (re-decoded, "
            "preempted-discarded, and warmup work are the waste terms)",
        )
        self._m_suggested = r.gauge(
            "dalle_fleet_suggested_replicas",
            "advisory replica count from the capacity model (the "
            "elastic-serving input signal; nothing acts on it yet)",
        )
        self._m_headroom = r.gauge_family(
            "dalle_fleet_mfu_headroom",
            "per-replica fraction of the serving-MFU ceiling still "
            "unused (1.0 = idle, 0.0 = at the ceiling)",
            label_name="replica",
        )

    # ---------------------------------------------------------- transport

    def _fetch(self, url: str, path: str) -> bytes:
        """The one scrape socket touch (stubbed in tests): GET url+path,
        return the body bytes. Raises on transport failure or non-200 —
        the caller converts that into a stale generation."""
        req = urllib.request.Request(url + path, method="GET")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            if resp.status != 200:
                raise urllib.error.HTTPError(
                    url + path, resp.status, "scrape failed", resp.headers,
                    None,
                )
            return resp.read()

    # ------------------------------------------------------------ sweeps

    def _scrape_one(self, scrape: ReplicaScrape, now: float) -> None:
        """Scrape one replica's three surfaces; commit atomically under
        the lock on success, mark stale (keeping the last good payload)
        on ANY failure."""
        try:
            metrics_body = self._fetch(scrape.url, "/metrics")
            families = parse_exposition(metrics_body.decode("utf-8"))
            health = json.loads(self._fetch(scrape.url, "/healthz") or b"{}")
            vitals = json.loads(
                self._fetch(scrape.url, "/debug/vitals?n=1") or b"{}"
            )
            if not isinstance(health, dict) or not isinstance(vitals, dict):
                raise ValueError("health/vitals body is not a JSON object")
        except urllib.error.HTTPError as exc:
            # /healthz answers 503 while draining/unhealthy — that is an
            # ANSWER for the prober, but for telemetry the payload may
            # be mid-shutdown; treat any non-200 as a failed scrape
            self._mark_failed(scrape, f"http {exc.code} on {exc.filename}")
            return
        except Exception as exc:
            self._mark_failed(scrape, repr(exc))
            return
        with self._lock:
            scrape.families = families
            scrape.health = health
            scrape.vitals = vitals
            scrape.ts = now
            scrape.stale = False
            scrape.error = None
            scrape.generation += 1
            for fam in families.values():
                if fam.type != "counter":
                    continue
                for s in fam.samples:
                    series = s.key()
                    prev = self._prev.get((scrape.name, series))
                    scrape.monotonic[series] = (
                        scrape.monotonic.get(series, 0.0)
                        + counter_delta(prev, s.value)
                    )
                    self._prev[(scrape.name, series)] = s.value
        self._m_scrapes.labels(scrape.name).inc()
        self._m_generation.labels(scrape.name).set(scrape.generation)
        self._m_stale.labels(scrape.name).set(0)

    def _mark_failed(self, scrape: ReplicaScrape, error: str) -> None:
        with self._lock:
            scrape.stale = True
            scrape.error = error
        self._m_errors.labels(scrape.name).inc()
        self._m_stale.labels(scrape.name).set(1)
        if self.log is not None:
            self.log.event(
                "fleet_scrape_failed", replica=scrape.name, error=error,
            )

    def scrape_once(self, now: Optional[float] = None) -> None:
        """One sweep over every replica — the scrape thread's body,
        callable directly from tests. Replicas are scraped CONCURRENTLY
        (sweep time = max fetch latency, not the sum), so one hung
        endpoint's timeout cannot starve the others' freshness."""
        now = self._now() if now is None else now
        with self._lock:
            scrapes = list(self._scrapes.values())
        if len(scrapes) == 1:
            self._scrape_one(scrapes[0], now)
        elif scrapes:
            threads = [
                threading.Thread(
                    target=self._scrape_one, args=(s, now),
                    name="dalle-fleet-scrape-one", daemon=True,
                )
                for s in scrapes
            ]
            for t in threads:
                t.start()
            for t in threads:
                # 3 fetches per replica, each bounded by timeout_s
                t.join(timeout=3.0 * self.timeout_s + 5.0)
        with self._lock:
            self._sweep += 1
        self._refresh_flops_rate(scrapes)
        self._refresh_capacity_gauges()

    def _replica_flops_rate(self, scrape: "ReplicaScrape") -> Optional[float]:
        """One replica's measured FLOP/s per card from its `/debug/programs`
        rows: counted FLOPs over the EMA wall of every synced program,
        weighted by dispatches. None when the replica reports no synced
        row (no cost table, nothing served yet) or the fetch fails."""
        try:
            detail = json.loads(self._fetch(scrape.url, "/debug/programs") or b"{}")
        except Exception:
            return None
        flops = wall = 0.0
        for row in (detail.get("programs") if isinstance(detail, dict) else None) or ():
            if not isinstance(row, dict) or not row.get("wall_includes_sync"):
                continue
            n = CapacityModel._num(row.get("dispatches")) or 0.0
            f = CapacityModel._num(row.get("flops"))
            ms = CapacityModel._num(row.get("wall_ema_ms"))
            if n > 0 and f and ms:
                flops += f * n
                wall += ms / 1e3 * n
        return flops / wall if wall > 0 else None

    def _refresh_flops_rate(self, scrapes: List["ReplicaScrape"]) -> None:
        """Feed the usage ledger the fleet-average FLOP rate per card over
        the replicas whose scrape is fresh and that report one."""
        if self.usage is None:
            return
        rates = [
            r for r in (self._replica_flops_rate(s) for s in scrapes if not s.stale)
            if r is not None
        ]
        if rates:
            self.usage.note_flops_rate(sum(rates) / len(rates))

    def _refresh_capacity_gauges(self) -> None:
        report = self.capacity_report()
        self._m_goodput.set(report["goodput"]["fraction"])
        self._m_suggested.set(report["suggested_replicas"])
        for name, rep in report["replicas"].items():
            headroom = rep.get("mfu_headroom")
            if headroom is not None:
                self._m_headroom.labels(name).set(headroom)

    # --------------------------------------------------------- lifecycle

    def start(self) -> "FleetScraper":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="dalle-fleet-scraper", daemon=True,
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.scrape_once()
            except Exception as exc:  # the scrape thread must never die;
                if self.log is not None:  # the stop-wait below is its
                    self.log.event(  # backoff before the retry
                        "fleet_sweep_error", error=repr(exc)
                    )
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=3.0 * self.timeout_s + 5.0)
            self._thread = None

    # ------------------------------------------------------------- reads

    def snapshot(self) -> Dict[str, ReplicaScrape]:
        """Shallow copy of the per-replica scrape map. The ReplicaScrape
        payloads are replaced wholesale on each successful sweep, so
        holding a reference across sweeps is safe for reading."""
        with self._lock:
            return dict(self._scrapes)

    def fleet_totals(self, sample_name: str) -> float:
        """Reset-corrected fleet total for one counter series name,
        summed across replicas and label sets, since scraper start."""
        total = 0.0
        with self._lock:
            for scrape in self._scrapes.values():
                for (name, _labels), v in scrape.monotonic.items():
                    if name == sample_name:
                        total += v
        return total

    def capacity_report(self) -> Dict:
        usage_summary = self.usage.summary() if self.usage is not None \
            else None
        return CapacityModel.assess(
            self.snapshot(),
            fleet_decoded_tokens=self.fleet_totals(
                "dalle_serving_decoded_tokens_total"
            ),
            fleet_resumed_tokens=self.fleet_totals(
                "dalle_serving_resumed_tokens_total"
            ),
            usage=usage_summary,
        )

    def fleet_detail(self) -> Dict:
        """The `GET /debug/fleet` JSON: per-replica freshness + health
        summary (including the prefix-cache Bloom digest each replica
        advertises), the capacity/goodput report, and usage totals."""
        now = self._now()
        with self._lock:
            sweep = self._sweep
            scrapes = dict(self._scrapes)
        replicas = {}
        for name, s in sorted(scrapes.items()):
            health = s.health or {}
            kv = health.get("kv") or {}
            entry = {
                "url": s.url,
                "generation": s.generation,
                "stale": s.stale,
                "age_s": (
                    round(now - s.ts, 3) if s.ts is not None else None
                ),
                "status": health.get("status"),
                "queue_depth_rows": health.get("queue_depth_rows"),
                "slots_active": health.get("slots_active"),
                "uptime_s": health.get("uptime_s"),
            }
            if s.error:
                entry["error"] = s.error
            if health.get("work"):
                entry["work"] = health["work"]
            bloom = (kv.get("prefix_cache") or {}).get("bloom")
            if bloom is not None:
                # the seen-keys digest a prefix-affine placer would intersect
                entry["prefix_bloom"] = bloom
            replicas[name] = entry
        out = {
            "sweep": sweep,
            "interval_s": self.interval_s,
            "replicas": replicas,
            "capacity": self.capacity_report(),
        }
        if self.usage is not None:
            out["usage"] = self.usage.summary()
        return out

    # -------------------------------------------------------- federation

    def federated_render(self) -> str:
        """The `GET /fleet/metrics` body: every replica sample re-tagged
        `replica="name"`, one HELP/TYPE header per family, plus rollup
        families — `<name>:fleet_sum` (counters: reset-corrected since
        scraper start; gauges: sum of latest values), `<name>:fleet_max`
        (gauges), and `<name>:fleet` bucket-merged histograms. Parseable
        by this project's own `parse_exposition`."""
        scrapes = self.snapshot()
        by_family: Dict[str, List[Tuple[str, ParsedFamily]]] = {}
        for name, scrape in sorted(scrapes.items()):
            for fam_name, fam in scrape.families.items():
                by_family.setdefault(fam_name, []).append((name, fam))
        lines: List[str] = []
        for fam_name in sorted(by_family):
            rows = by_family[fam_name]
            ftype, fhelp = rows[0][1].type, rows[0][1].help
            lines.append(f"# HELP {fam_name} {fhelp}")
            lines.append(f"# TYPE {fam_name} {ftype}")
            for replica, fam in rows:
                for s in fam.samples:
                    labels = [("replica", replica)] + sorted(
                        s.labels.items()
                    )
                    lines.append(
                        f"{s.name}{{{_render_labels(labels)}}} "
                        f"{_fmt(s.value)}"
                    )
            lines.extend(self._rollup_lines(fam_name, ftype, rows, scrapes))
        lines.extend(self._scrape_meta_lines(scrapes))
        return "\n".join(lines) + "\n"

    def _rollup_lines(self, fam_name: str, ftype: str, rows, scrapes):
        lines: List[str] = []
        if ftype == "counter":
            # per label set, summed across replicas, reset-corrected
            totals: Dict[Tuple, float] = {}
            with self._lock:
                for replica, fam in rows:
                    mono = scrapes[replica].monotonic
                    for s in fam.samples:
                        key = s.key()
                        totals[key] = totals.get(key, 0.0) + mono.get(
                            key, 0.0
                        )
            lines.append(f"# TYPE {fam_name}:fleet_sum counter")
            for (name, labels), v in sorted(totals.items()):
                suffix = f"{{{_render_labels(list(labels))}}}" if labels \
                    else ""
                lines.append(f"{fam_name}:fleet_sum{suffix} {_fmt(v)}")
        elif ftype == "gauge":
            grouped: Dict[Tuple, List[float]] = {}
            for _replica, fam in rows:
                for s in fam.samples:
                    grouped.setdefault(s.key(), []).append(s.value)
            for agg, fn in (("fleet_sum", sum), ("fleet_max", max)):
                lines.append(f"# TYPE {fam_name}:{agg} gauge")
                for (name, labels), vs in sorted(grouped.items()):
                    suffix = f"{{{_render_labels(list(labels))}}}" \
                        if labels else ""
                    lines.append(
                        f"{fam_name}:{agg}{suffix} {_fmt(fn(vs))}"
                    )
        elif ftype == "histogram":
            merged: Dict[Tuple, List[Dict]] = {}
            for _replica, fam in rows:
                for labels_key, point in fam.histogram_series().items():
                    merged.setdefault(labels_key, []).append(point)
            lines.append(f"# TYPE {fam_name}:fleet histogram")
            for labels_key, points in sorted(merged.items()):
                lines.extend(render_histogram_point(
                    f"{fam_name}:fleet",
                    merge_histogram_points(points),
                    labels=_render_labels(list(labels_key)),
                ))
        return lines

    def _scrape_meta_lines(self, scrapes) -> List[str]:
        """Scrape freshness rides the federated body itself, so a
        consumer of /fleet/metrics alone can tell truth from history."""
        lines = [
            "# HELP dalle_fleet_scrape_stale 1 when the replica's "
            "latest scrape failed and its samples are carried history",
            "# TYPE dalle_fleet_scrape_stale gauge",
        ]
        for name, s in sorted(scrapes.items()):
            lines.append(
                f'dalle_fleet_scrape_stale{{replica="{name}"}} '
                f"{int(s.stale)}"
            )
        lines.append("# TYPE dalle_fleet_scrape_generation gauge")
        for name, s in sorted(scrapes.items()):
            lines.append(
                f'dalle_fleet_scrape_generation{{replica="{name}"}} '
                f"{s.generation}"
            )
        return lines


# ------------------------------------------------------------ usage ledger


class UsageLedger:
    """Per-tenant / per-priority usage attribution from the router's own
    request accounting: rows, decoded/resumed tokens (from the replica's
    response `usage` block), and chip-seconds (the replica-side dispatch
    wall clock — one chip per replica; `chips_per_replica` scales a
    sharded fleet). FLOPs are attributed at the scraped ProgramCostTable
    rate (`note_flops_rate`, FLOP/s per chip) current at record time.

    Tenant cardinality is BOUNDED: after `max_tenants` distinct tenants,
    new ones fold into the `__other__` bucket — a metric label fed from
    an unbounded request string would leak label cardinality.
    """

    OTHER = "__other__"
    #: label charset clamp: anything else becomes "_" (tenant strings
    #: come from request bodies; a label value must not explode the
    #: exposition syntax)
    _SAFE = frozenset(
        "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
        "-_.:"
    )

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        max_tenants: int = 32,
        chips_per_replica: int = 1,
    ):
        self.max_tenants = int(max_tenants)
        self.chips_per_replica = int(chips_per_replica)
        self._lock = threading.Lock()
        self._rows: Dict[Tuple[str, str], Dict] = {}
        self._tenants: set = set()
        self._flops_per_s = 0.0
        self._m_chip = None
        if registry is not None:
            self._m_chip = registry.counter_family(
                "dalle_fleet_chip_seconds_total",
                "chip-seconds attributed per tenant and priority class "
                "(replica dispatch wall x chips per replica)",
                label_name="tenant",
            )

    def note_flops_rate(self, flops_per_second: float) -> None:
        """Latest fleet-average FLOP/s per chip from the scraped
        ProgramCostTable rows; converts chip-seconds into est. FLOPs."""
        with self._lock:
            self._flops_per_s = max(0.0, float(flops_per_second))

    def _bounded_tenant(self, tenant: Optional[str]) -> str:
        """Clamp a request-supplied tenant string into the bounded label
        space: sanitized charset, length-capped, folded into `__other__`
        once the tenant map is full."""
        raw = str(tenant) if tenant else "anonymous"
        safe = "".join(
            ch if ch in self._SAFE else "_" for ch in raw[:64]
        ) or "anonymous"
        if safe in self._tenants:
            return safe
        if len(self._tenants) >= self.max_tenants:
            return self.OTHER
        self._tenants.add(safe)
        return safe

    def record(
        self,
        tenant: Optional[str],
        priority: str,
        rows: int,
        wall_s: float,
        decoded_tokens: int = 0,
        resumed_tokens: int = 0,
        replica: Optional[str] = None,
    ) -> None:
        chip_s = max(0.0, float(wall_s)) * self.chips_per_replica
        with self._lock:
            label = self._bounded_tenant(tenant)
            key = (label, str(priority))
            row = self._rows.get(key)
            if row is None:
                row = self._rows[key] = {
                    "requests": 0, "rows": 0, "decoded_tokens": 0,
                    "resumed_tokens": 0, "chip_seconds": 0.0,
                    "est_flops": 0.0,
                }
            row["requests"] += 1
            row["rows"] += int(rows)
            row["decoded_tokens"] += int(decoded_tokens)
            row["resumed_tokens"] += int(resumed_tokens)
            row["chip_seconds"] += chip_s
            row["est_flops"] += chip_s * self._flops_per_s
        if self._m_chip is not None:
            self._m_chip.labels_extra(label, priority=str(priority)).inc(
                chip_s
            )

    def summary(self) -> Dict:
        """The `GET /debug/usage` JSON (and the capacity model's
        useful-work input): per-(tenant, priority) rows plus totals."""
        with self._lock:
            rows = [
                {
                    "tenant": tenant, "priority": priority,
                    "requests": r["requests"], "rows": r["rows"],
                    "decoded_tokens": r["decoded_tokens"],
                    "resumed_tokens": r["resumed_tokens"],
                    "chip_seconds": round(r["chip_seconds"], 4),
                    "est_flops": float(f'{r["est_flops"]:.4g}'),
                }
                for (tenant, priority), r in sorted(self._rows.items())
            ]
            flops_per_s = self._flops_per_s
        return {
            "tenants": rows,
            "distinct_tenants": len({r["tenant"] for r in rows}),
            "max_tenants": self.max_tenants,
            "chips_per_replica": self.chips_per_replica,
            "flops_per_chip_second": flops_per_s,
            "totals": {
                "requests": sum(r["requests"] for r in rows),
                "rows": sum(r["rows"] for r in rows),
                "decoded_tokens": sum(r["decoded_tokens"] for r in rows),
                "resumed_tokens": sum(r["resumed_tokens"] for r in rows),
                "chip_seconds": round(
                    sum(r["chip_seconds"] for r in rows), 4
                ),
            },
        }


# --------------------------------------------------------- capacity model


class CapacityModel:
    """Pure functions over a scrape generation: no sockets, no clocks, no
    state; the block an elastic-capacity controller would consume."""

    #: realistic serving-MFU ceiling for headroom math: decode is
    #: latency-bound and never reaches the matmul roofline, so headroom
    #: against 1.0 would read perpetually idle
    MFU_CEILING = 0.35
    #: mean fresh-replica utilization above which the advisory signal
    #: asks for one more replica / below which it releases one
    UTIL_HIGH = 0.85
    UTIL_LOW = 0.30

    @staticmethod
    def _num(v) -> Optional[float]:
        """Coerce a scraped health field to float, or None — /healthz
        payloads cross a process boundary, so junk must degrade to
        "unknown", never raise out of the scrape loop."""
        try:
            f = float(v)
        except (TypeError, ValueError):
            return None
        return f if f == f else None  # NaN is not a measurement

    @staticmethod
    def replica_assessment(scrape: ReplicaScrape) -> Dict:
        """Per-replica slice: MFU headroom (from the scraped
        `dalle_serving_mfu` gauge family), queue depth, slot
        utilization, and worst SLO burn (from /healthz)."""
        health = scrape.health if isinstance(scrape.health, dict) else {}
        out: Dict = {
            "stale": scrape.stale,
            "generation": scrape.generation,
            "status": health.get("status"),
        }
        mfu_fam = scrape.families.get("dalle_serving_mfu")
        if mfu_fam is not None and mfu_fam.samples:
            mfu = max(s.value for s in mfu_fam.samples)
            headroom = max(0.0, 1.0 - mfu / CapacityModel.MFU_CEILING)
            out["mfu"] = float(f"{mfu:.4g}")
            out["mfu_headroom"] = float(f"{headroom:.4g}")
        num = CapacityModel._num
        queue = num(health.get("queue_depth_rows"))
        slots = num(health.get("slots_active"))
        work = health.get("work") if isinstance(health.get("work"), dict) \
            else {}
        max_batch = num(work.get("max_batch"))
        out["queue_depth_rows"] = queue
        out["slots_active"] = slots
        burn = 0.0
        for slo in health.get("slo") or ():
            if isinstance(slo, dict):
                burn = max(burn, num(slo.get("burn_rate")) or 0.0)
        out["slo_burn"] = burn
        util = None
        if max_batch:
            util = (slots or 0.0) / max_batch
            if queue:
                # a standing queue beyond ~4 batches reads as saturated
                util = max(util, min(1.0, queue / (4.0 * max_batch)))
        elif queue is not None:
            util = min(1.0, queue / 16.0)
        if util is not None:
            out["utilization"] = float(f"{util:.4g}")
        return out

    @staticmethod
    def assess(
        scrapes: Dict[str, ReplicaScrape],
        fleet_decoded_tokens: float = 0.0,
        fleet_resumed_tokens: float = 0.0,
        usage: Optional[Dict] = None,
    ) -> Dict:
        """Fleet capacity/goodput report over the latest generation.

        Goodput: `useful / (useful + waste)` where useful is the decode
        work delivered to completed requests (the usage ledger's decoded
        tokens — each token counted once, resumes excluded) and waste is
        (a) decode work the fleet performed beyond that (re-decoded
        after failover, preempted-then-discarded, shed mid-flight) plus
        (b) warmup decode work estimated from each replica's
        `work.warmup_batches x image_seq_len x max_batch`.
        """
        replicas = {
            name: CapacityModel.replica_assessment(s)
            for name, s in sorted(scrapes.items())
        }
        fresh = [r for r in replicas.values() if not r["stale"]]
        utils = [
            r["utilization"] for r in fresh if r.get("utilization") is not None
        ]
        mean_util = sum(utils) / len(utils) if utils else 0.0
        max_burn = max((r["slo_burn"] for r in fresh), default=0.0)

        num = CapacityModel._num
        warmup_tokens = 0.0
        for s in scrapes.values():
            health = s.health if isinstance(s.health, dict) else {}
            work = health.get("work") if isinstance(health.get("work"),
                                                    dict) else {}
            warmup_tokens += (
                (num(work.get("warmup_batches")) or 0.0)
                * (num(work.get("image_seq_len")) or 0.0)
                * (num(work.get("max_batch")) or 1.0)
            )
        useful = float(
            (usage or {}).get("totals", {}).get("decoded_tokens", 0)
        )
        wasted = max(0.0, fleet_decoded_tokens - useful) + warmup_tokens
        denom = useful + wasted
        goodput = useful / denom if denom > 0 else 1.0

        n = len(scrapes)
        suggested = n
        if n:
            if max_burn > 1.0 or mean_util > CapacityModel.UTIL_HIGH:
                suggested = n + 1
            elif (
                mean_util < CapacityModel.UTIL_LOW
                and max_burn == 0.0
                and n > 1
                and fresh
            ):
                suggested = n - 1
        return {
            "replicas": replicas,
            "fresh_replicas": len(fresh),
            "mean_utilization": float(f"{mean_util:.4g}"),
            "max_slo_burn": float(f"{max_burn:.4g}"),
            "goodput": {
                "useful_tokens": int(useful),
                "fleet_decoded_tokens": int(fleet_decoded_tokens),
                "fleet_resumed_tokens": int(fleet_resumed_tokens),
                "warmup_tokens": int(warmup_tokens),
                "wasted_tokens": int(wasted),
                "fraction": float(f"{goodput:.4g}"),
            },
            "suggested_replicas": suggested,
        }
