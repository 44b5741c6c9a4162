"""Replica fleet router: health-aware routing, failover, hedging, drain.

Counterpart of the JAX package's `serving/router.py` (host code, copied
so the port imports nothing of that package; stdlib HTTP only, no torch:
a router process never touches the card). One admission router in front
of N `ServingServer` replicas, each of which may itself run a tensor-
parallel engine. Its job is to make the fleet survive any one replica
being slow, wedged, restarting or gone without client-visible errors.

Mechanisms, in the order a request meets them:

  * ROUTING POLICY: least-outstanding-rows over the routable replicas,
    healthy before degraded, with QoS spillover (the "low" class uses
    non-degraded replicas only). A 503 + Retry-After cools the replica
    for that priority class for that long; a 429 (tenant quota) passes
    through to the client uncooled.
  * HEALTH STATE MACHINE: active probes of each replica's /healthz drive
    `healthy` / `degraded` / `ejected`. Consecutive probe failures or a
    rolling dispatch error-rate burst eject (the breaker opens); probes
    back off exponentially (capped); a probe success half-opens the
    circuit, and ONE trial request closes it again or re-ejects with a
    doubled backoff.
  * FAILOVER + RETRY BUDGET: a failed or timed-out dispatch re-routes to
    the next candidate. The router pins the seed before the first
    attempt, and decode is (seed, position)-keyed, so a re-dispatched
    request returns the same tokens wherever it lands. Retries draw from
    a budget refilled by a fraction of recent successes, so a full-fleet
    outage drains it and retries cannot amplify the outage.
  * HEDGING: with `--hedge_after_ms`, a dispatch unanswered past the
    threshold gets a duplicate on the next candidate (budget-gated); the
    first usable answer wins.
  * GRACEFUL DRAIN: `POST /admin/drain?replica=NAME` stops admissions to
    the replica, waits out its outstanding rows and marks it `drained`;
    `/admin/undrain` returns it. `?propagate=1` drains / undrains the
    replica's own intake too.
  * POISON QUARANTINE: a replica crash (transport failure) is an incident
    charged to the requests in flight there; a request in `quarantine_after`
    consecutive incidents gets a terminal 422 with the incident ids and
    is refused at ingress after that.
  * DECODE-STATE RESUME: a migrating drain's 409 or a supervisor's spool
    hand-off (`POST /admin/spool`, `serving/supervisor.py`) leaves a
    checkpoint keyed by the request fingerprint (`x-dalle-request-key`);
    the failover re-dispatch carries it as `"resume"`, so the next replica
    restores the finished rows and resumes the others at their journaled
    position. `--migrate_wait_s` lets a transport-failed request park for
    the restarted replica's hand-off.

Observability: the router adopts or mints `x-dalle-trace` at ingress and
parents each dispatch span into it; each dispatch carries `x-dalle-route`
(`replica;attempt;hedged`) and `x-dalle-request-key`, which the replica
writes into its request log line. It exports the `dalle_router_*`
families, serves its own /healthz (503 only when no replica is routable),
`GET /debug/replicas`, `/debug/usage` (`obs/fleetmetrics.UsageLedger`)
and, with the fleet scraper on, `/fleet/metrics` and `/debug/fleet`
(`obs/fleetmetrics.FleetScraper`).

Run it: `python -m dalle_pytorch_tpu_torch.serving.router --replicas
http://h1:8000,http://h2:8000 --port 8100` (or `python -m
dalle_pytorch_tpu_torch.serve --router --replicas ...`). The `_post` /
`_probe` seams are the only socket touches, and the state machine runs
off an injectable clock. `--trace_export URL` attaches an
`obs/aggregate.TraceExporter` to the router's tracer, so its dispatch
spans join the replicas' in the fleet collector (`obs/collector.py`).
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import queue as queue_mod
import re
import socket
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlsplit

from dalle_pytorch_tpu_torch.obs.aggregate import (
    TRACE_HEADER,
    default_site,
    format_trace_header,
    parse_trace_header,
    sanitize_site,
    span_uid_for,
)
from dalle_pytorch_tpu_torch.obs.tracing import Tracer
from dalle_pytorch_tpu_torch.serving.qos import PRIORITY_CLASSES, priority_class
from dalle_pytorch_tpu_torch.serving.streaming import (
    KEEPALIVE,
    SSEParser,
    encode_sse,
)

#: routing-decision header the router stamps on every forwarded dispatch;
#: replicas parse it into their request log lines so a fleet log join can
#: attribute every attempt
ROUTE_HEADER = "x-dalle-route"

#: content-identity header the router stamps on every forwarded dispatch:
#: the request fingerprint (quarantine key). Replicas key their
#: crash-spool checkpoints on it, so the supervisor's spool hand-off
#: joins back to the exact in-flight requests the crash interrupted —
#: and log lines across the fleet share one content join key.
REQUEST_KEY_HEADER = "x-dalle-request-key"

_ROUTE_RE = re.compile(r"^([A-Za-z0-9_.\-]{1,64});(\d{1,4});([01])$")

_REQUEST_KEY_RE = re.compile(r"^[A-Za-z0-9_.\-]{1,64}$")


def parse_request_key(value) -> Optional[str]:
    """Strict/total parse of an inbound `x-dalle-request-key` header;
    None for anything malformed (the key lands in spool files and log
    lines, and garbage must not)."""
    if not value or not isinstance(value, str):
        return None
    value = value.strip()
    return value if _REQUEST_KEY_RE.match(value) else None

MAX_BODY_BYTES = 1 << 20

#: numeric encoding of replica state for the state gauge family
STATE_VALUES = {
    "healthy": 0.0,
    "degraded": 1.0,
    "half_open": 2.0,
    "draining": 3.0,
    "drained": 4.0,
    "ejected": 5.0,
}


def format_route_header(replica: str, attempt: int, hedged: bool) -> str:
    """`x-dalle-route` value for one dispatch: `replica;attempt;hedged`.
    The replica name goes through the same clamp as trace sites so the
    strict parser on the other side always round-trips it."""
    return f"{sanitize_site(replica)};{int(attempt)};{1 if hedged else 0}"


def parse_route_header(value) -> Optional[Dict]:
    """Strict/total parse of an inbound `x-dalle-route` header into
    `{"replica", "attempt", "hedged"}`; None for anything malformed —
    the fields land in request log lines, and garbage must not."""
    if not value or not isinstance(value, str):
        return None
    m = _ROUTE_RE.match(value.strip())
    if not m:
        return None
    return {
        "replica": m.group(1),
        "attempt": int(m.group(2)),
        "hedged": m.group(3) == "1",
    }


def request_fingerprint(body: Dict) -> str:
    """Content identity of one /generate body for quarantine tracking.
    Excludes `timeout_s` (client patience is not content) and `resume`
    (a decode-state checkpoint is transport state — a migrated re-
    dispatch is THE SAME request and must keep its key), and is
    computed BEFORE the router pins a seed, so a seedless client
    re-sending the same poison prompt maps to the same key even though
    each submission would have drawn a fresh seed."""
    import hashlib

    essence = {
        k: v for k, v in body.items() if k not in ("timeout_s", "resume")
    }
    return hashlib.sha256(
        json.dumps(essence, sort_keys=True, default=str).encode()
    ).hexdigest()[:24]


class CheckpointRegistry:
    """Bounded store of decode-state checkpoints keyed by request
    fingerprint — the crash-recovery half of migration. Filled by the
    supervisor's spool hand-off (`POST /admin/spool`) and by migrating
    drains; consumed (at most once) by the failover path, which attaches
    the checkpoint to the re-dispatch so the resuming replica restores
    completed rows instead of re-decoding the whole request. Waiters
    (`wait_for`) park a transport-failed request briefly for the
    restarted replica's spool to arrive."""

    def __init__(self, capacity: int = 256):
        from collections import OrderedDict

        assert capacity >= 1
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._entries: "OrderedDict[str, Dict]" = OrderedDict()
        self.ingested = 0
        self.consumed = 0

    def put(self, key: str, wire: str, source: Optional[str] = None) -> None:
        with self._cond:
            self._entries[key] = {
                "wire": wire, "source": source, "at": time.time(),
            }
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
            self.ingested += 1
            self._cond.notify_all()

    def take(self, key: str) -> Optional[Dict]:
        """Consume the checkpoint for `key` (at most one resume per
        beacon — a second failover starts clean rather than resuming a
        snapshot the first resume already advanced past)."""
        with self._cond:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self.consumed += 1
            return entry

    def wait_for(self, key: str, timeout_s: float) -> Optional[Dict]:
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        with self._cond:
            while True:
                entry = self._entries.pop(key, None)
                if entry is not None:
                    self.consumed += 1
                    return entry
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(timeout=min(remaining, 0.25))

    def discard(self, key: str) -> None:
        with self._cond:
            self._entries.pop(key, None)

    def detail(self) -> Dict:
        with self._lock:
            return {
                "keys": len(self._entries),
                "capacity": self.capacity,
                "ingested": self.ingested,
                "consumed": self.consumed,
            }


class QuarantineTracker:
    """Consecutive-incident accounting per request fingerprint.

    `implicate(key, incident)` charges every request in flight during
    one incident; `absolve(key)` (called on any successful completion)
    resets the streak — so an innocent request that merely shared a
    replica with a poison one is cleared by its own failover success,
    while the poison request's streak only grows. At `after` consecutive
    implications the key is quarantined.

    ONE replica death is ONE incident: transport failures against the
    same replica within `coalesce_window_s` share an incident id (N
    in-flight dispatch threads all report the same severed box), and a
    key is charged at most once per incident — a bystander must not
    reach the threshold off a single crash reported twice (once as a
    bystander, once by its own failed dispatch). Bounded LRU over
    `capacity` keys; incident metadata rides in a bounded ring for
    /debug.
    """

    def __init__(self, after: int = 3, capacity: int = 1024,
                 coalesce_window_s: float = 5.0, ttl_s: float = 600.0,
                 time_fn=time.monotonic):
        assert after >= 1 and capacity >= 1 and ttl_s > 0
        self.after = int(after)
        self.capacity = int(capacity)
        self.coalesce_window_s = float(coalesce_window_s)
        #: implication streaks EXPIRE: quarantine is protection, not a
        #: permanent blocklist. Without a TTL, a fleet-wide transport
        #: blip that walks one request across `after` dead replicas
        #: would brick its fingerprint forever (quarantined keys are
        #: refused at ingress, so the absolve-on-success path can never
        #: run for them). A true replica-killer re-trips within one
        #: failover walk anyway.
        self.ttl_s = float(ttl_s)
        self._now = time_fn
        self._lock = threading.Lock()
        #: key -> {"count": consecutive implications, "incidents": [ids]}
        #: — insertion/refresh ordered, so eviction drops the key with
        #: the OLDEST most-recent implication (absolve just pops; a
        #: side ordering structure would go stale on absolve and evict
        #: live marks)
        from collections import OrderedDict

        self._marks: "OrderedDict" = OrderedDict()
        self._incident_seq = 0
        #: replica -> (incident id, minted at) for coalescing
        self._last_by_replica: Dict[str, Tuple[str, float]] = {}
        self.incidents: deque = deque(maxlen=64)
        self.quarantined_keys = 0

    def mint_incident(self, replica: str, error: str, keys) -> str:
        """New incident id — or the open one for `replica` when its last
        death is younger than the coalesce window."""
        now = self._now()
        with self._lock:
            last = self._last_by_replica.get(replica)
            if last is not None and now - last[1] <= self.coalesce_window_s:
                return last[0]
            self._incident_seq += 1
            inc_id = f"inc-{self._incident_seq:06d}"
            self._last_by_replica[replica] = (inc_id, now)
            self.incidents.append({
                "id": inc_id,
                "replica": replica,
                "error": error,
                "implicated": len(list(keys)),
                "ts": time.time(),
            })
            return inc_id

    def implicate(self, key: str, incident_id: str) -> int:
        """Charge one key with one incident (idempotent per incident);
        returns its consecutive implication count."""
        now = self._now()
        with self._lock:
            mark = self._marks.get(key)
            if mark is not None and now - mark["last_at"] > self.ttl_s:
                self._marks.pop(key)
                mark = None  # expired streak: start fresh
            if mark is None:
                mark = {"count": 0, "incidents": [], "last_at": now}
                self._marks[key] = mark
                while len(self._marks) > self.capacity:
                    # evict the oldest NON-quarantined mark (never the
                    # key being charged right now): a quarantined key is
                    # refused at ingress, so it never refreshes its
                    # position — plain LRU would let churn silently
                    # forget a replica-killer. Only when every OTHER
                    # tracked key is quarantined does the oldest of
                    # those go (bounded memory wins).
                    victim = next(
                        (
                            k for k, m in self._marks.items()
                            if k != key and m["count"] < self.after
                        ),
                        next(k for k in self._marks if k != key),
                    )
                    self._marks.pop(victim)
            else:
                # freshly implicated keys are the ones worth keeping
                self._marks.move_to_end(key)
            mark["last_at"] = now
            if incident_id in mark["incidents"]:
                return mark["count"]
            mark["count"] += 1
            mark["incidents"].append(incident_id)
            if mark["count"] == self.after:
                self.quarantined_keys += 1
            return mark["count"]

    def absolve(self, key: str) -> None:
        """A success ends the streak: the request demonstrably does not
        kill replicas (it was a bystander)."""
        with self._lock:
            self._marks.pop(key, None)

    def is_quarantined(self, key: str) -> bool:
        with self._lock:
            mark = self._marks.get(key)
            if mark is None:
                return False
            if self._now() - mark["last_at"] > self.ttl_s:
                self._marks.pop(key)  # expired: the quarantine lifts
                return False
            return mark["count"] >= self.after

    def incidents_for(self, key: str) -> List[str]:
        with self._lock:
            mark = self._marks.get(key)
            return list(mark["incidents"]) if mark else []

    def detail(self) -> Dict:
        now = self._now()
        with self._lock:
            live = {
                k: m for k, m in self._marks.items()
                if now - m["last_at"] <= self.ttl_s
            }
            quarantined = {
                k: list(m["incidents"])
                for k, m in live.items()
                if m["count"] >= self.after
            }
            return {
                "after": self.after,
                "ttl_s": self.ttl_s,
                "tracked_keys": len(live),
                "quarantined": quarantined,
                "quarantined_total": self.quarantined_keys,
                "recent_incidents": list(self.incidents),
            }


class RetryBudget:
    """Token-bucket retry budget that refills on SUCCESS, not on time.

    `deposit()` is called once per successful dispatch and adds `ratio`
    tokens (capped); `withdraw()` spends one token per retry/hedge and
    returns False when the bucket is empty. The refill-on-success shape
    is the anti-amplification property the chaos tests pin: during a
    full-fleet outage nothing succeeds, the bucket drains to zero, and
    every further request costs exactly ONE attempt — a fleet of
    retrying routers cannot DDoS its own recovering replicas. `initial`
    seeds the bucket so cold-start failover works before the first
    success.
    """

    def __init__(self, ratio: float = 0.2, initial: float = 10.0,
                 cap: float = 100.0):
        assert ratio >= 0 and initial >= 0 and cap >= initial
        self.ratio = float(ratio)
        self.cap = float(cap)
        self._balance = float(initial)
        self._lock = threading.Lock()
        self.withdrawn = 0
        self.denied = 0

    @property
    def balance(self) -> float:
        with self._lock:
            return self._balance

    def deposit(self) -> None:
        with self._lock:
            self._balance = min(self.cap, self._balance + self.ratio)

    def withdraw(self) -> bool:
        with self._lock:
            if self._balance < 1.0:
                self.denied += 1
                return False
            self._balance -= 1.0
            self.withdrawn += 1
            return True


class Replica:
    """Per-replica routing state. All mutation happens under the
    router's lock; the dispatch threads only touch it through the
    router's helpers."""

    def __init__(self, name: str, url: str, now: float):
        self.name = name
        self.url = url.rstrip("/")
        parts = urlsplit(self.url)
        assert parts.scheme in ("http", ""), (
            f"replica {name}: only http:// URLs are supported, got {url!r}"
        )
        assert parts.hostname, f"replica {name}: no host in {url!r}"
        self.host = parts.hostname
        self.port = parts.port or 80
        #: admin-controlled lifecycle: active | draining | drained
        self.mode = "active"
        #: probe/breaker-controlled health: healthy | degraded |
        #: half_open | ejected
        self.health = "healthy"
        self.outstanding_rows = 0
        self.inflight = 0
        self.probe_failures = 0
        self.next_probe_at = now
        self.probe_backoff_s = 0.0
        #: consecutive circuit opens — drives the capped exponential
        #: backoff (reset when a trial closes the circuit)
        self.open_count = 0
        #: rolling (ts, ok) dispatch outcomes for the error-rate breaker
        self.window: deque = deque()
        #: priority class index -> monotonic ts until which this replica
        #: is cooled for that class (its own Retry-After, obeyed)
        self.cooldowns: Dict[int, float] = {}
        self.trial_inflight = False
        self.last_error: Optional[str] = None
        self.ejected_reason: Optional[str] = None
        self.requests = 0
        self.failures = 0
        #: request fingerprints currently dispatched here (key -> count)
        #: — the attribution set a crash incident implicates
        self.inflight_keys: Dict[str, int] = {}
        #: bounded LRU of fingerprints recently dispatched here — the
        #: "prefix cache plausibly holds this prompt" signal migration
        #: re-dispatch uses to prefer a cache-warm replica
        from collections import OrderedDict

        self.seen_keys: "OrderedDict[str, float]" = OrderedDict()
        #: requests this replica completed from a migrated resume
        self.resumes = 0
        # ---- restart/crash attribution (supervised-restart visibility):
        #: completed down->up cycles (ejected, then a successful trial)
        self.restarts = 0
        #: when the current outage began (None while up)
        self.down_at: Optional[float] = None
        #: why the most recent outage began ("<reason>: <last_error>")
        self.last_down_reason: Optional[str] = None
        #: ejection-to-recovered wall seconds of the most recent restart
        self.last_rejoin_s: Optional[float] = None

    def state(self) -> str:
        """Single display state: admin mode wins over health."""
        if self.mode != "active":
            return self.mode
        return self.health

    def error_rate(self) -> Tuple[int, float]:
        n = len(self.window)
        if not n:
            return 0, 0.0
        fails = sum(1 for _, ok in self.window if not ok)
        return n, fails / n

    def detail(self, now: float) -> Dict:
        n, rate = self.error_rate()
        return {
            "name": self.name,
            "url": self.url,
            "state": self.state(),
            "mode": self.mode,
            "health": self.health,
            "outstanding_rows": self.outstanding_rows,
            "inflight": self.inflight,
            "requests": self.requests,
            "failures": self.failures,
            "error_window": {"samples": n, "error_rate": round(rate, 3)},
            "probe_failures": self.probe_failures,
            "probe_backoff_s": round(self.probe_backoff_s, 3),
            "next_probe_in_s": round(max(0.0, self.next_probe_at - now), 3),
            "open_count": self.open_count,
            "cooldowns_s": {
                PRIORITY_CLASSES[k]: round(max(0.0, until - now), 3)
                for k, until in self.cooldowns.items()
                if until > now
            },
            "ejected_reason": self.ejected_reason,
            "last_error": self.last_error,
            "restarts": self.restarts,
            "down_for_s": (
                round(now - self.down_at, 3)
                if self.down_at is not None else None
            ),
            "last_down_reason": self.last_down_reason,
            "last_rejoin_s": (
                round(self.last_rejoin_s, 3)
                if self.last_rejoin_s is not None else None
            ),
            "resumes": self.resumes,
        }


class FleetRouter:
    """Routing policy core: replica set, health state machine, failover
    loop. HTTP-free except for the `_post`/`_probe` seams, and clocked by
    the injectable `time_fn` so tests drive probes/backoff/cooldowns
    deterministically while exercising real sockets."""

    def __init__(
        self,
        replicas: Sequence[str],
        registry=None,
        tracer: Optional[Tracer] = None,
        log=None,
        exporter=None,
        site: Optional[str] = None,
        request_timeout_s: float = 120.0,
        attempt_timeout_s: float = 30.0,
        hedge_after_ms: Optional[float] = None,
        probe_interval_s: float = 1.0,
        probe_timeout_s: float = 2.0,
        eject_after_probe_failures: int = 3,
        error_window_s: float = 30.0,
        error_rate_threshold: float = 0.5,
        error_min_samples: int = 4,
        probe_backoff_s: float = 1.0,
        probe_backoff_max_s: float = 30.0,
        retry_budget_ratio: float = 0.2,
        retry_budget_initial: float = 10.0,
        quarantine_after: int = 3,
        migrate_wait_s: float = 0.0,
        time_fn=time.monotonic,
    ):
        assert replicas, "router needs at least one replica URL"
        self._now = time_fn
        now = self._now()
        self.replicas: List[Replica] = []
        seen = set()
        for i, spec in enumerate(replicas):
            name, sep, url = str(spec).partition("=")
            if not sep:  # bare URL: derive a stable name from host:port
                url = str(spec)
                parts = urlsplit(url)
                name = f"{parts.hostname}-{parts.port or 80}"
            name = sanitize_site(name)
            while name in seen:  # two replicas on one host:port — suffix
                name = f"{name}-{i}"
            seen.add(name)
            self.replicas.append(Replica(name, url, now))
        self.request_timeout_s = float(request_timeout_s)
        self.attempt_timeout_s = float(attempt_timeout_s)
        self.hedge_after_s = (
            None if hedge_after_ms is None else float(hedge_after_ms) / 1e3
        )
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.eject_after_probe_failures = int(eject_after_probe_failures)
        self.error_window_s = float(error_window_s)
        self.error_rate_threshold = float(error_rate_threshold)
        self.error_min_samples = int(error_min_samples)
        self.probe_backoff_base_s = float(probe_backoff_s)
        self.probe_backoff_max_s = float(probe_backoff_max_s)
        self.budget = RetryBudget(
            ratio=retry_budget_ratio, initial=retry_budget_initial
        )
        # poison-request quarantine (0 disables): consecutive crash
        # implications before a request fingerprint is refused outright
        # (tracker shares the injectable clock so chaos tests drive the
        # incident-coalescing window deterministically)
        self.quarantine = (
            QuarantineTracker(after=int(quarantine_after), time_fn=time_fn)
            if int(quarantine_after) > 0 else None
        )
        # decode-state migration (serving/migrate.py): spooled/drained
        # checkpoints keyed by request fingerprint; a transport-failed
        # request may park up to `migrate_wait_s` for the restarted
        # replica's spool hand-off before falling back to a from-scratch
        # re-dispatch (0 = never park: instant failover, crash resumes
        # only when the spool already arrived)
        self.checkpoints = CheckpointRegistry()
        self.migrate_wait_s = float(migrate_wait_s)
        # identity for span UIDs and log lines, through the site clamp so the
        # router's parent_uid round-trips the header codec
        self.site = sanitize_site(site) if site else default_site()
        self.host = sanitize_site(socket.gethostname() or "localhost")
        self.pid = os.getpid()
        self.tracer = tracer if tracer is not None else Tracer(max_traces=128)
        self.exporter = exporter
        if exporter is not None:
            exporter.attach(self.tracer)
        self.log = log
        self._lock = threading.Lock()
        self._drained = threading.Condition(self._lock)
        self._seed_lock = threading.Lock()
        self._seed_counter = int(time.time()) & 0x7FFFFFFF
        self._probe_thread: Optional[threading.Thread] = None
        self._probe_stop = threading.Event()
        self._started_at = time.time()

        if registry is None:
            from dalle_pytorch_tpu_torch.training.metrics import MetricsRegistry

            registry = MetricsRegistry()
        self.registry = registry
        self._m_state = registry.gauge_family(
            "dalle_router_replica_state",
            "per-replica routing state (0 healthy, 1 degraded, 2 "
            "half-open, 3 draining, 4 drained, 5 ejected)",
            label_name="replica",
        )
        self._m_outstanding = registry.gauge_family(
            "dalle_router_outstanding_rows",
            "request rows currently dispatched to each replica",
            label_name="replica",
        )
        self._m_requests = registry.counter_family(
            "dalle_router_requests_total",
            "dispatch attempts per replica (including retries and hedges)",
            label_name="replica",
        )
        self._m_failovers = registry.counter_family(
            "dalle_router_failovers_total",
            "dispatches re-routed to another replica, by failure reason "
            "(transport: connect/timeout/reset; status: replica 5xx; "
            "backpressure: replica 429/503 — cooled, not broken)",
            label_name="reason",
        )
        self._m_hedges = registry.counter(
            "dalle_router_hedges_total",
            "duplicate dispatches launched for the latency tail "
            "(--hedge_after_ms; first usable answer wins)",
        )
        self._m_hedge_wins = registry.counter(
            "dalle_router_hedge_wins_total",
            "hedged duplicates that answered before the primary",
        )
        self._m_ejections = registry.counter_family(
            "dalle_router_ejections_total",
            "replicas ejected from rotation, by reason (probe: "
            "consecutive health-probe failures; error_rate: dispatch "
            "error-rate burst opened the circuit; trial: the half-open "
            "trial request failed)",
            label_name="reason",
        )
        self._m_probes = registry.counter_family(
            "dalle_router_probes_total",
            "health probes by result",
            label_name="result",
        )
        self._m_budget = registry.gauge(
            "dalle_router_retry_budget",
            "retry-budget tokens available (refills on success; empty "
            "during an outage, so retries cannot amplify it)",
        )
        self._m_budget.set(self.budget.balance)
        self._m_unroutable = registry.counter(
            "dalle_router_unroutable_total",
            "requests refused because no replica was routable for their "
            "class (all ejected/draining/cooling)",
        )
        self._m_quarantined = registry.counter(
            "dalle_router_quarantined_total",
            "requests refused as poison: implicated in K consecutive "
            "replica crash incidents (terminal 422 with incident ids "
            "instead of endless failover)",
        )
        self._m_migrations = registry.counter_family(
            "dalle_router_migrations_total",
            "in-flight requests re-dispatched with a decode-state "
            "checkpoint, by source (drain: a migrating drain's 409 "
            "carried it; crash: the restarted replica's spool hand-off)",
            label_name="reason",
        )
        self._m_spool_ingested = registry.counter(
            "dalle_router_spool_checkpoints_total",
            "checkpoints ingested from replica spool hand-offs "
            "(POST /admin/spool)",
        )
        # per-tenant / per-priority usage accounting: every successful
        # dispatch records its replica wall + token usage here; the
        # fleet scraper joins in ProgramCostTable FLOP rates and
        # GET /debug/usage reads it back
        from dalle_pytorch_tpu_torch.obs.fleetmetrics import UsageLedger

        self.usage = UsageLedger(registry=registry)
        for rep in self.replicas:
            self._m_state.labels(rep.name).set(STATE_VALUES[rep.state()])
            self._m_outstanding.labels(rep.name).set(0)

    # ------------------------------------------------------------ identity

    def _span_uid(self, span) -> str:
        # the shared identity format (aggregate.span_uid_for): router
        # dispatch spans must join in the collector exactly like
        # exporter-shipped ones
        return span_uid_for(self.site, self.host, self.pid, span.span_id)

    def next_seed(self, n: int) -> int:
        """Pin a seed BEFORE the first dispatch for requests that didn't
        send one: every retry/hedge forwards the identical payload, so
        duplicated execution returns bit-identical tokens."""
        with self._seed_lock:
            s = self._seed_counter
            self._seed_counter = (self._seed_counter + n) & 0x7FFFFFFF
            return s

    # ------------------------------------------------------- state machine

    def _set_state_gauge(self, rep: Replica) -> None:
        self._m_state.labels(rep.name).set(
            STATE_VALUES.get(rep.state(), 5.0)
        )

    def _eject(self, rep: Replica, reason: str, now: float) -> None:
        """Caller holds the lock. closed→open edge of the breaker."""
        rep.health = "ejected"
        rep.ejected_reason = reason
        if rep.down_at is None:
            # outage start (repeat ejections while flapping keep the
            # ORIGINAL down timestamp — time-to-rejoin measures the
            # whole outage, not the last flap)
            rep.down_at = now
            rep.last_down_reason = (
                f"{reason}: {rep.last_error}" if rep.last_error else reason
            )
        rep.trial_inflight = False
        rep.open_count += 1
        rep.window.clear()
        rep.probe_backoff_s = min(
            self.probe_backoff_base_s * (2 ** (rep.open_count - 1)),
            self.probe_backoff_max_s,
        )
        rep.next_probe_at = now + rep.probe_backoff_s
        self._m_ejections.labels(reason).inc()
        self._set_state_gauge(rep)
        if self.log is not None:
            self.log.event(
                "replica_ejected", replica=rep.name, reason=reason,
                probe_backoff_s=round(rep.probe_backoff_s, 3),
                last_error=rep.last_error,
            )

    def _record_dispatch(self, rep: Replica, ok: bool) -> None:
        """Feed one live-dispatch outcome into the breaker."""
        now = self._now()
        with self._lock:
            rep.requests += 1
            if not ok:
                rep.failures += 1
            if rep.health == "half_open":
                # the one trial request decides the circuit
                rep.trial_inflight = False
                if ok:
                    rep.health = "healthy"
                    rep.open_count = 0
                    rep.probe_failures = 0
                    rep.probe_backoff_s = 0.0
                    rep.ejected_reason = None
                    rep.window.clear()
                    if rep.down_at is not None:
                        # restart attribution: one completed down->up
                        # cycle, measured from the ejection that began
                        # the outage to THIS closing trial
                        rep.restarts += 1
                        rep.last_rejoin_s = now - rep.down_at
                        rep.down_at = None
                    self._set_state_gauge(rep)
                    if self.log is not None:
                        self.log.event(
                            "replica_recovered", replica=rep.name,
                            restarts=rep.restarts,
                            rejoin_s=(
                                round(rep.last_rejoin_s, 3)
                                if rep.last_rejoin_s is not None else None
                            ),
                            down_reason=rep.last_down_reason,
                        )
                else:
                    self._eject(rep, "trial", now)
                return
            rep.window.append((now, ok))
            while rep.window and now - rep.window[0][0] > self.error_window_s:
                rep.window.popleft()
            if not ok and rep.health != "ejected":
                n, rate = rep.error_rate()
                if (
                    n >= self.error_min_samples
                    and rate >= self.error_rate_threshold
                ):
                    self._eject(rep, "error_rate", now)

    def _cool(self, rep: Replica, klass: int, retry_after_s: float) -> None:
        """Obey a replica's own Retry-After for one priority class."""
        until = self._now() + max(0.0, float(retry_after_s))
        with self._lock:
            rep.cooldowns[klass] = max(rep.cooldowns.get(klass, 0.0), until)

    # -------------------------------------------------------------- probes

    def _probe(self, rep: Replica) -> Tuple[int, Dict]:
        """The one probe socket touch (stubbed in tests): GET /healthz.
        Returns (status, parsed detail); raises on transport failure."""
        req = urllib.request.Request(rep.url + "/healthz", method="GET")
        try:
            with urllib.request.urlopen(
                req, timeout=self.probe_timeout_s
            ) as resp:
                return resp.status, json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as exc:  # 503 is an answer, not
            return exc.code, {}  # a transport failure

    def _probe_one(self, rep: Replica, now: float) -> None:
        try:
            status, detail = self._probe(rep)
        except Exception as exc:
            self._on_probe(rep, None, {}, now, error=exc)
        else:
            self._on_probe(rep, status, detail, now)

    def probe_once(self, now: Optional[float] = None) -> None:
        """One probe sweep over every due replica — the probe thread's
        body, callable directly (tests drive it with a stubbed clock).
        Due replicas are probed CONCURRENTLY: sweep time is the max of
        the probe latencies, not the sum, so one dark replica's connect
        timeout cannot delay failure detection on the others."""
        now = self._now() if now is None else now
        due = []
        with self._lock:
            for rep in self.replicas:
                if now >= rep.next_probe_at and rep.mode == "active":
                    due.append(rep)
        if not due:
            return
        if len(due) == 1:
            self._probe_one(due[0], now)
            return
        threads = [
            threading.Thread(
                target=self._probe_one, args=(rep, now),
                name="dalle-router-probe-one", daemon=True,
            )
            for rep in due
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.probe_timeout_s + 5.0)

    def _on_probe(self, rep: Replica, status: Optional[int], detail: Dict,
                  now: float, error: Optional[BaseException] = None) -> None:
        ok = status == 200
        self._m_probes.labels("ok" if ok else "fail").inc()
        with self._lock:
            if ok:
                rep.probe_failures = 0
                tier = (detail or {}).get("status", "ok")
                if rep.health == "ejected":
                    # open→half-open: admit ONE trial request; live
                    # traffic (not the probe) closes the circuit
                    rep.health = "half_open"
                    rep.trial_inflight = False
                elif rep.health != "half_open":
                    rep.health = (
                        "degraded" if tier == "degraded" else "healthy"
                    )
                rep.next_probe_at = now + self.probe_interval_s
            else:
                rep.last_error = (
                    repr(error) if error is not None else f"healthz {status}"
                )
                rep.probe_failures += 1
                if rep.health == "ejected":
                    # stay open; keep backing off (capped)
                    rep.probe_backoff_s = min(
                        max(
                            rep.probe_backoff_s * 2,
                            self.probe_backoff_base_s,
                        ),
                        self.probe_backoff_max_s,
                    )
                    rep.next_probe_at = now + rep.probe_backoff_s
                elif rep.probe_failures >= self.eject_after_probe_failures:
                    self._eject(rep, "probe", now)
                else:
                    rep.next_probe_at = now + self.probe_interval_s
            self._set_state_gauge(rep)

    def start_probes(self) -> "FleetRouter":
        if self._probe_thread is None:
            self._probe_stop.clear()
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="dalle-router-probe",
                daemon=True,
            )
            self._probe_thread.start()
        return self

    def _probe_loop(self) -> None:
        while not self._probe_stop.is_set():
            try:
                self.probe_once()
            except Exception as exc:  # the probe thread must never die;
                if self.log is not None:  # next tick retries — the stop
                    self.log.event(  # wait below is its backoff
                        "probe_sweep_error", error=repr(exc)
                    )
            self._probe_stop.wait(self.probe_interval_s)

    def stop_probes(self) -> None:
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=self.probe_timeout_s + 5.0)
            self._probe_thread = None

    # ----------------------------------------------------------- selection

    def _routable(self, klass: int, exclude) -> List[Replica]:
        """Candidate replicas for one attempt, best-first: healthy before
        degraded/half-open (deprioritized, not excluded — except for the
        low class, which may not touch a degraded replica at all), then
        least outstanding rows, then name for determinism."""
        now = self._now()
        out = []
        with self._lock:
            for rep in self.replicas:
                if rep.name in exclude or rep.mode != "active":
                    continue
                if rep.health == "ejected":
                    continue
                if rep.health == "half_open" and rep.trial_inflight:
                    continue
                if (
                    rep.health == "degraded"
                    and klass >= priority_class("low")
                ):
                    continue
                if rep.cooldowns.get(klass, 0.0) > now:
                    continue
                out.append(rep)
            # half_open ranks WITH healthy: the circuit only closes when
            # the trial request runs, and trial_inflight already caps a
            # recovering replica at one live request — deprioritizing it
            # below healthy would starve the trial forever on a fleet
            # with any healthy capacity
            out.sort(key=lambda r: (
                0 if r.health in ("healthy", "half_open") else 1,
                r.outstanding_rows,
                r.requests,  # tie-break: an idle fleet round-robins
                r.name,  # instead of pinning the first name
            ))
        return out

    def _prefer_cache_warm(self, cands: List[Replica],
                           key: str) -> List[Replica]:
        """Stable re-rank of one attempt's candidates: replicas that
        recently dispatched this fingerprint first — their prefix cache
        plausibly still holds the prompt, so a migrated resume's
        re-prefill is a near-zero-cost cache hit. Health/occupancy order
        is preserved within each partition (this is a tiebreak, not an
        override)."""
        with self._lock:
            warm = [r for r in cands if key in r.seen_keys]
        if not warm:
            return cands
        warm_set = set(id(r) for r in warm)
        return warm + [r for r in cands if id(r) not in warm_set]

    def ingest_spool(self, replica: Optional[str],
                     checkpoints: Dict[str, str]) -> int:
        """POST /admin/spool: a restarted replica's crash-beacon journal,
        handed over by its supervisor. Each entry lands in the checkpoint
        registry keyed by request fingerprint; in-flight failovers (and
        parked `migrate_wait_s` waiters) pick them up."""
        n = 0
        for key, wire in checkpoints.items():
            key = parse_request_key(key)
            if key is None or not isinstance(wire, str):
                continue
            self.checkpoints.put(key, wire, source=replica)
            n += 1
        if n:
            self._m_spool_ingested.inc(n)
            if self.log is not None:
                self.log.event(
                    "spool_ingested", replica=replica, checkpoints=n,
                )
        return n

    def _retry_after_s(self, klass: int) -> float:
        """Retry-After for an unroutable request: the soonest a replica
        could return (cooldown expiry or next probe), clamped to [1, 30]."""
        now = self._now()
        etas = []
        with self._lock:
            for rep in self.replicas:
                if rep.mode != "active":
                    continue
                if rep.health == "ejected":
                    etas.append(rep.next_probe_at - now)
                else:
                    etas.append(rep.cooldowns.get(klass, now) - now)
        eta = min((e for e in etas if e > 0), default=1.0)
        return min(max(1.0, eta), 30.0)

    # ------------------------------------------------------------ dispatch

    def _claim(self, cands: List[Replica]) -> Tuple[
        Optional[Replica], List[Replica]
    ]:
        """Atomically pick the primary from an ordered candidate list.
        A half-open replica is claimed as THE trial under the same lock
        that read `trial_inflight` (closing the select-then-dispatch
        race that would send a burst of live traffic at a still-sick
        replica); the hedge pool excludes half-open replicas entirely —
        a duplicate dispatch is load, not a trial."""
        with self._lock:
            for i, rep in enumerate(cands):
                if rep.health == "half_open":
                    if rep.trial_inflight:
                        continue  # lost the claim race: not a candidate
                    rep.trial_inflight = True
                return rep, [
                    r for r in cands[i + 1:] if r.health != "half_open"
                ]
        return None, []

    def _begin_attempt(self, rep: Replica, rows: int,
                       key: Optional[str] = None) -> None:
        with self._lock:
            rep.outstanding_rows += rows
            rep.inflight += 1
            if key is not None:
                rep.inflight_keys[key] = rep.inflight_keys.get(key, 0) + 1
                # affinity memory: this replica's prefix cache plausibly
                # holds this prompt now (bounded LRU; migration
                # re-dispatch prefers cache-warm replicas)
                rep.seen_keys[key] = self._now()
                rep.seen_keys.move_to_end(key)
                while len(rep.seen_keys) > 512:
                    rep.seen_keys.popitem(last=False)
            self._m_outstanding.labels(rep.name).set(rep.outstanding_rows)
        self._m_requests.labels(rep.name).inc()

    def _end_attempt(self, rep: Replica, rows: int,
                     key: Optional[str] = None) -> None:
        with self._lock:
            rep.outstanding_rows = max(0, rep.outstanding_rows - rows)
            rep.inflight = max(0, rep.inflight - 1)
            if key is not None:
                n = rep.inflight_keys.get(key, 0) - 1
                if n <= 0:
                    rep.inflight_keys.pop(key, None)
                else:
                    rep.inflight_keys[key] = n
            self._m_outstanding.labels(rep.name).set(rep.outstanding_rows)
            if rep.mode == "draining" and rep.outstanding_rows == 0:
                rep.mode = "drained"
                self._set_state_gauge(rep)
                self._drained.notify_all()
                if self.log is not None:
                    self.log.event("replica_drained", replica=rep.name)

    def _post(self, rep: Replica, payload: bytes, headers: Dict[str, str],
              timeout_s: float, conns: List) -> Tuple[int, bytes, Dict]:
        """The one dispatch socket touch: POST /generate on `rep`. The
        connection object is appended to `conns` BEFORE the request so a
        hedging winner can close the loser mid-flight. Raises on
        transport failure."""
        conn = http.client.HTTPConnection(
            rep.host, rep.port, timeout=timeout_s
        )
        conns.append(conn)
        try:
            conn.request(
                "POST", "/generate", body=payload,
                headers={"Content-Type": "application/json", **headers},
            )
            resp = conn.getresponse()
            data = resp.read()
            keep = {}
            ra = resp.getheader("Retry-After")
            if ra is not None:
                keep["Retry-After"] = ra
            return resp.status, data, keep
        finally:
            conn.close()

    def _classify(self, res: Dict, klass: int) -> str:
        """One dispatch result -> `pass` (return to client), `failover`
        (breaker error, try elsewhere), `cooled` (replica-level
        backpressure: obey Retry-After for this class, try elsewhere) or
        `migrate` (the replica exported this request's decode state at a
        chunk boundary — re-dispatch it WITH the checkpoint; a healthy,
        deliberate hand-off, not a failure). 429 passes THROUGH: it is
        tenant-scoped (quota), and cooling the replica for the whole
        class would let one over-quota tenant make the class unroutable
        for everyone — the offending tenant must see its own 429 +
        Retry-After instead (a flooding tenant degrades only itself)."""
        if res["kind"] == "error":
            return "failover"
        status = res["status"]
        if status == 409:
            # only a replica's migrating drain answers 409 on /generate;
            # parse (and cache) the checkpoint off the body — an
            # unparseable body degrades to pass (the client sees the 409)
            ckpt = self._migrated_checkpoint(res)
            if ckpt is not None:
                return "migrate"
        if status == 503:
            return "cooled"
        if status >= 500 and status != 504:
            return "failover"
        # 2xx, 4xx (incl. the tenant-scoped 429), and 504 (the request
        # consumed its own deadline — retrying cannot meet it) pass
        return "pass"

    @staticmethod
    def _migrated_checkpoint(res: Dict) -> Optional[Dict]:
        """Parse a 409 body's migration payload once, memoized on the
        result dict; None unless it is a well-formed migrated response."""
        if "migrated_payload" not in res:
            payload = None
            try:
                obj = json.loads(res.get("body") or b"{}")
                if (
                    isinstance(obj, dict)
                    and obj.get("migrated") is True
                    and isinstance(obj.get("checkpoint"), str)
                ):
                    payload = obj
            except Exception:
                payload = None
            res["migrated_payload"] = payload
        return res["migrated_payload"]

    def _implicate_crash(self, rep: Replica, key: Optional[str],
                         error: str) -> None:
        """Quarantine attribution for one TRANSPORT failure: it reads as
        a replica crash/severed connection and implicates every request
        in flight there at that moment — the crash took them all down,
        and only repetition across incidents separates the cause from
        the bystanders. Replica 5xx answers never reach here (the
        replica survived; request-scoped poison is the replica's own
        batcher-side quarantine). Caller does NOT hold the lock."""
        if self.quarantine is None:
            return
        with self._lock:
            keys = set(rep.inflight_keys)
        if key is not None:
            keys.add(key)  # own attempt already _end_attempt-ed
        if not keys:
            return
        inc_id = self.quarantine.mint_incident(rep.name, error, keys)
        counts = {k: self.quarantine.implicate(k, inc_id) for k in keys}
        if self.log is not None:
            self.log.event(
                "crash_incident", incident=inc_id, replica=rep.name,
                error=error, implicated=len(keys),
                quarantined=[
                    k for k, c in counts.items()
                    if c >= self.quarantine.after
                ],
            )

    def _settle(self, res: Dict, rep: Replica, klass: int,
                key: Optional[str] = None) -> str:
        """Record one arrived result into the breaker/cooldowns (and the
        quarantine ledger); returns its classification."""
        kind = self._classify(res, klass)
        if kind == "failover":
            transport = res["kind"] == "error"
            error = (
                repr(res["error"]) if transport else f"http {res['status']}"
            )
            with self._lock:
                rep.last_error = error
            if (
                transport
                and not isinstance(res.get("error"), TimeoutError)
                and not res.get("cancelled")
            ):
                # crash evidence only: connect refused / reset / severed
                # mid-response. A client-side SOCKET TIMEOUT means the
                # replica was slow, not dead (socket.timeout is a
                # TimeoutError alias), and a hedge-win CANCELLATION
                # means WE closed the loser's connection — implicating
                # on either would let a slow spell or routine hedging
                # quarantine innocent prompts against healthy replicas.
                self._implicate_crash(rep, key, error)
            self._record_dispatch(rep, ok=False)
        elif kind == "cooled":
            try:
                ra = float(res.get("headers", {}).get("Retry-After", 1.0))
            except (TypeError, ValueError):
                ra = 1.0
            self._cool(rep, klass, ra)
            # explicit backpressure is a HEALTHY refusal: it must not
            # open the circuit (a queue-full burst would otherwise eject
            # the exact replica that is correctly protecting itself)
            self._record_dispatch(rep, ok=True)
        elif kind == "migrate":
            # a migrating drain is a deliberate, healthy hand-off: no
            # breaker evidence, no cooldown (the drain itself already
            # removed the replica from rotation), no implication
            self._record_dispatch(rep, ok=True)
        else:
            self._record_dispatch(rep, ok=res["status"] < 500)
            if res["status"] == 200:
                self.budget.deposit()
                if self.quarantine is not None and key is not None:
                    # a completed request demonstrably doesn't kill
                    # replicas: end its implication streak
                    self.quarantine.absolve(key)
        self._m_budget.set(self.budget.balance)
        return kind

    def _dispatch_hedged(
        self, primary: Replica, hedge_pool: List[Replica], payload: bytes,
        trace, attempt: int, rows: int, klass: int, timeout_s: float,
        key: Optional[str] = None,
    ) -> Tuple[Dict, str, bool]:
        """One routing attempt: dispatch to `primary`, optionally hedge
        to the best of `hedge_pool` after `hedge_after_s`, first usable
        answer wins (loser's connection closed). Returns (winning
        result, its classification, hedged?). Each dispatch thread
        settles its OWN result into the breaker/cooldowns/budget before
        queueing it — a result abandoned after a hedge win (or an
        orchestrator timeout) still does its bookkeeping exactly once,
        so a half-open trial can never be left claimed forever."""
        results: "queue_mod.Queue[Dict]" = queue_mod.Queue()
        conns: List = []
        #: set by the winner BEFORE it closes the loser's connection, so
        #: the loser's resulting transport error reads as CANCELLATION —
        #: not crash evidence against a healthy replica (the quarantine
        #: ledger must never fill with hedge-win artifacts)
        won = threading.Event()

        def run(rep: Replica, hedged: bool) -> None:
            span = trace.begin(
                "dispatch", replica=rep.name, attempt=attempt,
                hedged=hedged,
            )
            headers = {ROUTE_HEADER: format_route_header(
                rep.name, attempt, hedged
            )}
            if key is not None:
                # content join key: the replica keys its crash-spool
                # checkpoints (and its log lines) on it
                headers[REQUEST_KEY_HEADER] = key
            if trace:
                headers[TRACE_HEADER] = format_trace_header(
                    trace.trace_id, self._span_uid(span)
                )
            self._begin_attempt(rep, rows, key=key)
            try:
                try:
                    status, data, keep = self._post(
                        rep, payload, headers, timeout_s, conns
                    )
                except Exception as exc:
                    trace.end(span, error=repr(exc))
                    res = {
                        "kind": "error", "replica": rep, "error": exc,
                        "hedged": hedged, "cancelled": won.is_set(),
                    }
                else:
                    trace.end(span, status=status)
                    res = {
                        "kind": "http", "replica": rep, "status": status,
                        "body": data, "headers": keep, "hedged": hedged,
                    }
            finally:
                self._end_attempt(rep, rows, key=key)
            res["disposition"] = self._settle(res, rep, klass, key=key)
            results.put(res)

        threading.Thread(
            target=run, args=(primary, False),
            name="dalle-router-dispatch", daemon=True,
        ).start()
        launched = 1
        hedged_used = False
        first: Optional[Dict] = None
        if self.hedge_after_s is not None and hedge_pool:
            try:
                first = results.get(timeout=self.hedge_after_s)
            except queue_mod.Empty:
                # primary is slow: duplicate to the next candidate if the
                # budget allows (hedges draw from the same budget as
                # retries — tail insurance must not amplify an outage)
                if self.budget.withdraw():
                    self._m_budget.set(self.budget.balance)
                    self._m_hedges.inc()
                    hedged_used = True
                    threading.Thread(
                        target=run, args=(hedge_pool[0], True),
                        name="dalle-router-hedge", daemon=True,
                    ).start()
                    launched += 1
        best: Optional[Tuple[Dict, str]] = None
        for _ in range(launched):
            if first is not None:
                res, first = first, None
            else:
                try:
                    # generous wall bound: each attempt's socket timeout
                    # already caps it; this is belt-and-braces against a
                    # lost thread
                    res = results.get(timeout=timeout_s + 10.0)
                except queue_mod.Empty:
                    break
            kind = res["disposition"]  # settled by the dispatch thread
            if kind == "pass":
                if res["hedged"]:
                    self._m_hedge_wins.inc()
                won.set()  # before the close: the loser's error is a
                for conn in conns:  # cancellation, not crash evidence
                    try:
                        conn.close()
                    except Exception:
                        pass
                return res, kind, hedged_used
            best = (res, kind)  # keep waiting for a better answer
        if best is None:  # every dispatch thread got lost past its own
            res = {  # socket timeout: treat as a transport failure —
                "kind": "error", "replica": primary,  # NOT settled (the
                "error": TimeoutError("dispatch produced no result"),
                "hedged": False,  # lost thread will settle its own)
                "disposition": "failover",
            }
            return res, "failover", hedged_used
        return best[0], best[1], hedged_used

    # ------------------------------------------------------------ requests

    def _record_usage(self, body: Dict, res: Dict, wall_s: float) -> None:
        """Attribute one successful dispatch to the usage ledger:
        replica-reported wall (`latency_ms`, the chip-second basis) and
        the response's `usage` token block, falling back to router-side
        wall when the body carries neither. Accounting only — a broken
        body must never fail the reply it is accounting for."""
        try:
            usage: Dict = {}
            latency_ms = None
            try:
                payload = json.loads(res.get("body") or b"{}")
                if isinstance(payload, dict):
                    u = payload.get("usage")
                    usage = u if isinstance(u, dict) else {}
                    latency_ms = payload.get("latency_ms")
            except Exception:
                pass
            wall = (
                float(latency_ms) / 1000.0
                if isinstance(latency_ms, (int, float)) else float(wall_s)
            )
            rep = res.get("replica")
            self.usage.record(
                tenant=body.get("tenant"),
                priority=str(body.get("priority", "normal")),
                rows=int(body.get("num_images", 1) or 1),
                wall_s=wall,
                decoded_tokens=int(usage.get("decoded_tokens") or 0),
                resumed_tokens=int(usage.get("resumed_tokens") or 0),
                replica=rep.name if rep is not None else None,
            )
        except Exception:
            pass

    def handle_generate(self, raw: bytes, inbound_headers) -> Tuple[
        int, bytes, List[Tuple[str, str]]
    ]:
        """Route one client /generate body through the fleet. Returns
        (status, response body, extra headers) for the HTTP layer."""
        try:
            body = json.loads(raw)
            assert isinstance(body, dict), "body must be a JSON object"
            priority = body.get("priority", "normal")
            assert priority in PRIORITY_CLASSES, (
                f"priority must be one of {list(PRIORITY_CLASSES)}"
            )
            rows = int(body.get("num_images", 1))
            assert rows >= 1, "num_images must be >= 1"
            timeout_s = float(body.get("timeout_s", self.request_timeout_s))
            assert 0.0 < timeout_s <= self.request_timeout_s, (
                f"timeout_s must be in (0, {self.request_timeout_s}]"
            )
        except Exception as exc:
            return 400, json.dumps(
                {"error": f"bad request: {exc}"}
            ).encode(), []
        klass = priority_class(priority)
        # quarantine key BEFORE the seed pin: content identity, so an
        # identical resubmission (which would draw a fresh seed) is still
        # recognized as the same poison request
        qkey = (
            request_fingerprint(body) if self.quarantine is not None
            else None
        )
        if qkey is not None and self.quarantine.is_quarantined(qkey):
            self._m_quarantined.inc()
            incidents = self.quarantine.incidents_for(qkey)
            if self.log is not None:
                self.log.event(
                    "quarantine_refused", key=qkey, incidents=incidents,
                )
            return 422, json.dumps({
                "error": "request quarantined: implicated in "
                f"{len(incidents)} consecutive replica crash incidents",
                "incidents": incidents,
            }).encode(), []
        if body.get("seed") is None:
            body["seed"] = self.next_seed(rows)
        payload = json.dumps(body).encode("utf-8")

        ctx = parse_trace_header(inbound_headers.get(TRACE_HEADER))
        trace = self.tracer.start_trace(
            "route",
            trace_id=ctx[0] if ctx else None,
            parent_uid=ctx[1] if ctx else None,
            rows=rows, priority=priority,
        )
        t0 = self._now()
        deadline = t0 + timeout_s
        tried: set = set()
        attempt = 0
        last: Optional[Tuple[Dict, str]] = None
        hedged_any = False
        # migration state: once a checkpoint is attached (drain 409 or
        # crash-spool hit) every further dispatch of this request is a
        # RESUME — the target replica restores completed rows verbatim
        free_attempts = 0  # migrate re-dispatches don't draw retry budget
        resume_reason: Optional[str] = None
        migrated_from: Optional[str] = None
        resumed_at_chunk: Optional[int] = None

        def mig_fields() -> Dict:
            if resume_reason is None:
                return {}
            out = {"migrated_from": migrated_from, "resume": resume_reason}
            if resumed_at_chunk is not None:
                out["resumed_at_chunk"] = resumed_at_chunk
            return out

        def closed_out(outcome: str, status: int, replica=None, **fields):
            trace.finish(outcome=outcome)
            if self.log is not None:
                self.log.request(
                    trace_id=trace.trace_id if trace else None,
                    outcome=outcome, status=status,
                    latency_ms=round((self._now() - t0) * 1e3, 2),
                    stages=trace.stage_seconds(),
                    replica=replica, attempt=attempt, hedged=hedged_any,
                    priority=priority, rows=rows,
                    **mig_fields(), **fields,
                )

        while True:
            now = self._now()
            if now >= deadline:
                closed_out("timeout", 504)
                return 504, json.dumps({
                    "error": "router exhausted the request deadline "
                    "across failover attempts"
                }).encode(), []
            cands = self._routable(klass, tried)
            if not cands and tried:
                # nothing NEW to try: fall back to the full candidate
                # set (a flapping fleet beats an instant give-up when
                # the budget still allows a retry)
                cands = self._routable(klass, frozenset())
            if not cands:
                self._m_unroutable.inc()
                retry = self._retry_after_s(klass)
                closed_out(
                    "unroutable", 503,
                    replica=last[0]["replica"].name if last else None,
                )
                err = (
                    "no replica routable for priority "
                    f"{priority!r} (all ejected, draining, or cooling)"
                )
                return 503, json.dumps({"error": err}).encode(), [
                    ("Retry-After", str(int(round(retry))))
                ]
            if resume_reason is not None and qkey is not None:
                # resume re-dispatch: prefer replicas that recently saw
                # this fingerprint — their prefix cache plausibly holds
                # the prompt, so the resume's re-prefill is a cache hit
                cands = self._prefer_cache_warm(cands, qkey)
            if attempt - free_attempts > 0 and not self.budget.withdraw():
                # budget empty: surface the LAST failure instead of
                # hammering recovering replicas with more attempts
                # (migrate re-dispatches are exempt — a rolling drain is
                # deliberate fleet maintenance, not failure retry, and
                # must not be starved by an unrelated outage's drained
                # budget). (Checked BEFORE the trial claim below, so an
                # early return can never leak a claimed half-open trial.)
                self._m_budget.set(self.budget.balance)
                closed_out(
                    "budget_exhausted", 503,
                    replica=last[0]["replica"].name if last else None,
                )
                return 503, json.dumps({
                    "error": "retry budget exhausted (fleet-wide "
                    "failures; no retry capacity left)"
                }).encode(), [("Retry-After", "1")]
            self._m_budget.set(self.budget.balance)
            primary, hedge_pool = self._claim(cands)
            if primary is None:
                # every remaining candidate is a half-open replica whose
                # trial another request just claimed: brief condition,
                # tell the client to come right back
                self._m_unroutable.inc()
                closed_out(
                    "unroutable", 503,
                    replica=last[0]["replica"].name if last else None,
                )
                return 503, json.dumps({
                    "error": "all routable replicas are mid-trial "
                    "(recovering); retry shortly"
                }).encode(), [("Retry-After", "1")]
            timeout_attempt = min(
                self.attempt_timeout_s, max(0.1, deadline - now)
            )
            res, kind, hedged = self._dispatch_hedged(
                primary, hedge_pool, payload, trace, attempt, rows,
                klass, timeout_attempt, key=qkey,
            )
            hedged_any = hedged_any or hedged
            if kind == "migrate":
                # the draining replica exported this request's decode
                # state at a chunk boundary: re-dispatch THE SAME request
                # (same key, same trace, same seed) with the checkpoint
                # attached so the next replica resumes instead of
                # restarting from scratch
                payload409 = res["migrated_payload"]
                body["resume"] = payload409["checkpoint"]
                payload = json.dumps(body).encode("utf-8")
                migrated_from = res["replica"].name
                resume_reason = "drain"
                rc = payload409.get("resumed_at_chunk")
                resumed_at_chunk = int(rc) if rc is not None else None
                self._m_migrations.labels("drain").inc()
                if self.log is not None:
                    self.log.event(
                        "request_migrated", reason="drain",
                        replica=res["replica"].name, key=qkey,
                        resumed_at_chunk=resumed_at_chunk,
                        checkpoint_bytes=len(payload409["checkpoint"]),
                    )
                free_attempts += 1
                tried.add(res["replica"].name)
                last = (res, kind)
                attempt += 1
                continue
            if kind == "pass":
                status = res["status"]
                outcome = "ok" if status == 200 else "replica_status"
                if status == 200 and resume_reason is not None:
                    with self._lock:
                        res["replica"].resumes += 1
                if status == 200:
                    # usage accounting off the reply's own metadata
                    # (never fails the reply; tenant rides the body)
                    self._record_usage(body, res, self._now() - t0)
                closed_out(
                    outcome, status, replica=res["replica"].name,
                )
                extra = [("x-dalle-replica", res["replica"].name)]
                extra.extend(res.get("headers", {}).items())
                return status, res["body"], extra
            if (
                qkey is not None
                and self.quarantine.is_quarantined(qkey)
            ):
                # THIS request's implication streak just crossed the
                # threshold: stop failing over — re-dispatching a
                # replica-killer serially takes down the fleet
                self._m_quarantined.inc()
                incidents = self.quarantine.incidents_for(qkey)
                closed_out(
                    "quarantined", 422, replica=res["replica"].name,
                    incidents=incidents,
                )
                return 422, json.dumps({
                    "error": "request quarantined: implicated in "
                    f"{len(incidents)} consecutive replica crash "
                    "incidents",
                    "incidents": incidents,
                }).encode(), []
            # failover: count it, exclude the loser, loop (bounded by
            # the retry budget withdrawn at the top of the loop)
            reason = (
                "transport" if res["kind"] == "error"
                else "backpressure" if kind == "cooled"
                else "status"
            )
            if (
                reason == "transport" and qkey is not None
                and resume_reason is None
            ):
                # crash path: a spooled checkpoint for this request (the
                # supervisor hands the dead replica's journal over on
                # restart) turns the from-scratch re-dispatch into a
                # resume — optionally parking up to migrate_wait_s for
                # the hand-off to arrive
                entry = self.checkpoints.take(qkey)
                if entry is None and self.migrate_wait_s > 0:
                    entry = self.checkpoints.wait_for(
                        qkey,
                        min(self.migrate_wait_s,
                            max(0.0, deadline - self._now())),
                    )
                if entry is not None:
                    body["resume"] = entry["wire"]
                    payload = json.dumps(body).encode("utf-8")
                    migrated_from = entry.get("source")
                    resume_reason = "crash"
                    self._m_migrations.labels("crash").inc()
                    if self.log is not None:
                        self.log.event(
                            "request_migrated", reason="crash",
                            replica=res["replica"].name, key=qkey,
                            source=entry.get("source"),
                            checkpoint_bytes=len(entry["wire"]),
                        )
            self._m_failovers.labels(reason).inc()
            tried.add(res["replica"].name)
            last = (res, kind)
            attempt += 1

    # ---------------------------------------------------------- streaming

    #: seconds of upstream silence before a streaming dispatch reads as
    #: wedged and fails over — replicas keep-alive every ~10s, so this is
    #: three missed heartbeats, not one slow chunk
    stream_read_timeout_s: float = 30.0
    #: idle keep-alive cadence toward the CLIENT while splicing (covers
    #: seams where upstream bytes arrive but nothing new is forwardable)
    stream_keepalive_s: float = 10.0

    def handle_generate_stream(self, raw: bytes, inbound_headers,
                               write) -> Optional[Tuple[
                                   int, bytes, List[Tuple[str, str]]
                               ]]:
        """Route one STREAMING /generate through the fleet, splicing the
        replicas' SSE event streams into ONE continuous client stream.

        `write(bytes)` ships frames to the client (the HTTP layer sends
        the SSE response head lazily on the first call). Returns a
        `(status, body, headers)` tuple only while NOTHING has been
        written yet (plain JSON error reply); returns None once the
        stream started — every later failure reaches the client as an
        `error` event, and a migrated/failed-over request is
        re-dispatched (resume checkpoint attached, same key/seed/trace)
        with the new replica's events spliced on. The splice is
        content-addressed: progress/preview events carry the
        request-level chunk index, and only an index ABOVE the client's
        high water is forwarded — a resumed replica re-announcing chunks
        the client has seen (or a non-resume restart replaying from 0)
        is swallowed, so the client observes a gapless, duplicate-free
        sequence across every seam. Client-facing `id:` sequence numbers
        are the router's own (upstream streams restart per replica).

        No hedging for streams: a duplicated stream would double-decode
        for its whole lifetime, not just the tail."""
        try:
            body = json.loads(raw)
            assert isinstance(body, dict), "body must be a JSON object"
            assert body.get("stream") is True, "not a streaming request"
            priority = body.get("priority", "normal")
            assert priority in PRIORITY_CLASSES, (
                f"priority must be one of {list(PRIORITY_CLASSES)}"
            )
            rows = int(body.get("num_images", 1))
            assert rows >= 1, "num_images must be >= 1"
            timeout_s = float(body.get("timeout_s", self.request_timeout_s))
            assert 0.0 < timeout_s <= self.request_timeout_s, (
                f"timeout_s must be in (0, {self.request_timeout_s}]"
            )
        except Exception as exc:
            return 400, json.dumps(
                {"error": f"bad request: {exc}"}
            ).encode(), []
        klass = priority_class(priority)
        qkey = (
            request_fingerprint(body) if self.quarantine is not None
            else None
        )
        if qkey is not None and self.quarantine.is_quarantined(qkey):
            self._m_quarantined.inc()
            incidents = self.quarantine.incidents_for(qkey)
            return 422, json.dumps({
                "error": "request quarantined: implicated in "
                f"{len(incidents)} consecutive replica crash incidents",
                "incidents": incidents,
            }).encode(), []
        if body.get("seed") is None:
            # seed pinned before attempt one: re-dispatches decode
            # bit-identical tokens, which is what makes the chunk-index
            # dedup below CORRECT and not just tidy
            body["seed"] = self.next_seed(rows)
        payload = json.dumps(body).encode("utf-8")

        ctx = parse_trace_header(inbound_headers.get(TRACE_HEADER))
        trace = self.tracer.start_trace(
            "route",
            trace_id=ctx[0] if ctx else None,
            parent_uid=ctx[1] if ctx else None,
            rows=rows, priority=priority, streamed=True,
        )
        t0 = self._now()
        deadline = t0 + timeout_s
        tried: set = set()
        attempt = 0
        free_attempts = 0
        resume_reason: Optional[str] = None
        migrated_from: Optional[str] = None
        resumed_at_chunk: Optional[int] = None
        last: Optional[Dict] = None

        # client-facing splice state: one outgoing sequence, one chunk
        # high water per event type, one `open` ever
        out_seq = 0
        progress_hw = -1
        preview_hw = -1
        opened = False
        started = False  # any byte reached the client

        def forward(etype: str, data: dict) -> None:
            nonlocal out_seq, started
            write(encode_sse(etype, data, seq=out_seq))
            out_seq += 1
            started = True

        def mig_fields() -> Dict:
            if resume_reason is None:
                return {}
            out = {"migrated_from": migrated_from, "resume": resume_reason}
            if resumed_at_chunk is not None:
                out["resumed_at_chunk"] = resumed_at_chunk
            return out

        def closed_out(outcome: str, status: int, replica=None, **fields):
            trace.finish(outcome=outcome)
            if self.log is not None:
                self.log.request(
                    trace_id=trace.trace_id if trace else None,
                    outcome=outcome, status=status,
                    latency_ms=round((self._now() - t0) * 1e3, 2),
                    stages=trace.stage_seconds(),
                    replica=replica, attempt=attempt, hedged=False,
                    priority=priority, rows=rows, streamed=True,
                    stream_events=out_seq,
                    **mig_fields(), **fields,
                )

        def fail(outcome: str, status: int, err: dict, extra=(),
                 replica=None, **fields):
            """One exit for every routing failure: JSON reply while the
            stream hasn't started, a terminal `error` event once it
            has."""
            closed_out(outcome, status, replica=replica, **fields)
            if not started:
                return status, json.dumps(err).encode(), list(extra)
            forward("error", dict(err, status=status))
            return None

        def run_attempt(rep: Replica) -> Tuple[Dict, Tuple[str, object]]:
            """One streaming dispatch to `rep`. Returns (res, marker):
            `res` feeds `_settle`; marker is ("done", status) — terminal
            forwarded, stream complete; ("migrated", event data) — the
            replica handed back a checkpoint mid-stream; ("http", None)
            — non-SSE answer, classify like the buffered path;
            ("deadline", None); or ("retry", None) — transport/5xx
            failure, try elsewhere. Client-socket write failures
            propagate (the caller severs upstream, which makes the
            replica orphan the stream and cancel the decode)."""
            nonlocal opened, progress_hw, preview_hw, started
            span = trace.begin(
                "dispatch", replica=rep.name, attempt=attempt,
                streamed=True,
            )
            headers = {
                "Content-Type": "application/json",
                ROUTE_HEADER: format_route_header(rep.name, attempt, False),
            }
            if qkey is not None:
                headers[REQUEST_KEY_HEADER] = qkey
            if trace:
                headers[TRACE_HEADER] = format_trace_header(
                    trace.trace_id, self._span_uid(span)
                )
            self._begin_attempt(rep, rows, key=qkey)
            conn = http.client.HTTPConnection(
                rep.host, rep.port, timeout=self.stream_read_timeout_s
            )
            try:
                try:
                    conn.request(
                        "POST", "/generate", body=payload, headers=headers
                    )
                    resp = conn.getresponse()
                except Exception as exc:
                    trace.end(span, error=repr(exc))
                    return {
                        "kind": "error", "replica": rep, "error": exc,
                        "hedged": False, "cancelled": False,
                    }, ("retry", None)
                if resp.status != 200 or "text/event-stream" not in (
                    resp.getheader("Content-Type") or ""
                ):
                    data = resp.read()
                    keep = {}
                    ra = resp.getheader("Retry-After")
                    if ra is not None:
                        keep["Retry-After"] = ra
                    trace.end(span, status=resp.status)
                    return {
                        "kind": "http", "replica": rep,
                        "status": resp.status, "body": data,
                        "headers": keep, "hedged": False,
                    }, ("http", None)
                parser = SSEParser()
                last_write = self._now()
                while True:
                    if self._now() >= deadline:
                        trace.end(span, error="deadline")
                        return {
                            "kind": "http", "replica": rep, "status": 504,
                            "body": b"", "headers": {}, "hedged": False,
                        }, ("deadline", None)
                    try:
                        chunk = resp.read1(65536)
                    except Exception as exc:  # incl. socket timeouts
                        trace.end(span, error=repr(exc))
                        return {
                            "kind": "error", "replica": rep, "error": exc,
                            "hedged": False, "cancelled": False,
                        }, ("retry", None)
                    if not chunk:
                        # EOF without a terminal event: severed stream
                        # (hard kill mid-decode) — crash-grade evidence
                        exc = ConnectionError(
                            "replica stream ended without a terminal event"
                        )
                        trace.end(span, error=repr(exc))
                        return {
                            "kind": "error", "replica": rep, "error": exc,
                            "hedged": False, "cancelled": False,
                        }, ("retry", None)
                    forwarded = False
                    for etype, data, _seq in parser.feed(chunk):
                        if etype == "open":
                            if not opened:
                                opened = True
                                forward("open", data)
                                forwarded = True
                            continue
                        if etype in ("progress", "preview"):
                            c = int(data.get("chunk", -1))
                            if etype == "progress":
                                if c <= progress_hw:
                                    continue  # replayed chunk: swallow
                                progress_hw = c
                            else:
                                if c <= preview_hw:
                                    continue
                                preview_hw = c
                            forward(etype, data)
                            forwarded = True
                            continue
                        if etype == "migrated":
                            trace.end(span, status=409)
                            # settle EXACTLY like a buffered 409: the
                            # synthetic body keys the migrate disposition
                            return {
                                "kind": "http", "replica": rep,
                                "status": 409,
                                "body": json.dumps(
                                    dict(data, migrated=True)
                                ).encode(),
                                "headers": {}, "hedged": False,
                            }, ("migrated", data)
                        if etype == "error":
                            status = int(data.get("status", 500))
                            if status >= 500 and status != 504:
                                # replica-side failure terminal: NOT
                                # forwarded — fail over (a resume may
                                # still rescue the decode)
                                trace.end(span, status=status)
                                return {
                                    "kind": "http", "replica": rep,
                                    "status": status,
                                    "body": json.dumps(data).encode(),
                                    "headers": {}, "hedged": False,
                                }, ("retry", None)
                            forward("error", data)
                            trace.end(span, status=status)
                            return {
                                "kind": "http", "replica": rep,
                                "status": status, "body": b"",
                                "headers": {}, "hedged": False,
                            }, ("done", status)
                        if etype == "result":
                            forward("result", data)
                            trace.end(span, status=200)
                            return {
                                "kind": "http", "replica": rep,
                                "status": 200, "body": b"",
                                "headers": {}, "hedged": False,
                            }, ("done", 200)
                        forward(etype, data)  # unknown types pass through
                        forwarded = True
                    if forwarded:
                        last_write = self._now()
                    elif (
                        self._now() - last_write >= self.stream_keepalive_s
                    ):
                        write(KEEPALIVE)
                        started = True  # response head is on the wire now
                        last_write = self._now()
            finally:
                # severing the upstream connection on ANY exit makes the
                # abandoned replica handler orphan its stream and cancel
                # the decode at the next chunk boundary
                conn.close()
                self._end_attempt(rep, rows, key=qkey)

        while True:
            now = self._now()
            if now >= deadline:
                return fail(
                    "timeout", 504,
                    {"error": "router exhausted the request deadline "
                     "across failover attempts"},
                    replica=last["replica"].name if last else None,
                )
            cands = self._routable(klass, tried)
            if not cands and tried:
                cands = self._routable(klass, frozenset())
            if not cands:
                self._m_unroutable.inc()
                retry = self._retry_after_s(klass)
                return fail(
                    "unroutable", 503,
                    {"error": "no replica routable for priority "
                     f"{priority!r} (all ejected, draining, or cooling)"},
                    extra=[("Retry-After", str(int(round(retry))))],
                    replica=last["replica"].name if last else None,
                )
            if resume_reason is not None and qkey is not None:
                cands = self._prefer_cache_warm(cands, qkey)
            if attempt - free_attempts > 0 and not self.budget.withdraw():
                self._m_budget.set(self.budget.balance)
                return fail(
                    "budget_exhausted", 503,
                    {"error": "retry budget exhausted (fleet-wide "
                     "failures; no retry capacity left)"},
                    extra=[("Retry-After", "1")],
                    replica=last["replica"].name if last else None,
                )
            self._m_budget.set(self.budget.balance)
            primary, _hedge_pool = self._claim(cands)
            if primary is None:
                self._m_unroutable.inc()
                return fail(
                    "unroutable", 503,
                    {"error": "all routable replicas are mid-trial "
                     "(recovering); retry shortly"},
                    extra=[("Retry-After", "1")],
                    replica=last["replica"].name if last else None,
                )
            try:
                res, (marker, minfo) = run_attempt(primary)
            except (BrokenPipeError, ConnectionResetError):
                # OUR client went away mid-stream: upstream is already
                # severed (run_attempt's finally), which cancels the
                # decode on the replica — nothing left to route
                closed_out(
                    "disconnected", 200, replica=primary.name,
                )
                return None
            kind = self._settle(res, primary, klass, key=qkey)
            last = res
            if marker == "done":
                if int(minfo) == 200 and resume_reason is not None:
                    with self._lock:
                        primary.resumes += 1
                if int(minfo) == 200:
                    # streamed bytes passed through unparsed: record the
                    # wall-clock side of the usage row (token counts ride
                    # only the buffered path's usage block)
                    self._record_usage(
                        body, {"replica": primary}, self._now() - t0,
                    )
                closed_out(
                    "ok" if int(minfo) == 200 else "replica_status",
                    int(minfo), replica=primary.name,
                )
                return None
            if marker == "deadline":
                return fail(
                    "timeout", 504,
                    {"error": "router exhausted the request deadline "
                     "mid-stream"},
                    replica=primary.name,
                )
            if marker == "migrated" or kind == "migrate":
                # checkpoint hand-off (mid-stream terminal event, or a
                # buffered-style 409): re-dispatch THE SAME request as a
                # resume; its replayed chunks fall below the high water
                payload409 = (
                    dict(minfo) if marker == "migrated"
                    else self._migrated_checkpoint(res)
                )
                body["resume"] = payload409["checkpoint"]
                payload = json.dumps(body).encode("utf-8")
                migrated_from = payload409.get("migrated_from") or (
                    res["replica"].name
                )
                resume_reason = "drain"
                rc = payload409.get("resumed_at_chunk")
                resumed_at_chunk = int(rc) if rc is not None else None
                self._m_migrations.labels("drain").inc()
                if self.log is not None:
                    self.log.event(
                        "request_migrated", reason="drain", streamed=True,
                        replica=res["replica"].name, key=qkey,
                        resumed_at_chunk=resumed_at_chunk,
                        checkpoint_bytes=len(payload409["checkpoint"]),
                    )
                free_attempts += 1
                tried.add(res["replica"].name)
                attempt += 1
                continue
            if marker == "http" and kind == "pass":
                # non-SSE replica answer (400/422/429/504...): surface it
                status = res["status"]
                if not started:
                    closed_out(
                        "replica_status", status, replica=primary.name,
                    )
                    extra = [("x-dalle-replica", primary.name)]
                    extra.extend(res.get("headers", {}).items())
                    return status, res["body"], extra
                try:
                    err = json.loads(res["body"] or b"{}")
                    assert isinstance(err, dict)
                except Exception:
                    err = {"error": f"replica answered {status}"}
                return fail(
                    "replica_status", status, err, replica=primary.name,
                )
            if (
                qkey is not None
                and self.quarantine.is_quarantined(qkey)
            ):
                self._m_quarantined.inc()
                incidents = self.quarantine.incidents_for(qkey)
                return fail(
                    "quarantined", 422,
                    {"error": "request quarantined: implicated in "
                     f"{len(incidents)} consecutive replica crash "
                     "incidents",
                     "incidents": incidents},
                    replica=primary.name, incidents=incidents,
                )
            # failover: transport failure, severed stream, 5xx terminal,
            # or cooled backpressure — identical bookkeeping to the
            # buffered path, including the crash-spool resume rescue
            reason = (
                "transport" if res["kind"] == "error"
                else "backpressure" if kind == "cooled"
                else "status"
            )
            if (
                reason == "transport" and qkey is not None
                and resume_reason is None
            ):
                entry = self.checkpoints.take(qkey)
                if entry is None and self.migrate_wait_s > 0:
                    entry = self.checkpoints.wait_for(
                        qkey,
                        min(self.migrate_wait_s,
                            max(0.0, deadline - self._now())),
                    )
                if entry is not None:
                    body["resume"] = entry["wire"]
                    payload = json.dumps(body).encode("utf-8")
                    migrated_from = entry.get("source")
                    resume_reason = "crash"
                    self._m_migrations.labels("crash").inc()
                    if self.log is not None:
                        self.log.event(
                            "request_migrated", reason="crash",
                            streamed=True, replica=res["replica"].name,
                            key=qkey, source=entry.get("source"),
                            checkpoint_bytes=len(entry["wire"]),
                        )
            self._m_failovers.labels(reason).inc()
            tried.add(res["replica"].name)
            attempt += 1

    # --------------------------------------------------------------- admin

    def _find(self, name: str) -> Optional[Replica]:
        for rep in self.replicas:
            if rep.name == name:
                return rep
        return None

    def _propagate_admin(self, rep: Replica, action: str,
                         query: str = ""):
        """Best-effort POST of the replica's own /admin/<action> so
        direct clients are refused during the drain window too. Returns
        (error string | None, parsed response body | None) — the body is
        a plain return value, never shared state, so concurrent admin
        drains cannot read each other's bundles."""
        try:
            req = urllib.request.Request(
                rep.url + f"/admin/{action}" + (f"?{query}" if query else ""),
                data=b"", method="POST",
            )
            with urllib.request.urlopen(
                req, timeout=max(self.probe_timeout_s, 35.0 if query else 0)
            ) as resp:
                raw = resp.read()
            try:
                body = json.loads(raw or b"{}")
            except Exception:
                body = None
            return None, body
        except Exception as exc:
            return repr(exc), None

    def drain(self, name: str, wait_s: float = 0.0,
              propagate: bool = False,
              migrate: bool = False) -> Optional[Dict]:
        """Stop new admissions to `name`, wait out its outstanding rows
        (up to `wait_s`), eject it from rotation as `drained`. Returns
        the replica's state dict, or None for an unknown name.

        `migrate=True` (implies propagate) makes it a ZERO-LOST-WORK
        drain: the replica exports every queued + in-flight request as a
        decode-state checkpoint at its next chunk boundary — the blocked
        dispatch threads get 409s and re-dispatch each request as a
        resume on a healthy replica — so the drain completes in roughly
        one chunk instead of one full decode, re-decoding only the
        unfinished rows. The returned bundle is also ingested into the
        checkpoint registry (belt and braces for direct-client
        requests)."""
        rep = self._find(name)
        if rep is None:
            return None
        with self._lock:
            if rep.mode == "active":
                rep.mode = "draining"
                if rep.outstanding_rows == 0:
                    rep.mode = "drained"
            self._set_state_gauge(rep)
        if self.log is not None:
            self.log.event(
                "replica_drain", replica=name, mode=rep.mode,
                migrate=migrate,
                outstanding_rows=rep.outstanding_rows,
            )
        if propagate or migrate:
            err, body = self._propagate_admin(
                rep, "drain", query="migrate=1" if migrate else ""
            )
            if err and self.log is not None:
                self.log.event(
                    "replica_drain_propagate_failed", replica=name,
                    error=err,
                )
            if migrate and not err:
                bundle = (
                    (body or {}).get("migrate") or {}
                ).get("checkpoints") or {}
                for key, wire in bundle.items():
                    key = parse_request_key(key)
                    if key is not None and isinstance(wire, str):
                        self.checkpoints.put(key, wire, source=name)
        if wait_s > 0:
            # injectable clock like every other timing path, so a
            # stubbed-clock chaos test can expire the wait
            # deterministically (real waits still tick via the
            # 0.1s-capped condition timeout)
            deadline = self._now() + wait_s
            with self._lock:
                while rep.mode == "draining":
                    remaining = deadline - self._now()
                    if remaining <= 0:
                        break
                    self._drained.wait(timeout=min(remaining, 0.1))
        return rep.detail(self._now())

    def undrain(self, name: str, propagate: bool = False) -> Optional[Dict]:
        """Return a drained/draining replica to rotation (health resets
        to half-open so live traffic must prove it before it carries
        full load; the next probe runs immediately)."""
        rep = self._find(name)
        if rep is None:
            return None
        now = self._now()
        with self._lock:
            rep.mode = "active"
            # a replica coming back from a restart proves itself like a
            # recovering one: one trial closes the circuit
            rep.health = "half_open"
            rep.trial_inflight = False
            rep.probe_failures = 0
            rep.next_probe_at = now
            self._set_state_gauge(rep)
        if propagate:
            err, _ = self._propagate_admin(rep, "undrain")
            if err and self.log is not None:
                self.log.event(
                    "replica_undrain_propagate_failed", replica=name,
                    error=err,
                )
        if self.log is not None:
            self.log.event("replica_undrain", replica=name)
        return rep.detail(now)

    # --------------------------------------------------------------- views

    def health(self) -> Tuple[bool, Dict]:
        now = self._now()
        with self._lock:
            states = {rep.name: rep.state() for rep in self.replicas}
        n_healthy = sum(1 for s in states.values() if s == "healthy")
        n_routable = n_healthy + sum(
            1 for s in states.values() if s in ("degraded", "half_open")
        )
        if n_healthy:
            status = "ok"
        elif n_routable:
            status = "degraded"
        else:
            status = "unhealthy"
        detail = {
            "status": status,
            "role": "router",
            "uptime_s": round(time.time() - self._started_at, 1),
            "replicas": states,
            "routable": n_routable,
            "retry_budget": round(self.budget.balance, 2),
        }
        return status != "unhealthy", detail

    def detail(self) -> Dict:
        now = self._now()
        return {
            "site": self.site,
            "pid": self.pid,
            "host": self.host,
            "replicas": [rep.detail(now) for rep in self.replicas],
            "retry_budget": {
                "balance": round(self.budget.balance, 2),
                "ratio": self.budget.ratio,
                "withdrawn": self.budget.withdrawn,
                "denied": self.budget.denied,
            },
            "hedge_after_ms": (
                None if self.hedge_after_s is None
                else self.hedge_after_s * 1e3
            ),
            "quarantine": (
                self.quarantine.detail()
                if self.quarantine is not None else {"after": 0}
            ),
            "migration": {
                "migrate_wait_s": self.migrate_wait_s,
                "registry": self.checkpoints.detail(),
                "migrations": {
                    label: int(c.value)
                    for label, c in self._m_migrations.items()
                },
                "resumes_by_replica": {
                    rep.name: rep.resumes
                    for rep in self.replicas if rep.resumes
                },
            },
        }


class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    timeout = 120

    def log_message(self, fmt, *args):
        if self.server.owner.verbose:
            super().log_message(fmt, *args)

    def _reply(self, code: int, payload, extra_headers=()) -> None:
        body = (
            payload if isinstance(payload, (bytes, bytearray))
            else json.dumps(payload, default=str).encode("utf-8")
        )
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if code >= 400:
            self.send_header("Connection", "close")
            self.close_connection = True
        for k, v in extra_headers:
            self.send_header(k, v)
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def do_GET(self):
        router = self.server.owner.router
        path, _, _query = self.path.partition("?")
        if path == "/healthz":
            healthy, detail = router.health()
            self._reply(200 if healthy else 503, detail)
        elif path == "/metrics":
            text = router.registry.render().encode("utf-8")
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(text)))
            self.end_headers()
            try:
                self.wfile.write(text)
            except (BrokenPipeError, ConnectionResetError):
                pass
        elif path == "/debug/replicas":
            self._reply(200, router.detail())
        elif path == "/fleet/metrics":
            fleet = self.server.owner.fleet
            if fleet is None:
                self._reply(404, {
                    "error": "fleet metrics disabled (--no_fleet_metrics)"
                })
                return
            text = fleet.federated_render().encode("utf-8")
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(text)))
            self.end_headers()
            try:
                self.wfile.write(text)
            except (BrokenPipeError, ConnectionResetError):
                pass
        elif path == "/debug/fleet":
            fleet = self.server.owner.fleet
            if fleet is None:
                self._reply(404, {
                    "error": "fleet metrics disabled (--no_fleet_metrics)"
                })
                return
            self._reply(200, fleet.fleet_detail())
        elif path == "/debug/usage":
            self._reply(200, router.usage.summary())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        router = self.server.owner.router
        path, _, query = self.path.partition("?")
        if path == "/admin/spool":
            # supervisor spool hand-off: {"replica": name?,
            # "checkpoints": {key: wire}} — malformed entries are
            # silently skipped (parse_request_key), the count returns
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if not 0 < length <= MAX_BODY_BYTES:
                    raise ValueError(f"bad Content-Length {length}")
                obj = json.loads(self.rfile.read(length))
                assert isinstance(obj, dict), "body must be a JSON object"
                cps = obj.get("checkpoints")
                assert isinstance(cps, dict), "checkpoints must be a dict"
            except Exception as exc:
                self._reply(400, {"error": f"bad request: {exc}"})
                return
            n = router.ingest_spool(obj.get("replica"), cps)
            self._reply(200, {"ingested": n})
            return
        if path in ("/admin/drain", "/admin/undrain"):
            params = parse_qs(query)
            name = params.get("replica", [None])[0]
            if not name:
                self._reply(400, {"error": "missing ?replica=NAME"})
                return
            propagate = params.get("propagate", ["0"])[0] in ("1", "true")
            if path == "/admin/drain":
                try:
                    wait_s = float(params.get("wait_s", ["0"])[0])
                except (TypeError, ValueError):
                    self._reply(400, {"error": "wait_s must be a number"})
                    return
                migrate = params.get("migrate", ["0"])[0] in ("1", "true")
                detail = router.drain(
                    name, wait_s=wait_s, propagate=propagate,
                    migrate=migrate,
                )
            else:
                detail = router.undrain(name, propagate=propagate)
            if detail is None:
                self._reply(404, {"error": f"unknown replica {name!r}"})
                return
            self._reply(200, detail)
            return
        if path != "/generate":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if not 0 < length <= MAX_BODY_BYTES:
                raise ValueError(f"bad Content-Length {length}")
        except ValueError as exc:
            self._reply(400, {"error": f"bad request: {exc}"})
            return
        raw = self.rfile.read(length)
        stream_req = False
        try:
            obj = json.loads(raw)
            stream_req = isinstance(obj, dict) and bool(obj.get("stream"))
        except Exception:
            pass  # malformed body: handle_generate's 400 covers it
        if stream_req:
            # streaming splice: the router owns the socket for the whole
            # stream; the SSE response head goes out lazily on the first
            # forwarded frame so pre-stream failures stay JSON replies
            started = {"v": False}

            def write(data: bytes) -> None:
                if not started["v"]:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("Connection", "close")
                    self.close_connection = True
                    self.end_headers()
                    started["v"] = True
                self.wfile.write(data)
                self.wfile.flush()

            try:
                out = router.handle_generate_stream(
                    raw, self.headers, write
                )
            except (BrokenPipeError, ConnectionResetError):
                return  # client went away; upstream was already severed
            except Exception as exc:
                if started["v"]:
                    return  # a live event stream can't become a 500
                self._reply(500, {"error": f"router failure: {exc}"})
                return
            if out is not None:
                status, body, extra = out
                self._reply(status, body, extra)
            return
        try:
            status, body, extra = router.handle_generate(raw, self.headers)
        except Exception as exc:  # router bug: an orderly 500 beats a
            self._reply(500, {  # silently dropped connection
                "error": f"router failure: {exc}"
            })
            return
        self._reply(status, body, extra)


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, owner: "RouterServer"):
        self.owner = owner
        super().__init__(addr, _RouterHandler)


class RouterServer:
    """HTTP front for a `FleetRouter` with the same lifecycle surface as
    `ServingServer`: `start()` serves on a background thread (port 0
    picks a free one), `shutdown()` stops the probe loop, the listener,
    and the trace exporter."""

    def __init__(self, router: FleetRouter, host: str = "127.0.0.1",
                 port: int = 8100, verbose: bool = False,
                 probes: bool = True, fleet: Optional[object] = None):
        self.router = router
        self.verbose = verbose
        #: optional FleetScraper (obs/fleetmetrics.py) behind
        #: GET /fleet/metrics and /debug/fleet — owned here so its
        #: thread lifecycle matches the probe loop's, never the
        #: dispatch path's
        self.fleet = fleet
        self._httpd = _HTTPServer((host, port), self)
        self._thread: Optional[threading.Thread] = None
        self._serving = False
        self._closed = False
        if probes:
            router.start_probes()
        if fleet is not None:
            fleet.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "RouterServer":
        assert self._thread is None, "already started"
        self._serving = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="dalle-router-http",
            daemon=True,
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        if self._closed:
            return
        self._serving = True
        self._httpd.serve_forever(poll_interval=0.05)

    def shutdown(self) -> None:
        self.router.stop_probes()
        if self.fleet is not None:
            self.fleet.stop()
        first_close = not self._closed
        self._closed = True
        if self._serving:
            self._httpd.shutdown()
            self._serving = False
        if first_close:
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self.router.exporter is not None and first_close:
            self.router.exporter.stop()
        if first_close and self.router.log is not None:
            self.router.log.event("router_shutdown")


def add_router_args(p: argparse.ArgumentParser,
                    require_replicas: bool = True) -> None:
    """Router-specific flags, shared by `python -m ...serving.router`
    and `serve.py --router` (which validates --replicas itself, since
    the flag only applies when --router is set)."""
    p.add_argument("--replicas", type=str, required=require_replicas,
                   default=None, metavar="URLS",
                   help="comma-separated replica base URLs, optionally "
                   "named: 'http://h1:8000,west=http://h2:8000'")
    p.add_argument("--attempt_timeout_s", type=float, default=30.0,
                   help="per-dispatch socket timeout; a slower replica "
                   "attempt is failed over (the client's own timeout_s "
                   "still bounds the whole request)")
    p.add_argument("--hedge_after_ms", type=float, default=None,
                   help="duplicate a dispatch to the next replica when "
                   "the primary has not answered within this threshold "
                   "(first usable answer wins; drawn from the retry "
                   "budget; default: no hedging)")
    p.add_argument("--probe_interval_s", type=float, default=1.0,
                   help="seconds between /healthz probes per replica")
    p.add_argument("--eject_after", type=int, default=3,
                   help="consecutive probe failures that eject a replica")
    p.add_argument("--error_rate_threshold", type=float, default=0.5,
                   help="rolling dispatch error rate that opens the "
                   "circuit (with at least --error_min_samples)")
    p.add_argument("--error_min_samples", type=int, default=4,
                   help="dispatch outcomes required before the error-"
                   "rate breaker may open")
    p.add_argument("--retry_budget_ratio", type=float, default=0.2,
                   help="retry-budget tokens added per successful "
                   "dispatch (the sustained retry fraction)")
    p.add_argument("--retry_budget_initial", type=float, default=10.0,
                   help="retry-budget tokens at startup (cold-start "
                   "failover headroom)")
    p.add_argument("--quarantine_after", type=int, default=3,
                   help="consecutive replica-crash incidents a request "
                   "may be implicated in before it is quarantined "
                   "(terminal 422 with incident ids; a success clears "
                   "the streak; 0 disables the quarantine)")
    p.add_argument("--migrate_wait_s", type=float, default=0.0,
                   help="seconds a transport-failed request may park "
                   "waiting for the crashed replica's checkpoint spool "
                   "to arrive (supervisor hand-off) before failing over "
                   "from scratch; 0 = never park (spooled resumes still "
                   "apply when the hand-off already landed)")
    p.add_argument("--fleet_scrape_interval_s", type=float, default=2.0,
                   help="seconds between fleet telemetry sweeps "
                   "(/metrics + /debug/vitals + /healthz per replica) "
                   "feeding GET /fleet/metrics and /debug/fleet")
    p.add_argument("--no_fleet_metrics", action="store_true",
                   help="disable the fleet telemetry scraper "
                   "(/fleet/metrics and /debug/fleet answer 404; "
                   "per-tenant /debug/usage still works from the "
                   "router's own accounting)")


def router_from_args(args, registry=None, log=None) -> FleetRouter:
    """Build a `FleetRouter` from parsed CLI args (shared by both CLIs).
    Tracing/export flags follow serve.py's."""
    exporter = None
    if getattr(args, "trace_export", None):
        from dalle_pytorch_tpu_torch.obs.aggregate import TraceExporter

        if registry is None:
            from dalle_pytorch_tpu_torch.training.metrics import MetricsRegistry

            registry = MetricsRegistry()
        exporter = TraceExporter(args.trace_export, site=getattr(args, "trace_site", None), registry=registry)
    return FleetRouter(
        [r for r in args.replicas.split(",") if r],
        registry=registry,
        tracer=Tracer(
            enabled=not getattr(args, "no_tracing", False),
            max_traces=getattr(args, "trace_ring", 256),
        ),
        log=log,
        exporter=exporter,
        site=getattr(args, "trace_site", None),
        request_timeout_s=getattr(args, "request_timeout_s", 120.0),
        attempt_timeout_s=args.attempt_timeout_s,
        hedge_after_ms=args.hedge_after_ms,
        probe_interval_s=args.probe_interval_s,
        eject_after_probe_failures=args.eject_after,
        error_rate_threshold=args.error_rate_threshold,
        error_min_samples=args.error_min_samples,
        retry_budget_ratio=args.retry_budget_ratio,
        retry_budget_initial=args.retry_budget_initial,
        quarantine_after=getattr(args, "quarantine_after", 3),
        migrate_wait_s=getattr(args, "migrate_wait_s", 0.0),
    )


def fleet_scraper_from_args(args, router: FleetRouter, log=None):
    """Build the fleet telemetry scraper for a router CLI boot (None
    when --no_fleet_metrics): scrapes the SAME replica set the router
    routes to, shares its registry (so /metrics carries the
    dalle_fleet_* gauges) and its usage ledger."""
    if getattr(args, "no_fleet_metrics", False):
        return None
    from dalle_pytorch_tpu_torch.obs.fleetmetrics import FleetScraper

    return FleetScraper(
        [(rep.name, rep.url) for rep in router.replicas],
        registry=router.registry,
        usage=router.usage,
        interval_s=getattr(args, "fleet_scrape_interval_s", 2.0),
        log=log,
    )


def run_router_server(args, log=None) -> int:
    """The shared CLI run loop: build the router from parsed args, serve
    in the foreground with double-signal handling. Both entrypoints
    (`python -m ...serving.router` and `serve.py --router`) call this so
    their lifecycle behavior cannot drift."""
    import signal

    router = router_from_args(args, log=log)
    server = RouterServer(
        router, host=args.host, port=args.port,
        verbose=getattr(args, "verbose", False),
        fleet=fleet_scraper_from_args(args, router, log=log),
    )

    stopping = threading.Event()

    def _stop(signum, frame):
        if stopping.is_set():  # second signal: shutdown is wedged
            print("[router] second signal: exiting immediately", flush=True)
            os._exit(1)
        stopping.set()
        print(f"[router] signal {signum}: shutting down", flush=True)
        # shutdown joins the serve loop; run it off the main thread,
        # which is blocked inside serve_forever
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)

    # parseable readiness line: tests and orchestrators wait for it
    print(f"[router] listening on http://{args.host}:{server.port} "
          f"(replicas={[r.name for r in router.replicas]})", flush=True)
    server.serve_forever()
    print("[router] shutdown complete", flush=True)
    return 0


def main(argv=None) -> int:
    from dalle_pytorch_tpu_torch.obs.logging import StructuredLog

    p = argparse.ArgumentParser(description=__doc__)
    add_router_args(p)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8100,
                   help="0 picks a free port")
    p.add_argument("--request_timeout_s", type=float, default=120.0)
    p.add_argument("--trace_export", type=str, default=None, metavar="URL")
    p.add_argument("--trace_site", type=str, default=None, metavar="NAME")
    p.add_argument("--trace_ring", type=int, default=256)
    p.add_argument("--no_tracing", action="store_true")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    if args.trace_export is not None and args.no_tracing:
        p.error("--trace_export needs the span tracer; drop --no_tracing")

    log = StructuredLog(component="dalle.router", site=args.trace_site)
    return run_router_server(args, log=log)


if __name__ == "__main__":
    import sys

    sys.exit(main())
