"""Priority classes, weighted-fair queuing and per-tenant accounting.

Counterpart of the JAX package's `serving/qos.py` (host code, copied so
the port imports nothing of that package): the host-side scheduling core
of the serving layer's QoS.

  * three priority classes, "high" / "normal" / "low", with weights
    (default 8 / 4 / 1). Scheduling is stride-style weighted fair
    queuing: the next request comes from the non-empty class with the
    smallest `rows_served / weight`, so a backlogged high class gets ~8x
    the admission share of a backlogged low class, and low is never
    starved outright: after at most `sum(weights) / weight[low]`
    row-admissions its ratio is the least and it must be picked.
  * per-tenant fairness within a class: each (class, tenant) pair has its
    own deque, and the class serves the tenant with the least
    `rows_served / weight`, so one tenant flooding a class degrades only
    its own latency. Tenant weights (`tenant_weights={"a": 4, "b": 1}`)
    make the shares proportional (unlisted tenants weigh 1); weights are
    shares, quotas stay the hard bound.
  * per-tenant quotas: `tenant_rows` counts a tenant's queued rows so the
    batcher can refuse a tenant past its share (`TenantQuotaError`, 429).

Plain host state mutated under the batcher's condition lock. `push_front`
serves the preemption and retry path: a suspended request goes back to
the front of its own (class, tenant) deque, with no gain over other
classes.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Dict, Iterable, List, Optional, Tuple

#: admission classes, best-first; index = numeric class (lower = better)
PRIORITY_CLASSES = ("high", "normal", "low")

#: relative admission share of a backlogged class (stride scheduling)
DEFAULT_CLASS_WEIGHTS = {"high": 8.0, "normal": 4.0, "low": 1.0}


def priority_class(priority: str) -> int:
    """Numeric class for a priority name; raises ValueError on junk (the
    HTTP layer maps that to 400)."""
    try:
        return PRIORITY_CLASSES.index(priority)
    except ValueError:
        raise ValueError(
            f"unknown priority {priority!r}; expected one of "
            f"{PRIORITY_CLASSES}"
        ) from None


class ShedError(RuntimeError):
    """Admission-time load shed: the cost model says this request's SLO
    cannot be met (503 + Retry-After at the HTTP layer — reject NOW so
    the client can retry elsewhere, instead of queueing it to a certain
    timeout)."""

    def __init__(self, msg: str, retry_after_s: float = 1.0,
                 reason: str = "deadline"):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)
        self.reason = reason


class TenantQuotaError(RuntimeError):
    """Tenant exceeded its queued-rows quota (429 at the HTTP layer)."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class WeightedFairQueue:
    """Per-class, per-tenant request queues with stride-scheduled pops.

    Requests need `.klass` (int index into PRIORITY_CLASSES), `.tenant`
    (str, "" = the shared default tenant), and `.pending_rows` (int —
    rows still to serve; the service-accounting unit). NOT thread-safe:
    the batcher mutates it under its own condition lock, exactly like the
    deque it replaces.
    """

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 tenant_weights: Optional[Dict[str, float]] = None):
        w = dict(DEFAULT_CLASS_WEIGHTS)
        if weights:
            w.update(weights)
        if not all(w.get(c, 0) > 0 for c in PRIORITY_CLASSES):
            raise ValueError(f"every class needs a positive weight, got {w}")
        self.weights = tuple(float(w[c]) for c in PRIORITY_CLASSES)
        # per-tenant admission shares within a class (stride scheduling
        # over rows_served / weight, same math as the class level);
        # tenants not listed weigh 1.0
        self.tenant_weights = {
            str(t): float(v) for t, v in (tenant_weights or {}).items()
        }
        if not all(v > 0 for v in self.tenant_weights.values()):
            raise ValueError(f"tenant weights must be positive, got {self.tenant_weights}")
        # class -> tenant -> deque[request]; OrderedDict keeps tenant
        # iteration deterministic (test-friendly tie-breaks)
        self._queues: Tuple["OrderedDict[str, deque]", ...] = tuple(
            OrderedDict() for _ in PRIORITY_CLASSES
        )
        # stride accounting: rows served per class / per (class, tenant).
        # Never reset while the process lives — ratios, not totals, drive
        # scheduling, so unbounded growth is fine (floats).
        self._class_served = [0.0 for _ in PRIORITY_CLASSES]
        self._tenant_served: List[Dict[str, float]] = [
            {} for _ in PRIORITY_CLASSES
        ]
        self._len = 0
        self._rows = 0
        self._class_rows = [0 for _ in PRIORITY_CLASSES]
        self._tenant_rows: Dict[str, int] = {}

    # ------------------------------------------------------------ intake

    def push(self, req) -> None:
        self._pre_insert(req)
        self._queues[req.klass].setdefault(req.tenant, deque()).append(req)
        self._account(req, +1)

    def push_front(self, req) -> None:
        """Resume path: next in line WITHIN its own (class, tenant) queue
        — no cross-class priority gain."""
        self._pre_insert(req)
        self._queues[req.klass].setdefault(req.tenant, deque()).appendleft(req)
        self._account(req, +1)

    def _pre_insert(self, req) -> None:
        """Reactivation clamp (classic WFQ virtual-time catch-up): a
        class or tenant that sat IDLE must not bank scheduling credit.
        Without this, after a long high-only period a low burst's ratio
        (served/weight) would undercut high's by the whole idle span and
        outrank it for thousands of admissions — priority inverted. The
        clamp also keeps preemption churn-free: a preempted victim
        re-queued into its empty class re-enters at the CURRENT minimum
        ratio, tying — not beating — the blocked head it was evicted
        for, and ties break toward the better class."""
        k = req.klass
        if not any(self._queues[k].values()):
            active = [
                j for j, tenants in enumerate(self._queues)
                if any(tenants.values())
            ]
            if active:
                floor = min(
                    self._class_served[j] / self.weights[j] for j in active
                )
                self._class_served[k] = max(
                    self._class_served[k], floor * self.weights[k]
                )
        q = self._queues[k].get(req.tenant)
        if q is None or not q:
            served = self._tenant_served[k]
            backlogged = [t for t, tq in self._queues[k].items() if tq]
            if backlogged:
                # weighted virtual time, like the class-level clamp: the
                # floor is the minimum served/weight RATIO, and the idle
                # tenant re-enters at that ratio scaled by its own weight
                floor = min(
                    served.get(t, 0.0) / self.tenant_weight(t)
                    for t in backlogged
                )
                served[req.tenant] = max(
                    served.get(req.tenant, 0.0),
                    floor * self.tenant_weight(req.tenant),
                )

    def _account(self, req, sign: int) -> None:
        self._len += sign
        rows = sign * int(req.pending_rows)
        self._rows += rows
        self._class_rows[req.klass] += rows
        t = self._tenant_rows.get(req.tenant, 0) + rows
        if t > 0:
            self._tenant_rows[req.tenant] = t
        else:
            self._tenant_rows.pop(req.tenant, None)

    def tenant_weight(self, tenant: str) -> float:
        """Admission-share weight of one tenant (1.0 unless configured)."""
        return self.tenant_weights.get(tenant, 1.0)

    # --------------------------------------------------------- scheduling

    def _pick(self) -> Optional[Tuple[int, str]]:
        """(class, tenant) the scheduler serves next, or None when empty:
        smallest rows_served/weight class, then its least-served tenant."""
        best = None
        best_ratio = None
        for k, tenants in enumerate(self._queues):
            if not any(tenants.values()):
                continue
            ratio = self._class_served[k] / self.weights[k]
            if best_ratio is None or ratio < best_ratio:
                best, best_ratio = k, ratio
        if best is None:
            return None
        served = self._tenant_served[best]
        tenant = min(
            (t for t, q in self._queues[best].items() if q),
            key=lambda t: served.get(t, 0.0) / self.tenant_weight(t),
        )
        return best, tenant

    def peek(self):
        """The request the scheduler would pop next (None when empty).
        Deterministic: repeated peeks without intervening push/pop return
        the same request, so the batcher's peek-validate-pop idiom holds."""
        pick = self._pick()
        if pick is None:
            return None
        k, tenant = pick
        return self._queues[k][tenant][0]

    def pop(self, charge: bool = True):
        """Pop the scheduled head. `charge=False` skips service accounting
        — popping a cancelled/expired request consumed no capacity and
        must not cost its class its fair share."""
        pick = self._pick()
        assert pick is not None, "pop from an empty queue"
        k, tenant = pick
        req = self._queues[k][tenant].popleft()
        self._account(req, -1)
        if charge:
            rows = max(1, int(req.pending_rows))
            self._class_served[k] += rows
            served = self._tenant_served[k]
            served[tenant] = served.get(tenant, 0.0) + rows
        return req

    # ------------------------------------------------------------- views

    def __len__(self) -> int:
        return self._len

    @property
    def rows(self) -> int:
        return self._rows

    def tenant_rows(self, tenant: str) -> int:
        return self._tenant_rows.get(tenant, 0)

    def rows_at_or_better(self, klass: int) -> int:
        """Queued rows in class `klass` or better. The queue-full bound
        competes a new request only against rows its own class must wait
        behind — a low-class flood fills the LOW horizon and 503s itself,
        while high-class arrivals still see a near-empty queue (worst-
        case total memory stays bounded at n_classes x the row bound)."""
        return sum(self._class_rows[: klass + 1])

    def class_depths(self) -> Dict[str, int]:
        """{class name: queued rows} for gauges / healthz / vitals."""
        out = {}
        for k, name in enumerate(PRIORITY_CLASSES):
            out[name] = sum(
                sum(int(r.pending_rows) for r in q)
                for q in self._queues[k].values()
            )
        return out

    def requests(self) -> List:
        """Every queued request, class-major then tenant arrival order —
        a stable snapshot for state dumps and shutdown sweeps."""
        out = []
        for tenants in self._queues:
            for q in tenants.values():
                out.extend(q)
        return out

    def oldest_enqueued_at(self) -> Optional[float]:
        """Earliest `enqueued_at` across everything queued (head-age
        staleness signal for the watchdog; None when empty)."""
        times = [r.enqueued_at for r in self.requests()]
        return min(times) if times else None

    def drain(self) -> Iterable:
        """Pop everything (shutdown drain=False path)."""
        out = self.requests()
        for tenants in self._queues:
            tenants.clear()
        self._len = 0
        self._rows = 0
        self._tenant_rows.clear()
        return out
