"""The port's QoS scheduling core against the JAX package's (CPU).

`serving/qos.py:WeightedFairQueue` in both packages under the same seeded
numpy schedules of `push`, `push_front`, `pop(charge=...)` and `peek`
over the three priority classes, several tenants, class weights and
tenant weights: the same pop order, and after every operation the same
`rows`, `tenant_rows`, `rows_at_or_better`, `class_depths`,
`oldest_enqueued_at` and length. Plus the helpers: `priority_class`, the
errors' `retry_after_s` / `reason`, and weights that must be positive.
"""

import numpy as np
import pytest

from dalle_pytorch_tpu.serving import qos as jqos
from dalle_pytorch_tpu_torch.serving import qos

TENANTS = ("", "acme", "flood", "tiny")


class _R:
    """A request as the queue sees it: class, tenant, pending rows and
    arrival time (the same object goes into both queues)."""

    def __init__(self, name, klass, tenant, rows, enqueued_at):
        self.name = name
        self.klass = klass
        self.tenant = tenant
        self.pending_rows = rows
        self.enqueued_at = enqueued_at


def _views(q):
    return (
        len(q), q.rows, {t: q.tenant_rows(t) for t in TENANTS},
        [q.rows_at_or_better(k) for k in range(3)], q.class_depths(), q.oldest_enqueued_at(),
        [r.name for r in q.requests()],
    )


CASES = [
    dict(seed=0, weights=None, tenant_weights=None),
    dict(seed=1, weights={"high": 2.0, "low": 0.5}, tenant_weights=None),
    dict(seed=2, weights=None, tenant_weights={"acme": 4.0, "flood": 0.5}),
    dict(seed=3, weights={"normal": 1.0}, tenant_weights={"tiny": 3.0}),
]


@pytest.mark.parametrize("case", CASES, ids=[f"seed{c['seed']}" for c in CASES])
def test_same_schedule_same_pops_and_accounting(case):
    rng = np.random.RandomState(case["seed"])
    ours = qos.WeightedFairQueue(case["weights"], case["tenant_weights"])
    ref = jqos.WeightedFairQueue(case["weights"], case["tenant_weights"])
    popped_ours, popped_ref = [], []
    for step in range(600):
        op = rng.choice(["push", "push_front", "pop", "pop_free", "peek"], p=[0.4, 0.1, 0.3, 0.1, 0.1])
        if op in ("push", "push_front"):
            req = _R(
                step, int(rng.randint(3)), TENANTS[rng.randint(len(TENANTS))],
                int(rng.randint(1, 4)), float(rng.uniform(0, 100)),
            )
            getattr(ours, op)(req)
            getattr(ref, op)(req)
        elif op == "peek":
            a, b = ours.peek(), ref.peek()
            assert (a is None and b is None) or a is b
        elif len(ref):
            charge = op == "pop"
            popped_ours.append(ours.pop(charge=charge).name)
            popped_ref.append(ref.pop(charge=charge).name)
        assert _views(ours) == _views(ref), f"step {step} ({op})"
    assert popped_ours == popped_ref and len(popped_ref) > 100
    assert [r.name for r in ours.drain()] == [r.name for r in ref.drain()]
    assert _views(ours) == _views(ref)


def test_backlogged_classes_share_by_weight_as_the_reference():
    ours, ref = qos.WeightedFairQueue(), jqos.WeightedFairQueue()
    for i in range(60):
        for klass in range(3):
            req = _R(f"{klass}-{i}", klass, "", 1, float(i))
            ours.push(req)
            ref.push(req)
    order = [ours.pop().name for _ in range(130)]
    assert order == [ref.pop().name for _ in range(130)]
    counts = [sum(1 for n in order if n.startswith(f"{k}-")) for k in range(3)]
    assert counts[0] > counts[1] > counts[2] > 0  # 8 : 4 : 1, and low is never starved


def test_priority_class_and_errors():
    for name in qos.PRIORITY_CLASSES:
        assert qos.priority_class(name) == jqos.priority_class(name)
    assert qos.PRIORITY_CLASSES == jqos.PRIORITY_CLASSES
    assert qos.DEFAULT_CLASS_WEIGHTS == jqos.DEFAULT_CLASS_WEIGHTS
    with pytest.raises(ValueError, match="unknown priority"):
        qos.priority_class("urgent")
    shed = qos.ShedError("late", retry_after_s=3, reason="deadline")
    ref = jqos.ShedError("late", retry_after_s=3, reason="deadline")
    assert (shed.retry_after_s, shed.reason, str(shed)) == (ref.retry_after_s, ref.reason, str(ref))
    assert isinstance(shed.retry_after_s, float) and qos.ShedError("x").retry_after_s == 1.0
    quota = qos.TenantQuotaError("over", retry_after_s=7)
    assert quota.retry_after_s == jqos.TenantQuotaError("over", retry_after_s=7).retry_after_s == 7.0
    assert qos.TenantQuotaError("x").retry_after_s == 1.0


@pytest.mark.parametrize("kw", [dict(weights={"low": 0.0}), dict(tenant_weights={"a": -1.0})])
def test_weights_must_be_positive(kw):
    with pytest.raises(ValueError, match="positive"):
        qos.WeightedFairQueue(**kw)
