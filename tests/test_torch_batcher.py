"""The port's batchers (CPU): the `MicroBatcher` against the JAX package's,
and the `ContinuousBatcher`'s QoS, cancellation and recovery on the
port's tiny engines.

* `MicroBatcher`: the port's and the JAX package's over one numpy fake
  engine under the same submission schedule give the same batches and
  the same outcomes, case by case of `tests/test_serving.py::
  TestMicroBatcher` (coalescing, deadline flush, whole multi-row
  requests, oversized, queue full, timeout, cancellation, engine error,
  graceful and hard shutdown, the depth gauge) plus the weighted-fair
  order and the tenant quota.
* `ContinuousBatcher` over a numpy slot fake, the port's beside the JAX
  package's: the same preemption victim and counters.
* `ContinuousBatcher` over the port's tiny `ContinuousEngine` and
  `PagedContinuousEngine` (fp32, plain versions), mirroring
  `tests/test_qos.py`: high overtakes queued low; a low flood cannot
  starve normal; preemption of the youngest low gives the unpreempted
  tokens (slotted and paged, with and without resume); reserve slots;
  cancel and timeout mid-decode release the slot (paged `leak_check()`
  empty); a chunk or prefill failure injected by `FaultInjector`
  recovers to the same tokens, a stall rule only delays; an exhausted
  retry fails clean; the tenant quota (429) and the deadline shed (503).
  `FaultInjector`'s rules fire as the JAX package's do.
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.serving import batcher as jbatcher
from dalle_pytorch_tpu.serving import qos as jqos
from dalle_pytorch_tpu.serving.engine import SampleSpec as JSpec
from dalle_pytorch_tpu.training.metrics import MetricsRegistry as JRegistry
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.obs.tracing import Tracer
from dalle_pytorch_tpu_torch.serving import batcher as pbatcher
from dalle_pytorch_tpu_torch.serving import qos as pqos
from dalle_pytorch_tpu_torch.serving.batcher import (
    ContinuousBatcher,
    QueueFullError,
    RequestCancelled,
    RequestTimeout,
)
from dalle_pytorch_tpu_torch.serving.engine import ContinuousEngine, PagedContinuousEngine, SampleSpec
from dalle_pytorch_tpu_torch.serving.faults import FaultInjector, InjectedFault
from dalle_pytorch_tpu_torch.serving.qos import ShedError, TenantQuotaError
from dalle_pytorch_tpu_torch.training.metrics import MetricsRegistry
from test_torch_dalle import TINY

torch.set_num_threads(2)

PORT = types.SimpleNamespace(b=pbatcher, q=pqos, Spec=SampleSpec, Registry=MetricsRegistry)
REF = types.SimpleNamespace(b=jbatcher, q=jqos, Spec=JSpec, Registry=JRegistry)


# ------------------------------------------------ MicroBatcher vs the JAX one


class FakeEngine:
    """The `generate` surface, numpy only: a row's tokens carry its seed."""

    def __init__(self, max_batch=4, gate=None, fail=False):
        self.max_batch, self.gate, self.fail = max_batch, gate, fail
        self.batches = []  # seeds of each flushed batch

    def generate(self, specs):
        if self.gate is not None:
            assert self.gate.wait(10.0), "the test never released the engine"
        if self.fail:
            raise RuntimeError("the device fell over")
        self.batches.append([int(s.seed) for s in specs])
        return np.stack([np.full(4, s.seed, np.int32) for s in specs]), None


def _outcome(req, timeout=10):
    """A request's end as comparable data: its tokens' seeds, or its error."""
    try:
        toks, pix = req.future.result(timeout=timeout)
    except Exception as exc:
        return type(exc).__name__
    assert pix is None
    return [int(t[0]) for t in toks]


def _micro(impl, eng, **kw):
    return impl.b.MicroBatcher(eng, registry=impl.Registry(), **kw)


def _specs(impl, *seeds):
    return [impl.Spec(np.zeros(8, np.int32), seed=s) for s in seeds]


def _value(b, name):
    return b.registry.get(name).value


def scenario_coalesce(impl):
    eng = FakeEngine(max_batch=4)
    b = _micro(impl, eng, max_delay_ms=2000)
    t0 = time.monotonic()
    reqs = [b.submit(_specs(impl, i)) for i in range(4)]
    out = [_outcome(r) for r in reqs]
    took = time.monotonic() - t0
    occ = b.registry.get("dalle_serving_batch_occupancy_rows")
    b.shutdown()
    return dict(out=out, batches=eng.batches, fast=took < 1.5, occupancy=(occ.count, occ.sum))


def scenario_deadline_flush(impl):
    eng = FakeEngine(max_batch=8)
    b = _micro(impl, eng, max_delay_ms=100)
    out = _outcome(b.submit(_specs(impl, 7)))
    b.shutdown()
    return dict(out=out, batches=eng.batches)


def scenario_multi_row_whole(impl):
    eng = FakeEngine(max_batch=4)
    b = _micro(impl, eng, max_delay_ms=500)
    r1, r2 = b.submit(_specs(impl, 1, 2, 3)), b.submit(_specs(impl, 9))
    out = [_outcome(r1), _outcome(r2)]
    b.shutdown()
    return dict(out=out, batches=eng.batches)


def scenario_oversized(impl):
    b = _micro(impl, FakeEngine(max_batch=4))
    with pytest.raises(impl.b.QueueFullError, match="exceeds max batch") as err:
        b.submit(_specs(impl, *range(5)))
    b.shutdown()
    return dict(error=type(err.value).__name__, rejected=_value(b, "dalle_serving_rejected_total"))


def _parked(impl, max_queue_rows=64):
    """A 1-row batcher whose worker holds request 0 inside the engine."""
    gate = threading.Event()
    eng = FakeEngine(max_batch=1, gate=gate)
    b = _micro(impl, eng, max_delay_ms=1, max_queue_rows=max_queue_rows)
    first = b.submit(_specs(impl, 0))
    deadline = time.monotonic() + 10
    while b.queue_depth_rows and time.monotonic() < deadline:
        time.sleep(0.005)  # until the worker took it off the queue
    return eng, b, gate, first


def scenario_queue_full(impl):
    eng, b, gate, first = _parked(impl, max_queue_rows=2)
    queued = [b.submit(_specs(impl, 1)), b.submit(_specs(impl, 2))]
    with pytest.raises(impl.b.QueueFullError, match="queue full") as err:
        b.submit(_specs(impl, 3))
    rejected = _value(b, "dalle_serving_rejected_total")
    gate.set()
    out = [_outcome(r) for r in [first] + queued]
    b.shutdown()
    return dict(out=out, batches=eng.batches, rejected=rejected, retry_after=err.value.retry_after_s)


def scenario_timeout(impl):
    eng, b, gate, first = _parked(impl)
    stale = b.submit(_specs(impl, 1), timeout_s=0.05)
    time.sleep(0.2)  # it expires while the engine is busy
    gate.set()
    out = [_outcome(first), _outcome(stale)]
    b.shutdown()
    return dict(out=out, batches=eng.batches, timeouts=_value(b, "dalle_serving_timeouts_total"))


def scenario_cancel(impl):
    eng, b, gate, first = _parked(impl)
    doomed = b.submit(_specs(impl, 1))
    doomed.cancel()
    gate.set()
    out = [_outcome(first), _outcome(doomed)]
    b.shutdown()
    return dict(out=out, batches=eng.batches, cancelled=_value(b, "dalle_serving_cancelled_total"))


def scenario_engine_error(impl):
    eng = FakeEngine(max_batch=4, fail=True)
    b = _micro(impl, eng, max_delay_ms=50)
    reqs = [b.submit(_specs(impl, 0)), b.submit(_specs(impl, 1))]
    out = [_outcome(r) for r in reqs]
    last = type(b.last_error).__name__
    errors = _value(b, "dalle_serving_engine_errors_total")
    incidents = [r.incidents for r in reqs]
    b.shutdown()
    return dict(out=out, last_error=last, errors=errors, incidents=incidents)


def scenario_graceful_shutdown(impl):
    eng, b, gate, first = _parked(impl)
    reqs = [first] + [b.submit(_specs(impl, i)) for i in (1, 2)]
    gate.set()
    b.shutdown(drain=True)
    out = [_outcome(r, timeout=1) for r in reqs]
    with pytest.raises(impl.b.ShuttingDownError):
        b.submit(_specs(impl, 9))
    return dict(out=out, batches=eng.batches)


def scenario_hard_shutdown(impl):
    eng, b, gate, first = _parked(impl)
    pending = b.submit(_specs(impl, 1))
    gate.set()
    b.shutdown(drain=False)
    return dict(out=[_outcome(first), _outcome(pending, timeout=1)])


def scenario_depth_gauge(impl):
    eng, b, gate, first = _parked(impl, max_queue_rows=8)
    b.submit(_specs(impl, 1))
    b.submit(_specs(impl, 2))
    during = (b.queue_depth_rows, _value(b, "dalle_serving_queue_depth_rows"))
    by_class = b.class_depths()
    gate.set()
    b.shutdown(drain=True)
    return dict(during=during, by_class=by_class, after=_value(b, "dalle_serving_queue_depth_rows"))


def scenario_priority_and_quota(impl):
    eng, b, gate, first = _parked(impl)
    b.tenant_quota_rows = 2
    low = [b.submit(_specs(impl, s), priority="low", tenant="t") for s in (1, 2)]
    with pytest.raises(impl.q.TenantQuotaError) as err:
        b.submit(_specs(impl, 3), priority="low", tenant="t")
    high = b.submit(_specs(impl, 4), priority="high", tenant="u")
    gate.set()
    out = [_outcome(r) for r in [first] + low + [high]]
    shed = {k: c.value for k, c in b.registry.get("dalle_serving_shed_total").items()}
    b.shutdown()
    return dict(out=out, batches=eng.batches, retry_after=err.value.retry_after_s, shed=shed)


EXPECTED = {
    "coalesce": dict(out=[[0], [1], [2], [3]], batches=[[0, 1, 2, 3]], fast=True, occupancy=(1, 4)),
    "deadline_flush": dict(out=[7], batches=[[7]]),
    "multi_row_whole": dict(out=[[1, 2, 3], [9]], batches=[[1, 2, 3, 9]]),
    "oversized": dict(error="QueueFullError", rejected=1),
    "queue_full": dict(out=[[0], [1], [2]], batches=[[0], [1], [2]], rejected=1, retry_after=1.0),
    "timeout": dict(out=[[0], "RequestTimeout"], batches=[[0]], timeouts=1),
    "cancel": dict(out=[[0], "RequestCancelled"], batches=[[0]], cancelled=1),
    "engine_error": dict(
        out=["RuntimeError", "RuntimeError"], last_error="RuntimeError", errors=1,
        incidents=[["disp-000001"], ["disp-000001"]],
    ),
    "graceful_shutdown": dict(out=[[0], [1], [2]], batches=[[0], [1], [2]]),
    "hard_shutdown": dict(out=[[0], "ShuttingDownError"]),
    "depth_gauge": dict(during=(2, 2), by_class={"high": 0, "normal": 2, "low": 0}, after=0),
    "priority_and_quota": dict(
        out=[[0], [1], [2], [4]], batches=[[0], [4], [1], [2]], retry_after=1.0, shed={"quota": 1},
    ),
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_micro_batcher_matches_the_reference(name):
    run = globals()[f"scenario_{name}"]
    ours, ref = run(PORT), run(REF)
    assert ours == ref
    assert ours == EXPECTED[name]


# ------------------------------------ preemption policy vs the JAX batcher


class SlotFake:
    """The slot surface, numpy only: each chunk advances every live slot by
    `chunk`; a row's tokens carry its seed. `step_chunk` waits for a permit
    from the test (`Stepper`)."""

    image_seq_len = 8
    max_batch = 4
    prefill_batch = 4

    def __init__(self, chunk=1):
        self.chunk = chunk
        self.pos = np.zeros(self.max_batch, np.int64)
        self.active = np.zeros(self.max_batch, bool)
        self.seeds = np.zeros(self.max_batch, np.int64)

    def prefill_slots(self, assignments):
        for slot, sp in assignments:
            self.pos[slot], self.active[slot], self.seeds[slot] = 0, True, sp.seed

    def step_chunk(self):
        live = self.active & (self.pos < self.image_seq_len)
        self.pos[live] += self.chunk
        return self.pos.copy(), self.active.copy()

    def snapshot_rows(self, slots):
        return np.stack([np.full(self.image_seq_len, self.seeds[s], np.int32) for s in slots])

    harvest = snapshot_rows

    def release(self, slots):
        for s in slots:
            self.active[s] = False

    def decode_pixels(self, tokens):
        return None


class Stepper:
    """Chunk boundaries on the test's command: `engine.step_chunk` waits for
    a permit; `step(n)` releases n and returns once the worker is parked
    at the next boundary, its work for the released ones done."""

    def __init__(self, engine):
        self.entered, self.permits = threading.Event(), threading.Semaphore(0)
        inner = engine.step_chunk

        def step_chunk(*args, **kw):
            self.entered.set()
            assert self.permits.acquire(timeout=30), "no chunk permit released"
            return inner(*args, **kw)

        engine.step_chunk = step_chunk

    def step(self, n=1):
        for _ in range(n):
            self.entered.clear()
            self.permits.release()
            assert self.entered.wait(30)

    def until(self, cond, max_steps=64):
        for _ in range(max_steps):
            if cond():
                return
            self.step()
        assert cond(), "condition not reached within the step budget"

    def finish(self, reqs, timeout=60.0):
        """Release boundaries until every request resolved (after the last
        retirement the worker parks idle and enters no chunk)."""
        deadline = time.monotonic() + timeout
        while not all(r.future.done() for r in reqs):
            assert time.monotonic() < deadline, "requests never finished"
            self.permits.release()
            time.sleep(0.002)


def _preemption_run(impl):
    eng = SlotFake()
    stepper = Stepper(eng)
    b = impl.b.ContinuousBatcher(eng, registry=impl.Registry())
    lows = [b.submit(_specs(impl, i), priority="low") for i in range(4)]
    assert stepper.entered.wait(10)
    stepper.until(lambda: b.allocator.n_active == 4)
    high = b.submit(_specs(impl, 9), priority="high")
    stepper.step(2)  # boundary 1: the preemption; boundary 2: high admitted
    preempted = [r.preemptions for r in lows]
    stepper.finish(lows + [high])
    out = [_outcome(r) for r in lows + [high]]
    counters = {
        name: {k: c.value for k, c in b.registry.get(name).items()}
        for name in ("dalle_serving_preemptions_total", "dalle_serving_resumptions_total")
    }
    b.shutdown()
    return dict(preempted=preempted, out=out, counters=counters, snapshot=len(lows[3].preempt_snapshots))


def test_preemption_policy_matches_the_reference():
    ours, ref = _preemption_run(PORT), _preemption_run(REF)
    assert ours == ref
    assert ours["preempted"] == [0, 0, 0, 1]  # the youngest low
    assert ours["counters"] == {
        "dalle_serving_preemptions_total": {"priority": 1},
        "dalle_serving_resumptions_total": {"priority": 1},
    }
    assert ours["out"] == [[0], [1], [2], [3], [9]]


# ---------------------------------------------- the port's tiny engines

IMG_SEQ = TINY["image_fmap_size"] ** 2


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(5)
    return DALLE(**TINY, attn_impl="flash").eval()


def _engine(model, paged=False, resume=False, max_batch=2, prefix_entries=8):
    cls = PagedContinuousEngine if paged else ContinuousEngine
    kw = dict(page_size=4, prefix_entries=prefix_entries) if paged else {}
    return cls(
        model, max_batch=max_batch, chunk_tokens=2, prefill_batch=max_batch, device="cpu",
        resume_enabled=resume, **kw,
    )


def _prompt(fill):
    ids = np.zeros(TINY["text_seq_len"], np.int32)
    ids[:4] = fill
    return ids


def _spec(seed, fill=(1, 2, 3, 4)):
    return SampleSpec(_prompt(fill), seed=seed, temperature=1.0, top_k=0.5)


def _tokens(req, timeout=120):
    return req.future.result(timeout=timeout)[0]


def _reference(model, spec):
    b = ContinuousBatcher(_engine(model, max_batch=1))
    try:
        return _tokens(b.submit([spec]))
    finally:
        b.shutdown()


def _wait(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.002)


def _family(b, name):
    return {k: int(c.value) for k, c in b.registry.get(name).items()}


def test_high_overtakes_queued_low(model):
    eng = _engine(model)
    b = ContinuousBatcher(eng)
    stepper = Stepper(eng)
    running = [b.submit([_spec(i)], priority="low") for i in range(2)]
    assert stepper.entered.wait(10)
    queued = [b.submit([_spec(10 + i)], priority="low") for i in range(2)]
    high = b.submit([_spec(99)], priority="high")
    stepper.finish(running + queued + [high])
    for r in running + queued + [high]:
        _tokens(r)
    assert all(high.first_token_at <= q.first_token_at for q in queued)
    b.shutdown()


def test_low_flood_cannot_starve_normal(model):
    eng = _engine(model)
    b = ContinuousBatcher(eng)
    tracer = Tracer()
    flood = [
        b.submit([_spec(i)], priority="low", tenant="flooder", trace=tracer.start_trace())
        for i in range(8)
    ]
    normal = b.submit([_spec(50)], priority="normal", trace=tracer.start_trace())
    for r in flood + [normal]:
        _tokens(r)
        r.trace.finish()
    waits = [r.trace.stage_seconds().get("queue", 0.0) for r in flood]
    assert normal.trace.stage_seconds()["queue"] <= max(waits)
    b.shutdown()


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
@pytest.mark.parametrize("resume", [False, True], ids=["restart", "resume"])
def test_preempted_low_gives_the_unpreempted_tokens(model, paged, resume):
    victim_spec = _spec(1234, (5, 6, 7, 8))
    ref = _reference(model, victim_spec)
    eng = _engine(model, paged=paged, resume=resume)
    b = ContinuousBatcher(eng)
    stepper = Stepper(eng)
    other = b.submit([_spec(5, (1, 1, 2, 2))], priority="low")
    victim = b.submit([victim_spec], priority="low")
    assert stepper.entered.wait(10)
    stepper.until(lambda: victim.first_token_at is not None and b.allocator.n_active == 2)
    stepper.step(2)  # some tokens decoded before the high arrives
    high = b.submit([_spec(9, (3, 3, 4, 4))], priority="high")
    stepper.finish([other, victim, high])
    np.testing.assert_array_equal(_tokens(victim), ref)
    assert victim.preemptions == 1 and high.preemptions == 0 and other.preemptions == 0
    snap = victim.preempt_snapshots[0]
    assert 1 <= len(snap) < IMG_SEQ
    np.testing.assert_array_equal(_tokens(victim)[0][: len(snap)], snap)
    assert _family(b, "dalle_serving_preemptions_total") == {"priority": 1}
    assert _family(b, "dalle_serving_resumptions_total") == {"priority": 1}
    # with resume the victim continued at its position: its prefix was not decoded again
    decoded = int(b.registry.get("dalle_serving_decoded_tokens_total").value)
    assert decoded == 3 * IMG_SEQ + (0 if resume else len(snap))
    assert eng.stats.resume_dispatches == (1 if resume else 0)
    if paged:
        assert eng.kv.leak_check() == []
    b.shutdown()


def test_reserve_slots_hold_room_for_high(model):
    eng = _engine(model, max_batch=3)
    b = ContinuousBatcher(eng, reserve_slots=1)
    stepper = Stepper(eng)
    lows = [b.submit([_spec(i)], priority="low") for i in range(3)]
    assert stepper.entered.wait(10)
    stepper.until(lambda: b.allocator.n_active == 2)
    stepper.step(2)
    assert b.allocator.n_active == 2  # the third slot is the high class's
    with pytest.raises(QueueFullError, match="exceeds max batch 2"):
        b.submit([_spec(i) for i in range(3)], priority="low")
    high = b.submit([_spec(9)], priority="high")
    stepper.until(lambda: b.allocator.n_active == 3)  # the reserve, no preemption
    stepper.finish(lows + [high])
    for r in lows + [high]:
        _tokens(r)
    assert sum(r.preemptions for r in lows) == 0
    b.shutdown()


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
@pytest.mark.parametrize("how", ["cancel", "timeout"])
def test_cancel_and_timeout_mid_decode_release_the_slot(model, paged, how):
    eng = _engine(model, paged=paged)
    b = ContinuousBatcher(eng)
    stepper = Stepper(eng)
    req = b.submit([_spec(0)], timeout_s=0.3 if how == "timeout" else 120.0)
    assert stepper.entered.wait(10)
    stepper.until(lambda: req.first_token_at is not None)
    if how == "cancel":
        req.cancel()
    else:
        time.sleep(0.35)  # the deadline passes while the row decodes
    stepper.finish([req])
    with pytest.raises(RequestCancelled if how == "cancel" else RequestTimeout, match="mid-decode"):
        req.future.result(0)
    assert b.allocator.n_active == 0
    assert b.registry.get("dalle_serving_slots_active").value == 0
    name = "dalle_serving_cancelled_total" if how == "cancel" else "dalle_serving_timeouts_total"
    assert b.registry.get(name).value == 1
    if paged:
        assert eng.kv.leak_check() == []
    b.shutdown()


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_injected_chunk_failure_recovers_to_the_same_tokens(model, paged):
    specs = [_spec(77, (2, 4, 6, 8)), _spec(78, (1, 3, 5, 7))]
    refs = [_reference(model, s) for s in specs]
    eng = _engine(model, paged=paged)
    b = ContinuousBatcher(eng)
    eng.faults = FaultInjector().fail_nth("chunk", 3)
    reqs = [b.submit([s]) for s in specs]
    for r, ref in zip(reqs, refs):
        np.testing.assert_array_equal(_tokens(r), ref)
    assert eng.faults.fired[0]["program"] == "chunk"
    assert [r.dispatch_retries for r in reqs] == [1, 1]
    assert b.registry.get("dalle_serving_dispatch_retries_total").value == 2
    assert _family(b, "dalle_serving_resumptions_total") == {"dispatch_retry": 2}
    assert isinstance(b.last_error, InjectedFault) or b.last_error is None
    if paged:
        assert eng.kv.leak_check() == []
    b.shutdown()


def test_midwave_prefill_failure_leaves_the_pool_consistent(model):
    specs = [_spec(11, (9, 9, 1, 1)), _spec(22, (9, 9, 2, 2))]
    refs = [_reference(model, s) for s in specs]
    eng = _engine(model, paged=True, prefix_entries=0)
    b = ContinuousBatcher(eng)
    eng.faults = FaultInjector().fail_nth("prefill", 1)
    with b._cond:  # one admission wave for both
        reqs = [b.submit([s], priority="low") for s in specs]
    for r, ref in zip(reqs, refs):
        np.testing.assert_array_equal(_tokens(r), ref)
    assert [r.dispatch_retries for r in reqs] == [1, 1]
    assert eng.kv.leak_check() == []
    again = b.submit([_spec(33, (7, 7, 7, 7))])
    _tokens(again)
    assert eng.kv.leak_check() == []
    b.shutdown()


def test_fault_rules_match_the_reference():
    from dalle_pytorch_tpu.serving.faults import FaultInjector as JFaultInjector

    outcomes = []
    for cls in (FaultInjector, JFaultInjector):
        faults = cls().fail_nth("chunk", 2).fail_nth("prefill", 1).stall_nth("chunk", 4, seconds=0.01)
        seen = []
        for program in ("prefill", "chunk", "chunk", "chunk", "chunk", "prefill", "chunk"):
            try:
                faults.on_dispatch(program)
                seen.append("ok")
            except RuntimeError as exc:
                seen.append(type(exc).__name__)
        fired = [(f["program"], f["nth"], f["kind"]) for f in faults.fired]
        outcomes.append((seen, fired, faults.dispatches("chunk"), faults.dispatches("prefill")))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == ["InjectedFault", "ok", "InjectedFault", "ok", "ok", "ok", "ok"]


def test_stall_rule_delays_but_completes(model):
    eng = _engine(model)
    b = ContinuousBatcher(eng)
    release = threading.Event()
    eng.faults = FaultInjector().stall_nth("chunk", 2, seconds=30, until=release)
    req = b.submit([_spec(3, (6, 6, 6, 6))])
    _wait(lambda: eng.faults.dispatches("chunk") == 2)
    time.sleep(0.05)
    assert not req.future.done() and eng.faults.fired[0]["kind"] == "stall"  # parked in chunk 2
    release.set()
    np.testing.assert_array_equal(_tokens(req), _reference(model, _spec(3, (6, 6, 6, 6))))
    assert req.dispatch_retries == 0
    b.shutdown()


def test_exhausted_retry_fails_clean(model):
    eng = _engine(model, paged=True)
    b = ContinuousBatcher(eng)
    eng.faults = FaultInjector().fail_nth("prefill", 1).fail_nth("prefill", 2)
    req = b.submit([_spec(5)])
    with pytest.raises(InjectedFault):
        req.future.result(120)
    assert req.dispatch_retries == 1 and req.incidents == ["disp-000001", "disp-000002"]
    assert b.allocator.n_active == 0 and eng.kv.leak_check() == []
    _tokens(b.submit([_spec(6)]))  # the rules are spent: it serves again
    assert eng.kv.leak_check() == [] and b.last_error is None
    b.shutdown()


def _loaded(model, **kw):
    """A batcher whose two slots decode while the worker waits at a
    boundary, so what is submitted stays queued."""
    eng = _engine(model)
    b = ContinuousBatcher(eng, **kw)
    stepper = Stepper(eng)
    running = [b.submit([_spec(i)], priority="low", tenant=f"bg{i}") for i in range(2)]
    assert stepper.entered.wait(10)
    stepper.until(lambda: b.allocator.n_active == 2)
    return b, stepper, running


def test_tenant_quota_429(model):
    b, stepper, running = _loaded(model, tenant_quota_rows=2)
    queued = [b.submit([_spec(10 + i)], tenant="t") for i in range(2)]
    with pytest.raises(TenantQuotaError) as err:
        b.submit([_spec(12)], tenant="t")
    assert err.value.retry_after_s >= 1.0
    queued.append(b.submit([_spec(13)], tenant="other"))
    assert _family(b, "dalle_serving_shed_total") == {"quota": 1}
    stepper.finish(running + queued)
    b.shutdown()


@pytest.mark.parametrize("shed", [True, False])
def test_deadline_shed_503(model, shed):
    b, stepper, running = _loaded(model, deadline_shed=shed)
    b._chunk_ema = 0.5  # 8 chunks an image: 4 s an image
    reqs = []
    if shed:
        with pytest.raises(ShedError) as err:
            b.submit([_spec(10)], timeout_s=2.0)
        assert err.value.reason == "deadline" and 1.0 <= err.value.retry_after_s <= 60.0
        assert _family(b, "dalle_serving_shed_total") == {"deadline": 1}
    else:
        reqs.append(b.submit([_spec(10)], timeout_s=60.0))  # no cost model: queued
    reqs.append(b.submit([_spec(11)], timeout_s=120.0))  # meetable: queued
    stepper.finish(running + reqs)
    for r in reqs:
        _tokens(r)
    b.shutdown()
