"""The port's engine vitals, stall watchdog, SLO tracker and cost table
(CPU), against the JAX package's where the two share a contract.

* `StallWatchdog` and `SLOTracker`: both packages' fire on the same clock
  (each module's `time` swapped for one stepped clock) over the same
  snapshots and histogram observations: the same stall records, counters,
  burn rates and status; `EngineVitals.tick` samples the same fields from
  the same host-state stubs, its device seam stubbed.
* `ProgramCostTable`: the port counts each program's work at its warmup
  shape; the prefill, resume and chunk rows of the slotted, paged, int8
  and tensor-parallel (tp = 2, CPU mesh) engines equal an independent
  count from the configuration (linear weights, 4 * dim_head flops a
  visible pair a head, the logits head); the dVAE decode rows are counted
  by `torch.utils.flop_counter`; the peaks come from the device name (the
  H100 SXM / PCIe / NVL rates), never a TPU constant, and a device with no
  peak has no MFU; only synced walls export MFU; launches accumulate.
* The serving surfaces: `/debug/vitals`, `/debug/programs`, /healthz's
  degraded tier from a stall and from SLO burn, the burn fed to the
  continuous batcher (its shed reason `slo_burn`), and the crash rule.
"""

import json
import types
import urllib.error
import urllib.request

import pytest
import torch

from dalle_pytorch_tpu.obs import vitals as jvitals
from dalle_pytorch_tpu.serving.faults import FaultInjector as JFaultInjector
from dalle_pytorch_tpu.training.metrics import MetricsRegistry as JRegistry
from dalle_pytorch_tpu_torch.data.tokenizer import ByteTokenizer
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
from dalle_pytorch_tpu_torch.obs import vitals as pvitals
from dalle_pytorch_tpu_torch.serving.engine import ContinuousEngine, PagedContinuousEngine
from dalle_pytorch_tpu_torch.serving.faults import FaultInjector
from dalle_pytorch_tpu_torch.serving.server import ServingServer
from dalle_pytorch_tpu_torch.serving.sharded import ShardedContinuousEngine
from dalle_pytorch_tpu_torch.training.metrics import MetricsRegistry

torch.set_num_threads(2)

TINY = dict(dim=32, depth=2, heads=2, dim_head=16, num_image_tokens=32, image_fmap_size=4, num_text_tokens=257,
            text_seq_len=8, attn_types=("full",), shift_tokens=True, rotary_emb=True)
VAE = dict(image_size=32, num_layers=3, num_tokens=32, codebook_dim=16, hidden_dim=8)
SIDES = {"jax": (jvitals, JRegistry), "port": (pvitals, MetricsRegistry)}


@pytest.fixture
def clock(monkeypatch):
    """One stepped clock for both modules' `time.monotonic`."""
    now = types.SimpleNamespace(t=500.0)
    fake = types.SimpleNamespace(monotonic=lambda: now.t, time=lambda: 1.7e9 + now.t,
                                 perf_counter=lambda: now.t)
    for module, _ in SIDES.values():
        monkeypatch.setattr(module, "time", fake)
    return now


def _scrub(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


def _exposition(registry, prefix):
    """Sample and TYPE lines (the port's HELP texts name its own devices)."""
    return sorted(ln for ln in registry.render().splitlines() if prefix in ln and not ln.startswith("# HELP"))


SNAPSHOTS = [
    {"dispatch_inflight": {"program": "chunk", "age_s": 0.01}, "queue_head_age_s": 0.2, "chunk_index": 7,
     "slots_active": 2},
    {"dispatch_inflight": {"program": "chunk", "age_s": 2.0}},
    {"dispatch_inflight": {"program": "chunk", "age_s": 2.0}},
    {"dispatch_inflight": {"program": "generate:8", "age_s": 45.0, "first": True}},
    {"queue_head_age_s": 3.0, "queue_depth_rows": 9},
    {"chunk_index": 5, "slots_active": 3},
    {"chunk_index": 5, "slots_active": 3},
    {"chunk_index": 5, "slots_active": 3},
    {"chunk_index": 6, "slots_active": 3},
]


@pytest.mark.parametrize("cooldown", [0.0, 2.5, 60.0])
def test_watchdogs_fire_alike_on_one_clock(clock, cooldown):
    seen = {}
    for side, (module, registry) in SIDES.items():
        clock.t = 500.0
        reg = registry()
        wd = module.StallWatchdog(dispatch_mult=4.0, dispatch_min_s=0.05, queue_age_budget_s=1.0,
                                  no_progress_ticks=2, cooldown_s=cooldown, first_dispatch_budget_s=30.0,
                                  registry=reg)
        fired = []
        for snap in SNAPSHOTS * 2:
            fired.append(_scrub(wd.check(snap, {"chunk": 0.02})))
            clock.t += 1.0
        seen[side] = (fired, wd.stalls_fired, _scrub(wd.recent_stalls()), wd.last_stall_age_s(),
                      _exposition(reg, "stalls"))
    assert seen["port"] == seen["jax"]
    assert seen["port"][1] > 0


@pytest.mark.parametrize("threshold, objective, window", [(0.25, 0.9, 300.0), (0.3, 0.99, 2.5), (5.0, 0.5, 10.0)])
def test_slo_trackers_burn_alike(clock, threshold, objective, window):
    values = [0.01, 0.2, 0.4, 0.03, 1.5, 0.3, 0.26, 7.0, 0.02]
    seen = {}
    for side, (module, registry) in SIDES.items():
        clock.t = 500.0
        reg = registry()
        hist = reg.histogram("dalle_serving_request_latency_seconds", "latency")
        tracker = module.SLOTracker([module.SLOTarget("request", threshold, hist.name, objective=objective),
                                     module.SLOTarget("ttft", 0.1, "dalle_serving_ttft_seconds")],
                                    registry=reg, window_s=window)
        steps = []
        for i, v in enumerate(values):
            hist.observe(v)
            tracker.update()
            steps.append((tracker.burning(), tracker.max_burn()))
            clock.t += 1.5 if i % 2 else 0.5
        seen[side] = (steps, tracker.status(), _exposition(reg, "burn"))
    assert seen["port"] == seen["jax"]


class _Alloc:
    n_active = 3


class _Batcher:
    queue_depth_rows = 5
    allocator = _Alloc()

    def head_age_s(self):
        return 1.25

    def class_depths(self):
        return {"high": 1, "normal": 4, "low": 0}


class _Kv:
    blocks_active, blocks_free, cache = 11, 29, [1, 2]


def test_sampler_ticks_alike(clock):
    seen = {}
    for side, (module, registry) in SIDES.items():
        reg = registry()

        class Stub(module.EngineVitals):
            def _device_memory_stats(self, *device):
                return {"bytes_in_use": 12345, "peak_bytes_in_use": 23456}

        vit = Stub(interval_s=60.0, registry=reg, watchdog=module.StallWatchdog(registry=reg, queue_age_budget_s=1.0))
        vit.bind(engine=types.SimpleNamespace(chunk_index=7, kv=_Kv()), batcher=_Batcher())
        vit.dispatch_begin("chunk")
        clock.t += 0.5
        snap = vit.tick()
        vit.dispatch_end("chunk", 0.5)
        snap2 = vit.tick()
        seen[side] = ({k: v for k, v in snap.items() if k not in ("ts", "compile_count")},
                      {k: v for k, v in snap2.items() if k not in ("ts", "compile_count")},
                      vit.window_summary(), vit.degraded_reasons(), _exposition(reg, "dalle_serving_"))
    assert seen["port"] == seen["jax"]
    assert seen["port"][0]["memory_stats"]["bytes_in_use"] == 12345 and seen["port"][3] == ["stall:queue_head_stale"]


def test_disabled_vitals_start_nothing():
    vit = pvitals.EngineVitals(enabled=False, registry=MetricsRegistry())
    engine = types.SimpleNamespace(vitals=pvitals.NULL_VITALS)
    vit.bind(engine=engine).start()
    assert vit._thread is None and vit.samples_taken == 0 and engine.vitals is pvitals.NULL_VITALS
    assert not pvitals.NULL_VITALS


# ------------------------------------------------------------ cost table


@pytest.mark.parametrize("name, flops, bps", [
    ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12), ("NVIDIA H100 PCIe", 756e12, 2.0e12),
    ("NVIDIA H100 NVL", 835e12, 3.9e12), ("cpu", None, None), (None, None, None), ("NVIDIA A100-SXM4-80GB", None, None),
])
def test_peaks_come_from_the_device_name(name, flops, bps):
    table = pvitals.ProgramCostTable(device_name=name)
    assert (table.peak_flops, table.hbm_bps) == (flops, bps)
    assert table.peak_flops not in (jvitals.V5E_PEAK_FLOPS,) and table.hbm_bps != jvitals.V5E_HBM_BPS
    assert not any("V5E" in n for n in dir(pvitals))


def test_mfu_only_from_synced_walls_and_launches_accumulate():
    reg = MetricsRegistry()
    table = pvitals.ProgramCostTable(peak_flops=1e12, hbm_bps=1e11, registry=reg)
    table.add("chunk", 2e9, 4e8, memory={"peak_allocated_bytes": 7}, launches={"k.launches": 8})
    table.add("prefill", 1e10, 1e9)
    table.record_wall("prefill", 0.01, synced=False, launches={"k.tile_launches": 2})
    assert table.mfu("prefill") is None and "mfu" not in table.rows()[1]
    for wall in (0.01, 0.03):
        table.record_wall("chunk", wall, synced=True, launches={"k.launches": 8})
    row = {r["program"]: r for r in table.rows()}["chunk"]
    ema = 0.8 * 0.01 + 0.2 * 0.03
    assert row["mfu"] == float(f"{min(1.0, 2e9 / (ema * 1e12)):.4g}") and row["dispatches"] == 2
    assert row["launches"] == {"k.launches": 16} and row["launches_per_dispatch"] == {"k.launches": 8}
    assert reg.get("dalle_serving_mfu").labels("chunk").value == pytest.approx(2e9 / (ema * 1e12))
    table.record_wall("unknown", 1.0)
    nopeak = pvitals.ProgramCostTable(device_name="cpu", registry=MetricsRegistry())
    nopeak.add("chunk", 1.0, 1.0)
    nopeak.record_wall("chunk", 0.1)
    assert nopeak.mfu("chunk") is None and "mfu" not in nopeak.rows()[0] and nopeak.rows()[0]["hbm_gbps"] > 0


def independent_flops(cfg, slots, chunk, positions):
    """The count from the configuration: 2 flops a weight a position
    (qkv, out, GEGLU in and out), 4 * dim_head a head a visible pair, 2 *
    dim * vocabulary a logits row; `positions` the warmup chunk's image
    positions at its start (None: an idle slot at 0)."""
    dim, depth, heads, dh = cfg["dim"], cfg["depth"], cfg["heads"], cfg["dim_head"]
    inner, hidden = heads * dh, 4 * dim
    text, seq = cfg["text_seq_len"] + 1, cfg["image_fmap_size"] ** 2
    vocab = cfg["num_text_tokens"] + cfg["text_seq_len"] + cfg["num_image_tokens"]
    token = depth * 2 * (dim * 3 * inner + inner * dim + dim * 2 * hidden + hidden * dim)
    pair, logit = depth * 4 * dh * heads, 2 * dim * vocab

    def forward(n):
        return slots * (n * token + n * (n + 1) // 2 * pair + logit)

    steps = 0
    for t in range(chunk):
        pos = [0 if p is None else min(p + t, seq) for p in positions]
        steps += len(pos) * (token + logit) + sum(text + p + 1 for p in pos) * pair
    return {"prefill": forward(text), "resume": forward(text + seq - 1), "chunk": steps}


def _engine(kind, model, vae=None, **kw):
    common = dict(max_batch=4, chunk_tokens=2, prefill_batch=4, tokenizer=ByteTokenizer(), device="cpu",
                  resume_enabled=True, preview_enabled=vae is not None)
    if kind == "paged":
        return PagedContinuousEngine(model, vae, page_size=4, **common, **kw)
    if kind == "tp2":
        return ShardedContinuousEngine(model, vae, mesh="tp=2", **common, **kw)
    return ContinuousEngine(model, vae, **common, **kw)


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return DALLE(**TINY, attn_impl="flash").eval()


@pytest.mark.parametrize("kind, kw", [("slot", {}), ("paged", {}), ("slot", {"kv_dtype": "int8"}), ("tp2", {})])
def test_cost_rows_equal_an_independent_count(model, kind, kw):
    cfg = TINY
    if kind == "tp2":  # a vocabulary tp = 2 splits (an indivisible one stays whole on each shard)
        cfg = dict(TINY, num_text_tokens=256)
        torch.manual_seed(0)
        model = DALLE(**cfg, attn_impl="flash").eval()
    eng = _engine(kind, model, **kw)
    eng.cost_table = pvitals.ProgramCostTable(peak_flops=1e12, registry=MetricsRegistry())
    eng.warmup()
    rows = {r["program"]: r for r in eng.cost_table.rows()}
    # the slotted warmup: slot 0 prefilled at 0, slot 1 resumed at 1, the
    # others idle; the paged one: slot 1 a prefix hit at 0, slot 2 resumed
    positions = [0, 1, None, None] if kind != "paged" else [0, 0, 1, None]
    want = independent_flops(cfg, 4, 2, positions)
    assert {p: rows[p]["flops"] for p in want} == want
    assert all("error" not in r for r in rows.values())
    kv = 2 * TINY["heads"] * TINY["dim_head"] * TINY["depth"] * (1 if kw else 4)
    if kw:
        kv += 2 * TINY["heads"] * 4 * TINY["depth"]
    assert eng.decode_work().kv_bytes == kv
    assert all(r["launches_per_dispatch"] == {} for r in rows.values())  # no kernel launches on the CPU


@pytest.mark.parametrize("shared", [{}, {"shared_attn_ids": (0, 0), "shared_ff_ids": (0, 0)}])
def test_decode_work_reads_the_distinct_weights_once(shared):
    """The config count's weight bytes are the model's distinct matrix
    and logits weights, a layer that shared ids repeat read once."""
    torch.manual_seed(0)
    m = DALLE(**TINY, **shared).to(torch.bfloat16)
    eng = ContinuousEngine(m, None, max_batch=2, chunk_tokens=2, tokenizer=ByteTokenizer(), device="cpu")
    tr = m.transformer
    linears = [a.to_qkv.weight for a in tr.attn.values()] + [a.to_out.weight for a in tr.attn.values()]
    linears += [f.dense_0.weight for f in tr.ff.values()] + [f.dense_1.weight for f in tr.ff.values()]
    want = sum(w.numel() * w.element_size() for w in linears) + m.logits_dense.weight.numel() * 2
    assert eng.decode_work().weight_bytes == want
    assert eng.decode_work().token_flops == 2 * m.depth * sum(w.numel() for w in linears) / len(tr.attn)


def test_dvae_rows_counted_by_the_flop_counter(model):
    vae = DiscreteVAE(**VAE).eval()
    eng = _engine("slot", model, vae)
    eng.cost_table = pvitals.ProgramCostTable(peak_flops=1e12)
    eng.warmup()
    rows = {r["program"]: r for r in eng.cost_table.rows()}
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.inference_mode():
        vae.decode(torch.zeros(4, 16, dtype=torch.long))
    assert rows["decode_pixels"]["flops"] == rows["preview"]["flops"] == counter.get_total_flops() > 0
    assert set(rows) == {"prefill", "resume", "chunk", "decode_pixels", "preview"}


def test_engine_brackets_feed_the_dispatch_clock(model):
    eng = _engine("slot", model)
    seen = []

    class Clock:
        enabled = True

        def dispatch_begin(self, name):
            seen.append(("begin", name))

        def dispatch_end(self, name, seconds):
            seen.append(("end", name))

    eng.vitals = Clock()
    eng.warmup()
    names = [n for kind, n in seen if kind == "begin"]
    assert names == ["prefill", "resume", "chunk", "release"]
    assert seen.count(("end", "chunk")) == 1


# ------------------------------------------------------- serving surfaces


def _get(port, path):
    try:
        resp = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60)
    except urllib.error.HTTPError as err:
        resp = err
    with resp:
        return resp.status, json.loads(resp.read())


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        resp = urllib.request.urlopen(req, timeout=120)
    except urllib.error.HTTPError as err:
        resp = err
    with resp:
        return resp.status, json.loads(resp.read())


def test_server_vitals_surfaces_and_degraded_tier(model):
    eng = _engine("slot", model)
    eng.registry = reg = MetricsRegistry()
    eng.cost_table = pvitals.ProgramCostTable(peak_flops=1e12, registry=reg)
    eng.warmup()

    class Stub(pvitals.EngineVitals):
        def _device_memory_stats(self, *device):
            return {"bytes_in_use": 4096}

    slo = pvitals.SLOTracker([pvitals.SLOTarget("request", 0.005, "dalle_serving_request_latency_seconds")],
                             registry=reg)
    vitals = Stub(interval_s=60.0, registry=reg, watchdog=pvitals.StallWatchdog(registry=reg), slo=slo)
    server = ServingServer(eng, port=0, vitals=vitals).start()
    try:
        assert eng.vitals is vitals and server.batcher.slo_burn == slo.max_burn
        assert _get(server.port, "/healthz")[1]["status"] == "ok"
        status, payload = _post(server.port, {"prompt": "x", "seed": 1})
        assert status == 200
        vitals.tick()
        status, detail = _get(server.port, "/debug/vitals?n=1")
        assert status == 200 and detail["samples_taken"] == 1 and len(detail["samples"]) == 1
        assert detail["device"] == {"type": "cpu", "name": "cpu"} and detail["samples"][0]["memory_stats"]
        assert _get(server.port, "/debug/vitals?n=0")[0] == 400
        status, programs = _get(server.port, "/debug/programs")
        rows = {r["program"]: r for r in programs["programs"]}
        assert status == 200 and rows["chunk"]["dispatches"] > 0 and 0 < rows["chunk"]["mfu"] <= 1
        # every request is over 5 ms: the budget burns, /healthz degrades (still 200)
        status, health = _get(server.port, "/healthz")
        assert status == 200 and health["status"] == "degraded" and health["degraded_reasons"] == ["slo_burn:request"]
        assert server.batcher._burn_factor() == 4.0
        vitals.watchdog.check({"queue_head_age_s": None, "dispatch_inflight": {"program": "chunk", "age_s": 99.0}},
                              {"chunk": 0.01})
        assert "stall:dispatch_stuck" in _get(server.port, "/healthz")[1]["degraded_reasons"]
    finally:
        server.shutdown()
    assert vitals._thread is None


def test_burning_budget_sheds_earlier(model):
    eng = _engine("slot", model)
    eng.warmup()
    server = ServingServer(eng, port=0).start()
    try:
        batcher = server.batcher
        batcher._chunk_ema = 0.01  # a measured basis: 8 chunks an image
        req = types.SimpleNamespace(timeout_s=0.25)
        assert batcher._shed_check(req) is None
        batcher.slo_burn = lambda: 20.0
        shed = batcher._shed_check(req)
        assert shed is not None and shed.reason == "slo_burn" and "burn factor 4.00" in str(shed)
        batcher.slo_burn = lambda: (_ for _ in ()).throw(RuntimeError("broken source"))
        assert batcher._burn_factor() == 1.0
    finally:
        server.shutdown()


def test_crash_rule_matches_the_reference():
    seen = {}
    for side, cls in (("port", FaultInjector), ("jax", JFaultInjector)):
        inj = cls().crash_nth("chunk", 3, exit_code=71).fail_nth("prefill", 1)
        aborted = []
        inj._abort = lambda program, nth, code: aborted.append((program, nth, code))
        for _ in range(4):
            inj.on_dispatch("chunk")
        with pytest.raises(Exception):
            inj.on_dispatch("prefill")
        seen[side] = (aborted, [{k: v for k, v in f.items() if k != "exc"} for f in inj.fired],
                      inj.dispatches("chunk"))
    assert seen["port"] == seen["jax"] == ([("chunk", 3, 71)], seen["jax"][1], 4)


def test_serve_twin_arms_the_crash_rule(monkeypatch):
    from dalle_pytorch_tpu_torch import serve

    engine, events = types.SimpleNamespace(faults=None), []
    log = types.SimpleNamespace(event=lambda name, **kw: events.append((name, kw)))
    monkeypatch.setenv("DALLE_SERVE_CRASH", "chunk:3")
    serve.arm_crash(engine, log)
    assert engine.faults._rules == {"chunk": {3: {"kind": "crash", "exit_code": 70}}}
    assert events == [("chaos_crash_armed", {"program": "chunk", "nth": 3})]
    monkeypatch.delenv("DALLE_SERVE_CRASH")
    engine.faults = None
    serve.arm_crash(engine, log)
    assert engine.faults is None
