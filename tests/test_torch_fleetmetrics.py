"""The port's fleet telemetry plane and exposition parser against the JAX
package's (CPU).

* `parse_exposition`: both parsers read the port server's real `/metrics`
  body (classic and OpenMetrics, after traffic, vitals and the cost table
  on) into the same families, types, help and samples; both refuse the
  same malformed bodies; `counter_delta`, `merge_histogram_points` and
  `render_histogram_point` agree.
* `FleetScraper`: both scrapers, on the same stepped clock, fed the same
  replica bodies through their `_fetch` seam (the real bodies of two port
  replicas, then a counter reset, a garbage body and a dead replica),
  agree on generations, staleness, reset-corrected totals, the federated
  `/fleet/metrics` body, the `/debug/fleet` view and the capacity report;
  `CapacityModel.assess` and `UsageLedger` agree on synthetic input.
* The port's addition: each sweep reads the replicas' `/debug/programs`
  and hands the usage ledger the fleet's FLOP rate per card, counted FLOPs
  over synced EMA walls weighted by dispatches.
"""

import json
import urllib.error
import urllib.request

import pytest
import torch

from dalle_pytorch_tpu.obs import fleetmetrics as jfm
from dalle_pytorch_tpu.training import metrics as jm
from dalle_pytorch_tpu_torch.data.tokenizer import ByteTokenizer
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.obs import fleetmetrics as pfm
from dalle_pytorch_tpu_torch.obs.vitals import EngineVitals, ProgramCostTable, SLOTarget, SLOTracker, StallWatchdog
from dalle_pytorch_tpu_torch.serving.engine import ContinuousEngine
from dalle_pytorch_tpu_torch.serving.server import ServingServer
from dalle_pytorch_tpu_torch.training import metrics as pm

torch.set_num_threads(2)

TINY = dict(dim=32, depth=2, heads=2, dim_head=16, num_image_tokens=32, image_fmap_size=4, num_text_tokens=257,
            text_seq_len=8, attn_types=("full",), shift_tokens=True, rotary_emb=True)


def _get(port, path):
    try:
        resp = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60)
    except urllib.error.HTTPError as err:
        resp = err
    with resp:
        return resp.status, resp.read()


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


@pytest.fixture(scope="module")
def bodies():
    """The /metrics (both flavours), /healthz, /debug/vitals and
    /debug/programs bodies of two port replicas after traffic, each with
    vitals, an SLO tracker and a cost table with a given peak."""
    torch.manual_seed(0)
    model = DALLE(**TINY, attn_impl="flash").eval()
    out = []
    for r in range(2):
        eng = ContinuousEngine(model, None, max_batch=2, chunk_tokens=2, prefill_batch=2, tokenizer=ByteTokenizer(),
                               device="cpu", resume_enabled=True)
        eng.registry = reg = pm.MetricsRegistry()
        eng.cost_table = ProgramCostTable(peak_flops=1e12, hbm_bps=1e11, registry=reg)
        eng.warmup()
        vitals = EngineVitals(interval_s=60, registry=reg, watchdog=StallWatchdog(registry=reg),
                              slo=SLOTracker([SLOTarget("request", 0.5, "dalle_serving_request_latency_seconds")],
                                             registry=reg))
        server = ServingServer(eng, port=0, vitals=vitals).start()
        try:
            for s in range(2 + r):
                _post(server.port, {"prompt": "fleet", "seed": s, "tenant": f"t{s}"})
            vitals.tick()
            out.append({path: _get(server.port, path)[1] for path in (
                "/metrics", "/metrics?exemplars=1", "/healthz", "/debug/vitals?n=1", "/debug/programs")})
        finally:
            server.shutdown()
    return out


def _families(parsed):
    return {
        name: (f.type, f.help, [(s.name, s.labels, s.value) for s in f.samples])
        for name, f in sorted(parsed.items())
    }


@pytest.mark.parametrize("flavour", ["/metrics", "/metrics?exemplars=1"])
def test_parsers_agree_on_the_port_servers_exposition(bodies, flavour):
    for replica in bodies:
        text = replica[flavour].decode()
        port, jax_ = pm.parse_exposition(text), jm.parse_exposition(text)
        assert _families(port) == _families(jax_)
        chunks = "dalle_serving_chunks" if "exemplars" in flavour else "dalle_serving_chunks_total"
        assert {"dalle_serving_mfu", chunks, "dalle_slo_burn_rate"} <= set(port)
        hist = port["dalle_serving_request_latency_seconds"]
        assert hist.histogram_series() == jax_["dalle_serving_request_latency_seconds"].histogram_series()


@pytest.mark.parametrize("text", [
    "foo{a=\"1\" 3\n", "foo\n", "foo{a=1} 2\n", "foo bar\n", "9bad 1\n", "foo{a=\"x\"} 1 2 3\n",
])
def test_parsers_refuse_the_same_malformed_bodies(text):
    with pytest.raises(ValueError):
        jm.parse_exposition(text)
    with pytest.raises(ValueError):
        pm.parse_exposition(text)


def test_histogram_and_counter_helpers_agree():
    for prev, cur in ((None, 5.0), (3.0, 7.5), (9.0, 2.0), (4.0, 4.0)):
        assert pm.counter_delta(prev, cur) == jm.counter_delta(prev, cur)
    pts = [{"bounds": [0.1, 1.0], "cum": [1, 3], "count": 4, "sum": 2.5},
           {"bounds": [0.5, 1.0, 5.0], "cum": [2, 2, 6], "count": 7, "sum": 9.0}, None]
    assert pm.merge_histogram_points(pts) == jm.merge_histogram_points(pts)
    merged = pm.merge_histogram_points(pts)
    assert pm.render_histogram_point("h", merged, 'replica="a"') == jm.render_histogram_point("h", merged, 'replica="a"')
    assert pm.render_histogram_point("h", merged) == jm.render_histogram_point("h", merged)


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _scraper(module, served, clock, registry, usage=None):
    scraper = module.FleetScraper([("a", "http://a"), ("b", "http://b")], registry=registry, usage=usage,
                                  time_fn=clock, interval_s=1.0)

    def fetch(url, path):
        body = served[url[len("http://"):]].get(path)
        if body is None or isinstance(body, Exception):
            raise body or urllib.error.HTTPError(url + path, 404, "no such path", None, None)
        return body

    scraper._fetch = fetch
    return scraper


def _view(scraper):
    detail = scraper.fleet_detail()
    for entry in detail["replicas"].values():
        entry.pop("age_s", None)
    return dict(federated=scraper.federated_render(), detail=detail, capacity=scraper.capacity_report(),
                totals=scraper.fleet_totals("dalle_serving_decoded_tokens_total"),
                snapshot={n: (s.generation, s.stale, s.error is not None) for n, s in scraper.snapshot().items()})


def test_scrapers_agree_through_resets_garbage_and_death(bodies):
    served = {"a": dict(bodies[0]), "b": dict(bodies[1])}
    clock = Clock()
    sides = {
        "port": _scraper(pfm, served, clock, pm.MetricsRegistry()),
        "jax": _scraper(jfm, served, clock, jm.MetricsRegistry()),
    }
    views = []
    for step in range(5):
        if step == 2:  # b restarted: its counters start again from its first body
            served["b"]["/metrics"] = bodies[0]["/metrics"]
        if step == 3:  # a garbage exposition body and a dead replica
            served["a"]["/metrics"] = b"dalle_serving_chunks_total{oops 3\n"
            served["b"] = {}
        for scraper in sides.values():
            scraper.scrape_once()
        clock.t += 1.0
        views.append({side: _view(s) for side, s in sides.items()})
    for view in views:
        assert view["port"] == view["jax"]
    assert views[-1]["port"]["snapshot"] == {"a": (3, True, True), "b": (3, True, True)}
    fed = pm.parse_exposition(views[1]["port"]["federated"])
    assert {s.labels["replica"] for s in fed["dalle_serving_chunks_total"].samples} == {"a", "b"}
    assert "dalle_serving_chunks_total:fleet_sum" in fed


def _assess_inputs(module):
    scrapes = {}
    for name, mfu, health, stale in (
        ("a", 0.07, {"status": "ok", "queue_depth_rows": 3, "slots_active": 2,
                     "work": {"max_batch": 4, "warmup_batches": 1, "image_seq_len": 16},
                     "slo": [{"burn_rate": 0.4}]}, False),
        ("b", None, {"status": "degraded", "queue_depth_rows": "junk", "slots_active": 4,
                     "work": {"max_batch": 4}, "slo": [{"burn_rate": 1.7}]}, False),
        ("c", 0.3, {"status": "ok"}, True),
    ):
        s = module.ReplicaScrape(name, "http://" + name)
        s.stale, s.generation, s.health = stale, 3, health
        if mfu is not None:
            text = f'# TYPE dalle_serving_mfu gauge\ndalle_serving_mfu{{program="chunk"}} {mfu}\n'
            s.families = (pm if module is pfm else jm).parse_exposition(text)
        scrapes[name] = s
    return scrapes


@pytest.mark.parametrize("decoded, useful", [(0.0, 0), (400.0, 300), (100.0, 500)])
def test_capacity_model_agrees(decoded, useful):
    usage = {"totals": {"decoded_tokens": useful}}
    got = [
        m.CapacityModel.assess(_assess_inputs(m), fleet_decoded_tokens=decoded, fleet_resumed_tokens=8.0, usage=usage)
        for m in (pfm, jfm)
    ]
    assert got[0] == got[1]


def test_usage_ledgers_agree_and_bound_tenants():
    ledgers = [m.UsageLedger(registry=r(), max_tenants=3) for m, r in ((pfm, pm.MetricsRegistry),
                                                                       (jfm, jm.MetricsRegistry))]
    for led in ledgers:
        led.note_flops_rate(2.5e9)
        for i, tenant in enumerate(["a", "b", "b", "c/d!", "e", "f", None]):
            led.record(tenant, ["high", "normal", "low"][i % 3], rows=1 + i % 2, wall_s=0.25 * (i + 1),
                       decoded_tokens=16, resumed_tokens=i)
    assert ledgers[0].summary() == ledgers[1].summary()
    assert "__other__" in {r["tenant"] for r in ledgers[0].summary()["tenants"]}


def test_port_scraper_feeds_the_flop_rate_from_the_programs(bodies):
    served = {"a": dict(bodies[0]), "b": dict(bodies[1])}
    usage = pfm.UsageLedger()
    scraper = _scraper(pfm, served, Clock(), pm.MetricsRegistry(), usage=usage)
    scraper.scrape_once()
    rates = []
    for replica in bodies:
        rows = [r for r in json.loads(replica["/debug/programs"])["programs"] if r.get("wall_includes_sync")]
        flops = sum(r["flops"] * r["dispatches"] for r in rows)
        wall = sum(r["wall_ema_ms"] / 1e3 * r["dispatches"] for r in rows)
        rates.append(flops / wall)
    assert rates[0] > 0 and usage.summary()["flops_per_chip_second"] == pytest.approx(sum(rates) / 2, rel=1e-12)
    served["a"].pop("/debug/programs")  # a replica without a cost table: the others' rate
    scraper.scrape_once()
    assert usage.summary()["flops_per_chip_second"] == pytest.approx(rates[1], rel=1e-12)
    # the JAX scraper never reads the programs (its ledger stays at 0)
    jusage = jfm.UsageLedger()
    _scraper(jfm, served, Clock(), jm.MetricsRegistry(), usage=jusage).scrape_once()
    assert jusage.summary()["flops_per_chip_second"] == 0.0


def test_fleet_endpoints_on_the_port_router(bodies):
    """The port's RouterServer serves /fleet/metrics, /debug/fleet and
    /debug/usage from its scraper and ledger."""
    from dalle_pytorch_tpu_torch.serving.router import FleetRouter, RouterServer

    router = FleetRouter(["a=http://127.0.0.1:9", "b=http://127.0.0.1:10"], registry=pm.MetricsRegistry())
    served = {"127.0.0.1:9": dict(bodies[0]), "127.0.0.1:10": dict(bodies[1])}
    scraper = pfm.FleetScraper([(r.name, r.url) for r in router.replicas], registry=router.registry,
                               usage=router.usage, interval_s=60)

    def fetch(url, path):
        return served[url[len("http://"):]][path]

    scraper._fetch = fetch
    scraper.scrape_once()
    front = RouterServer(router, port=0, probes=False, fleet=scraper).start()
    try:
        status, text = _get(front.port, "/fleet/metrics")
        fams = pm.parse_exposition(text.decode())
        assert status == 200 and "dalle_serving_mfu" in fams and "dalle_fleet_scrape_stale" in fams
        status, raw = _get(front.port, "/debug/fleet")
        fleet = json.loads(raw)
        assert status == 200 and all(r.get("mfu_headroom") is not None for r in fleet["capacity"]["replicas"].values())
        status, raw = _get(front.port, "/debug/usage")
        assert status == 200 and json.loads(raw)["flops_per_chip_second"] > 0
    finally:
        front.shutdown()
