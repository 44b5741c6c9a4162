"""The port's serving command line end to end (CPU), as
`tests/test_serving_e2e.py::TestServeCliEndToEnd` drives the reference's.

A tiny checkpoint written by the port (`training/pipeline.py:
save_dalle_checkpoint`, its dVAE inside; the config names no vocabulary,
so the default one serves) is served by `python -m
dalle_pytorch_tpu_torch.serve --device cpu --port 0`: the readiness line,
/healthz, two concurrent /generate requests coalesced into one batch, the
trace dump and a clean exit 0 on SIGTERM. Without `--device cpu` and with
no card it fails and names the card; the reference's refused combinations
of the fleet, vitals and tracing flags are refused by the parser. One CPU
boot with `--compile_cache`, `--profile_dir` and `--trace_export` shows
each wired: the cache's plan in /debug/state, a profile written under the
directory, the request's trace in the collector.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from dalle_pytorch_tpu_torch.data.tokenizer import get_tokenizer
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
from dalle_pytorch_tpu_torch.serve import parse_args
from dalle_pytorch_tpu_torch.training.pipeline import dalle_config, dvae_hparams, save_dalle_checkpoint
from dalle_pytorch_tpu_torch.weights import export_dvae_params

REPO = Path(__file__).resolve().parent.parent
VAE = dict(image_size=32, num_layers=3, num_tokens=32, codebook_dim=16, hidden_dim=8)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    torch.manual_seed(0)
    vocab = get_tokenizer().vocab_size
    model = DALLE(dim=32, depth=1, heads=2, dim_head=16, num_image_tokens=32, image_fmap_size=4,
                  num_text_tokens=vocab, text_seq_len=8, attn_impl="flash")
    vae = DiscreteVAE(**VAE)
    path = tmp_path_factory.mktemp("serve") / "dalle.npz"
    save_dalle_checkpoint(str(path), dalle_config(model, bf16=False), model,
                          vae_params=export_dvae_params(vae), vae_hparams=dvae_hparams(vae))
    return path


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        return resp.status, resp.read().decode()


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def _scrape(text, name):
    return float(next(ln for ln in text.splitlines() if ln.startswith(name + " ")).split()[1])


def _serve(checkpoint, *flags, cwd):
    return subprocess.Popen(
        [sys.executable, "-m", "dalle_pytorch_tpu_torch.serve", "--dalle_path", str(checkpoint), *flags],
        cwd=cwd, env={**os.environ, "PYTHONPATH": str(REPO)}, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )


def test_serve_cli_on_the_cpu(checkpoint, tmp_path):
    trace_dump = tmp_path / "traces.json"
    proc = _serve(checkpoint, "--device", "cpu", "--port", "0", "--batch_shapes", "1,2",
                  "--max_delay_ms", "2000", "--trace_dump", str(trace_dump), cwd=tmp_path)
    try:
        lines, port = [], None
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "listening on" in line:
                port = int(line.split("http://")[1].split()[0].rsplit(":", 1)[1])
                break
        assert port is not None, "".join(lines)
        assert "engine=micro" in lines[-1] and "device=cpu" in lines[-1]
        assert any('"event": "warmup_done"' in ln for ln in lines)
        status, body = _get(port, "/healthz")
        assert status == 200 and json.loads(body)["status"] == "ok"

        results = {}
        threads = [
            threading.Thread(target=lambda s=s: results.setdefault(s, _post(port, {"prompt": "red", "seed": s})))
            for s in (1, 2)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for s in (1, 2):
            status, payload = results[s]
            assert status == 200 and payload["shape"] == [1, 32, 32, 3] and len(payload["tokens"][0]) == 16
        status, text = _get(port, "/metrics")
        assert _scrape(text, "dalle_serving_requests_total") == 2
        assert _scrape(text, "dalle_serving_batches_total") == 1  # coalesced
        assert _scrape(text, "dalle_serving_batch_occupancy_rows_sum") == 2
        status, body = _get(port, "/debug/traces")
        live = json.loads(body)
        assert any(e.get("name") == "generate" for e in live["traceEvents"])

        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "draining queue and shutting down" in out and "[serve] shutdown complete" in out
        requests = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
        assert sum(1 for r in requests if r.get("event") == "request" and r["status"] == 200) == 2
        dumped = json.loads(trace_dump.read_text())
        assert len(dumped["traceEvents"]) >= len(live["traceEvents"])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the failure on a machine with no card")
def test_serve_cli_without_a_card_names_it(checkpoint, tmp_path):
    proc = _serve(checkpoint, "--port", "0", cwd=tmp_path)
    out, _ = proc.communicate(timeout=240)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in out and "NVIDIA GPU" in out
    assert "listening on" not in out


@pytest.mark.parametrize("flags", [
    ["--router"], ["--replicas", "http://a"], ["--supervise", "--port", "0"], ["--spool_notify", "http://n"],
    ["--trace_export", "http://c", "--no_tracing"], ["--no_vitals", "--slo_ttft_ms", "500"],
    ["--slo_ttft_ms", "500", "--slo_objective", "1"], ["--tenant_quota_rows", "0"],
    ["--replica_quarantine_after", "-1"], ["--router", "--replicas", "http://a"],
])
def test_flags_not_offered_are_refused(flags, capsys):
    """The fleet, vitals, QoS and tracing flags in combinations the
    reference refuses: exit 2 with a message naming one of them."""
    with pytest.raises(SystemExit) as err:
        parse_args(["--dalle_path", "x.npz", *flags])
    said = capsys.readouterr().err
    assert err.value.code == 2 and any(f in said for f in flags if f.startswith("--")), said


@pytest.fixture(scope="module")
def observed_boot(checkpoint, tmp_path_factory):
    """One CPU boot of the serve twin with the three observability flags,
    exporting to an in-process collector: one request, one profile
    capture, /debug/state and /metrics, then SIGTERM (the exporter's last
    flush). Returns what the cases read."""
    from dalle_pytorch_tpu_torch.obs.collector import CollectorServer

    work = tmp_path_factory.mktemp("observed")
    collector = CollectorServer(port=0, grace_s=0.1).start()
    proc = _serve(checkpoint, "--device", "cpu", "--port", "0", "--batch_shapes", "1",
                  "--compile_cache", str(work / "cache"), "--profile_dir", str(work / "profiles"),
                  "--trace_export", collector.url, "--trace_site", "replica-x", cwd=work)
    try:
        lines, port = [], None
        deadline = time.monotonic() + 240
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "listening on" in line:
                port = int(line.split("http://")[1].split()[0].rsplit(":", 1)[1])
        assert port is not None, "".join(lines)
        _, generated = _post(port, {"prompt": "red", "seed": 3})
        req = urllib.request.Request(f"http://127.0.0.1:{port}/debug/profile?seconds=0.5", data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            profile = json.loads(resp.read())
        state = json.loads(_get(port, "/debug/state")[1])
        metrics = _get(port, "/metrics")[1]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        events = [json.loads(ln) for ln in lines + out.splitlines(keepends=True) if ln.startswith("{")]
        yield dict(work=work, generated=generated, profile=profile, state=state, metrics=metrics, events=events,
                   collector=collector.collector, collector_url=collector.url)
    finally:
        if proc.poll() is None:
            proc.kill()
        collector.shutdown()


@pytest.mark.parametrize("flag", ["--compile_cache", "--profile_dir", "--trace_export"])
def test_observability_flags_accepted_and_wired(flag, observed_boot):
    b = observed_boot
    if flag == "--compile_cache":
        # the CPU loads no kernel library: a cold plan over every source,
        # no verdict counted, the boot phases timed
        cache = b["state"]["compile_cache"]
        assert cache["dir"] == str(b["work"] / "cache") and (b["work"] / "cache" / "aot").is_dir()
        assert cache["plan"]["mode"] == "cold" and len(cache["plan"]["programs"]) >= 6
        assert cache["counts"] == {"hits": 0, "misses": 0, "rejects": 0} and b["state"]["compiles"]["uncached"] == 0
        assert {"checkpoint", "plan", "warmup", "export"} <= set(cache["boot_seconds"])
        assert 'dalle_boot_seconds{phase="warmup"}' in b["metrics"] and "dalle_boot_cache_hits_total 0" in b["metrics"]
        done = next(e for e in b["events"] if e.get("event") == "warmup_done")
        assert done["boot_cache_mode"] == "cold" and done["uncached_compiles"] == 0
    elif flag == "--profile_dir":
        trace_dir = Path(b["profile"]["trace_dir"])
        assert trace_dir.parent == b["work"] / "profiles" and trace_dir.name.startswith("profile_")
        assert b["profile"]["seconds"] == 0.5 and "traceEvents" in json.loads((trace_dir / "trace.json").read_text())
        assert b["state"]["profiler"]["captures"] == 1 and not b["state"]["profiler"]["busy"]
    else:
        assert b["state"]["trace_export"]["url"] == b["collector_url"]
        trace_id = b["generated"]["trace_id"]
        bundle = b["collector"].find(trace_id)
        assert bundle is not None and {p["site"] for p in bundle.procs.values()} == {"replica-x"}
        names = {s["name"] for s in bundle.spans.values()}
        assert {"request", "queue", "generate", "respond"} <= names, names
        stopped = next(e for e in b["events"] if e.get("event") == "trace_export_stopped")
        assert stopped["traces_sent"] >= 1 and stopped["dropped"] == 0
        assert "dalle_obs_export_traces_total" in b["metrics"]


def test_fleet_and_vitals_flags_accepted():
    router = parse_args(["--router", "--replicas", "a=http://h:1,http://h:2", "--port", "0",
                         "--migrate_wait_s", "30", "--hedge_after_ms", "50", "--no_fleet_metrics"])
    assert router.router and router.migrate_wait_s == 30.0 and router.no_fleet_metrics
    replica = parse_args(["--dalle_path", "x.npz", "--engine", "continuous", "--port", "8001", "--supervise",
                          "--checkpoint_spool", "d", "--spool_notify", "http://r:8100", "--slo_ttft_ms", "500",
                          "--slo_objective", "0.9", "--vitals_interval_s", "0.5", "--no_program_costs"])
    assert replica.supervise and replica.spool_notify == "http://r:8100" and replica.slo_ttft_ms == 500.0
    assert replica.vitals_interval_s == 0.5 and replica.no_program_costs and not replica.no_vitals


@pytest.mark.parametrize("flags, message", [
    (["--checkpoint_spool", "d"], "needs --engine continuous"),
    (["--reserve_slots", "8"], "--reserve_slots must be in"),
    (["--tenant_weights", "a=0"], "bad --tenant_weights"),
    (["--request_log_max_mb", "5"], "needs --request_log_path"),
])
def test_flag_checks(flags, message, capsys):
    with pytest.raises(SystemExit):
        parse_args(["--dalle_path", "x.npz", *flags])
    assert message in capsys.readouterr().err
    args = parse_args(["--dalle_path", "x.npz", "--tenant_weights", "a=4,b=1", "--batch_shapes", "1,4"])
    assert args.device == "cuda" and args.tenant_weights == {"a": 4.0, "b": 1.0} and args.batch_shapes == (1, 4)


@pytest.mark.parametrize("mesh", ["tp=2", "dp=1,tp=4", "tp=-1", " tp=1 ", "fsdp=1,tp=2,sp=1"])
def test_mesh_shapes_accepted(mesh):
    args = parse_args(["--dalle_path", "x.npz", "--engine", "continuous", "--mesh", mesh])
    assert args.mesh == mesh


@pytest.mark.parametrize("flags, message", [
    (["--mesh", "tp=2"], "--mesh needs --engine continuous"),
    (["--engine", "continuous", "--mesh", "pp=2"], "unknown mesh axis 'pp'"),
    (["--engine", "continuous", "--mesh", "2,4"], "must be axis=size"),
    (["--engine", "continuous", "--mesh", "tp=0"], "sizes must be >= 1"),
    (["--engine", "continuous", "--mesh", "tp=-2"], "sizes must be >= 1"),
    (["--engine", "continuous", "--mesh", "dp=2,tp=2"], "ROADMAP.md Queue 1 item 8"),
    (["--engine", "continuous", "--mesh", "fsdp=2"], "ROADMAP.md Queue 1 item 8"),
    (["--engine", "continuous", "--mesh", "sp=4"], "ROADMAP.md Queue 1 item 8"),
])
def test_mesh_flag_checks(flags, message, capsys):
    """The reference's parse-time checks (`serve.py:330-341`), and the axes
    the sharded engines do not serve yet."""
    with pytest.raises(SystemExit) as err:
        parse_args(["--dalle_path", "x.npz", *flags])
    assert err.value.code == 2 and message in capsys.readouterr().err
