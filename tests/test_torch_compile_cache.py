"""The port's kernel-library compile cache (CPU), after the reference's
`tests/test_recovery.py` boot-cache tests.

The CPU machine has no nvcc, so the cache is driven through the real
`kernels.build` with its compile command (`kernels.compiler_command`) swapped
for g++ over tiny C sources, loaded with ctypes as the CUDA libraries are:

* a first boot against an empty directory is cold (each library a
  counted miss, built, exported), a second boot warm (each library a hit
  loaded from its artifact, nothing built, `CompileTally.uncached == 0`,
  also across two fresh processes);
* a fingerprint that drifted (config, ladder, sources, nvcc flags) is a
  cold boot of counted misses, served from the build directory;
* an artifact truncated or garbled by `FaultInjector.corrupt_cache` is a
  counted reject, the library loads from the build directory, the boot
  goes on, and the warmup's export heals the cache;
* `dalle_boot_seconds{phase=}` and the counters on the registry;
* an artifact written by the JAX package's `pack_artifact` loads in the
  port under the same fingerprint string, and the port's export plans warm
  in the JAX `CompileCache`;
* the supervised child keeps `--compile_cache`.
"""

import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

from dalle_pytorch_tpu.utils import compile_cache as jcc
from dalle_pytorch_tpu_torch import kernels
from dalle_pytorch_tpu_torch.serving.engine import GenerationEngine
from dalle_pytorch_tpu_torch.serving.faults import FaultInjector
from dalle_pytorch_tpu_torch.serving.supervisor import child_command
from dalle_pytorch_tpu_torch.training.metrics import MetricsRegistry
from dalle_pytorch_tpu_torch.utils import compile_guard
from dalle_pytorch_tpu_torch.utils.compile_cache import MAGIC, CompileCache, kernel_fingerprint

REPO = Path(__file__).resolve().parent.parent
SOURCES = {
    "tiny_add": "int tiny_add(int a, int b) { return a + b; }\n",
    "tiny_mul": "int tiny_mul(int a, int b) { return a * b; }\n",
}
CONFIG = {"dim": 64, "depth": 2}
LADDER = ("prefill", "chunk", "release")


def gxx_command(src, out):
    """nvcc's stand-in: g++ over a C source."""
    return ["g++", "-x", "c", "-shared", "-fPIC", "-O1", "-o", str(out), str(src)]


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """`kernels` pointed at two tiny C sources and a build directory of
    this test, with its builds counted; restores the process after."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name, text in SOURCES.items():
        (csrc / f"{name}.cu").write_text(text)
    builds = []

    def command(src, out):
        builds.append(Path(src).stem)
        return gxx_command(src, out)

    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "compiler_command", command)
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "build_log", {})
    monkeypatch.setattr(kernels, "_cache", None)
    return types.SimpleNamespace(dir=tmp_path, builds=builds)


def fingerprint(config=CONFIG, ladder=LADDER):
    return kernel_fingerprint("cpu", model_config=config, programs=ladder)


def boot(cache_dir, fp=None, faults=None, export=True):
    """One replica boot in this process: a fresh library table, the cache
    installed before anything builds, bound and planned, the libraries
    made ready and called, then warmup's export. Returns
    (cache, plan, tally, registry)."""
    kernels._libs.clear()
    kernels.build_log.clear()
    reg = MetricsRegistry()
    cache = CompileCache(cache_dir, registry=reg).install()
    cache.faults = faults
    with cache.boot_phase("plan"):
        cache.bind(fp or fingerprint(), kernels.sources())
        plan = cache.plan_boot()
    with compile_guard.track_compiles() as tally:
        with cache.boot_phase("warmup"):
            assert kernels.library("tiny_add").tiny_add(20, 22) == 42
            assert kernels.library("tiny_mul").tiny_mul(6, 7) == 42
            if export:
                GenerationEngine._export_libraries(types.SimpleNamespace(compile_cache=cache))
    return cache, plan, tally, reg


def counts(reg):
    return {k: int(reg.get(f"dalle_boot_cache_{k}_total").value) for k in ("hits", "misses", "rejects")}


def sources_of():
    return {n: kernels.build_log[n]["source"] for n in SOURCES}


def test_first_boot_cold_then_warm(tiny):
    cache, plan, tally, reg = boot(tiny.dir / "cache")
    assert plan["mode"] == "cold" and plan["reason"].startswith("no manifest")
    assert counts(reg) == {"hits": 0, "misses": 2, "rejects": 0} and cache.counts == {"hits": 0, "misses": 2, "rejects": 0}
    assert sorted(tiny.builds) == sorted(SOURCES) and sources_of() == {n: "built" for n in SOURCES}
    assert (tally.count, tally.cache_hits, tally.uncached) == (2, 0, 2)
    assert sorted(cache.detail()["exported"]) == sorted(SOURCES)
    manifest = json.loads((tiny.dir / "cache" / "aot" / "MANIFEST.json").read_text())
    assert manifest["fingerprint"] == fingerprint() and sorted(manifest["programs"]) == sorted(SOURCES)

    cache, plan, tally, reg = boot(tiny.dir / "cache")
    assert plan["mode"] == "warm" and plan["reason"] is None
    assert counts(reg) == {"hits": 2, "misses": 0, "rejects": 0}
    assert len(tiny.builds) == 2 and sources_of() == {n: "cache" for n in SOURCES}  # nothing built
    assert (tally.count, tally.cache_hits, tally.uncached) == (2, 2, 0)
    assert cache.detail()["exported"] == [] and not list((tiny.dir / "cache" / "lib").iterdir())
    events = compile_guard.recent_events()[-2:]
    assert [e["source"] for e in events] == ["cache", "cache"] and not any(e["built"] for e in events)


@pytest.mark.parametrize("drift", ["config", "ladder", "source", "flags"])
def test_fingerprint_drift_is_a_cold_miss(tiny, drift, monkeypatch):
    boot(tiny.dir / "cache")
    if drift == "config":
        fp = fingerprint(config={**CONFIG, "depth": 3})
    elif drift == "ladder":
        fp = fingerprint(ladder=LADDER + ("resume",))
    elif drift == "source":
        (kernels.CSRC / "tiny_add.cu").write_text(SOURCES["tiny_add"] + "/* edited */\n")
        fp = fingerprint()
    else:
        monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-lineinfo",))
        fp = fingerprint()
    assert fp != boot_fp_of(tiny)
    cache, plan, tally, reg = boot(tiny.dir / "cache", fp=fp, export=False)
    assert plan["mode"] == "cold" and plan["reason"].startswith("fingerprint mismatch")
    assert counts(reg) == {"hits": 0, "misses": 2, "rejects": 0}
    assert all(v["reason"].startswith("fingerprint mismatch") for v in cache.loads.values())
    # served from the build directory (what the drift changed rebuilds), never from the stale artifact
    assert tally.cache_hits == 0 and tally.uncached == 2
    assert sources_of() == {"tiny_add": "built" if drift in ("source", "flags") else "disk",
                            "tiny_mul": "built" if drift == "flags" else "disk"}


def boot_fp_of(tiny):
    return json.loads((tiny.dir / "cache" / "aot" / "MANIFEST.json").read_text())["fingerprint"]


@pytest.mark.parametrize("mode", ["truncate", "garble"])
def test_corrupt_artifact_is_a_counted_reject(tiny, mode):
    boot(tiny.dir / "cache")
    faults = FaultInjector().corrupt_cache("tiny_add", nth=1, mode=mode)
    cache, plan, tally, reg = boot(tiny.dir / "cache", faults=faults)
    assert faults.fired == [{"artifact": "tiny_add", "nth": 1, "kind": "corrupt_cache", "mode": mode}]
    assert plan["mode"] == "cold" and "tiny_add" in plan["reason"]
    assert plan["programs"]["tiny_add"]["status"] == "reject" and plan["programs"]["tiny_mul"]["status"] == "hit"
    assert counts(reg) == {"hits": 1, "misses": 0, "rejects": 1}  # one verdict a library, not one a read
    assert cache.loads["tiny_add"]["status"] == "reject"
    assert cache.loads["tiny_add"]["reason"] in ("truncated payload", "checksum mismatch") or \
        cache.loads["tiny_add"]["reason"].startswith("corrupt header")
    assert sources_of() == {"tiny_add": "disk", "tiny_mul": "cache"} and len(tiny.builds) == 2
    assert (tally.cache_hits, tally.uncached) == (1, 1)
    # warmup's export rewrote the rejected artifact: the next boot is warm
    assert cache.detail()["exported"] == ["tiny_add"]
    cache, plan, tally, reg = boot(tiny.dir / "cache")
    assert plan["mode"] == "warm" and counts(reg)["hits"] == 2 and tally.uncached == 0


def test_unbound_or_missing_artifacts(tiny):
    cache = CompileCache(tiny.dir / "cache").install()
    assert cache.load("tiny_add") is None and cache.counts == {"hits": 0, "misses": 0, "rejects": 0}
    assert not cache.wants("tiny_add")  # nothing exported before bind
    with compile_guard.track_compiles() as tally:
        kernels.library("tiny_add")
    assert sources_of_one("tiny_add") == "built" and tally.uncached == 1 and cache.detail()["exported"] == []
    cache.bind(fingerprint(), kernels.sources())
    assert cache.load("tiny_mul") is None and cache.loads["tiny_mul"] == {"status": "miss", "reason": "missing artifact"}
    (cache.artifact_path("tiny_mul")).write_bytes(b"not an artifact")
    assert cache.load("tiny_mul") is None and cache.loads["tiny_mul"]["reason"] == "bad magic"
    # a valid container around bytes that are no library: a reject, never loaded
    cache.artifact_path("tiny_mul").write_bytes(kernels_pack(b"\x7fELF garbage", fingerprint()))
    assert cache.load("tiny_mul") is None and cache.loads["tiny_mul"]["reason"].startswith("unloadable")
    assert cache.counts == {"hits": 0, "misses": 1, "rejects": 2}
    CompileCache.uninstall()
    assert kernels._cache is None


def sources_of_one(name):
    return kernels.build_log[name]["source"]


def kernels_pack(payload, fp):
    from dalle_pytorch_tpu_torch.utils.artifact import pack_artifact

    return pack_artifact(MAGIC, fp, payload)


def test_boot_phase_gauge_and_detail(tiny):
    cache, _, _, reg = boot(tiny.dir / "cache")
    text = reg.render()
    for phase in ("plan", "warmup", "export"):
        assert f'dalle_boot_seconds{{phase="{phase}"}}' in text
        assert cache.boot_seconds[phase] >= 0.0
    detail = cache.detail()
    assert detail["fingerprint"] == fingerprint() and detail["programs"] == sorted(SOURCES)
    assert set(detail["loads"]) == set(SOURCES) and detail["errors"] == {}
    json.dumps(detail)  # /debug/state carries it


def test_artifacts_cross_packages(tiny):
    fp = fingerprint()
    boot(tiny.dir / "port_cache")
    built = kernels.BUILD_DIR
    # the port's export plans warm in the reference's cache, and unpacks there
    jcache = jcc.CompileCache(tiny.dir / "port_cache").bind(fp, sorted(SOURCES))
    assert jcache.plan_boot()["mode"] == "warm"
    raw = (tiny.dir / "port_cache" / "aot" / "tiny_add.aotx").read_bytes()
    status, _, payload = jcc.unpack_artifact(raw, jcc.MAGIC, fp)
    assert status == "hit" and payload == next(built.glob("tiny_add-*.so")).read_bytes()
    # the reference's container around a built library loads in the port
    cache = CompileCache(tiny.dir / "jax_cache").bind(fp, sorted(SOURCES))
    for name in SOURCES:
        so = next(built.glob(f"{name}-*.so")).read_bytes()
        cache.artifact_path(name).write_bytes(jcc.pack_artifact(jcc.MAGIC, fp, so, extra={"program": name}))
    assert cache.deserialize("tiny_add").tiny_add(1, 2) == 3 and cache.loads == {}  # uncounted
    lib = cache.load("tiny_mul")
    assert lib is not None and lib.tiny_mul(6, 7) == 42 and cache.loads["tiny_mul"]["status"] == "hit"
    assert cache.plan_boot()["mode"] == "warm"
    # the same bytes under another fingerprint string are a miss in both
    assert jcc.unpack_artifact(raw, jcc.MAGIC, "0" * 32)[0] == "miss"
    assert cache.bind("0" * 32, sorted(SOURCES)).load("tiny_add") is None
    assert cache.loads["tiny_add"]["status"] == "miss"


_SECOND_BOOT = r"""
import json, sys
from pathlib import Path
from dalle_pytorch_tpu_torch import kernels
from dalle_pytorch_tpu_torch.utils import compile_guard
from dalle_pytorch_tpu_torch.utils.compile_cache import CompileCache, kernel_fingerprint

work = Path(sys.argv[1])
kernels.CSRC, kernels.BUILD_DIR = work / "csrc", work / "build"
kernels.compiler_command = lambda src, out: ["g++", "-x", "c", "-shared", "-fPIC", "-O1", "-o", str(out), str(src)]
cache = CompileCache(work / "cache").install()
cache.bind(kernel_fingerprint("cpu", model_config={"dim": 64}, programs=("chunk",)), kernels.sources())
plan = cache.plan_boot()
with compile_guard.track_compiles() as tally:
    total = kernels.library("tiny_add").tiny_add(1, 2) + kernels.library("tiny_mul").tiny_mul(3, 4)
print(json.dumps({"mode": plan["mode"], "counts": cache.counts, "compiles": tally.count,
                  "cache_hits": tally.cache_hits, "uncached": tally.uncached, "total": total,
                  "sources": {n: kernels.build_log[n]["source"] for n in ("tiny_add", "tiny_mul")}}))
"""


def test_second_boot_uncached_zero_across_processes(tiny):
    script = tiny.dir / "boot.py"
    script.write_text(_SECOND_BOOT)

    def one_boot():
        out = subprocess.run([sys.executable, str(script), str(tiny.dir)], cwd=REPO, capture_output=True, text=True,
                             timeout=120, env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"})
        assert out.returncode == 0, out.stderr
        return json.loads(out.stdout.strip().splitlines()[-1])

    first, second = one_boot(), one_boot()
    assert first["mode"] == "cold" and first["uncached"] == 2 and first["sources"] == {"tiny_add": "built",
                                                                                         "tiny_mul": "built"}
    assert second["mode"] == "warm" and second["counts"] == {"hits": 2, "misses": 0, "rejects": 0}
    assert (second["compiles"], second["cache_hits"], second["uncached"]) == (2, 2, 0)
    assert second["sources"] == {"tiny_add": "cache", "tiny_mul": "cache"} and second["total"] == 15


def test_tally_and_guard(tiny):
    with compile_guard.assert_no_recompiles(allowed=1) as tally:
        kernels.library("tiny_add")
    assert tally.count == 1 and tally.events[-1]["kernel"] == "tiny_add" and tally.events[-1]["source"] == "built"
    with pytest.raises(compile_guard.RecompileError, match="tiny_mul"):
        with compile_guard.assert_no_recompiles():
            kernels.library("tiny_mul")
    with compile_guard.assert_no_recompiles() as tally:  # loaded libraries cost nothing
        kernels.library("tiny_add"), kernels.library("tiny_mul")
    assert (tally.count, tally.cache_hits, tally.uncached, tally.events) == (0, 0, 0, [])
    with pytest.raises(ValueError):
        compile_guard.record_build("x", 0.0, "elsewhere")


def test_fault_rule_checks_its_arguments(tmp_path):
    with pytest.raises(ValueError):
        FaultInjector().corrupt_cache("a", nth=0)
    with pytest.raises(ValueError):
        FaultInjector().corrupt_cache("a", mode="shred")
    faults = FaultInjector().corrupt_cache("a", nth=2)
    faults.on_artifact_load("a", tmp_path / "missing.aotx")  # 1st read: no rule
    faults.on_artifact_load("a", tmp_path / "missing.aotx")  # 2nd: a missing file stays missing
    assert not (tmp_path / "missing.aotx").exists() and faults.fired[0]["nth"] == 2


def test_supervised_child_keeps_the_compile_cache():
    argv = ["--dalle_path", "d.npz", "--engine", "continuous", "--port", "8001", "--supervise",
            "--compile_cache", "/srv/cache", "--spool_notify", "http://r:8100", "--checkpoint_spool", "s"]
    child = child_command(argv)
    assert child[:3] == [sys.executable, "-m", "dalle_pytorch_tpu_torch.serve"]
    assert child[child.index("--compile_cache") + 1] == "/srv/cache"
    assert "--supervise" not in child and "--spool_notify" not in child
