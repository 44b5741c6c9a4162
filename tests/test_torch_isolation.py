"""The port imports no jax, no flax and nothing of the JAX package.

Two checks: every module of `dalle_pytorch_tpu_torch` and `chip_smoke.py`
imports in a fresh process whose import system refuses `jax`, `jaxlib`,
`flax` and the top-level package `dalle_pytorch_tpu` (matched exactly —
`dalle_pytorch_tpu_torch` shares its prefix); and an AST scan finds no
import of them in the port's sources: the package, `chip_smoke.py` and
every `scripts/torch_*.py`.
"""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "dalle_pytorch_tpu_torch"
REFUSED = ("jax", "jaxlib", "flax", "dalle_pytorch_tpu")


def _sources():
    return (
        sorted(PORT.rglob("*.py"))
        + [REPO / "chip_smoke.py"]
        + sorted((REPO / "scripts").glob("torch_*.py"))
    )


def test_the_scan_covers_every_port_script():
    names = {p.name for p in _sources()}
    assert {
        "chip_smoke.py", "torch_continuous_profile.py", "paging.py", "generate.py", "clip.py",
        "native_bpe.py", "tokenizer.py", "images.py", "wide_head.py", "torch_wide_head_probe.py",
        "migrate.py", "streaming.py", "artifact.py", "metrics.py", "qos.py", "faults.py",
        "server.py", "serve.py", "batcher.py", "tracing.py", "logging.py", "aggregate.py",
        "vitals.py", "router.py", "compile_guard.py", "train_dalle.py", "precompute_tokens.py",
        "loader.py", "rainbow.py", "webdataset.py", "prefetch.py", "config.py", "lr.py", "flops.py",
        "train_vae.py", "train_clip.py", "gumbel.py", "vae_io.py", "mesh.py", "partition.py",
        "serving_partition.py", "tensor_parallel.py", "sharded.py", "collectives.py", "fsdp.py",
        "ring.py", "launch.py", "torch_collectives_probe.py", "supervisor.py", "fleetmetrics.py",
        "collector.py", "profiler.py", "compile_cache.py",
    } <= names


def test_port_imports_with_the_reference_refused():
    code = textwrap.dedent(
        f"""
        import importlib, pkgutil, sys
        REFUSED = {REFUSED!r}
        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in REFUSED:
                    raise ImportError("refused import of " + name)
        sys.meta_path.insert(0, Refuse())
        import dalle_pytorch_tpu_torch as port
        names = [m.name for m in pkgutil.walk_packages(port.__path__, "dalle_pytorch_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        importlib.import_module("chip_smoke")
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
        assert not leaked, leaked
        print(len(names))
        """
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15  # every module was walked


def test_no_reference_imports_in_the_sources():
    found = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [
                f"{path.relative_to(REPO)}:{node.lineno} {n}"
                for n in names
                if n.split(".")[0] in REFUSED
            ]
    assert not found, found
