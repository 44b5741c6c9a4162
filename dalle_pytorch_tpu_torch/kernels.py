"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled with
`nvcc` for Hopper (`sm_90a`) into a shared library, loaded with ctypes
(the build that takes seconds, not the minutes a source including
PyTorch's headers takes). Libraries are built at first use, from the
sources in this checkout, into `build/torch_kernels/` at the repo root,
named by a hash of the source and flags so an edited source rebuilds and
an unchanged one loads as is. Several kernels are compiled concurrently,
one nvcc process each. There is no fallback: without nvcc this raises.

With a compile cache installed (`utils/compile_cache.CompileCache.install`,
`serve --compile_cache DIR`), a library is looked up in the cache first,
then in `BUILD_DIR`, then built; a library nvcc built is exported into the
cache. The cache validates every artifact against its boot fingerprint
and checksum: a missing, stale or damaged one is a counted miss or reject
and the library comes from `BUILD_DIR` or nvcc instead. Where each library
came from ("cache", "disk" or "built") is in `build_log` and in the
`utils/compile_guard` event.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

from dalle_pytorch_tpu_torch.utils import compile_guard

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
    "--split-compile=0",  # optimize a source's kernels on every core: halves flash_decode.cu's build
)

_libs: Dict[str, ctypes.CDLL] = {}
#: per kernel: {"seconds": build wall time (0.0 when loaded from disk, the
#: validation and load when from the cache), "path": the .so (the cache's
#: artifact), "ptxas": nvcc's register/shared-memory report, "source":
#: "cache" | "disk" | "built"}
build_log: Dict[str, dict] = {}
#: the installed compile cache (`utils/compile_cache.CompileCache`), or None
_cache = None


def install_cache(cache) -> None:
    """Make `cache` the store `build` looks in first and exports into (None
    uninstalls it). Libraries already loaded stay as they are."""
    global _cache
    _cache = cache


def sources() -> List[str]:
    """The kernel library names: every `csrc/<name>.cu`."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def source_hashes() -> Dict[str, str]:
    """sha256 of every kernel source, by library name."""
    return {name: hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest() for name in sources()}


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are compiled from csrc/ at first use and need "
        "the CUDA toolkit"
    )


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def compiler_command(src: Path, out: Path) -> List[str]:
    """The command that builds `src` into the shared library `out` (the
    seam a test swaps for a host compiler)."""
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]


def build(names: Sequence[str]) -> None:
    """Make every named kernel library not yet loaded ready: from the
    installed compile cache, else from `BUILD_DIR`, else compiled
    (concurrently) by nvcc."""
    todo = [n for n in dict.fromkeys(names) if n not in _libs]
    cache = _cache
    procs, cached = {}, {}
    for name in todo:
        if cache is not None:
            t0 = time.perf_counter()
            lib = cache.load(name)  # a counted verdict; None unless a valid artifact loaded
            if lib is not None:
                cached[name] = lib
                build_log[name] = {"seconds": time.perf_counter() - t0, "path": str(cache.artifact_path(name)),
                                   "ptxas": "", "source": "cache"}
                continue
        out = _target(name)
        if out.exists():
            build_log[name] = {"seconds": 0.0, "path": str(out), "ptxas": "", "source": "disk"}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = compiler_command(CSRC / f"{name}.cu", tmp)
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp, time.perf_counter(),
        )
    failed = []
    for name, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, _target(name))  # atomic: a concurrent build never sees half a file
        build_log[name] = {
            "seconds": time.perf_counter() - t0,
            "path": str(_target(name)),
            "ptxas": log,
            "source": "built",
        }
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    for name in todo:
        _libs[name] = cached[name] if name in cached else ctypes.CDLL(str(_target(name)))
        info = build_log[name]
        compile_guard.record_build(name, info["seconds"], info["source"], cache_installed=cache is not None)
        if name in procs and cache is not None and cache.wants(name):
            cache.export(name, _target(name))  # records its own failure, never raises


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it if needed."""
    if name not in _libs:
        build([name])
    return _libs[name]
