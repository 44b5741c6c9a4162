"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled with
`nvcc` for Hopper (`sm_90a`) into a shared library, loaded with ctypes
(the build that takes seconds, not the minutes a source including
PyTorch's headers takes). Libraries are built at first use, from the
sources in this checkout, into `build/torch_kernels/` at the repo root,
named by a hash of the source and flags so an edited source rebuilds and
an unchanged one loads as is. Several kernels are compiled concurrently,
one nvcc process each. There is no fallback: without nvcc this raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

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
#: per kernel: {"seconds": build wall time (0.0 when loaded from disk),
#: "path": the .so, "ptxas": nvcc's register/shared-memory report}
build_log: Dict[str, dict] = {}


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


def build(names: Sequence[str]) -> None:
    """Compile (concurrently) and load every named kernel not yet loaded."""
    todo = [n for n in dict.fromkeys(names) if n not in _libs]
    procs = {}
    if any(not _target(n).exists() for n in todo):
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in todo:
        out = _target(name)
        if out.exists():
            build_log[name] = {"seconds": 0.0, "path": str(out), "ptxas": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
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
        }
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    for name in todo:
        _libs[name] = ctypes.CDLL(str(_target(name)))
        compile_guard.record_build(name, build_log[name]["seconds"], built=name in procs)


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it if needed."""
    if name not in _libs:
        build([name])
    return _libs[name]
