"""The kernel-library compile cache, for boots that build nothing.

Counterpart of the JAX package's `utils/compile_cache.py`. There, a
replica's boot compiles its program ladder with XLA, and the cache keeps
the serialized executables. The port's compiled artifacts are the CUDA
kernel libraries `kernels.py` builds with nvcc (seconds to minutes each on
a fresh host), so the cache keeps those: each library is one artifact in
the reference's self-validating container (`utils/artifact.py`, magic
`DALLEAOT\\n`), stamped with a boot fingerprint, under `DIR/aot/`, with a
`MANIFEST.json` beside them, the reference's layout. Ship `DIR` to a new
host, and a replica that boots against it with the same fingerprint loads
every library from it and runs no nvcc.

The fingerprint (`kernel_fingerprint`, `engine_fingerprint`) names
torch's and CUDA's versions, nvcc's version, the device's kind and compute
capability, `kernels.NVCC_FLAGS`, every kernel source's hash, and, as the
reference's does, the model config and the engine's program ladder. Any
drift turns the artifacts into misses.

Lifecycle (`serve --compile_cache DIR` runs it):

    cache = CompileCache(dir, registry=reg, log=log).install()  # before anything builds
    ... build the engine ...
    cache.bind(engine_fingerprint(engine), kernels.sources())
    plan = cache.plan_boot()             # warm / cold forecast
    engine.compile_cache = cache         # warmup exports what it made ready
    with cache.boot_phase("warmup"):
        engine.warmup()

`install()` makes `kernels.build` look in the cache first, then in
`BUILD_DIR`, then run nvcc. Each library asked for is one counted verdict
(`dalle_boot_cache_{hits,misses,rejects}_total`): a hit is loaded from its
validated bytes; a miss (missing artifact, another fingerprint) or a
reject (bad magic, truncated, checksum mismatch, a library that will not
load) is logged and the library comes from `BUILD_DIR` or nvcc. No
failure of the cache fails a boot, and no library is loaded unchecked.
The reference counts every program of its ladder at `plan_boot`, since
its warmup compiles them all; the port's libraries are made ready at a
kernel's first launch, so a verdict is counted when its library is first
asked for, and the hits equal the libraries a boot loaded.
`dalle_boot_seconds{phase=}` times checkpoint / plan / warmup / export.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

from dalle_pytorch_tpu_torch.utils.artifact import (
    FORMAT_VERSION,
    boot_fingerprint,
    device_kind,
    pack_artifact,
    unpack_artifact,
)

MAGIC = b"DALLEAOT\n"
#: manifest filename inside DIR/aot/
MANIFEST = "MANIFEST.json"

_nvcc_version: Dict[str, Optional[str]] = {}


def _atomic_write(path: Path, data: bytes) -> None:
    tmp = path.with_suffix(path.suffix + f".tmp{os.getpid()}")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def nvcc_version() -> Optional[str]:
    """nvcc's version ("12.4.131"), None without a toolkit. Read from the
    toolkit's `version.json` where it has one, else from `nvcc --version`,
    so a warm boot spawns no nvcc process at all."""
    if "v" not in _nvcc_version:
        from dalle_pytorch_tpu_torch import kernels

        found = None
        try:
            nvcc = Path(kernels.find_nvcc())
        except RuntimeError:
            nvcc = None
        if nvcc is not None:
            try:
                meta = json.loads((nvcc.resolve().parent.parent / "version.json").read_text())
                found = str(meta["cuda_nvcc"]["version"])
            except (OSError, ValueError, KeyError, TypeError):
                import subprocess

                out = subprocess.run([str(nvcc), "--version"], capture_output=True, text=True, timeout=60).stdout
                match = re.search(r"V(\d+(?:\.\d+)+)", out)
                found = match.group(1) if match else out.strip() or None
        _nvcc_version["v"] = found
    return _nvcc_version["v"]


def kernel_identity(device) -> Dict:
    """What the kernel libraries of this process depend on: the CUDA
    version torch was built for, nvcc's version, the device's compute
    capability, the nvcc flags and every source's hash."""
    import torch

    from dalle_pytorch_tpu_torch import kernels

    dev = torch.device(device)
    return {
        "cuda": torch.version.cuda,
        "nvcc": nvcc_version(),
        "capability": list(torch.cuda.get_device_capability(dev)) if dev.type == "cuda" else None,
        "nvcc_flags": list(kernels.NVCC_FLAGS),
        "sources": kernels.source_hashes(),
    }


def kernel_fingerprint(device, model_config=None, programs: Iterable[str] = (), mesh_shape=None) -> str:
    """The boot fingerprint of the compile cache: torch's version, the
    device kind, the model config and the program ladder
    (`utils/artifact.boot_fingerprint`) plus `kernel_identity`."""
    return boot_fingerprint(
        device=device_kind(device),
        mesh_shape=mesh_shape,
        model_config=model_config,
        programs=tuple(programs),
        extra={"kernels": kernel_identity(device)},
    )


def engine_fingerprint(engine) -> str:
    """`kernel_fingerprint` of a serving engine: its device, config,
    program ladder and (sharded) mesh shape."""
    mesh = getattr(engine, "mesh", None)
    return kernel_fingerprint(
        engine.device, model_config=engine.cfg, programs=engine.program_ladder(),
        mesh_shape=None if mesh is None else dict(mesh.shape),
    )


class CompileCache:
    """One directory of fingerprinted kernel-library artifacts, plus the
    boot accounting. Every load-side failure is absorbed: a bad cache
    degrades to a build from `BUILD_DIR` or nvcc, counted, never to a
    crashed replica."""

    def __init__(self, directory, registry=None, log=None):
        self.dir = Path(directory)
        self.aot_dir = self.dir / "aot"
        #: where a validated library is written to be loaded (and unlinked)
        self.lib_dir = self.dir / "lib"
        self.aot_dir.mkdir(parents=True, exist_ok=True)
        self.lib_dir.mkdir(parents=True, exist_ok=True)
        self.log = log
        self.fingerprint: Optional[str] = None
        self.programs: tuple = ()
        self.plan: Optional[Dict] = None
        #: fault-injection seam (serving/faults.py `corrupt_cache` rules):
        #: called with (artifact, path) before every artifact read
        self.faults = None
        self._exported: set = set()
        self._errors: Dict[str, str] = {}
        self.boot_seconds: Dict[str, float] = {}
        #: the counted verdict of each library asked for: {"status", "reason"}
        self.loads: Dict[str, Dict] = {}
        self.counts = {"hits": 0, "misses": 0, "rejects": 0}
        self._metrics = {}
        self._m_phase = None
        if registry is not None:
            self._metrics = {
                "hit": registry.counter(
                    "dalle_boot_cache_hits_total",
                    "compile-cache artifacts that validated against the boot fingerprint and loaded "
                    "(warm-boot evidence)",
                ),
                "miss": registry.counter(
                    "dalle_boot_cache_misses_total",
                    "compile-cache artifacts missing or keyed to another fingerprint (built or loaded "
                    "from the build directory instead; expected after any config, toolkit or source change)",
                ),
                "reject": registry.counter(
                    "dalle_boot_cache_rejects_total",
                    "compile-cache artifacts rejected as corrupt, truncated or unloadable (built or loaded "
                    "from the build directory instead; investigate the cache volume)",
                ),
            }
            self._m_phase = registry.gauge_family(
                "dalle_boot_seconds", "wall seconds of the most recent boot, by phase", label_name="phase",
            )

    # ------------------------------------------------------------ wiring

    def install(self) -> "CompileCache":
        """Make this cache the store `kernels.build` looks in first and
        exports into: process-wide, before the first kernel builds."""
        from dalle_pytorch_tpu_torch import kernels

        kernels.install_cache(self)
        return self

    @staticmethod
    def uninstall() -> None:
        """Detach `kernels.py` from any cache (tests restore the process)."""
        from dalle_pytorch_tpu_torch import kernels

        kernels.install_cache(None)

    def bind(self, fingerprint: str, programs: Iterable[str]) -> "CompileCache":
        """The identity artifacts must carry, and the libraries the plan
        checks and warmup exports (`kernels.sources()` for a replica)."""
        self.fingerprint = str(fingerprint)
        self.programs = tuple(str(p) for p in programs)
        return self

    # ------------------------------------------------------------- layout

    def artifact_path(self, program: str) -> Path:
        safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in str(program))
        return self.aot_dir / f"{safe}.aotx"

    @property
    def manifest_path(self) -> Path:
        return self.aot_dir / MANIFEST

    def _read_manifest(self) -> Optional[Dict]:
        try:
            return json.loads(self.manifest_path.read_text())
        except FileNotFoundError:
            return None
        except Exception:
            return {"corrupt": True}

    def _write_manifest(self, entries: Dict[str, Dict]) -> None:
        _atomic_write(
            self.manifest_path,
            json.dumps(
                {"format": FORMAT_VERSION, "fingerprint": self.fingerprint, "programs": entries,
                 "written_at": time.time()},
                indent=1, sort_keys=True,
            ).encode(),
        )

    # -------------------------------------------------------------- checks

    def _validate(self, program: str) -> Dict:
        """One artifact's verdict: {"status": "hit" | "miss" | "reject",
        "reason", and for a hit "payload"}. Never raises."""
        path = self.artifact_path(program)
        if self.faults is not None:
            self.faults.on_artifact_load(program, path)
        try:
            raw = path.read_bytes()
        except FileNotFoundError:
            return {"status": "miss", "reason": "missing artifact"}
        except Exception as exc:
            return {"status": "reject", "reason": f"unreadable: {exc!r}"}
        status, reason, payload = unpack_artifact(raw, MAGIC, self.fingerprint)
        if status != "hit":
            return {"status": status, "reason": reason}
        return {"status": "hit", "reason": None, "payload": payload}

    def plan_boot(self) -> Dict:
        """Validate every bound library's artifact and return the boot
        plan: `mode` "warm" only when every one is a hit, else "cold" with
        the reasons. A forecast: the counted verdict of a library is taken
        when it is first asked for (`load`)."""
        assert self.fingerprint is not None, "bind() before plan_boot()"
        t0 = time.perf_counter()
        verdicts: Dict[str, Dict] = {}
        manifest = self._read_manifest()
        for program in self.programs:
            v = self._validate(program)
            verdicts[program] = {"status": v["status"], "reason": v["reason"],
                                 **({"bytes": len(v["payload"])} if "payload" in v else {})}
        statuses = {v["status"] for v in verdicts.values()}
        mode = "warm" if statuses == {"hit"} else "cold"
        reason = None
        if mode == "cold":
            if manifest is None:
                reason = "no manifest (first boot against this directory)"
            elif manifest.get("corrupt"):
                reason = "corrupt manifest"
            elif manifest.get("fingerprint") != self.fingerprint:
                reason = "fingerprint mismatch (config, ladder, torch, toolkit, device or source drift)"
            else:
                reason = f"invalid artifacts: { {p: v['reason'] for p, v in verdicts.items() if v['status'] != 'hit'} }"
        self.plan = {
            "mode": mode, "reason": reason, "fingerprint": self.fingerprint, "programs": verdicts,
            "plan_s": round(time.perf_counter() - t0, 4),
        }
        if self.log is not None:
            self.log.event("boot_cache_plan", mode=mode, reason=reason, fingerprint=self.fingerprint,
                           programs={p: v["status"] for p, v in verdicts.items()})
        return self.plan

    # --------------------------------------------------------------- load

    def _deserialize(self, program: str, payload: bytes) -> ctypes.CDLL:
        """Validated library bytes -> the loaded library: written to a file
        of this process, loaded, and unlinked (the mapping stays)."""
        safe = self.artifact_path(program).stem
        path = self.lib_dir / f"{safe}-{self.fingerprint[:12]}.{os.getpid()}.so"
        _atomic_write(path, payload)
        try:
            return ctypes.CDLL(str(path))
        finally:
            path.unlink(missing_ok=True)

    def _open(self, program: str):
        """(verdict, the library or None): the artifact validated and, when
        valid, loaded; validated bytes that will not load are a reject.
        Never raises."""
        v = self._validate(program)
        if v["status"] != "hit":
            return v, None
        try:
            return v, self._deserialize(program, v["payload"])
        except Exception as exc:
            self._errors[str(program)] = repr(exc)
            return {"status": "reject", "reason": f"unloadable: {exc!r}"}, None

    def deserialize(self, program: str) -> Optional[ctypes.CDLL]:
        """Best-effort, uncounted load of one valid artifact; None on any
        failure."""
        return None if self.fingerprint is None else self._open(program)[1]

    def load(self, program: str) -> Optional[ctypes.CDLL]:
        """`kernels.build`'s lookup: the library from its validated
        artifact, or None (after a counted, logged miss or reject) when it
        must come from the build directory or nvcc. An unbound cache
        (no fingerprint yet) answers None, uncounted."""
        if self.fingerprint is None:
            return None
        v, lib = self._open(program)
        status = v["status"]
        self.loads[str(program)] = {"status": status, "reason": v["reason"]}
        self.counts[{"hit": "hits", "miss": "misses", "reject": "rejects"}[status]] += 1
        metric = self._metrics.get(status)
        if metric is not None:
            metric.inc()
        if self.log is not None:
            self.log.event("boot_cache_load", program=str(program), status=status, reason=v["reason"])
        return lib

    # ------------------------------------------------------------- export

    def wants(self, program: str) -> bool:
        """Should this library be exported? Only when bound, among the
        bound libraries, not exported this boot, and not loaded from
        (or forecast valid in) the cache."""
        if self.fingerprint is None or program in self._exported:
            return False
        if self.programs and program not in self.programs:
            return False
        if self.loads.get(program, {}).get("status") == "hit":
            return False
        if self.plan is not None and program not in self.loads:
            v = self.plan["programs"].get(program)
            if v is not None and v["status"] == "hit":
                return False
        return True

    def _serialize(self, compiled) -> bytes:
        """A built library (its path) -> the artifact's payload."""
        return Path(compiled).read_bytes()

    def export(self, program: str, compiled) -> bool:
        """Write one library (`compiled`: the path of its .so) as a
        fingerprint-stamped artifact (atomic), then the manifest. Failures
        are recorded, never raised."""
        try:
            payload = self._serialize(compiled)
            _atomic_write(
                self.artifact_path(program),
                pack_artifact(MAGIC, self.fingerprint, payload,
                              extra={"program": str(program), "written_at": time.time()}),
            )
        except Exception as exc:
            self._errors[str(program)] = repr(exc)
            if self.log is not None:
                self.log.event("boot_cache_export_failed", program=str(program), error=repr(exc))
            return False
        self._exported.add(str(program))
        # artifacts of earlier boots that still validate stay listed
        entries = {}
        for p in dict.fromkeys(list(self.programs) + sorted(self._exported)):
            v = self._validate(p)
            if v["status"] == "hit":
                entries[p] = {"bytes": len(v["payload"])}
        self._write_manifest(entries)
        return True

    # --------------------------------------------------------- accounting

    def record_error(self, program: str, exc: BaseException) -> None:
        self._errors[str(program)] = repr(exc)

    @contextlib.contextmanager
    def boot_phase(self, phase: str):
        """Time one boot phase into `dalle_boot_seconds{phase=}` and
        `boot_seconds`."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            s = time.perf_counter() - t0
            self.boot_seconds[phase] = round(s, 4)
            if self._m_phase is not None:
                self._m_phase.labels(phase).set(s)

    def detail(self) -> Dict:
        return {
            "dir": str(self.dir),
            "fingerprint": self.fingerprint,
            "programs": list(self.programs),
            "plan": self.plan,
            "counts": dict(self.counts),
            "loads": {k: dict(v) for k, v in self.loads.items()},
            "exported": sorted(self._exported),
            "errors": dict(self._errors),
            "boot_seconds": dict(self.boot_seconds),
        }
