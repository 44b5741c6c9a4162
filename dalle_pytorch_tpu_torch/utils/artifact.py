"""Boot fingerprints and the self-validating artifact container.

Counterpart of the part of the JAX package's `utils/compile_cache.py`
that decode-state checkpoints (`serving/migrate.py`) and the port's
kernel-library compile cache (`utils/compile_cache.py`) share: the boot
fingerprint, its canonical-JSON and config helpers, and `pack_artifact` /
`unpack_artifact`. The container is byte for byte the reference's — MAGIC
+ canonical-JSON header (format version, fingerprint, payload length,
payload sha256) + one newline + payload — so a blob written by either
package opens in the other under the same fingerprint string. The port's
fingerprint names torch's version and the device kind where the
reference's names jax's version and backend.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, Optional, Sequence

#: container format: bump on any layout change so an old artifact is a
#: clean miss, not a parse error
FORMAT_VERSION = 1


def _canonical(obj) -> str:
    """Deterministic JSON for fingerprint hashing: sorted keys, compact,
    repr for leaves JSON cannot hold."""
    return json.dumps(obj, sort_keys=True, default=repr, separators=(",", ":"))


def config_payload(cfg) -> object:
    """Stable serialization of a model config for the fingerprint: JSON
    values pass through, objects with `to_dict` / `as_dict` use it, and
    anything else falls back to its repr."""
    if cfg is None or isinstance(cfg, (dict, list, str, int, float, bool)):
        return cfg
    for attr in ("to_dict", "as_dict"):
        fn = getattr(cfg, attr, None)
        if callable(fn):
            try:
                return fn()
            except Exception:
                pass
    return repr(cfg)


def device_kind(device) -> str:
    """The name a fingerprint gives a device: the card's name for CUDA
    (`torch.cuda.get_device_name`), else the device type."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def boot_fingerprint(
    device: Optional[str] = None,
    mesh_shape=None,
    model_config=None,
    programs: Sequence[str] = (),
    torch_version: Optional[str] = None,
    extra=None,
) -> str:
    """Stable identity of one serving build: any drift (a torch upgrade,
    another device kind, a new model config, a program added to the
    engine's ladder, `extra`) changes it, so a stale artifact or
    checkpoint becomes a miss instead of a wrong resume."""
    if torch_version is None:
        import torch

        torch_version = torch.__version__
    payload = {
        "format": FORMAT_VERSION,
        "torch": torch_version,
        "device": device,
        "mesh": mesh_shape,
        "model": config_payload(model_config),
        "programs": sorted(str(p) for p in programs),
        "extra": extra,
    }
    return hashlib.sha256(_canonical(payload).encode()).hexdigest()[:32]


def pack_artifact(
    magic: bytes,
    fingerprint: str,
    payload: bytes,
    format_version: int = FORMAT_VERSION,
    extra: Optional[Dict] = None,
) -> bytes:
    """Payload -> self-validating blob (the caller picks MAGIC and the
    format version; `extra` adds caller-specific header fields)."""
    header = {
        "format": int(format_version),
        "fingerprint": str(fingerprint),
        "payload_bytes": len(payload),
        "payload_sha256": hashlib.sha256(payload).hexdigest(),
        **(extra or {}),
    }
    return bytes(magic) + _canonical(header).encode() + b"\n" + bytes(payload)


def unpack_artifact(raw: bytes, magic: bytes, fingerprint: str, format_version: int = FORMAT_VERSION):
    """Blob -> (status, reason, payload): "hit" (valid), "miss" (another
    build's artifact: format or fingerprint drift) or "reject" (integrity
    failure: bad magic, corrupt header, truncated payload, checksum
    mismatch). Never raises."""
    if not raw.startswith(magic):
        return "reject", "bad magic", None
    rest = raw[len(magic):]
    try:
        nl = rest.index(b"\n")
        header = json.loads(rest[:nl])
    except Exception as exc:
        return "reject", f"corrupt header: {exc!r}", None
    payload = rest[nl + 1:]
    try:
        if int(header.get("format", -1)) != int(format_version):
            return "miss", f"format {header.get('format')} != {format_version}", None
        if header.get("fingerprint") != str(fingerprint):
            return (
                "miss",
                f"fingerprint mismatch ({header.get('fingerprint')!r} != {str(fingerprint)!r})",
                None,
            )
        if len(payload) != int(header.get("payload_bytes", -1)):
            return "reject", "truncated payload", None
        if hashlib.sha256(payload).hexdigest() != header.get("payload_sha256"):
            return "reject", "checksum mismatch", None
    except Exception as exc:
        return "reject", f"corrupt header: {exc!r}", None
    return "hit", None, payload
