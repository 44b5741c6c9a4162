"""Serving: the engines (`engine.py`, tensor-parallel in `sharded.py`), the
batchers (`batcher.py`), QoS (`qos.py`), fault injection (`faults.py`),
decode-state migration (`migrate.py`), streaming (`streaming.py`), the
HTTP server (`server.py`) and the replica fleet in front of it: the router
(`router.py`) and the crash-fast supervisor (`supervisor.py`);
counterparts of the JAX package's modules of those names.
`python -m dalle_pytorch_tpu_torch.serve` is the command line.

The names below load on first use, so importing the router or the
supervisor (`serve --router`, `serve --supervise`) does not import torch:
those processes never touch the card.
"""

from importlib import import_module

_EXPORTS = {
    "batcher": (
        "ContinuousBatcher", "MicroBatcher", "QueueFullError", "RequestCancelled",
        "RequestTimeout", "ShuttingDownError",
    ),
    "engine": (
        "ContinuousEngine", "GenerationEngine", "PagedContinuousEngine", "SampleSpec",
        "SlotAllocator", "engine_from_checkpoint",
    ),
    "faults": ("FaultInjector", "InjectedFault"),
    "migrate": (
        "CheckpointCorrupt", "CheckpointMismatch", "CheckpointSpool", "MigratedError",
        "RequestCheckpoint", "RowCheckpoint", "decode_checkpoint", "encode_checkpoint",
        "from_wire", "to_wire",
    ),
    "qos": ("PRIORITY_CLASSES", "ShedError", "TenantQuotaError", "WeightedFairQueue"),
    "router": ("FleetRouter", "QuarantineTracker", "RetryBudget", "RouterServer", "request_fingerprint"),
    "server": ("ServingServer",),
    "sharded": (
        "ShardedContinuousEngine", "ShardedPagedContinuousEngine", "build_serving_mesh",
        "parse_mesh_shape",
    ),
    "supervisor": ("ReplicaSupervisor",),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
