"""Serving: the engines (`engine.py`), the batchers (`batcher.py`), QoS
(`qos.py`), fault injection (`faults.py`), decode-state migration
(`migrate.py`), streaming (`streaming.py`) and the HTTP server
(`server.py`); counterparts of the JAX package's modules of those names.
`python -m dalle_pytorch_tpu_torch.serve` is the command line."""

from dalle_pytorch_tpu_torch.serving.batcher import (
    ContinuousBatcher,
    MicroBatcher,
    QueueFullError,
    RequestCancelled,
    RequestTimeout,
    ShuttingDownError,
)
from dalle_pytorch_tpu_torch.serving.engine import (
    ContinuousEngine,
    GenerationEngine,
    PagedContinuousEngine,
    SampleSpec,
    SlotAllocator,
    engine_from_checkpoint,
)
from dalle_pytorch_tpu_torch.serving.faults import FaultInjector, InjectedFault
from dalle_pytorch_tpu_torch.serving.migrate import (
    CheckpointCorrupt,
    CheckpointMismatch,
    CheckpointSpool,
    MigratedError,
    RequestCheckpoint,
    RowCheckpoint,
)
from dalle_pytorch_tpu_torch.serving.qos import PRIORITY_CLASSES, ShedError, TenantQuotaError, WeightedFairQueue
from dalle_pytorch_tpu_torch.serving.server import ServingServer

__all__ = [
    "CheckpointCorrupt", "CheckpointMismatch", "CheckpointSpool", "ContinuousBatcher",
    "ContinuousEngine", "FaultInjector", "GenerationEngine", "InjectedFault", "MicroBatcher",
    "MigratedError", "PRIORITY_CLASSES", "PagedContinuousEngine", "QueueFullError",
    "RequestCancelled", "RequestCheckpoint", "RequestTimeout", "RowCheckpoint", "SampleSpec",
    "ServingServer", "ShedError", "ShuttingDownError", "SlotAllocator", "TenantQuotaError",
    "WeightedFairQueue", "engine_from_checkpoint",
]
