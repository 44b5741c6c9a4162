"""Serving observability: request tracing (`tracing.py`), structured logs
(`logging.py`), trace-context headers and the trace exporter
(`aggregate.py`), the fleet trace collector (`collector.py`), on-demand
`torch.profiler` captures (`profiler.py`), device telemetry (`vitals.py`:
the cost table, the vitals sampler, the stall watchdog and the SLO
tracker) and the fleet telemetry plane (`fleetmetrics.py`: the router's
scraper, usage ledger and capacity model); counterparts of the JAX
package's `obs/` modules of those names. Nothing here imports torch at
import time."""

from dalle_pytorch_tpu_torch.obs.aggregate import TRACE_HEADER, TraceExporter, format_trace_header, parse_trace_header
from dalle_pytorch_tpu_torch.obs.collector import CollectorServer, TraceCollector
from dalle_pytorch_tpu_torch.obs.fleetmetrics import CapacityModel, FleetScraper, UsageLedger
from dalle_pytorch_tpu_torch.obs.logging import StructuredLog
from dalle_pytorch_tpu_torch.obs.profiler import ProfilerBusy, ProfilerCapture
from dalle_pytorch_tpu_torch.obs.tracing import NULL_EXPORTER, NULL_TRACE, Span, Trace, Tracer
from dalle_pytorch_tpu_torch.obs.vitals import (
    NULL_VITALS,
    EngineVitals,
    ProgramCostTable,
    SLOTarget,
    SLOTracker,
    StallWatchdog,
)

__all__ = [
    "CapacityModel", "CollectorServer", "EngineVitals", "FleetScraper", "NULL_EXPORTER", "NULL_TRACE",
    "NULL_VITALS", "ProfilerBusy", "ProfilerCapture", "ProgramCostTable", "SLOTarget", "SLOTracker", "Span",
    "StallWatchdog", "StructuredLog", "TRACE_HEADER", "Trace", "TraceCollector", "TraceExporter", "Tracer",
    "UsageLedger", "format_trace_header", "parse_trace_header",
]
