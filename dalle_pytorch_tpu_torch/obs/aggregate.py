"""Trace-context propagation: the `x-dalle-trace` header.

The header half of the JAX package's `obs/aggregate.py` (host code,
copied so the port imports nothing of that package). A caller sends
`x-dalle-trace: <trace_id>[/<parent span uid>]`; the server adopts a valid
one as its request's trace ID (and records the caller's span as the
remote parent), so the caller's spans and the server's join on one ID.
Process identity (`default_site`, `sanitize_site`) is shared with the
structured log; the router parents its dispatch spans with
`format_trace_header` and names them with `span_uid_for`. The fleet
`TraceExporter` and collector are not ported yet.
"""

from __future__ import annotations

import os
import re
import socket
from typing import Optional, Tuple

#: the one propagation header (http.server looks headers up without case)
TRACE_HEADER = "x-dalle-trace"

_TRACE_ID_RE = re.compile(r"^[0-9a-f]{8,32}$")
_SPAN_UID_RE = re.compile(r"^[A-Za-z0-9_.:\-]{1,128}$")


def format_trace_header(trace_id: str, parent_uid: Optional[str] = None) -> str:
    """`x-dalle-trace` value of an outbound hop: the trace ID, or
    `<trace_id>/<parent_uid>` when the caller has a span for the callee's
    root to parent into."""
    return trace_id if parent_uid is None else f"{trace_id}/{parent_uid}"


def parse_trace_header(value) -> Optional[Tuple[str, Optional[str]]]:
    """Parse an inbound `x-dalle-trace` header into (trace_id, parent_uid).

    Total and strict: None (mint a fresh context) for a missing header, a
    trace ID that is not 8-32 lowercase hex digits, or a span UID that is
    too long or holds other characters."""
    if not value or not isinstance(value, str):
        return None
    trace_id, sep, parent_uid = value.strip().partition("/")
    if not _TRACE_ID_RE.match(trace_id):
        return None
    if not sep:
        return trace_id, None
    if not _SPAN_UID_RE.match(parent_uid):
        return None
    return trace_id, parent_uid


def sanitize_site(site: str) -> str:
    """Clamp a site name to the span-UID alphabet (no '/', spaces or ':'),
    at most 64 characters."""
    return re.sub(r"[^A-Za-z0-9_.\-]", "-", str(site))[:64] or "proc"


def default_site() -> str:
    """The process's default site name: $DALLE_TRACE_SITE, else the
    hostname, sanitized."""
    return sanitize_site(os.environ.get("DALLE_TRACE_SITE") or socket.gethostname() or "proc")


def span_uid_for(site: str, host: str, pid: int, span_id: int) -> str:
    """The span-UID identity format `site:host:pid:span_id`, one
    definition for every producer (host is part of it: two containerized
    replicas sharing a site both run as pid 1)."""
    return f"{site}:{host}:{pid}:{span_id}"
