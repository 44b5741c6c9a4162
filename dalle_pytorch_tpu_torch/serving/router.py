"""Fleet routing headers a replica parses.

The header part of the JAX package's `serving/router.py` (host code,
copied so the port imports nothing of that package): a router in front of
replicas stamps `x-dalle-route` (the replica, the attempt, whether it was
a hedge) and `x-dalle-request-key` (the request's content key) on every
dispatch. The port's server parses both into its request log lines; the
key also names the request's crash-spool checkpoint and lets a
re-dispatched stream re-attach. The router itself is not ported yet.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

#: routing-decision header: `replica;attempt;hedged`
ROUTE_HEADER = "x-dalle-route"

#: content-identity header: the request fingerprint
REQUEST_KEY_HEADER = "x-dalle-request-key"

_ROUTE_RE = re.compile(r"^([A-Za-z0-9_.\-]{1,64});(\d{1,4});([01])$")

_REQUEST_KEY_RE = re.compile(r"^[A-Za-z0-9_.\-]{1,64}$")


def parse_request_key(value) -> Optional[str]:
    """Strict, total parse of an inbound `x-dalle-request-key` header;
    None for anything malformed (the key lands in spool files and log
    lines)."""
    if not value or not isinstance(value, str):
        return None
    value = value.strip()
    return value if _REQUEST_KEY_RE.match(value) else None


def parse_route_header(value) -> Optional[Dict]:
    """Strict, total parse of an inbound `x-dalle-route` header into
    `{"replica", "attempt", "hedged"}`; None for anything malformed."""
    if not value or not isinstance(value, str):
        return None
    m = _ROUTE_RE.match(value.strip())
    if not m:
        return None
    return {"replica": m.group(1), "attempt": int(m.group(2)), "hedged": m.group(3) == "1"}
