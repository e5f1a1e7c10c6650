"""The ``_status`` builtin service: /vars and /rpcz served over the RPC
fabric itself (reference src/brpc/builtin/ — every bRPC server ships its
introspection pages on its own port; here they ride the same brt_std
framing as user services, so any ``Channel`` can scrape any node).

Wire mapping (payloads are UTF-8/JSON, like the naming bridge):

- ``vars``       req = optional filter string → rsp = ``/vars`` text dump
- ``vars_json``  req = optional filter string → rsp = JSON object
- ``rpcz``       req = optional JSON query {limit, service, method, side,
                 errors_only} → rsp = JSON list of span dicts (newest
                 first)
- ``rpcz_text``  same query → rsp = one-line-per-span text
- ``health``     empty req → ``ok`` (the plain liveness probe the
                 resilience tier's HealthProber and the reference's
                 health checker use); any non-empty req (convention:
                 ``full``) → JSON per-component health — circuit-breaker
                 states per endpoint, last probe results, racecheck/obs
                 gates (``brpc_tpu_torch.resilience.health_components``)

Registered via ``rpc.Server.add_status_service()``; client side via
:func:`scrape_vars` / :func:`scrape_rpcz` over an existing ``Channel``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from brpc_tpu_torch.obs import rpcz, vars as obs_vars

SERVICE_NAME = "_status"


def _parse_query(payload: bytes) -> dict:
    if not payload:
        return {}
    q = json.loads(payload.decode())
    if not isinstance(q, dict):
        raise ValueError("rpcz query must be a JSON object")
    allowed = {"limit", "service", "method", "side", "errors_only"}
    unknown = set(q) - allowed
    if unknown:
        raise ValueError(f"unknown rpcz query keys: {sorted(unknown)}")
    return q


def make_status_handler(registry: "Optional[obs_vars.Registry]" = None,
                        ring: "Optional[rpcz.SpanRing]" = None):
    """Returns ``fn(method, request) -> bytes`` for ``Server.add_service``."""
    reg = registry or obs_vars.default_registry()
    # an empty SpanRing is falsy (__len__), so test identity, not truth
    rng = rpcz.default_ring() if ring is None else ring

    def handler(method: str, request: bytes) -> bytes:
        if method == "health":
            if not request:
                return b"ok"  # plain probes keep the bare contract
            # resilience imports obs; this hook runs lazily so the
            # dependency stays one-way at import time
            from brpc_tpu_torch import resilience
            return json.dumps(resilience.health_components()).encode()
        if method == "vars":
            return reg.dump_exposed(request.decode() or None).encode()
        if method == "vars_json":
            return json.dumps(
                reg.dump_exposed_dict(request.decode() or None)).encode()
        if method in ("rpcz", "rpcz_text"):
            q = _parse_query(request)
            spans = rng.dump(limit=int(q.get("limit", 50)),
                             service=q.get("service"),
                             method=q.get("method"),
                             side=q.get("side"),
                             errors_only=bool(q.get("errors_only", False)))
            if method == "rpcz_text":
                return rpcz.format_rpcz(spans).encode()
            return json.dumps(spans).encode()
        raise ValueError(f"unknown _status method {method}")

    return handler


# ---- client side: scrape a remote node over an existing Channel ----

def scrape_health(channel, full: bool = False):
    """Remote health: the bare ``"ok"`` string, or the structured
    per-component dict with ``full=True``."""
    if not full:
        return channel.call(SERVICE_NAME, "health").decode()
    raw = channel.call(SERVICE_NAME, "health", b"full")
    return json.loads(raw.decode())

def scrape_vars(channel, filter: str = "", json_form: bool = False):
    """Remote ``dump_exposed``: text by default, dict with json_form."""
    if json_form:
        raw = channel.call(SERVICE_NAME, "vars_json", filter.encode())
        return json.loads(raw.decode())
    return channel.call(SERVICE_NAME, "vars", filter.encode()).decode()


def scrape_rpcz(channel, limit: int = 50, service: Optional[str] = None,
                method: Optional[str] = None, side: Optional[str] = None,
                errors_only: bool = False) -> List[Dict[str, object]]:
    """Remote ``dump_rpcz``: newest-first span dicts from the peer."""
    q = {"limit": limit, "errors_only": errors_only}
    if service is not None:
        q["service"] = service
    if method is not None:
        q["method"] = method
    if side is not None:
        q["side"] = side
    raw = channel.call(SERVICE_NAME, "rpcz", json.dumps(q).encode())
    return json.loads(raw.decode())
