"""Per-request Context — counterpart of ``gofr_tpu/context.py``: the one
argument every handler receives.

It wraps the transport request (``param``, ``params``, ``path_param``,
``bind``, ``host_name``, ``headers``), reaches the container's members as
attributes (``ctx.sql``, ``ctx.ml``, ``ctx.logger``, ``ctx.config`` and
the other datasources, None until configured), its metric store
(``ctx.metrics()``), its datasources and inter-service clients by name,
opens user spans under the request's (``with ctx.trace("work"):``), reads
what an auth guard established (``get_auth_info()``), and writes
websocket frames to this request's socket or to a registered connection.
"""

from __future__ import annotations

from typing import Any

from .tracing import NoopTracer, Span

__all__ = ["Context", "AuthInfo"]

_DELEGATED = frozenset({
    "sql", "redis", "kv", "file", "pubsub", "cassandra", "clickhouse",
    "mongo", "dgraph", "solr", "opentsdb", "ml", "logger", "config"})


class AuthInfo:
    """The identity an auth guard left on the request."""

    def __init__(self, method: str | None, identity: Any) -> None:
        self._method = method
        self._identity = identity

    def get_username(self) -> str:
        return self._identity if self._method == "basic" else ""

    def get_api_key(self) -> str:
        return self._identity if self._method == "apikey" else ""

    def get_claims(self) -> dict:
        if self._method == "oauth" and isinstance(self._identity, dict):
            return self._identity
        return {}

    @property
    def method(self) -> str | None:
        return self._method


class Context:
    def __init__(self, request: Any, container, *, span: Span | None = None,
                 out: Any = None) -> None:
        self.request = request
        self.container = container
        self.span = span
        self.out = out

    def __getattr__(self, name: str) -> Any:
        if name in _DELEGATED:
            return getattr(self.container, name)
        raise AttributeError(f"Context has no attribute {name!r}")

    def metrics(self):
        return self.container.metrics_manager

    def get_http_service(self, name: str) -> Any:
        return self.container.get_http_service(name)

    def get_datasource(self, name: str) -> Any:
        return self.container.get_datasource(name)

    # -- the request -----------------------------------------------------------
    def param(self, key: str) -> str:
        return self.request.param(key)

    def params(self, key: str) -> list[str]:
        return self.request.params(key)

    def path_param(self, key: str) -> str:
        return self.request.path_param(key)

    async def bind(self, model: type | None = None) -> Any:
        return await self.request.bind(model)

    def host_name(self) -> str:
        return self.request.host_name()

    @property
    def headers(self) -> Any:
        return getattr(self.request, "headers", {})

    # -- tracing and auth ------------------------------------------------------
    def trace(self, name: str) -> Span:
        """A user span under the request's: ``with ctx.trace("work"):``."""
        tracer = self.container.tracer
        if tracer is None:
            tracer = self.container.tracer = NoopTracer()
        return tracer.start_span(name, parent=self.span)

    def get_auth_info(self) -> AuthInfo:
        raw = getattr(self.request, "raw", None)
        auth = raw.get("gofr_auth") if raw is not None else None
        if auth is None:
            return AuthInfo(None, None)
        return AuthInfo(auth[0], auth[1])

    # -- websockets ------------------------------------------------------------
    async def write_message_to_socket(self, data: Any) -> None:
        """Write one frame to this request's websocket."""
        ws = getattr(self.request, "websocket", None)
        if ws is None:
            raise RuntimeError("no websocket on this request")
        await ws.send_response(data)

    async def write_message_to_service(self, service_name: str,
                                       data: Any) -> None:
        """Write one frame to the connection registered as
        ``service_name`` in the container."""
        conn = self.container.websocket_connections.get(service_name)
        if conn is None:
            raise RuntimeError(
                f"no websocket connection registered for {service_name}")
        await conn.send_response(data)
