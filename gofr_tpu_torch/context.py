"""Per-request Context — counterpart of ``gofr_tpu/context.py``: the one
argument every handler receives. It wraps the transport request
(``bind``, ``param``, ``headers``), reaches the container's members as
attributes (``ctx.ml``, ``ctx.logger``, ``ctx.config``), and writes
websocket frames with ``write_message_to_socket``."""

from __future__ import annotations

from typing import Any

__all__ = ["Context"]

_DELEGATED = frozenset({"ml", "logger", "config"})


class Context:
    def __init__(self, request: Any, container, *, span=None) -> None:
        self.request = request
        self.container = container
        self.span = span

    def __getattr__(self, name: str) -> Any:
        if name in _DELEGATED:
            return getattr(self.container, name)
        raise AttributeError(f"Context has no attribute {name!r}")

    def param(self, key: str) -> str:
        return self.request.param(key)

    @property
    def headers(self) -> Any:
        return getattr(self.request, "headers", {})

    async def bind(self) -> Any:
        return await self.request.bind()

    async def write_message_to_socket(self, data: Any) -> None:
        """Write one frame to this request's websocket."""
        ws = getattr(self.request, "websocket", None)
        if ws is None:
            raise RuntimeError("no websocket on this request")
        await ws.send_response(data)
