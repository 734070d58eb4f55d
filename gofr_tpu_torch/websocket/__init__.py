"""WebSocket routes — counterpart of ``gofr_tpu/websocket``.

``App.websocket(route, handler)`` upgrades a GET request and re-invokes
the handler once per inbound message: ``ctx.bind()`` yields the frame
(parsed as JSON when it is JSON; ``ctx.bind(model)`` binds it like an HTTP
body), the handler may write frames with ``ctx.write_message_to_socket``,
and its return value is sent back as one more frame. A live connection is
registered in the container's ``websocket_connections`` under its
``Sec-WebSocket-Key`` until it closes. A handler that raises is logged
and answers that message with one error frame, ``{"error": {"message":
..., "status": ...}}`` (the typed error's HTTP status, 500 for any other
exception), so a streaming caller whose request failed mid-stream is told
so instead of waiting; the connection stays open. (The JAX route sends nothing on an error.)
"""

from __future__ import annotations

import json
from typing import Any

from aiohttp import WSMsgType, web

from ..context import Context
from ..handler import HandlerFunc, invoke
from ..http.request import bind_to_model
from ..http.responder import to_jsonable

__all__ = ["Connection", "websocket_route_handler"]


class Connection:
    """A live websocket with a typed send helper."""

    def __init__(self, ws: web.WebSocketResponse, key: str = "") -> None:
        self.ws = ws
        self.key = key
        self.current_message: Any = None

    async def send_response(self, data: Any) -> None:
        if isinstance(data, (bytes, bytearray)):
            await self.ws.send_bytes(bytes(data))
        elif isinstance(data, str):
            await self.ws.send_str(data)
        else:
            await self.ws.send_str(json.dumps(to_jsonable(data)))

    async def close(self) -> None:
        await self.ws.close()


class _WSRequest:
    """Request adapter: ``bind`` yields the current frame."""

    def __init__(self, raw: web.Request, conn: Connection) -> None:
        self.raw = raw
        self.websocket = conn

    def param(self, key: str) -> str:
        return self.raw.query.get(key, "")

    def params(self, key: str) -> list[str]:
        return list(self.raw.query.getall(key, []))

    def path_param(self, key: str) -> str:
        return self.raw.match_info.get(key, "")

    def host_name(self) -> str:
        return f"ws://{self.raw.host}"

    def context(self) -> Any:
        return self.raw

    @property
    def headers(self):
        return self.raw.headers

    async def bind(self, model: type | None = None) -> Any:
        data = self.websocket.current_message
        if model is not None:
            return bind_to_model(json.loads(data), model)
        try:
            return json.loads(data)
        except (json.JSONDecodeError, TypeError):
            return data


def websocket_route_handler(handler: HandlerFunc, container):
    async def ws_handler(request: web.Request) -> web.StreamResponse:
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        key = request.headers.get("Sec-WebSocket-Key", str(id(ws)))
        conn = Connection(ws, key)
        container.websocket_connections[key] = conn
        ctx = Context(_WSRequest(request, conn), container,
                      span=request.get("gofr_span"))
        try:
            await _serve(ws, conn, ctx, handler, container)
        finally:
            container.websocket_connections.pop(key, None)
        return ws

    return ws_handler


async def _serve(ws, conn: Connection, ctx: Context, handler: HandlerFunc,
                 container) -> None:
    """The read loop: the handler once per inbound message."""
    async for msg in ws:
        if msg.type in (WSMsgType.TEXT, WSMsgType.BINARY):
            conn.current_message = msg.data
        elif msg.type in (WSMsgType.CLOSE, WSMsgType.ERROR):
            break
        else:
            continue
        try:
            result = await invoke(handler, ctx)
        except Exception as exc:
            container.logger.errorf("websocket handler error: %s", exc)
            status = getattr(exc, "status_code", None)
            await conn.send_response({"error": {
                "message": str(exc) if status is not None
                else "internal error",
                "status": int(status) if status is not None else 500}})
            continue
        if result is not None:
            await conn.send_response(result)
