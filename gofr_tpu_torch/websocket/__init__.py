"""WebSocket routes — counterpart of ``gofr_tpu/websocket``.

``App.websocket(route, handler)`` upgrades a GET request and re-invokes
the handler once per inbound message: ``ctx.bind()`` yields the frame
(parsed as JSON when it is JSON), the handler may write frames with
``ctx.write_message_to_socket``, and its return value is sent back as one
more frame. A handler that raises is logged and answers that message with
one error frame, ``{"error": {"message": ..., "status": ...}}`` (the
typed error's HTTP status, 500 for any other exception), so a streaming
caller whose request failed mid-stream is told so instead of waiting; the
connection stays open. (The JAX route sends nothing on an error.)
"""

from __future__ import annotations

import json
from typing import Any

from aiohttp import WSMsgType, web

from ..context import Context
from ..handler import HandlerFunc, invoke
from ..http.responder import to_jsonable

__all__ = ["Connection", "websocket_route_handler"]


class Connection:
    """A live websocket with a typed send helper."""

    def __init__(self, ws: web.WebSocketResponse) -> None:
        self.ws = ws
        self.current_message: Any = None

    async def send_response(self, data: Any) -> None:
        if isinstance(data, (bytes, bytearray)):
            await self.ws.send_bytes(bytes(data))
        elif isinstance(data, str):
            await self.ws.send_str(data)
        else:
            await self.ws.send_str(json.dumps(to_jsonable(data)))


class _WSRequest:
    """Request adapter: ``bind`` yields the current frame."""

    def __init__(self, raw: web.Request, conn: Connection) -> None:
        self.raw = raw
        self.websocket = conn

    def param(self, key: str) -> str:
        return self.raw.query.get(key, "")

    async def bind(self) -> Any:
        data = self.websocket.current_message
        try:
            return json.loads(data)
        except (json.JSONDecodeError, TypeError):
            return data


def websocket_route_handler(handler: HandlerFunc, container):
    async def ws_handler(request: web.Request) -> web.StreamResponse:
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        conn = Connection(ws)
        ctx = Context(_WSRequest(request, conn), container,
                      span=request.get("gofr_span"))
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
        return ws

    return ws_handler
