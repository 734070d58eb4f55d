"""Server-sent events (SSE) streaming responses — counterpart of
``gofr_tpu/http/sse.py``.

LLM serving APIs (the OpenAI wire format in particular) stream over HTTP
with ``text/event-stream``. ``EventStream`` wraps aiohttp's StreamResponse
so a handler can push frames and then return the stream; the responder
passes a prepared StreamResponse through untouched (``http/responder.py``).

    async def chat(ctx):
        async with EventStream(ctx) as stream:
            async for tok in ctx.ml.llm("chat").stream(ids, n):
                await stream.send({"token": tok})
            await stream.done()
        return stream.response
"""

from __future__ import annotations

import json
from typing import Any

from aiohttp import web

__all__ = ["EventStream"]


class EventStream:
    """An ``async with`` SSE session over the request's connection."""

    def __init__(self, ctx, *, headers: dict | None = None) -> None:
        self._raw_request = ctx.request.raw
        self._logger = getattr(ctx, "logger", None)
        # CORS / correlation-id middleware can't modify a prepared response,
        # so they pre-stash their headers on the request for us to merge
        stashed = {}
        try:
            stashed = dict(self._raw_request.get("gofr_response_headers", {}))
        except Exception:
            pass
        self.response = web.StreamResponse(
            status=200,
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "Connection": "keep-alive",
                **stashed,
                **(headers or {}),
            },
        )

    async def __aenter__(self) -> "EventStream":
        await self.response.prepare(self._raw_request)
        return self

    async def __aexit__(self, exc_type, exc, tb) -> bool:
        import asyncio

        suppress = False
        if exc is not None and not isinstance(
                exc, (ConnectionResetError, asyncio.CancelledError)):
            # headers + frames already went out: a fresh 500 response on
            # this connection would corrupt the wire, so surface the
            # failure as a terminal error event and suppress the exception
            # (the handler then returns the prepared stream as normal) —
            # but LOG it, or the failure is invisible server-side
            if self._logger is not None:
                try:
                    self._logger.errorf("error mid-SSE-stream: %r", exc)
                except Exception:
                    pass
            try:
                await self.send({"error": {"message": str(exc)}},
                                event="error")
            except Exception:
                pass
            suppress = True
        try:
            await self.response.write_eof()
        except ConnectionResetError:
            pass
        return suppress or exc_type is ConnectionResetError

    async def send(self, data: Any, *, event: str | None = None) -> None:
        """Write one SSE frame; dicts/lists are JSON-encoded. Multi-line
        string payloads become one ``data:`` line per line (the SSE spec
        drops anything after a bare newline inside a frame)."""
        if not isinstance(data, str):
            data = json.dumps(data)
        frame = ""
        if event:
            frame += f"event: {event.splitlines()[0]}\n"
        # splitlines handles \n, \r and \r\n — all SSE line terminators;
        # an empty payload still needs its one data: line
        for line in data.splitlines() or [""]:
            frame += f"data: {line}\n"
        frame += "\n"
        await self.response.write(frame.encode())

    async def done(self) -> None:
        """The OpenAI-style terminal sentinel frame."""
        await self.response.write(b"data: [DONE]\n\n")
