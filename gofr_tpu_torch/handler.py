"""Handler engine — counterpart of ``gofr_tpu/handler.py``.

``wrap_handler`` turns a user handler into an aiohttp handler: it builds
the ``Context``, runs the handler (async on the loop, sync on a worker
thread) with the optional ``REQUEST_TIMEOUT`` (408), keeps a typed
``GofrError`` as the answer, turns any other exception into a logged,
opaque 500, and maps (result, error) to the response with the responder.
The default routes' handlers live here too: ``/.well-known/health``
(the container's aggregate; 503 with the full payload when a datasource
is DOWN), ``/.well-known/alive`` and the catch-all 404 / 405.
"""

from __future__ import annotations

import asyncio
import inspect
import traceback
from typing import Any, Awaitable, Callable

from aiohttp import web

from .context import Context
from .http.errors import (GofrError, InvalidRoute, PanicRecovery,
                          RequestTimeout, ServiceUnavailable)
from .http.request import HTTPRequest
from .http.responder import respond

__all__ = ["wrap_handler", "invoke", "HandlerFunc", "health_handler",
           "alive_handler", "catch_all_handler"]

HandlerFunc = Callable[[Context], Any | Awaitable[Any]]


async def invoke(func: HandlerFunc, ctx: Context) -> Any:
    """Call a sync-or-async handler; a sync one runs on the default
    executor so it never blocks the loop."""
    if inspect.iscoroutinefunction(func):
        return await func(ctx)
    result = await asyncio.get_running_loop().run_in_executor(None, func, ctx)
    if inspect.isawaitable(result):
        return await result
    return result


def wrap_handler(func: HandlerFunc, container,
                 request_timeout: float | None = None
                 ) -> Callable[[web.Request], Awaitable[web.StreamResponse]]:
    async def aio_handler(request: web.Request) -> web.StreamResponse:
        ctx = Context(HTTPRequest(request), container,
                      span=request.get("gofr_span"))
        result: Any = None
        err: BaseException | None = None
        try:
            coro = invoke(func, ctx)
            if request_timeout and request_timeout > 0:
                result = await asyncio.wait_for(coro, timeout=request_timeout)
            else:
                result = await coro
        except asyncio.TimeoutError:
            err = RequestTimeout()
        except GofrError as exc:
            err = exc
        except web.HTTPException:
            raise
        except Exception as exc:
            # panic recovery: log the stack, answer an opaque 500 so
            # internals never leak
            container.logger.error("handler panic", error=str(exc),
                                   type=type(exc).__name__,
                                   stack=traceback.format_exc())
            err = PanicRecovery()
        return respond(request.method, result, err)

    return aio_handler


def health_handler(container):
    """Aggregated readiness. A datasource reporting DOWN (a dead or closed
    LLM server) answers 503 with the full health payload in the error
    envelope, so a load balancer stops routing here."""

    async def handler(ctx: Context) -> Any:
        health = await ctx.container.health()
        if any(isinstance(v, dict) and v.get("status") == "DOWN"
               for v in health.values()):
            err = ServiceUnavailable("one or more datasources are DOWN")
            err.response = dict(health)
            raise err
        return health

    return handler


async def alive_handler(_: Context) -> Any:
    return {"status": "UP"}


class MethodNotAllowed(GofrError):
    status_code = 405


async def catch_all_handler(ctx: Context) -> Any:
    """404 for an unknown path; 405 when the path exists under another
    method."""
    raw = ctx.request.raw
    allowed: set[str] = set()
    for resource in raw.app.router.resources():
        if getattr(resource, "canonical", "") == "/{tail}":
            continue
        try:
            _, methods = await resource.resolve(raw)
        except Exception:
            continue
        allowed |= methods
    if allowed and raw.method not in allowed:
        raise MethodNotAllowed("method not allowed")
    raise InvalidRoute()
