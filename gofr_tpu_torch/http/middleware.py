"""The HTTP middleware chain — counterpart of
``gofr_tpu/http/middleware.py``, in the JAX package's order: tracing
(a span per request, parented on an incoming W3C ``traceparent``, named
by the route template), request logging with panic recovery (an
unexpected exception logs its stack and answers an opaque 500, every
request logs a ``RequestLog`` with its duration, and the trace id goes
back as ``X-Correlation-ID``), and the ``app_http_response`` histogram by
route template, method and status. The CORS and auth middlewares of the
JAX package are not ported."""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass
from http import HTTPStatus
from typing import Awaitable, Callable, TextIO

from aiohttp import web

from ..tracing import parse_traceparent

__all__ = ["RequestLog", "CORSConfig", "tracer_middleware",
           "logging_middleware", "cors_middleware", "metrics_middleware"]

Handler = Callable[[web.Request], Awaitable[web.StreamResponse]]
Middleware = Callable[[web.Request, Handler], Awaitable[web.StreamResponse]]


@dataclass
class RequestLog:
    """One request's structured log entry."""

    trace_id: str = ""
    span_id: str = ""
    start_time: str = ""
    response_time_us: int = 0
    method: str = ""
    ip: str = ""
    uri: str = ""
    response_code: int = 0

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "start_time": self.start_time,
                "response_time": self.response_time_us,
                "method": self.method, "ip": self.ip, "uri": self.uri,
                "response": self.response_code}

    def pretty_print(self, writer: TextIO) -> None:
        code = self.response_code
        color = 34 if code < 300 else (220 if code < 500 else 202)
        writer.write(f"\x1b[38;5;8m{self.trace_id}\x1b[0m "
                     f"\x1b[38;5;{color}m{code}\x1b[0m "
                     f"{self.response_time_us:10d}μs {self.method} "
                     f"{self.uri} ")


def _route_template(request: web.Request) -> str | None:
    route = getattr(request.match_info, "route", None)
    return getattr(getattr(route, "resource", None), "canonical", None)


def tracer_middleware(tracer) -> Middleware:
    async def mw(request: web.Request, nxt: Handler) -> web.StreamResponse:
        parent = parse_traceparent(request.headers.get("traceparent"))
        span = tracer.start_span(
            f"{request.method} {request.path}", parent=parent, kind="SERVER",
            attributes={"http.method": request.method,
                        "http.target": request.path_qs})
        request["gofr_span"] = span
        try:
            resp = await nxt(request)
            span.set_attribute("http.status_code", getattr(resp, "status", 0))
            return resp
        except Exception as exc:
            span.record_exception(exc)
            raise
        finally:
            # the route template, not the raw path, bounds span names
            template = _route_template(request)
            if template:
                span.name = f"{request.method} {template}"
                span.set_attribute("http.route", template)
            span.end()

    return mw


def _client_ip(request: web.Request) -> str:
    fwd = request.headers.get("X-Forwarded-For")
    if fwd:
        return fwd.split(",")[0].strip()
    peer = (request.transport.get_extra_info("peername")
            if request.transport else None)
    return peer[0] if peer else ""


def logging_middleware(logger) -> Middleware:
    async def mw(request: web.Request, nxt: Handler) -> web.StreamResponse:
        start = time.perf_counter()
        span = request.get("gofr_span")
        trace_id = span.trace_id if span is not None else ""
        if trace_id:
            # a streaming handler prepares its response before this
            # middleware can touch it: EventStream merges the stash
            request.setdefault("gofr_response_headers", {})[
                "X-Correlation-ID"] = trace_id
        start_str = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime())
        resp = None
        try:
            resp = await nxt(request)
        except web.HTTPException as exc:
            resp = exc
            raise
        except Exception:
            logger.error("panic recovered", stack=traceback.format_exc(),
                         method=request.method, uri=request.path_qs)
            resp = web.json_response(
                {"error": {"message": "some unexpected error has occurred"}},
                status=HTTPStatus.INTERNAL_SERVER_ERROR)
        finally:
            status = getattr(resp, "status", 0) if resp is not None else 0
            entry = RequestLog(
                trace_id=trace_id,
                span_id=span.span_id if span is not None else "",
                start_time=start_str,
                response_time_us=int((time.perf_counter() - start) * 1e6),
                method=request.method, ip=_client_ip(request),
                uri=request.path_qs, response_code=status)
            (logger.error if status >= 500 else logger.info)(entry)
        if trace_id and not resp.prepared:
            resp.headers["X-Correlation-ID"] = trace_id
        return resp

    return mw


@dataclass
class CORSConfig:
    """Built from the ``ACCESS_CONTROL_*`` keys, JAX's defaults."""

    allow_origin: str = "*"
    allow_headers: str = ("Authorization, Content-Type, x-requested-with, "
                          "origin, true-client-ip, X-Correlation-ID")
    allow_methods: str = ""
    allow_credentials: str = ""
    expose_headers: str = ""
    max_age: str = ""

    @classmethod
    def from_config(cls, config) -> "CORSConfig":
        c = cls()
        get = config.get_or_default
        c.allow_origin = get("ACCESS_CONTROL_ALLOW_ORIGIN", c.allow_origin)
        c.allow_headers = get("ACCESS_CONTROL_ALLOW_HEADERS", c.allow_headers)
        c.allow_methods = get("ACCESS_CONTROL_ALLOW_METHODS", "")
        c.allow_credentials = get("ACCESS_CONTROL_ALLOW_CREDENTIALS", "")
        c.expose_headers = get("ACCESS_CONTROL_EXPOSE_HEADERS", "")
        c.max_age = get("ACCESS_CONTROL_MAX_AGE", "")
        return c

    def headers(self, registered_methods: str) -> dict[str, str]:
        out = {
            "Access-Control-Allow-Origin": self.allow_origin,
            "Access-Control-Allow-Headers": self.allow_headers,
            "Access-Control-Allow-Methods": (self.allow_methods
                                             or registered_methods),
        }
        if self.allow_credentials:
            out["Access-Control-Allow-Credentials"] = self.allow_credentials
        if self.expose_headers:
            out["Access-Control-Expose-Headers"] = self.expose_headers
        if self.max_age:
            out["Access-Control-Max-Age"] = self.max_age
        return out


def cors_middleware(cfg: CORSConfig,
                    registered_methods: Callable[[], str]) -> Middleware:
    async def mw(request: web.Request, nxt: Handler) -> web.StreamResponse:
        hdrs = cfg.headers(registered_methods())
        if request.method == "OPTIONS":
            return web.Response(status=HTTPStatus.OK, headers=hdrs)
        request.setdefault("gofr_response_headers", {}).update(hdrs)
        resp = await nxt(request)
        if not resp.prepared:
            for k, v in hdrs.items():
                resp.headers[k] = v
        return resp

    return mw


def metrics_middleware(metrics) -> Middleware:
    async def mw(request: web.Request, nxt: Handler) -> web.StreamResponse:
        start = time.perf_counter()
        status = 500
        try:
            resp = await nxt(request)
            status = getattr(resp, "status", 200)
            return resp
        except web.HTTPException as exc:
            status = exc.status
            raise
        finally:
            metrics.record_histogram(
                "app_http_response", time.perf_counter() - start,
                path=_route_template(request) or request.path,
                method=request.method, status=str(status))

    return mw
