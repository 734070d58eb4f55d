"""The HTTP middleware chain — counterpart of
``gofr_tpu/http/middleware.py``, in the JAX package's order: tracing
(a span per request, parented on an incoming W3C ``traceparent``, named
by the route template), request logging with panic recovery (an
unexpected exception logs its stack and answers an opaque 500, every
request logs a ``RequestLog`` with its duration, and the trace id goes
back as ``X-Correlation-ID``), CORS from the ``ACCESS_CONTROL_*`` keys,
the ``app_http_response`` histogram by route template, method and
status, then the auth guards the app enabled: HTTP Basic, ``X-Api-Key``
and OAuth bearer tokens (a caller's decoder, or RS256 against a JWKS
document, ``jwks.py``). The guards let ``/.well-known/*`` and ``OPTIONS``
through, answer 401 with the JSON envelope, and leave the identity on
the request for ``ctx.get_auth_info()``."""

from __future__ import annotations

import base64
import hmac
import json
import time
import traceback
from dataclasses import dataclass
from http import HTTPStatus
from typing import Awaitable, Callable, TextIO

from aiohttp import web

from ..tracing import parse_traceparent

__all__ = ["RequestLog", "CORSConfig", "tracer_middleware",
           "logging_middleware", "cors_middleware", "metrics_middleware",
           "basic_auth_middleware", "api_key_auth_middleware",
           "oauth_middleware", "jwks_oauth_middleware", "is_well_known",
           "constant_time_equals"]

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


def is_well_known(path: str) -> bool:
    """Health and liveness stay reachable without credentials."""
    return path.startswith("/.well-known/")


def _bypass(request: web.Request) -> bool:
    return is_well_known(request.path) or request.method == "OPTIONS"


def _unauthorized(message: str = "Unauthorized") -> web.Response:
    return web.json_response({"error": {"message": message}},
                             status=HTTPStatus.UNAUTHORIZED)


def constant_time_equals(a: str, b: str) -> bool:
    return hmac.compare_digest(a.encode(), b.encode())


def basic_auth_middleware(validator: Callable[[str, str], bool]
                          ) -> Middleware:
    """HTTP Basic: ``validator(username, password)`` admits."""

    async def mw(request: web.Request, nxt: Handler) -> web.StreamResponse:
        if _bypass(request):
            return await nxt(request)
        header = request.headers.get("Authorization", "")
        if not header.startswith("Basic "):
            return _unauthorized()
        try:
            decoded = base64.b64decode(header[6:]).decode()
        except ValueError:  # bad base64 or bad UTF-8
            return _unauthorized("invalid authorization header")
        username, _, password = decoded.partition(":")
        if not validator(username, password):
            return _unauthorized()
        request["gofr_auth"] = ("basic", username)
        return await nxt(request)

    return mw


def api_key_auth_middleware(validator: Callable[[str], bool]) -> Middleware:
    """``X-Api-Key``: ``validator(key)`` admits."""

    async def mw(request: web.Request, nxt: Handler) -> web.StreamResponse:
        if _bypass(request):
            return await nxt(request)
        key = request.headers.get("X-Api-Key", "")
        if not key or not validator(key):
            return _unauthorized()
        request["gofr_auth"] = ("apikey", key)
        return await nxt(request)

    return mw


def _decode_unverified(token: str) -> dict:
    parts = token.split(".")
    if len(parts) != 3:
        raise ValueError("malformed JWT")
    payload = parts[1] + "=" * (-len(parts[1]) % 4)
    return json.loads(base64.urlsafe_b64decode(payload))


def oauth_middleware(decoder: Callable[[str], dict] | None = None
                     ) -> Middleware:
    """Bearer tokens through the caller's verifying ``decoder``, else
    their unverified claims (tests only; ``App.enable_oauth`` refuses it
    unless asked); an ``exp`` in the past is refused either way."""

    async def mw(request: web.Request, nxt: Handler) -> web.StreamResponse:
        if _bypass(request):
            return await nxt(request)
        header = request.headers.get("Authorization", "")
        if not header.startswith("Bearer "):
            return _unauthorized()
        token = header[7:]
        try:
            claims = (decoder(token) if decoder is not None
                      else _decode_unverified(token))
        except Exception as exc:  # the decoder's own failure: a 401
            return _unauthorized(f"invalid token: {exc}")
        exp = claims.get("exp")
        if isinstance(exp, (int, float)) and exp < time.time():
            return _unauthorized("token expired")
        request["gofr_auth"] = ("oauth", claims)
        return await nxt(request)

    return mw


def jwks_oauth_middleware(provider) -> Middleware:
    """Bearer tokens verified RS256 against ``provider``'s cached JWKS
    document (``jwks.JWKSProvider``)."""

    async def mw(request: web.Request, nxt: Handler) -> web.StreamResponse:
        if _bypass(request):
            return await nxt(request)
        header = request.headers.get("Authorization", "")
        if not header.startswith("Bearer "):
            return _unauthorized()
        try:
            claims = await provider.verify(header[7:])
        except Exception as exc:  # any token it cannot verify: a 401
            return _unauthorized(f"invalid token: {exc}")
        request["gofr_auth"] = ("oauth", claims)
        return await nxt(request)

    return mw
