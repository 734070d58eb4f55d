"""Inter-service HTTP clients — counterpart of ``gofr_tpu/service``.

``HTTPService`` is the base client: each call opens a CLIENT span, sends
its W3C ``traceparent``, logs the call at DEBUG and records the
``app_http_service_response`` histogram; ``health_check`` GETs its health
endpoint (``.well-known/alive`` by default). Options wrap it in the order
given (``new_http_service`` / ``App.add_http_service``):
``CircuitBreakerConfig`` (after more than ``threshold`` consecutive
failures, an exception or a 5xx, calls fail fast with ``CircuitOpenError``
while a background probe checks health every ``interval`` seconds and
closes the circuit when it is UP), ``RetryConfig`` (an exception or a 5xx
is retried up to ``max_retries`` times), ``HealthConfig``,
``BasicAuthConfig``, ``APIKeyConfig``, ``DefaultHeaders`` and
``OAuthConfig`` (client credentials: a token fetched from ``token_url``
and cached until 30 s before it expires).
"""

from __future__ import annotations

import asyncio
import base64
import json
import time
from dataclasses import dataclass, field
from typing import Any, Mapping

import aiohttp

from ..metrics import MetricsError
from ..tracing import Tracer, format_traceparent

__all__ = [
    "HTTPService",
    "Response",
    "CircuitBreakerConfig",
    "CircuitOpenError",
    "RetryConfig",
    "HealthConfig",
    "BasicAuthConfig",
    "APIKeyConfig",
    "OAuthConfig",
    "DefaultHeaders",
    "new_http_service",
]


class CircuitOpenError(Exception):
    def __init__(self) -> None:
        super().__init__("circuit breaker is open; request failed fast")


@dataclass
class Response:
    status_code: int
    body: bytes
    headers: Mapping[str, str]

    def json(self) -> Any:
        return json.loads(self.body)

    @property
    def text(self) -> str:
        return self.body.decode("utf-8", errors="replace")

    @property
    def ok(self) -> bool:
        return 200 <= self.status_code < 300


class HTTPService:
    """Base outbound client: spans, logs and metrics on every call."""

    def __init__(self, address: str, logger=None, metrics=None,
                 tracer: Tracer | None = None) -> None:
        self.address = address.rstrip("/")
        self._logger = logger
        self._metrics = metrics
        self._tracer = tracer
        self._session: aiohttp.ClientSession | None = None
        self.health_endpoint = ".well-known/alive"
        self.health_timeout = 5.0

    def _ensure_session(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession()
        return self._session

    async def request(
        self,
        method: str,
        path: str,
        *,
        params: Mapping[str, str] | None = None,
        body: bytes | None = None,
        json_body: Any = None,
        headers: Mapping[str, str] | None = None,
    ) -> Response:
        url = f"{self.address}/{path.lstrip('/')}" if path else self.address
        hdrs = dict(headers or {})
        span = None
        if self._tracer is not None:
            span = self._tracer.start_span(
                f"http-service {method} {path}", kind="CLIENT",
                attributes={"http.url": url, "http.method": method},
            )
            hdrs["traceparent"] = format_traceparent(span.context)
        start = time.perf_counter()
        status = 0
        try:
            session = self._ensure_session()
            if json_body is not None:
                body = json.dumps(json_body).encode()
                hdrs.setdefault("Content-Type", "application/json")
            async with session.request(
                method, url, params=params, data=body, headers=hdrs
            ) as resp:
                status = resp.status
                payload = await resp.read()
                return Response(resp.status, payload, dict(resp.headers))
        except Exception as exc:
            if span is not None:
                span.record_exception(exc)
            raise
        finally:
            dur = time.perf_counter() - start
            if span is not None:
                span.set_attribute("http.status_code", status)
                span.end()
            if self._logger is not None:
                self._logger.debug(
                    {"service": self.address, "method": method, "path": path,
                     "status": status, "duration": int(dur * 1e6)}
                )
            if self._metrics is not None:
                try:
                    self._metrics.record_histogram(
                        "app_http_service_response", dur,
                        service=self.address, method=method,
                        status=str(status))
                except MetricsError:
                    pass  # a manager without the framework's metric set

    # verb helpers ------------------------------------------------------------
    async def get(self, path: str, params: Mapping[str, str] | None = None,
                  headers: Mapping[str, str] | None = None) -> Response:
        return await self.request("GET", path, params=params, headers=headers)

    async def get_with_headers(self, path: str, params=None,
                               headers=None) -> Response:
        return await self.request("GET", path, params=params, headers=headers)

    async def post(self, path: str, *, params=None, body: bytes | None = None,
                   json_body: Any = None, headers=None) -> Response:
        return await self.request("POST", path, params=params, body=body,
                                  json_body=json_body, headers=headers)

    async def put(self, path: str, *, params=None, body: bytes | None = None,
                  json_body: Any = None, headers=None) -> Response:
        return await self.request("PUT", path, params=params, body=body,
                                  json_body=json_body, headers=headers)

    async def patch(self, path: str, *, params=None, body: bytes | None = None,
                    json_body: Any = None, headers=None) -> Response:
        return await self.request("PATCH", path, params=params, body=body,
                                  json_body=json_body, headers=headers)

    async def delete(self, path: str, *, body: bytes | None = None,
                     headers=None) -> Response:
        return await self.request("DELETE", path, body=body, headers=headers)

    # health ------------------------------------------------------------------
    async def health_check(self) -> dict:
        try:
            resp = await asyncio.wait_for(
                self.request("GET", self.health_endpoint),
                timeout=self.health_timeout)
            if resp.ok:
                return {"status": "UP", "details": {"host": self.address}}
            return {"status": "DOWN", "details": {"host": self.address,
                                                  "code": resp.status_code}}
        except Exception as exc:
            return {"status": "DOWN", "details": {"host": self.address},
                    "error": str(exc)}

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()


class _Decorator:
    """Base: delegate everything to the wrapped service."""

    def __init__(self, inner) -> None:
        self._inner = inner

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)

    async def request(self, method: str, path: str, **kwargs) -> Response:
        return await self._inner.request(method, path, **kwargs)

    # verb helpers route through *this* object's request()
    async def get(self, path: str, params=None, headers=None) -> Response:
        return await self.request("GET", path, params=params, headers=headers)

    async def post(self, path: str, **kwargs) -> Response:
        return await self.request("POST", path, **kwargs)

    async def put(self, path: str, **kwargs) -> Response:
        return await self.request("PUT", path, **kwargs)

    async def patch(self, path: str, **kwargs) -> Response:
        return await self.request("PATCH", path, **kwargs)

    async def delete(self, path: str, **kwargs) -> Response:
        return await self.request("DELETE", path, **kwargs)

    async def health_check(self) -> dict:
        return await self._inner.health_check()

    async def close(self) -> None:
        await self._inner.close()


@dataclass
class CircuitBreakerConfig:
    threshold: int = 5
    interval: float = 10.0  # seconds between auto-close probes

    def apply(self, inner, logger=None) -> "_CircuitBreaker":
        return _CircuitBreaker(inner, self, logger)


class _CircuitBreaker(_Decorator):
    def __init__(self, inner, cfg: CircuitBreakerConfig, logger=None) -> None:
        super().__init__(inner)
        self._cfg = cfg
        self._logger = logger
        self._failures = 0
        self._open = False
        self._probe_task: asyncio.Task | None = None

    async def request(self, method: str, path: str, **kwargs) -> Response:
        if self._open:
            raise CircuitOpenError()
        try:
            resp = await self._inner.request(method, path, **kwargs)
        except CircuitOpenError:
            raise
        except Exception:
            self._record_failure()
            raise
        if resp.status_code >= 500:
            self._record_failure()
        else:
            self._failures = 0
        return resp

    def _record_failure(self) -> None:
        self._failures += 1
        if self._failures > self._cfg.threshold and not self._open:
            self._open = True
            if self._logger is not None:
                self._logger.warnf("circuit opened for %s",
                                   self._inner.address)
            try:
                self._probe_task = asyncio.get_running_loop().create_task(
                    self._probe())
            except RuntimeError:
                pass  # no loop: stays open until next loop-driven probe

    async def _probe(self) -> None:
        """The background health probe; closes the circuit when the
        target is UP again."""
        while self._open:
            await asyncio.sleep(self._cfg.interval)
            health = await self._inner.health_check()
            if health.get("status") == "UP":
                self._open = False
                self._failures = 0
                if self._logger is not None:
                    self._logger.infof("circuit closed for %s",
                                       self._inner.address)

    async def close(self) -> None:
        if self._probe_task is not None:
            self._probe_task.cancel()
        await self._inner.close()


@dataclass
class RetryConfig:
    max_retries: int = 3

    def apply(self, inner, logger=None) -> "_Retry":
        return _Retry(inner, self, logger)


class _Retry(_Decorator):
    def __init__(self, inner, cfg: RetryConfig, logger=None) -> None:
        super().__init__(inner)
        self._cfg = cfg
        self._logger = logger

    async def request(self, method: str, path: str, **kwargs) -> Response:
        last_exc: Exception | None = None
        for attempt in range(self._cfg.max_retries + 1):
            try:
                resp = await self._inner.request(method, path, **kwargs)
            except CircuitOpenError:
                raise
            except Exception as exc:
                last_exc = exc
                continue
            if resp.status_code < 500 or attempt == self._cfg.max_retries:
                return resp
        assert last_exc is not None
        raise last_exc


@dataclass
class HealthConfig:
    endpoint: str = ".well-known/alive"
    timeout: float = 5.0

    def apply(self, inner, logger=None):
        base = inner
        while isinstance(base, _Decorator):
            base = base._inner
        base.health_endpoint = self.endpoint.lstrip("/")
        base.health_timeout = self.timeout
        return inner


@dataclass
class BasicAuthConfig:
    username: str
    password: str

    def apply(self, inner, logger=None) -> "_HeaderAuth":
        token = base64.b64encode(
            f"{self.username}:{self.password}".encode()).decode()
        return _HeaderAuth(inner, {"Authorization": f"Basic {token}"})


@dataclass
class APIKeyConfig:
    api_key: str

    def apply(self, inner, logger=None) -> "_HeaderAuth":
        return _HeaderAuth(inner, {"X-Api-Key": self.api_key})


@dataclass
class DefaultHeaders:
    headers: dict[str, str] = field(default_factory=dict)

    def apply(self, inner, logger=None) -> "_HeaderAuth":
        return _HeaderAuth(inner, dict(self.headers))


class _HeaderAuth(_Decorator):
    def __init__(self, inner, headers: dict[str, str]) -> None:
        super().__init__(inner)
        self._headers = headers

    async def request(self, method: str, path: str, **kwargs) -> Response:
        hdrs = dict(kwargs.pop("headers", None) or {})
        for k, v in self._headers.items():
            hdrs.setdefault(k, v)
        return await self._inner.request(method, path, headers=hdrs, **kwargs)


@dataclass
class OAuthConfig:
    """Client credentials: a token fetched from ``token_url``, cached
    until near its expiry, sent as ``Authorization: Bearer``."""

    client_id: str
    client_secret: str
    token_url: str
    scopes: list[str] = field(default_factory=list)

    def apply(self, inner, logger=None) -> "_OAuth":
        return _OAuth(inner, self, logger)


class _OAuth(_Decorator):
    def __init__(self, inner, cfg: OAuthConfig, logger=None) -> None:
        super().__init__(inner)
        self._cfg = cfg
        self._logger = logger
        self._token: str | None = None
        self._expiry = 0.0
        self._lock = asyncio.Lock()

    async def _get_token(self) -> str:
        async with self._lock:
            if self._token is not None and time.time() < self._expiry - 30:
                return self._token
            form = {
                "grant_type": "client_credentials",
                "client_id": self._cfg.client_id,
                "client_secret": self._cfg.client_secret,
            }
            if self._cfg.scopes:
                form["scope"] = " ".join(self._cfg.scopes)
            async with aiohttp.ClientSession() as session:
                async with session.post(self._cfg.token_url,
                                        data=form) as resp:
                    payload = await resp.json()
            self._token = payload["access_token"]
            self._expiry = time.time() + float(payload.get("expires_in", 3600))
            return self._token

    async def request(self, method: str, path: str, **kwargs) -> Response:
        token = await self._get_token()
        hdrs = dict(kwargs.pop("headers", None) or {})
        hdrs.setdefault("Authorization", f"Bearer {token}")
        return await self._inner.request(method, path, headers=hdrs, **kwargs)


def new_http_service(address: str, logger=None, metrics=None,
                     tracer: Tracer | None = None, *options: Any):
    """The base client wrapped by each option in turn."""
    svc: Any = HTTPService(address, logger, metrics, tracer)
    for opt in options:
        svc = opt.apply(svc, logger)
    return svc
