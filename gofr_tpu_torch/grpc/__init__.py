"""gRPC front — counterpart of ``gofr_tpu/grpc``.

``JSONService`` mounts proto-less RPCs whose messages are JSON-encoded
dicts (``unary`` and server-``stream`` methods); ``start_grpc_server``
serves the registered services on ``grpc.aio`` behind a logging
interceptor: a span and an ``RPCLog`` per call, and every exception
mapped to a status by ``_grpc_status_of``. A typed ``GofrError`` maps to
the status of its HTTP code with its own message (429 ->
RESOURCE_EXHAUSTED, 503 -> UNAVAILABLE, 504 -> DEADLINE_EXCEEDED, ...);
anything else is INTERNAL with the sanitized message "internal error" and
a logged stack. An ``Overloaded`` abort also carries ``retry-after``
(whole seconds) in its trailing metadata.
"""

from __future__ import annotations

import inspect
import json
import time
import traceback
from dataclasses import dataclass
from typing import Any, Awaitable, Callable

import grpc
import grpc.aio

from ..http.errors import GofrError

__all__ = ["start_grpc_server", "JSONService", "RPCLog"]

_HTTP_TO_GRPC = {
    400: grpc.StatusCode.INVALID_ARGUMENT,
    401: grpc.StatusCode.UNAUTHENTICATED,
    403: grpc.StatusCode.PERMISSION_DENIED,
    404: grpc.StatusCode.NOT_FOUND,
    408: grpc.StatusCode.DEADLINE_EXCEEDED,
    409: grpc.StatusCode.ALREADY_EXISTS,
    429: grpc.StatusCode.RESOURCE_EXHAUSTED,  # Overloaded (shed)
    503: grpc.StatusCode.UNAVAILABLE,         # ServerClosed, GeneratorCrashed
    504: grpc.StatusCode.DEADLINE_EXCEEDED,   # DeadlineExceeded
}


def _grpc_status_of(exc: BaseException):
    """(StatusCode, message, is_client_error) for a raised exception. Only
    the framework's typed errors map to client statuses with their real
    message; a third-party exception that happens to carry
    ``status_code`` is INTERNAL like any other."""
    if isinstance(exc, GofrError):
        status = getattr(exc, "status_code", None)
        if status is not None and int(status) in _HTTP_TO_GRPC:
            return _HTTP_TO_GRPC[int(status)], str(exc), True
    return grpc.StatusCode.INTERNAL, "internal error", False


def _trailers(exc: BaseException) -> tuple:
    retry = getattr(exc, "retry_after", None)
    if retry is None:
        return ()
    return (("retry-after", str(max(1, round(retry)))),)


@dataclass
class RPCLog:
    """One RPC's structured log entry."""

    method: str
    duration_us: int
    status_code: int

    def to_dict(self) -> dict:
        return {"method": self.method, "duration": self.duration_us,
                "status": self.status_code}

    def pretty_print(self, writer) -> None:
        writer.write(f"\x1b[38;5;5mGRPC\x1b[0m {self.duration_us:8d}μs "
                     f"{self.status_code} {self.method} ")


class _LoggingInterceptor(grpc.aio.ServerInterceptor):
    """Span + RPCLog per call; exceptions become statuses."""

    def __init__(self, logger, tracer) -> None:
        self._logger = logger
        self._tracer = tracer

    async def _fail(self, exc, method, span, context) -> None:
        status, message, client_err = _grpc_status_of(exc)
        if span is not None:
            span.record_exception(exc)
        if client_err:  # a typed 4xx/5xx answer, not a panic
            self._logger.debug({"grpc": method, "rejected": str(exc)})
        else:
            self._logger.error("grpc panic recovered", method=method,
                               error=str(exc), stack=traceback.format_exc())
        await context.abort(status, message, trailing_metadata=_trailers(exc))

    def _finish(self, method, span, start, code) -> None:
        if span is not None:
            span.end()
        self._logger.info(RPCLog(
            method=method,
            duration_us=int((time.perf_counter() - start) * 1e6),
            status_code=code))

    async def intercept_service(self, continuation, handler_call_details):
        handler = await continuation(handler_call_details)
        if handler is None:
            return None
        method = handler_call_details.method
        tracer = self._tracer

        def wrap_unary(behavior):
            async def wrapped(request, context):
                start = time.perf_counter()
                span = (tracer.start_span(f"grpc {method}", kind="SERVER")
                        if tracer is not None else None)
                code = 0
                try:
                    result = behavior(request, context)
                    if inspect.isawaitable(result):
                        result = await result
                    return result
                except Exception as exc:
                    code = _grpc_status_of(exc)[0].value[0]
                    await self._fail(exc, method, span, context)
                finally:
                    self._finish(method, span, start, code)

            return wrapped

        def wrap_stream(behavior):
            async def wrapped(request, context):
                start = time.perf_counter()
                span = (tracer.start_span(f"grpc {method}", kind="SERVER")
                        if tracer is not None else None)
                code = 0
                try:
                    async for item in behavior(request, context):
                        yield item
                except Exception as exc:
                    code = _grpc_status_of(exc)[0].value[0]
                    await self._fail(exc, method, span, context)
                finally:
                    self._finish(method, span, start, code)

            return wrapped

        if handler.unary_unary:
            return grpc.unary_unary_rpc_method_handler(
                wrap_unary(handler.unary_unary),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer)
        if handler.unary_stream:
            return grpc.unary_stream_rpc_method_handler(
                wrap_stream(handler.unary_stream),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer)
        return handler


class JSONService:
    """A proto-less gRPC service whose methods exchange JSON dicts::

        svc = JSONService("llm.Chat")
        svc.stream("Generate", generate_fn)   # async gen (dict, ctx) -> dict
        app.register_service(svc, impl=None)
    """

    def __init__(self, name: str) -> None:
        self.name = name
        self._unary: dict[str, Callable[..., Awaitable[Any]]] = {}
        self._stream: dict[str, Callable[..., Any]] = {}

    def unary(self, method: str, fn: Callable[..., Awaitable[Any]]) -> None:
        self._unary[method] = fn

    def stream(self, method: str, fn: Callable[..., Any]) -> None:
        self._stream[method] = fn

    def build_handler(self) -> grpc.GenericRpcHandler:
        def serialize(obj: Any) -> bytes:
            return json.dumps(obj).encode()

        def deserialize(raw: bytes) -> Any:
            return json.loads(raw) if raw else {}

        handlers: dict[str, grpc.RpcMethodHandler] = {}
        for method, fn in self._unary.items():
            handlers[method] = grpc.unary_unary_rpc_method_handler(
                fn, request_deserializer=deserialize,
                response_serializer=serialize)
        for method, fn in self._stream.items():
            handlers[method] = grpc.unary_stream_rpc_method_handler(
                fn, request_deserializer=deserialize,
                response_serializer=serialize)
        return grpc.method_handlers_generic_handler(self.name, handlers)


async def start_grpc_server(services, port: int, logger, tracer):
    """Serve the registered ``JSONService``s on ``[::]:port``; returns the
    started ``grpc.aio`` server."""
    server = grpc.aio.server(interceptors=[_LoggingInterceptor(logger,
                                                               tracer)])
    for svc in services:
        server.add_generic_rpc_handlers((svc.build_handler(),))
    server.add_insecure_port(f"[::]:{port}")
    await server.start()
    return server
