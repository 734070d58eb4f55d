"""Typed serving-plane errors — counterpart of ``gofr_tpu/ml/errors.py``.

The JAX package derives these from its framework's ``GofrError`` so its
HTTP and gRPC fronts map ``status_code`` onto responses. The port has no
front yet and keeps its own small base class with the same contract: each
error carries the HTTP status a front should answer with.
"""

from __future__ import annotations

from http import HTTPStatus

__all__ = ["ServingError", "ServerClosed", "GeneratorCrashed",
           "DeadlineExceeded", "Overloaded"]


class ServingError(Exception):
    """Base of the errors a client of ``LLMServer`` can receive."""

    status_code = HTTPStatus.INTERNAL_SERVER_ERROR


class ServerClosed(ServingError):
    """The server is shut down (or shutting down). 503."""

    status_code = HTTPStatus.SERVICE_UNAVAILABLE

    def __init__(self, message: str = "llm server is closed") -> None:
        super().__init__(message)


class GeneratorCrashed(ServingError):
    """A device dispatch failed underneath this request; the server is
    dead. 503: the prompt was not partially committed anywhere."""

    status_code = HTTPStatus.SERVICE_UNAVAILABLE

    def __init__(self, message: str = "llm generator crashed") -> None:
        super().__init__(message)


class DeadlineExceeded(ServingError):
    """The request's deadline passed before completion, while queued or
    mid-decode. 504."""

    status_code = HTTPStatus.GATEWAY_TIMEOUT

    def __init__(self, message: str = "request deadline exceeded") -> None:
        super().__init__(message)


class Overloaded(ServingError):
    """Admission was shed under overload. 429, with ``retry_after``
    seconds for a ``Retry-After`` header. Raised by the bounded-admission
    layer, which is still to be ported (ROADMAP A.6, with the front)."""

    status_code = HTTPStatus.TOO_MANY_REQUESTS

    def __init__(self, message: str | None = None,
                 retry_after: float = 1.0) -> None:
        self.retry_after = max(0.0, float(retry_after))
        super().__init__(message or "server overloaded; request shed")
