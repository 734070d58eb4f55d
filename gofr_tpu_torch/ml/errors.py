"""Typed serving-plane errors — counterpart of ``gofr_tpu/ml/errors.py``.

Subclasses of the front's ``GofrError`` (``http/errors.py``), so the HTTP
responder maps ``status_code`` onto the JSON error envelope and the gRPC
front maps the same codes onto gRPC statuses (429 -> RESOURCE_EXHAUSTED,
503 -> UNAVAILABLE, 504 -> DEADLINE_EXCEEDED) instead of collapsing every
serving failure into a 500 / INTERNAL.
"""

from __future__ import annotations

from http import HTTPStatus

from ..http.errors import GofrError

__all__ = ["ServerClosed", "GeneratorCrashed", "DeadlineExceeded",
           "Overloaded"]


class ServerClosed(GofrError):
    """The server is shut down (or shutting down). 503 / UNAVAILABLE."""

    status_code = HTTPStatus.SERVICE_UNAVAILABLE

    def __init__(self, message: str = "llm server is closed") -> None:
        super().__init__(message)


class GeneratorCrashed(GofrError):
    """A device dispatch failed underneath this request; the server is
    dead (restart under a watchdog is ROADMAP A.6b). 503 / UNAVAILABLE:
    the prompt was not partially committed anywhere."""

    status_code = HTTPStatus.SERVICE_UNAVAILABLE

    def __init__(self, message: str = "llm generator crashed") -> None:
        super().__init__(message)


class DeadlineExceeded(GofrError):
    """The request's deadline (``deadline_s=`` /
    ``GOFR_ML_DEFAULT_DEADLINE_S``) passed before completion, while queued
    or mid-decode. 504 / DEADLINE_EXCEEDED."""

    status_code = HTTPStatus.GATEWAY_TIMEOUT

    def __init__(self, message: str = "request deadline exceeded") -> None:
        super().__init__(message)


class Overloaded(GofrError):
    """Admission was shed under overload (``GOFR_ML_MAX_QUEUE`` /
    ``GOFR_ML_MAX_QUEUED_TOKENS``). 429, with ``retry_after`` seconds from
    the observed queue drain rate: the HTTP responder sends it as a
    ``Retry-After`` header, the gRPC front as ``retry-after`` trailing
    metadata."""

    status_code = HTTPStatus.TOO_MANY_REQUESTS

    def __init__(self, message: str | None = None,
                 retry_after: float = 1.0) -> None:
        self.retry_after = max(0.0, float(retry_after))
        super().__init__(message or "server overloaded; request shed")
        self.headers = {"Retry-After": str(max(1, round(self.retry_after)))}
        self.response = {"retry_after_s": round(self.retry_after, 3)}
