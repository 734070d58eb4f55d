"""Typed HTTP errors with status-code semantics — counterpart of
``gofr_tpu/http/errors.py``.

Any raised ``GofrError`` carries ``status_code``; the responder turns it
into the status of the JSON error envelope and the gRPC front into the
matching gRPC status. Untyped exceptions answer an opaque 500.
"""

from __future__ import annotations

from http import HTTPStatus

__all__ = ["GofrError", "EntityNotFound", "EntityAlreadyExists",
           "MissingParam", "InvalidParam", "InvalidInput", "InvalidRoute",
           "RequestTimeout", "PanicRecovery", "ServiceUnavailable",
           "Unauthorized", "Forbidden", "status_code_of"]


class GofrError(Exception):
    """Base class: carries an HTTP status code and a user-facing message."""

    status_code: int = HTTPStatus.INTERNAL_SERVER_ERROR

    def __init__(self, message: str | None = None) -> None:
        super().__init__(message or self.default_message())

    def default_message(self) -> str:
        return HTTPStatus(self.status_code).phrase

    @property
    def message(self) -> str:
        return str(self)


class EntityNotFound(GofrError):
    status_code = HTTPStatus.NOT_FOUND

    def __init__(self, name: str = "", value: str = "") -> None:
        if name:
            super().__init__(f"No entity found with {name}: {value}")
        else:
            super().__init__("entity not found")


class EntityAlreadyExists(GofrError):
    status_code = HTTPStatus.CONFLICT

    def __init__(self, message: str = "entity already exists") -> None:
        super().__init__(message)


class MissingParam(GofrError):
    status_code = HTTPStatus.BAD_REQUEST

    def __init__(self, *params: str) -> None:
        super().__init__(
            f"'{len(params)}' missing parameter(s): {', '.join(params)}")
        self.params = params


class InvalidParam(GofrError):
    status_code = HTTPStatus.BAD_REQUEST

    def __init__(self, *params: str) -> None:
        super().__init__(
            f"'{len(params)}' invalid parameter(s): {', '.join(params)}")
        self.params = params


class InvalidInput(GofrError):
    status_code = HTTPStatus.BAD_REQUEST


class InvalidRoute(GofrError):
    status_code = HTTPStatus.NOT_FOUND

    def __init__(self) -> None:
        super().__init__("route not registered")


class RequestTimeout(GofrError):
    status_code = HTTPStatus.REQUEST_TIMEOUT

    def __init__(self) -> None:
        super().__init__("request timed out")


class PanicRecovery(GofrError):
    status_code = HTTPStatus.INTERNAL_SERVER_ERROR

    def __init__(self) -> None:
        super().__init__("some unexpected error has occurred")


class ServiceUnavailable(GofrError):
    status_code = HTTPStatus.SERVICE_UNAVAILABLE


class Unauthorized(GofrError):
    status_code = HTTPStatus.UNAUTHORIZED


class Forbidden(GofrError):
    status_code = HTTPStatus.FORBIDDEN


def status_code_of(err: BaseException) -> int:
    """The HTTP status of an arbitrary error: its ``status_code`` when it
    has an int one, else 500."""
    code = getattr(err, "status_code", None)
    if isinstance(code, int):
        return code
    return HTTPStatus.INTERNAL_SERVER_ERROR
