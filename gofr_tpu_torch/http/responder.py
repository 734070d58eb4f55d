"""Responder — counterpart of ``gofr_tpu/http/responder.py``: maps a
handler's (result, error) to an HTTP response with the JSON envelope.

Success: ``{"data": ...}``, POST 201, DELETE 204, otherwise 200. Error:
``{"error": {"message": ...}}`` at the error's ``status_code`` (500 for an
untyped one), with the error's ``headers`` (``Overloaded``'s
``Retry-After``) and its ``response`` dict merged into the error object;
an error with partial data answers 206 with both. A ``File`` result is
written raw with its content type, a ``Raw`` one as JSON without the
envelope (200), and a prepared stream (``EventStream``) passes through.
"""

from __future__ import annotations

import dataclasses
import json
from http import HTTPStatus
from typing import Any

from aiohttp import web

from .errors import status_code_of
from .response import File, Raw

__all__ = ["respond", "to_jsonable"]


def to_jsonable(obj: Any) -> Any:
    """Handler results (dicts, lists, dataclasses, numpy or torch arrays)
    as JSON-ready values."""
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    if isinstance(obj, dict):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, set):
        return sorted(to_jsonable(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: to_jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if hasattr(obj, "tolist"):
        return obj.tolist()
    if isinstance(obj, bytes):
        return obj.decode("utf-8", errors="replace")
    return str(obj)


def _status_code(method: str, data: Any, err: BaseException | None) -> int:
    if err is not None:
        return HTTPStatus.PARTIAL_CONTENT if data is not None \
            else status_code_of(err)
    if method == "POST":
        return HTTPStatus.CREATED
    if method == "DELETE":
        return HTTPStatus.NO_CONTENT
    return HTTPStatus.OK


def respond(method: str, result: Any, err: BaseException | None
            ) -> web.StreamResponse:
    """The aiohttp response for a handler's (result, error) pair."""
    if err is None and isinstance(result, web.StreamResponse):
        return result
    if err is None and isinstance(result, File):
        return web.Response(body=result.content,
                            content_type=result.content_type)
    if err is None and isinstance(result, Raw):
        return web.Response(body=json.dumps(to_jsonable(result.data)).encode(),
                            status=HTTPStatus.OK,
                            content_type="application/json")
    headers: dict[str, str] = {}
    status = _status_code(method, result, err)
    envelope: dict[str, Any] = {}
    if err is not None:
        extra_headers = getattr(err, "headers", None)
        if isinstance(extra_headers, dict):
            headers = {str(k): str(v) for k, v in extra_headers.items()}
        error_obj: dict[str, Any] = {"message": str(err)
                                     or type(err).__name__}
        extra = getattr(err, "response", None)
        if isinstance(extra, dict):
            error_obj.update(to_jsonable(extra))
        envelope["error"] = error_obj
        if result is not None:
            envelope["data"] = to_jsonable(result)
    else:
        if status == HTTPStatus.NO_CONTENT:
            return web.Response(status=status)
        envelope["data"] = to_jsonable(result)
    return web.Response(body=json.dumps(envelope).encode(), status=status,
                        content_type="application/json", headers=headers)
