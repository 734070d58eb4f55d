"""Responder — counterpart of ``gofr_tpu/http/responder.py``: maps a
handler's (result, error) to an HTTP response with the JSON envelope.

Success: ``{"data": ...}``, POST 201, DELETE 204, otherwise 200. Error:
``{"error": {"message": ...}}`` at the error's ``status_code`` (500 for an
untyped one), with the error's ``headers`` (``Overloaded``'s
``Retry-After``) and its ``response`` dict merged into the error object;
an error with partial data answers 206 with both. The response types of
``response.py`` are written as that module says, and a prepared stream
(``EventStream``) passes through.
"""

from __future__ import annotations

import dataclasses
import json
from http import HTTPStatus
from typing import Any

from aiohttp import web

from .errors import status_code_of
from .response import File, Raw, Redirect, Response, Template

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
    if hasattr(obj, "to_dict"):
        return to_jsonable(obj.to_dict())
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


def _typed(result: Any, headers: dict) -> web.StreamResponse | None:
    """The response of a result of one of ``response.py``'s types."""
    if isinstance(result, web.StreamResponse):
        return result
    if isinstance(result, Redirect):
        return web.Response(status=result.status_code,
                            headers={**headers, "Location": result.url})
    if isinstance(result, File):
        return web.Response(body=result.content,
                            content_type=result.content_type, headers=headers)
    if isinstance(result, Template):
        return web.Response(text=result.render(), content_type="text/html",
                            headers=headers)
    if isinstance(result, Raw):
        return web.Response(body=json.dumps(to_jsonable(result.data)).encode(),
                            status=HTTPStatus.OK,
                            content_type="application/json", headers=headers)
    return None


def respond(method: str, result: Any, err: BaseException | None
            ) -> web.StreamResponse:
    """The aiohttp response for a handler's (result, error) pair."""
    headers: dict[str, str] = {}
    meta = None
    if isinstance(result, Response):
        headers, meta, result = dict(result.headers), result.meta, result.data
    if err is None:
        typed = _typed(result, headers)
        if typed is not None:
            return typed
    status = _status_code(method, result, err)
    envelope: dict[str, Any] = {}
    if err is not None:
        extra_headers = getattr(err, "headers", None)
        if isinstance(extra_headers, dict):
            headers.update({str(k): str(v) for k, v in extra_headers.items()})
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
            return web.Response(status=status, headers=headers)
        envelope["data"] = to_jsonable(result)
        if meta is not None:
            envelope["meta"] = to_jsonable(meta)
    return web.Response(body=json.dumps(envelope).encode(), status=status,
                        content_type="application/json", headers=headers)
