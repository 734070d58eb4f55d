"""The transport-agnostic Request and its HTTP adapter — counterpart of
``gofr_tpu/http/request.py``.

``HTTPRequest`` answers ``param`` / ``params`` (a comma-separated value
splits), ``path_param(s)``, ``host_name`` and ``bind(model=None)``, which
switches on the content type: JSON (an empty body is ``{}``, a malformed
one a 400), form-urlencoded and multipart forms (a dict), anything else
the raw bytes. Given a model, ``bind_to_model`` fills a dataclass,
coercing each field to its annotation; a multipart file part binds by the
field's type: ``UploadedFile`` keeps the name, content type and bytes,
``fileutil.Zip`` the parsed archive (a bad archive is a 400), ``bytes``
the content, ``str`` its text. ``metadata={"file": "form-field"}`` binds a
differently named part.
"""

from __future__ import annotations

import dataclasses
import json
import types
import typing
from typing import Any, Mapping, Protocol, runtime_checkable

from ..fileutil import Zip
from .errors import InvalidInput

__all__ = ["Request", "HTTPRequest", "UploadedFile", "bind_to_model"]


@dataclasses.dataclass
class UploadedFile:
    """An uploaded multipart file: its name, content type and bytes."""

    filename: str
    content_type: str
    content: bytes

    @property
    def size(self) -> int:
        return len(self.content)

    def zip(self) -> Zip:
        return Zip.from_bytes(self.content)


@runtime_checkable
class Request(Protocol):
    def param(self, key: str) -> str: ...
    def params(self, key: str) -> list[str]: ...
    def path_param(self, key: str) -> str: ...
    async def bind(self, model: type | None = None) -> Any: ...
    def host_name(self) -> str: ...


def _coerce_file(value: UploadedFile, annot: Any) -> Any:
    if annot is UploadedFile:
        return value
    if annot is Zip:
        try:
            return value.zip()
        except Exception as exc:
            raise InvalidInput(
                f"field expects a zip archive, got {value.filename!r}: "
                f"{exc}") from exc
    if annot in (None, Any, bytes):
        return value.content
    if annot is str:
        try:
            return value.content.decode()
        except UnicodeDecodeError as exc:
            raise InvalidInput(f"uploaded file {value.filename!r} is not "
                               f"valid text") from exc
    raise InvalidInput(
        f"cannot bind uploaded file {value.filename!r} to {annot}")


def _coerce(value: Any, annot: Any) -> Any:
    """A parsed value coerced to a field's annotation."""
    if value is None:
        return value
    origin = typing.get_origin(annot)
    if origin is typing.Union or origin is types.UnionType:
        args = [a for a in typing.get_args(annot) if a is not type(None)]
        return _coerce(value, args[0]) if len(args) == 1 else value
    if isinstance(value, UploadedFile):
        return _coerce_file(value, annot)
    if annot in (Zip, UploadedFile):
        # a plain form value where a file part was declared
        raise InvalidInput(
            f"field expects an uploaded file, got {type(value).__name__}")
    if annot in (None, Any):
        return value
    try:
        if annot is bool and isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        if annot in (int, float, str, bool) and not isinstance(value, annot):
            return annot(value)
    except (TypeError, ValueError) as exc:
        raise InvalidInput(f"cannot convert {value!r} to {annot}") from exc
    return value


def bind_to_model(data: Mapping[str, Any], model: type) -> Any:
    """A dict bound into a dataclass (coercing each field) or a plain
    class (attributes set as they come)."""
    if dataclasses.is_dataclass(model):
        hints = typing.get_type_hints(model)
        kwargs = {f.name: _coerce(data[f.name], hints.get(f.name))
                  for f in dataclasses.fields(model) if f.name in data}
        try:
            return model(**kwargs)
        except TypeError as exc:
            raise InvalidInput(str(exc)) from exc
    obj = model()
    for k, v in data.items():
        if isinstance(v, UploadedFile):
            v = v.content
        if hasattr(obj, k) or not hasattr(obj, "__slots__"):
            setattr(obj, k, v)
    return obj


class HTTPRequest:
    """The Request contract over an aiohttp request."""

    def __init__(self, raw: Any) -> None:  # aiohttp.web.Request
        self.raw = raw

    def param(self, key: str) -> str:
        return self.raw.query.get(key, "")

    def params(self, key: str) -> list[str]:
        out: list[str] = []
        for v in self.raw.query.getall(key, []):
            out.extend(v.split(","))
        return out

    def path_param(self, key: str) -> str:
        return self.raw.match_info.get(key, "")

    def path_params(self) -> dict[str, str]:
        return dict(self.raw.match_info)

    def host_name(self) -> str:
        scheme = "https" if self.raw.secure else "http"
        return f"{scheme}://{self.raw.host}"

    @property
    def method(self) -> str:
        return self.raw.method

    @property
    def path(self) -> str:
        return self.raw.path

    @property
    def headers(self) -> Mapping[str, str]:
        return self.raw.headers

    def context(self) -> Any:
        return self.raw

    async def body(self) -> bytes:
        return await self.raw.read()

    async def _form(self, typed: bool) -> dict:
        data: dict = {}
        for k, v in (await self.raw.post()).items():
            if not hasattr(v, "file"):
                data[k] = v
            elif typed:
                data[k] = UploadedFile(getattr(v, "filename", "") or "",
                                       getattr(v, "content_type", "") or "",
                                       v.file.read())
            else:  # an untyped bind gives a file part's bytes
                data[k] = v.file.read()
        return data

    async def bind(self, model: type | None = None) -> Any:
        ctype = (self.raw.content_type or "").lower()
        if ctype in ("application/json", "") or ctype.endswith("+json"):
            raw = await self.raw.read()
            try:
                data: Any = json.loads(raw) if raw else {}
            except json.JSONDecodeError as exc:
                raise InvalidInput(f"invalid JSON body: {exc}") from exc
        elif ctype in ("application/x-www-form-urlencoded",
                       "multipart/form-data"):
            data = await self._form(model is not None)
        else:
            data = await self.raw.read()
        if model is None or isinstance(data, (bytes, bytearray)):
            return data
        if not isinstance(data, Mapping):
            raise InvalidInput(
                "request body must be a JSON object to bind a model")
        if dataclasses.is_dataclass(model):
            for f in dataclasses.fields(model):
                alias = f.metadata.get("file")
                if alias and alias in data and f.name not in data:
                    data[f.name] = data.pop(alias)
        return bind_to_model(data, model)
