"""The HTTP request adapter — counterpart of ``gofr_tpu/http/request.py``,
cut to JSON: ``bind()`` parses a JSON body (an empty body is ``{}``, a
malformed one a 400); any other content type binds the raw bytes. The
form and multipart binders of the JAX package are not ported."""

from __future__ import annotations

import json
from typing import Any, Mapping

from .errors import InvalidInput

__all__ = ["HTTPRequest"]


class HTTPRequest:
    """The Request contract over an aiohttp request."""

    def __init__(self, raw: Any) -> None:  # aiohttp.web.Request
        self.raw = raw

    def param(self, key: str) -> str:
        return self.raw.query.get(key, "")

    @property
    def headers(self) -> Mapping[str, str]:
        return self.raw.headers

    async def bind(self) -> Any:
        ctype = (self.raw.content_type or "").lower()
        raw = await self.raw.read()
        if ctype not in ("application/json", "") \
                and not ctype.endswith("+json"):
            return raw
        if not raw:
            return {}
        try:
            return json.loads(raw)
        except json.JSONDecodeError as exc:
            raise InvalidInput(f"invalid JSON body: {exc}") from exc
