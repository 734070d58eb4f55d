"""Response value types a handler may return — counterpart of
``gofr_tpu/http/response.py``. The responder writes each as JAX's does:
``Raw`` as JSON without the ``{"data": ...}`` envelope (the OpenAI wire
format needs it), ``File`` as bytes with its content type, ``Redirect`` as
a 302 (or its own status) with ``Location``, ``Response`` as the envelope
with extra headers and an optional ``meta``, and ``Template`` as the HTML
of a file from ``TEMPLATES_DIR`` (default ``./templates``) rendered with
``str.format``."""

from __future__ import annotations

import mimetypes
import os
from dataclasses import dataclass, field
from typing import Any, Mapping

__all__ = ["File", "Raw", "Redirect", "Response", "Template"]


@dataclass
class Raw:
    """Serialize ``data`` as-is (no envelope)."""

    data: Any


@dataclass
class File:
    """Binary payload with explicit content type."""

    content: bytes
    content_type: str = "application/octet-stream"

    @classmethod
    def from_path(cls, path: str, content_type: str | None = None) -> "File":
        """The file at ``path``; the content type guessed from its name
        when not given."""
        with open(path, "rb") as fh:
            content = fh.read()
        if content_type is None:
            content_type = (mimetypes.guess_type(path)[0]
                            or "application/octet-stream")
        return cls(content, content_type)


@dataclass
class Redirect:
    url: str
    status_code: int = 302


@dataclass
class Response:
    """Data plus extra response headers and metadata."""

    data: Any
    headers: Mapping[str, str] = field(default_factory=dict)
    meta: Mapping[str, Any] | None = None


@dataclass
class Template:
    """A template file rendered with ``str.format(**data)``."""

    name: str
    data: Mapping[str, Any] = field(default_factory=dict)
    directory: str | None = None

    def render(self) -> str:
        directory = self.directory or os.environ.get("TEMPLATES_DIR",
                                                     "./templates")
        with open(os.path.join(directory, self.name), "r",
                  encoding="utf-8") as fh:
            return fh.read().format(**self.data)
