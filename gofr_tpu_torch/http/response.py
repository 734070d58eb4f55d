"""Response value types a handler may return — counterpart of
``gofr_tpu/http/response.py``, cut to ``File`` (a binary payload with its
content type) and ``Raw`` (a JSON body without the ``{"data": ...}``
envelope, as the OpenAI wire format needs), both written as they are by
the responder."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

__all__ = ["File", "Raw"]


@dataclass
class Raw:
    """Serialize ``data`` as-is (no envelope)."""

    data: Any


@dataclass
class File:
    """Binary payload with explicit content type."""

    content: bytes
    content_type: str = "application/octet-stream"
