"""Response value types a handler may return — counterpart of
``gofr_tpu/http/response.py``, cut to ``File``: a binary payload with its
content type, written raw (no JSON envelope) by the responder."""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["File"]


@dataclass
class File:
    """Binary payload with explicit content type."""

    content: bytes
    content_type: str = "application/octet-stream"
