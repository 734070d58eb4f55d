"""Datasource drivers — counterpart of ``gofr_tpu/datasource``: SQL on
sqlite (``sql/``). A driver whose client library is missing raises
``UnavailableDriverError`` at connect time, as in the JAX package. Redis,
the KV and file stores, pub/sub and the wire-protocol stores are not
ported yet."""

from __future__ import annotations

__all__ = ["UnavailableDriverError"]


class UnavailableDriverError(RuntimeError):
    """Raised when an optional driver's client library is not installed."""

    def __init__(self, driver: str, needs: str) -> None:
        super().__init__(
            f"datasource driver {driver!r} requires the {needs!r} client "
            f"library, which is not available in this environment; install "
            f"it or use a supported backend")
