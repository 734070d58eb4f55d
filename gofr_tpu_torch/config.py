"""Configuration — counterpart of ``gofr_tpu/config``: the two-method
contract (``get`` / ``get_or_default``) every part of the front reads
through. ``EnvConfig`` reads the process environment live (the dotenv
overlays of the JAX package are not ported); ``MapConfig`` is a plain
dict for tests."""

from __future__ import annotations

import os
from typing import Mapping, Protocol, runtime_checkable

__all__ = ["Config", "EnvConfig", "MapConfig"]


@runtime_checkable
class Config(Protocol):
    def get(self, key: str) -> str | None: ...

    def get_or_default(self, key: str, default: str) -> str: ...


class EnvConfig:
    """Config backed by the process environment, read at each call."""

    def get(self, key: str) -> str | None:
        return os.environ.get(key)

    def get_or_default(self, key: str, default: str) -> str:
        val = self.get(key)
        return val if val is not None else default


class MapConfig:
    """Static config: values come from a plain dict only."""

    def __init__(self, values: Mapping[str, str] | None = None) -> None:
        self._values = dict(values or {})

    def get(self, key: str) -> str | None:
        return self._values.get(key)

    def get_or_default(self, key: str, default: str) -> str:
        return self._values.get(key, default)
