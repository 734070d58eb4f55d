"""Configuration — counterpart of ``gofr_tpu/config``: the two-method
contract (``get`` / ``get_or_default``) every part of the framework reads
through.

``new_env_config(config_dir)`` loads ``{config_dir}/.env``, overlays
``{config_dir}/.{APP_ENV}.env`` when ``APP_ENV`` is set (in the process
environment or in ``.env``), and reads the process environment live over
both, as the JAX package's loader does. ``EnvConfig()`` with no file
values reads the process environment alone; ``MapConfig`` is a plain dict
for tests.
"""

from __future__ import annotations

import os
from typing import Mapping, Protocol, runtime_checkable

__all__ = ["Config", "EnvConfig", "MapConfig", "load_env_file",
           "new_env_config"]


@runtime_checkable
class Config(Protocol):
    def get(self, key: str) -> str | None: ...

    def get_or_default(self, key: str, default: str) -> str: ...


def _parse_env_line(line: str) -> tuple[str, str] | None:
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    if line.startswith("export "):
        line = line[len("export "):].lstrip()
    if "=" not in line:
        return None
    key, _, value = line.partition("=")
    key, value = key.strip(), value.strip()
    # matched quotes are stripped; an unquoted value loses a trailing
    # " # comment"
    if len(value) >= 2 and value[0] == value[-1] and value[0] in ("'", '"'):
        value = value[1:-1]
    else:
        hash_idx = value.find(" #")
        if hash_idx != -1:
            value = value[:hash_idx].rstrip()
    return key, value


def load_env_file(path: str) -> dict[str, str]:
    """A dotenv file as a dict; a missing file is an empty one."""
    out: dict[str, str] = {}
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for raw in fh:
                kv = _parse_env_line(raw)
                if kv is not None:
                    out[kv[0]] = kv[1]
    except (FileNotFoundError, IsADirectoryError):
        return {}
    return out


class EnvConfig:
    """Config over a layered map: the dotenv values, read once, under the
    process environment, read at each call."""

    def __init__(self, file_values: Mapping[str, str] | None = None) -> None:
        self._file_values: dict[str, str] = dict(file_values or {})

    def get(self, key: str) -> str | None:
        val = os.environ.get(key)
        if val is not None:
            return val
        return self._file_values.get(key)

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


def new_env_config(config_dir: str = "./configs") -> EnvConfig:
    """``{config_dir}/.env``, then ``.{APP_ENV}.env`` over it, then the
    process environment over both."""
    values = load_env_file(os.path.join(config_dir, ".env"))
    app_env = os.environ.get("APP_ENV") or values.get("APP_ENV")
    if app_env:
        values.update(load_env_file(os.path.join(config_dir,
                                                 f".{app_env}.env")))
    return EnvConfig(values)
