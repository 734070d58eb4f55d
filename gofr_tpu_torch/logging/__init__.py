"""Leveled, structured logging — counterpart of ``gofr_tpu/logging``.

JSON lines on a pipe or file, colored lines on a terminal; payloads that
implement ``PrettyPrint`` (request, SQL and RPC logs) render themselves
there. Levels DEBUG < INFO < NOTICE < WARN < ERROR < FATAL; ``LOG_LEVEL``
picks the floor, ``change_level`` moves it live (``remote.py`` polls a URL
for it). ERROR and above go to stderr. ``new_file_logger`` writes JSON
lines to a file.
"""

from __future__ import annotations

import io
import json
import os
import sys
import threading
import time
from enum import IntEnum
from typing import Any, Protocol, TextIO, runtime_checkable

__all__ = ["Level", "Logger", "PrettyPrint", "new_logger", "new_file_logger",
           "get_level_from_string", "NULL"]


class Level(IntEnum):
    DEBUG = 1
    INFO = 2
    NOTICE = 3
    WARN = 4
    ERROR = 5
    FATAL = 6

    @property
    def color(self) -> int:
        return {Level.DEBUG: 256, Level.INFO: 6, Level.NOTICE: 12,
                Level.WARN: 3, Level.ERROR: 160, Level.FATAL: 160}[self]


def get_level_from_string(level: str | None) -> Level:
    if not level:
        return Level.INFO
    try:
        return Level[level.strip().upper()]
    except KeyError:
        return Level.INFO


@runtime_checkable
class PrettyPrint(Protocol):
    """A structured log payload that renders itself on a terminal."""

    def pretty_print(self, writer: TextIO) -> None: ...


def _json_default(obj: Any) -> Any:
    if hasattr(obj, "to_dict"):
        return obj.to_dict()
    if hasattr(obj, "__dict__"):
        return {k: v for k, v in vars(obj).items() if not k.startswith("_")}
    return str(obj)


class Logger:
    """Thread-safe leveled logger: one lock per write, so concurrent
    handlers never interleave partial lines."""

    def __init__(self, level: Level = Level.INFO, out: TextIO | None = None,
                 err: TextIO | None = None, *,
                 is_terminal: bool | None = None) -> None:
        self.level = level
        self._out = out if out is not None else sys.stdout
        self._err = err if err is not None else sys.stderr
        if is_terminal is None:
            try:
                is_terminal = self._out.isatty()
            except (AttributeError, ValueError):
                is_terminal = False
        self._is_terminal = is_terminal
        self._lock = threading.Lock()

    def log_at(self, level: Level, *args: Any, **fields: Any) -> None:
        if level < self.level:
            return
        now = time.time()
        writer = self._err if level >= Level.ERROR else self._out
        with self._lock:
            try:
                if self._is_terminal:
                    self._pretty(writer, level, now, args, fields)
                else:
                    self._json(writer, level, now, args, fields)
                writer.flush()
            except ValueError:
                pass  # writer closed (interpreter teardown)

    def _json(self, w: TextIO, level: Level, now: float, args: tuple,
              fields: dict) -> None:
        if len(args) == 1:
            message = args[0]
            if isinstance(message, PrettyPrint) and hasattr(message,
                                                            "to_dict"):
                message = message.to_dict()
        else:
            message = " ".join(str(a) for a in args)
        entry = {"level": level.name,
                 "time": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(now))
                 + f".{int((now % 1) * 1e6):06d}Z",
                 "message": message, **fields}
        w.write(json.dumps(entry, default=_json_default) + "\n")

    def _pretty(self, w: TextIO, level: Level, now: float, args: tuple,
                fields: dict) -> None:
        ts = time.strftime("%H:%M:%S", time.localtime(now))
        w.write(f"\x1b[38;5;{level.color}m{level.name:5s}\x1b[0m [{ts}] ")
        for a in args:
            if isinstance(a, PrettyPrint):
                a.pretty_print(w)
            else:
                w.write(f"{a} ")
        if fields:
            w.write(json.dumps(fields, default=_json_default))
        w.write("\n")

    def debug(self, *args: Any, **fields: Any) -> None:
        self.log_at(Level.DEBUG, *args, **fields)

    def debugf(self, fmt: str, *args: Any) -> None:
        self.log_at(Level.DEBUG, fmt % args if args else fmt)

    def info(self, *args: Any, **fields: Any) -> None:
        self.log_at(Level.INFO, *args, **fields)

    def infof(self, fmt: str, *args: Any) -> None:
        self.log_at(Level.INFO, fmt % args if args else fmt)

    def notice(self, *args: Any, **fields: Any) -> None:
        self.log_at(Level.NOTICE, *args, **fields)

    def warn(self, *args: Any, **fields: Any) -> None:
        self.log_at(Level.WARN, *args, **fields)

    def warnf(self, fmt: str, *args: Any) -> None:
        self.log_at(Level.WARN, fmt % args if args else fmt)

    def error(self, *args: Any, **fields: Any) -> None:
        self.log_at(Level.ERROR, *args, **fields)

    def errorf(self, fmt: str, *args: Any) -> None:
        self.log_at(Level.ERROR, fmt % args if args else fmt)

    def fatal(self, *args: Any, **fields: Any) -> None:
        self.log_at(Level.FATAL, *args, **fields)

    def log(self, *args: Any, **fields: Any) -> None:
        self.log_at(Level.INFO, *args, **fields)

    def change_level(self, level: Level) -> None:
        self.level = level


class _NullLogger(Logger):
    def __init__(self) -> None:
        super().__init__(Level.FATAL, out=io.StringIO(), err=io.StringIO(),
                         is_terminal=False)

    def log_at(self, level: Level, *args: Any, **fields: Any) -> None:
        pass


NULL = _NullLogger()


def new_logger(level: Level | str | None = None) -> Logger:
    """A logger at ``level`` (default ``LOG_LEVEL``, else INFO)."""
    if not isinstance(level, Level):
        level = get_level_from_string(
            level if isinstance(level, str) else os.environ.get("LOG_LEVEL"))
    return Logger(level)


def new_file_logger(path: str, level: Level = Level.INFO) -> Logger:
    """A logger writing JSON lines to ``path`` (appended); an empty path
    logs nothing."""
    if not path:
        return NULL
    fh = open(path, "a", encoding="utf-8")
    return Logger(level, out=fh, err=fh, is_terminal=False)
