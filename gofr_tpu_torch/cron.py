"""Cron scheduler — counterpart of ``gofr_tpu/cron.py``.

``parse_schedule`` reads 5 fields (minute hour day month weekday; fires at
second 0) or 6 (a leading seconds field): wildcards, values, ranges
``a-b``, steps ``*/n`` and ``a-b/n`` and lists ``a,b,c``; a day of the
month and a weekday both restricted match either, as standard cron does.
An invalid expression raises ``InvalidCronError`` with JAX's text.
``Cron.run`` ticks each second (catching up at most 5 seconds after a
stall) and starts each due job on its own task with a fresh Context (a
no-op request) under a ``cron <name>`` span.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Any

from .context import Context
from .handler import HandlerFunc, invoke
from .tracing import Tracer

__all__ = ["Cron", "parse_schedule", "CronSchedule", "InvalidCronError"]

_FIELD_RANGES = [
    ("second", 0, 59),
    ("minute", 0, 59),
    ("hour", 0, 23),
    ("day", 1, 31),
    ("month", 1, 12),
    ("dow", 0, 6),
]


class InvalidCronError(ValueError):
    pass


def _parse_field(expr: str, lo: int, hi: int, name: str) -> frozenset[int]:
    out: set[int] = set()
    for part in expr.split(","):
        step = 1
        if "/" in part:
            part, _, step_s = part.partition("/")
            try:
                step = int(step_s)
            except ValueError:
                raise InvalidCronError(
                    f"bad step in {name}: {step_s!r}") from None
            if step <= 0:
                raise InvalidCronError(f"step must be positive in {name}")
        if part in ("*", ""):
            lo2, hi2 = lo, hi
        elif "-" in part:
            a, _, b = part.partition("-")
            try:
                lo2, hi2 = int(a), int(b)
            except ValueError:
                raise InvalidCronError(
                    f"bad range in {name}: {part!r}") from None
        else:
            try:
                lo2 = hi2 = int(part)
            except ValueError:
                raise InvalidCronError(
                    f"bad value in {name}: {part!r}") from None
        if lo2 < lo or hi2 > hi or lo2 > hi2:
            raise InvalidCronError(
                f"{name} value out of range [{lo},{hi}]: {part!r}"
            )
        out.update(range(lo2, hi2 + 1, step))
    return frozenset(out)


@dataclass(frozen=True)
class CronSchedule:
    seconds: frozenset[int]
    minutes: frozenset[int]
    hours: frozenset[int]
    days: frozenset[int]
    months: frozenset[int]
    dows: frozenset[int]
    day_restricted: bool
    dow_restricted: bool

    def matches(self, t: time.struct_time) -> bool:
        if t.tm_sec not in self.seconds or t.tm_min not in self.minutes:
            return False
        if t.tm_hour not in self.hours or t.tm_mon not in self.months:
            return False
        day_ok = t.tm_mday in self.days
        dow_ok = ((t.tm_wday + 1) % 7) in self.dows  # Mon=0 -> cron Sun=0
        # both the day of the month and the weekday restricted: either
        if self.day_restricted and self.dow_restricted:
            return day_ok or dow_ok
        if self.day_restricted:
            return day_ok
        if self.dow_restricted:
            return dow_ok
        return True


def parse_schedule(expr: str) -> CronSchedule:
    fields = expr.split()
    if len(fields) == 5:
        fields = ["0"] + fields  # no seconds field → fire at second 0
    if len(fields) != 6:
        raise InvalidCronError(
            f"schedule must have 5 or 6 fields, got {len(fields)}: {expr!r}"
        )
    parsed = [
        _parse_field(f, lo, hi, name)
        for f, (name, lo, hi) in zip(fields, _FIELD_RANGES, strict=True)
    ]
    return CronSchedule(
        seconds=parsed[0],
        minutes=parsed[1],
        hours=parsed[2],
        days=parsed[3],
        months=parsed[4],
        dows=parsed[5],
        day_restricted=fields[3] != "*",
        dow_restricted=fields[5] != "*",
    )


class _NoopRequest:
    """The request of a cron job's Context."""

    def param(self, key: str) -> str:
        return ""

    def params(self, key: str) -> list[str]:
        return []

    def path_param(self, key: str) -> str:
        return ""

    async def bind(self, model: type | None = None) -> Any:
        return None

    def host_name(self) -> str:
        return "gofr-cron"

    def context(self) -> Any:
        return None


class Cron:
    def __init__(self, container, tracer: Tracer | None = None) -> None:
        self._container = container
        self._tracer = tracer
        self._jobs: list[tuple[CronSchedule, str, HandlerFunc]] = []
        self._running: set[asyncio.Task] = set()

    def add_job(self, schedule: str, name: str, fn: HandlerFunc) -> None:
        self._jobs.append((parse_schedule(schedule), name, fn))
        self._container.logger.infof("cron job %s registered: %s", name,
                                     schedule)

    async def run(self) -> None:
        """Tick each second; start every due job on its own task."""
        last_tick = int(time.time())
        while True:
            await asyncio.sleep(max(0.0, 1.0 - (time.time() % 1.0)))
            now = int(time.time())
            # catch up at most a few missed seconds (event-loop stalls)
            for sec in range(last_tick + 1, min(now, last_tick + 5) + 1):
                t = time.localtime(sec)
                for schedule, name, fn in self._jobs:
                    if schedule.matches(t):
                        task = asyncio.ensure_future(self._run_job(name, fn))
                        self._running.add(task)
                        task.add_done_callback(self._running.discard)
            last_tick = max(now, last_tick)

    async def _run_job(self, name: str, fn: HandlerFunc) -> None:
        span = None
        if self._tracer is not None:
            span = self._tracer.start_span(f"cron {name}", kind="INTERNAL")
        ctx = Context(_NoopRequest(), self._container, span=span)
        try:
            await invoke(fn, ctx)
        except Exception as exc:  # a failing job is logged, the rest run
            self._container.logger.errorf("cron job %s failed: %s", name,
                                          exc)
            if span is not None:
                span.record_exception(exc)
        finally:
            if span is not None:
                span.end()
