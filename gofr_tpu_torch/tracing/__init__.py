"""Tracing — counterpart of ``gofr_tpu/tracing``: ratio-sampled spans
carried through ``contextvars``, W3C ``traceparent`` parse and format, and
a batch processor feeding an exporter.

``TRACE_EXPORTER=console`` logs each finished span at DEBUG; unset (or any
other value) exports nothing. The JAX package's OTLP and Zipkin HTTP
exporters are not ported: the port's front makes no outbound calls.
"""

from __future__ import annotations

import contextvars
import queue
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Mapping

__all__ = ["Span", "SpanContext", "Tracer", "new_tracer",
           "current_span", "current_context", "current_traceparent",
           "parse_traceparent", "format_traceparent"]

_current_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "gofr_torch_current_span", default=None)


def _rand_trace_id() -> str:
    return f"{random.getrandbits(128):032x}"


def _rand_span_id() -> str:
    return f"{random.getrandbits(64):016x}"


@dataclass(frozen=True)
class SpanContext:
    trace_id: str
    span_id: str
    sampled: bool = True


def parse_traceparent(header: str | None) -> SpanContext | None:
    """Parse a W3C ``traceparent`` header (``00-<32x>-<16x>-<2x>``); None
    when absent or malformed."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    try:
        trace, span = int(parts[1], 16), int(parts[2], 16)
        flags = int(parts[3], 16)
    except ValueError:
        return None
    if trace == 0 or span == 0:
        return None
    return SpanContext(parts[1], parts[2], bool(flags & 1))


def format_traceparent(ctx: SpanContext) -> str:
    return f"00-{ctx.trace_id}-{ctx.span_id}-{'01' if ctx.sampled else '00'}"


@dataclass
class Span:
    name: str
    context: SpanContext
    parent_span_id: str | None = None
    kind: str = "INTERNAL"
    start_time: float = field(default_factory=time.time)
    end_time: float | None = None
    attributes: dict[str, Any] = field(default_factory=dict)
    events: list[tuple[float, str, dict]] = field(default_factory=list)
    status_code: str = "UNSET"  # OK | ERROR | UNSET
    status_message: str = ""
    _tracer: "Tracer | None" = None
    _token: Any = None

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def set_attributes(self, attrs: Mapping[str, Any]) -> None:
        self.attributes.update(attrs)

    def add_event(self, name: str, attrs: Mapping[str, Any] | None = None
                  ) -> None:
        self.events.append((time.time(), name, dict(attrs or {})))

    def set_status(self, code: str, message: str = "") -> None:
        self.status_code = code
        self.status_message = message

    def record_exception(self, exc: BaseException) -> None:
        self.add_event("exception", {"type": type(exc).__name__,
                                     "message": str(exc)})
        self.set_status("ERROR", str(exc))

    def end(self) -> None:
        if self.end_time is not None:
            return
        self.end_time = time.time()
        if self._token is not None:
            try:
                _current_span.reset(self._token)
            except ValueError:  # ended in another context
                _current_span.set(None)
            self._token = None
        if self._tracer is not None:
            self._tracer._on_end(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.record_exception(exc)
        self.end()

    @property
    def trace_id(self) -> str:
        return self.context.trace_id

    @property
    def span_id(self) -> str:
        return self.context.span_id


def current_span() -> Span | None:
    return _current_span.get()


def current_context() -> SpanContext | None:
    """The active span's context, captured at enqueue time so the serving
    thread can parent its spans explicitly (``contextvars`` do not follow
    work handed to another thread)."""
    span = _current_span.get()
    return span.context if span is not None else None


def current_traceparent() -> str | None:
    """The active span's W3C ``traceparent``, or None: what a wire frame
    carries so the receiving process parents its spans in the same
    trace."""
    ctx = current_context()
    return format_traceparent(ctx) if ctx is not None else None


class ConsoleExporter:
    """Logs each finished span at DEBUG through the app's logger."""

    def __init__(self, logger=None) -> None:
        self._logger = logger

    def export(self, spans: list[Span]) -> None:
        if self._logger is None:
            return
        for s in spans:
            self._logger.debug("span", trace_id=s.trace_id,
                               span_id=s.span_id, name=s.name,
                               duration_us=int(((s.end_time or s.start_time)
                                                - s.start_time) * 1e6))


class _BatchProcessor:
    """Queue + background thread flushing spans to an exporter."""

    def __init__(self, exporter, max_batch: int = 256,
                 interval: float = 2.0) -> None:
        self._exporter = exporter
        self._queue: queue.Queue[Span | None] = queue.Queue(maxsize=8192)
        self._max_batch = max_batch
        self._interval = interval
        self._stopped = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="gofr-torch-trace-export")
        self._thread.start()

    def submit(self, span: Span) -> None:
        if self._stopped:
            return
        try:
            self._queue.put_nowait(span)
        except queue.Full:
            pass

    def _run(self) -> None:
        buf: list[Span] = []
        while True:
            try:
                item = self._queue.get(timeout=self._interval)
            except queue.Empty:
                item = False  # the interval passed: flush what is there
            if item is None:
                break
            if item:
                buf.append(item)
            if buf and (len(buf) >= self._max_batch or item is False):
                self._exporter.export(buf)
                buf = []
        if buf:
            self._exporter.export(buf)

    def shutdown(self) -> None:
        self._stopped = True
        self._queue.put(None)
        self._thread.join(timeout=5)


class Tracer:
    """Creates spans; sampling is decided at a trace's root with
    probability ``sample_ratio`` and inherited below it."""

    def __init__(self, service_name: str = "gofr-app", exporter=None,
                 sample_ratio: float = 1.0) -> None:
        self.service_name = service_name
        self.sample_ratio = sample_ratio
        self._processor = (_BatchProcessor(exporter)
                           if exporter is not None else None)

    def start_span(self, name: str, *,
                   parent: SpanContext | Span | None = None,
                   kind: str = "INTERNAL",
                   attributes: Mapping[str, Any] | None = None,
                   activate: bool = True) -> Span:
        if parent is None:
            parent = current_span()
        parent_ctx = parent.context if isinstance(parent, Span) else parent
        if parent_ctx is not None:
            ctx = SpanContext(parent_ctx.trace_id, _rand_span_id(),
                              parent_ctx.sampled)
            parent_id = parent_ctx.span_id
        else:
            ctx = SpanContext(_rand_trace_id(), _rand_span_id(),
                              random.random() < self.sample_ratio)
            parent_id = None
        span = Span(name=name, context=ctx, parent_span_id=parent_id,
                    kind=kind, attributes=dict(attributes or {}),
                    _tracer=self)
        if activate:
            span._token = _current_span.set(span)
        return span

    def _on_end(self, span: Span) -> None:
        if self._processor is not None and span.context.sampled:
            self._processor.submit(span)

    def inject(self, span: Span | None = None) -> dict[str, str]:
        """The ``traceparent`` header that propagates ``span`` (default:
        the active span) to a downstream call."""
        span = span or current_span()
        if span is None:
            return {}
        return {"traceparent": format_traceparent(span.context)}

    def shutdown(self) -> None:
        if self._processor is not None:
            self._processor.shutdown()


def new_tracer(config, logger=None) -> Tracer:
    """A tracer from ``TRACE_EXPORTER`` (``console`` or none),
    ``TRACER_RATIO`` and ``APP_NAME``."""
    try:
        ratio = float(config.get_or_default("TRACER_RATIO", "1"))
    except ValueError:
        ratio = 1.0
    exporter = None
    if (config.get("TRACE_EXPORTER") or "").lower() == "console":
        exporter = ConsoleExporter(logger)
    return Tracer(config.get_or_default("APP_NAME", "gofr-app"), exporter,
                  ratio)
