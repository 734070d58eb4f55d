"""Tracing — counterpart of ``gofr_tpu/tracing``: ratio-sampled spans
carried through ``contextvars``, W3C ``traceparent`` parse and format, and
a batch processor feeding an exporter.

``new_tracer(config)`` picks the exporter as the JAX package does:
``TRACE_EXPORTER=otlp`` or ``jaeger`` with ``TRACER_URL`` posts OTLP/HTTP
JSON to the collector's ``/v1/traces`` (a URL naming Zipkin's
``/api/v2/spans`` keeps the Zipkin format), ``zipkin`` or ``gofr`` posts
Zipkin-v2 JSON, ``console`` logs each finished span at DEBUG, and
anything else exports nothing. ``NoopTracer`` samples nothing.
"""

from __future__ import annotations

import contextvars
import json
import queue
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Mapping

__all__ = ["Span", "SpanContext", "Tracer", "NoopTracer", "SpanExporter",
           "ConsoleExporter", "ZipkinJSONExporter", "OTLPHTTPExporter",
           "new_tracer", "current_span", "current_context",
           "current_traceparent", "parse_traceparent", "format_traceparent"]

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


class SpanExporter:
    """What the batch processor hands finished spans to."""

    def export(self, spans: list[Span]) -> None:
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class ConsoleExporter(SpanExporter):
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


class _HTTPJSONExporter(SpanExporter):
    """POSTs each batch, encoded as JSON, to an HTTP collector."""

    def __init__(self, url: str, service_name: str, logger=None,
                 timeout: float = 5.0) -> None:
        self.url = url
        self.service_name = service_name
        self._logger = logger
        self._timeout = timeout

    def encode(self, spans: list[Span]) -> Any:
        raise NotImplementedError

    def export(self, spans: list[Span]) -> None:
        import http.client
        import urllib.request

        body = json.dumps(self.encode(spans)).encode()
        req = urllib.request.Request(
            self.url, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=self._timeout).close()
        except (OSError, http.client.HTTPException) as exc:
            # a collector that is down never breaks serving; warn, so a
            # wrong TRACER_URL does not drop every span unseen
            if self._logger is not None:
                self._logger.warn(f"trace export to {self.url} failed: {exc}")


class ZipkinJSONExporter(_HTTPJSONExporter):
    """Batches of Zipkin-v2 JSON spans."""

    def _encode(self, s: Span) -> dict:
        out: dict[str, Any] = {
            "traceId": s.trace_id,
            "id": s.span_id,
            "name": s.name,
            "kind": (s.kind if s.kind in ("SERVER", "CLIENT", "PRODUCER",
                                          "CONSUMER") else None),
            "timestamp": int(s.start_time * 1e6),
            "duration": max(1, int(((s.end_time or s.start_time)
                                    - s.start_time) * 1e6)),
            "localEndpoint": {"serviceName": self.service_name},
            "tags": {str(k): str(v) for k, v in s.attributes.items()},
        }
        if s.parent_span_id:
            out["parentId"] = s.parent_span_id
        if s.status_code == "ERROR":
            out["tags"]["error"] = s.status_message or "true"
        return {k: v for k, v in out.items() if v is not None}

    def encode(self, spans: list[Span]) -> list[dict]:
        return [self._encode(s) for s in spans]


_OTLP_KIND = {"INTERNAL": 1, "SERVER": 2, "CLIENT": 3, "PRODUCER": 4,
              "CONSUMER": 5}
_OTLP_STATUS = {"UNSET": 0, "OK": 1, "ERROR": 2}
# the instrumentation scope keeps the JAX package's name, so a collector's
# queries select both packages' spans alike
_OTLP_SCOPE = "gofr_tpu.tracing"


def _otlp_any_value(value: Any) -> dict:
    """A value as an OTLP AnyValue; 64-bit ints travel as decimal
    strings (the OTLP/JSON mapping)."""
    if isinstance(value, bool):
        return {"boolValue": value}
    if isinstance(value, int):
        return {"intValue": str(value)}
    if isinstance(value, float):
        return {"doubleValue": value}
    return {"stringValue": str(value)}


def _otlp_attrs(attrs: Mapping[str, Any]) -> list[dict]:
    return [{"key": str(k), "value": _otlp_any_value(v)}
            for k, v in attrs.items()]


class OTLPHTTPExporter(_HTTPJSONExporter):
    """OTLP/HTTP JSON batches to a collector's ``/v1/traces`` (any
    OpenTelemetry collector; Jaeger 1.35 and later ingest it): hex ids,
    unix-nano timestamps as strings, typed attributes, numeric kind and
    status."""

    def __init__(self, url: str, service_name: str, logger=None,
                 timeout: float = 5.0) -> None:
        # a collector's base URL or the full signal path
        if not url.rstrip("/").endswith("/v1/traces"):
            url = url.rstrip("/") + "/v1/traces"
        super().__init__(url, service_name, logger, timeout)

    def _encode_span(self, s: Span) -> dict:
        end = s.end_time or s.start_time
        out: dict[str, Any] = {
            "traceId": s.trace_id,
            "spanId": s.span_id,
            "name": s.name,
            "kind": _OTLP_KIND.get(s.kind, 1),
            "startTimeUnixNano": str(int(s.start_time * 1e9)),
            "endTimeUnixNano": str(int(end * 1e9)),
            "attributes": _otlp_attrs(s.attributes),
            "status": {"code": _OTLP_STATUS.get(s.status_code, 0)},
        }
        if s.parent_span_id:
            out["parentSpanId"] = s.parent_span_id
        if s.status_message:
            out["status"]["message"] = s.status_message
        if s.events:
            out["events"] = [{"timeUnixNano": str(int(ts * 1e9)),
                              "name": name, "attributes": _otlp_attrs(attrs)}
                             for ts, name, attrs in s.events]
        return out

    def encode(self, spans: list[Span]) -> dict:
        return {"resourceSpans": [{
            "resource": {"attributes": _otlp_attrs(
                {"service.name": self.service_name})},
            "scopeSpans": [{"scope": {"name": _OTLP_SCOPE},
                            "spans": [self._encode_span(s)
                                      for s in spans]}]}]}


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
                try:
                    self._exporter.export(buf)
                finally:
                    buf = []
        if buf:
            self._exporter.export(buf)

    def shutdown(self) -> None:
        self._stopped = True
        self._queue.put(None)
        self._thread.join(timeout=5)
        self._exporter.shutdown()


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


class NoopTracer(Tracer):
    """Samples nothing and exports nothing."""

    def __init__(self) -> None:
        super().__init__("noop", None, 0.0)


def new_tracer(config, logger=None) -> Tracer:
    """A tracer from ``TRACE_EXPORTER``, ``TRACER_URL``, ``TRACER_RATIO``
    and ``APP_NAME`` (see the module docstring)."""
    try:
        ratio = float(config.get_or_default("TRACER_RATIO", "1"))
    except ValueError:
        ratio = 1.0
    name = (config.get("TRACE_EXPORTER") or "").lower()
    url = config.get("TRACER_URL")
    service = config.get_or_default("APP_NAME", "gofr-app")
    exporter: SpanExporter | None = None
    if name in ("otlp", "jaeger") and url:
        # posting OTLP at a Zipkin ingest path would 404 every batch
        if "/api/v2/spans" in url:
            exporter = ZipkinJSONExporter(url, service, logger)
        else:
            exporter = OTLPHTTPExporter(url, service, logger)
    elif name in ("zipkin", "gofr") and url:
        exporter = ZipkinJSONExporter(url, service, logger)
    elif name == "console":
        exporter = ConsoleExporter(logger)
    if isinstance(exporter, _HTTPJSONExporter) and logger is not None:
        logger.infof("exporting traces to %s at %s", name, exporter.url)
    return Tracer(service, exporter, ratio)
