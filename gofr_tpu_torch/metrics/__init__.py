"""Metrics — counterpart of ``gofr_tpu/metrics``: a typed metric store
with Prometheus text exposition (format 0.0.4), served at ``/metrics`` by
the app's metrics server.

``Manager`` registers counters, up-down counters, gauges and histograms
(registering a name twice, or recording to an unknown one, raises) and
renders them with ``expose_text``. Gauge samplers registered with
``register_sampler`` refresh runtime gauges on every scrape and from a
``SamplerThread`` between scrapes; ``Timer`` records a block's seconds
into a histogram. Bucket edges, label rendering and
number formatting are the JAX package's, so the two expose the same text
for the same values.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Iterable, Mapping

__all__ = ["Manager", "MetricsError", "DuplicateMetricError",
           "MetricNotFoundError", "DEFAULT_BUCKETS", "SamplerThread",
           "Timer"]

DEFAULT_BUCKETS = (
    0.001, 0.003, 0.005, 0.01, 0.02, 0.03, 0.05, 0.1, 0.2, 0.3, 0.5,
    0.75, 1, 2, 3, 5, 10, 30,
)


class MetricsError(Exception):
    pass


class DuplicateMetricError(MetricsError):
    def __init__(self, name: str) -> None:
        super().__init__(f"metric {name!r} already registered")


class MetricNotFoundError(MetricsError):
    def __init__(self, name: str) -> None:
        super().__init__(f"metric {name!r} is not registered")


def _label_key(labels: Mapping[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(key: tuple[tuple[str, str], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, v.replace("\\", "\\\\").replace('"', '\\"')
                     .replace("\n", "\\n"))
        for k, v in key)
    return "{" + inner + "}"


class _Metric:
    prom_type = "untyped"

    def __init__(self, name: str, description: str) -> None:
        self.name = name
        self.description = description
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}

    def _header(self, out: list[str]) -> None:
        out.append(f"# HELP {self.name} {self.description}")
        out.append(f"# TYPE {self.name} {self.prom_type}")

    def expose(self, out: list[str]) -> None:
        self._header(out)
        with self._lock:
            items = list(self._values.items()) or [((), 0.0)]
        for key, val in items:
            out.append(f"{self.name}{_fmt_labels(key)} {_fmt_value(val)}")


class _Counter(_Metric):
    prom_type = "counter"

    def add(self, delta: float, labels: Mapping[str, str]) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + delta


class _UpDownCounter(_Counter):
    prom_type = "gauge"


class _Gauge(_Metric):
    prom_type = "gauge"

    def set(self, value: float, labels: Mapping[str, str]) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)


class _Histogram(_Metric):
    prom_type = "histogram"

    def __init__(self, name: str, description: str,
                 buckets: Iterable[float]) -> None:
        super().__init__(name, description)
        self.buckets = tuple(sorted(set(float(b) for b in buckets)))
        self._series: dict[tuple, list] = {}  # key -> [counts, sum, count]

    def record(self, value: float, labels: Mapping[str, str]) -> None:
        key = _label_key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = [[0] * len(self.buckets), 0.0, 0]
            counts = series[0]
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            series[1] += value
            series[2] += 1

    def percentile(self, q: float,
                   labels: Mapping[str, str] | None = None) -> float:
        """Approximate percentile from the bucket edges (for in-process
        checks and ``/debug/serving``; Prometheus does the real math)."""
        key = _label_key(labels or {})
        with self._lock:
            series = self._series.get(key)
            if series is None or series[2] == 0:
                return float("nan")
            counts, _, total = series
            rank = q * total
            for i, b in enumerate(self.buckets):
                if counts[i] >= rank:
                    return b
            return self.buckets[-1]

    def expose(self, out: list[str]) -> None:
        self._header(out)
        with self._lock:
            items = [(k, (list(v[0]), v[1], v[2]))
                     for k, v in self._series.items()]
        for key, (counts, total, count) in items:
            for i, b in enumerate(self.buckets):
                bkey = tuple(sorted(key + (("le", _fmt_value(b)),)))
                out.append(f"{self.name}_bucket{_fmt_labels(bkey)} "
                           f"{counts[i]}")
            inf_key = tuple(sorted(key + (("le", "+Inf"),)))
            out.append(f"{self.name}_bucket{_fmt_labels(inf_key)} {count}")
            out.append(f"{self.name}_sum{_fmt_labels(key)} "
                       f"{_fmt_value(total)}")
            out.append(f"{self.name}_count{_fmt_labels(key)} {count}")


class Manager:
    """The typed metric store (``ctx.metrics()``)."""

    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()
        self._samplers: list = []

    def _register(self, metric: _Metric) -> None:
        with self._lock:
            if metric.name in self._metrics:
                raise DuplicateMetricError(metric.name)
            self._metrics[metric.name] = metric

    def new_counter(self, name: str, description: str = "") -> None:
        self._register(_Counter(name, description))

    def new_updown_counter(self, name: str, description: str = "") -> None:
        self._register(_UpDownCounter(name, description))

    def new_gauge(self, name: str, description: str = "") -> None:
        self._register(_Gauge(name, description))

    def new_histogram(self, name: str, description: str = "",
                      buckets: Iterable[float] = DEFAULT_BUCKETS) -> None:
        self._register(_Histogram(name, description, buckets))

    def _get(self, name: str, kind: type) -> _Metric:
        metric = self._metrics.get(name)
        if metric is None or not isinstance(metric, kind):
            raise MetricNotFoundError(name)
        return metric

    def increment_counter(self, name: str, **labels: str) -> None:
        self._get(name, _Counter).add(1.0, labels)

    def add_counter(self, name: str, delta: float, **labels: str) -> None:
        self._get(name, _Counter).add(delta, labels)

    def delta_updown_counter(self, name: str, delta: float,
                             **labels: str) -> None:
        self._get(name, _UpDownCounter).add(delta, labels)

    def set_gauge(self, name: str, value: float, **labels: str) -> None:
        self._get(name, _Gauge).set(value, labels)

    def record_histogram(self, name: str, value: float, **labels: str) -> None:
        self._get(name, _Histogram).record(value, labels)

    def percentile(self, name: str, q: float, **labels: str) -> float:
        return self._get(name, _Histogram).percentile(q, labels)

    def has(self, name: str) -> bool:
        return name in self._metrics

    def register_sampler(self, fn) -> None:
        """Add a zero-arg callable that refreshes gauges from live state;
        it runs on every scrape and on the ``SamplerThread``."""
        with self._lock:
            self._samplers.append(fn)

    def run_samplers(self) -> None:
        with self._lock:
            samplers = list(self._samplers)
        for fn in samplers:
            try:
                fn()
            except Exception:
                pass  # a broken sampler must never break the scrape

    def expose_text(self) -> str:
        """Every metric in Prometheus text exposition format 0.0.4."""
        self.run_samplers()
        out: list[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            m.expose(out)
        return "\n".join(out) + "\n"


class SamplerThread:
    """Runs the manager's gauge samplers every ``interval_s`` seconds, so
    runtime gauges stay fresh between scrapes."""

    def __init__(self, manager: Manager, interval_s: float = 10.0) -> None:
        self._manager = manager
        self._interval = max(0.1, float(interval_s))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="gofr-torch-metrics-sampler")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self._manager.run_samplers()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


class Timer:
    """Context manager recording its block's elapsed seconds into a
    histogram."""

    def __init__(self, manager: Manager, name: str, **labels: str) -> None:
        self._m = manager
        self._name = name
        self._labels = labels
        self._start = 0.0

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._m.record_histogram(self._name,
                                 time.perf_counter() - self._start,
                                 **self._labels)
