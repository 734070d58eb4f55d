"""Dependency-injection container — counterpart of
``gofr_tpu/container``, cut to the serving front: the logger, the metrics
manager with the framework's metric set registered, the tracer, the
``ml`` datasource, ``health()`` (the
aggregate readiness behind ``/.well-known/health``) and ``close()``. The
SQL, Redis, KV and pub/sub datasources of the JAX package are not
ported."""

from __future__ import annotations

import inspect
import threading
import time

from .config import Config, MapConfig
from .logging import Logger, new_logger
from .metrics import Manager

__all__ = ["Container", "new_container"]

STATUS_UP = "UP"
STATUS_DOWN = "DOWN"
STATUS_DEGRADED = "DEGRADED"


class Container:
    """Holds everything the handler Context exposes."""

    def __init__(self, config: Config | None = None,
                 logger: Logger | None = None) -> None:
        self.config: Config = config or MapConfig()
        self.logger: Logger = logger or new_logger(self.config.get("LOG_LEVEL"))
        self.metrics_manager = Manager()
        self.tracer = None  # set by the App
        self.app_name = self.config.get_or_default("APP_NAME", "gofr-app")
        self.app_version = self.config.get_or_default("APP_VERSION", "dev")
        self.ml = None  # the model runtime datasource (ml.MLDatasource)
        self._start_time = time.time()

    def register_framework_metrics(self) -> None:
        """The metric set the front and the serving path record into, with
        the JAX package's names, descriptions and bucket edges."""
        m = self.metrics_manager
        m.new_gauge("app_info", "app info: name and version")
        m.set_gauge("app_info", 1, app_name=self.app_name,
                    app_version=self.app_version)
        m.new_histogram("app_http_response", "HTTP response time in seconds")
        m.new_gauge("app_process_memory_bytes", "resident set size")
        m.new_gauge("app_process_threads", "thread count")
        m.new_gauge("app_process_uptime_seconds", "seconds since start")
        m.new_histogram(
            "app_llm_ttft_seconds", "LLM time to first token",
            buckets=(0.01, 0.025, 0.05, 0.1, 0.2, 0.4, 0.8, 1.6, 3.2))
        m.new_histogram(
            "app_llm_tpot_seconds",
            "LLM time per output token after the first (stream cadence)",
            buckets=(0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0))
        m.new_counter("app_llm_tokens_total",
                      "LLM tokens streamed to consumers")
        m.new_gauge("app_llm_active_slots", "decode slots currently live")
        m.new_histogram("app_llm_queue_seconds",
                        "LLM request wait before slot admission")
        m.new_gauge(
            "app_ml_queue_depth",
            "pending work per serving component (engine dispatch queue, "
            "batcher backlog, llm waiting requests)")
        m.new_counter("app_ml_prefix_hits_total",
                      "admissions served from a cached shared KV prefix")
        m.new_counter("app_ml_prefix_misses_total",
                      "admissions with no usable cached prefix")
        m.new_counter("app_ml_prefix_evictions_total",
                      "cached prefixes dropped (cap or pool pressure)")
        m.new_counter("app_ml_prefill_tokens_saved_total",
                      "prompt tokens NOT re-prefilled thanks to prefix reuse")
        m.new_counter("app_ml_kv_offload_spills_total",
                      "evicted prefix KV page sets copied device->host")
        m.new_counter("app_ml_kv_offload_restores_total",
                      "offloaded prefix KV page sets copied host->device "
                      "on a cache hit")
        m.new_gauge("app_ml_kv_offload_bytes",
                    "bytes held by the host-RAM KV offload tier")
        m.new_histogram(
            "app_llm_priority_queue_seconds",
            "LLM request wait before slot admission per priority class")
        m.new_histogram(
            "app_llm_chunk_tokens",
            "decode steps per dispatch picked from the chunk ladder",
            buckets=(1, 2, 4, 8, 16, 32, 64))
        m.new_gauge("app_llm_token_budget",
                    "per-dispatch token budget (decode + chunked prefill)")
        m.new_gauge("app_llm_prefill_share",
                    "budget fraction reserved for chunked prefill "
                    "(SLO-steered)")
        m.new_counter("app_llm_deadline_exceeded_total",
                      "LLM requests reaped past their deadline (queued or "
                      "mid-decode)")
        m.new_counter("app_llm_shed_total",
                      "LLM requests shed at admission under overload, per "
                      "priority class")
        m.new_gauge("app_llm_evictions",
                    "streams truncated because the KV page pool ran dry")
        m.new_gauge("app_llm_prefix_evictions",
                    "idle shared prefixes LRU-dropped under pool pressure")
        m.new_gauge("app_llm_free_pages", "free KV pages in the paged pool")
        # the serving recorders: watchdog, flight recorder, journeys,
        # goodput ledger and the program inventory
        m.new_counter("app_ml_generator_restarts_total",
                      "LLM generator crashes recovered by the serving "
                      "watchdog (decode state reset, queue resumed)")
        m.new_counter("app_ml_events_dropped_total",
                      "event-log ring overwrites: events consumers polling "
                      "/debug/events can no longer read (their cursor "
                      "gapped)")
        m.new_counter("app_ml_journeys_total",
                      "request journeys sealed, by finish reason (stop / "
                      "length / eviction / deadline / shed / crashed / "
                      "cancelled / error)")
        m.new_gauge("app_ml_host_rss_bytes",
                    "current process resident set size (the offload "
                    "tier's footprint lives here)")
        m.new_histogram(
            "app_llm_dispatch_phase_seconds",
            "serving dispatch wall time per phase (flight recorder: "
            "queue_pop / decide / assemble / launch / d2h_issue / "
            "device_wait / emit / other)",
            # phases run from microseconds (a scheduler plan) to a whole
            # device step: the default buckets' 1 ms floor would flatten
            # every host-side phase into one bucket
            buckets=(5e-5, 2e-4, 5e-4, 1e-3, 3e-3, 5e-3, 0.01, 0.02,
                     0.03, 0.05, 0.1, 0.2, 0.5, 1.0))
        m.new_counter("app_llm_tokens_wasted_total",
                      "device-computed tokens that never delivered, by "
                      "reason (deadline_cancelled / crashed / disconnected "
                      "/ restore_fallback / window_overshoot / "
                      "pipeline_overshoot) — the goodput ledger's waste "
                      "side")
        m.new_gauge("app_llm_goodput_fraction",
                    "delivered / device-computed tokens per model (the "
                    "goodput ledger's headline ratio)")
        m.new_counter("app_ml_compile_seconds_total",
                      "wall seconds spent capturing decode graphs and on "
                      "the first runs of the prefill buckets")
        m.new_gauge("app_ml_programs",
                    "device programs in a model's inventory (decode "
                    "graphs and prefill buckets; the /debug/programs row "
                    "count)")

    def refresh_process_metrics(self) -> None:
        m = self.metrics_manager
        try:
            import resource

            m.set_gauge("app_process_memory_bytes",
                        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                        * 1024)
        except Exception:
            pass
        m.set_gauge("app_process_threads", threading.active_count())
        m.set_gauge("app_process_uptime_seconds",
                    time.time() - self._start_time)

    async def health(self) -> dict:
        """Aggregate readiness: each datasource's ``health_check()``, and
        overall DEGRADED when any is not UP."""
        out: dict = {}
        overall = STATUS_UP
        if self.ml is not None:
            try:
                result = self.ml.health_check()
                if inspect.isawaitable(result):
                    result = await result
            except Exception as exc:
                result = {"status": STATUS_DOWN, "error": str(exc)}
            if result.get("status") != STATUS_UP:
                overall = STATUS_DEGRADED
            out["ml"] = result
        out["status"] = overall
        out["name"] = self.app_name
        out["version"] = self.app_version
        return out

    async def close(self) -> None:
        if self.ml is None:
            return
        try:
            result = self.ml.close()
            if inspect.isawaitable(result):
                await result
        except Exception as exc:
            self.logger.warnf("error closing datasource: %s", exc)


def new_container(config: Config, logger: Logger | None = None) -> Container:
    c = Container(config, logger=logger)
    c.register_framework_metrics()
    return c
