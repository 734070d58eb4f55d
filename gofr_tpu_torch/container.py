"""Dependency-injection container — counterpart of
``gofr_tpu/container``: the logger, the metrics manager with the
framework's metric set registered (the front's, SQL's and outbound
calls', the model runtime's ``app_tpu_*`` and ``app_ml_*`` series and the
LLM's ``app_llm_*``), the tracer, the datasources, the inter-service HTTP
clients (``services``), the live websocket connections, ``health()`` (the
aggregate readiness behind ``/.well-known/health``) and ``close()``.

``new_container`` builds SQL from ``DB_DIALECT=sqlite`` (``DB_NAME``, an
in-memory database by default), which migrations (``migration/``) and
CRUD (``crud.py``) run on. Other datasources come in through
``add_datasource`` (the ``Provider`` contract: logger, metrics and
tracer injected, then ``connect()``); outbound clients through
``App.add_http_service``. The ``ml`` datasource holds the models and LLM
servers.

Not ported yet, each queued in ROADMAP A: pub/sub and the subscriber
(A.18); Redis, the KV and file stores, and SQL's ``mysql`` and
``postgres`` dialects, for which ``new_sql`` raises ``ValueError``
(A.19); the wire-protocol stores (Mongo, Cassandra, ClickHouse, Dgraph,
Solr, OpenTSDB; A.20); the CLI and ``container/mock.py`` (A.21). Their
attributes stay None.
"""

from __future__ import annotations

import inspect
import threading
import time
from typing import Any, Protocol, runtime_checkable

from .config import Config, MapConfig
from .logging import Logger, new_logger
from .metrics import Manager

__all__ = ["Container", "HealthChecker", "Provider", "new_container"]

STATUS_UP = "UP"
STATUS_DOWN = "DOWN"
STATUS_DEGRADED = "DEGRADED"

# the datasource attributes, in the order health and close visit them
DATASOURCES = ("sql", "redis", "kv", "file", "pubsub", "cassandra",
               "clickhouse", "mongo", "dgraph", "solr", "opentsdb", "ml")


@runtime_checkable
class HealthChecker(Protocol):
    def health_check(self) -> dict: ...


@runtime_checkable
class Provider(Protocol):
    """An injected datasource: the container gives it the app's
    observability, then connects it."""

    def use_logger(self, logger: Any) -> None: ...
    def use_metrics(self, metrics: Any) -> None: ...
    def use_tracer(self, tracer: Any) -> None: ...
    def connect(self) -> None: ...


async def _call(fn) -> Any:
    result = fn()
    if inspect.isawaitable(result):
        result = await result
    return result


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
        for name in DATASOURCES:
            setattr(self, name, None)  # ml: the model runtime (MLDatasource)
        self.services: dict[str, Any] = {}  # inter-service HTTP clients
        self.websocket_connections: dict[str, Any] = {}
        self._extra_datasources: dict[str, Any] = {}
        self._start_time = time.time()

    def register_framework_metrics(self) -> None:
        """The metric set the front and the serving path record into, with
        the JAX package's names, descriptions and bucket edges."""
        m = self.metrics_manager
        m.new_gauge("app_info", "app info: name and version")
        m.set_gauge("app_info", 1, app_name=self.app_name,
                    app_version=self.app_version)
        m.new_histogram("app_http_response", "HTTP response time in seconds")
        m.new_histogram("app_http_service_response",
                        "outbound HTTP call time in seconds")
        m.new_histogram("app_sql_stats", "SQL statement time in seconds")
        m.new_gauge("app_process_memory_bytes", "resident set size")
        m.new_gauge("app_process_threads", "thread count")
        m.new_gauge("app_process_uptime_seconds", "seconds since start")
        # the model runtime's series keep the JAX package's names (the
        # ``tpu`` in them included), so dashboards compare like with like
        m.new_histogram(
            "app_tpu_step_seconds", "on-device execute time per step")
        m.new_gauge("app_tpu_hbm_bytes_in_use", "HBM bytes in use per device")
        m.new_gauge("app_tpu_hbm_bytes_limit", "HBM bytes limit per device")
        m.new_histogram("app_ml_batch_size", "dynamic batcher batch sizes",
                        buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
        m.new_histogram("app_ml_queue_seconds", "request time in batch queue")
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
        m.new_histogram(
            "app_llm_spec_accept",
            "per-stream speculative draft acceptance rate [0, 1]",
            buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0))
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
        # the replica pool (ml/replica.py) and its KV transport
        m.new_counter("app_ml_kv_transport_ships_total",
                      "prefix KV page sets exported off a prefill replica "
                      "by the disaggregated-serving KV transport")
        m.new_counter("app_ml_kv_transport_lands_total",
                      "transported prefix KV page sets landed in a decode "
                      "replica's host tier")
        m.new_counter("app_ml_kv_transport_bytes",
                      "payload bytes moved by the KV transport "
                      "(successful ships)")
        m.new_counter("app_ml_kv_migrations_total",
                      "live-KV-migration attempts during elastic scale "
                      "events, by outcome (adopted / failed / skipped)")
        # sequence-parallel serving (GOFR_ML_SP)
        m.new_counter("app_ml_sp_prefills_total",
                      "prompts prefilled sequence-parallel across the "
                      "generator's sp mesh (GOFR_ML_SP)")
        m.new_counter("app_ml_sp_fallbacks_total",
                      "sequence-parallel prefills that fell back to the "
                      "single-device full prefill (bit-identical output)")
        m.new_gauge("app_ml_sp_shards",
                    "shard count of the generator's sequence-parallel "
                    "serving plan (the sp mesh axis size)")
        m.new_gauge("app_llm_fleet_size",
                    "live (non-retired) replicas in an elastic pool")
        m.new_gauge("app_llm_replica_state",
                    "per-replica serving state ordinal (0 serving, "
                    "1 degraded, 2 recovering, 3 dead) — alert on >= 2")
        m.new_gauge("app_llm_replica_outstanding",
                    "requests in flight toward a replica from the fleet "
                    "router (slots + staged margin)")
        m.new_counter("app_llm_replica_routed_total",
                      "requests routed to a replica, by routing reason "
                      "(affinity / least_loaded / failover)")
        m.new_counter("app_llm_replica_failovers_total",
                      "requests re-admitted to a surviving replica after "
                      "their first replica crashed or died")
        # the federated front (ml/federation.py)
        m.new_gauge("app_llm_fed_peer_state",
                    "per-peer membership state ordinal (0 up, 1 suspect, "
                    "2 dead, 3 left, 4 unknown)")
        m.new_counter("app_llm_fed_remote_routed_total",
                      "requests routed to a federated peer by its "
                      "gossiped prefix digests")
        m.new_counter("app_llm_fed_remote_failovers_total",
                      "remote attempts that failed before a token and "
                      "were served locally")
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
            "device_wait / emit / route / ship / land / other)",
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

    def metrics(self) -> Manager:
        return self.metrics_manager

    def add_datasource(self, name: str, ds: Any) -> None:
        """Inject ``ds`` through the ``Provider`` contract; it lands on
        its attribute when ``name`` is one of ``DATASOURCES`` still
        unset, else among the extra datasources."""
        if hasattr(ds, "use_logger"):
            ds.use_logger(self.logger)
        if hasattr(ds, "use_metrics"):
            ds.use_metrics(self.metrics_manager)
        if hasattr(ds, "use_tracer"):
            ds.use_tracer(self.tracer)
        if hasattr(ds, "connect"):
            ds.connect()
        if name in DATASOURCES and getattr(self, name) is None:
            setattr(self, name, ds)
        else:
            self._extra_datasources[name] = ds

    def get_datasource(self, name: str) -> Any:
        if name in DATASOURCES and getattr(self, name) is not None:
            return getattr(self, name)
        return self._extra_datasources.get(name)

    def get_http_service(self, name: str) -> Any:
        return self.services.get(name)

    def _datasource_items(self) -> list[tuple[str, Any]]:
        items = [(n, getattr(self, n)) for n in DATASOURCES
                 if getattr(self, n) is not None]
        return items + list(self._extra_datasources.items())

    async def health(self) -> dict:
        """Aggregate readiness: each datasource's and each service's
        ``health_check()``; overall DEGRADED when any is not UP."""
        out: dict = {}
        overall = STATUS_UP
        checks = self._datasource_items()
        checks += [(f"{n}-service", svc) for n, svc in self.services.items()]
        for name, target in checks:
            checker = getattr(target, "health_check", None)
            if checker is None:
                continue
            try:
                result = await _call(checker)
            except Exception as exc:  # a failing check reports DOWN
                result = {"status": STATUS_DOWN, "error": str(exc)}
            if not isinstance(result, dict):
                result = {"status": STATUS_UP, "details": result}
            if result.get("status") != STATUS_UP:
                overall = STATUS_DEGRADED
            out[name] = result
        out["status"] = overall
        out["name"] = self.app_name
        out["version"] = self.app_version
        return out

    async def close(self) -> None:
        """Close every datasource, then every service client."""
        for _, ds in self._datasource_items():
            closer = getattr(ds, "close", None)
            if closer is None:
                continue
            try:
                await _call(closer)
            except Exception as exc:  # one failing close must not stop
                self.logger.warnf("error closing datasource: %s", exc)
        for svc in self.services.values():
            closer = getattr(svc, "close", None)
            if closer is None:
                continue
            try:
                await _call(closer)
            except Exception as exc:
                self.logger.warnf("error closing service client: %s", exc)


def new_container(config: Config, logger: Logger | None = None) -> Container:
    """A container with the framework's metrics, and SQL when
    ``DB_DIALECT`` is set."""
    c = Container(config, logger=logger)
    c.register_framework_metrics()
    if config.get("DB_DIALECT"):
        from .datasource.sql import new_sql

        c.sql = new_sql(config, c.logger, c.metrics_manager)
    return c
