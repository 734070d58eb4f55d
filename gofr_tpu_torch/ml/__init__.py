"""Serving layer of the port: the ``Generator`` over a dense or paged KV
cache (generate.py), its host-side scheduling policy (scheduler.py), the
shared-prefix cache policy (prefix_cache.py), the ``LLMServer`` that owns
the generator on a serving thread (llm.py), the typed errors clients see
(errors.py), and ``MLDatasource``, the ``ctx.ml`` datasource the front
mounts LLMs in — counterpart of ``gofr_tpu/ml/__init__.py``, cut to one
server per model. ``serving_snapshot`` and ``programs_snapshot`` are the
bodies of ``/debug/serving`` and ``/debug/programs``; the sampler exports
queue depths, live slots, process RSS, event-log drops, the goodput
ledger (``app_llm_tokens_wasted_total``, ``app_llm_goodput_fraction``) and
the program inventory (``app_ml_programs``,
``app_ml_compile_seconds_total``).

Not ported, and raising ``NotImplementedError`` naming their ROADMAP
item when asked for: replica pools and the fleet (``replicas`` > 1,
``GOFR_ML_REPLICAS`` > 1, ``GOFR_ML_ELASTIC``, ``GOFR_ML_CANARY``,
``GOFR_ML_FEDERATION``, ``disagg``: A.14) and tuned profiles
(``profile=``, ``GOFR_ML_PROFILE``: A.16).
"""

from __future__ import annotations

import asyncio
import os
from typing import Any

__all__ = ["MLDatasource"]


def _host_rss_bytes() -> float | None:
    """The process's resident set size now (``/proc``), else its peak."""
    try:
        with open("/proc/self/statm", "rb") as f:
            return float(int(f.read().split()[1])) * os.sysconf("SC_PAGE_SIZE")
    except Exception:
        try:
            import resource

            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024.0
        except Exception:
            return None

# server-level policy, not Generator knobs (the JAX split)
_SERVER_KWARGS = ("prefix_cache", "max_restarts", "restart_window_s",
                  "default_deadline_s", "max_queue", "max_queued_tokens",
                  "fault")
# replica-pool knobs: meaningless on one server
_POOL_KWARGS = ("depth_per_replica", "affinity_min_tokens", "disagg",
                "spawn", "elastic", "replicas_min", "replicas_max", "canary")


def _not_ported(name: str, what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"llm {name}: {what} is not ported yet "
                               f"(ROADMAP {item})")


def _switch_from_env(knob: str) -> bool:
    """A 0/1 fleet switch read as JAX reads it (malformed raises)."""
    raw = os.environ.get(knob, "").strip()
    if not raw or raw == "0":
        return False
    if raw == "1":
        return True
    raise ValueError(f"{knob} must be 0 or 1, got {raw!r}")


def _replicas_from_env() -> int:
    raw = os.environ.get("GOFR_ML_REPLICAS", "").strip()
    if not raw:
        return 1
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"GOFR_ML_REPLICAS must be an integer, got {raw!r}") from None
    if n < 1:
        raise ValueError(f"GOFR_ML_REPLICAS must be >= 1, got {n}")
    return n


class MLDatasource:
    """Registry of named LLM servers, exposed to handlers as ``ctx.ml``."""

    def __init__(self, logger=None, metrics=None, tracer=None) -> None:
        self._logger = logger
        self._metrics = metrics
        self._tracer = tracer
        self._llms: dict[str, Any] = {}
        # watermarks: lifetime totals publish as counter deltas
        self._events_dropped_seen = 0
        self._goodput_seen: dict[tuple[str, str], int] = {}
        self._compile_seen: dict[str, float] = {}
        if metrics is not None:
            metrics.register_sampler(self.sample_runtime_gauges)

    def register_llm(self, name: str, params: Any, cfg: Any, *,
                     generator: Any = None, replicas: int | None = None,
                     profile: Any = None, federation: Any = None,
                     device=None, **gen_kwargs):
        """Mount a continuous-batching LLM: ``llm(name)`` gives the async
        generate / stream API (``LLMServer``). Pass a ready ``Generator``
        or ``params`` and ``cfg`` (with ``device``, default the first
        card) to build one; a built one is warmed up here unless
        ``warmup=False``, so the kernels are built and the decode graphs
        captured before the first request. ``prefix_cache``,
        ``max_restarts``, ``restart_window_s``, ``default_deadline_s``,
        ``max_queue``, ``max_queued_tokens`` and ``fault`` go to the
        server, everything else to the Generator."""
        if federation is not None or \
                os.environ.get("GOFR_ML_FEDERATION", "").strip():
            raise _not_ported(name, "federation (GOFR_ML_FEDERATION)",
                              "A.14")
        if profile is not None or \
                os.environ.get("GOFR_ML_PROFILE", "").strip():
            raise _not_ported(name, "a tuned profile (GOFR_ML_PROFILE)",
                              "A.16")
        n = _replicas_from_env() if replicas is None else int(replicas)
        if n < 1:
            raise ValueError(
                f"llm {name}: replicas must be >= 1, got {replicas}")
        if n > 1:
            raise _not_ported(name, f"a replica pool (replicas={n})", "A.14")
        server_kwargs = {k: gen_kwargs.pop(k) for k in _SERVER_KWARGS
                         if k in gen_kwargs}
        pool_kwargs = {k: gen_kwargs.pop(k) for k in _POOL_KWARGS
                       if k in gen_kwargs}
        asked = [k for k, v in pool_kwargs.items() if v]
        if pool_kwargs.get("disagg") is None and \
                _switch_from_env("GOFR_ML_DISAGG"):
            asked.append("GOFR_ML_DISAGG")
        if pool_kwargs.get("elastic") is None and \
                _switch_from_env("GOFR_ML_ELASTIC"):
            asked.append("GOFR_ML_ELASTIC")
        if pool_kwargs.get("canary") is None and \
                os.environ.get("GOFR_ML_CANARY", "").strip():
            asked.append("GOFR_ML_CANARY")
        if asked:
            raise _not_ported(name, f"the replica pool's {', '.join(asked)}",
                              "A.14")
        warm = gen_kwargs.pop("warmup", True)
        if generator is None:
            from .generate import Generator

            generator = Generator(params, cfg, device=device, **gen_kwargs)
            if warm:
                generator.warmup()  # startup pays every build and capture
        from .llm import LLMServer

        server = LLMServer(generator, name=name, logger=self._logger,
                           metrics=self._metrics, tracer=self._tracer,
                           **server_kwargs)
        if self._logger is not None:
            self._logger.infof("llm %s registered (1 replica(s), %d slots)",
                               name, generator.batch_slots)
        self._llms[name] = server
        return server

    def llm(self, name: str):
        if name not in self._llms:
            raise KeyError(f"llm {name!r} is not registered; available: "
                           f"{sorted(self._llms)}")
        return self._llms[name]

    def sample_runtime_gauges(self) -> None:
        """One sampler pass: each LLM's queue depth and live slots, the
        process RSS, event-log drops, the goodput ledger and the program
        inventory."""
        from ..flight_recorder import event_log

        m = self._metrics
        rss = _host_rss_bytes()
        if rss is not None:
            m.set_gauge("app_ml_host_rss_bytes", rss)
        dropped = event_log().dropped
        if dropped > self._events_dropped_seen:
            m.add_counter("app_ml_events_dropped_total",
                          dropped - self._events_dropped_seen)
            self._events_dropped_seen = dropped
        for name, server in self._llms.items():
            m.set_gauge("app_ml_queue_depth", server.queue_depth(),
                        component="llm", model=name)
            m.set_gauge("app_llm_active_slots", float(server.gen.n_live),
                        model=name)
        self._export_goodput(m)
        self._export_program_telemetry(m)

    def _export_goodput(self, m) -> None:
        """Wasted-token counter deltas per (model, reason) and the live
        goodput fraction."""
        from .goodput import goodput_ledger

        ledger = goodput_ledger()
        if ledger is None:
            return
        for (model, reason), total in ledger.wasted_totals().items():
            seen = self._goodput_seen.get((model, reason), 0)
            if total > seen:
                m.add_counter("app_llm_tokens_wasted_total", total - seen,
                              model=model, reason=reason)
                self._goodput_seen[(model, reason)] = total
        for model in ledger.models():
            frac = ledger.snapshot_model(model)["goodput"]
            if frac is not None:
                m.set_gauge("app_llm_goodput_fraction", frac, model=model)

    def _export_program_telemetry(self, m) -> None:
        """The program-inventory gauge and the capture-seconds counter
        delta."""
        for name, server in self._llms.items():
            totals = server.gen.programs.totals()
            m.set_gauge("app_ml_programs", float(totals["programs"]),
                        model=name)
            seen = self._compile_seen.get(name, 0.0)
            if totals["compile_s"] > seen:
                m.add_counter("app_ml_compile_seconds_total",
                              totals["compile_s"] - seen, model=name)
                self._compile_seen[name] = totals["compile_s"]

    def hbm_snapshot(self) -> dict:
        """Device memory for ``/debug/serving`` and ``/debug/programs``:
        one row per card (bytes allocated and the card's total), and on
        the CPU ``"unsupported"`` with the process RSS as the fallback, as
        JAX answers for a backend without memory stats."""
        import torch

        devices: dict[str, Any] = {}
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                devices[f"cuda:{i}"] = {
                    "bytes_in_use": int(torch.cuda.memory_allocated(i)),
                    "bytes_limit": int(
                        torch.cuda.get_device_properties(i).total_memory)}
            return {"devices": devices}
        return {"devices": {"cpu:0": "unsupported"}, "fallback": "host_rss",
                "host_rss_bytes": _host_rss_bytes()}

    def programs_snapshot(self, cost: bool = True) -> dict:
        """The ``/debug/programs`` body: each model's programs (decode
        graphs and prefill buckets) with their totals, and the device
        memory."""
        out: dict[str, Any] = {"models": {}, "hbm": self.hbm_snapshot()}
        for name, server in self._llms.items():
            log = server.gen.programs
            out["models"][name] = {"totals": log.totals(),
                                   "entries": log.snapshot(cost=cost)}
        return out

    def serving_snapshot(self) -> dict:
        """The live serving state of ``/debug/serving``: per LLM the
        health details, pool, host tier, prefix cache, fused-window and
        pipeline blocks, scheduler, resilience, the flight recorder's
        stalls, the auto-profiler and the goodput ledger — the blocks of
        the JAX datasource's snapshot that a single server has."""
        from .goodput import goodput_ledger

        ledger = goodput_ledger()
        snap: dict[str, Any] = {"models": {}, "llms": {},
                                "hbm": self.hbm_snapshot()}
        for name, server in self._llms.items():
            gen = server.gen
            entry = dict(server.health_check()["details"])
            entry["pool"] = gen.pool_stats()
            host = getattr(gen, "host_kv", None)
            if host is not None:
                tier = host.stats()
                tier.update(spills=gen.kv_spills, restores=gen.kv_restores,
                            restore_fallbacks=gen.kv_restore_fallbacks)
                entry["kv_host_tier"] = tier
            if server.prefix_cache is not None:
                entry["prefix_cache"] = server.prefix_cache.snapshot()
            win = gen.window_stats()
            if win is not None:
                entry["decode_window"] = win
            pipe = gen.pipeline_stats()
            if pipe is not None:
                entry["pipeline"] = pipe
            entry["scheduler"] = server.scheduler_snapshot()
            entry["resilience"] = server.resilience_snapshot()
            if server.recorder is not None:
                entry["stalls"] = server.recorder.snapshot()
            if server.autoprof is not None:
                entry["autoprof"] = server.autoprof.snapshot()
            if ledger is not None:
                entry["goodput"] = ledger.snapshot_model(name)
            snap["llms"][name] = entry
        return snap

    def health_check(self) -> dict:
        """UP while every LLM serves; DEGRADED while one recovers or has a
        restart in its window; DOWN when one is dead or closed (the health
        route then answers 503)."""
        import torch

        devices = ([str(torch.device("cuda", i))
                    for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else ["cpu"])
        details: dict[str, Any] = {"devices": devices, "models": {}}
        status = "UP"
        if self._llms:
            details["llms"] = {}
            for name, server in self._llms.items():
                h = server.health_check()
                details["llms"][name] = h["details"]
                if h["status"] == "DOWN":
                    status = "DOWN"
                elif h["status"] != "UP" and status == "UP":
                    status = "DEGRADED"
        return {"status": status, "details": details}

    def close(self):
        """Close every LLM server. With an event loop running (the app's
        shutdown) the teardown runs on a worker thread and this returns
        its awaitable: a drain of ``GOFR_ML_DRAIN_S`` must not freeze the
        loop that delivers the very tokens it waits for."""
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            self._close_now()
            return None
        return asyncio.to_thread(self._close_now)

    def _close_now(self) -> None:
        for server in self._llms.values():
            server.close()
