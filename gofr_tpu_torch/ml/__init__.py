"""Serving layer of the port: the ``Generator`` over a dense or paged KV
cache (generate.py), its host-side scheduling policy (scheduler.py), the
shared-prefix cache policy (prefix_cache.py), the ``LLMServer`` that owns
the generator on a serving thread (llm.py), the model ``Engine``
(engine.py) and its ``DynamicBatcher`` (batching.py), the typed errors
clients see (errors.py), and ``MLDatasource``, the ``ctx.ml`` datasource
the front mounts models (``register``, ``predict``) and LLMs
(``register_llm``, ``llm``) in — counterpart of ``gofr_tpu/ml/__init__.py``,
cut to one server per LLM. ``serving_snapshot`` and ``programs_snapshot``
are the bodies of ``/debug/serving`` and ``/debug/programs``; the sampler
exports the device memory (``app_tpu_hbm_bytes_in_use`` / ``_limit``, the
process RSS on the CPU), queue depths, live slots, event-log drops, the
goodput ledger (``app_llm_tokens_wasted_total``,
``app_llm_goodput_fraction``) and the program inventory
(``app_ml_programs``, ``app_ml_compile_seconds_total``).

``register_llm(profile=)`` / ``GOFR_ML_PROFILE`` applies a tuned profile
(``ml/tune.py``) around the server's construction.

``register_llm(replicas=)`` / ``GOFR_ML_REPLICAS`` > 1, a list of ready
generators, ``elastic`` / ``GOFR_ML_ELASTIC=1`` or ``canary`` /
``GOFR_ML_CANARY`` mount a ``ReplicaPool`` (``ml/replica.py``) instead of
one server; ``disagg`` / ``GOFR_ML_DISAGG=1`` splits it into prefill and
decode replicas over the KV transport (``ml/kv_transport.py``).
``/debug/serving`` then shows the pool's ``routing`` block and one
``replicas.{i}`` row per core, and the sampler exports
``app_llm_fleet_size`` and the per-replica gauges.

``register_llm(federation=)`` / ``GOFR_ML_FEDERATION`` wraps the built
server in a ``FederatedPool`` (``ml/federation.py``): gossip membership,
cross-host digest routing and host-level failover over the multihost
wire; ``/debug/serving`` then carries a ``federation`` block.

``GOFR_ML_SP`` / ``GOFR_ML_SP_MIN_TOKENS`` / ``GOFR_ML_SP_SHARDS`` (in the
environment, or the first and last in a tuned profile's knob map) reach
the ``Generator``, which plans sequence-parallel serving from them
(``ml/sp_serving.py``) over its mesh: a replica's devices
(``ml/replica.py``), or the ``mesh`` of a ready generator passed as
``generator=`` (on one card, the card named once a shard).
"""

from __future__ import annotations

import asyncio
import os
import sys
from typing import Any

from .engine import Engine, EngineConfig

__all__ = ["MLDatasource", "Engine", "EngineConfig"]


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



def _tuned_profile(name: str, prof: Any) -> dict:
    """A profile path or dict, validated as JAX validates it."""
    from .tune import TUNABLE_KNOBS, load_profile

    if isinstance(prof, str):
        prof = load_profile(prof)
    elif isinstance(prof, dict):
        prof = dict(prof)
        knobs = prof.get("knobs")
        if not isinstance(knobs, dict):
            raise ValueError(f"llm {name}: profile= dict has no 'knobs' map")
        bad = set(knobs) - TUNABLE_KNOBS
        if bad:
            raise ValueError(
                f"llm {name}: profile sets non-tunable knob(s) "
                f"{sorted(bad)}")
        prof["knobs"] = {k: str(v) for k, v in knobs.items()}
    else:
        raise TypeError(
            f"llm {name}: profile= must be a path or a loaded profile "
            f"dict, got {type(prof).__name__}")
    return prof


def _card_memory() -> dict:
    """{"cuda:i": {"bytes_in_use", "bytes_limit"}} of every card: the
    caching allocator's live bytes (``memory_stats``) and the card's total
    (``mem_get_info``'s total, read from the properties so no idle card
    gets a context). Empty without a card."""
    import torch

    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {
        "bytes_in_use": int(torch.cuda.memory_stats(i).get(
            "allocated_bytes.all.current", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory)}
        for i in range(torch.cuda.device_count())}


class MLDatasource:
    """Registry of named model engines and LLM servers, exposed to handlers
    as ``ctx.ml``."""

    def __init__(self, logger=None, metrics=None, tracer=None) -> None:
        self._logger = logger
        self._metrics = metrics
        self._tracer = tracer
        self._engines: dict[str, Engine] = {}
        self._batchers: dict[str, Any] = {}
        self._llms: dict[str, Any] = {}
        # watermarks: lifetime totals publish as counter deltas
        self._events_dropped_seen = 0
        self._goodput_seen: dict[tuple[str, str], int] = {}
        self._compile_seen: dict[str, float] = {}
        if metrics is not None:
            metrics.register_sampler(self.sample_runtime_gauges)

    def register(self, name: str, model: Any = None, *, apply_fn=None,
                 params=None, example_inputs: tuple | None = None,
                 config: EngineConfig | None = None, batching: Any = None,
                 device=None) -> Engine:
        """Mount a model: an object with ``apply`` / ``params`` (the port's
        model classes), an ``apply_fn`` / ``params`` pair, or a ready
        ``Engine``. ``device`` defaults to the model's, else the params',
        else the first card. ``batching=True`` (or a ``DynamicBatcher``)
        puts a batcher in front of ``predict`` and captures every bucket
        now."""
        if isinstance(model, Engine):
            engine = model
        else:
            if model is not None and apply_fn is None:
                apply_fn = getattr(model, "apply", None) or model.__call__
                params = params if params is not None else getattr(
                    model, "params", None)
                if example_inputs is None:
                    example_inputs = getattr(model, "example_inputs", None)
            if apply_fn is None:
                raise ValueError("register needs a model object or apply_fn")
            if device is None:
                device = getattr(model, "device", None)
            engine = Engine(name, apply_fn, params, config=config,
                            logger=self._logger, metrics=self._metrics,
                            tracer=self._tracer,
                            example_inputs=example_inputs, device=device)
        self._engines[name] = engine
        if batching is not None:
            from .batching import DynamicBatcher

            if batching is True:
                batching = DynamicBatcher(engine, metrics=self._metrics,
                                          tracer=self._tracer)
            self._batchers[name] = batching
            engine.warmup_buckets()  # the batcher pads to buckets: all now
        if self._logger is not None:
            self._logger.infof("model %s registered on %s", name,
                               str(engine.device))
        return engine

    def engine(self, name: str) -> Engine:
        if name not in self._engines:
            raise KeyError(f"model {name!r} is not registered; available: "
                           f"{sorted(self._engines)}")
        return self._engines[name]

    def batcher(self, name: str):
        return self._batchers.get(name)

    async def predict(self, name: str, *inputs: Any) -> Any:
        """One prediction: through the model's batcher when one is mounted
        (one example, no batch axis), else straight to the engine."""
        batcher = self._batchers.get(name)
        if batcher is not None:
            return await batcher.submit(*inputs)
        return await self.engine(name).predict(*inputs)

    def predict_sync(self, name: str, *inputs: Any) -> Any:
        return self.engine(name).predict_sync(*inputs)

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
        server, everything else to the Generator.

        ``replicas`` (default ``GOFR_ML_REPLICAS``; 1) > 1 mounts a
        ``ReplicaPool``: N generators, one per card while cards last and
        round-robin past them (on one card they share the weights),
        behind one cache-aware routing and admission front with fleet
        failover (``ml/replica.py``). ``generator`` may be a list of
        ready generators, one per replica. ``depth_per_replica``,
        ``affinity_min_tokens``, ``disagg``, ``spawn``, ``elastic``,
        ``replicas_min``, ``replicas_max`` and ``canary`` go to the pool.
        ``elastic`` / ``GOFR_ML_ELASTIC=1`` and ``canary`` /
        ``GOFR_ML_CANARY`` mount the pool even at one replica; built from
        ``params`` and ``cfg``, the pool gets a default ``spawn`` factory
        that builds and warms a replica on the next device slice.
        ``disagg`` / ``GOFR_ML_DISAGG=1`` needs ``replicas >= 2``.

        ``profile=`` (a path or a loaded dict; default
        ``GOFR_ML_PROFILE``) applies a tuned profile (``ml/tune.py``): its
        knob map overlays the environment for the construction only,
        with loud validation, drift warnings and a ``profile`` block in
        ``/debug/serving``. Unset constructs nothing.

        ``federation=`` (a ``FederationConfig``; default
        ``GOFR_ML_FEDERATION``) wraps the built server in a
        ``FederatedPool`` (``ml/federation.py``). Unset constructs no
        federation machinery: the bare server is returned."""
        # parse the fleet map BEFORE building the server: a typo'd
        # GOFR_ML_FEDERATION fails the boot without leaking a live
        # serving thread it would never mount
        fed_cfg = federation
        if fed_cfg is None and \
                os.environ.get("GOFR_ML_FEDERATION", "").strip():
            from .federation import federation_from_env

            fed_cfg = federation_from_env()
        if fed_cfg is not None:
            from .federation import FederationConfig

            if not isinstance(fed_cfg, FederationConfig):
                raise TypeError(
                    f"llm {name}: federation= must be a FederationConfig, "
                    f"got {type(fed_cfg).__name__}")
        prof = profile
        if prof is None and os.environ.get("GOFR_ML_PROFILE", "").strip():
            prof = os.environ["GOFR_ML_PROFILE"].strip()
        if prof is None:
            server = self._build_llm(name, params, cfg, generator, replicas,
                                     device, gen_kwargs)
        else:
            from .tune import profile_boot_warnings, profile_overlay

            prof = _tuned_profile(name, prof)
            warnings = profile_boot_warnings(prof)
            for line in warnings:
                if self._logger is not None:
                    self._logger.warnf("llm %s: %s", name, line)
                else:
                    print(f"WARNING: llm {name}: {line}", file=sys.stderr)
            with profile_overlay(prof["knobs"]):
                server = self._build_llm(name, params, cfg, generator,
                                         replicas, device, gen_kwargs,
                                         profile_knobs=prof["knobs"])
            # what /debug/serving shows: which knob map steered this boot
            # and what drifted
            server.tuned_profile = {
                "path": prof.get("path"),
                "created_at": prof.get("created_at"),
                "knobs": dict(prof["knobs"]),
                "warnings": warnings,
            }
        if fed_cfg is not None:
            from .federation import FederatedPool

            server = FederatedPool(server, fed_cfg, name=name,
                                   logger=self._logger,
                                   metrics=self._metrics,
                                   tracer=self._tracer)
            if self._logger is not None:
                self._logger.infof(
                    "llm %s federated: host %s listening on %s:%d "
                    "(%d peer(s))", name, fed_cfg.host_id,
                    server.listen_addr[0], server.listen_addr[1],
                    len(fed_cfg.peers))
        self._llms[name] = server
        return server

    def _build_llm(self, name: str, params: Any, cfg: Any, generator: Any,
                   replicas: int | None, device, gen_kwargs: dict,
                   profile_knobs: dict | None = None):
        """The construction half of ``register_llm``: a tuned profile
        overlays the environment around all of it (the replica count, the
        Generator's env defaults, the pool's knobs)."""
        from .. import resolve_device
        from .llm import LLMServer
        from .replica import (ReplicaPool, build_replica_generators,
                              canary_from_env, disagg_from_env,
                              elastic_from_env, replicas_from_env,
                              spawn_devices)

        server_kwargs = {k: gen_kwargs.pop(k) for k in _SERVER_KWARGS
                         if k in gen_kwargs}
        pool_kwargs = {k: gen_kwargs.pop(k) for k in _POOL_KWARGS
                       if k in gen_kwargs}
        if profile_knobs:
            # a scale-up spawns outside this boot's overlay: the pool
            # re-applies the knob map around every spawn
            pool_kwargs["profile_knobs"] = dict(profile_knobs)
        explicit = (replicas is not None
                    or os.environ.get("GOFR_ML_REPLICAS", "").strip() != "")
        n = replicas_from_env(1) if replicas is None else int(replicas)
        if n < 1:
            raise ValueError(
                f"llm {name}: replicas must be >= 1, got {replicas}")
        devices = None if device is None else [device]
        if isinstance(generator, (list, tuple)):
            gens = list(generator)
            if not gens:
                raise ValueError(
                    f"llm {name}: generator= was an empty list; pass one "
                    f"ready generator per replica, or params/cfg")
            if explicit and len(gens) != n:
                raise ValueError(
                    f"llm {name}: {n} replicas requested but {len(gens)} "
                    f"ready generator(s) were passed; the list must have "
                    f"one generator per replica")
        elif generator is not None:
            if n > 1:
                raise ValueError(
                    f"llm {name}: {n} replicas requested but a single "
                    f"ready generator was passed; pass a list of {n} "
                    f"generators (one per replica) or (params, cfg) so "
                    f"replicas can be built")
            gens = [generator]
        else:
            warm = gen_kwargs.pop("warmup", True)
            if "spawn" not in pool_kwargs:
                # an elastic pool built from (params, cfg) can grow at
                # runtime: one warmed replica on the new index's device
                # slice (spares first, round-robin past the card count:
                # JAX's default spawn)
                def _default_spawn(idx, _p=params, _c=cfg, _n0=n,
                                   _devs=devices, _kw=dict(gen_kwargs)):
                    return build_replica_generators(
                        _p, _c, 1, warmup=True,
                        devices=spawn_devices(idx, _devs, _n0), **_kw)[0]

                pool_kwargs["spawn"] = _default_spawn
            # one replica sits on ``device`` (default the first card), as
            # a bare Generator does; more split every card. Startup pays
            # every build and capture (``warm``)
            gens = build_replica_generators(
                params, cfg, n, warmup=warm,
                devices=(devices if devices or n > 1
                         else [resolve_device(None)]),
                **gen_kwargs)
        elastic_req = pool_kwargs.get("elastic")
        if elastic_req is None:
            elastic_req = elastic_from_env()
        # a shadow canary needs the pool front even at fleet size 1
        canary_req = pool_kwargs.get("canary")
        if canary_req is None:
            canary_req = canary_from_env()
            if canary_req is not None:
                pool_kwargs["canary"] = canary_req
        if len(gens) == 1:
            disagg_req = pool_kwargs.get("disagg")
            if disagg_req is None:
                disagg_req = disagg_from_env()
            if disagg_req:
                raise ValueError(
                    f"llm {name}: disaggregated prefill/decode "
                    f"(GOFR_ML_DISAGG/disagg=) requires replicas >= 2")
        if len(gens) > 1 or elastic_req or canary_req:
            server = ReplicaPool(gens, name=name, logger=self._logger,
                                 metrics=self._metrics, tracer=self._tracer,
                                 **pool_kwargs, **server_kwargs)
        else:
            server = LLMServer(gens[0], name=name, logger=self._logger,
                               metrics=self._metrics, tracer=self._tracer,
                               **server_kwargs)
        if self._logger is not None:
            self._logger.infof("llm %s registered (%d replica(s), %d slots)",
                               name, len(gens),
                               sum(g.batch_slots for g in gens))
        return server

    def llm(self, name: str):
        if name not in self._llms:
            raise KeyError(f"llm {name!r} is not registered; available: "
                           f"{sorted(self._llms)}")
        return self._llms[name]

    def refresh_device_metrics(self, metrics) -> None:
        """The HBM gauges per card; on the CPU, which reports no device
        memory, the process RSS instead, as JAX publishes it."""
        cards = _card_memory()
        for label, row in cards.items():
            metrics.set_gauge("app_tpu_hbm_bytes_in_use", row["bytes_in_use"],
                              device=label)
            metrics.set_gauge("app_tpu_hbm_bytes_limit", row["bytes_limit"],
                              device=label)
        if not cards:
            rss = _host_rss_bytes()
            if rss is not None:
                try:
                    metrics.set_gauge("app_ml_host_rss_bytes", rss)
                except Exception:
                    pass  # a bare manager without the series

    def sample_runtime_gauges(self) -> None:
        """One sampler pass: device memory, each engine's, batcher's and
        LLM's queue depth, live slots, the process RSS, event-log drops, the
        goodput ledger and the program inventory."""
        from ..flight_recorder import event_log

        m = self._metrics
        self.refresh_device_metrics(m)
        rss = _host_rss_bytes()
        if rss is not None:
            m.set_gauge("app_ml_host_rss_bytes", rss)
        for name, engine in self._engines.items():
            m.set_gauge("app_ml_queue_depth", engine.queue_depth(),
                        component="engine", model=name)
        for name, batcher in self._batchers.items():
            depth = getattr(batcher, "queue_depth", None)
            if depth is not None:
                m.set_gauge("app_ml_queue_depth", depth(),
                            component="batcher", model=name)
        dropped = event_log().dropped
        if dropped > self._events_dropped_seen:
            m.add_counter("app_ml_events_dropped_total",
                          dropped - self._events_dropped_seen)
            self._events_dropped_seen = dropped
        for name, server in self._llms.items():
            m.set_gauge("app_ml_queue_depth", server.queue_depth(),
                        component="llm", model=name)
            if hasattr(server, "export_gauges"):
                # a replica pool: per-replica state and occupancy, the
                # fleet's live slots and app_llm_fleet_size; a federated
                # front adds each peer's state
                server.export_gauges(m)
                if hasattr(server, "replicas"):
                    continue
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

    def _program_logs(self):
        """Every (model, ProgramLog) pair: engines, then LLM generators, a
        pool's cores under ``pool/idx``."""
        for name, engine in self._engines.items():
            yield name, engine.programs
        for name, server in self._llms.items():
            if hasattr(server, "replicas"):
                for i, core in enumerate(server.replicas):
                    yield f"{name}/{i}", core.gen.programs
            else:
                yield name, server.gen.programs

    def _export_program_telemetry(self, m) -> None:
        """The program-inventory gauge and the capture-seconds counter
        delta."""
        for name, log in self._program_logs():
            totals = log.totals()
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
        cards = _card_memory()
        if cards:
            return {"devices": cards}
        return {"devices": {"cpu:0": "unsupported"}, "fallback": "host_rss",
                "host_rss_bytes": _host_rss_bytes()}

    def programs_snapshot(self, cost: bool = True) -> dict:
        """The ``/debug/programs`` body: each model's programs (engine
        graphs by batch, or a native engine's ``pjrt/…`` packages with its
        ``pjrt`` stats; decode graphs and prefill buckets) with their
        totals, and the device memory."""
        out: dict[str, Any] = {"models": {}, "hbm": self.hbm_snapshot()}
        for name, log in self._program_logs():
            row = {"totals": log.totals(), "entries": log.snapshot(cost=cost)}
            engine = self._engines.get(name)
            pjrt = getattr(engine, "_pjrt", None)
            if pjrt is not None and engine.programs is log:
                row["pjrt"] = dict(pjrt.stats)  # the native executor's
            out["models"][name] = row
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
        for name, engine in self._engines.items():
            entry = {"steps": engine.steps, "device": str(engine.device),
                     "backend": engine.backend,
                     "batch_buckets": list(engine.config.batch_buckets),
                     "compiled_buckets": sorted(engine.compiled_buckets),
                     "queue_depth": engine.queue_depth()}
            batcher = self._batchers.get(name)
            if batcher is not None:
                entry["batcher"] = {"queue_depth": batcher.queue_depth(),
                                    "max_batch": batcher._max_batch,
                                    "max_delay_s": batcher._max_delay}
            snap["models"][name] = entry
        def llm_entry(server, model: str) -> dict:
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
            sp = gen.sp_stats()
            if sp is not None:
                # sequence-parallel serving (GOFR_ML_SP): mode, shards, the
                # dual-path threshold, striping and the prefill tally
                entry["sp"] = sp
            spec = gen.spec_stats()
            if spec is not None:
                # speculative serving: K, the draft mode, lifetime windows
                # and acceptance, the adaptive disable and re-probe state
                entry["speculation"] = spec
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
                entry["goodput"] = ledger.snapshot_model(model)
            if getattr(server, "tuned_profile", None) is not None:
                entry["profile"] = server.tuned_profile
            return entry

        for name, server in self._llms.items():
            # a federated front wraps the host-local server: the local
            # shape as usual, then the per-host fleet view, and the
            # federated health owns the top-level state
            fed = None
            inner = server
            if hasattr(server, "federation_snapshot"):
                fed = server.federation_snapshot()
                inner = server.local
            if hasattr(inner, "replicas"):
                # a replica pool: fleet health and the routing state once,
                # then one full row per core keyed by its index
                entry = dict(inner.health_check()["details"])
                entry["routing"] = server.routing_snapshot()
                entry["replicas"] = {
                    str(i): llm_entry(core, core.name)
                    for i, core in enumerate(inner.replicas)}
                if ledger is not None:
                    # the pool name aggregates its fleet-level waste
                    # (failover, migration) and every core's ledger
                    entry["goodput"] = ledger.snapshot_model(name)
                if getattr(inner, "tuned_profile", None) is not None:
                    entry["profile"] = inner.tuned_profile
            else:
                entry = llm_entry(inner, name)
            if fed is not None:
                entry["state"] = server.health()
                entry["federation"] = fed
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
        details: dict[str, Any] = {"devices": devices, "models": {
            name: {"steps": engine.steps, "device": str(engine.device)}
            for name, engine in self._engines.items()}}
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
        """Close every engine, batcher and LLM server. With an event loop running (the app's
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
        for engine in self._engines.values():
            engine.close()
        for batcher in self._batchers.values():
            closer = getattr(batcher, "close", None)
            if closer is not None:
                closer()
        for server in self._llms.values():
            server.close()
