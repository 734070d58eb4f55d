"""Serving debug and profiling endpoints — counterpart of
``gofr_tpu/debug.py``, mounted by the app always, like ``/metrics``:

- ``GET /debug/serving`` — the serving plane's state: per LLM the health
  details, pool, host tier, prefix cache, window and pipeline blocks,
  scheduler, ``resilience``, ``stalls`` (the flight recorder),
  ``autoprof`` and ``goodput``; latency percentiles from the histograms
  ``/metrics`` serves; and ``runtime``, the port's fingerprint
  (``ml/capture.runtime_fingerprint``: torch and CUDA versions, card name
  and count, the armed ``GOFR_ML_*`` knobs).
- ``GET /debug/profile?seconds=N`` — a ``torch.profiler`` capture over N
  seconds (CPU and CUDA activities; every kernel of the process, graph
  replays included) in slices (``flight_recorder.PROFILE_SLICE_S``,
  ``PROFILE_PERIOD_S`` apart), returned as a zip of one Chrome trace a
  slice.
  One capture at a time, process-wide (``flight_recorder.PROFILE_LOCK``):
  a second request answers 409.
- ``GET /debug/events?since=&model=&kind=&rid=&limit=`` — the event log.
- ``GET /debug/requests``, ``GET /debug/requests/<rid>`` — journeys.
- ``GET /debug/goodput`` — the goodput ledger.
- ``GET /debug/programs`` — the program inventory and device memory.
- ``GET /debug/profile/auto``, ``GET /debug/profile/auto/<id>`` — the
  auto-profiler's captures.
- ``GET /debug/crash``, ``GET /debug/crash/<id>`` — crash bundles.
- ``GET /debug/capture?rid=`` — the traffic capture's binary bundle
  (``ml/capture.py``), or one request's; ``{"enabled": false}`` when
  ``GOFR_ML_CAPTURE`` is unset or 0, 404 for an unknown rid.
"""

from __future__ import annotations

import asyncio
import math
import os
import shutil
import tempfile
import time

from aiohttp import web

from .flight_recorder import LAUNCH_GATE
from .flight_recorder import PROFILE_LOCK as _profile_lock

__all__ = ["register_debug_routes", "serving_snapshot"]

_LATENCY_HISTOGRAMS = (
    "app_llm_queue_seconds",
    "app_llm_ttft_seconds",
    "app_llm_tpot_seconds",
)
# queue wait per admission-priority class: label sets (model, priority)
_PRIORITY_HISTOGRAM = "app_llm_priority_queue_seconds"
_QUANTILES = (0.5, 0.95, 0.99)

MAX_PROFILE_SECONDS = 60.0


def _histogram_percentiles(manager, model_names) -> dict:
    """p50/p95/p99 per latency histogram per model, from the bucket edges
    (``Manager.percentile``)."""
    out: dict = {}
    for name in _LATENCY_HISTOGRAMS:
        if not manager.has(name):
            continue
        for model in model_names:
            vals = {f"p{int(q * 100)}": manager.percentile(name, q,
                                                           model=model)
                    for q in _QUANTILES}
            vals = {k: v for k, v in vals.items() if not math.isnan(v)}
            if vals:
                out.setdefault(name, {})[model] = vals
    if manager.has(_PRIORITY_HISTOGRAM) and model_names:
        from .ml.scheduler import PRIORITIES

        for model in model_names:
            for prio in PRIORITIES:
                vals = {f"p{int(q * 100)}": manager.percentile(
                            _PRIORITY_HISTOGRAM, q, model=model,
                            priority=prio)
                        for q in _QUANTILES}
                vals = {k: v for k, v in vals.items() if not math.isnan(v)}
                if vals:
                    out.setdefault(_PRIORITY_HISTOGRAM, {}).setdefault(
                        model, {})[prio] = vals
    return out


def serving_snapshot(container) -> dict:
    """The ``/debug/serving`` body."""
    from .ml.capture import runtime_fingerprint

    snap: dict = {"ts": time.time(), "runtime": runtime_fingerprint()}
    ml = getattr(container, "ml", None)
    if ml is not None:
        snap.update(ml.serving_snapshot())
        names = list(snap["llms"])
    else:
        snap.update({"models": {}, "llms": {}})
        names = []
    manager = container.metrics_manager
    manager.run_samplers()  # queue depths and gauges current, not stale
    snap["percentiles"] = _histogram_percentiles(manager, names)
    return snap


def _run_profile_capture(trace_dir: str, seconds: float) -> None:
    """The blocking capture, off the event loop: the auto-profiler's own
    (one start/sleep/stop for both profiler paths)."""
    from .flight_recorder import _capture_profile_trace

    _capture_profile_trace(trace_dir, seconds)


def _zip_dir(root: str) -> bytes:
    from .flight_recorder import zip_dir_bytes

    data, _truncated = zip_dir_bytes(root)  # a manual capture: uncapped
    return data


def _error(message: str, status: int) -> web.Response:
    return web.json_response({"error": {"message": message}}, status=status)


def register_debug_routes(app, aio_app: web.Application) -> None:
    """Mount the ``/debug/*`` routes on the HTTP server. They answer from
    in-process state and sit behind the app's middleware."""

    async def serving_handler(_: web.Request) -> web.Response:
        return web.json_response({"data": serving_snapshot(app.container)})

    async def profile_handler(request: web.Request) -> web.Response:
        try:
            seconds = float(request.query.get("seconds", "2"))
        except ValueError:
            return _error("seconds must be a number", 400)
        if not 0 < seconds <= MAX_PROFILE_SECONDS:
            return _error(f"seconds must be in (0, {MAX_PROFILE_SECONDS:g}]",
                          400)
        if not _profile_lock.acquire(blocking=False):
            return _error("a profile capture is already running", 409)
        try:
            trace_dir = tempfile.mkdtemp(prefix="gofr-profile-")
            loop = asyncio.get_running_loop()
            capture = loop.run_in_executor(
                None, _run_profile_capture, trace_dir, seconds)
        except BaseException:
            _profile_lock.release()
            raise
        # the lock outlives this handler: a client disconnect cancels the
        # coroutine while the capture thread runs on, and the next capture
        # must see 409 until it stops
        capture.add_done_callback(lambda _: _profile_lock.release())
        try:
            await asyncio.shield(capture)
            body = _zip_dir(trace_dir)
        except asyncio.CancelledError:
            capture.add_done_callback(
                lambda _: shutil.rmtree(trace_dir, ignore_errors=True))
            raise
        except Exception as exc:
            shutil.rmtree(trace_dir, ignore_errors=True)
            app.logger.errorf("profile capture failed: %s", exc)
            return _error(f"profile capture failed: {exc}", 503)
        shutil.rmtree(trace_dir, ignore_errors=True)
        return web.Response(
            body=body, content_type="application/zip",
            headers={"Content-Disposition":
                     'attachment; filename="torch-trace.zip"'})

    async def events_handler(request: web.Request) -> web.Response:
        from .flight_recorder import event_log

        try:
            since = int(request.query.get("since", "0"))
            limit = int(request.query.get("limit", "256"))
        except ValueError:
            return _error("since/limit must be integers", 400)
        if limit < 1:
            return _error("limit must be >= 1", 400)
        # kind= repeats (?kind=a&kind=b) and/or takes a comma list
        kinds = [k for raw in request.query.getall("kind", [])
                 for k in raw.split(",") if k]
        return web.json_response({"data": event_log().query(
            since=since, model=request.query.get("model") or None,
            kind=tuple(kinds) or None,
            rid=request.query.get("rid") or None, limit=limit)})

    async def requests_handler(_: web.Request) -> web.Response:
        from .ml.journey import journey_log

        log = journey_log()
        if log is None:
            return web.json_response(
                {"data": {"enabled": False, "reason": "GOFR_ML_JOURNEY=0"}})
        data = log.snapshot()
        data["enabled"] = True
        return web.json_response({"data": data})

    async def request_handler(request: web.Request) -> web.Response:
        from .ml.journey import journey_log

        log = journey_log()
        rid = request.match_info["rid"]
        journey = log.get(rid) if log is not None else None
        if journey is None:
            return _error(f"unknown request id {rid!r}"
                          + (" (journeys disabled: GOFR_ML_JOURNEY=0)"
                             if log is None else ""), 404)
        return web.json_response({"data": journey.snapshot()})

    async def goodput_handler(_: web.Request) -> web.Response:
        from .ml.goodput import goodput_ledger

        ledger = goodput_ledger()
        if ledger is None:
            return web.json_response(
                {"data": {"enabled": False, "reason": "GOFR_ML_GOODPUT=0"}})
        data = ledger.snapshot()
        data["enabled"] = True
        return web.json_response({"data": data})

    async def programs_handler(request: web.Request) -> web.Response:
        ml = getattr(app.container, "ml", None)
        if ml is None:
            return web.json_response({"data": {"models": {}}})
        cost = request.query.get("cost", "1") != "0"
        return web.json_response({"data": ml.programs_snapshot(cost=cost)})

    async def autoprofile_list_handler(_: web.Request) -> web.Response:
        from .flight_recorder import autoprof_enabled, profile_vault

        return web.json_response({"data": {
            "enabled": autoprof_enabled(),
            "captures": profile_vault().list(),
        }})

    async def autoprofile_handler(request: web.Request) -> web.Response:
        from .flight_recorder import profile_vault

        profile_id = request.match_info["profile_id"]
        bundle = profile_vault().get(profile_id)
        if bundle is None:
            return _error(f"unknown profile id {profile_id!r}", 404)
        return web.Response(
            body=bundle["data"], content_type="application/zip",
            headers={"Content-Disposition":
                     f'attachment; filename="{profile_id}.zip"'})

    async def capture_handler(request: web.Request) -> web.Response:
        from .ml.capture import traffic_capture

        cap = traffic_capture()
        if cap is None:
            return web.json_response(
                {"data": {"enabled": False,
                          "reason": "GOFR_ML_CAPTURE unset or 0"}})
        rid = request.query.get("rid") or None
        if rid is not None and cap.get(rid) is None:
            return _error(f"unknown request id {rid!r}", 404)
        # encoding walks the ring and packs token arrays: off the loop
        loop = asyncio.get_running_loop()
        body = await loop.run_in_executor(None, lambda: cap.encode(rid=rid))
        name = f"capture-{rid}.gfrb" if rid is not None else "capture.gfrb"
        return web.Response(
            body=body, content_type="application/octet-stream",
            headers={"Content-Disposition":
                     f'attachment; filename="{name}"'})

    async def crash_list_handler(_: web.Request) -> web.Response:
        from .flight_recorder import crash_vault

        return web.json_response({"data": {"crashes": crash_vault().list()}})

    async def crash_handler(request: web.Request) -> web.Response:
        from .flight_recorder import crash_vault

        crash_id = request.match_info["crash_id"]
        bundle = crash_vault().get(crash_id)
        if bundle is None:
            return _error(f"unknown crash id {crash_id!r}", 404)
        return web.json_response({"data": bundle})

    aio_app.router.add_get("/debug/serving", serving_handler)
    aio_app.router.add_get("/debug/profile", profile_handler)
    aio_app.router.add_get("/debug/profile/auto", autoprofile_list_handler)
    aio_app.router.add_get("/debug/profile/auto/{profile_id}",
                           autoprofile_handler)
    aio_app.router.add_get("/debug/goodput", goodput_handler)
    aio_app.router.add_get("/debug/capture", capture_handler)
    aio_app.router.add_get("/debug/programs", programs_handler)
    aio_app.router.add_get("/debug/events", events_handler)
    aio_app.router.add_get("/debug/crash", crash_list_handler)
    aio_app.router.add_get("/debug/crash/{crash_id}", crash_handler)
    aio_app.router.add_get("/debug/requests", requests_handler)
    aio_app.router.add_get("/debug/requests/{rid}", request_handler)


def register_profiler_routes(app, aio_app: web.Application) -> None:
    """The ``APP_ENV=DEBUG`` profiler session: ``POST /debug/profile/start``
    and ``/stop`` around a ``torch.profiler`` session (its Chrome trace is
    written into the directory ``stop`` names), ``GET
    /debug/profile/status``. The session holds ``PROFILE_LOCK`` from start
    to stop."""
    state: dict = {"dir": None, "prof": None}

    async def start_profile(request: web.Request) -> web.Response:
        if state["dir"] is not None:
            return _error("profile already running", 409)
        if not _profile_lock.acquire(blocking=False):
            return _error("a profile capture is already running", 409)
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            trace_dir = request.query.get("dir") or tempfile.mkdtemp(
                prefix="gofr-profile-")
            prof = profile(activities=activities)
            with LAUNCH_GATE.exclusive():
                prof.start()
        except BaseException:
            _profile_lock.release()
            raise
        state.update(dir=trace_dir, prof=prof)
        app.logger.infof("profiler trace started -> %s", trace_dir)
        return web.json_response({"data": {"status": "started",
                                           "dir": trace_dir}})

    async def stop_profile(_: web.Request) -> web.Response:
        if state["dir"] is None:
            return _error("no profile running", 409)
        trace_dir, prof = state["dir"], state["prof"]
        state.update(dir=None, prof=None)
        try:
            with LAUNCH_GATE.exclusive():
                prof.stop()
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        finally:
            _profile_lock.release()
        app.logger.infof("profiler trace stopped (%s)", trace_dir)
        return web.json_response({"data": {"status": "stopped",
                                           "dir": trace_dir}})

    async def profile_status(_: web.Request) -> web.Response:
        return web.json_response({"data": {
            "running": state["dir"] is not None, "dir": state["dir"]}})

    aio_app.router.add_post("/debug/profile/start", start_profile)
    aio_app.router.add_post("/debug/profile/stop", stop_profile)
    aio_app.router.add_get("/debug/profile/status", profile_status)
