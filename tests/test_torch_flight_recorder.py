"""PyTorch port, the serving flight recorder (``flight_recorder.py``): the
event log, the dispatch recorder, crash forensics and the ``/debug/*``
routes, held against the JAX package's (CPU, the tiny model at f32, the
JAX weights carried across with ``params_from_jax``).

Twins of ``tests/test_flight_recorder.py``: the event log's cursor,
filters and ring bound and the dispatch recorder's record math give the
JAX module's results on the same calls; a served request leaves records
whose phases sum to their wall; ``GOFR_ML_FLIGHT_RECORDER=0`` turns it
off; admit, shed and deadline decisions reach the event log and stamp the
spans; a forced crash leaves a ``/debug/crash/<id>`` bundle with its
trigger, the admission before it and the slot table; the vault is
bounded. Then the parity of the ``/debug/*`` bodies: the same JSON keys
(and values where deterministic) from the JAX example app and the port's
app after the same requests and the same scripted crash.
"""

import asyncio
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from gofr_tpu import flight_recorder as jfr
from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.ml.llm import LLMServer as JLLMServer
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch import flight_recorder as tfr
from gofr_tpu_torch.app import App
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.container import Container
from gofr_tpu_torch.ml.errors import (DeadlineExceeded, GeneratorCrashed,
                                      Overloaded)
from gofr_tpu_torch.ml.generate import Generator
from gofr_tpu_torch.ml.llm import LLMServer
from gofr_tpu_torch.models import llama as tllama
from gofr_tpu_torch.tracing import Tracer

pytestmark = pytest.mark.timeout(300)


@pytest.fixture(scope="module")
def pair():
    jcfg = jllama.tiny_llama(dtype=jnp.float32, use_flash=False)
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for name in ("GOFR_ML_FAULT", "GOFR_ML_MAX_RESTARTS",
                 "GOFR_ML_FLIGHT_RECORDER", "GOFR_ML_AUTOPROF",
                 "GOFR_ML_JOURNEY", "GOFR_ML_GOODPUT",
                 "GOFR_ML_DECODE_WINDOW", "GOFR_ML_PIPELINE",
                 "GOFR_ML_TOKEN_BUDGET", "GOFR_ML_KV_HOST_BUDGET_MB"):
        monkeypatch.delenv(name, raising=False)


def _gen(pair, **kw):
    _, _, tcfg, tparams = pair
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("prefill_buckets", (8,))
    return Generator(tparams, tcfg, device="cpu", **kw)


def _jgen(pair, **kw):
    jcfg, jparams, _, _ = pair
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("prefill_buckets", (8,))
    return JGenerator(jparams, jcfg, **kw)


def _manager():
    c = Container(MapConfig({"APP_NAME": "fr-test"}))
    c.register_framework_metrics()
    return c.metrics_manager


def _fail_after(point: str, ok: int):
    left = {"n": ok}

    def hook(p):
        if p == point:
            if left["n"] > 0:
                left["n"] -= 1
            else:
                raise RuntimeError(f"injected at {p}")

    return hook


def _sleep_hook(point: str, seconds: float):
    def hook(p):
        if p == point:
            time.sleep(seconds)

    return hook


class _RecordingTracer(Tracer):
    """A port Tracer that keeps its finished spans."""

    def __init__(self) -> None:
        super().__init__("test", None, 1.0)
        self.finished: list = []

    def _on_end(self, span) -> None:
        self.finished.append(span)

    def by_name(self, name: str) -> list:
        return [s for s in self.finished if s.name == name]


def _strip(obj):
    """Wall-clock values out: what two runs of the same calls share."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k not in ("ts", "at", "wall_s", "s", "share")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


# -- the event log ---------------------------------------------------------------

def _event_log_script(mod) -> list:
    log = mod.EventLog(capacity=16)
    out = [log.cursor]
    out.append(log.emit("admit", model="m", slot=0)["seq"])
    log.emit("shed", model="m")
    log.emit("route", model="other")
    log.emit("crash", model="m/0")
    out += [log.query(), log.query(model="m"),
            log.query(model="m", kind="crash"),
            log.query(model="m", kind=("crash", "shed")),
            log.query(since=4), log.query(limit=2), log.query(since=2)]
    for i in range(40):
        log.emit("route", model="m", i=i, rid=f"r{i % 3}")
    out += [log.query(), log.query(rid="r1", limit=5), log.tail(3),
            log.dropped]
    return _strip(out)


def test_event_log_matches_jax():
    assert _event_log_script(tfr) == _event_log_script(jfr)


def test_event_log_cursor_filters_and_ring_bound():
    log = tfr.EventLog(capacity=16)
    assert log.cursor == 0
    first = log.emit("admit", model="m", slot=0)
    assert first["seq"] == 1
    log.emit("shed", model="m")
    log.emit("route", model="other")
    log.emit("crash", model="m/0")
    out = log.query()
    assert [e["kind"] for e in out["events"]] == ["admit", "shed", "route",
                                                 "crash"]
    assert out["cursor"] == 4 and not out["truncated"]
    out = log.query(model="m")
    assert [e["kind"] for e in out["events"]] == ["admit", "shed", "crash"]
    assert log.query(model="m", kind="crash")["events"][0]["model"] == "m/0"
    assert log.query(since=out["cursor"])["events"] == []
    page = log.query(limit=2)
    assert [e["seq"] for e in page["events"]] == [1, 2]
    assert page["truncated"] and page["cursor"] == 2
    rest = log.query(since=page["cursor"])
    assert [e["seq"] for e in rest["events"]] == [3, 4]
    for i in range(40):
        log.emit("route", model="m", i=i)
    out = log.query()
    assert len(out["events"]) == 16
    assert out["cursor"] == 44
    assert out["events"][0]["seq"] == 44 - 16 + 1
    assert out["dropped"] == 44 - 16


def test_event_ring_knob_matches_jax(monkeypatch):
    for raw, want in (("64", 64), ("", 2048), ("x", 2048), ("3", 16)):
        monkeypatch.setenv("GOFR_ML_EVENT_RING", raw)
        assert tfr.EventLog()._buf.maxlen == jfr.EventLog()._buf.maxlen \
            == want


# -- the dispatch recorder ---------------------------------------------------------

def _recorder_script(mod) -> list:
    rec = mod.DispatchRecorder(model="unit", ring=4)
    rec.reset()
    rec.note("assemble", 0.004)
    rec.note("device_wait", 0.050)
    rec.note("emit", 0.001)
    rec.note_rid("r1")
    rec.note_rid("r1")
    rec.note_window(4, 3)
    rec.note_window(4, 4)
    rec.note_overlap(2)
    rec.commit()
    snap = rec.snapshot()
    out = [snap["dispatches"], snap["top_stall"], snap["decode_window"],
           snap["overlapped_dispatches"], sorted(snap["window"]["phases"]),
           [{k: v for k, v in r.items() if k not in ("wall_s", "phases")}
            for r in rec.tail(4)]]
    rec.note("queue_pop", 1.0)
    rec.reset()
    for _ in range(4):
        rec.note("launch", 0.001)
        rec.commit()
    snap = rec.snapshot()
    out += [snap["dispatches"], snap["window"]["records"],
            sorted(snap), rec.pending, rec.pending_device_work]
    return out


def test_dispatch_recorder_matches_jax():
    assert _recorder_script(tfr) == _recorder_script(jfr)


def test_dispatch_recorder_record_math_and_top_stall():
    rec = tfr.DispatchRecorder(model="unit", ring=4)
    rec.reset()
    rec.note("assemble", 0.004)
    rec.note("device_wait", 0.050)  # the device's time, never a stall
    rec.note("emit", 0.001)
    rec.commit()
    snap = rec.snapshot()
    assert snap["dispatches"] == 1
    phases = snap["window"]["phases"]
    assert {"assemble", "device_wait", "emit", "other"} <= set(phases)
    total = sum(p["s"] for p in phases.values())
    assert total == pytest.approx(0.055, abs=1e-6)
    assert phases["other"]["s"] >= 0.0
    assert snap["top_stall"] == "assemble"
    rec.note("queue_pop", 1.0)
    rec.reset()
    assert rec.snapshot()["dispatches"] == 1
    for _ in range(4):
        rec.note("launch", 0.001)
        rec.commit()
    snap = rec.snapshot()
    assert snap["dispatches"] == 5
    assert snap["window"]["records"] == 4


def test_device_idle_estimate_matches_jax():
    """The same settles credit the same estimated busy seconds as the JAX
    recorder's ``note_settle``: blocking settles on an empty device
    calibrate the per-step EMA, the others are credited from it."""
    def script(mod):
        rec = mod.DispatchRecorder(model="idle", ring=16)
        out = []
        for span, depth0, steps, wait in ((0.010, 0, 4, 0.008),
                                          (0.012, 1, 4, 0.0),
                                          (0.020, 0, 8, 0.015),
                                          (0.011, 2, 4, 0.0),
                                          (0.003, 1, 1, 0.0)):
            rec.note_settle(span, depth0, steps, wait)
            out.append((round(rec._pending_busy, 12),
                        round(rec._exec_ema or 0.0, 12),
                        rec._pending_settled))
        return out

    assert script(tfr) == script(jfr)


# -- stall attribution, live -------------------------------------------------------

def test_server_phase_breakdown_covers_step_wall(pair, run):
    metrics = _manager()

    async def scenario():
        server = LLMServer(_gen(pair), name="fr-phases", metrics=metrics)
        try:
            out = await server.generate([3, 1, 4], 6)
            assert len(out) == 6
        finally:
            server.close()
        return server

    server = run(scenario())
    rec = server.recorder
    assert rec is not None and server.gen.recorder is rec
    snap = rec.snapshot()
    assert snap["dispatches"] >= 1 and snap["window"]["records"] >= 1
    for record in list(rec._ring):
        assert sum(record["phases"].values()) == pytest.approx(
            record["wall_s"], abs=1e-6)
    assert snap["attributed_share"] is not None
    assert snap["attributed_share"] >= 0.95
    assert snap["top_stall"] in ("queue_pop", "decide", "assemble",
                                 "launch", "d2h_issue", "emit", "other")
    phases = snap["window"]["phases"]
    assert phases["launch"]["s"] > 0
    assert "d2h_issue" in phases and "device_wait" in phases
    assert sum(p["share"] for p in phases.values()) == pytest.approx(
        1.0, abs=0.01)
    text = metrics.expose_text()
    assert ('app_llm_dispatch_phase_seconds_count'
            '{model="fr-phases",phase="launch"}') in text


def test_recorder_disabled_by_env(pair, run, monkeypatch):
    monkeypatch.setenv("GOFR_ML_FLIGHT_RECORDER", "0")

    async def scenario():
        server = LLMServer(_gen(pair), name="fr-off")
        try:
            assert server.recorder is None and server.gen.recorder is None
            assert server.autoprof is None
            out = await server.generate([3, 1, 4], 4)
            assert len(out) == 4
        finally:
            server.close()

    run(scenario())


# -- serving events, live ------------------------------------------------------------

def test_serving_events_admit_shed_deadline(pair, run):
    tracer = _RecordingTracer()
    cursor = tfr.event_log().cursor

    async def scenario():
        server = LLMServer(_gen(pair, batch_slots=1), name="fr-events",
                           max_queue=1, tracer=tracer)
        server.gen.fault = _sleep_hook("step", 0.01)
        try:
            long_task = asyncio.create_task(server.generate([9, 9], 40))
            await asyncio.sleep(0.08)
            with pytest.raises(DeadlineExceeded):
                await server.generate([1, 2], 4, deadline_s=0.05)
            queued = asyncio.create_task(
                server.generate([3, 4], 4, priority="low"))
            await asyncio.sleep(0.05)
            with pytest.raises((Overloaded, DeadlineExceeded)):
                await server.generate([5, 6], 4, priority="low")
            queued.cancel()
            await asyncio.gather(queued, return_exceptions=True)
            await long_task
        finally:
            server.close()

    run(scenario())
    out = tfr.event_log().query(since=cursor, model="fr-events")
    kinds = [e["kind"] for e in out["events"]]
    assert "admit" in kinds and "deadline" in kinds and "shed" in kinds
    admit = next(e for e in out["events"] if e["kind"] == "admit")
    assert admit["prompt_tokens"] == 2 and admit["priority"] == "normal"
    assert all(e["rid"] for e in out["events"]
               if e["kind"] in ("admit", "deadline", "shed"))
    reasons = [s.attributes.get("ml.finish_reason")
               for s in tracer.by_name("ml.queue")]
    assert "deadline" in reasons and "shed" in reasons


# -- crash forensics, live ------------------------------------------------------------

def _debug_app(server, name):
    app = App(config=MapConfig({"APP_NAME": "fr-app"}))
    ml = app._ensure_ml()
    ml._llms[name] = server
    return app


def test_crash_bundle_and_debug_endpoints(pair, run):
    async def scenario():
        server = LLMServer(_gen(pair), name="fr-crash", max_restarts=0)
        server.gen.fault = _fail_after("step", 0)
        app = _debug_app(server, "fr-crash")
        client = TestClient(TestServer(app._build_http_app()))
        await client.start_server()
        try:
            with pytest.raises(GeneratorCrashed):
                await server.generate([3, 1, 4], 6)
            r = await client.get("/debug/crash")
            crashes = (await r.json())["data"]["crashes"]
            mine = [c for c in crashes if c["model"] == "fr-crash"]
            assert mine and "injected" in mine[-1]["error"]
            r = await client.get(f"/debug/crash/{mine[-1]['id']}")
            assert r.status == 200
            bundle = (await r.json())["data"]
            assert bundle["trigger"]["kind"] == "crash"
            assert "injected" in bundle["trigger"]["error"]
            slots = bundle["state"]["slots"]
            assert len(slots) == 1
            assert slots[0]["prompt_tokens"] == 3
            assert slots[0]["priority"] == "normal"
            assert "scheduler" in bundle["state"]
            assert bundle["state"]["journeys"][0]["rid"] == slots[0]["rid"]
            seqs = {e["kind"]: e["seq"] for e in bundle["events"]
                    if e.get("model") == "fr-crash"}
            assert seqs["admit"] < bundle["trigger"]["seq"]
            r = await client.get("/debug/crash/no-such-crash")
            assert r.status == 404
            r = await client.get("/debug/events",
                                 params={"model": "fr-crash"})
            body = (await r.json())["data"]
            kinds = [e["kind"] for e in body["events"]]
            assert kinds.index("admit") < kinds.index("crash")
            assert "dead" in kinds
            r = await client.get(
                "/debug/events",
                params={"model": "fr-crash", "since": str(body["cursor"])})
            assert (await r.json())["data"]["events"] == []
            r = await client.get("/debug/events", params={"since": "nope"})
            assert r.status == 400
            r = await client.get("/debug/events", params={"limit": "0"})
            assert r.status == 400
            r = await client.get("/debug/serving")
            entry = (await r.json())["data"]["llms"]["fr-crash"]
            assert entry["stalls"]["dispatches"] >= 0
            assert "phases" in entry["stalls"]["window"]
            recent = entry["resilience"]["restarts"]["recent"]
            assert recent and recent[-1]["crash_id"] == mine[-1]["id"]
            assert entry["state"] == "dead"
        finally:
            await client.close()
            server.close()

    run(scenario())


@pytest.mark.parametrize("mod", [tfr, jfr], ids=["torch", "jax"])
def test_crash_vault_bounded(mod):
    vault = mod.CrashVault(capacity=3)
    ids = [vault.capture(model="m/0", trigger={"seq": i, "error": "x"},
                         state={}, events=[]) for i in range(5)]
    assert len(vault.list()) == 3
    assert vault.get(ids[0]) is None
    assert vault.get(ids[-1]) is not None
    assert [c["id"] for c in vault.list()] == ids[-3:] == \
        ["m-0-3", "m-0-4", "m-0-5"]


# -- /debug/* parity with the JAX example app -----------------------------------------

def _keys(obj, depth: int = 0):
    """The JSON key tree (values dropped), for key-by-key parity."""
    if isinstance(obj, dict):
        return {k: _keys(v, depth + 1) for k, v in obj.items()}
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return [_keys(obj[0], depth + 1)]
    return None


async def _drive_debug(app, server, name: str) -> dict:
    """The same requests and the same scripted crash through one app's
    ``/debug/*`` routes."""
    client = TestClient(TestServer(app._build_http_app()))
    await client.start_server()
    out: dict = {}
    try:
        for p in ([3, 1, 4], [2, 7, 1, 8]):
            await server.generate(p, 6)
        server.gen.fault = _fail_after("step", 0)
        try:
            await server.generate([5, 5, 5], 6)
        except Exception as exc:
            out["crash_error"] = type(exc).__name__
        server.gen.fault = None
        for _ in range(200):
            if server.health() != "recovering":
                break
            await asyncio.sleep(0.01)
        await server.generate([9, 2], 4)
        for route in ("/debug/serving", "/debug/goodput", "/debug/requests",
                      "/debug/programs", "/debug/profile/auto",
                      "/debug/crash", "/debug/capture"):
            r = await client.get(route)
            out[route] = (r.status, (await r.json())["data"])
        crash_id = [c for c in out["/debug/crash"][1]["crashes"]
                    if c["model"] == name][-1]["id"]
        r = await client.get(f"/debug/crash/{crash_id}")
        out["crash"] = (r.status, (await r.json())["data"])
        r = await client.get("/debug/events", params={"model": name})
        out["events"] = (r.status, (await r.json())["data"])
        rid = out["/debug/requests"][1]["recent_rids"][-1]
        r = await client.get(f"/debug/requests/{rid}")
        out["journey"] = (r.status, (await r.json())["data"])
        r = await client.get("/debug/requests/nope")
        out["journey_404"] = r.status
        r = await client.get("/debug/profile", params={"seconds": "0"})
        out["profile_400"] = r.status
    finally:
        await client.close()
        server.close()
    return out


@pytest.fixture(scope="module")
def debug_bodies(pair):
    """(JAX bodies, port bodies) after the same traffic and crash. Each
    package's process-wide profile vault is a fresh one for the fixture's
    life, holding one identical synthetic capture, and so is each
    package's goodput ledger: what earlier tests in the worker left in
    either vault or ledger does not reach the bodies."""
    from gofr_tpu.ml import goodput as jgp
    from gofr_tpu_torch.ml import goodput as tgp

    with pytest.MonkeyPatch.context() as m:
        for mod in (jfr, tfr):
            vault = mod.ProfileVault()
            vault.capture(model="fr-par/0",
                          trigger={"reason": "p50", "ratio": 2.5},
                          data=b"synthetic trace", truncated=False)
            m.setattr(mod, "_PROFILES", vault)
        for mod in (jgp, tgp):
            m.setattr(mod, "_LEDGER", mod.GoodputLedger())
        yield _debug_bodies(pair)


def _debug_bodies(pair):
    from gofr_tpu.app import App as JApp
    from gofr_tpu.config import MapConfig as JMapConfig

    async def both():
        japp = JApp(config=JMapConfig({"APP_NAME": "fr-parity"}))
        jml = japp._ensure_ml()
        jgen = _jgen(pair, chunk=2)
        jgen.warmup()
        jserver = JLLMServer(jgen, name="fr-par-j", max_restarts=3)
        jml._llms["fr-par-j"] = jserver
        want = await _drive_debug(japp, jserver, "fr-par-j")
        tgen = _gen(pair, chunk=2)
        tgen.warmup()
        tserver = LLMServer(tgen, name="fr-par-t", max_restarts=3)
        got = await _drive_debug(_debug_app(tserver, "fr-par-t"), tserver,
                                 "fr-par-t")
        return want, got

    return asyncio.run(both())


ROUTES = ("/debug/serving", "/debug/goodput", "/debug/requests",
          "/debug/programs", "/debug/profile/auto", "/debug/crash",
          "/debug/capture", "crash", "events", "journey")


@pytest.mark.parametrize("route", ROUTES)
def test_debug_json_keys_match_jax(debug_bodies, route):
    """Each ``/debug/*`` body has the JAX body's keys. Left out, by design:
    ``runtime`` holds the port's own fingerprint (torch and CUDA versions
    in place of jax and its backend), ``models`` and ``hbm`` name the
    port's devices, and the per-model names differ (``fr-par-j`` /
    ``fr-par-t``)."""
    want, got = debug_bodies
    assert got[route][0] == want[route][0] == 200

    def norm(body):
        body = json.loads(json.dumps(body).replace("fr-par-j", "M")
                          .replace("fr-par-t", "M"))
        if route == "/debug/serving":
            body.pop("runtime")
            body.pop("hbm")
        if route == "/debug/programs":
            body.pop("hbm")
            for m in body["models"].values():
                m.pop("entries")
                m.pop("pjrt", None)
        if route == "/debug/goodput":
            body["models"] = {k: v for k, v in body["models"].items()
                              if k == "M"}
        if route == "/debug/crash":
            body["crashes"] = [c for c in body["crashes"] if c["model"] == "M"]
        return body

    jk, tk = _keys(norm(want[route][1])), _keys(norm(got[route][1]))
    for keys in (jk, tk):
        if route == "/debug/requests":
            # which reasons and marks the process-wide log has seen
            # depends on the tests run before in this process
            keys["finish_reasons"] = keys["marks"] = None
        if route == "crash":
            # the bundle's events are the newest of the process-wide log,
            # whose oldest kinds depend on the tests run before
            keys["events"] = None
        if route in ("/debug/serving", "crash"):
            # keys of what the port has not: a failed asynchronous copy
            # counter (the port's block copy has no separate failure)
            block = keys["llms"]["M"] if route == "/debug/serving" \
                else keys["state"]
            block["pool"].pop("prefetch_errors", None)
    assert tk == jk


def test_debug_values_match_jax_where_deterministic(debug_bodies):
    """Values two runs of the same traffic share: the crash's victim
    count, restarts, states, goodput per reason, journey finish reasons,
    the event types in order and the 404 / 400 answers."""
    want, got = debug_bodies
    assert got["crash_error"] == want["crash_error"] == "GeneratorCrashed"
    js, ts = (b["/debug/serving"][1] for b in (want, got))
    jl, tl = js["llms"]["fr-par-j"], ts["llms"]["fr-par-t"]
    for key in ("state", "slots", "served", "restarts"):
        assert tl[key] == jl[key], key
    jr, tr = jl["resilience"], tl["resilience"]
    assert {k: tr["restarts"][k] for k in ("total", "in_window", "budget")} \
        == {k: jr["restarts"][k] for k in ("total", "in_window", "budget")}
    assert tl["goodput"]["delivered"] == jl["goodput"]["delivered"]
    assert tl["goodput"]["wasted"] == jl["goodput"]["wasted"]
    assert tl["goodput"]["device_tokens"] == jl["goodput"]["device_tokens"]
    jb, tb = want["crash"][1], got["crash"][1]
    assert len(tb["state"]["slots"]) == len(jb["state"]["slots"]) == 1
    assert tb["trigger"]["in_flight"] == jb["trigger"]["in_flight"]
    assert [e["kind"] for e in got["events"][1]["events"]] == \
        [e["kind"] for e in want["events"][1]["events"]]
    assert got["journey"][1]["finish_reason"] == \
        want["journey"][1]["finish_reason"] == "length"
    assert [m["mark"] for m in got["journey"][1]["marks"]] == \
        [m["mark"] for m in want["journey"][1]["marks"]]
    assert got["journey_404"] == want["journey_404"] == 404
    assert got["profile_400"] == want["profile_400"] == 400
    assert got["/debug/capture"][1] == want["/debug/capture"][1]


def test_debug_profiler_session_routes(run, tmp_path):
    """``APP_ENV=DEBUG`` mounts the profiler session (start, status, stop:
    a Chrome trace in the named directory) as JAX's app does; it holds the
    profiler lock, so a timed capture answers 409 meanwhile. Without the
    env the start route is the catch-all 404."""
    async def scenario():
        app = App(config=MapConfig({"APP_NAME": "fr-prof",
                                    "APP_ENV": "DEBUG"}))
        client = TestClient(TestServer(app._build_http_app()))
        await client.start_server()
        try:
            r = await client.post("/debug/profile/start",
                                  params={"dir": str(tmp_path)})
            assert r.status == 200
            assert (await r.json())["data"]["status"] == "started"
            r = await client.post("/debug/profile/start")
            assert r.status == 409
            r = await client.get("/debug/profile", params={"seconds": "0.1"})
            assert r.status == 409
            r = await client.get("/debug/profile/status")
            assert (await r.json())["data"] == {"running": True,
                                                "dir": str(tmp_path)}
            r = await client.post("/debug/profile/stop")
            assert (await r.json())["data"]["status"] == "stopped"
            assert (tmp_path / "trace.json").stat().st_size > 0
            assert not tfr.PROFILE_LOCK.locked()
            r = await client.post("/debug/profile/stop")
            assert r.status == 409
        finally:
            await client.close()
        plain = App(config=MapConfig({"APP_NAME": "fr-plain"}))
        client = TestClient(TestServer(plain._build_http_app()))
        await client.start_server()
        try:
            r = await client.post("/debug/profile/start")
            assert r.status == 404
        finally:
            await client.close()

    run(scenario())


def test_profile_capture_holds_serving_for_one_slice_at_most(tmp_path,
                                                             monkeypatch):
    """A profiler stop converts every event it recorded while holding the
    GIL and ``LAUNCH_GATE``, so its cost grows with the time recorded. A
    capture records in slices: with a conversion that takes half the
    recorded time, a serving pass during a 1 s capture waits for one
    slice's stop at most, never for the whole second's."""
    import threading

    from torch.autograd import profiler as autograd_profiler

    real_disable = autograd_profiler._disable_profiler
    real_enter = autograd_profiler.profile.__enter__
    started = {"t": 0.0, "stops": 0}

    def enter(self):
        started["t"] = time.perf_counter()
        return real_enter(self)

    def conversion():
        started["stops"] += 1
        time.sleep(0.5 * (time.perf_counter() - started["t"]))
        return real_disable()

    monkeypatch.setattr(autograd_profiler.profile, "__enter__", enter)
    monkeypatch.setattr(autograd_profiler, "_disable_profiler", conversion)
    capture = threading.Thread(target=tfr._capture_profile_trace,
                               args=(str(tmp_path), 1.0))
    waits = []
    capture.start()
    while capture.is_alive():
        tfr.LAUNCH_GATE.admission_point()  # every pass may admit
        t0 = time.perf_counter()
        with tfr.LAUNCH_GATE.serving():
            waits.append(time.perf_counter() - t0)
        time.sleep(0.002)
    capture.join()
    assert started["stops"] == len(list(tmp_path.glob("trace-*.json"))) > 1
    assert max(waits) < 0.2, f"a serving pass waited {max(waits):.3f} s"


def test_profile_slices_start_at_admissions(tmp_path, monkeypatch):
    """A slice starts at the next admission: the serving pass that
    prefills waits at ``admission_point`` until the slice holds the gate,
    so every slice records an admission pass, not only decode."""
    import threading

    from torch.autograd import profiler as autograd_profiler

    real_enter = autograd_profiler.profile.__enter__
    real_disable = autograd_profiler._disable_profiler
    state = {"recording": False}

    def enter(self):
        out = real_enter(self)
        state["recording"] = True
        return out

    def disable():
        state["recording"] = False
        return real_disable()

    monkeypatch.setattr(autograd_profiler.profile, "__enter__", enter)
    monkeypatch.setattr(autograd_profiler, "_disable_profiler", disable)
    # slices long enough that the waiting pass gets its turn on a loaded
    # host, short against the time between admissions
    # and a period (the wait for an admission) well past the time
    # between admissions however slow the passes run
    monkeypatch.setattr(tfr, "PROFILE_SLICE_S", 0.05)
    monkeypatch.setattr(tfr, "PROFILE_PERIOD_S", 0.8)
    capture = threading.Thread(target=tfr._capture_profile_trace,
                               args=(str(tmp_path), 2.0))
    capture.start()
    recorded = 0
    i = 0
    while capture.is_alive():
        admit = i % 12 == 0  # a prefill every ~150 ms among decode passes
        if admit:
            tfr.LAUNCH_GATE.admission_point()
        with tfr.LAUNCH_GATE.serving():
            recorded += admit and state["recording"]
            time.sleep(0.01)
        i += 1
    capture.join()
    slices = len(list(tmp_path.glob("trace-*.json")))
    assert slices >= 2 and recorded >= slices, (slices, recorded)


def test_auto_profile_slices_start_on_the_timer():
    """The auto-profiler fires on a slow dispatch, often in steady decode
    with no admission in sight. Its capture starts its slices on the
    timer: a 1 s capture with no serving pass reaching an admission
    records several slices across the second, not one slice after
    waiting the window out."""
    import io
    import zipfile

    vault = tfr.ProfileVault()
    prof = tfr.AutoProfiler(model="ap-timer", vault=vault,
                            events=tfr.EventLog(), capture_s=1.0)
    prof._trigger({"reason": "step_ms_p50"})
    deadline = time.monotonic() + 30.0
    while prof.captures + prof.failures == 0 and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    assert prof.captures == 1 and prof.failures == 0, prof.snapshot()
    bundle = vault.get(vault.list()[0]["id"])
    with zipfile.ZipFile(io.BytesIO(bundle["data"])) as zf:
        slices = [n for n in zf.namelist() if n.startswith("trace-")]
    assert len(slices) > 1, slices
