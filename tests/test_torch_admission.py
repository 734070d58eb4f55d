"""PyTorch port, admission and the serving knobs: the port's ``LLMServer``
sheds, ages, expires deadlines, drains and steers the prefill share as the
JAX server does under the same knobs (CPU, the tiny model at f32).

- twins of ``tests/test_resilience.py`` (deadlines, shedding, the queued
  tokens bound, the transports' status mapping, the health plane) and
  ``tests/test_scheduler.py`` (the SLO controller, priority admission,
  aging, unknown priorities) on the port;
- every repaired environment knob builds the same server state as the
  JAX server under the same environment, and a malformed value raises the
  JAX server's message; the knobs of what is not ported raise naming
  their ROADMAP item;
- the tokenizer encodes and decodes as the JAX package's pure-Python
  path does (hypothesis).
"""

import asyncio
import time
import types

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gofr_tpu_torch.ml.errors import (DeadlineExceeded, GeneratorCrashed,
                                      Overloaded, ServerClosed)
from gofr_tpu_torch.ml.generate import Generator
from gofr_tpu_torch.ml.llm import LLMServer
from gofr_tpu_torch.ml.scheduler import SLOController, TokenBudgetScheduler
from gofr_tpu_torch.models import llama

pytestmark = pytest.mark.timeout(240)


@pytest.fixture(scope="module")
def model():
    cfg = llama.tiny_llama(dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    return cfg, params


def _gen(model, **kw):
    cfg, params = model
    kw.setdefault("batch_slots", 1)
    kw.setdefault("max_seq", 64)
    kw.setdefault("prefill_buckets", (8, 16))
    return Generator(params, cfg, device="cpu", **kw)


def _expected(model, prompt, n):
    return _gen(model).generate(prompt, n)


def _slow(gen, seconds: float) -> None:
    """Sleep ``seconds`` before every decode dispatch (an instance
    attribute over ``Generator.step``); ``_fast`` takes it away."""
    inner = type(gen).step.__get__(gen)

    def step():
        time.sleep(seconds)
        inner()

    gen.step = step


def _fast(gen) -> None:
    gen.__dict__.pop("step", None)


# ------------------------------------------------------------------ deadlines
def test_queue_deadline_expiry_never_prefilled(model, run):
    """A queued request past its TTL is reaped at the admission gate with
    DeadlineExceeded (504); it never reaches a prefill."""

    async def scenario():
        server = LLMServer(_gen(model))
        _slow(server.gen, 0.01)
        try:
            long_task = asyncio.create_task(server.generate([9, 9], 30))
            await asyncio.sleep(0.05)  # the long one owns the only slot
            with pytest.raises(DeadlineExceeded) as ei:
                await server.generate([1, 2], 4, deadline_s=0.05)
            assert int(ei.value.status_code) == 504
            assert server.resilience_snapshot()["deadline_expired"] == 1
            assert await long_task == _expected(model, [9, 9], 30)
            assert server.gen.prefill_waves == 1  # only the long one
        finally:
            server.close()

    run(scenario())


def test_decode_deadline_cancels_mid_generation(model, run):
    """A slot past its deadline mid-decode is cancelled: the consumer has
    the streamed prefix, then the typed 504; the slot and its pages free
    for the next request."""

    async def scenario():
        server = LLMServer(_gen(model, page_size=8))
        _slow(server.gen, 0.01)
        try:
            got: list[int] = []
            with pytest.raises(DeadlineExceeded):
                async for burst in server.stream_chunks([1, 2], 60,
                                                        deadline_s=0.08):
                    got.extend(burst)
            assert got and len(got) < 60
            _fast(server.gen)
            out = await server.generate([1, 2], 4)  # slot + pages free
            assert out == _expected(model, [1, 2], 4)
            assert server.gen.n_live == 0
        finally:
            server.close()

    run(scenario())


def test_default_deadline_from_env(model, run, monkeypatch):
    monkeypatch.setenv("GOFR_ML_DEFAULT_DEADLINE_S", "0.04")

    async def scenario():
        server = LLMServer(_gen(model))
        _slow(server.gen, 0.01)
        try:
            with pytest.raises(DeadlineExceeded):
                await server.generate([1, 2], 60)  # no per-call deadline
            # deadline_s=0 opts one request out of the default
            out = await server.generate([1, 2], 4, deadline_s=0)
            assert out == _expected(model, [1, 2], 4)
        finally:
            server.close()

    run(scenario())


# -------------------------------------------------------------- load shedding
def test_shed_lowest_priority_first_with_retry_after(model, run):
    """Past the queue bound the newest LOWEST-priority queued request is
    shed with a typed 429 + Retry-After; a high-priority arrival preempts
    queued low-priority work instead of being shed."""

    async def scenario():
        server = LLMServer(_gen(model), max_queue=2)
        _slow(server.gen, 0.01)
        try:
            long_task = asyncio.create_task(server.generate([9, 9], 40))
            await asyncio.sleep(0.05)  # occupy the slot
            lows = [asyncio.create_task(
                server.generate([i + 1, i + 2], 4, priority="low"))
                for i in range(2)]
            await asyncio.sleep(0.05)  # both queued
            high = asyncio.create_task(
                server.generate([5, 6], 4, priority="high"))
            results = await asyncio.gather(*lows, high, long_task,
                                           return_exceptions=True)
            shed = [r for r in results if isinstance(r, Overloaded)]
            assert len(shed) == 1
            assert isinstance(results[1], Overloaded), results  # the newest
            assert isinstance(results[0], list)
            assert isinstance(results[2], list)
            err = shed[0]
            assert int(err.status_code) == 429
            assert err.retry_after > 0
            assert "Retry-After" in err.headers
            snap = server.resilience_snapshot()
            assert snap["shed"] == {"high": 0, "normal": 0, "low": 1}

            # a low arrival against a queue with nothing worse sheds ITSELF
            t2 = asyncio.create_task(server.generate([9, 8], 40))
            await asyncio.sleep(0.05)
            parked = [asyncio.create_task(
                server.generate([i + 1, i + 3], 4, priority="high"))
                for i in range(2)]
            await asyncio.sleep(0.05)
            with pytest.raises(Overloaded):
                await server.generate([7, 7], 4, priority="low")
            _fast(server.gen)
            await asyncio.gather(t2, *parked)
        finally:
            server.close()

    run(scenario())


def test_idle_burst_not_shed_with_free_slots(model, run):
    """The queue bound measures backlog, not staging: a burst covered by
    free slots admits instead of shedding, even with max_queue=1."""

    async def scenario():
        server = LLMServer(_gen(model, batch_slots=4), max_queue=1)
        try:
            results = await asyncio.gather(
                *(server.generate([i + 1, 2], 4) for i in range(4)),
                return_exceptions=True)
            assert all(isinstance(r, list) for r in results), results
        finally:
            server.close()

    run(scenario())


def test_queued_tokens_bound(model, run):
    """GOFR_ML_MAX_QUEUED_TOKENS sheds on backlog TOKENS, not requests."""

    async def scenario():
        server = LLMServer(_gen(model), max_queued_tokens=8)
        _slow(server.gen, 0.01)
        try:
            long_task = asyncio.create_task(server.generate([9, 9], 40))
            await asyncio.sleep(0.05)
            q1 = asyncio.create_task(
                server.generate([1, 2, 3, 4, 5, 6], 4))  # 6 queued tokens
            await asyncio.sleep(0.05)
            with pytest.raises(Overloaded):  # 6 + 6 > 8
                await server.generate([1, 2, 3, 4, 5, 7], 4)
            _fast(server.gen)
            assert await q1 == _expected(model, [1, 2, 3, 4, 5, 6], 4)
            await long_task
        finally:
            server.close()

    run(scenario())


def test_overloaded_http_envelope_and_grpc_mapping():
    """429 with Retry-After on HTTP; RESOURCE_EXHAUSTED /
    DEADLINE_EXCEEDED / UNAVAILABLE on gRPC; untyped errors sanitized."""
    import grpc

    from gofr_tpu_torch.grpc import _grpc_status_of, _trailers
    from gofr_tpu_torch.http.responder import respond

    resp = respond("GET", None, Overloaded(retry_after=7.2))
    assert resp.status == 429
    assert resp.headers["Retry-After"] == "7"
    assert respond("GET", None, DeadlineExceeded()).status == 504
    assert respond("GET", None, GeneratorCrashed()).status == 503
    assert _grpc_status_of(Overloaded())[0] == \
        grpc.StatusCode.RESOURCE_EXHAUSTED
    assert _grpc_status_of(DeadlineExceeded())[0] == \
        grpc.StatusCode.DEADLINE_EXCEEDED
    assert _grpc_status_of(ServerClosed())[0] == grpc.StatusCode.UNAVAILABLE
    assert _grpc_status_of(GeneratorCrashed())[0] == \
        grpc.StatusCode.UNAVAILABLE
    assert _grpc_status_of(KeyError("secret")) == \
        (grpc.StatusCode.INTERNAL, "internal error", False)
    assert _trailers(Overloaded(retry_after=7.2)) == (("retry-after", "7"),)
    assert _trailers(ServerClosed()) == ()


# -------------------------------------------------------------- health plane
def test_health_handler_reflects_llm_state(model, run):
    """/.well-known/health answers 200 while serving and 503 once the LLM
    server is dead."""
    from aiohttp.test_utils import TestClient, TestServer

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig

    async def scenario():
        app = App(config=MapConfig({"APP_NAME": "resilience-test"}))
        ml = app._ensure_ml()
        server = LLMServer(_gen(model), name="chat",
                           metrics=app.container.metrics_manager,
                           max_restarts=0)
        ml._llms["chat"] = server
        client = TestClient(TestServer(app._build_http_app()))
        await client.start_server()
        try:
            r = await client.get("/.well-known/health")
            assert r.status == 200
            body = (await r.json())["data"]
            assert body["ml"]["status"] == "UP"
            assert body["ml"]["details"]["llms"]["chat"]["state"] == "serving"
            res = server.resilience_snapshot()
            assert res["state"] == "serving"
            assert res["closed_cleanly"] is True

            def crash():
                raise RuntimeError("injected at step")

            server.gen.step = crash  # no restart budget: the first is fatal
            with pytest.raises(GeneratorCrashed):
                await server.generate([1, 2], 4)
            assert server.health() == "dead"
            r = await client.get("/.well-known/health")
            assert r.status == 503
            err = (await r.json())["error"]
            assert err["ml"]["status"] == "DOWN"
            assert err["ml"]["details"]["llms"]["chat"]["state"] == "dead"
        finally:
            await client.close()
            server.close()

    run(scenario())


# ----------------------------------------------------------------- scheduler
def test_slo_controller_steers_share():
    sched = TokenBudgetScheduler(64, (1, 2, 4, 8), prefill_chunk=8,
                                 prefill_share=0.5)
    ctl = SLOController(sched, ttft_target_s=0.2, tpot_target_s=0.05,
                        interval_s=0.0)
    ctl.observe_tpot(0.5)  # TPOT over target: the share backs off
    assert ctl.maybe_update(now=1.0)
    assert sched.prefill_share < 0.5
    sched.set_share(0.3)  # TTFT over target, TPOT healthy: it grows
    ctl._tpot.clear()
    ctl.observe_tpot(0.01)
    ctl.observe_ttft(1.0)
    ctl.maybe_update(now=2.0)
    assert sched.prefill_share > 0.3
    ctl._ttft.clear()  # both healthy: drift to neutral, always clamped
    ctl.observe_ttft(0.01)
    sched.set_share(0.9)
    ctl.maybe_update(now=3.0)
    assert sched.min_share <= sched.prefill_share < 0.9


def _order(model, run, gap_s: float) -> list[str]:
    """Admission order of a low request queued first and a high one
    ``gap_s`` later, behind a hog on the only slot."""

    async def scenario():
        server = LLMServer(_gen(model, max_seq=64, prefill_buckets=(8,),
                                chunk=2))
        _slow(server.gen, 0.04)  # the hog holds the slot ~1.2 s
        order: list[str] = []
        try:
            hog = asyncio.create_task(server.generate([9, 9, 9], 60))
            await asyncio.sleep(0.1)

            async def one(name, prio):
                await server.generate([5, 3], 3, priority=prio)
                order.append(name)

            jobs = [asyncio.create_task(one("low", "low"))]
            await asyncio.sleep(gap_s)
            jobs += [asyncio.create_task(one("normal", "normal")),
                     asyncio.create_task(one("high", "high"))]
            await asyncio.wait_for(asyncio.gather(hog, *jobs), 120)
            return order
        finally:
            server.close()

    return run(scenario())


def test_server_priority_admission_order(model, run):
    """Under slot contention high admits before normal before low,
    whatever the arrival order."""
    assert _order(model, run, 0.05) == ["high", "normal", "low"]


def test_server_aging_promotes_starved_low(model, run, monkeypatch):
    """With GOFR_ML_PRIORITY_AGING_S=0.05 a parked low request outranks
    later high and normal ones."""
    monkeypatch.setenv("GOFR_ML_PRIORITY_AGING_S", "0.05")
    assert _order(model, run, 0.4)[0] == "low"


def test_server_rejects_unknown_priority(model, run):
    async def scenario():
        server = LLMServer(_gen(model, prefill_buckets=(8,)))
        try:
            with pytest.raises(ValueError):
                await server.generate([5, 3], 2, priority="urgent")
            return await server.generate([5, 3], 2, priority="high")
        finally:
            server.close()

    assert len(run(scenario())) == 2


def test_scheduler_snapshot_through_server(model, run):
    """The scheduler block: budget, ladder, realized chunk sizes, SLO
    state, and per-priority queue depths."""
    async def scenario():
        server = LLMServer(_gen(model, batch_slots=2, prefill_buckets=(8,),
                                chunk=4, token_budget=8))
        try:
            await server.generate([3, 1, 4], 6)
            return server.scheduler_snapshot(), server.queue_depth()
        finally:
            server.close()

    snap, depth = run(scenario())
    assert snap["budget"] == 8
    assert snap["ladder"] == [1, 2, 4]
    assert sum(int(v) for v in snap["dispatches"].values()) > 0
    assert set(snap["waiting"]) == {"high", "normal", "low"}
    assert "slo" in snap and snap["slo"]["updates"] >= 0
    assert depth == 0


# ------------------------------------------- the knobs, against the JAX server
@pytest.fixture(scope="module")
def jax_model():
    from gofr_tpu.models import llama as jllama

    cfg = jllama.tiny_llama(use_flash=False)
    return cfg, jllama.init_params(cfg, jax.random.PRNGKey(0))


def _servers(model, jax_model, **server_kw):
    """A JAX and a port LLMServer built under the current environment."""
    from gofr_tpu.ml.generate import Generator as JGenerator
    from gofr_tpu.ml.llm import LLMServer as JLLMServer

    jcfg, jparams = jax_model
    kw = dict(batch_slots=2, max_seq=64, prefill_buckets=(8, 16))
    return (JLLMServer(JGenerator(jparams, jcfg, **kw), **server_kw),
            LLMServer(_gen(model, **kw), **server_kw))


def _state(server) -> dict:
    ctl = server._controller
    return {"max_queue": server._max_queue,
            "max_queued_tokens": server._max_queued_tokens,
            "default_deadline": server._default_deadline,
            "aging_s": server._waiting.aging_s,
            "drain_s": server._drain_default,
            "max_restarts": server._max_restarts,
            "restart_window_s": server._restart_window,
            "ttft_target_s": ctl.ttft_target_s,
            "tpot_target_s": ctl.tpot_target_s,
            "bounds": server.resilience_snapshot()["queue_bounds"]}


KNOBS = {
    "GOFR_ML_MAX_QUEUE": "5",
    "GOFR_ML_MAX_QUEUED_TOKENS": "300",
    "GOFR_ML_DEFAULT_DEADLINE_S": "2.5",
    "GOFR_ML_PRIORITY_AGING_S": "0.25",
    "GOFR_ML_DRAIN_S": "7",
    "GOFR_ML_MAX_RESTARTS": "5",
    "GOFR_ML_RESTART_WINDOW_S": "30",
    "GOFR_ML_TTFT_TARGET_MS": "120",
    "GOFR_ML_TPOT_TARGET_MS": "35",
}
MALFORMED = {
    "GOFR_ML_MAX_QUEUE": "many",
    "GOFR_ML_MAX_QUEUED_TOKENS": "1.5",
    "GOFR_ML_DEFAULT_DEADLINE_S": "soon",
    "GOFR_ML_PRIORITY_AGING_S": "x",
    "GOFR_ML_DRAIN_S": "-1",
    "GOFR_ML_MAX_RESTARTS": "three",
    "GOFR_ML_RESTART_WINDOW_S": "a minute",
    "GOFR_ML_FAULT": "step:2",
    "GOFR_ML_CAPTURE": "lots",
    "GOFR_ML_TTFT_TARGET_MS": "fast",
    "GOFR_ML_TPOT_TARGET_MS": "",
}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_knob_builds_the_jax_server_state(model, jax_model, knob,
                                          monkeypatch):
    monkeypatch.setenv(knob, KNOBS[knob])
    jserver, tserver = _servers(model, jax_model)
    try:
        assert _state(tserver) == _state(jserver)
    finally:
        jserver.close()
        tserver.close()


@pytest.mark.parametrize("knob", sorted(MALFORMED))
def test_malformed_knob_raises_the_jax_message(model, jax_model, knob,
                                               monkeypatch):
    monkeypatch.setenv(knob, MALFORMED[knob])
    errors = []
    for build in (lambda: _servers(model, jax_model)[0],
                  lambda: _servers(model, jax_model)[1]):
        try:
            build().close()
            errors.append(None)
        except ValueError as exc:
            errors.append(str(exc))
    assert errors[0] is not None
    assert errors[1] == errors[0]


@pytest.mark.parametrize("env,kw", [
    ({"GOFR_ML_MAX_RESTARTS": "5"}, {}),
    ({}, {"max_restarts": 1}),
    ({"GOFR_ML_RESTART_WINDOW_S": "12"}, {"max_restarts": 0}),
    ({"GOFR_ML_MAX_RESTARTS": "0"}, {}),
    ({"GOFR_ML_FAULT": "step:0.5"}, {}),
    ({"GOFR_ML_FAULT": "step:0.02,prefill:0.05,emit:0.01",
      "GOFR_ML_FAULT_SEED": "1234"}, {}),
    ({"GOFR_ML_FAULT": ""}, {}),
    ({}, {"fault": None}),
])
def test_resilience_knobs_build_the_jax_snapshot(model, jax_model, env, kw,
                                                 monkeypatch):
    """The watchdog's and the chaos hook's knobs give the JAX server's
    ``resilience_snapshot()``: state, restart budget and window, history,
    counters, bounds and the armed fault config."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jserver, tserver = _servers(model, jax_model, **kw)
    try:
        assert tserver.resilience_snapshot() == jserver.resilience_snapshot()
        assert tserver.health() == jserver.health() == "serving"
    finally:
        jserver.close()
        tserver.close()


def test_unset_max_restarts_reads_three(model, jax_model, monkeypatch):
    monkeypatch.delenv("GOFR_ML_MAX_RESTARTS", raising=False)
    jserver, tserver = _servers(model, jax_model)
    try:
        assert tserver._max_restarts == jserver._max_restarts == 3
        assert tserver._restart_window == jserver._restart_window == 60.0
    finally:
        jserver.close()
        tserver.close()


@pytest.mark.parametrize("how", ["env", "injector", "unset"])
def test_fault_knob_arms_the_injector(model, how, monkeypatch):
    """``GOFR_ML_FAULT`` (or ``fault=``) arms the chaos hook on the
    generator's dispatch points and the server's emit path; unset arms
    nothing."""
    from gofr_tpu_torch.testutil.faults import FaultInjector

    kw = {}
    if how == "env":
        monkeypatch.setenv("GOFR_ML_FAULT", "step:0.25,emit:1:OSError")
        monkeypatch.setenv("GOFR_ML_FAULT_SEED", "5")
    elif how == "injector":
        kw["fault"] = FaultInjector.parse("prefill:1")
    server = LLMServer(_gen(model), **kw)
    try:
        if how == "unset":
            assert server.gen.fault is None and server._fault is None
            assert server.resilience_snapshot()["fault"] is None
            return
        assert isinstance(server.gen.fault, FaultInjector)
        assert server.gen.fault is server._fault
        if how == "env":
            assert server._fault.seed == 5
            assert server._fault.points["emit"] == (1.0, OSError)
        else:
            assert server._fault is kw["fault"]
    finally:
        server.close()


@pytest.mark.parametrize("raw", ["128", "1", "lots", "-1", "", "0"])
def test_capture_knob_raises_naming_a16(model, raw, monkeypatch):
    """``GOFR_ML_CAPTURE`` parsed as JAX parses it: a malformed value
    raises the JAX package's message; a positive ring size arms the
    traffic capture (ROADMAP A.16, ported) with that bound; unset, empty or
    0 constructs none."""
    from gofr_tpu.ml.capture import _ring_size

    monkeypatch.setenv("GOFR_ML_CAPTURE", raw)
    try:
        n = _ring_size()
        want = None
    except ValueError as exc:
        want = str(exc)
    if want is not None:
        with pytest.raises(ValueError) as got:
            LLMServer(_gen(model))
        assert str(got.value) == want
        return
    server = LLMServer(_gen(model))
    try:
        if n > 0:
            assert server._capture.stats()["capacity"] == n
        else:
            assert server._capture is None
    finally:
        server.close()


# Each case keeps the name and id it had while every fleet knob raised
# naming its ROADMAP item; ``want`` says what a case now checks: "pool"
# and "disagg" that a ReplicaPool mounts, "profile" a loud boot failure,
# "A.14b" (federation, ported since) JAX's boot error for a fleet map
# that does not name this host, then a mounted FederatedPool once
# GOFR_ML_FEDERATION_SELF names it.
@pytest.mark.parametrize("env,kw,want", [
    pytest.param({"GOFR_ML_REPLICAS": "2"}, {}, "pool", id="env0-kw0-A.14"),
    pytest.param({}, {"replicas": 2}, "pool", id="env1-kw1-A.14"),
    pytest.param({"GOFR_ML_ELASTIC": "1"}, {}, "pool", id="env2-kw2-A.14"),
    pytest.param({"GOFR_ML_CANARY": "candidate.json"}, {}, "profile",
                 id="env3-kw3-A.14"),
    pytest.param({"GOFR_ML_FEDERATION": "a=127.0.0.1:1"}, {}, "A.14b",
                 id="env4-kw4-A.14"),
    pytest.param({"GOFR_ML_DISAGG": "1"}, {}, "disagg", id="env5-kw5-A.14"),
    pytest.param({}, {"disagg": True}, "disagg", id="env6-kw6-A.14"),
    pytest.param({"GOFR_ML_PROFILE": "tuned.json"}, {}, "profile",
                 id="env7-kw7-A.16"),
    pytest.param({}, {"profile": "tuned.json"}, "profile",
                 id="env8-kw8-A.16"),
])
def test_unported_fleet_knobs_raise_naming_their_item(model, env, kw, want,
                                                      monkeypatch):
    """The fleet knobs (ROADMAP A.14a, ported) mount a ``ReplicaPool`` as
    JAX's ``register_llm`` does: ``GOFR_ML_REPLICAS`` / ``replicas=`` > 1
    and ``GOFR_ML_ELASTIC=1`` (even at one replica). A canary or tuned
    profile that cannot be read fails the boot with the JAX package's
    message; disaggregation on one replica gives JAX's "requires replicas
    >= 2" and mounts a disaggregated pool at two. Federation across hosts
    (A.14b, ported) fails the boot with JAX's error while
    ``GOFR_ML_FEDERATION_SELF`` is unset and mounts a ``FederatedPool``
    once it names a member."""
    from gofr_tpu_torch.ml import MLDatasource
    from gofr_tpu_torch.ml.replica import ReplicaPool

    cfg, params = model
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    knobs = dict(device="cpu", max_seq=64, prefill_buckets=(8,), **kw)
    if want == "profile":
        from gofr_tpu.ml.tune import load_profile

        with pytest.raises(ValueError) as jax_err:
            load_profile("tuned.json")
        with pytest.raises(ValueError) as got:
            MLDatasource().register_llm("chat", params, cfg, **knobs)
        assert str(got.value) == str(jax_err.value).replace(
            "tuned.json", env.get("GOFR_ML_CANARY", "tuned.json"))
        return
    if want == "A.14b":
        from gofr_tpu.ml.federation import \
            federation_from_env as jax_federation_from_env
        from gofr_tpu.testutil import get_free_port
        from gofr_tpu_torch.ml.federation import FederatedPool

        monkeypatch.delenv("GOFR_ML_FEDERATION_SELF", raising=False)
        with pytest.raises(ValueError) as jax_err:
            jax_federation_from_env()
        with pytest.raises(ValueError) as got:
            MLDatasource().register_llm("chat", params, cfg, **knobs)
        assert str(got.value) == str(jax_err.value)
        monkeypatch.setenv("GOFR_ML_FEDERATION",
                           f"a=127.0.0.1:{get_free_port()}")
        monkeypatch.setenv("GOFR_ML_FEDERATION_SELF", "a")
        server = MLDatasource().register_llm("chat", params, cfg, **knobs)
        try:
            assert isinstance(server, FederatedPool)
            assert server.federation_snapshot()["host"] == "a"
        finally:
            server.close()
        return
    if want == "disagg":
        from gofr_tpu.ml import MLDatasource as JMLDatasource

        with pytest.raises(ValueError) as jax_err:
            JMLDatasource().register_llm("chat", None, None,
                                         generator=object(),
                                         **({"disagg": True} if kw else {}))
        with pytest.raises(ValueError) as got:
            MLDatasource().register_llm("chat", params, cfg, **knobs)
        assert str(got.value) == str(jax_err.value)
        knobs.update(replicas=2, page_size=4, batch_slots=1)
    server = MLDatasource().register_llm("chat", params, cfg, **knobs)
    try:
        assert isinstance(server, ReplicaPool)
        assert server.fleet_size() == (1 if want == "pool" and env.get(
            "GOFR_ML_ELASTIC") else 2)
        assert (server.routing_snapshot()["disagg"] is not None) == (
            want == "disagg")
    finally:
        server.close()


def test_example_knobs_of_later_items_raise(monkeypatch):
    """LLAMA_CKPT / TOKENIZER_JSON (A.12, ported) naming nothing raise
    FileNotFoundError at boot, and a draft checkpoint (LLM_DRAFT_CKPT with
    a positive LLM_SPEC_K) that is not an HF directory raises JAX's
    ValueError (the name is kept from when A.12 raised). LLM_DISAGG=1
    (A.14a, ported) gives JAX's "requires replicas >= 2" on one replica
    and boots a
    disaggregated pool with GOFR_ML_REPLICAS=2 over paged generators (the
    name is kept from when it raised naming A.14)."""
    from gofr_tpu_torch.examples import llama_server

    for knob in ("TOKENIZER_JSON", "LLAMA_CKPT"):
        with monkeypatch.context() as m:
            m.setenv(knob, "/nonexistent")
            with pytest.raises(FileNotFoundError, match="nonexistent"):
                llama_server.main(device="cpu")
    with monkeypatch.context() as m:
        m.setenv("LLM_SPEC_K", "2")
        m.setenv("LLM_DRAFT_CKPT", "/nonexistent")
        m.setenv("LLAMA_PRESET", "tiny")
        with pytest.raises(ValueError, match="is not a HF model directory"):
            llama_server.main(device="cpu")
    from gofr_tpu_torch.ml.replica import ReplicaPool

    with monkeypatch.context() as m:
        m.setenv("LLM_DISAGG", "1")
        m.setenv("LLAMA_PRESET", "tiny")
        with pytest.raises(ValueError, match="requires replicas >= 2"):
            llama_server.main(device="cpu")
        m.setenv("GOFR_ML_REPLICAS", "2")
        m.setenv("LLM_PAGE_SIZE", "8")
        app = llama_server.main(device="cpu")
        pool = app._ensure_ml().llm("chat")
        try:
            assert isinstance(pool, ReplicaPool)
            assert pool.routing_snapshot()["disagg"]["roles"] == {
                "0": "prefill", "1": "decode"}
        finally:
            pool.close()


def test_slo_steering_moves_the_share_as_jax_does(model, jax_model, run,
                                                  monkeypatch):
    """With a TTFT target no prefill meets and a TPOT target every stream
    meets, both servers' controllers raise the prefill share from 0.5."""
    monkeypatch.setenv("GOFR_ML_TTFT_TARGET_MS", "0.001")
    monkeypatch.setenv("GOFR_ML_TPOT_TARGET_MS", "10000")
    jserver, tserver = _servers(model, jax_model)

    async def traffic(server):
        _slow(server.gen, 0.04)
        for p in ([3, 1, 4], [1, 5, 9]):
            await server.generate(p, 20)

    try:
        shares = []
        for server in (jserver, tserver):
            run(traffic(server))
            shares.append(server.gen.scheduler.prefill_share)
            assert server._controller.updates >= 2
        assert shares[0] > 0.5 and shares[1] > 0.5, shares
    finally:
        jserver.close()
        tserver.close()


# ------------------------------------------------------------------ tokenizer
@pytest.fixture(scope="module")
def bpe_pair():
    from gofr_tpu.native.tokenizer import BPETokenizer as JBPE
    from gofr_tpu.native.tokenizer import train_bpe

    from gofr_tpu_torch.tokenizer import BPETokenizer

    trained = train_bpe(["the quick brown fox jumps over the lazy dog " * 4,
                         "gofr serves llama on a card, the card serves",
                         "ababababab aaa bbb"], 300, specials=["<eos>"])
    ref = JBPE(trained.vocab, trained.merges, specials=trained.specials,
               use_native=False)
    port = BPETokenizer(trained.vocab, trained.merges,
                        specials=trained.specials)
    return ref, port


@settings(max_examples=60, deadline=None)
@given(data=st.binary(max_size=64), extra=st.lists(
    st.integers(min_value=-3, max_value=600), max_size=6))
def test_tokenizer_matches_the_pure_python_path(bpe_pair, data, extra):
    ref, port = bpe_pair
    ids = port.encode(data)
    assert ids == ref.encode(data)
    assert port.decode_bytes(ids) == data
    assert port.decode_bytes(ids + extra) == ref.decode_bytes(ids + extra)
    assert port.decode(ids + extra) == ref.decode(ids + extra)


def test_byte_level_tokenizer_sizes_the_tiny_model(monkeypatch):
    from gofr_tpu_torch.tokenizer import BPETokenizer

    monkeypatch.setenv("LLAMA_PRESET", "tiny")
    tok = BPETokenizer.byte_level(specials=["<eos>"])
    assert tok.vocab_size == 257 and tok.specials == {"<eos>": 256}
    assert llama.config_from_env(
        tiny_vocab_size=tok.vocab_size).vocab_size == 257
    # ids past the vocabulary (random 8b weights emit up to 128255)
    assert tok.decode([104, 105, 128255]) == "hi�"


def _item(priority: int, enqueued_at: float, n_tokens: int):
    return types.SimpleNamespace(priority=priority, enqueued_at=enqueued_at,
                                 n_tokens=n_tokens)


def test_queue_keeps_queued_tokens_and_sheds_newest_lowest():
    from gofr_tpu_torch.ml.scheduler import AgingPriorityQueue, retry_after_s

    q = AgingPriorityQueue()
    items = [_item(2, 0.0, 3), _item(2, 1.0, 4), _item(1, 0.0, 5),
             _item(0, 0.0, 6)]
    for it in items:
        q.push(it)
    assert q.tokens == 18
    assert q.shed_lowest(worse_than=2) is None  # nothing worse than low
    assert q.shed_lowest(worse_than=0) is items[1]  # newest low
    assert q.tokens == 14
    assert q.pop(now=0.0) is items[3]
    assert q.prune(lambda it: it.priority == 2) == [items[0]]
    assert q.tokens == 5 and len(q) == 1
    assert q.snapshot(now=2.0)["normal"] == {"depth": 1,
                                             "oldest_wait_s": 2.0}
    assert retry_after_s([], 3) == 1.0  # nothing drained yet
    assert retry_after_s([0.0, 1.0, 2.0], 3) == 4.0  # 1/s, 4 ahead
    assert np.isclose(retry_after_s([0.0, 100.0], 10 ** 6), 300.0)

