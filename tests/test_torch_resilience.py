"""PyTorch port, the serving watchdog and fault injection: the port's
``LLMServer`` + ``Generator.recover`` and ``testutil/faults.py`` held
against the JAX server on the same scripted faults (CPU, the tiny model at
f32, the JAX weights carried across with ``params_from_jax``).

Twins of ``tests/test_resilience.py`` (the fault grammar and its
rejections, deterministic draws, crash recovery with queued requests
surviving, a prefill crash, the restart budget, a borrowed prefix
invalidated, the admission crash that must not orphan a popped request,
the typed closed errors, a disconnect mid chunked prefill, no hang under
random faults). Each scripted scenario runs through both servers and must
give the same victims and typed errors, identical survivor tokens, the
same restart counts and states, the same goodput per reason and the same
sequence of event types.
"""

import asyncio
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.ml.llm import LLMServer as JLLMServer
from gofr_tpu.models import llama as jllama
from gofr_tpu.testutil import faults as jfaults
from gofr_tpu_torch.ml.errors import (DeadlineExceeded, GeneratorCrashed,
                                      ServerClosed)
from gofr_tpu_torch.ml.generate import Generator
from gofr_tpu_torch.ml.llm import LLMServer
from gofr_tpu_torch.models import llama as tllama
from gofr_tpu_torch.testutil import faults as tfaults

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
    for name in ("GOFR_ML_FAULT", "GOFR_ML_FAULT_SEED", "GOFR_ML_MAX_RESTARTS",
                 "GOFR_ML_RESTART_WINDOW_S", "GOFR_ML_DECODE_WINDOW",
                 "GOFR_ML_PIPELINE", "GOFR_ML_TOKEN_BUDGET",
                 "GOFR_ML_KV_HOST_BUDGET_MB"):
        monkeypatch.delenv(name, raising=False)


def _kw(kw):
    kw = dict(kw)
    kw.setdefault("batch_slots", 1)
    kw.setdefault("max_seq", 64)
    kw.setdefault("prefill_buckets", (8, 16))
    return kw


def _jgen(pair, **kw):
    jcfg, jparams, _, _ = pair
    return JGenerator(jparams, jcfg, **_kw(kw))


def _tgen(pair, **kw):
    _, _, tcfg, tparams = pair
    return Generator(tparams, tcfg, device="cpu", **_kw(kw))


def _servers(pair, gen_kw=None, **server_kw):
    """A JAX and a port server over the same weights and options."""
    gen_kw = gen_kw or {}
    return (JLLMServer(_jgen(pair, **gen_kw), **server_kw),
            LLMServer(_tgen(pair, **gen_kw), **server_kw))


def _expected(pair, prompt, n):
    return _tgen(pair).generate(prompt, n)


def _fail_n(point: str, n: int, exc=RuntimeError):
    """A scripted chaos hook: raise ``exc`` the first ``n`` times the given
    point fires, then behave."""
    left = {"n": n}

    def hook(p):
        if p == point and left["n"] > 0:
            left["n"] -= 1
            raise exc(f"injected at {p}")

    return hook


def _sleep_hook(point: str, seconds: float):
    def hook(p):
        if p == point:
            time.sleep(seconds)

    return hook


def _outcome(r):
    """A result as both packages compare: the tokens, or the typed error's
    class name and HTTP status."""
    if isinstance(r, BaseException):
        return (type(r).__name__, int(getattr(r, "status_code", 0)))
    return r


def _kinds(mod, cursor: int, model: str) -> list[str]:
    return [e["kind"] for e in mod.event_log().query(
        since=cursor, model=model, limit=100000)["events"]]


def _event_logs():
    from gofr_tpu import flight_recorder as jfr
    from gofr_tpu_torch import flight_recorder as tfr

    return jfr, tfr


def _ledgers():
    from gofr_tpu.ml import goodput as jgp
    from gofr_tpu_torch.ml import goodput as tgp

    return jgp.goodput_ledger(), tgp.goodput_ledger()


# -- the fault grammar -----------------------------------------------------------

GOOD_SPECS = ["step:0.5,restore:1:OSError", "step:0.02,prefill:0.05,emit:0.01",
              " step:1 , spill:0.25:KeyError ", "STEP:1",
              "route:0.1,ship:0.2,land:0.3,migrate:1", "peer_partition:0.5"]
BAD_SPECS = ["", "step", "step:2", "step:0", "step:0.1:NotAnExc",
             "bogus:0.5", "step:0.5:KeyboardInterrupt",
             "step:0.5:GeneratorExit", "step:x", "step:0.5:OSError:more"]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_fault_spec_parses_as_jax(spec):
    want = jfaults.FaultInjector.parse(spec).snapshot()
    got = tfaults.FaultInjector.parse(spec).snapshot()
    assert got == want
    assert tfaults.FAULT_POINTS == jfaults.FAULT_POINTS


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_fault_spec_rejections_match_jax(spec):
    with pytest.raises(ValueError) as want:
        jfaults.FaultInjector.parse(spec)
    with pytest.raises(ValueError) as got:
        tfaults.FaultInjector.parse(spec)
    assert str(got.value) == str(want.value)


def test_fault_spec_parsing():
    inj = tfaults.FaultInjector.parse("step:0.5,restore:1:OSError")
    assert inj.points["step"][0] == 0.5
    assert inj.points["step"][1] is tfaults.InjectedFault
    assert issubclass(tfaults.InjectedFault, RuntimeError)
    assert inj.points["restore"] == (1.0, OSError)
    snap = inj.snapshot()
    assert snap["spec"]["restore"] == {"rate": 1.0, "raises": "OSError"}


def test_fault_injector_fires_deterministically():
    inj = tfaults.FaultInjector.parse("step:1")
    with pytest.raises(tfaults.InjectedFault):
        inj.fire("step")
    inj.fire("prefill")  # unarmed point: no-op
    assert inj.injected["step"] == 1 and inj.attempts["step"] == 1
    assert tfaults.FaultInjector.from_env() is None  # env unset


@pytest.mark.parametrize("seed", [None, 7, 1234])
def test_fault_draws_match_jax(seed):
    """The same seed draws the same fault sequence as the JAX injector."""
    def draws(mod):
        inj = mod.FaultInjector.parse("step:0.3,emit:0.1", seed=seed)
        out = []
        for i in range(300):
            point = "step" if i % 3 else "emit"
            try:
                inj.fire(point)
                out.append(0)
            except RuntimeError as exc:
                out.append(str(exc))
        return out, inj.snapshot()

    assert draws(tfaults) == draws(jfaults)


def test_fault_knobs_from_env_match_jax(monkeypatch):
    monkeypatch.setenv("GOFR_ML_FAULT", "step:0.2,prefill:0.5:OSError")
    monkeypatch.setenv("GOFR_ML_FAULT_SEED", "99")
    want = jfaults.FaultInjector.from_env().snapshot()
    got = tfaults.FaultInjector.from_env().snapshot()
    assert got == want and got["seed"] == 99
    monkeypatch.setenv("GOFR_ML_FAULT", "  ")
    assert tfaults.FaultInjector.from_env() is None


def test_fault_snapshot_renders_hooks_as_jax():
    def my_hook(point):
        pass

    assert tfaults.fault_snapshot(None) is None
    assert tfaults.fault_snapshot(my_hook) == jfaults.fault_snapshot(my_hook)
    inj = tfaults.FaultInjector.parse("emit:1")
    assert tfaults.fault_snapshot(inj) == inj.snapshot()


# -- watchdog / crash recovery, JAX against the port ---------------------------------

def _resilience_view(server) -> dict:
    snap = server.resilience_snapshot()
    r = snap["restarts"]
    return {"state": snap["state"], "health": server.health(),
            "status": server.health_check()["status"],
            "total": r["total"], "in_window": r["in_window"],
            "budget": r["budget"], "window_s": r["window_s"],
            "recovered": [x["recovered"] for x in r["recent"]],
            "restarts": server.gen.restarts}


def test_crash_recover_queued_requests_survive(pair, run):
    """A step crash fails ONLY the in-flight request; the queued ones admit
    after recovery with the tokens of an uncrashed run; the server is
    ``degraded`` — the same victims, tokens, states, goodput and events as
    the JAX server."""
    prompts = [[i + 1, i + 2] for i in range(4)]
    expects = [_expected(pair, p, 4) for p in prompts]
    jfr, tfr = _event_logs()
    jled, tled = _ledgers()

    async def scenario(server, fr, ledger):
        server.gen.fault = _fail_n("step", 1)
        cursor = fr.event_log().cursor
        try:
            results = await asyncio.gather(
                *(server.generate(p, 4) for p in prompts),
                return_exceptions=True)
            view = _resilience_view(server)
        finally:
            server.close()
        assert server.closed_cleanly
        return ([_outcome(r) for r in results], view,
                _kinds(fr, cursor, server.name),
                ledger.snapshot_model(server.name))

    jserver, tserver = _servers(pair, name="rs-queued")
    want = run(scenario(jserver, jfr, jled))
    jled_before = tled.snapshot_model("rs-queued")
    got = run(scenario(tserver, tfr, tled))
    outcomes, view, kinds, _ = got
    assert outcomes == want[0]
    assert [o for o in outcomes if isinstance(o, tuple)] == \
        [("GeneratorCrashed", 503)]
    for r, exp in zip(outcomes, expects, strict=True):
        if isinstance(r, list):
            assert r == exp
    assert view == want[1]
    assert view["restarts"] == 1 and view["state"] == "degraded"
    assert view["status"] == "DEGRADED" and view["recovered"] == [True]
    assert kinds == want[2]
    assert "crash" in kinds and "recover" in kinds
    delta = {k: got[3][k] - jled_before[k]
             for k in ("delivered", "device_tokens")}
    assert delta == {k: want[3][k] for k in ("delivered", "device_tokens")}


def test_crash_during_prefill_recovers(pair, run):
    """A prefill crash fails that admission batch with the typed error and
    the server keeps serving, as the JAX server does."""

    async def scenario(server):
        server.gen.fault = _fail_n("prefill", 1)
        try:
            with pytest.raises(Exception) as ei:
                await server.generate([1, 2], 4)
            out = await server.generate([1, 2], 4)
            return (type(ei.value).__name__, out, server.gen.restarts,
                    server.health())
        finally:
            server.close()

    jserver, tserver = _servers(pair, gen_kw={"batch_slots": 2})
    want = run(scenario(jserver))
    got = run(scenario(tserver))
    assert got == want
    assert got[0] == "GeneratorCrashed"
    assert got[1] == _expected(pair, [1, 2], 4) and got[2] == 1


def test_restart_budget_exhaustion_dead_and_unhealthy(pair, run):
    """Crash-looping past the budget: every consumer gets a typed error,
    health DOWN, new submissions fail fast with a 503 — as in JAX."""

    async def scenario(server):
        server.gen.fault = _fail_n("step", 10 ** 6)
        results = await asyncio.gather(
            *(server.generate([1, 2], 4) for _ in range(5)),
            return_exceptions=True)
        try:
            await server.generate([1, 2], 2)
            late = None
        except Exception as exc:
            late = _outcome(exc)
        view = _resilience_view(server)
        server.close()
        return [_outcome(r) for r in results], late, view

    jserver, tserver = _servers(pair, max_restarts=2)
    want = run(scenario(jserver))
    got = run(scenario(tserver))
    assert got == want
    outcomes, late, view = got
    assert all(o == ("GeneratorCrashed", 503) for o in outcomes)
    assert late == ("GeneratorCrashed", 503)
    assert view["state"] == "dead" and view["status"] == "DOWN"
    assert view["total"] == 2 and view["recovered"] == [True, True, False]


def test_crash_invalidates_borrowed_prefix(pair, run):
    """A crash while a slot borrows a registered prefix invalidates that
    registration; plain requests still serve."""

    async def scenario(server):
        pid = await asyncio.get_running_loop().run_in_executor(
            None, server.register_prefix, list(range(1, 9)))
        server.gen.fault = _fail_n("step", 1)
        try:
            with pytest.raises(Exception) as ei:
                await server.generate([30, 31], 4, prefix=pid)
            gone = not server.has_prefix(pid)
            out = await server.generate([1, 2], 4)
            return type(ei.value).__name__, gone, out
        finally:
            server.close()

    gen_kw = {"batch_slots": 2, "page_size": 8}
    jserver, tserver = _servers(pair, gen_kw=gen_kw)
    want = run(scenario(jserver))
    got = run(scenario(tserver))
    assert got == want == ("GeneratorCrashed", True,
                           _expected(pair, [1, 2], 4))


def test_unborrowed_prefix_survives_a_crash(pair, run):
    """The other half of the invalidation rule: a registered prefix no
    crashed slot borrowed keeps its pages and still serves after the
    recovery, with the tokens it gave before."""

    async def scenario(server):
        pid = await asyncio.to_thread(server.register_prefix,
                                      list(range(1, 9)))
        before = await server.generate([30, 31], 4, prefix=pid)
        server.gen.fault = _fail_n("step", 1)
        try:
            with pytest.raises(GeneratorCrashed):
                await server.generate([5, 6], 4)
            after = await server.generate([30, 31], 4, prefix=pid)
            return server.has_prefix(pid), before, after
        finally:
            server.close()

    ok, before, after = run(scenario(LLMServer(_tgen(
        pair, batch_slots=2, page_size=8))))
    assert ok and after == before


def test_admission_crash_does_not_orphan_popped_requests(pair, run):
    """A crash between the waiting-queue pop and slot admission (the radix
    lookup dispatches device work) fails the popped request typed instead
    of leaving its consumer parked forever."""

    async def scenario():
        server = LLMServer(_tgen(pair, batch_slots=2))
        orig = server._split_prefix
        left = {"n": 1}

        def boom(req):
            if left["n"]:
                left["n"] -= 1
                raise RuntimeError("injected radix crash")
            return orig(req)

        server._split_prefix = boom
        try:
            results = await asyncio.wait_for(
                asyncio.gather(
                    *(server.generate([i + 1, i + 2], 4) for i in range(3)),
                    return_exceptions=True),
                timeout=60)  # a hang here is the fault
            crashed = [r for r in results if isinstance(r, GeneratorCrashed)]
            ok = [r for r in results if isinstance(r, list)]
            assert crashed, results
            assert len(crashed) + len(ok) == 3, results
        finally:
            server.close()

    run(scenario())


# -- the closed-server contract and disconnects ------------------------------------

def test_typed_closed_errors(pair, run):
    async def scenario():
        server = LLMServer(_tgen(pair, page_size=8))
        server.close()
        with pytest.raises(ServerClosed) as ei:
            await server.generate([1, 2], 4)
        assert int(ei.value.status_code) == 503
        with pytest.raises(ServerClosed):
            server.register_prefix([1, 2, 3])
        with pytest.raises(ServerClosed):
            server.drop_prefix(1)

    run(scenario())


def test_client_disconnect_mid_chunked_prefill(pair, run):
    """A consumer that breaks while its slot is still in chunked prefill:
    the slot is reaped, its pages freed, and the other slot's stream is
    unpolluted."""
    prompt = list(range(1, 13))  # 12 tokens, prefill_chunk 4: 3 segments

    async def scenario():
        server = LLMServer(_tgen(pair, batch_slots=2, page_size=4,
                                 prefill_chunk=4))
        gen = server.gen
        free_at_rest = gen.free_pages
        gen.fault = _sleep_hook("prefill", 0.02)
        try:
            agen = server.stream_chunks(prompt, 8)
            task = asyncio.create_task(agen.__anext__())
            for _ in range(100):
                if gen._chunked:
                    break
                await asyncio.sleep(0.005)
            assert gen._chunked, "slot never entered chunked prefill"
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
            await agen.aclose()
            out = await server.generate([1, 2], 4)
            assert out == _expected(pair, [1, 2], 4)
            for _ in range(100):
                if gen.n_live == 0 and not gen._chunked:
                    break
                await asyncio.sleep(0.01)
            assert not gen._chunked and not gen._chunked_order
            assert gen.n_live == 0
            assert gen.free_pages == free_at_rest
        finally:
            server.close()

    run(scenario())


def test_no_client_hangs_under_random_faults(pair, run):
    """Under a probabilistic fault arm every client receives valid output
    or a typed error — never a hang — and the server keeps serving; the
    ledger balances against the generator's computed tokens."""

    async def scenario():
        server = LLMServer(_tgen(pair, batch_slots=2), max_restarts=100,
                           name="rs-chaos",
                           fault=tfaults.FaultInjector.parse(
                               "step:0.05", seed=7))
        try:
            results = await asyncio.wait_for(
                asyncio.gather(
                    *(server.generate([i % 5 + 1, i % 3 + 1], 4)
                      for i in range(12)),
                    return_exceptions=True),
                timeout=120)
            for _ in range(200):
                if server.health() != "recovering":
                    break
                await asyncio.sleep(0.01)
            return results, server.resilience_snapshot(), server.gen
        finally:
            server.close()

    _, tled = _ledgers()
    before = tled.snapshot_model("rs-chaos")
    results, snap, gen = run(scenario())
    for r in results:
        assert isinstance(r, (list, GeneratorCrashed)), r
    ok = [r for r in results if isinstance(r, list)]
    assert ok, "every request failed under a 5% fault rate"
    assert sum(snap["fault"]["injected"].values()) >= 1
    assert snap["restarts"]["total"] == sum(snap["fault"]["injected"].values())
    after = tled.snapshot_model("rs-chaos")
    assert after["device_tokens"] - before["device_tokens"] \
        == gen.tokens_computed
    assert after["delivered"] - before["delivered"] == 4 * len(ok)


def test_deadline_mid_decode_is_not_a_crash(pair, run):
    """A deadline reaped mid-decode under the watchdog stays a 504 for its
    own request: no restart, the server stays ``serving``."""

    async def scenario():
        server = LLMServer(_tgen(pair))
        server.gen.fault = _sleep_hook("step", 0.01)
        try:
            with pytest.raises(DeadlineExceeded):
                await server.generate([1, 2], 60, deadline_s=0.08)
            return server.resilience_snapshot()["restarts"]["total"], \
                server.health()
        finally:
            server.close()

    assert run(scenario()) == (0, "serving")
