"""PyTorch port, the goodput ledger (``ml/goodput.py``), the auto-profiler
and the program inventory (``ml/programs.py``), held against the JAX
package's (CPU, the tiny model at f32, the JAX weights carried across with
``params_from_jax``).

Twins of ``tests/test_goodput.py``: the ledger's unit arithmetic and
knobs; the token fates of a served request, a deadline reaped mid-decode,
a consumer that walks away, a crash, and a restore that falls back — each
scenario run through the JAX server and the port's, with the same tokens
charged to the same reasons and the ledger balanced against the port
generator's own count of computed tokens; ``GOFR_ML_GOODPUT=0`` and
``GOFR_ML_AUTOPROF=0`` leave the hot path untouched; the auto-profiler
triggers exactly once a cooldown (on the step's p50 and on a phase's share,
the same triggers as JAX's) and through the serve loop; the program rows of
a warmed generator and the ``/debug/goodput``, ``/debug/serving``,
``/debug/programs`` and ``/debug/profile/auto`` routes.
"""

import asyncio
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from gofr_tpu import flight_recorder as jfr
from gofr_tpu.ml import goodput as jgp
from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.ml.llm import LLMServer as JLLMServer
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch import flight_recorder as tfr
from gofr_tpu_torch.app import App
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.ml import goodput as tgp
from gofr_tpu_torch.ml.errors import DeadlineExceeded, GeneratorCrashed
from gofr_tpu_torch.ml.generate import Generator
from gofr_tpu_torch.ml.kv_offload import HostKVStore, OffloadConfig
from gofr_tpu_torch.ml.llm import LLMServer
from gofr_tpu_torch.models import llama as tllama

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
    for name in ("GOFR_ML_FAULT", "GOFR_ML_MAX_RESTARTS", "GOFR_ML_GOODPUT",
                 "GOFR_ML_AUTOPROF", "GOFR_ML_FLIGHT_RECORDER",
                 "GOFR_ML_JOURNEY", "GOFR_ML_DECODE_WINDOW",
                 "GOFR_ML_PIPELINE", "GOFR_ML_TOKEN_BUDGET",
                 "GOFR_ML_KV_HOST_BUDGET_MB"):
        monkeypatch.delenv(name, raising=False)


def _kw(kw):
    kw = dict(kw)
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("prefill_buckets", (8, 16))
    return kw


def _gen(pair, **kw):
    _, _, tcfg, tparams = pair
    return Generator(tparams, tcfg, device="cpu", **_kw(kw))


def _jgen(pair, **kw):
    jcfg, jparams, _, _ = pair
    return JGenerator(jparams, jcfg, **_kw(kw))


def _balanced(snap: dict) -> bool:
    return (snap["delivered"] + sum(snap["wasted"].values())
            == snap["device_tokens"])


def _both(pair, run, scenario, name: str, gen_kw=None, **server_kw):
    """``scenario(server)`` through the JAX server and the port's (each its
    own ledger under ``name``): (JAX ledger row, port ledger row, port
    generator)."""
    gen_kw = gen_kw or {}
    out = []
    for mod, srv, make in ((jgp, JLLMServer, _jgen), (tgp, LLMServer, _gen)):
        server = srv(make(pair, **gen_kw), name=name, **server_kw)
        try:
            run(scenario(server))
        finally:
            server.close()
        out.append(mod.goodput_ledger().snapshot_model(name))
    return out[0], out[1], server.gen


# -- the ledger, unit level --------------------------------------------------------

def _ledger_script(mod):
    led = mod.GoodputLedger()
    led.note("m", "delivered", 10)
    led.note("m", "spec_rejected", 3)
    led.note("m/0", "crashed", 2)
    led.note("m", "delivered", 0)
    try:
        led.note("m", "not_a_reason", 1)
        err = None
    except ValueError as exc:
        err = str(exc)
    led.handle("other").note("restore_fallback", 4)
    snaps = [led.snapshot_model("m"), led.snapshot_model("other"),
             led.snapshot()["fleet"]]
    for s in snaps:
        s.pop("delivered_per_s")
    return err, snaps, led.wasted_totals(), led.models()


def test_ledger_matches_jax():
    assert _ledger_script(tgp) == _ledger_script(jgp)
    assert tgp.WASTE_REASONS == jgp.WASTE_REASONS


def test_ledger_unit():
    led = tgp.GoodputLedger()
    led.note("m", "delivered", 10)
    led.note("m", "spec_rejected", 3)
    led.note("m/0", "crashed", 2)
    led.note("m", "delivered", 0)
    with pytest.raises(ValueError):
        led.note("m", "not_a_reason", 1)
    snap = led.snapshot_model("m")
    assert snap["device_tokens"] == 15 and snap["delivered"] == 10
    assert snap["wasted"] == {"spec_rejected": 3, "crashed": 2}
    assert _balanced(snap)
    assert snap["goodput"] == pytest.approx(10 / 15, abs=1e-4)
    led.handle("other").note("restore_fallback", 4)
    assert led.snapshot_model("other")["wasted"] == {"restore_fallback": 4}
    fleet = led.snapshot()["fleet"]
    assert fleet["device_tokens"] == 19 and _balanced(fleet)


def test_knob_defaults(monkeypatch):
    assert tgp.goodput_enabled() and tfr.autoprof_enabled()
    monkeypatch.setenv("GOFR_ML_GOODPUT", "0")
    monkeypatch.setenv("GOFR_ML_AUTOPROF", "0")
    assert not tgp.goodput_enabled() and not tfr.autoprof_enabled()
    assert tgp.goodput_ledger() is None
    assert jgp.goodput_ledger() is None  # the same knob, the same answer


# -- token fates, JAX against the port ---------------------------------------------

def test_delivered_end_to_end(pair, run):
    async def scenario(server):
        assert len(await server.generate([3, 1, 4, 1], 8)) == 8

    want, got, gen = _both(pair, run, scenario, "gp-ok")
    assert got["delivered"] == want["delivered"] == 8
    assert got["wasted"] == want["wasted"] == {}
    assert got["goodput"] == 1.0 and _balanced(got)
    assert gen.tokens_computed == got["device_tokens"]


def test_deadline_cancelled_mid_decode(pair, run):
    async def scenario(server):
        server.gen.fault = (lambda p: time.sleep(0.05) if p == "step"
                            else None)
        with pytest.raises(Exception) as ei:
            await server.generate([3, 1, 4], 50, deadline_s=0.3)
        assert type(ei.value).__name__ == "DeadlineExceeded"

    want, got, gen = _both(pair, run, scenario, "gp-dl")
    for snap in (want, got):
        assert snap["wasted"].get("deadline_cancelled", 0) >= 1
        assert snap["delivered"] == 0 and _balanced(snap)
    assert set(got["wasted"]) == set(want["wasted"])
    assert gen.tokens_computed == got["device_tokens"]


def test_disconnected_consumer(pair, run):
    async def scenario(server):
        agen = server.stream_chunks([3, 1, 4], 40)
        async for _burst in agen:
            break
        await agen.aclose()
        for _ in range(400):
            if server.gen.n_live == 0 and not server._active:
                break
            await asyncio.sleep(0.005)

    want, got, gen = _both(pair, run, scenario, "gp-bye")
    for snap in (want, got):
        assert snap["wasted"].get("disconnected", 0) >= 1
        assert snap["delivered"] == 0 and _balanced(snap)
    assert gen.tokens_computed == got["device_tokens"]


def test_crashed_slots(pair, run):
    """The first dispatch succeeds, the second raises: the slot's tokens
    are charged ``crashed`` — the same count as the JAX server's."""
    def scenario(server):
        fired = {"n": 0}

        def hook(point):
            if point == "step":
                fired["n"] += 1
                if fired["n"] > 1:
                    raise RuntimeError("injected mid-decode")

        server.gen.fault = hook

        async def go():
            with pytest.raises(Exception) as ei:
                await server.generate([3, 1, 4], 12)
            assert type(ei.value).__name__ == "GeneratorCrashed"
        return go()

    want, got, gen = _both(pair, run, scenario, "gp-boom",
                           gen_kw={"chunk": 2}, max_restarts=0)
    assert got["wasted"] == want["wasted"]
    assert got["wasted"]["crashed"] >= 1 and got["delivered"] == 0
    assert _balanced(got) and gen.tokens_computed == got["device_tokens"]


def test_restore_fallback_classification_points():
    """An over-budget reject in the host tier and the admission-race miss
    in the radix cache note the already-paid tokens, as in JAX."""
    from gofr_tpu_torch.ml.prefix_cache import RadixPrefixCache

    led = tgp.GoodputLedger()
    store = HostKVStore(OffloadConfig(budget_mb=1 / 1024))  # 1 KiB
    store.goodput = led.handle("kv")
    big = {"k": torch.zeros((4, 4, 64), dtype=torch.float32)}
    assert not store.put((1, 2, 3), big, {"len": 12, "tail": [],
                                          "ids_full": [1, 2, 3]})
    assert led.snapshot_model("kv")["wasted"] == {"restore_fallback": 12}
    cache = RadixPrefixCache.__new__(RadixPrefixCache)  # record_miss only
    cache._lock = threading.Lock()
    cache.misses = 0
    cache._metrics = None
    cache.goodput = led.handle("px")
    cache.record_miss(lost_tokens=8)
    assert led.snapshot_model("px")["wasted"] == {"restore_fallback": 8}
    assert cache.misses == 1


@pytest.fixture
def host_budget(monkeypatch):
    monkeypatch.setenv("GOFR_ML_KV_HOST_BUDGET_MB", "64")


def _spill_idle(server):
    """Spill every idle registered prefix to the host tier, on the serving
    thread (the generator's capacity-eviction path)."""
    gen = server.gen

    def work():
        return sum(bool(gen.drop_prefix(pid, spill=True))
                   for pid, info in list(gen._prefixes.items())
                   if info["refs"] == 0)

    return server._run_on_serving(work, 30, "spill")


def _restore_fault_scenario(server):
    """Promote a prefix, spill it, and serve it once restored and once
    through a ``restore`` fault that raises ``KeyError``: the tokens of
    each request and the prefix prefills paid."""
    prompt = [5, 9, 2, 7, 1, 4, 8, 3, 6, 6, 2]
    gen = server.gen
    fired = {"n": 0}

    def fault(point):
        if point == "restore" and not fired["n"]:
            fired["n"] = 1
            raise KeyError("injected restore fault")

    async def go():
        out = [await server.generate(prompt, 5) for _ in range(2)]
        assert await asyncio.to_thread(_spill_idle, server) >= 1
        out.append(await server.generate(prompt, 5))  # restored
        assert await asyncio.to_thread(_spill_idle, server) >= 1
        prefills = gen.prefix_prefills
        gen.fault = fault
        out.append(await server.generate(prompt, 5))  # the fallback
        gen.fault = None
        server.result = (out, gen.prefix_prefills - prefills,
                         gen.kv_restores, fired["n"])
    return go()


def test_restore_fault_charged_as_fallback_and_served_cold(pair, run,
                                                           host_budget):
    """A ``restore`` fault raising ``KeyError`` (the tier's lost-entry
    path): the offloaded prefix's tokens are charged ``restore_fallback``
    — as many as the JAX server charges — and the request is served with
    its prefix prefilled again, with the resident hit's tokens."""
    servers = []

    def scenario(server):
        servers.append(server)
        return _restore_fault_scenario(server)

    want, got, gen = _both(pair, run, scenario, "gp-restore",
                           gen_kw={"batch_slots": 1, "chunk": 2,
                                   "page_size": 4, "n_pages": 16})
    assert got["wasted"] == want["wasted"]
    assert got["wasted"]["restore_fallback"] > 0 and _balanced(got)
    (jout, *_), (tout, prefills, restores, fired) = \
        servers[0].result, servers[1].result
    assert tout == jout
    cold, hit, restored, fallback = tout
    assert restored == hit == fallback
    assert fired == 1 and prefills == 1 and restores == 1


def test_goodput_disabled_leaves_hot_path_untouched(pair, run, monkeypatch):
    exp = _gen(pair).generate([3, 1, 4], 6)
    monkeypatch.setenv("GOFR_ML_GOODPUT", "0")
    server = LLMServer(_gen(pair), name="gp-off")

    async def scenario():
        assert server._goodput is None and server.gen.goodput is None
        assert await server.generate([3, 1, 4], 6) == exp

    try:
        run(scenario())
    finally:
        server.close()
    assert tgp._LEDGER.snapshot_model("gp-off")["device_tokens"] == 0


def test_autoprof_disabled_leaves_hot_path_untouched(pair, run, monkeypatch):
    exp = _gen(pair).generate([3, 1, 4], 6)
    monkeypatch.setenv("GOFR_ML_AUTOPROF", "0")
    server = LLMServer(_gen(pair), name="ap-off")

    async def scenario():
        assert server.autoprof is None
        assert server.recorder is not None
        assert server.recorder.observer is None
        assert await server.generate([3, 1, 4], 6) == exp

    try:
        run(scenario())
    finally:
        server.close()


# -- the auto-profiler ---------------------------------------------------------------

def _fake_capture(calls):
    def capture(trace_dir, seconds):
        calls.append(seconds)
        with open(os.path.join(trace_dir, "trace.txt"), "w") as f:
            f.write("fake-trace")

    return capture


def _drain_captures(prof, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if prof.captures + prof.failures + prof.skipped_busy > 0:
            return
        time.sleep(0.01)


def _autoprof_script(mod, walls, phases_fn, **kw):
    """Feed ``walls`` through an AutoProfiler of ``mod``: the trigger, the
    capture count and the seconds asked of the capture."""
    calls: list = []
    prof = mod.AutoProfiler(model="ap-unit", vault=mod.ProfileVault(),
                            cooldown_s=60.0, capture_s=0.2, window=4,
                            baseline=16, min_baseline=8,
                            capture_fn=_fake_capture(calls), **kw)
    for w in walls:
        prof.observe(w, phases_fn(w))
    _drain_captures(prof)
    trigger = dict(prof.last_trigger or {})
    trigger.pop("at", None)
    return trigger, prof.captures, calls


def test_autoprof_triggers_like_jax():
    """The same step walls and phases trigger the same capture as JAX's
    auto-profiler: on the step's p50 and on a phase's share."""
    walls = [0.001] * 16 + [0.010] * 32
    assert _autoprof_script(tfr, walls, lambda w: {"launch": w},
                            multiplier=2.0) == \
        _autoprof_script(jfr, walls, lambda w: {"launch": w}, multiplier=2.0)
    walls = [0.002] * 24
    share = (lambda w, n=[0]: {"launch": w} if (n.__setitem__(0, n[0] + 1)
                                                or n[0] <= 16)
             else {"emit": w})
    share_j = (lambda w, n=[0]: {"launch": w} if (n.__setitem__(0, n[0] + 1)
                                                  or n[0] <= 16)
               else {"emit": w})
    got = _autoprof_script(tfr, walls, share, multiplier=100.0)
    want = _autoprof_script(jfr, walls, share_j, multiplier=100.0)
    assert got == want and got[0]["reason"] == "phase_share"


def test_autoprof_triggers_exactly_once_per_cooldown():
    vault = tfr.ProfileVault()
    calls: list = []
    prof = tfr.AutoProfiler(model="ap-unit", vault=vault, multiplier=2.0,
                            cooldown_s=60.0, capture_s=0.2, window=4,
                            baseline=16, min_baseline=8,
                            capture_fn=_fake_capture(calls))
    cursor = tfr.event_log().cursor
    for _ in range(16):
        prof.observe(0.001, {"launch": 0.001})
    for _ in range(12):
        prof.observe(0.010, {"launch": 0.010})
    _drain_captures(prof)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and not vault.list():
        time.sleep(0.01)
    assert prof.captures == 1 and prof.failures == 0
    bundles = vault.list()
    assert len(bundles) == 1 and bundles[0]["model"] == "ap-unit"
    assert bundles[0]["trigger"]["reason"] == "step_ms_p50"
    assert calls == [0.2]
    assert vault.get(bundles[0]["id"])["data"]
    events = tfr.event_log().query(since=cursor, kind="profile")["events"]
    assert len(events) == 1 and events[0]["model"] == "ap-unit"
    for _ in range(20):
        prof.observe(0.010, {"launch": 0.010})
    assert prof.captures == 1
    snap = prof.snapshot()
    assert snap["cooling_down"] and snap["last_trigger"] is not None


def test_autoprof_skips_while_the_profiler_is_held():
    """A trigger that finds ``PROFILE_LOCK`` held (a manual capture or an
    in-process measurement) is skipped and counted, never run."""
    calls: list = []
    prof = tfr.AutoProfiler(model="ap-busy", vault=tfr.ProfileVault(),
                            multiplier=2.0, cooldown_s=60.0, capture_s=0.1,
                            window=4, baseline=16, min_baseline=8,
                            capture_fn=_fake_capture(calls))
    with tfr.PROFILE_LOCK:
        for _ in range(16):
            prof.observe(0.001, {"launch": 0.001})
        for _ in range(8):
            prof.observe(0.010, {"launch": 0.010})
    assert prof.skipped_busy == 1 and prof.captures == 0 and calls == []


def test_autoprof_env_knobs_validated_as_jax(monkeypatch):
    for name, raw in (("GOFR_ML_AUTOPROF_MULT", "1.0"),
                      ("GOFR_ML_AUTOPROF_COOLDOWN_S", "-1"),
                      ("GOFR_ML_AUTOPROF_SECONDS", "lots")):
        with monkeypatch.context() as m:
            m.setenv(name, raw)
            with pytest.raises(ValueError) as want:
                jfr.AutoProfiler(model="x")
            with pytest.raises(ValueError) as got:
                tfr.AutoProfiler(model="x")
            assert str(got.value) == str(want.value)


def test_autoprof_serving_integration(pair, run):
    """Recorder commits feed the profiler through the serve loop, and a
    slowdown (a sleeping ``step`` hook) trips one capture."""
    server = LLMServer(_gen(pair), name="ap-live")
    assert server.autoprof is not None
    calls: list = []
    prof = tfr.AutoProfiler(model="ap-live", vault=tfr.ProfileVault(),
                            multiplier=3.0, cooldown_s=300.0, capture_s=0.1,
                            window=4, baseline=16, min_baseline=8,
                            capture_fn=_fake_capture(calls))
    server.autoprof = prof
    server.recorder.observer = prof.observe
    slow = {"on": False}
    server.gen.fault = (lambda p: time.sleep(0.03)
                        if slow["on"] and p == "step" else None)

    async def scenario():
        for _ in range(4):
            await server.generate([3, 1, 4], 8)
        slow["on"] = True
        for _ in range(4):
            await server.generate([3, 1, 4], 8)

    try:
        run(scenario())
        _drain_captures(prof)
    finally:
        server.close()
    assert prof.dispatches >= 24
    assert prof.captures == 1, prof.snapshot()
    snap = tgp.goodput_ledger().snapshot_model("ap-live")
    assert snap["delivered"] == 64 and _balanced(snap)


def test_profiler_capture_writes_a_chrome_trace(tmp_path):
    """The capture the auto-profiler and ``/debug/profile`` share is a
    ``torch.profiler`` run written as a Chrome trace, zipped whole."""
    tfr._capture_profile_trace(str(tmp_path), 0.05)
    data, truncated = tfr.zip_dir_bytes(str(tmp_path))
    assert not truncated and data[:2] == b"PK"
    assert (tmp_path / "trace.json").stat().st_size > 0


# -- the program inventory -----------------------------------------------------------

def test_programs_inventory_ladder_and_buckets(pair):
    gen = _gen(pair, chunk=4)
    gen.warmup()
    rows = {r["name"]: r for r in gen.programs.snapshot()}
    assert "prefill/b8" in rows and "prefill/b16" in rows
    assert rows["prefill/b8"]["kind"] == "prefill"
    gen.generate([3, 1, 4], 6)  # the CPU records decode shapes at first use
    rows = {r["name"]: r for r in gen.programs.snapshot()}
    assert "decode/chunk4" in rows and "decode/chunk1" in rows
    for row in rows.values():
        assert row["wall_s"] > 0 and row["cache"] == "none"
        assert row["cost"]["flops"] > 0 and row["cost"]["bytes_accessed"] > 0
    assert "cost" not in gen.programs.snapshot(cost=False)[0]
    totals = gen.programs.totals()
    assert totals["programs"] == len(rows) and totals["compile_s"] > 0
    gen.programs.record("decode/chunk4", wall_s=1.0, kind="eager")
    assert gen.programs.totals()["programs"] == len(rows)
    assert rows["decode/chunk4"]["warm_count"] >= 1


def test_programs_paged_widths_and_segment(pair):
    gen = _gen(pair, chunk=2, page_size=4, prefill_chunk=8, n_pages=32)
    gen.warmup()
    gen.generate(list(range(1, 20)), 4)
    names = {r["name"] for r in gen.programs.snapshot()}
    assert "prefill/segment8" in names
    assert any(n.startswith("decode/chunk2/cols") for n in names)


def test_programs_paged_ops_recorded(pair):
    """Twin of test_goodput.py::test_programs_paged_ops_recorded: the first
    spill's gather and the first restore's scatter are program rows."""
    store = HostKVStore(OffloadConfig(budget_mb=8))
    gen = _gen(pair, page_size=4, n_pages=16, host_kv=store)
    gen.warmup()
    pid = gen.register_prefix([5, 6, 7, 8, 9])
    assert gen.drop_prefix(pid, spill=True)
    gen.restore_prefix((5, 6, 7, 8, 9))
    names = {r["name"] for r in gen.programs.snapshot()}
    assert "paged/gather" in names and "paged/scatter" in names


def test_model_cost_counts_weights_and_keys(pair):
    from gofr_tpu_torch.ml.programs import model_cost

    _, _, tcfg, _ = pair
    one = model_cost(tcfg, 1, 1, 16)
    assert model_cost(tcfg, 2, 1, 16)["flops"] == 2 * one["flops"]
    assert model_cost(tcfg, 1, 2, 16)["bytes_accessed"] > one["bytes_accessed"]
    assert model_cost(tcfg, 1, 8, 8, prefill=True)["flops"] > one["flops"]


# -- the debug endpoints ----------------------------------------------------------------

def test_debug_endpoints(pair, run):
    async def scenario():
        app = App(config=MapConfig({"APP_NAME": "gp-app"}))
        ml = app._ensure_ml()
        gen = _gen(pair)
        gen.warmup()
        server = LLMServer(gen, name="gp-http")
        ml._llms["gp-http"] = server
        client = TestClient(TestServer(app._build_http_app()))
        await client.start_server()
        try:
            await server.generate([3, 1, 4], 6)
            resp = await client.get("/debug/goodput")
            assert resp.status == 200
            data = (await resp.json())["data"]
            assert data["enabled"]
            assert data["models"]["gp-http"]["delivered"] == 6
            assert _balanced(data["fleet"])
            resp = await client.get("/debug/serving")
            body = (await resp.json())["data"]
            entry = body["llms"]["gp-http"]
            assert entry["goodput"]["delivered"] == 6
            assert "autoprof" in entry and "stalls" in entry
            hbm = body["hbm"]
            assert all(v == "unsupported" for v in hbm["devices"].values())
            assert hbm["fallback"] == "host_rss" and hbm["host_rss_bytes"] > 0
            assert body["runtime"]["torch"] == torch.__version__
            assert body["runtime"]["devices"]["count"] >= 1
            resp = await client.get("/debug/programs")
            progs = (await resp.json())["data"]
            names = {r["name"] for r in progs["models"]["gp-http"]["entries"]}
            assert any(n.startswith("decode/chunk") for n in names)
            resp = await client.get("/debug/profile/auto")
            body = (await resp.json())["data"]
            assert body["enabled"] is True
            assert isinstance(body["captures"], list)
            resp = await client.get("/debug/profile/auto/nope-1")
            assert resp.status == 404
            pid = tfr.profile_vault().capture(
                model="gp-http", trigger={"reason": "step_ms_p50"},
                data=b"PK\x05\x06" + b"\0" * 18)
            resp = await client.get(f"/debug/profile/auto/{pid}")
            assert resp.status == 200
            assert resp.content_type == "application/zip"
            resp = await client.get("/debug/capture")
            assert (await resp.json())["data"]["enabled"] is False
        finally:
            await client.close()
            server.close()

    run(scenario())


def test_profile_route_answers_409_while_a_capture_runs(pair, run):
    """One capture at a time, process-wide: ``/debug/profile`` answers 409
    while the profiler lock is held, and zips a capture once it is free."""
    async def scenario():
        app = App(config=MapConfig({"APP_NAME": "gp-prof"}))
        client = TestClient(TestServer(app._build_http_app()))
        await client.start_server()
        try:
            with tfr.PROFILE_LOCK:
                r = await client.get("/debug/profile",
                                     params={"seconds": "0.1"})
                assert r.status == 409
            r = await client.get("/debug/profile", params={"seconds": "0.1"})
            assert r.status == 200
            assert r.content_type == "application/zip"
            assert (await r.read())[:2] == b"PK"
            assert not tfr.PROFILE_LOCK.locked()
        finally:
            await client.close()

    run(scenario())


def test_metrics_export_wasted_and_goodput_fraction(pair, run):
    """The sampler publishes ``app_llm_tokens_wasted_total{model,reason}``
    as deltas of the ledger and ``app_llm_goodput_fraction``."""
    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.ml import MLDatasource

    c = Container(MapConfig({"APP_NAME": "gp-metrics"}))
    c.register_framework_metrics()
    ml = MLDatasource(metrics=c.metrics_manager)
    server = ml.register_llm("gp-met", None, None, generator=_gen(
        pair, chunk=2), max_restarts=0)
    fired = {"n": 0}

    def hook(point):
        if point == "step":
            fired["n"] += 1
            if fired["n"] == 3:
                raise RuntimeError("injected")

    server.gen.fault = hook

    async def scenario():
        with pytest.raises(GeneratorCrashed):
            await server.generate([3, 1, 4], 12)

    try:
        run(scenario())
    finally:
        server.close()
    text = c.metrics_manager.expose_text()
    crashed = tgp.goodput_ledger().snapshot_model("gp-met")["wasted"][
        "crashed"]
    assert (f'app_llm_tokens_wasted_total{{model="gp-met",'
            f'reason="crashed"}} {crashed}') in text
    assert 'app_llm_goodput_fraction{model="gp-met"} 0' in text
    assert 'app_ml_programs{model="gp-met"}' in text
    assert DeadlineExceeded is not None
