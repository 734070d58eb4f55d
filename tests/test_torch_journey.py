"""PyTorch port, request journeys (``ml/journey.py``), held against the
JAX package's (CPU, the tiny model at f32, the JAX weights carried across
with ``params_from_jax``).

Twins of ``tests/test_journey.py``, less the replica pool's one-timeline
test (ROADMAP A.14) and the speculation half of the chunked-prefill one
(in ``test_torch_spec_serving.py``): marks tile the wall and fold past
their bound; tail sampling keeps
failures and the p99-slow; the knob; a chunked-prefill request's
waterfall; a deadline-reaped request retained with its reason; the
request↔dispatch cross-link both ways; ``GOFR_ML_JOURNEY=0`` leaves the
hot path and the tokens untouched; a crash bundle carries the victims'
journeys; ``/debug/requests`` and ``/debug/events`` filters. The unit
scripts and a served request give the same marks as the JAX module's.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from gofr_tpu.ml import journey as jjr
from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.ml.llm import LLMServer as JLLMServer
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch.app import App
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.flight_recorder import crash_vault, event_log
from gofr_tpu_torch.ml import journey as tjr
from gofr_tpu_torch.ml.errors import DeadlineExceeded, GeneratorCrashed
from gofr_tpu_torch.ml.generate import Generator
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
    for name in ("GOFR_ML_FAULT", "GOFR_ML_MAX_RESTARTS", "GOFR_ML_JOURNEY",
                 "GOFR_ML_FLIGHT_RECORDER", "GOFR_ML_DECODE_WINDOW",
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


def _assert_tiles(waterfall: dict) -> None:
    """Marks sum to the request wall, no segment is negative, and the
    record is sealed with a finish reason."""
    marks = waterfall["marks"]
    assert waterfall["done"] and waterfall["finish_reason"] is not None
    assert all(m["dur_s"] >= 0.0 for m in marks)
    total = sum(m["dur_s"] for m in marks)
    assert total == pytest.approx(waterfall["wall_s"], abs=1e-5)
    assert marks[-1]["mark"] in ("finish", "other")


def _shape(waterfall: dict) -> list:
    """A waterfall without its clock: the marks and their data."""
    return [{k: v for k, v in m.items() if k not in ("t_s", "dur_s")}
            for m in waterfall["marks"] if m["mark"] != "other"]


# -- unit level ----------------------------------------------------------------------

def _journey_script(mod):
    j = mod.Journey("r-unit", model="m", trace_id="t")
    for i in range(3 * mod.MAX_MARKS):
        j.mark("decode", tokens=2, dispatch=i + 1)
    j.note(tokens=6)
    sealed = (j.finish("stop"), j.finish("length"))
    j.mark("decode", tokens=9)
    snap = j.snapshot()
    return sealed, snap["finish_reason"], snap["request"], _shape(snap)


def test_journey_matches_jax():
    assert _journey_script(tjr) == _journey_script(jjr)
    assert tjr.MAX_MARKS == jjr.MAX_MARKS
    assert tjr.FAILURE_REASONS == jjr.FAILURE_REASONS


def test_journey_marks_tile_wall_and_bound():
    j = tjr.Journey("r-unit", model="m")
    for i in range(3 * tjr.MAX_MARKS):
        j.mark("decode", tokens=2, dispatch=i + 1)
    assert j.finish("stop")
    assert not j.finish("length")
    snap = j.snapshot()
    _assert_tiles(snap)
    assert snap["finish_reason"] == "stop"
    assert len(snap["marks"]) <= tjr.MAX_MARKS + 1
    decoded = sum(m.get("tokens", 0) for m in snap["marks"]
                  if m["mark"] == "decode")
    assert decoded == 6 * tjr.MAX_MARKS
    folded = [m for m in snap["marks"] if m.get("folded")]
    assert folded and folded[-1]["dispatch"] == 3 * tjr.MAX_MARKS
    j.mark("decode", tokens=9)
    assert j.snapshot()["marks"] == snap["marks"]


def _tail_sampling_script(mod):
    log = mod.JourneyLog(capacity=16)

    def ok(rid: str, wall: float) -> None:
        j = mod.Journey(rid, model="m")
        log.start(j)
        j.finish("stop")
        j.wall_s = wall
        log.finish(j)

    failed = mod.Journey("r-fail", model="m")
    log.start(failed)
    failed.finish("deadline")
    log.finish(failed)
    for i in range(40):
        ok(f"r-ok-{i}", 0.001)
    slow = mod.Journey("r-slow", model="m")
    log.start(slow)
    slow.finish("stop")
    slow.wall_s = 99.0
    log.finish(slow)
    for i in range(40, 60):
        ok(f"r-ok-{i}", 0.001)
    snap = log.snapshot()
    return ([log.get(r) is not None for r in ("r-ok-0", "r-fail", "r-slow")],
            snap["retained"], snap["started"], snap["finished"],
            [(e["rid"], e["failed"], e["finish_reason"])
             for e in snap["exemplars"]], snap["recent_rids"],
            snap["finish_reasons"])


def test_journey_log_tail_sampling_matches_jax():
    got = _tail_sampling_script(tjr)
    assert got == _tail_sampling_script(jjr)
    assert got[0] == [False, True, True] and got[1] == 16


def test_journeys_enabled_knob(monkeypatch):
    assert tjr.journeys_enabled() and tjr.journey_log() is not None
    monkeypatch.setenv("GOFR_ML_JOURNEY", "0")
    assert not tjr.journeys_enabled() and tjr.journey_log() is None
    monkeypatch.setenv("GOFR_ML_JOURNEY", "64")
    assert tjr._ring_size() == jjr._ring_size() == 64


def test_rids_are_process_unique():
    rids = {tjr.next_rid() for _ in range(1000)}
    assert len(rids) == 1000 and all(r.startswith("r") for r in rids)


# -- serving, live -------------------------------------------------------------------

def test_sum_to_wall_under_chunked_prefill(pair, run):
    """A prompt long enough to chunk its prefill still yields a waterfall
    whose marks sum to the wall, with the JAX server's marks."""
    prompt = list(range(1, 21))  # > the largest bucket: chunked prefill
    kw = dict(batch_slots=1, page_size=4, chunk=2, prefill_chunk=8,
              n_pages=32)
    out = []
    for srv, make, mod, name in ((JLLMServer, _jgen, jjr, "jr-prop-j"),
                                 (LLMServer, _gen, tjr, "jr-prop")):
        server = srv(make(pair, **kw), name=name)

        async def scenario(server=server):
            return await server.generate(prompt, 8)

        try:
            tokens = run(scenario())
        finally:
            server.close()
        rid = mod.journey_log().snapshot()["recent_rids"][-1]
        out.append((tokens, mod.journey_log().get(rid).snapshot()))
    (jtok, jw), (ttok, tw) = out
    assert ttok == jtok and len(ttok) == 8
    assert tw["model"] == "jr-prop"
    _assert_tiles(tw)
    names = [m["mark"] for m in tw["marks"]]
    assert "admit" in names and "prefill" in names and "decode" in names
    assert tw["request"]["tokens"] == 8
    strip = (lambda w: [{k: v for k, v in m.items()
                         if k not in ("dispatch", "inflight")}
                        for m in _shape(w)])
    assert strip(tw) == strip(jw)


def test_failed_request_retained_with_reason(pair, run):
    cursor = event_log().cursor
    server = LLMServer(_gen(pair, batch_slots=1), name="jr-dead")

    async def scenario():
        hog = asyncio.create_task(server.generate([9, 9], 30))
        await asyncio.sleep(0.05)
        with pytest.raises(DeadlineExceeded):
            await server.generate([1, 2, 3], 4, deadline_s=0.001)
        await hog

    try:
        run(scenario())
    finally:
        server.close()
    ev = event_log().query(since=cursor, model="jr-dead",
                           kind="deadline")["events"]
    assert ev and ev[-1]["rid"]
    waterfall = tjr.journey_log().get(ev[-1]["rid"]).snapshot()
    assert waterfall["finish_reason"] == "deadline"
    _assert_tiles(waterfall)
    ex = {e["rid"] for e in tjr.journey_log().snapshot()["exemplars"]}
    assert ev[-1]["rid"] in ex


def test_dispatch_request_crosslink(pair, run):
    server = LLMServer(_gen(pair), name="jr-xlink")

    async def scenario():
        await server.generate([3, 1, 4], 6)

    try:
        run(scenario())
    finally:
        server.close()
    rid = tjr.journey_log().snapshot()["recent_rids"][-1]
    waterfall = tjr.journey_log().get(rid).snapshot()
    seqs = {m["dispatch"] for m in waterfall["marks"] if "dispatch" in m}
    assert seqs
    by_seq = {r["seq"]: r for r in server.recorder.tail(64)}
    linked = [by_seq[s] for s in seqs if s in by_seq]
    assert linked and any(rid in r.get("rids", ()) for r in linked)


def test_journeys_disabled_leaves_hot_path_untouched(pair, run, monkeypatch):
    exp = _gen(pair).generate([3, 1, 4], 6)
    monkeypatch.setenv("GOFR_ML_JOURNEY", "0")
    server = LLMServer(_gen(pair), name="jr-off")

    async def scenario():
        assert server._journeys is None
        assert await server.generate([3, 1, 4], 6) == exp

    try:
        run(scenario())
    finally:
        server.close()
    assert all("rids" not in r for r in server.recorder.tail(64))


def test_crash_bundle_carries_victim_journeys(pair, run):
    server = LLMServer(_gen(pair), name="jr-crash", max_restarts=0)
    fired = {"n": 0}

    def hook(point):
        if point == "step":
            fired["n"] += 1
            if fired["n"] > 1:
                raise RuntimeError("injected mid-decode")

    server.gen.fault = hook

    async def scenario():
        with pytest.raises(GeneratorCrashed):
            await server.generate([3, 1, 4], 12)

    try:
        run(scenario())
    finally:
        server.close()
    mine = [c for c in crash_vault().list() if c["model"] == "jr-crash"]
    assert mine
    bundle = crash_vault().get(mine[-1]["id"])
    journeys = bundle["state"]["journeys"]
    assert len(journeys) == 1
    assert journeys[0]["rid"] == bundle["state"]["slots"][0]["rid"]
    assert any(m["mark"] == "admit" for m in journeys[0]["marks"])
    assert bundle["state"]["dispatches"]
    victim = tjr.journey_log().get(journeys[0]["rid"]).snapshot()
    assert victim["finish_reason"] == "crashed"
    _assert_tiles(victim)


def test_served_marks_match_jax(pair, run):
    """The same request through both servers leaves the same sequence of
    marks with the same token counts (dispatch seqs and depths aside)."""
    shapes = []
    for srv, make, mod, name in ((JLLMServer, _jgen, jjr, "jr-par-j"),
                                 (LLMServer, _gen, tjr, "jr-par-t")):
        server = srv(make(pair, chunk=2), name=name)

        async def scenario(server=server):
            await server.generate([3, 1, 4, 1, 5], 7)

        try:
            run(scenario())
        finally:
            server.close()
        rid = mod.journey_log().snapshot()["recent_rids"][-1]
        w = mod.journey_log().get(rid).snapshot()
        shapes.append([{k: v for k, v in m.items()
                        if k not in ("dispatch", "inflight")}
                       for m in _shape(w)])
    assert shapes[1] == shapes[0]


# -- debug endpoints -----------------------------------------------------------------

def test_debug_requests_endpoints(pair, run):
    async def scenario():
        app = App(config=MapConfig({"APP_NAME": "jr-app"}))
        ml = app._ensure_ml()
        server = LLMServer(_gen(pair), name="jr-http")
        ml._llms["jr-http"] = server
        client = TestClient(TestServer(app._build_http_app()))
        await client.start_server()
        try:
            cursor = event_log().cursor
            await server.generate([3, 1, 4], 5)
            r = await client.get("/debug/requests")
            body = (await r.json())["data"]
            assert body["enabled"] and body["finished"] >= 1
            assert "admit" in body["marks"] and "wall" in body
            rid = body["recent_rids"][-1]
            r = await client.get(f"/debug/requests/{rid}")
            assert r.status == 200
            waterfall = (await r.json())["data"]
            assert waterfall["rid"] == rid
            _assert_tiles(waterfall)
            r = await client.get("/debug/requests/no-such-rid")
            assert r.status == 404
            r = await client.get(
                "/debug/events",
                params=[("kind", "admit,deadline"), ("kind", "shed"),
                        ("since", str(cursor))])
            body = (await r.json())["data"]
            assert "dropped" in body
            assert {e["kind"] for e in body["events"]} <= {
                "admit", "deadline", "shed"}
            r = await client.get("/debug/events",
                                 params={"rid": rid, "since": str(cursor)})
            evs = (await r.json())["data"]["events"]
            assert evs and all(e["rid"] == rid for e in evs)
        finally:
            await client.close()
            server.close()

    run(scenario())


def test_debug_requests_disabled(pair, run, monkeypatch):
    monkeypatch.setenv("GOFR_ML_JOURNEY", "0")

    async def scenario():
        app = App(config=MapConfig({"APP_NAME": "jr-off-app"}))
        client = TestClient(TestServer(app._build_http_app()))
        await client.start_server()
        try:
            r = await client.get("/debug/requests")
            assert (await r.json())["data"] == {
                "enabled": False, "reason": "GOFR_ML_JOURNEY=0"}
            r = await client.get("/debug/requests/r1")
            assert r.status == 404
        finally:
            await client.close()

    run(scenario())


def test_pool_request_is_one_timeline(pair, run):
    """A replica-pool request keeps ONE journey across the fleet hop and
    the core hop: route, admit, prefill, decode and finish in a single
    record, the rid on the route and admit events, the trace id attached,
    and ``app_ml_journeys_total`` labelled with the POOL name though a
    core sealed it. The marks are the JAX pool's, in order."""
    from gofr_tpu.ml.replica import ReplicaPool as JReplicaPool
    from gofr_tpu_torch.ml.replica import ReplicaPool
    from gofr_tpu_torch.tracing import Tracer

    counts: dict = {}

    class _Metrics:
        def add_counter(self, name, delta, **labels):
            key = (name, labels.get("model"), labels.get("reason"))
            counts[key] = counts.get(key, 0) + delta

        def set_gauge(self, name, value, **labels):
            pass

        def record_histogram(self, name, value, **labels):
            pass

    class _Tracer(Tracer):
        def __init__(self) -> None:
            super().__init__("test", None, 1.0)

        def _on_end(self, span) -> None:
            pass

    tracer = _Tracer()
    cursor = event_log().cursor
    pool = ReplicaPool([_gen(pair), _gen(pair)], name="jr-pool",
                       tracer=tracer, metrics=_Metrics())
    jpool = JReplicaPool([_jgen(pair), _jgen(pair)], name="jr-jpool")

    async def scenario():
        with tracer.start_span("req") as root:
            out = await pool.generate([3, 1, 4, 1, 5], 5)
        jout = await jpool.generate([3, 1, 4, 1, 5], 5)
        assert out == jout and len(out) == 5
        return root

    try:
        root = run(scenario())
    finally:
        pool.close()
        jpool.close()
    routes = [e for e in event_log().query(
        since=cursor, kind="route")["events"] if e["model"] == "jr-pool"]
    assert routes and routes[-1]["rid"]
    rid = routes[-1]["rid"]
    assert routes[-1]["trace"] == root.trace_id
    admits = [e for e in event_log().query(
        since=cursor, kind="admit")["events"] if e.get("rid") == rid]
    assert admits and admits[0]["model"].startswith("jr-pool/")
    waterfall = tjr.journey_log().get(rid).snapshot()
    assert waterfall["trace_id"] == root.trace_id
    _assert_tiles(waterfall)
    names = [m["mark"] for m in waterfall["marks"]]
    assert names[0] == "route" and "admit" in names
    route = waterfall["marks"][0]
    assert route["reason"] in ("affinity", "least_loaded")
    assert route["replica"] in (0, 1)
    assert counts.get(("app_ml_journeys_total", "jr-pool", "length")) == 1
    assert not any(name == "app_ml_journeys_total" and model != "jr-pool"
                   for name, model, _ in counts)
    jlog = jjr.journey_log()
    jrid = next(r for r in reversed(jlog.snapshot()["recent_rids"])
                if jlog.get(r) is not None and jlog.get(r).model == "jr-jpool")
    jnames = [m["mark"] for m in jlog.get(jrid).snapshot()["marks"]]
    assert [n for n in names if n != "other"] == \
        [n for n in jnames if n != "other"]
