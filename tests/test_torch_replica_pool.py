"""PyTorch port, the replica pool (``ml/replica.py``): the twin of
``tests/test_replica_pool.py``, held against the JAX package at f32 on
the CPU.

The same tiny Llama (weights drawn by the JAX package and bridged with
``llama.params_from_jax``) serves through a port ``ReplicaPool`` of
port Generators; every greedy output must equal the JAX package's
single-replica output token for token, and the pool's routing, failover,
fleet admission, drain and observability contracts are JAX's. The pool
itself is also held against a JAX ``ReplicaPool`` on the same prompts.
Tolerance: tokens are compared exactly.
"""

import asyncio
import concurrent.futures
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.ml.replica import ReplicaPool as JReplicaPool
from gofr_tpu.ml.replica import \
    build_replica_generators as jbuild_replica_generators
from gofr_tpu_torch import parallel as par
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch.app import App
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.ml import MLDatasource
from gofr_tpu_torch.ml.errors import (DeadlineExceeded, GeneratorCrashed,
                                      Overloaded, ServerClosed)
from gofr_tpu_torch.ml.generate import Generator
from gofr_tpu_torch.ml.llm import LLMServer, drain_s_from_env
from gofr_tpu_torch.ml.prefix_cache import PrefixCacheConfig
from gofr_tpu_torch.ml.replica import (ReplicaPool, build_replica_generators,
                                       replicas_from_env, split_devices)
from gofr_tpu_torch.models import llama as tllama
from gofr_tpu_torch.testutil.faults import FaultInjector
from gofr_tpu_torch.tracing import Tracer

pytestmark = pytest.mark.timeout(300)

CPU = torch.device("cpu")
PROMPTS = [[5, 9, 2, 7], [3, 1], [8, 6, 4], [2, 2, 9, 1]]


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX params, port cfg, port params, memo of JAX outputs):
    the JAX package draws the weights; the port runs them bridged."""
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(int(rng.integers(0, 2**31)))
    jcfg = jllama.tiny_llama(dtype=jnp.float32, use_flash=False)
    jparams = jllama.init_params(jcfg, key)
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams, {}


def _gen(model, **kw):
    _, _, cfg, params, _ = model
    kw.setdefault("batch_slots", 1)
    kw.setdefault("max_seq", 64)
    kw.setdefault("prefill_buckets", (8, 16))
    return Generator(params, cfg, device="cpu", **kw)


def _jgen(model, **kw):
    cfg, params = model[0], model[1]
    kw.setdefault("batch_slots", 1)
    kw.setdefault("max_seq", 64)
    kw.setdefault("prefill_buckets", (8, 16))
    return JGenerator(params, cfg, **kw)


def _expected(model, prompt, n):
    """The JAX package's single-replica greedy output (one JAX Generator
    a module, reused)."""
    memo = model[4]
    key = (tuple(prompt), n)
    if key not in memo:
        if "gen" not in memo:
            memo["gen"] = _jgen(model)
        memo[key] = memo["gen"].generate(list(prompt), n)
    return memo[key]


def _fail_after(point: str, ok: int):
    """Chaos hook: let the point fire ``ok`` times, then raise forever."""
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


# ------------------------------------------------------------ construction
@pytest.mark.parametrize("reader", ["replicas", "drain"])
def test_env_readers_fail_loudly(reader, monkeypatch):
    """``GOFR_ML_REPLICAS`` and ``GOFR_ML_DRAIN_S`` parse as JAX's: a
    malformed value is a startup error with JAX's message."""
    from gofr_tpu.ml import llm as jllm
    from gofr_tpu.ml import replica as jreplica

    if reader == "replicas":
        assert replicas_from_env() == 1 and replicas_from_env(3) == 3
        monkeypatch.setenv("GOFR_ML_REPLICAS", "2")
        assert replicas_from_env() == 2
        bad, ours, theirs = (("zero", "0", "-1"), replicas_from_env,
                             jreplica.replicas_from_env)
        knob = "GOFR_ML_REPLICAS"
    else:
        monkeypatch.delenv("GOFR_ML_DRAIN_S", raising=False)
        assert drain_s_from_env() == 0.0
        monkeypatch.setenv("GOFR_ML_DRAIN_S", "2.5")
        assert drain_s_from_env() == 2.5
        bad, ours, theirs = (("5s", "-30", "nan", "inf"), drain_s_from_env,
                             jllm.drain_s_from_env)
        knob = "GOFR_ML_DRAIN_S"
    for raw in bad:
        monkeypatch.setenv(knob, raw)
        with pytest.raises(ValueError) as want:
            theirs()
        with pytest.raises(ValueError) as got:
            ours()
        assert str(got.value) == str(want.value)


def test_split_devices():
    """JAX's partition (contiguous subsets; round-robin past the device
    count), over ``torch.device``s; no card and no devices raises."""
    from gofr_tpu.ml.replica import split_devices as jsplit

    devs = [torch.device("cuda", i) for i in range(8)]
    names = list("abcdefgh")
    for n in (1, 2, 3, 8):
        got = [[d.index for d in s] for s in split_devices(n, devs)]
        want = [[names.index(x) for x in s] for s in jsplit(n, names)]
        assert got == want
    assert split_devices(3, [CPU]) == [[CPU], [CPU], [CPU]]
    with pytest.raises(ValueError):
        split_devices(0, devs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            split_devices(2)


def test_replicas_on_one_device_share_the_weights(model):
    """Replicas that land on the same device share the weight tensors (no
    copy, as JAX's ``device_put`` onto their own device); each owns its
    cache and page pool. An explicit ``sp=`` on a one-device replica
    raises JAX's error. A replica over several devices without SP is
    tensor-parallel (JAX's ``build_replica_generators``): its weights are
    views of the shared ones, split by ``SHARDING_RULES``, and its greedy
    output equals JAX's tensor-parallel replica's."""
    jcfg, jparams, cfg, params, _ = model
    gens = build_replica_generators(params, cfg, 2, warmup=False,
                                    devices=[CPU], batch_slots=1,
                                    max_seq=64, prefill_buckets=(8,),
                                    page_size=4, n_pages=16)
    assert gens[0].params is params and gens[1].params is params
    assert gens[0].cache["k"].data_ptr() != gens[1].cache["k"].data_ptr()
    with pytest.raises(ValueError, match="owns a single device"):
        build_replica_generators(params, cfg, 1, devices=[CPU], sp=True)
    kw = dict(warmup=False, batch_slots=1, max_seq=64, prefill_buckets=(8,))
    (tp_gen,) = build_replica_generators(params, cfg, 1,
                                         devices=[CPU, CPU], **kw)
    wq = tp_gen.params["layers"]["wq"]
    assert isinstance(wq, par.ShardedTensor) and wq.n == 2
    assert wq.shards[0].data_ptr() == params["layers"]["wq"].data_ptr()
    assert isinstance(tp_gen.cache["k"], par.ShardedTensor)
    (jgen,) = jbuild_replica_generators(jparams, jcfg, 1,
                                        devices=jax.devices()[:2], **kw)
    assert tp_gen.generate([5, 9, 2, 7], 8) == jgen.generate([5, 9, 2, 7], 8)


def test_fault_per_replica_arming(monkeypatch):
    from gofr_tpu.testutil.faults import FaultInjector as JFaultInjector

    monkeypatch.setenv("GOFR_ML_FAULT", "step:1")
    monkeypatch.setenv("GOFR_ML_FAULT_REPLICA", "1")
    assert FaultInjector.from_env_for_replica(0) is None
    inj = FaultInjector.from_env_for_replica(1)
    assert inj is not None and "step" in inj.points
    assert inj.seed == JFaultInjector.from_env_for_replica(1).seed
    monkeypatch.delenv("GOFR_ML_FAULT_REPLICA")
    a, b = (FaultInjector.from_env_for_replica(i) for i in (0, 1))
    assert a is not None and b is not None and a.seed != b.seed
    monkeypatch.setenv("GOFR_ML_FAULT_REPLICA", "not-an-idx")
    with pytest.raises(ValueError):
        FaultInjector.from_env_for_replica(0)


def test_register_llm_single_replica_passthrough(model, monkeypatch):
    monkeypatch.delenv("GOFR_ML_REPLICAS", raising=False)
    ml = MLDatasource()
    server = ml.register_llm("chat", None, None, generator=_gen(model))
    assert isinstance(server, LLMServer)
    server.close()
    monkeypatch.setenv("GOFR_ML_REPLICAS", "1")
    server = ml.register_llm("chat2", None, None, generator=_gen(model))
    assert isinstance(server, LLMServer)
    server.close()
    monkeypatch.setenv("GOFR_ML_REPLICAS", "2")
    gen = _gen(model)
    with pytest.raises(ValueError, match="replicas requested"):
        ml.register_llm("chat3", None, None, generator=gen)
    monkeypatch.delenv("GOFR_ML_REPLICAS")
    with pytest.raises(ValueError, match="replicas must be >= 1"):
        ml.register_llm("chat4", None, None, generator=gen, replicas=0)


def test_register_llm_env_replicas_builds_pool(model, monkeypatch, run):
    monkeypatch.setenv("GOFR_ML_REPLICAS", "2")
    _, _, cfg, params, _ = model
    ml = MLDatasource()
    # built from (params, cfg): two replicas on the one device, sharing
    # the weights, each warmed up
    pool = ml.register_llm("chat", params, cfg, device="cpu",
                           batch_slots=1, max_seq=64,
                           prefill_buckets=(8, 16))
    assert isinstance(pool, ReplicaPool)
    assert ml.llm("chat") is pool
    assert pool.replicas[0].gen.params is pool.replicas[1].gen.params

    async def scenario():
        out = await pool.generate([3, 1], 4)
        assert out == _expected(model, [3, 1], 4)
        snap = ml.serving_snapshot()["llms"]["chat"]
        assert set(snap["replicas"]) == {"0", "1"}
        for row in snap["replicas"].values():
            assert "pool" in row and "resilience" in row
        assert snap["routing"]["replicas"] == 2
        assert snap["state"] == "serving"
        assert set(ml.programs_snapshot()["models"]) >= {"chat/0", "chat/1"}

    try:
        run(scenario())
    finally:
        pool.close()


# ----------------------------------------------------------------- routing
def test_pool_bit_identical_and_balanced(model, run):
    """Concurrent requests spread across both replicas; every output
    equals the JAX single replica's and the JAX pool's on the same
    prompts."""
    expects = [_expected(model, p, 6) for p in PROMPTS]
    pool = ReplicaPool([_gen(model), _gen(model)], name="chat")
    jpool = JReplicaPool([_jgen(model), _jgen(model)], name="jchat")

    async def scenario():
        outs = await asyncio.gather(*(pool.generate(p, 6) for p in PROMPTS))
        jouts = await asyncio.gather(*(jpool.generate(p, 6)
                                       for p in PROMPTS))
        assert outs == expects == jouts
        snap = pool.routing_snapshot()
        assert all(sum(c.values()) >= 1 for c in snap["routed"].values())
        assert pool.health() == "serving"
        assert pool.served == 4
        jsnap = jpool.routing_snapshot()
        assert set(snap) == set(jsnap)

    try:
        run(scenario())
    finally:
        pool.close()
        jpool.close()


def test_cache_affinity_routing_and_dead_holder_fallback(model, run):
    gens = [_gen(model, page_size=4, chunk=2) for _ in range(2)]
    pool = ReplicaPool(gens, name="chat", max_restarts=0,
                       prefix_cache=PrefixCacheConfig(promote_hits=1))
    base = [7, 3, 9, 1, 4, 2, 8, 5]
    follow = base + [6, 6]

    async def scenario():
        exp = _expected(model, follow, 4)
        await pool.generate(base, 4)
        holder = max(range(2), key=lambda i: (
            pool.replicas[i].prefix_cache.peek(follow)[1]))
        out = await pool.generate(follow, 4)
        assert out == exp
        snap = pool.routing_snapshot()
        assert snap["routed"][str(holder)].get("affinity", 0) >= 1
        pool.replicas[holder].gen.fault = _fail_after("step", 0)
        with pytest.raises(GeneratorCrashed):
            await pool.replicas[holder].generate([1, 2], 2)
        assert pool.replicas[holder].health() == "dead"
        assert await pool.generate(follow, 4) == exp
        assert pool.health() == "degraded"

    try:
        run(scenario())
    finally:
        pool.close()


def test_explicit_prefix_pin_fleet_wide(model, run):
    gens = [_gen(model, batch_slots=2, page_size=8) for _ in range(2)]
    pool = ReplicaPool(gens, name="chat")
    prefix = list(range(1, 9))

    async def scenario():
        pid = await asyncio.to_thread(pool.register_prefix, prefix)
        assert pool.has_prefix(pid)
        for core in pool.replicas:
            assert core.prefix_cache.peek(prefix + [30])[0] is not None
        exp = _expected(model, prefix + [30, 31], 4)
        outs = await asyncio.gather(
            *(pool.generate([30, 31], 4, prefix=pid) for _ in range(3)))
        assert all(o == exp for o in outs)
        snap = pool.routing_snapshot()
        assert sum(c.get("affinity", 0)
                   for c in snap["routed"].values()) >= 3
        await asyncio.to_thread(pool.drop_prefix, pid)
        assert not pool.has_prefix(pid)
        with pytest.raises(KeyError):
            pool.drop_prefix(pid)

    try:
        run(scenario())
    finally:
        pool.close()


def test_pool_concurrent_event_loops(model):
    expects = [_expected(model, p, 6) for p in PROMPTS]
    pool = ReplicaPool([_gen(model), _gen(model)], name="chat")

    def drive(mine):
        async def scenario():
            return await asyncio.wait_for(
                asyncio.gather(*(pool.generate(p, 6) for p in mine)),
                timeout=120)

        return asyncio.run(scenario())

    try:
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            futs = [ex.submit(drive, PROMPTS[:2]),
                    ex.submit(drive, PROMPTS[2:])]
            outs = [o for f in futs for o in f.result(timeout=180)]
        assert outs == expects
        assert pool.served == 4
        snap = pool.routing_snapshot()
        assert snap["outstanding"] == [0, 0]
        assert snap["queued"] == 0
    finally:
        pool.close()


def test_pool_accepts_plain_callable_fault(model, run):
    seen: list[str] = []
    pool = ReplicaPool([_gen(model), _gen(model)], name="chat",
                       fault=seen.append)

    async def scenario():
        out = await pool.generate([3, 1], 4)
        assert out == _expected(model, [3, 1], 4)
        assert "route" in seen and "step" in seen
        snap = pool.routing_snapshot()
        assert snap["fault"] == {"hook": "list.append"}
        assert pool.replicas[0].resilience_snapshot()["fault"] is not None

    try:
        run(scenario())
    finally:
        pool.close()


# ---------------------------------------------------------------- failover
def test_failover_acceptance(model, monkeypatch, run):
    """GOFR_ML_REPLICAS=2 with a step fault on replica 0 past its restart
    budget: nothing hangs, every request completes on the survivor with
    the JAX package's tokens, health is degraded, not dead."""
    monkeypatch.setenv("GOFR_ML_REPLICAS", "2")
    monkeypatch.setenv("GOFR_ML_FAULT", "step:1")
    monkeypatch.setenv("GOFR_ML_FAULT_REPLICA", "0")
    expects = [_expected(model, p, 6) for p in PROMPTS]
    ml = MLDatasource()
    pool = ml.register_llm("chat", None, None,
                           generator=[_gen(model), _gen(model)],
                           max_restarts=0)
    assert isinstance(pool, ReplicaPool)

    async def scenario():
        results = await asyncio.wait_for(
            asyncio.gather(*(pool.generate(p, 6) for p in PROMPTS),
                           return_exceptions=True), timeout=120)
        assert results == expects
        assert pool.replicas[0].health() == "dead"
        assert pool.replicas[1].health() == "serving"
        assert pool.health() == "degraded"
        assert pool.health_check()["status"] == "DEGRADED"
        snap = pool.routing_snapshot()
        assert snap["states"] == {"0": "dead", "1": "serving"}
        assert snap["failovers"] >= 1
        assert snap["fault_replica"] == 0
        assert sum(c.get("failover", 0)
                   for c in snap["routed"].values()) >= 1
        assert await pool.generate([3, 1], 6) == expects[1]

    try:
        run(scenario())
    finally:
        pool.close()


def test_failover_trace_continuity(model, monkeypatch, run):
    monkeypatch.setenv("GOFR_ML_FAULT", "step:1")
    monkeypatch.setenv("GOFR_ML_FAULT_REPLICA", "0")
    from gofr_tpu_torch.flight_recorder import event_log

    tracer = _RecordingTracer()
    exp = _expected(model, [3, 1, 4], 6)
    cursor = event_log().cursor
    pool = ReplicaPool([_gen(model), _gen(model)], name="trace-pool",
                       tracer=tracer, max_restarts=0)

    async def scenario():
        with tracer.start_span("POST /generate", kind="SERVER") as req:
            out = await pool.generate([3, 1, 4], 6)
        assert out == exp
        return req

    try:
        req = run(scenario())
        routes = tracer.by_name("ml.route")
        assert len(routes) == 2
        assert all(s.trace_id == req.trace_id for s in routes)
        assert all(s.parent_span_id == req.span_id for s in routes)
        first, retry = routes
        assert first.attributes["ml.replica"] == 0
        assert first.attributes["ml.finish_reason"] == "rerouted"
        assert retry.attributes["ml.replica"] == 1
        assert retry.attributes["ml.route_reason"] == "failover"
        assert [(n, a) for _, n, a in retry.events if n == "ml.failover"] \
            == [("ml.failover", {"from_replica": 0, "attempt": 1})]
        decodes = tracer.by_name("ml.decode")
        assert decodes and all(s.trace_id == req.trace_id for s in decodes)
        kinds = [e["kind"] for e in event_log().query(
            since=cursor, model="trace-pool")["events"]]
        assert kinds.index("crash") < kinds.index("failover")
        assert "route" in kinds and "dead" in kinds
    finally:
        pool.close()


def test_streamed_request_fails_typed_on_crash(model, run):
    gens = [_gen(model, chunk=1), _gen(model, chunk=1)]
    pool = ReplicaPool(gens, name="chat", max_restarts=0)

    async def scenario():
        pool.replicas[0].gen.fault = _fail_after("step", 2)
        got: list[int] = []
        with pytest.raises(GeneratorCrashed) as ei:
            async for burst in pool.stream_chunks([5, 9, 2, 7], 30,
                                                  priority="high",
                                                  deadline_s=60):
                got.extend(burst)
        assert got and len(got) < 30
        assert int(ei.value.status_code) == 503
        assert pool.replicas[0].health() == "dead"
        assert await pool.generate([3, 1], 4) == _expected(model, [3, 1], 4)
        assert pool.health() == "degraded"

    try:
        run(scenario())
    finally:
        pool.close()


def test_all_replicas_dead_pool_dead(model, run):
    pool = ReplicaPool([_gen(model), _gen(model)], name="chat",
                       max_restarts=0)

    async def scenario():
        for core in pool.replicas:
            core.gen.fault = _fail_after("step", 0)
        results = await asyncio.wait_for(
            asyncio.gather(*(pool.generate([1, 2], 4) for _ in range(5)),
                           return_exceptions=True), timeout=120)
        assert all(isinstance(r, GeneratorCrashed) for r in results), results
        assert pool.health() == "dead"
        assert pool.health_check()["status"] == "DOWN"
        with pytest.raises(GeneratorCrashed) as ei:
            await pool.generate([1, 2], 2)
        assert int(ei.value.status_code) == 503

    try:
        run(scenario())
    finally:
        pool.close()


# ------------------------------------------------- fleet admission control
def test_fleet_wide_shedding_with_retry_after(model, run):
    pool = ReplicaPool([_gen(model), _gen(model)], name="chat",
                       max_queue=2, depth_per_replica=1)

    async def scenario():
        for core in pool.replicas:
            core.gen.fault = _sleep_hook("step", 0.01)
        longs = [asyncio.create_task(pool.generate([9, i + 1], 40))
                 for i in range(2)]
        await asyncio.sleep(0.15)
        lows = [asyncio.create_task(
            pool.generate([i + 1, i + 2], 4, priority="low"))
            for i in range(2)]
        await asyncio.sleep(0.05)
        high = asyncio.create_task(pool.generate([5, 6], 4, priority="high"))
        results = await asyncio.gather(*lows, high, *longs,
                                       return_exceptions=True)
        shed = [r for r in results if isinstance(r, Overloaded)]
        assert len(shed) == 1, results
        assert isinstance(results[1], Overloaded), results
        assert isinstance(results[0], list)
        assert results[2] == _expected(model, [5, 6], 4)
        err = shed[0]
        assert int(err.status_code) == 429
        assert err.retry_after > 0 and "Retry-After" in err.headers
        assert pool.routing_snapshot()["shed"] == {"high": 0, "normal": 0,
                                                   "low": 1}

    try:
        run(scenario())
    finally:
        pool.close()


def test_fleet_queue_deadline_expiry(model, run):
    from gofr_tpu_torch.flight_recorder import event_log

    pool = ReplicaPool([_gen(model), _gen(model)], name="dl-chat",
                       depth_per_replica=1)

    async def scenario():
        for core in pool.replicas:
            core.gen.fault = _sleep_hook("step", 0.01)
        start = event_log().cursor
        longs = [asyncio.create_task(pool.generate([9, i + 1], 40))
                 for i in range(2)]
        # both long requests hold their replica's one slot (their admit
        # events are logged) before the short one arrives: a state polled,
        # not a sleep a loaded host can outrun
        t_end = time.monotonic() + 60.0
        while sum(e["kind"] == "admit" for e in event_log().query(
                since=start, model="dl-chat")["events"]) < 2:
            assert time.monotonic() < t_end, "long requests never admitted"
            await asyncio.sleep(0.005)
        cursor = event_log().cursor
        with pytest.raises(DeadlineExceeded) as ei:
            await pool.generate([1, 2], 4, deadline_s=0.05)
        assert int(ei.value.status_code) == 504
        assert pool.routing_snapshot()["deadline_expired"] == 1
        # it never reached a replica: no core admitted anything since
        kinds = [(e["kind"], e.get("model")) for e in event_log().query(
            since=cursor, model="dl-chat")["events"]]
        assert ("deadline", "dl-chat") in kinds
        assert not any(k == "admit" for k, _ in kinds)
        await asyncio.gather(*longs)

    try:
        run(scenario())
    finally:
        pool.close()


# --------------------------------------------------- observability plane
def test_debug_serving_and_metrics_reflect_failover(model, run):
    async def scenario():
        app = App(config=MapConfig({"APP_NAME": "replica-test"}))
        metrics = app.container.metrics_manager
        ml = app._ensure_ml()
        pool = ReplicaPool([_gen(model), _gen(model)], name="chat",
                           metrics=metrics, max_restarts=0)
        ml._llms["chat"] = pool
        client = TestClient(TestServer(app._build_http_app()))
        await client.start_server()
        try:
            assert await pool.generate([3, 1], 4) == _expected(model, [3, 1],
                                                               4)
            r = await client.get("/debug/serving")
            entry = (await r.json())["data"]["llms"]["chat"]
            assert set(entry["replicas"]) == {"0", "1"}
            assert entry["routing"]["states"] == {"0": "serving",
                                                  "1": "serving"}
            pool.replicas[0].gen.fault = _fail_after("step", 0)
            with pytest.raises(GeneratorCrashed):
                await pool.replicas[0].generate([1, 2], 2)
            r = await client.get("/debug/serving")
            entry = (await r.json())["data"]["llms"]["chat"]
            assert entry["routing"]["states"]["0"] == "dead"
            assert entry["replicas"]["0"]["resilience"]["state"] == "dead"
            assert entry["replicas"]["1"]["resilience"]["state"] == "serving"
            r = await client.get("/.well-known/health")
            assert r.status == 200
            body = (await r.json())["data"]
            assert body["ml"]["status"] == "DEGRADED"
            details = body["ml"]["details"]["llms"]["chat"]
            assert details["state"] == "degraded"
            assert details["replicas"] == {"0": "dead", "1": "serving"}
            ml.sample_runtime_gauges()
            text = metrics.expose_text()
            assert "app_llm_replica_routed_total" in text
            state = [ln for ln in text.splitlines()
                     if ln.startswith("app_llm_replica_state")
                     and 'replica="0"' in ln]
            assert state and float(state[0].rsplit(" ", 1)[1]) == 3.0
            assert any(ln.startswith('app_llm_active_slots{model="chat"}')
                       for ln in text.splitlines())
            assert any(ln.startswith('app_llm_fleet_size{model="chat"} 2')
                       for ln in text.splitlines())
        finally:
            await client.close()
            pool.close()

    run(scenario())


# ----------------------------------------------------------- graceful drain
@pytest.mark.parametrize("budget_s", [5.0, 0.2])
def test_server_drain(model, run, budget_s):
    """``close(drain_s)``: with a budget the decode can meet, admission
    stops (typed ServerClosed), the in-flight stream finishes with the
    JAX package's tokens and the queued one flushes typed; past a short
    budget the teardown is bounded and the stream fails typed."""

    async def scenario():
        server = LLMServer(_gen(model))
        if budget_s < 1:
            server.gen.fault = _sleep_hook("step", 0.02)
            task = asyncio.create_task(server.generate([9, 9], 500))
            await asyncio.sleep(0.1)
            t0 = time.perf_counter()
            await asyncio.to_thread(server.close, budget_s)
            assert time.perf_counter() - t0 < 5.0
            with pytest.raises(ServerClosed):
                await task
            return
        server.gen.fault = _sleep_hook("step", 0.005)
        exp = _expected(model, [9, 9], 20)
        got: list[int] = []
        first = asyncio.get_running_loop().create_future()

        async def long_req():
            async for burst in server.stream_chunks([9, 9], 20):
                got.extend(burst)
                if not first.done():
                    first.set_result(None)

        long_task = asyncio.create_task(long_req())
        await asyncio.wait_for(first, 60)
        queued = asyncio.create_task(server.generate([1, 2], 4))
        while not server.queue_depth():  # parked behind the stream
            await asyncio.sleep(0.005)
        drain = asyncio.create_task(asyncio.to_thread(server.close, budget_s))
        while not server._draining:
            await asyncio.sleep(0.005)
        with pytest.raises(ServerClosed):
            await server.generate([3, 1], 4)
        await long_task
        assert got == exp
        with pytest.raises(ServerClosed):
            await queued
        await drain
        assert server.closed_cleanly

    run(scenario())


def test_drain_env_default_and_pool_drain(model, monkeypatch, run):
    monkeypatch.setenv("GOFR_ML_DRAIN_S", "5.0")

    async def scenario():
        pool = ReplicaPool([_gen(model), _gen(model)], name="chat")
        for core in pool.replicas:
            core.gen.fault = _sleep_hook("step", 0.005)
        exp = _expected(model, [9, 9], 20)
        got: list[int] = []
        first = asyncio.get_running_loop().create_future()

        async def long_req():
            async for burst in pool.stream_chunks([9, 9], 20):
                got.extend(burst)
                if not first.done():
                    first.set_result(None)

        long_task = asyncio.create_task(long_req())
        await asyncio.wait_for(first, 60)  # streaming on a replica
        await asyncio.to_thread(pool.close)
        await long_task
        assert got == exp
        with pytest.raises((ServerClosed, GeneratorCrashed)):
            await pool.generate([1, 2], 4)

    run(scenario())


def test_pool_without_a_card_raises(model, monkeypatch):
    """No fallback: a pool asked for without a card and without
    ``device="cpu"`` raises instead of serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default placement is valid")
    _, _, cfg, params, _ = model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MLDatasource().register_llm("chat", params, cfg, replicas=2,
                                    max_seq=64, prefill_buckets=(8,))
