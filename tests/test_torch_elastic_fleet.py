"""PyTorch port, the elastic replica fleet (``ml/replica.py``'s scale
plane and the KV transport's live migration): the twin of
``tests/test_elastic_fleet.py``, held against the JAX package at f32 on
the CPU.

Membership changes at runtime are lossless: a scale-up backfills pins
before it becomes routable, a scale-down under load completes every
request with the JAX package's greedy tokens, migrates the draining
replica's hot radix subtrees to survivors (the ledger balances: ships ==
adoptions + failures), and a ``close()`` racing a scale event settles the
event first. The autoscaler's verdicts equal JAX's ``_FleetSteer`` on the
same signals. Tolerance: tokens are compared exactly.
"""

import asyncio
import random
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch.ml.errors import GeneratorCrashed, ServerClosed
from gofr_tpu_torch.ml.generate import Generator
from gofr_tpu_torch.ml.kv_offload import HostKVStore, OffloadConfig
from gofr_tpu_torch.ml.kv_transport import KVTransport
from gofr_tpu_torch.ml.llm import LLMServer
from gofr_tpu_torch.ml.prefix_cache import PrefixCacheConfig
from gofr_tpu_torch.ml.replica import (ReplicaPool, _FleetSteer,
                                       elastic_from_env)
from gofr_tpu_torch.models import llama as tllama
from gofr_tpu_torch.testutil.faults import FAULT_POINTS, FaultInjector

pytestmark = pytest.mark.timeout(300)

BASE = [7, 3, 9, 1, 4, 2, 8, 5]


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.tiny_llama(dtype=jnp.float32, use_flash=False)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams, {}


def _gen(model, **kw):
    kw.setdefault("batch_slots", 1)
    kw.setdefault("max_seq", 64)
    kw.setdefault("prefill_buckets", (8, 16))
    return Generator(model[3], model[2], device="cpu", **kw)


def _expected(model, prompt, n):
    """The JAX package's single-replica greedy output (one JAX Generator
    a module, reused)."""
    memo = model[4]
    if "gen" not in memo:
        memo["gen"] = JGenerator(model[1], model[0], batch_slots=1,
                                 max_seq=64, prefill_buckets=(8, 16))
    key = (tuple(prompt), n)
    if key not in memo:
        memo[key] = memo["gen"].generate(list(prompt), n)
    return memo[key]


def _paged(model, **kw):
    return _gen(model, page_size=4, chunk=2, **kw)


def _holder(pool, prompt) -> int:
    return max(range(len(pool.replicas)), key=lambda i: (
        pool.replicas[i].prefix_cache.peek(prompt)[1]))


# ------------------------------------------------------------ construction
def test_elastic_from_env(monkeypatch):
    from gofr_tpu.ml.replica import elastic_from_env as jelastic

    monkeypatch.delenv("GOFR_ML_ELASTIC", raising=False)
    assert elastic_from_env() is False
    monkeypatch.setenv("GOFR_ML_ELASTIC", "0")
    assert elastic_from_env() is False
    monkeypatch.setenv("GOFR_ML_ELASTIC", "1")
    assert elastic_from_env() is True
    monkeypatch.setenv("GOFR_ML_ELASTIC", "yes")
    with pytest.raises(ValueError) as want:
        jelastic()
    with pytest.raises(ValueError) as got:
        elastic_from_env()
    assert str(got.value) == str(want.value)


def test_fleet_bounds_from_env(model, monkeypatch):
    monkeypatch.setenv("GOFR_ML_REPLICAS_MIN", "2")
    monkeypatch.setenv("GOFR_ML_REPLICAS_MAX", "1")
    with pytest.raises(ValueError, match="GOFR_ML_REPLICAS_MAX"):
        ReplicaPool([_gen(model)], name="chat")
    monkeypatch.setenv("GOFR_ML_REPLICAS_MIN", "not-a-number")
    monkeypatch.delenv("GOFR_ML_REPLICAS_MAX")
    with pytest.raises(ValueError, match="GOFR_ML_REPLICAS_MIN"):
        ReplicaPool([_gen(model)], name="chat")


def test_fault_points_cover_scale_plane():
    from gofr_tpu.testutil.faults import FAULT_POINTS as JPOINTS

    for point in ("scale_up", "scale_down", "migrate"):
        assert point in FAULT_POINTS
    assert set(FAULT_POINTS) == set(JPOINTS)


def test_fault_replica_arming_on_runtime_added_replica(model, monkeypatch):
    monkeypatch.setenv("GOFR_ML_FAULT", "emit:1")
    monkeypatch.setenv("GOFR_ML_FAULT_REPLICA", "2")
    pool = ReplicaPool([_gen(model), _gen(model)], name="chat",
                       spawn=lambda i: _gen(model))
    try:
        assert pool.replicas[0]._fault is None
        assert pool.replicas[1]._fault is None
        assert pool.add_replica() == 2
        inj = pool.replicas[2]._fault
        assert inj is not None and "emit" in inj.points
        assert inj.seed == FaultInjector.from_env().seed + 2
    finally:
        pool.close()


# -------------------------------------------------------------- controller
def test_fleet_steer_hysteresis_and_bounds():
    """The fleet-size controller's verdicts, tick for tick, equal JAX's
    ``_FleetSteer`` fed the same signals."""
    from gofr_tpu.ml.replica import _FleetSteer as JFleetSteer

    up = dict(queued=8, free=0, outstanding=2, capacity=2, n_live=1,
              retry_after_s=5.0)
    idle = dict(queued=0, free=4, outstanding=0, capacity=4, n_live=2,
                retry_after_s=0.0)
    script = [up, up, idle, up, idle, idle, idle, dict(up, n_live=3),
              dict(up, n_live=3), dict(idle, n_live=1)]
    want = [None, 2, None, None, None, None, 1, None, None, None]
    ours = _FleetSteer(1, 3, interval_s=0.0001, up_after=2, down_after=3)
    theirs = JFleetSteer(1, 3, interval_s=0.0001, up_after=2, down_after=3)
    for i, sig in enumerate(script):
        got = ours.decide(now=1.0 + i, **sig)
        assert got == theirs.decide(now=1.0 + i, **sig) == want[i]
    snap = ours.snapshot()
    assert snap == theirs.snapshot()
    assert snap["verdicts"] == {"up": 1, "down": 1}
    assert snap["bounds"] == {"min": 1, "max": 3}


# ---------------------------------------------------------------- scale-up
def test_scale_up_is_routable_and_bit_identical(model, run):
    prompts = [[5, 9, 2, 7], [3, 1], [8, 6, 4]]
    expects = [_expected(model, p, 6) for p in prompts]
    pool = ReplicaPool([_gen(model)], name="chat",
                       spawn=lambda i: _gen(model))

    async def scenario():
        idx = await asyncio.to_thread(pool.add_replica)
        assert idx == 1 and pool.fleet_size() == 2
        outs = await asyncio.gather(*(pool.generate(p, 6) for p in prompts))
        assert outs == expects
        snap = pool.routing_snapshot()
        assert snap["elastic"]["size"] == 2
        assert snap["elastic"]["events"][-1]["kind"] == "scale_up"
        assert all(sum(c.values()) >= 1 for c in snap["routed"].values())
        assert pool.health() == "serving"

    try:
        run(scenario())
    finally:
        pool.close()


def test_scale_up_backfills_pinned_prefixes(model, run):
    pool = ReplicaPool([_gen(model, batch_slots=2, page_size=8)],
                       name="chat",
                       spawn=lambda i: _gen(model, batch_slots=2,
                                            page_size=8))
    prefix = list(range(1, 9))

    async def scenario():
        pid = await asyncio.to_thread(pool.register_prefix, prefix)
        idx = await asyncio.to_thread(pool.add_replica)
        assert pool.replicas[idx].prefix_cache.peek(
            prefix + [30])[0] is not None
        exp = _expected(model, prefix + [30, 31], 4)
        outs = await asyncio.gather(
            *(pool.generate([30, 31], 4, prefix=pid) for _ in range(3)))
        assert all(o == exp for o in outs)
        ev = pool.routing_snapshot()["elastic"]["events"][-1]
        assert ev["kind"] == "scale_up" and ev["backfilled_pins"] == 1

    try:
        run(scenario())
    finally:
        pool.close()


def test_scale_up_without_spawn_fails_loudly(model):
    pool = ReplicaPool([_gen(model)], name="chat")
    try:
        with pytest.raises(ValueError, match="spawn"):
            pool.add_replica()
        assert pool.add_replica(_gen(model)) == 1
    finally:
        pool.close()


# -------------------------------------------------------------- scale-down
@pytest.mark.parametrize("fault", [False, True])
def test_scale_down_migrates_hot_prefixes(model, run, fault):
    """A draining replica's hot radix subtree ships to the survivor,
    which restores it on the next matching prompt; with a ``migrate``
    fault armed on the holder the export is lost, counted, and the
    survivor cold-starts. Either way the tokens are the JAX package's and
    the ledger balances (ships == adoptions + failures)."""
    pool = ReplicaPool([_paged(model) for _ in range(2)], name="chat",
                       prefix_cache=PrefixCacheConfig(promote_hits=1))

    async def scenario():
        exp = _expected(model, BASE + [6, 6], 4)
        await pool.generate(BASE, 4)
        holder = _holder(pool, BASE + [6])
        survivor = 1 - holder
        if fault:
            pool.replicas[holder]._fault = FaultInjector(
                {"migrate": (1.0, RuntimeError)})
        tally = await asyncio.to_thread(pool.remove_replica, holder)
        sg = pool.replicas[survivor].gen
        if fault:
            assert tally["adopted"] == 0 and tally["skipped"] >= 1
        else:
            assert tally["adopted"] >= 1
            assert sg.has_offloaded(tuple(BASE[:7]))
        assert await pool.generate(BASE + [6, 6], 4) == exp
        if not fault:
            assert sg.kv_restores >= 1
        led = pool.routing_snapshot()["elastic"]["migrations"]
        assert led["ships"] == led["adoptions"] + led["failures"]
        assert (led["adoptions"] >= 1) == (not fault)
        assert pool.health() == "serving"
        assert pool.fleet_size() == 1

    try:
        run(scenario())
    finally:
        pool.close()


def test_scale_down_under_load_zero_failures(model, run):
    pool = ReplicaPool([_gen(model, batch_slots=2) for _ in range(2)],
                       name="chat")
    prompts = [[i + 1, 2, 3] for i in range(8)]
    expects = [_expected(model, p, 8) for p in prompts]

    async def scenario():
        tasks = [asyncio.create_task(pool.generate(p, 8)) for p in prompts]
        await asyncio.sleep(0.05)
        await asyncio.to_thread(pool.remove_replica, 1, drain_s=30.0)
        outs = await asyncio.gather(*tasks)
        assert outs == expects
        assert pool.fleet_size() == 1 and pool.health() == "serving"
        assert await pool.generate(prompts[0], 8) == expects[0]

    try:
        run(scenario())
    finally:
        pool.close()


def test_remove_last_replica_refused(model):
    pool = ReplicaPool([_gen(model)], name="chat")
    try:
        with pytest.raises(ValueError, match="last live replica"):
            pool.remove_replica(0)
        with pytest.raises(ValueError, match="not a live fleet member"):
            pool.remove_replica(7)
    finally:
        pool.close()


def test_cross_host_migration_bytes_round_trip(model, run):
    """``migrate_bytes`` exports resident KV as one binary frame and
    ``land_bytes`` on the receiving side adopts it and closes the
    ledger there: sender ships == receiver adoptions."""
    src_gen = _paged(model, host_kv=HostKVStore(OffloadConfig(budget_mb=32)))
    dst_gen = _paged(model, host_kv=HostKVStore(OffloadConfig(budget_mb=32)))
    src = LLMServer(src_gen, name="send/0",
                    prefix_cache=PrefixCacheConfig(promote_hits=1))
    dst = LLMServer(dst_gen, name="recv/0",
                    prefix_cache=PrefixCacheConfig(promote_hits=1))
    sender, receiver = KVTransport(name="send"), KVTransport(name="recv")

    async def scenario():
        exp = _expected(model, BASE + [6, 6], 4)
        await src.generate(BASE, 4)
        rows = src.prefix_cache.hot_prefixes()
        assert rows and rows[0]["state"] == "registered"
        raw = sender.migrate_bytes(src, rows[0]["ids"], rows[0]["pid"])
        assert isinstance(raw, bytes)
        assert sender.snapshot()["migrations"]["ships"] == 1
        key = receiver.land_bytes(dst, raw)
        assert key == tuple(rows[0]["ids"])
        led = receiver.snapshot()["migrations"]
        assert led["adoptions"] == 1 and led["failures"] == 0
        assert dst_gen.has_offloaded(key)
        assert "_migration" not in dst_gen.host_kv.meta(key)
        assert await dst.generate(BASE + [6, 6], 4) == exp
        assert dst_gen.kv_restores >= 1

    try:
        run(scenario())
    finally:
        src.close()
        dst.close()


# --------------------------------------------------------- close/scale race
def test_close_settles_inflight_scale_up(model):
    release = threading.Event()

    def slow_spawn(i):
        release.wait(5.0)
        return _gen(model)

    pool = ReplicaPool([_gen(model)], name="race", spawn=slow_spawn)
    errs: list = []

    def adder():
        try:
            pool.add_replica()
        except Exception as exc:
            errs.append(exc)

    t = threading.Thread(target=adder)
    t.start()
    time.sleep(0.05)
    release.set()
    pool.close()
    t.join(timeout=10)
    assert not t.is_alive()
    assert len(errs) == 1 and isinstance(errs[0], ServerClosed)
    assert len(pool.replicas) == 1
    assert pool.health() == "dead"


def test_close_cuts_migrating_scale_down_short(model, run):
    pool = ReplicaPool([_paged(model) for _ in range(2)], name="race2",
                       prefix_cache=PrefixCacheConfig(promote_hits=1))

    async def scenario():
        await pool.generate(BASE, 4)
        remover = threading.Thread(
            target=lambda: pool.remove_replica(1, drain_s=2.0))
        remover.start()
        await asyncio.sleep(0.02)
        await asyncio.to_thread(pool.close)
        remover.join(timeout=15)
        assert not remover.is_alive()
        assert pool.health() == "dead"
        with pytest.raises((ServerClosed, GeneratorCrashed)):
            await pool.generate([1, 2], 2)

    run(scenario())


# ---------------------------------------------------------------- autoscale
def test_autoscaler_grows_under_backlog_and_sheds_idle(model, run):
    pool = ReplicaPool([_gen(model)], name="auto",
                       spawn=lambda i: _gen(model), elastic=True,
                       replicas_max=2)
    pool._steer.interval_s = 0.05
    pool._steer.up_after = 1
    pool._steer.down_after = 2

    def slow_step(point):  # a backlog that outlives a controller pass
        if point == "step":
            time.sleep(0.01)

    pool.replicas[0].gen.fault = slow_step

    prompts = [[i + 1, 2, 3] for i in range(8)]
    expects = [_expected(model, p, 8) for p in prompts]

    async def scenario():
        outs = await asyncio.gather(*(pool.generate(p, 8) for p in prompts))
        assert outs == expects
        # the port serves the tiny model fast enough that the idle
        # heartbeat may shed the added replica before a poll sees it:
        # read the scale history (grew to 2, then shed back to 1)
        kinds: list = []
        for _ in range(200):
            kinds = [(e["kind"], e["fleet_size"]) for e in
                     pool.routing_snapshot()["elastic"]["events"]]
            if ("scale_down", 1) in kinds:
                break
            await asyncio.sleep(0.05)
        assert ("scale_up", 2) in kinds
        assert kinds.index(("scale_up", 2)) < kinds.index(("scale_down", 1))
        assert pool._steer.snapshot()["verdicts"]["up"] >= 1
        assert pool.fleet_size() == 1
        assert pool.health() == "serving"

    try:
        run(scenario())
    finally:
        pool.close()


# --------------------------------------------- journey / forensic continuity
def test_scale_down_reroute_is_one_journey(model, run):
    from gofr_tpu_torch.ml.journey import journey_log

    """A request the retiring replica held staged (admitted to its queue,
    no token yet) re-admits on the survivor as ONE journey: the reject on
    the retiring core is a mark, the route onto the survivor continues
    the timeline, the record seals once. The drain lets the replica's
    in-flight stream finish (with ``drain_s=0`` a stream that already
    yielded a token would fail typed, and the port's CPU steps are fast
    enough for that to happen), and slowed steps keep staged work there
    when the scale-down starts."""
    pool = ReplicaPool([_gen(model) for _ in range(2)], name="jrn")
    prompts = [[i + 1, 2, 3] for i in range(8)]
    expects = [_expected(model, p, 8) for p in prompts]

    def slow_step(point):
        if point == "step":
            time.sleep(0.005)

    for core in pool.replicas:
        core.gen.fault = slow_step

    async def scenario():
        tasks = [asyncio.create_task(pool.generate(p, 8)) for p in prompts]
        await asyncio.sleep(0.03)
        await asyncio.to_thread(pool.remove_replica, 1, drain_s=30.0)
        outs = await asyncio.gather(*tasks)
        assert outs == expects
        log = journey_log()
        rerouted = 0
        for rid in log.snapshot()["recent_rids"]:
            j = log.get(rid)
            if j is None or j.model != "jrn":
                continue
            marks = [m["mark"] for m in j.marks]
            assert marks.count("finish") == 1
            if "reject" in marks:
                assert "route" in marks[marks.index("reject"):]
                rerouted += 1
        assert rerouted >= 1

    try:
        run(scenario())
    finally:
        pool.close()


def test_crash_bundle_snapshots_fleet_shape(model, run):
    from gofr_tpu_torch.flight_recorder import crash_vault

    pool = ReplicaPool([_gen(model), _gen(model)], name="shape",
                       spawn=lambda i: _gen(model), max_restarts=0)

    def boom(p):
        if p == "step":
            raise RuntimeError("boom")

    async def scenario():
        await asyncio.to_thread(pool.add_replica)
        pool.replicas[0].gen.fault = boom
        with pytest.raises(GeneratorCrashed):
            await pool.replicas[0].generate([1, 2], 4)
        bundles = [b for b in crash_vault().list()
                   if b["model"].startswith("shape/")]
        assert bundles
        fleet = crash_vault().get(bundles[-1]["id"])["state"]["fleet"]
        assert fleet["replicas"] == 3 and fleet["retired"] == []
        assert set(fleet["states"]) == {"0", "1", "2"}
        assert pool.replicas[1].snapshot()["fleet"]["replicas"] == 3

    try:
        run(scenario())
    finally:
        pool.close()


def test_register_llm_elastic_mounts_pool_at_size_one(model, monkeypatch,
                                                      run):
    from gofr_tpu_torch.ml import MLDatasource

    monkeypatch.delenv("GOFR_ML_REPLICAS", raising=False)
    monkeypatch.delenv("GOFR_ML_ELASTIC", raising=False)
    ml = MLDatasource()
    server = ml.register_llm("plain", None, None, generator=_gen(model))
    assert isinstance(server, LLMServer)
    server.close()
    monkeypatch.setenv("GOFR_ML_ELASTIC", "1")
    pool = ml.register_llm("grow", None, None, generator=_gen(model))
    assert isinstance(pool, ReplicaPool)
    try:
        assert pool.fleet_size() == 1 and pool._elastic
        assert pool._spawn is None
        assert pool.add_replica(_gen(model)) == 1

        async def scenario():
            assert await pool.generate([3, 1], 4) == _expected(model, [3, 1],
                                                               4)

        run(scenario())
    finally:
        pool.close()
    # built from (params, cfg) the pool gets a default spawn factory
    # that builds a warmed replica on the same device
    _, _, cfg, params, _ = model
    pool = ml.register_llm("grow2", params, cfg, device="cpu",
                           batch_slots=1, max_seq=64,
                           prefill_buckets=(8, 16))
    try:
        assert pool._spawn is not None
        assert pool.scale_to(2) == 2
        assert pool.replicas[1].gen.params is params

        async def scenario2():
            assert await pool.generate([3, 1], 4) == _expected(
                model, [3, 1], 4)

        run(scenario2())
    finally:
        pool.close()


# ------------------------------------------------------------ elastic chaos
def test_elastic_chaos_bounded(model, run):
    rng = random.Random(7)
    prompts = [[rng.randint(1, 30) for _ in range(rng.randint(2, 8))]
               for _ in range(12)]
    expects = [_expected(model, p, 6) for p in prompts]
    pool = ReplicaPool([_paged(model)], name="chaos",
                       spawn=lambda i: _paged(model),
                       prefix_cache=PrefixCacheConfig(promote_hits=1))

    async def scenario():
        stop = asyncio.Event()

        async def churn():
            while not stop.is_set():
                await asyncio.to_thread(pool.scale_to, rng.randint(1, 3),
                                        drain_s=30.0)
                await asyncio.sleep(0.02)

        churner = asyncio.create_task(churn())
        try:
            outs = [await pool.generate(p, 6) for p in prompts]
            assert outs == expects
        finally:
            stop.set()
            await churner
        led = pool.routing_snapshot()["elastic"]["migrations"]
        if led is not None:
            assert led["ships"] == led["adoptions"] + led["failures"]
        assert pool.health() in ("serving", "degraded")

    try:
        run(scenario())
    finally:
        pool.close()
