"""The port's federated fleet against the JAX package's, on the CPU over
loopback sockets.

Twins of ``tests/test_federation.py``'s tier-1 tests, at f32 on the JAX
tiny model's weights bridged into the port: two federated port hosts
route by gossiped digests, fail over a killed or partitioned peer, and
live-migrate on a graceful leave, and every routed, failed-over or
migrated stream equals the JAX package's single-host greedy output
(``ref``) token for token. One more test peers a JAX host with a port
host: each routes a prompt to the other by the other's gossiped digest,
so the gossip, ``gen`` and KV frames are the same wire in both packages.
"""

import asyncio
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ml.federation import FederatedPool as JFederatedPool
from gofr_tpu.ml.federation import FederationConfig as JFederationConfig
from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.ml.llm import LLMServer as JLLMServer
from gofr_tpu.models import llama as jllama
from gofr_tpu.testutil import get_free_port
from gofr_tpu_torch.flight_recorder import event_log
from gofr_tpu_torch.ml import MLDatasource
from gofr_tpu_torch.ml.errors import GeneratorCrashed, ServerClosed
from gofr_tpu_torch.ml.federation import (FederatedPool, FederationConfig,
                                          federation_from_env)
from gofr_tpu_torch.ml.generate import Generator
from gofr_tpu_torch.ml.goodput import goodput_ledger
from gofr_tpu_torch.ml.kv_offload import HostKVStore, OffloadConfig
from gofr_tpu_torch.ml.llm import LLMServer
from gofr_tpu_torch.ml.replica import ReplicaPool
from gofr_tpu_torch.models import llama as tllama

# every test drives real sockets: a lost wakeup fails the ONE test
pytestmark = pytest.mark.timeout(120)

GEN_KW = dict(batch_slots=1, max_seq=64, prefill_buckets=(8, 16),
              page_size=4, chunk=2)


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX params, port cfg, port params): the JAX package
    draws the weights, the port runs them bridged, at f32."""
    jcfg = jllama.tiny_llama(use_flash=False, dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams


def _gen(model, **kw):
    _, _, cfg, params = model
    return Generator(params, cfg, device="cpu", **{**GEN_KW, **kw})


def _jgen(model, **kw):
    cfg, params = model[0], model[1]
    return JGenerator(params, cfg, **{**GEN_KW, **kw})


@pytest.fixture(scope="module")
def ref(model):
    """The JAX package's single-host greedy output (one JAX Generator,
    memoized): what every federated path must reproduce."""
    gen = _jgen(model)
    memo: dict = {}

    def _ref(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            memo[key] = gen.generate(list(prompt), n)
        return memo[key]

    return _ref


def _wait(pred, timeout_s: float = 10.0, msg: str = "condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"never held within {timeout_s}s: {msg}")


def _cfg(hid, port, peers, config=FederationConfig, **kw):
    kw.setdefault("gossip_s", 0.1)
    kw.setdefault("suspect_beats", 2)
    kw.setdefault("dead_beats", 5)
    # queued remote streams must not trip the liveness bound while a
    # slow slot drains ahead of them: the tests kill links explicitly
    kw.setdefault("frame_gap_s", 30.0)
    return config(hid, ("127.0.0.1", port), peers, **kw)


def _pair(name, local_a, local_b, **cfg_kw):
    """Two federated port hosts ("a", "b") peering over loopback."""
    pa, pb = get_free_port(), get_free_port()
    cfg_a = _cfg("a", pa, {"b": ("127.0.0.1", pb)}, **cfg_kw)
    cfg_b = _cfg("b", pb, {"a": ("127.0.0.1", pa)}, **cfg_kw)
    fed_a = FederatedPool(local_a, cfg_a, name=f"{name}-a")
    fed_b = FederatedPool(local_b, cfg_b, name=f"{name}-b")
    return fed_a, fed_b, cfg_a, cfg_b


def _warm_hot_prefix(run, fed, prompt, n=4):
    """Serve ``prompt`` twice so its prefix promotes, and return the
    registered token run (page alignment may register a token short)."""

    async def scenario():
        await fed.generate(list(prompt), n)
        await fed.generate(list(prompt), n)

    run(scenario())
    rows = {}

    def ready():
        if hasattr(fed.local, "hot_prefix_rows"):
            got = fed.local.hot_prefix_rows(16)
        else:
            got = fed.local.prefix_cache.hot_prefixes(16)
        rows["rows"] = got
        return bool(got)

    _wait(ready, 5.0, "hot prefix never registered")
    return [int(t) for t in rows["rows"][0]["ids"]]


def _routable_peer(fed, hid):
    peer = fed._peers[hid]
    return (peer.state == "up" and peer.warm and bool(peer.digests)
            and peer.health in ("serving", "degraded"))


# 12 tokens: past the affinity floor (8) after page alignment shaves one
WARM = [5, 9, 2, 7, 1, 4, 8, 3, 6, 11, 13, 2]


# ------------------------------------------------------------- construction
def test_federation_from_env(monkeypatch):
    """JAX's parse and messages, knob for knob."""
    from gofr_tpu.ml.federation import \
        federation_from_env as jax_federation_from_env

    monkeypatch.delenv("GOFR_ML_FEDERATION", raising=False)
    monkeypatch.delenv("GOFR_ML_FEDERATION_SELF", raising=False)
    assert federation_from_env() is None

    spec = "a=10.0.0.1:9101, b=10.0.0.2:9101"
    monkeypatch.setenv("GOFR_ML_FEDERATION", spec)
    with pytest.raises(ValueError, match="GOFR_ML_FEDERATION_SELF"):
        federation_from_env()
    monkeypatch.setenv("GOFR_ML_FEDERATION_SELF", "c")
    with pytest.raises(ValueError, match="not a member"):
        federation_from_env()
    monkeypatch.setenv("GOFR_ML_FEDERATION_SELF", "b")
    cfg = federation_from_env()
    assert cfg.host_id == "b" and cfg.listen == ("10.0.0.2", 9101)
    assert cfg.peers == {"a": ("10.0.0.1", 9101)}
    assert cfg.gossip_s == 1.0 and cfg.frame_gap_s == 6.0

    for bad in ("oops", "a=nohost", "a=h:notaport", "=h:1"):
        monkeypatch.setenv("GOFR_ML_FEDERATION", bad)
        with pytest.raises(ValueError) as got:
            federation_from_env()
        with pytest.raises(ValueError) as want:
            jax_federation_from_env()
        assert str(got.value) == str(want.value)
    monkeypatch.setenv("GOFR_ML_FEDERATION", spec)
    monkeypatch.setenv("GOFR_ML_FED_GOSSIP_S", "0.25")
    monkeypatch.setenv("GOFR_ML_FED_SUSPECT_BEATS", "2")
    monkeypatch.setenv("GOFR_ML_FED_DEAD_BEATS", "4")
    cfg = federation_from_env()
    assert (cfg.gossip_s, cfg.suspect_beats, cfg.dead_beats) == (0.25, 2, 4)
    monkeypatch.setenv("GOFR_ML_FED_GOSSIP_S", "fast")
    with pytest.raises(ValueError, match="GOFR_ML_FED_GOSSIP_S"):
        federation_from_env()


def test_federation_config_validation():
    for args, kw, match in [
            (("", ("127.0.0.1", 1), {}), {}, "non-empty"),
            (("a", ("127.0.0.1", 1), {"a": ("127.0.0.1", 2)}), {},
             "peer with itself"),
            (("a", ("127.0.0.1", 1), {}), {"gossip_s": 0}, "gossip_s"),
            (("a", ("127.0.0.1", 1), {}),
             {"suspect_beats": 6, "dead_beats": 3}, "suspect_beats")]:
        with pytest.raises(ValueError, match=match) as got:
            FederationConfig(*args, **kw)
        with pytest.raises(ValueError) as want:
            JFederationConfig(*args, **kw)
        assert str(got.value) == str(want.value)
    cfg = FederationConfig("a", ("127.0.0.1", 1), {},
                           gossip_s=0.1, suspect_beats=2, dead_beats=5)
    assert cfg.frame_gap_s == 2.0  # floored: slow CI never false-kills
    assert cfg.suspect_after_s() == pytest.approx(0.2)
    assert cfg.dead_after_s() == pytest.approx(0.5)


def test_register_llm_without_env_builds_no_federation(model, monkeypatch):
    """GOFR_ML_FEDERATION unset: a bare server, no FederatedPool, no
    sockets, no federation threads; a typo'd fleet map is a boot error."""
    monkeypatch.delenv("GOFR_ML_FEDERATION", raising=False)
    monkeypatch.delenv("GOFR_ML_FEDERATION_SELF", raising=False)
    before = {t.name for t in threading.enumerate()
              if t.name.startswith("gofr-fed")}
    ml = MLDatasource()
    server = ml.register_llm("fedzero", None, None, generator=_gen(model))
    try:
        assert isinstance(server, LLMServer)
        assert not hasattr(server, "federation_snapshot")
        grew = {t.name for t in threading.enumerate()
                if t.name.startswith("gofr-fed")} - before
        assert not grew
        assert "federation" not in ml.serving_snapshot()["llms"]["fedzero"]
    finally:
        server.close()
    monkeypatch.setenv("GOFR_ML_FEDERATION", "a=127.0.0.1:1")
    monkeypatch.setenv("GOFR_ML_FEDERATION_SELF", "nope")
    with pytest.raises(ValueError, match="not a member"):
        ml.register_llm("fedbad", None, None, generator=object())


def test_register_llm_single_member_wires_federation(model, monkeypatch, run,
                                                     ref):
    """A one-host fleet from the env: register_llm wraps the server, the
    output equals JAX's single host, and the snapshot grows the
    federation block."""
    port = get_free_port()
    monkeypatch.setenv("GOFR_ML_FEDERATION", f"solo=127.0.0.1:{port}")
    monkeypatch.setenv("GOFR_ML_FEDERATION_SELF", "solo")
    ml = MLDatasource()
    server = ml.register_llm("fedsolo", None, None, generator=_gen(model))
    try:
        assert isinstance(server, FederatedPool)
        assert server.health() == "serving"
        assert server.health_check()["status"] == "UP"
        assert run(server.generate(WARM[:6], 4)) == ref(WARM[:6], 4)
        snap = ml.serving_snapshot()["llms"]["fedsolo"]
        assert snap["federation"]["host"] == "solo"
        assert snap["federation"]["remote"] == {
            "routed": 0, "served": 0, "failovers": 0}
        assert server.routing_snapshot()["federation"]["hosts"] == {}
    finally:
        server.close()
    assert server.health() == "dead"
    with pytest.raises(ServerClosed):
        run(server.generate(WARM[:6], 2))


# ------------------------------------------- remote routing + host failover
def _held_steps(core):
    """A step hook that parks ``core``'s serving thread, once a live slot
    has emitted its first token, until the core is closed: streams on it
    stop mid-way and queued requests stay unadmitted however fast or slow
    the host is (a state, not a sleep a loaded host can outrun)."""
    def hook(p):
        if p == "step" and any(s.live and s.tokens
                               for s in core.gen.slots):
            while not core._closed:
                time.sleep(0.005)

    return hook


def test_remote_route_and_kill_host_fails_over(model, run, ref):
    """A routes three prompts to B by B's gossiped hot-prefix digests;
    killing B mid-stream crashes the yielded stream typed, re-admits the
    queued two on A front-of-class equal to JAX's single host, flips
    health to degraded, and a rejoined B brings it back to serving."""
    ev = event_log()
    fed_a, fed_b, _cfg_a, cfg_b = _pair(
        "tfedkill",
        ReplicaPool([_gen(model)], name="tfedkill-a"),
        ReplicaPool([_gen(model)], name="tfedkill-b"))
    fed_b2 = None
    try:
        reg = _warm_hot_prefix(run, fed_b, WARM)
        assert len(reg) >= 8
        _wait(lambda: _routable_peer(fed_a, "b"), 10.0,
              "A never saw B up+warm with digests")
        core_b = fed_b.local.replicas[0]
        core_b.gen.fault = _held_steps(core_b)
        p1, p2, p3 = reg + [17], reg + [19], reg + [23]
        cursor = ev.cursor

        async def scenario():
            s1 = fed_a.stream_chunks(p1, 40)
            first = await s1.__anext__()
            assert first == ref(p1, 1)
            t2 = asyncio.create_task(fed_a.generate(p2, 6))
            t3 = asyncio.create_task(fed_a.generate(p3, 6))
            for _ in range(500):
                if fed_a.remote_routed == 3:
                    break
                await asyncio.sleep(0.01)
            assert fed_a.remote_routed == 3
            await asyncio.to_thread(fed_b.close)
            with pytest.raises(GeneratorCrashed):
                async for _ in s1:
                    pass
            assert await t2 == ref(p2, 6)
            assert await t3 == ref(p3, 6)

        run(scenario())
        assert fed_a.remote_failovers == 2
        wasted = goodput_ledger().snapshot_model("tfedkill-a")["wasted"]
        assert wasted.get("federation_recompute") == len(p2) + len(p3)
        _wait(lambda: fed_a._peers["b"].state == "dead", 10.0,
              "B never declared dead")
        assert fed_a.health() == "degraded"
        dead = ev.query(since=cursor, model="tfedkill-a",
                        kind="peer_dead")["events"]
        assert any(e.get("host") == "b" for e in dead)
        snap = fed_a.federation_snapshot()
        assert snap["hosts"]["b"]["state"] == "dead"
        assert snap["remote"]["routed"] == 3
        assert snap["remote"]["failovers"] == 2
        fed_b2 = FederatedPool(ReplicaPool([_gen(model)], name="tfedkill-b"),
                               cfg_b, name="tfedkill-b")
        _wait(lambda: fed_a.health() == "serving", 10.0,
              "fleet never healed after rejoin")
        joins = ev.query(since=cursor, model="tfedkill-a",
                         kind="host_join")["events"]
        assert any(e.get("host") == "b" for e in joins)
    finally:
        fed_a.close()
        fed_b.close()
        if fed_b2 is not None:
            fed_b2.close()


def test_partition_falls_back_locally_same_call(model, run, ref):
    """An injected ``peer_partition`` loses frames both ways without
    tearing sockets down: the routed request finishes locally on the same
    call equal to JAX's single host (the recompute charged), and gossip
    silence walks each side's peer suspect -> dead."""
    ev = event_log()
    fed_a, fed_b, _a, _b = _pair(
        "tfedpart",
        LLMServer(_gen(model), name="tfedpart-a"),
        LLMServer(_gen(model), name="tfedpart-b"),
        suspect_beats=4, dead_beats=8)
    try:
        reg = _warm_hot_prefix(run, fed_b, WARM)
        _wait(lambda: _routable_peer(fed_a, "b"), 10.0,
              "A never saw B up+warm with digests")
        local = WARM[:9]
        assert run(fed_a.generate(local, 4)) == ref(local, 4)
        assert fed_a.remote_routed == 0
        cursor = ev.cursor

        def _partition(point):
            if point == "peer_partition":
                raise RuntimeError("injected partition")

        fed_a._fault = _partition
        prompt = reg + [17]
        assert run(fed_a.generate(prompt, 6)) == ref(prompt, 6)
        assert fed_a.remote_routed == 1 and fed_a.remote_failovers == 1
        wasted = goodput_ledger().snapshot_model("tfedpart-a")["wasted"]
        assert wasted.get("federation_recompute") == len(prompt)
        _wait(lambda: fed_a._peers["b"].state == "dead", 10.0,
              "A never declared partitioned B dead")
        _wait(lambda: fed_b._peers["a"].state == "dead", 10.0,
              "B never declared partitioned A dead")
        for fed in (fed_a, fed_b):
            assert fed.health() == "degraded"
        kinds = [e["kind"] for e in ev.query(
            since=cursor, model="tfedpart-a",
            kind=("peer_suspect", "peer_dead"))["events"]]
        assert "peer_suspect" in kinds and "peer_dead" in kinds
    finally:
        fed_a.close()
        fed_b.close()


# ------------------------------------------------------- host leave (drain)
def test_leave_migrates_hot_subtree_and_ledger_closes(model, run, ref):
    """A graceful ``leave()`` migrates the leaver's hot subtree to the
    survivor over ``migrate_bytes`` frames; the fleet-wide ledger closes
    (B's ships == A's adoptions + everyone's failures); A marks B
    ``left`` and stays serving; the migrated prefix serves on A equal to
    JAX's single host."""
    ev = event_log()
    fed_a, fed_b, _a, _b = _pair(
        "tfedleave",
        LLMServer(_gen(model, host_kv=HostKVStore(
            OffloadConfig(budget_mb=64))), name="tfedleave-a"),
        LLMServer(_gen(model, host_kv=HostKVStore(
            OffloadConfig(budget_mb=64))), name="tfedleave-b"))
    try:
        reg = _warm_hot_prefix(run, fed_b, WARM)
        _wait(lambda: fed_b._peers["a"].state == "up"
              and fed_b._peers["a"].warm, 10.0, "B never saw A up+warm")
        cursor = ev.cursor
        res = fed_b.leave()
        assert res["target"] == "a"
        assert res["migrated"] >= 1 and res["lost_frames"] == 0
        ships = fed_b._transport.migrations["ships"]
        assert ships == res["migrated"]

        def closed():
            a, b = (fed_a._transport.migrations,
                    fed_b._transport.migrations)
            return a["adoptions"] + a["failures"] + b["failures"] == ships

        _wait(closed, 10.0, "migration ledger never closed fleet-wide")
        assert fed_a._transport.migrations["adoptions"] == ships
        _wait(lambda: fed_a._peers["b"].state == "left", 10.0,
              "A never saw B leave")
        assert fed_a.health() == "serving"
        leaves = ev.query(since=cursor, kind="host_leave")["events"]
        assert any(e.get("host") == "b" and e.get("local") for e in leaves)
        assert any(e.get("host") == "b" and not e.get("local")
                   for e in leaves)
        assert fed_b.leave() == {"already_leaving": True}
        prompt = WARM[:9]
        assert run(fed_b.generate(prompt, 4)) == ref(prompt, 4)
        # the migrated subtree serves on the survivor
        migrated = reg + [29]
        assert run(fed_a.generate(migrated, 4)) == ref(migrated, 4)
    finally:
        fed_a.close()
        fed_b.close()


# ------------------------------------------------------------ mixed fleet
def test_mixed_fleet_jax_and_port_hosts_share_the_wire(model, run, ref):
    """A JAX host ("j") and a port host ("t") peer over loopback: each
    warms a prefix, sees the other's gossiped digest, and routes a prompt
    extending it to the other as a ``gen`` frame; both answers equal the
    JAX package's single host."""
    pj, pt = get_free_port(), get_free_port()
    fed_j = JFederatedPool(
        JLLMServer(_jgen(model), name="mixed-j"),
        _cfg("j", pj, {"t": ("127.0.0.1", pt)}, config=JFederationConfig),
        name="mixed-j")
    fed_t = FederatedPool(
        LLMServer(_gen(model), name="mixed-t"),
        _cfg("t", pt, {"j": ("127.0.0.1", pj)}), name="mixed-t")
    try:
        other = [3, 8, 1, 6, 2, 9, 4, 7, 5, 12, 10, 1]
        reg_t = _warm_hot_prefix(run, fed_t, WARM)
        reg_j = _warm_hot_prefix(run, fed_j, other)
        _wait(lambda: _routable_peer(fed_j, "t"), 10.0,
              "the JAX host never saw the port host's digests")
        _wait(lambda: _routable_peer(fed_t, "j"), 10.0,
              "the port host never saw the JAX host's digests")
        to_t, to_j = reg_t + [17], reg_j + [19]
        assert run(fed_j.generate(to_t, 6)) == ref(to_t, 6)
        assert run(fed_t.generate(to_j, 6)) == ref(to_j, 6)
        assert (fed_j.remote_routed, fed_t.remote_served) == (1, 1)
        assert (fed_t.remote_routed, fed_j.remote_served) == (1, 1)
        assert fed_j.remote_failovers == fed_t.remote_failovers == 0
    finally:
        fed_j.close()
        fed_t.close()
