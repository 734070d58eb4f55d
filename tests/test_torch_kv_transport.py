"""PyTorch port, disaggregated prefill/decode over the KV transport
(``ml/kv_transport.py``, ``ml/multihost.py``'s framing): the twin of
``tests/test_kv_transport.py``, held against the JAX package at f32 on
the CPU.

On a two-replica port pool with ``disagg``, a prompt prefills on the
prefill replica, its whole-page prefix ships through the host tier, and
the decode replica restores it and prefills only the suffix: the greedy
tokens equal the JAX package's disaggregated pool at f32, int8 and int4
pages, and the JAX single replica's (the whole prompt at f32 and int8; at
int4 the same prefix + suffix split, see ``test_disagg_bit_identity``).
The wire codec writes the JAX package's bytes exactly, a frame a JAX prefill replica shipped
lands in a port decode replica, and the cross-host halves run over a
real ``127.0.0.1`` socket through the port's framing. Every transport
failure falls back to a full prefill with the same tokens. Tolerance:
tokens and bytes are compared exactly.
"""

import asyncio
import socket

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.ml.kv_offload import HostKVStore as JHostKVStore
from gofr_tpu.ml.kv_offload import OffloadConfig as JOffloadConfig
from gofr_tpu.ml import kv_transport as jkt
from gofr_tpu.ml import multihost as jmh
from gofr_tpu.ml.llm import LLMServer as JLLMServer
from gofr_tpu.ml.replica import ReplicaPool as JReplicaPool
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch.flight_recorder import event_log
from gofr_tpu_torch.ml import MLDatasource
from gofr_tpu_torch.ml.generate import Generator
from gofr_tpu_torch.ml.kv_offload import HostKVStore, OffloadConfig
from gofr_tpu_torch.ml.kv_transport import (KVTransport, decode_entry,
                                            encode_entry,
                                            encode_entry_shards)
from gofr_tpu_torch.ml.llm import LLMServer
from gofr_tpu_torch.ml.multihost import recv_frame, send_bytes, send_frame
from gofr_tpu_torch.ml.replica import ReplicaPool, disagg_from_env
from gofr_tpu_torch.models import llama as tllama
from gofr_tpu_torch.testutil.faults import FaultInjector
from gofr_tpu_torch.tracing import Tracer

pytestmark = pytest.mark.timeout(300)

# 9 tokens -> 2 whole pages at page_size 4, a non-empty suffix
PROMPT = [5, 9, 2, 7, 1, 4, 8, 3, 6]
BITS = {"kv16": 16, "int8": 8, "int4": 4}


def _pair(kv_bits=16):
    """(JAX cfg, JAX params, port cfg, port params): JAX draws the
    weights, the port runs them bridged, at f32."""
    kw = {} if kv_bits == 16 else {"kv_bits": kv_bits}
    jcfg = jllama.tiny_llama(dtype=jnp.float32, use_flash=False, **kw)
    tcfg = tllama.tiny_llama(dtype=torch.float32, **kw)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def models():
    return {name: _pair(bits) for name, bits in BITS.items()}


@pytest.fixture(scope="module")
def model(models):
    return models["kv16"]


_KW = dict(batch_slots=1, max_seq=64, prefill_buckets=(8, 16), page_size=4,
           chunk=2)


def _gen(model, **kw):
    return Generator(model[3], model[2], device="cpu", **{**_KW, **kw})


def _jgen(model, **kw):
    return JGenerator(model[1], model[0], **{**_KW, **kw})


_EXPECTED: dict = {}


def _expected(model, prompt, n, **kw):
    """The JAX package's single-replica greedy output."""
    key = (id(model), tuple(prompt), n, tuple(sorted(kw.items())))
    if key not in _EXPECTED:
        _EXPECTED[key] = _jgen(model, **kw).generate(list(prompt), n)
    return _EXPECTED[key]


def _fail_after(point: str, ok: int):
    left = {"n": ok}

    def hook(p):
        if p == point:
            if left["n"] > 0:
                left["n"] -= 1
            else:
                raise RuntimeError(f"injected at {p}")

    return hook


async def _wait_dead(core, timeout_s: float = 10.0) -> None:
    for _ in range(int(timeout_s / 0.01)):
        if core.health() == "dead":
            return
        await asyncio.sleep(0.01)
    raise AssertionError(f"replica never died (health={core.health()})")


class _RecordingTracer(Tracer):
    def __init__(self) -> None:
        super().__init__("test", None, 1.0)
        self.finished: list = []

    def _on_end(self, span) -> None:
        self.finished.append(span)

    def by_name(self, name: str) -> list:
        return [s for s in self.finished if s.name == name]


def _tcp_pair():
    """A connected pair of real TCP sockets on 127.0.0.1."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    a = socket.create_connection(srv.getsockname())
    b, _ = srv.accept()
    srv.close()
    return a, b


# ------------------------------------------------------------- construction
def test_disagg_from_env(monkeypatch):
    from gofr_tpu.ml.replica import disagg_from_env as jdisagg

    monkeypatch.delenv("GOFR_ML_DISAGG", raising=False)
    assert disagg_from_env() is False
    monkeypatch.setenv("GOFR_ML_DISAGG", "0")
    assert disagg_from_env() is False
    monkeypatch.setenv("GOFR_ML_DISAGG", "1")
    assert disagg_from_env() is True
    monkeypatch.setenv("GOFR_ML_DISAGG", "yes")
    with pytest.raises(ValueError) as want:
        jdisagg()
    with pytest.raises(ValueError) as got:
        disagg_from_env()
    assert str(got.value) == str(want.value)


def test_disagg_off_never_constructs_transport(model, run, monkeypatch):
    monkeypatch.delenv("GOFR_ML_DISAGG", raising=False)
    pool = ReplicaPool([_gen(model), _gen(model)], name="chat")
    try:
        assert pool._transport is None and pool._roles is None
        assert pool.routing_snapshot()["disagg"] is None
        exp = _expected(model, PROMPT, 6)

        async def scenario():
            assert await pool.generate(PROMPT, 6) == exp

        run(scenario())
    finally:
        pool.close()


def test_disagg_construction_validation(model, monkeypatch):
    with pytest.raises(ValueError, match=">= 2 replicas"):
        ReplicaPool([_gen(model)], disagg=True)
    dense = [_gen(model, page_size=0), _gen(model, page_size=0)]
    with pytest.raises(ValueError, match="paged"):
        ReplicaPool(dense, disagg=True)
    ml = MLDatasource()
    with pytest.raises(ValueError, match="requires replicas >= 2"):
        ml.register_llm("chat", None, None, generator=_gen(model),
                        disagg=True)
    monkeypatch.setenv("GOFR_ML_DISAGG", "1")
    with pytest.raises(ValueError, match="requires replicas >= 2"):
        ml.register_llm("chat", None, None, generator=_gen(model))


def test_disagg_arms_host_tier_when_offload_off(model, monkeypatch):
    monkeypatch.delenv("GOFR_ML_KV_HOST_BUDGET_MB", raising=False)
    gens = [_gen(model), _gen(model)]
    assert all(g.host_kv is None for g in gens)
    pool = ReplicaPool(gens, name="chat", disagg=True)
    try:
        assert all(g.host_kv is not None for g in gens)
        assert {g.host_kv.model for g in gens} == {"chat/0", "chat/1"}
        assert gens[0].host_kv.budget_bytes == 256 * 1024 * 1024
    finally:
        pool.close()


# ------------------------------------------------- the acceptance scenario
def _expected_split(model, prompt, n):
    """The JAX single replica's output on the split a disaggregated pool
    computes: the prompt's whole pages registered as a prefix, the rest
    prefilled on top of them (``Generator.register_prefix`` +
    ``add_request(prefix=)``)."""
    key = ("split", id(model), tuple(prompt), n)
    if key not in _EXPECTED:
        ps = _KW["page_size"]
        whole = (len(prompt) // ps) * ps
        gen = _jgen(model)
        pid = gen.register_prefix(prompt[:whole])
        slot = gen.add_request(prompt[whole:], n, prefix=pid)
        while gen.slots[slot].live:
            gen.step()
        gen.drain()
        _EXPECTED[key] = list(gen.slots[slot].tokens)
    return _EXPECTED[key]


@pytest.mark.parametrize("precision", ["kv16", "int8", "int4"])
def test_disagg_bit_identity(models, precision, run):
    """Prefill on the prefill replica, ship, restore and decode on the
    decode replica: the port's tokens equal the JAX package's
    disaggregated pool at every precision, and the JAX single replica's
    whole-prompt output at kv16 and int8.

    At int4 the JAX single replica's whole-prompt output differs from
    both packages' disaggregated output (the reference's own int4
    disaggregated test is red): a whole prefill attends the prompt's
    fresh keys and values, a suffix prefilled over shipped (or cached)
    pages attends their int4 codes. The port is held against the JAX
    single replica on that same split — the prefix registered, the
    suffix prefilled over it — which the disaggregated pool equals token
    for token in both packages."""
    model = models[precision]
    exp = _expected(model, PROMPT, 6)
    pool = ReplicaPool([_gen(model), _gen(model)], name=f"dg-{precision}",
                       disagg=True)
    jpool = JReplicaPool([_jgen(model), _jgen(model)],
                         name=f"jdg-{precision}", disagg=True)

    async def scenario():
        out = await asyncio.wait_for(pool.generate(PROMPT, 6), 120)
        jout = await asyncio.wait_for(jpool.generate(PROMPT, 6), 120)
        assert out == jout == _expected_split(model, PROMPT, 6)
        if precision == "int4":
            assert out != exp and out[:2] == exp[:2]
        else:
            assert out == exp
        snap = pool.routing_snapshot()["disagg"]
        jsnap = jpool.routing_snapshot()["disagg"]
        assert snap["ships"] == 1 and snap["lands"] == 1
        assert snap["failures"] == 0 and snap["bytes_moved"] > 0
        assert snap["roles"] == {"0": "prefill", "1": "decode"}
        # the same slabs moved: the byte count is JAX's
        assert snap["bytes_moved"] == jsnap["bytes_moved"]
        assert set(snap) == set(jsnap)
        assert pool.replicas[1].gen.kv_restores == 1
        routed = pool.routing_snapshot()["routed"]
        assert routed["0"] == {"prefill": 1}
        assert routed["1"].get("affinity", 0) == 1

    try:
        run(scenario())
    finally:
        pool.close()
        jpool.close()


def test_short_prompt_skips_transport(model, run):
    pool = ReplicaPool([_gen(model), _gen(model)], name="chat",
                       disagg=True)
    exp = _expected(model, [3, 1], 4)

    async def scenario():
        assert await pool.generate([3, 1], 4) == exp
        assert pool._transport.ships == 0
        assert pool.routing_snapshot()["routed"]["1"].get(
            "least_loaded", 0) >= 1

    try:
        run(scenario())
    finally:
        pool.close()


# ------------------------------------------------------- failure semantics
@pytest.mark.parametrize("point", ["ship", "land"])
def test_transport_fault_full_prefill_fallback(model, run, point):
    exp = _expected(model, PROMPT, 6)
    pool = ReplicaPool([_gen(model), _gen(model)], name=f"f-{point}",
                       disagg=True, fault=FaultInjector.parse(f"{point}:1"))

    async def scenario():
        out = await asyncio.wait_for(pool.generate(PROMPT, 6), 120)
        assert out == exp
        t = pool._transport
        assert t.failures >= 1
        if point == "ship":
            assert t.ships == 0
        else:
            assert t.ships == 1 and t.lands == 0
        assert all(c.gen.kv_restores == 0 for c in pool.replicas)

    try:
        run(scenario())
    finally:
        pool.close()


@pytest.mark.parametrize("where", ["dead", "spill", "oversize"])
def test_lost_handoff_falls_back_to_full_prefill(model, run, where):
    """A dead prefill replica (the stage is skipped), a prefill replica
    crashing under the export (a spill fault: no idle registration
    leaks), and an entry over the decode replica's host budget: each
    request still completes with the JAX package's tokens."""
    exp = _expected(model, PROMPT, 6)
    if where == "oversize":
        gens = [_gen(model, host_kv=HostKVStore(OffloadConfig(budget_mb=64))),
                _gen(model, host_kv=HostKVStore(
                    OffloadConfig(budget_mb=1e-6)))]
    else:
        gens = [_gen(model), _gen(model)]
    pool = ReplicaPool(gens, name=f"lost-{where}", disagg=True,
                       max_restarts=0)

    async def scenario():
        if where == "dead":
            pool.replicas[0].gen.fault = _fail_after("step", 0)
            with pytest.raises(Exception):
                await pool.replicas[0].generate([1, 2], 2)
            await _wait_dead(pool.replicas[0])
        elif where == "spill":
            pool.replicas[0].gen.fault = _fail_after("spill", 0)
        out = await asyncio.wait_for(pool.generate(PROMPT, 6), 120)
        assert out == exp
        t = pool._transport
        if where == "dead":
            assert t.ships == 0 and pool.health() == "degraded"
        elif where == "spill":
            assert t.ships == 0 and t.failures >= 1
            gen0 = pool.replicas[0].gen
            assert all(i["refs"] == 0 for i in gen0._prefixes.values())
        else:
            assert t.lands == 0 and t.failures >= 1

    try:
        run(scenario())
    finally:
        pool.close()


# --------------------------------------------------------- observability
def test_transport_metrics_events_and_phases(model, run):
    """The transport's counters, its ``kv_ship`` then ``kv_land`` events,
    and the ``ship`` / ``land`` phases on the two cores' recorders."""
    counts = {}

    class _Metrics:
        def add_counter(self, name, delta, **labels):
            counts[name] = counts.get(name, 0) + delta

        def set_gauge(self, name, value, **labels):
            pass

        def record_histogram(self, name, value, **labels):
            pass

    cursor = event_log().cursor
    pool = ReplicaPool([_gen(model), _gen(model)], name="ev-chat",
                       disagg=True, metrics=_Metrics())

    async def scenario():
        await pool.generate(PROMPT, 6)
        assert counts.get("app_ml_kv_transport_ships_total") == 1
        assert counts.get("app_ml_kv_transport_lands_total") == 1
        assert counts.get("app_ml_kv_transport_bytes", 0) > 0
        kinds = [e["kind"] for e in event_log().query(
            since=cursor, model="ev-chat")["events"]]
        assert "kv_ship" in kinds and "kv_land" in kinds
        assert kinds.index("kv_ship") < kinds.index("kv_land")
        assert pool.replicas[0].recorder.snapshot()["totals_s"].get(
            "ship", 0) > 0
        assert pool.replicas[1].recorder.snapshot()["totals_s"].get(
            "land", 0) > 0

    try:
        run(scenario())
    finally:
        pool.close()


# ------------------------------------------------------ the wire codec
def _slabs(dtype: str):
    """The same slab bits as a numpy dict (JAX side) and a tensor dict."""
    rng = np.random.default_rng(7)
    if dtype == "bfloat16":
        bits = rng.integers(0, 2**15, size=(2, 3, 4, 8), dtype=np.uint16)
        npy = bits.view(ml_dtypes.bfloat16)
        ten = torch.from_numpy(bits.view(np.int16).copy()).view(
            torch.bfloat16)
    elif dtype == "float32":
        npy = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
        ten = torch.from_numpy(npy.copy())
    else:
        npy = rng.integers(-100, 100, size=(2, 3, 4, 8)).astype(dtype)
        ten = torch.from_numpy(npy.copy())
    scale = rng.standard_normal((2, 3, 4)).astype(np.float32)
    return ({"k": npy, "k_scale": scale},
            {"k": ten, "k_scale": torch.from_numpy(scale.copy())})


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8", "uint8"])
def test_wire_codec_bytes_equal_jax(dtype):
    """``encode_entry`` writes the JAX package's bytes for the same slabs
    (the header names dtypes as numpy / ml_dtypes do), each package
    decodes the other's, and a round trip is bit-exact."""
    npy, ten = _slabs(dtype)
    meta = {"len": 8, "tail": [7], "ids_full": list(range(9)),
            "pinned": False}
    raw = encode_entry((1, 2, 3), ten, meta)
    assert raw == jkt.encode_entry((1, 2, 3), npy, meta)
    key, back, meta2 = decode_entry(raw)
    assert key == (1, 2, 3) and meta2 == meta
    for name, t in ten.items():
        assert back[name].dtype == t.dtype
        assert torch.equal(back[name].view(torch.uint8),
                           t.contiguous().view(torch.uint8))
    jkey, jback, _ = jkt.decode_entry(raw)
    assert jkey == key and jback["k"].dtype.name == dtype
    # sharded frames are JAX's too
    assert encode_entry_shards((1, 2, 3), ten, meta, 2) == \
        jkt.encode_entry_shards((1, 2, 3), npy, meta, 2)


def test_framing_interoperates_with_jax():
    """The port's ``send_frame`` / ``send_bytes`` / ``recv_frame`` speak
    the JAX package's wire both ways over a real TCP socket."""
    a, b = _tcp_pair()
    try:
        send_frame(a, {"op": "kv", "n": 3})
        send_bytes(a, b"\x00\x01raw")
        assert jmh.recv_frame(b) == {"op": "kv", "n": 3}
        assert jmh.recv_frame(b) == b"\x00\x01raw"
        jmh.send_frame(b, {"op": "done"})
        jmh.send_bytes(b, b"back")
        assert recv_frame(a) == {"op": "done"}
        assert recv_frame(a) == b"back"
        b.close()
        assert recv_frame(a) is None  # EOF
    finally:
        a.close()


def test_cross_host_ship_over_binary_frame(model, run):
    """Export on one server, encode, ride a binary frame over a real
    127.0.0.1 socket between JSON frames, land on the other server: the
    landed pages restore and decode to the JAX package's tokens."""
    exp = _expected(model, PROMPT, 6)
    budget = HostKVStore(OffloadConfig(budget_mb=64))
    src = LLMServer(_gen(model, host_kv=budget), name="src")
    dst = LLMServer(_gen(model, host_kv=HostKVStore(
        OffloadConfig(budget_mb=64))), name="dst")
    t = KVTransport(name="xhost")
    a, b = _tcp_pair()
    try:
        raw = t.ship_bytes(src, PROMPT)
        assert raw is not None and t.ships == 1
        send_frame(a, {"op": "kv", "tokens": len(PROMPT)})
        send_bytes(a, raw)
        send_frame(a, {"op": "done"})
        assert recv_frame(b) == {"op": "kv", "tokens": len(PROMPT)}
        got = recv_frame(b)
        assert isinstance(got, bytes) and got == raw
        assert recv_frame(b) == {"op": "done"}
        assert t.land_bytes(dst, got) == tuple(PROMPT)
        assert t.lands == 1

        async def scenario():
            assert await dst.generate(PROMPT, 6) == exp
            assert dst.gen.kv_restores == 1

        run(scenario())
    finally:
        a.close()
        b.close()
        src.close()
        dst.close()


@pytest.mark.parametrize("precision", ["kv16", "int8"])
def test_jax_shipped_frame_lands_in_the_port(models, precision, run):
    """A frame a JAX prefill replica shipped (``ship_bytes``), carried
    over a real socket, lands in a port decode replica, which restores
    it and decodes the JAX package's tokens."""
    model = models[precision]
    exp = _expected(model, PROMPT, 6)
    jsrc = JLLMServer(_jgen(model, host_kv=JHostKVStore(
        JOffloadConfig(budget_mb=64))), name="jsrc")
    dst = LLMServer(_gen(model, host_kv=HostKVStore(
        OffloadConfig(budget_mb=64))), name="tdst")
    a, b = _tcp_pair()
    try:
        raw = jkt.KVTransport(name="jax-side").ship_bytes(jsrc, PROMPT)
        assert raw is not None
        jmh.send_bytes(a, raw)
        t = KVTransport(name="port-side")
        assert t.land_bytes(dst, recv_frame(b)) == tuple(PROMPT)

        async def scenario():
            assert await dst.generate(PROMPT, 6) == exp
            assert dst.gen.kv_restores == 1

        run(scenario())
    finally:
        a.close()
        b.close()
        jsrc.close()
        dst.close()


def test_cross_host_ship_single_trace_id(model):
    src = LLMServer(_gen(model, host_kv=HostKVStore(
        OffloadConfig(budget_mb=64))), name="tr-src")
    dst = LLMServer(_gen(model, host_kv=HostKVStore(
        OffloadConfig(budget_mb=64))), name="tr-dst")
    sender_tr, receiver_tr = _RecordingTracer(), _RecordingTracer()
    sender = KVTransport(name="tr-a", tracer=sender_tr)
    receiver = KVTransport(name="tr-b", tracer=receiver_tr)
    a, b = _tcp_pair()
    try:
        cursor = event_log().cursor
        with sender_tr.start_span("request") as root:
            raw = sender.ship_bytes(src, PROMPT, rid="r-xhost")
        assert raw is not None
        send_bytes(a, raw)
        got = recv_frame(b)
        assert receiver.land_bytes(dst, got, rid="r-xhost") == tuple(PROMPT)
        ship = sender_tr.by_name("ml.kv_ship")[0]
        land = receiver_tr.by_name("ml.kv_land")[0]
        assert ship.trace_id == land.trace_id == root.trace_id
        assert land.parent_span_id == ship.span_id
        assert land.attributes["ml.rid"] == "r-xhost"
        evs = {e["kind"]: e for e in event_log().query(
            since=cursor, kind=("kv_ship", "kv_land"))["events"]}
        assert evs["kv_ship"]["rid"] == evs["kv_land"]["rid"] == "r-xhost"
        assert evs["kv_ship"]["trace"] == root.trace_id
        assert evs["kv_land"]["trace"] == root.trace_id
        entry = dst.gen.host_kv._entries[tuple(PROMPT)]
        assert "_traceparent" not in entry.meta
    finally:
        a.close()
        b.close()
        src.close()
        dst.close()


def test_land_bytes_corrupt_frame_counts_failure(model):
    dst = LLMServer(_gen(model, host_kv=HostKVStore(
        OffloadConfig(budget_mb=64))), name="dst-corrupt")
    t = KVTransport(name="xhost")
    try:
        good = encode_entry((1, 2), {"k": torch.zeros((4,), dtype=torch.int8)},
                            {"len": 0, "tail": [], "ids_full": [1, 2]})
        for bad in (b"", b"\x00\x00\x00\xffgarbage", good[:-3]):
            assert t.land_bytes(dst, bad) is None
        assert t.failures == 3 and t.lands == 0
    finally:
        dst.close()


def test_segmented_register_prefix_long_prefix(model):
    """A prefix past the largest prefill bucket registers in segments
    under chunked prefill, and prefixed decode equals the JAX package's
    full-prompt output."""
    long_pfx = [int(t) for t in
                np.random.RandomState(0).randint(1, 400, size=24)]
    ref = _expected(model, long_pfx + [7, 7], 5, prefill_chunk=8,
                    n_pages=32)
    gen = _gen(model, prefill_chunk=8, n_pages=32)
    pid = gen.register_prefix(long_pfx)
    slot = gen.add_request([7, 7], 5, prefix=pid)
    while gen.slots[slot].live:
        gen.step()
    gen.drain()
    assert gen.slots[slot].tokens[:5] == ref
    gen.release(slot)
    with pytest.raises(ValueError, match="prefill_chunk"):
        _gen(model).register_prefix(long_pfx)


def test_pending_shard_sets_bounded_with_eviction():
    landed = {}

    class Dst:
        def import_prefix_kv(self, key, arrays, meta, timeout_s):
            landed["key"] = key
            landed["arrays"] = arrays
            return True

    def shard0(base):
        arrays = {"k": torch.full((2, 4, 8, 4), float(base))}
        meta = {"len": 16, "tail": [], "ids_full": list(range(base,
                                                              base + 4))}
        return encode_entry_shards(tuple(range(base, base + 4)), arrays,
                                   meta, 2)

    cap = 3
    t = KVTransport(name="flood", pending_cap=cap)
    for i in range(10):
        assert t.land_bytes(Dst(), shard0(100 * (i + 1))[0]) is None
        assert len(t._pending_shards) <= cap
    snap = t.snapshot()
    assert snap["sp_shards_pending"] == cap
    assert snap["sp_shards_dropped"] == 10 - cap
    assert t.lands == 0 and not landed
    frames = shard0(9000)
    assert t.land_bytes(Dst(), frames[0]) is None
    assert t.land_bytes(Dst(), frames[1]) == tuple(range(9000, 9004))
    assert landed["key"] == tuple(range(9000, 9004))
    assert torch.equal(landed["arrays"]["k"], torch.full((2, 4, 8, 4), 9000.))
    snap = t.snapshot()
    assert snap["sp_shards_pending"] == cap - 1
    assert snap["sp_shards_dropped"] == 10 - cap + 1
    with pytest.raises(ValueError):
        KVTransport(name="bad", pending_cap=0)
