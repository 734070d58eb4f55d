"""PyTorch port, the host KV tier (``ml/kv_offload.py`` and the
generator's spill and restore), the twin of ``tests/test_kv_offload.py``:
the store's LRU under its byte budget, spill→restore bit identity and page
conservation at f32, int8 and int4 pages (the tokens held against the JAX
Generator's as well as the port's own never-evicted run), a borrowed
prefix never spilled, budget-zero parity, the restore's pool-pressure
fallback, the scheduler's restore charge, and the server's rotation of
prefixes through the radix cache's offloaded state; and the twins of
the serving plane's host-tier tests: the RSS gauge and the
``kv_host_tier`` block of ``/debug/serving``.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch.ml.generate import Generator, PagePoolExhausted
from gofr_tpu_torch.ml.kv_offload import HostKVStore, OffloadConfig
from gofr_tpu_torch.ml.llm import LLMServer
from gofr_tpu_torch.ml.prefix_cache import PrefixCacheConfig
from gofr_tpu_torch.ml.scheduler import TokenBudgetScheduler
from gofr_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.timeout(300)

KV_BITS = [16, 8, 4]
PFX = [5, 9, 2, 7, 1, 4, 8, 3, 6]      # 9 tokens -> 2 whole pages of 4
KW = dict(batch_slots=2, max_seq=64, prefill_buckets=(8, 16), page_size=4,
          n_pages=16)


def _pair(kv_bits=16):
    kw = {} if kv_bits == 16 else {"kv_bits": kv_bits}
    jcfg = jllama.tiny_llama(dtype=jnp.float32, use_flash=False, **kw)
    tcfg = tllama.tiny_llama(dtype=torch.float32, **kw)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def pairs():
    return {bits: _pair(bits) for bits in KV_BITS}


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for name in ("GOFR_ML_DECODE_WINDOW", "GOFR_ML_PIPELINE",
                 "GOFR_ML_SPEC_K", "GOFR_ML_TOKEN_BUDGET",
                 "GOFR_ML_KV_HOST_BUDGET_MB"):
        monkeypatch.delenv(name, raising=False)


def _store(mb=64.0):
    return HostKVStore(OffloadConfig(budget_mb=mb))


def _gen(pair, **kw):
    _, _, tcfg, tparams = pair
    return Generator(tparams, tcfg, device="cpu", **{**KW, **kw})


def _entry(n_bytes):
    arr = {"k": torch.zeros((n_bytes // 4,), dtype=torch.float32)}
    meta = {"len": 8, "tail": [], "ids_full": list(range(8)),
            "pinned": False}
    return arr, meta


def _held_pages(gen):
    return (sum(len(i["pages"]) for i in gen._prefixes.values())
            + sum(len(p) - s
                  for p, s in zip(gen._slot_pages, gen._slot_shared)))


def _run(gen, prefix, suffix=(6, 2)):
    slot = gen.add_request(list(suffix), 6, prefix=prefix)
    while gen.slots[slot].live:
        gen.step()
    gen.drain()
    toks = list(gen.slots[slot].tokens)
    gen.release(slot)
    return toks


# -- the store --------------------------------------------------------------------

def test_host_store_lru_ordering_under_budget():
    store = HostKVStore(OffloadConfig(budget_mb=2 / 1024))  # 2 KiB
    for key in ("a", "b", "c"):
        assert store.put((key,), *_entry(1024))
    # budget 2: the least recently used "a" falls out
    assert ("a",) not in store and ("b",) in store and ("c",) in store
    assert store.evictions == 1
    # pop removes; put_back reinserts as the most recently used
    arrays, meta = store.pop(("b",))
    store.put_back(("b",), arrays, meta)
    assert store.put(("d",), *_entry(1024))  # now "c" is the victim
    assert ("c",) not in store and ("b",) in store and ("d",) in store
    # an entry bigger than the whole budget is refused, not admitted
    assert not store.put(("big",), *_entry(4096))
    assert store.rejects == 1
    assert store.bytes_used <= store.budget_bytes


def test_host_store_meta_and_stats():
    store = _store()
    store.put(("x",), *_entry(1024))
    assert store.meta(("x",))["len"] == 8
    assert store.meta(("y",)) is None
    st = store.stats()
    assert st["entries"] == 1 and st["bytes"] == 1024
    assert st["pending_copies"] == 0  # no copy event: already settled
    assert store.pop(("y",)) is None
    assert store.take(("x",))[1]["len"] == 8 and len(store) == 0
    assert store.receive(("x",), *_entry(1024)) and ("x",) in store


def test_budget_env_zero_disables_tier(monkeypatch):
    assert not OffloadConfig.from_env().enabled
    assert HostKVStore.from_env() is None
    for raw in ("0", "", "nonsense", "-3"):
        monkeypatch.setenv("GOFR_ML_KV_HOST_BUDGET_MB", raw)
        assert HostKVStore.from_env() is None
    monkeypatch.setenv("GOFR_ML_KV_HOST_BUDGET_MB", "128")
    store = HostKVStore.from_env()
    assert store is not None and store.budget_bytes == 128 * 1024 * 1024


# -- the generator's spill and restore --------------------------------------------

@pytest.mark.parametrize("kv_bits", KV_BITS)
def test_spill_restore_bit_identity_and_page_conservation(pairs, kv_bits):
    """Decode after spill→restore gives the never-evicted tokens, which
    are the JAX Generator's; the restored pages hold the spilled bytes;
    pool pages are conserved across cycles (free + prefix-held +
    slot-owned is invariant)."""
    jcfg, jparams, _, _ = pairs[kv_bits]
    jgen = JGenerator(jparams, jcfg, **KW)
    want = _run(jgen, jgen.register_prefix(PFX))
    gen = _gen(pairs[kv_bits], host_kv=_store())
    pid = gen.register_prefix(PFX)
    ref = _run(gen, pid)
    assert ref == want
    conserved = gen.free_pages + _held_pages(gen)
    pages = gen._prefixes[pid]["pages"]
    spilled = {k: v[:, pages].clone() for k, v in gen.cache.items()
               if k != "len"}
    for _ in range(3):
        assert gen._reclaim_prefix_pages(len(gen._free_pages) + 2)
        assert not gen.has_prefix(pid) and gen.has_offloaded(PFX)
        assert gen.free_pages + _held_pages(gen) == conserved
        pid = gen.restore_prefix(PFX)
        assert gen.free_pages + _held_pages(gen) == conserved
        assert not gen.has_offloaded(PFX)  # a restore MOVES the entry
        pages = gen._prefixes[pid]["pages"]
        for k, was in spilled.items():
            assert torch.equal(gen.cache[k][:, pages], was), k
        assert _run(gen, pid) == ref
    assert gen.kv_spills == 3 and gen.kv_restores == 3
    stats = gen.pool_stats()
    assert stats["kv_spills"] == 3 and stats["kv_restores"] == 3
    assert stats["kv_restore_fallbacks"] == 0


def test_int4_pages_halve_the_host_bytes(pairs):
    """int4 pages (packed values + scale/zero planes) take half the value
    bytes of int8 ones in the pool and in the host tier."""
    store = _store()
    gen4 = _gen(pairs[4], host_kv=store)
    s4, s8 = gen4.pool_stats(), _gen(pairs[8]).pool_stats()
    assert s4["page_value_bytes"] * 2 == s8["page_value_bytes"]
    assert s4["page_bytes"] < 0.70 * s8["page_bytes"]
    gen4.register_prefix(PFX)
    assert gen4._reclaim_prefix_pages(len(gen4._free_pages) + 2)
    assert store.bytes_used == 2 * s4["page_bytes"]


def test_borrowed_prefix_never_spilled(pairs):
    """refs > 0 prefixes are never eviction candidates, so their pages are
    never mid-copy to the host while a slot still reads them."""
    gen = _gen(pairs[16], host_kv=_store())
    p_borrowed = gen.register_prefix(PFX)
    p_idle = gen.register_prefix([11, 12, 13, 14, 15, 16, 17, 18])
    gen._prefixes[p_borrowed]["refs"] = 1
    assert not gen._reclaim_prefix_pages(gen.n_pages + 10)  # honest fail
    assert gen.has_prefix(p_borrowed)
    assert not gen.has_offloaded(PFX)
    assert gen.has_offloaded([11, 12, 13, 14, 15, 16, 17, 18])
    assert not gen.has_prefix(p_idle)


def test_budget_zero_discard_parity(pairs):
    """With the tier off (env unset), eviction discards as before: nothing
    stored, no spill counted, restore raises; the tokens of a re-registered
    prefix are the never-evicted ones."""
    gen = _gen(pairs[16])
    assert gen.host_kv is None
    pid = gen.register_prefix(PFX)
    ref = _run(gen, pid)
    assert gen._reclaim_prefix_pages(len(gen._free_pages) + 2)
    assert not gen.has_prefix(pid) and not gen.has_offloaded(PFX)
    assert gen.kv_spills == 0
    with pytest.raises(KeyError):
        gen.restore_prefix(PFX)
    assert "kv_spills" in gen.pool_stats()  # counters stay visible at 0
    assert _run(gen, gen.register_prefix(PFX)) == ref


def test_restore_pool_pressure_falls_back(pairs):
    """A restore that cannot get pages raises PagePoolExhausted and keeps
    the host entry: nothing leaks, and a calmer attempt restores."""
    gen = _gen(pairs[16], n_pages=6, host_kv=_store())
    gen.register_prefix(PFX)
    assert gen._reclaim_prefix_pages(len(gen._free_pages) + 2)
    assert gen.has_offloaded(PFX)
    blocker = gen.register_prefix(list(range(101, 101 + 16)))
    gen._prefixes[blocker]["refs"] = 1  # borrowed: reclaim cannot help
    free_before = gen.free_pages
    with pytest.raises(PagePoolExhausted):
        gen.restore_prefix(PFX)
    assert gen.kv_restore_fallbacks == 1
    assert gen.free_pages == free_before
    assert gen.has_offloaded(PFX)
    gen._prefixes[blocker]["refs"] = 0
    gen.drop_prefix(blocker)
    assert gen.restore_prefix(PFX) > 0


def test_scheduler_charged_for_restores(pairs):
    """Restores debit the token budget: the next plan picks a smaller
    ladder entry, decode never drops below the 1-step floor, the debt
    drains and is capped; restore_prefix charges the live scheduler."""
    sched = TokenBudgetScheduler(64, (1, 2, 4, 8, 16), 16, slots=8)
    assert sched.plan(8, False) == (8, 0)
    sched.charge_restore(32)
    assert sched.restore_debt == 32
    size, _ = sched.plan(8, False)  # half the budget repays debt
    assert size == 4 and sched.restore_debt == 0
    assert sched.plan(8, False) == (8, 0)
    for _ in range(100):
        sched.charge_restore(10_000)
    assert sched.restore_debt <= 4 * sched.budget
    assert sched.snapshot()["restores_charged"] == 101

    gen = _gen(pairs[16], host_kv=_store(), chunk=2, token_budget=32)
    gen.register_prefix(PFX)
    assert gen._reclaim_prefix_pages(len(gen._free_pages) + 2)
    assert gen.has_prefix(gen.restore_prefix(PFX))
    assert gen.scheduler.restores_charged == 1
    assert gen.scheduler.restore_debt == 8  # two whole pages


def test_drop_prefix_spill_flag(pairs):
    """``drop_prefix(spill=True)`` stores the pages (True), a plain drop
    discards them (False)."""
    gen = _gen(pairs[16], host_kv=_store())
    assert gen.drop_prefix(gen.register_prefix(PFX), spill=True) is True
    assert gen.has_offloaded(PFX)
    other = [11, 12, 13, 14, 15, 16, 17, 18, 19]
    assert gen.drop_prefix(gen.register_prefix(other)) is False
    assert not gen.has_offloaded(other)


# -- the radix cache's offloaded state and the server --------------------------

def test_prefix_cache_offloaded_state(pairs):
    """A capacity eviction spills and leaves the node OFFLOADED (listed by
    ``hot_prefixes``); the next prompt through it restores; an adopted
    host entry restores too; ``forget_offloaded`` clears the state."""
    from gofr_tpu_torch.ml.prefix_cache import RadixPrefixCache

    gen = _gen(pairs[16], host_kv=_store())
    cache = RadixPrefixCache(gen, PrefixCacheConfig(promote_hits=1,
                                                    max_prefixes=1))
    a = [10, 11, 12, 13, 14, 15, 16, 17, 18, 1]
    b = [20, 21, 22, 23, 24, 25, 26, 27, 28, 1]
    pid_a, reg_a = cache.observe(a)  # promoted whole: 10 tokens
    assert pid_a is not None and reg_a == 10
    assert cache.observe(b)[0] is not None  # a spills (cap 1)
    assert gen.has_offloaded(a) and not gen.has_prefix(pid_a)
    rows = {tuple(r["ids"]): r["state"] for r in cache.hot_prefixes()}
    assert rows[tuple(a)] == "offloaded" and rows[tuple(b)] == "registered"
    # restores a (b spills in turn); with promote_hits 1 the longer
    # prompt then promotes its own 11 tokens on top of it
    pid, reg = cache.observe(a + [2])
    assert pid is not None and reg >= 10 and gen.kv_restores == 1
    assert cache.snapshot()["restores"] == 1
    assert cache.snapshot()["offloads"] >= 2
    # a handed-over entry: adopt it, and the next hit restores it
    c = [30, 31, 32, 33, 34, 35, 36, 37, 38]
    pid_c = gen.register_prefix(c)
    gen.drop_prefix(pid_c, spill=True)
    assert cache.adopt_offloaded(c)
    assert cache.observe(c + [1])[0] is not None and gen.kv_restores == 2
    cache.forget_offloaded(b)
    assert all(r["ids"] != tuple(b) for r in cache.hot_prefixes())


def test_server_rotation_restores_bit_identical(pairs, run):
    """Rotating system prompts overflow the pool; with the host tier on,
    warm hits restore offloaded pages and the outputs equal the cold pass,
    which equals the JAX Generator's whole-prompt output; the server's
    snapshot shows the tier and its counters."""
    jcfg, jparams, tcfg, tparams = pairs[16]
    prefixes = [[10 * i + j for j in range(1, 10)] for i in range(1, 4)]
    sfx = [6, 2]
    kw = dict(batch_slots=1, max_seq=64, prefill_buckets=(8, 16), chunk=2,
              page_size=4, n_pages=8)
    jgen = JGenerator(jparams, jcfg, **kw)
    want = [jgen.generate(p + sfx, 5) for p in prefixes]

    async def scenario():
        gen = Generator(tparams, tcfg, device="cpu", host_kv=_store(), **kw)
        server = LLMServer(gen, prefix_cache=PrefixCacheConfig(
            promote_hits=1))
        try:
            cold = [await server.generate(p + sfx, 5) for p in prefixes]
            warm = [await server.generate(p + sfx, 5) for p in prefixes]
            return cold, warm, gen, server.snapshot()
        finally:
            server.close()

    cold, warm, gen, snap = run(scenario())
    assert cold == warm == want
    assert gen.kv_restores >= 1
    assert snap["prefix_cache"]["restores"] == gen.kv_restores
    assert snap["prefix_cache"]["offloads"] >= gen.kv_restores
    tier = snap["kv_host_tier"]
    assert tier["budget_bytes"] == 64 * 1024 * 1024 and tier["puts"] >= 1
    assert snap["pool"]["kv_spills"] == gen.kv_spills >= 1
    assert snap["graphs"] is None  # the CPU runs no graphs


def test_server_snapshot_without_tier(pairs, run):
    """A paged server without the tier: ``kv_host_tier`` is None, the
    counters read 0, window and pipeline blocks are None when off."""
    _, _, tcfg, tparams = pairs[16]

    async def scenario():
        gen = Generator(tparams, tcfg, device="cpu", **KW)
        server = LLMServer(gen)
        try:
            await server.generate(PFX, 3)
            return server.snapshot()
        finally:
            server.close()

    snap = run(scenario())
    assert snap["kv_host_tier"] is None and snap["pool"]["kv_spills"] == 0
    assert snap["window"] is None and snap["pipeline"] is None
    assert snap["scheduler"]["plans"] == "chunks"
    assert asyncio.iscoroutinefunction(LLMServer.generate)


# -- the host tier on the serving plane (the JAX twins) ---------------------------

def test_host_rss_gauge_sampled():
    """Twin of test_kv_offload.py::test_host_rss_gauge_sampled: the sampler
    pass publishes app_ml_host_rss_bytes."""
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.ml import MLDatasource

    c = Container(MapConfig({}))
    c.register_framework_metrics()
    ml = MLDatasource(metrics=c.metrics_manager)
    ml.sample_runtime_gauges()
    text = c.metrics_manager.expose_text()
    line = next(ln for ln in text.splitlines()
                if ln.startswith("app_ml_host_rss_bytes"))
    assert float(line.rsplit(" ", 1)[1]) > 0


def test_serving_snapshot_exposes_host_tier(pairs, run):
    """Twin of test_kv_offload.py::test_serving_snapshot_exposes_host_tier:
    the per-LLM block of /debug/serving has ``kv_host_tier`` with the
    JAX block's keys."""
    from gofr_tpu_torch.ml import MLDatasource

    _, _, tcfg, tparams = pairs[16]

    async def scenario():
        ml = MLDatasource()
        gen = Generator(tparams, tcfg, device="cpu", batch_slots=1,
                        max_seq=64, prefill_buckets=(8, 16), chunk=2,
                        page_size=4, n_pages=8, host_kv=_store())
        server = ml.register_llm("chat", None, None, generator=gen,
                                 prefix_cache=PrefixCacheConfig(
                                     promote_hits=1))
        try:
            pid = await asyncio.to_thread(server.register_prefix, PFX)
            assert server.has_prefix(pid)
            return ml.serving_snapshot()["llms"]["chat"]
        finally:
            server.close()

    entry = run(scenario())
    tier = entry["kv_host_tier"]
    assert tier["budget_bytes"] == 64 * 1024 * 1024
    assert {"entries", "bytes", "spills", "restores",
            "restore_fallbacks"} <= set(tier)
