"""PyTorch port, the shared-prefix cache and paged serving: twins of the JAX
package's ``tests/test_prefix_cache.py`` and of the paged and chunked
serving tests of ``tests/test_llm_serving.py``.

The radix units run on a stub generator (the cache's policy needs no
device). The generator and server scenarios run the port on the CPU at f32
(the tiny config, the JAX tree carried across) and hold every stream's
greedy tokens equal to the JAX Generator's under the same options
(``use_flash=False``, as ``test_torch_generate.py`` runs it).
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch.ml.generate import Generator
from gofr_tpu_torch.ml.llm import LLMServer
from gofr_tpu_torch.ml.prefix_cache import PrefixCacheConfig, RadixPrefixCache
from gofr_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.timeout(300)


class StubGen:
    """Generator double exposing exactly the surface the cache touches."""

    def __init__(self, page_size=4, max_seq=512, prefill_buckets=(64,),
                 n_pages=64):
        self.page_size = page_size
        self.max_seq = max_seq
        self.prefill_buckets = prefill_buckets
        self.n_pages = n_pages
        self._prefixes = {}
        self._next = 1

    def register_prefix(self, ids, pinned=False):
        ids = [int(t) for t in ids]
        shared = (len(ids) // self.page_size) * self.page_size
        pid = self._next
        self._next += 1
        self._prefixes[pid] = {
            "pages": list(range(shared // self.page_size)), "len": shared,
            "tail": ids[shared:], "ids_full": ids, "refs": 0,
            "last_use": pid, "pinned": bool(pinned),
        }
        return pid

    def has_prefix(self, pid):
        return pid in self._prefixes

    def drop_prefix(self, pid, spill=False):
        info = self._prefixes[pid]
        if info["refs"] > 0:
            raise RuntimeError(f"prefix {pid} still borrowed")
        del self._prefixes[pid]
        return False


# -- radix units ------------------------------------------------------------------

def test_longest_match_exact_partial_nested():
    gen = StubGen(page_size=4)
    cache = RadixPrefixCache(gen, PrefixCacheConfig(promote_hits=99))
    short, long = list(range(1, 9)), list(range(1, 17))
    p_short, p_long = cache.pin(short), cache.pin(long)
    assert p_short != p_long
    assert cache.observe(long + [77]) == (p_long, 16)
    assert cache.observe(short + [50, 51]) == (p_short, 8)
    assert cache.observe([1, 2, 3, 99]) == (None, 0)
    # an exact page-aligned prompt leaves nothing to prefill: declined
    assert cache.observe(list(short))[0] is None
    assert cache.peek(long + [5]) == (p_long, 16)


def test_automatic_promotion_threshold():
    gen = StubGen(page_size=4)
    cache = RadixPrefixCache(gen, PrefixCacheConfig(promote_hits=3))
    base = [5, 6, 7, 8, 9, 10]
    assert cache.observe(base + [100]) == (None, 0)
    assert cache.observe(base + [101]) == (None, 0)
    pid, reg_len = cache.observe(base + [102])   # 3rd: promotes and hits
    assert pid is not None and reg_len == 6
    assert gen._prefixes[pid]["len"] == 4
    cache.commit_hit(pid)
    assert (cache.hits, cache.misses, cache.tokens_saved) == (1, 2, 4)
    assert cache.observe(base + [103])[0] == pid


def test_short_prefixes_never_promote():
    gen = StubGen(page_size=8)
    cache = RadixPrefixCache(gen, PrefixCacheConfig(promote_hits=1))
    for i in range(4):
        assert cache.observe([1, 2, 3, i + 10]) == (None, 0)
    assert not gen._prefixes


def test_borrowed_prefix_skipped_for_next_oldest():
    gen = StubGen(page_size=4)
    cache = RadixPrefixCache(
        gen, PrefixCacheConfig(promote_hits=1, max_prefixes=2))
    pid_a, _ = cache.observe([1, 2, 3, 4, 5, 6])
    pid_b, _ = cache.observe([21, 22, 23, 24, 25, 26])
    assert pid_a and pid_b and len(gen._prefixes) == 2
    gen._prefixes[pid_a]["refs"] = 1
    pid_c, _ = cache.observe([31, 32, 33, 34, 35, 36])
    assert pid_c is not None
    assert gen.has_prefix(pid_a) and not gen.has_prefix(pid_b)
    assert cache.evictions == 1
    gen._prefixes[pid_c]["refs"] = 1
    assert cache.observe([41, 42, 43, 44, 45, 46])[0] is None
    assert gen.has_prefix(pid_a) and gen.has_prefix(pid_c)
    assert [r["pid"] for r in cache.hot_prefixes()] == []


def test_generator_side_eviction_detected():
    gen = StubGen(page_size=4)
    cache = RadixPrefixCache(gen, PrefixCacheConfig(promote_hits=1))
    pid, _ = cache.observe([1, 2, 3, 4, 5, 6])
    del gen._prefixes[pid]
    pid2, _ = cache.observe([1, 2, 3, 4, 5, 6, 7])
    assert cache.evictions == 1
    assert pid2 is not None and pid2 != pid and gen.has_prefix(pid2)
    cache.invalidate(pid2)
    assert cache.evictions == 2 and cache.peek([1, 2, 3, 4, 5, 6, 7])[0] is None


def test_metrics_counters_exported():
    counts = {}

    class _Metrics:
        def add_counter(self, name, delta, **labels):
            counts[name] = counts.get(name, 0) + delta

    gen = StubGen(page_size=4)
    cache = RadixPrefixCache(gen, PrefixCacheConfig(promote_hits=2),
                             metrics=_Metrics(), model="m")
    base = [5, 6, 7, 8, 9]
    cache.observe(base + [100])
    for tail in (101, 102):
        pid, _ = cache.observe(base + [tail])
        cache.commit_hit(pid)
    assert counts == {"app_ml_prefix_misses_total": 1,
                      "app_ml_prefix_hits_total": 2,
                      "app_ml_prefill_tokens_saved_total": 8}
    snap = cache.snapshot()
    assert (snap["hits"], snap["misses"], snap["prefill_tokens_saved"]) \
        == (2, 1, 8)


# -- the generator and the server ------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = jllama.tiny_llama(dtype=jnp.float32, use_flash=False)
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams


def _jax_alone(model, prompts, n, **kw):
    """Each prompt alone through one JAX Generator (the expectation)."""
    jcfg, jparams, _, _ = model
    kw = {"batch_slots": 1, "max_seq": 64, "prefill_buckets": (64,), **kw}
    gen = JGenerator(jparams, jcfg, **kw)
    return [gen.generate(p, n) for p in prompts]


def _server(model, prefix_cache=None, **kw):
    _, _, tcfg, tparams = model
    return LLMServer(Generator(tparams, tcfg, device="cpu", **kw),
                     prefix_cache=prefix_cache)


def test_pressure_reclaim_unpinned_first_pinned_last(model):
    """Reclaim order, as in JAX: idle unpinned prefixes first (LRU), pinned
    ones last, borrowed ones never."""
    jcfg, jparams, tcfg, tparams = model
    kw = dict(batch_slots=2, max_seq=64, prefill_buckets=(8,), page_size=8,
              n_pages=8)

    def scenario(gen):
        p_pin = gen.register_prefix([1] * 8, pinned=True)
        p_auto1 = gen.register_prefix([2] * 8)
        p_auto2 = gen.register_prefix([3] * 8)
        p_borrowed = gen.register_prefix([4] * 8)
        gen._prefixes[p_borrowed]["refs"] = 1
        out = [gen._reclaim_prefix_pages(len(gen._free_pages) + 1),
               gen.has_prefix(p_auto1), gen.has_prefix(p_pin),
               gen.has_prefix(p_auto2)]
        out += [gen._reclaim_prefix_pages(len(gen._free_pages) + 2),
                gen.has_prefix(p_auto2), gen.has_prefix(p_pin),
                gen.has_prefix(p_borrowed)]
        gen._prefixes[p_borrowed]["refs"] = 0
        out.append(gen._reclaim_prefix_pages(gen.n_pages + 10))
        return out

    got = scenario(Generator(tparams, tcfg, device="cpu", **kw))
    assert got == scenario(JGenerator(jparams, jcfg, **kw))
    assert got == [True, False, True, True, True, False, False, True, False]


def test_server_equivalence_and_tokens_saved(model, run):
    """With the cache on, repeats prefill only the suffix (tokens saved
    counted), tokens equal the cache-off server's and JAX's."""
    prefix = [5, 9, 2, 7, 1, 4, 8, 3, 6]
    suffixes = [[6, 2], [9, 1, 1], [6, 2]]
    want = _jax_alone(model, [prefix + s for s in suffixes], 5)

    async def scenario(cache_on):
        server = _server(model, None if cache_on else False, batch_slots=2,
                         max_seq=64, prefill_buckets=(8, 16), chunk=2,
                         page_size=4)
        try:
            outs = [await server.generate(prefix + s, 5) for s in suffixes]
            snap = server.prefix_cache.snapshot() if server.prefix_cache \
                else None
            return outs, snap
        finally:
            server.close()

    plain, no_snap = run(scenario(False))
    cached, snap = run(scenario(True))
    assert no_snap is None
    assert cached == plain == want
    assert snap["misses"] == 1 and snap["hits"] == 2
    assert snap["prefill_tokens_saved"] == 2 * 8
    assert snap["prefixes"] and snap["prefixes"][0]["refs"] == 0


def test_check_admissible_accepts_cache_covered_long_prompt(model, run):
    """A prompt longer than the largest bucket is refused cold; once its
    prefix is cached only the suffix prefills, so it admits and decodes
    like JAX's whole-prompt path."""
    pfx = list(range(1, 15))
    long_prompt = pfx + [50, 51, 52, 53]
    want = _jax_alone(model, [long_prompt], 5, prefill_buckets=(32,))[0]

    async def scenario():
        server = _server(model, batch_slots=2, max_seq=64,
                         prefill_buckets=(8, 16), chunk=2, page_size=4)
        try:
            with pytest.raises(ValueError, match="largest prefill bucket"):
                server.check_admissible(long_prompt, 4)
            await asyncio.to_thread(server.register_prefix, pfx)
            server.check_admissible(long_prompt, 4)
            return await server.generate(long_prompt, 5)
        finally:
            server.close()

    assert run(scenario()) == want


def test_explicit_pin_survives_cache_churn(model, run):
    """register_prefix through the server pins on the cache; prefix=
    admission equals the full prompt; drop_prefix releases it; a pin
    outlives unpinned churn."""
    pfx = [5, 9, 2, 7, 1, 4, 8, 3]
    want = _jax_alone(model, [pfx + [6, 2]], 5)[0]

    async def scenario():
        server = _server(model, PrefixCacheConfig(promote_hits=1,
                                                  max_prefixes=2),
                         batch_slots=2, max_seq=64, prefill_buckets=(8, 16),
                         chunk=2, page_size=8)
        try:
            pid = await asyncio.to_thread(server.register_prefix, pfx)
            assert server.gen._prefixes[pid]["pinned"]
            out = await server.generate([6, 2], 5, prefix=pid)
            ref = await server.generate(pfx + [6, 2], 5)
            for i in range(3):  # unpinned churn at the cache's cap
                await server.generate([40 + i] * 9 + [1], 2)
            assert server.has_prefix(pid)
            await asyncio.to_thread(server.drop_prefix, pid)
            assert not server.has_prefix(pid)
            return out, ref
        finally:
            server.close()

    out, ref = run(scenario())
    assert out == ref == want


def test_paged_pool_backpressure_requeues(model, run):
    """A pool too small for every stream at once: admission hits
    PagePoolExhausted and the server requeues instead of failing; every
    stream ends as JAX's."""
    prompts = [[i + 1, i + 2, i + 3] for i in range(6)]
    want = _jax_alone(model, prompts, 4)

    async def scenario():
        server = _server(model, batch_slots=4, max_seq=32,
                         prefill_buckets=(8,), chunk=2, page_size=8,
                         n_pages=3)
        try:
            return await asyncio.gather(*(server.generate(p, 4)
                                          for p in prompts))
        finally:
            server.close()

    assert run(scenario()) == want


def test_shared_prefix_through_server(model, run):
    prefix = [5, 9, 2, 7, 1, 4, 8, 3]
    suffixes = [[6, 2], [9, 1, 1]]
    want = _jax_alone(model, [prefix + s for s in suffixes], 5)

    async def scenario():
        server = _server(model, batch_slots=2, max_seq=64,
                         prefill_buckets=(8, 16), chunk=2, page_size=8)
        try:
            pid = await asyncio.to_thread(server.register_prefix, prefix)
            return await asyncio.gather(*(server.generate(s, 5, prefix=pid)
                                          for s in suffixes))
        finally:
            server.close()

    assert run(scenario()) == want


def test_rotating_prefixes_never_exhaust_pool(model, run):
    """Registered, used once and abandoned, a rotating set of prefixes
    never exhausts the pool (idle ones LRU-evict), and a concurrent burst
    afterwards still serves under requeue pressure."""
    prefixes = [[i + 1] * 8 for i in range(5)]
    burst = [[i + 2, i + 5, i + 1] for i in range(4)]
    want = _jax_alone(model, [p + [7, 3] for p in prefixes] + burst, 4)

    async def scenario():
        server = _server(model, batch_slots=2, max_seq=32,
                         prefill_buckets=(8, 16), chunk=2, page_size=8,
                         n_pages=5)
        try:
            outs = []
            for pfx in prefixes:
                pid = await asyncio.to_thread(server.register_prefix, pfx)
                outs.append(await server.generate([7, 3], 4, prefix=pid))
            assert server.gen.prefix_evictions > 0
            outs += await asyncio.gather(*(server.generate(p, 4)
                                           for p in burst))
            return outs
        finally:
            server.close()

    assert run(scenario()) == want


@pytest.mark.parametrize("paged", [False, True])
def test_chunked_prefill_lossless_and_nonblocking(model, run, paged):
    """prefill_chunk=8: a long prompt prefills in segments while a short
    stream keeps receiving bursts; both equal JAX's whole-prompt decodes
    (dense, and chunked plus paged)."""
    long_prompt = list((np.arange(40) % 200 + 3).astype(int))
    short = [5, 3, 2]
    ref_long, ref_short = (_jax_alone(model, [long_prompt], 8, max_seq=128)[0],
                           _jax_alone(model, [short], 32, max_seq=128)[0])

    async def scenario():
        server = _server(model, batch_slots=2, max_seq=128,
                         prefill_buckets=(8, 64), chunk=2, prefill_chunk=8,
                         **({"page_size": 8} if paged else {}))
        try:
            bursts, seq, started = [], [0], asyncio.Event()

            async def short_stream():
                out = []
                async for burst in server.stream_chunks(short, 32):
                    seq[0] += 1
                    bursts.append(seq[0])
                    out.extend(burst)
                    started.set()
                return out

            async def long_req():
                await started.wait()  # admitted while the short decodes
                seq[0] += 1
                mark = seq[0]
                return mark, await server.generate(long_prompt, 8)

            short_out, (mark, long_out) = await asyncio.gather(
                short_stream(), long_req())
            assert server.gen.prefill_segments_run == 5
            return short_out, long_out, any(i > mark for i in bursts)
        finally:
            server.close()

    short_out, long_out, interleaved = run(scenario())
    assert short_out == ref_short and long_out == ref_long and interleaved


def test_chunked_prefill_cancel_mid_prefill(model, run):
    """A client walking away during segmented prefill frees the slot."""
    long_prompt = list((np.arange(60) % 200 + 3).astype(int))

    async def scenario():
        server = _server(model, batch_slots=1, max_seq=128,
                         prefill_buckets=(8, 64), chunk=2, prefill_chunk=8)
        try:
            agen = server.stream_chunks(long_prompt, 8)
            task = asyncio.create_task(agen.__anext__())
            await asyncio.sleep(0.05)
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, StopAsyncIteration):
                pass
            await agen.aclose()
            return await asyncio.wait_for(server.generate([5, 3, 2], 4), 60)
        finally:
            server.close()

    assert run(scenario()) == _jax_alone(model, [[5, 3, 2]], 4)[0]


def test_chunked_prefill_pool_dry_evicts_honestly(model, run):
    """The pool running dry mid-segmented-prefill ends the request as an
    'eviction' (never a silent 'stop'), the hog is never corrupted, and
    the pool recovers."""
    long_prompt = list((np.arange(30) % 200 + 3).astype(int))
    hog_prompt = [1, 2, 3, 4, 5, 6, 7]
    want_hog, want_after = _jax_alone(model, [hog_prompt, [5, 3]], 16)

    async def scenario():
        server = _server(model, batch_slots=2, max_seq=64,
                         prefill_buckets=(8, 64), chunk=2, page_size=8,
                         n_pages=7, prefill_chunk=8)
        try:
            hog_task = asyncio.create_task(server.generate(hog_prompt, 16))
            await asyncio.sleep(0.2)
            fin: dict = {}
            out = await asyncio.wait_for(
                server.generate(long_prompt, 8, info=fin), 120)
            hog = await asyncio.wait_for(hog_task, 120)
            after = await asyncio.wait_for(server.generate([5, 3], 4), 120)
            return out, fin, hog, after, server.gen.free_pages
        finally:
            server.close()

    out, fin, hog, after, free = run(scenario())
    assert hog == want_hog
    if len(out) < 8:
        assert fin.get("finish_reason") == "eviction", (out, fin)
    assert after == want_after[:4] and free == 6


def test_int4_pages_serve_like_jax(run):
    """An int4-page generator (``kv_bits=4``) behind the server: greedy
    tokens equal the JAX int4 paged Generator's, with a shared prefix
    promoted by the cache on the way."""
    jcfg = jllama.tiny_llama(dtype=jnp.float32, use_flash=False, kv_bits=4)
    tcfg = tllama.tiny_llama(dtype=torch.float32, kv_bits=4)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    prefix = [5, 9, 2, 7, 1, 4, 8, 3, 6]
    prompts = [prefix + s for s in ([6, 2], [9, 1, 1], [6, 2, 8])]
    kw = dict(batch_slots=2, max_seq=64, prefill_buckets=(8, 16), chunk=2,
              page_size=4)
    # the JAX twin: the first prompt whole, then what the cache does on the
    # second sighting — register the shared 9 tokens (8 on pages, 1 tail)
    # and admit the rest on top of them
    jgen = JGenerator(jparams, jcfg, **kw)
    want = [jgen.generate(prompts[0], 6)]
    pid = jgen.register_prefix(prefix)
    for p in prompts[1:]:
        slot = jgen.add_request(p[len(prefix):], 6, prefix=pid)
        while jgen.slots[slot].live:
            jgen.step()
        jgen.drain()
        want.append(jgen.slots[slot].tokens[:6])
        jgen.release(slot)

    async def scenario():
        server = LLMServer(Generator(tparams, tcfg, device="cpu", **kw))
        try:
            outs = [await server.generate(p, 6) for p in prompts]
            return outs, server.prefix_cache.snapshot()
        finally:
            server.close()

    outs, snap = run(scenario())
    assert outs == want
    assert snap["hits"] == 2 and snap["prefill_tokens_saved"] == 16


def test_cache_readers_race_the_serving_thread(model, run):
    """peek and snapshot read the trie from other threads while the serving thread inserts, promotes and counts:
    with a short switch interval, no reader raises, the last snapshot
    counts every prompt once (a hit or a miss), and the served tokens
    equal JAX's."""
    import sys
    import threading

    prefix = [5, 9, 2, 7, 1, 4, 8, 3, 6]
    prompts = [prefix + [i + 1, i + 2] for i in range(6)]
    want = _jax_alone(model, prompts, 3)
    errors, seen = [], []

    async def scenario():
        server = _server(model, batch_slots=2, max_seq=64,
                         prefill_buckets=(8, 16), chunk=2, page_size=4)
        stop = threading.Event()

        def reader():
            try:
                while not stop.is_set():
                    server.prefix_cache.peek(prefix + [1, 2, 3])
                    snap = server.prefix_cache.snapshot()
                    seen.append(snap["hits"] + snap["misses"])
            except Exception as exc:  # reported by the assertions below
                errors.append(exc)

        threads = [threading.Thread(target=reader) for _ in range(4)]
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            for t in threads:
                t.start()
            return [await server.generate(p, 3) for p in prompts]
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
            sys.setswitchinterval(old)
            server.close()
            assert not any(t.is_alive() for t in threads)

    assert run(scenario()) == want
    assert not errors
    assert seen and seen[-1] == len(prompts)
