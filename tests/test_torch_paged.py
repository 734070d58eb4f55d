"""PyTorch port, paged KV cache and chunked prefill, held against the JAX
package on the tiny config at f32 (same weights, inputs from a numpy seed;
the JAX side with ``use_flash=False``, as ``test_torch_generate.py`` runs
it).

Function level: ``paged_prefill_into``, ``paged_suffix_prefill``,
``paged_decode_step`` and the dense ``prefill_segment_into`` with f32,
int8 and int4 pages, on the same page table: logits and f32 cache
values within ``TOL`` (1e-4, as ``test_torch_llama.py``); int8/int4 codes,
scales and zero points bit for bit. Page 0 is scratch: what lands there is
never read by a live row, so it is left out of the comparison, except to
check that a row at virtual capacity writes there and nowhere else.

Generator level: twins of the JAX package's paged tests
(``tests/test_llama.py``): each scenario runs on the JAX Generator and on
the port's under the same options, and the greedy tokens (and the pool's
counters) must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.ml.generate import PrefixEvicted as JPrefixEvicted
from gofr_tpu.models import llama as jllama
from gofr_tpu.ops import quantize_kv4 as jquantize_kv4
from gofr_tpu_torch.ml.generate import Generator, PagePoolExhausted, PrefixEvicted
from gofr_tpu_torch.models import llama as tllama
from gofr_tpu_torch.ops import dequantize_kv4, quantize_kv4

pytestmark = pytest.mark.timeout(300)

TOL = dict(atol=1e-4, rtol=1e-4)
KV_BITS = [16, 8, 4]


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


def _bits(x) -> np.ndarray:
    """A cache array as comparable numpy: bf16 by its 16-bit pattern."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_pool_equal(tcache, jcache):
    """Same keys, shapes and dtypes; pages 1.. of f32 values within TOL,
    of quantized values and planes bit for bit; ``len`` equal."""
    assert set(tcache) == set(jcache)
    for key in jcache:
        want, got = _bits(jcache[key]), _bits(tcache[key])
        assert got.shape == want.shape and got.dtype == want.dtype, key
        if key == "len":
            np.testing.assert_array_equal(got, want)
        elif got.dtype == np.float32:
            np.testing.assert_allclose(got[:, 1:], want[:, 1:], **TOL)
        else:
            np.testing.assert_array_equal(got[:, 1:], want[:, 1:], key)


def _tokens(r, n, bucket, vocab=512):
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :n] = r.integers(0, vocab, n)
    return toks


# -- ops ------------------------------------------------------------------------

def test_quantize_kv4_bit_exact():
    """Packed codes, scales and zero points equal JAX's bit for bit, on
    random vectors and on the edges: a constant vector (the 1e-6 floor on
    the range), exact .5 codes (round half to even), extremes."""
    r = np.random.default_rng(0)
    x = r.standard_normal((64, 4, 32)).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 0] = 1.5
    x[2, 0] = np.linspace(0.0, 15.0, 32)
    x[2, 1] = np.arange(32) % 16 + 0.5
    x[3, 0, ::2], x[3, 0, 1::2] = -1e4, 1e4
    want = jquantize_kv4(jnp.asarray(x))
    got = quantize_kv4(torch.from_numpy(x))
    for w, g in zip(want, got, strict=True):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert got[0].dtype == torch.uint8 and got[0].shape == (64, 4, 16)
    back = dequantize_kv4(*got, torch.float32)
    np.testing.assert_allclose(back[4:].numpy(), x[4:],
                               atol=float(got[1].float().max()) / 2 + 1e-3)


# -- paged functions against JAX --------------------------------------------------

PS, P_MAX, N_PAGES = 4, 6, 16


def _pools(jcfg, tcfg, batch=2):
    return (jllama.init_paged_cache(jcfg, batch, N_PAGES, PS),
            tllama.init_paged_cache(tcfg, batch, N_PAGES, PS, device="cpu"))


def _prefilled(pair, r):
    """Both pools after one 11-token prompt into pages [3, 7, 1] of slot 0
    (a 16 bucket: its fourth page is scratch)."""
    jcfg, jparams, tcfg, tparams = pair
    jc, tc = _pools(jcfg, tcfg)
    toks, lens = _tokens(r, 11, 16), np.array([11], np.int32)
    row = np.array([3, 7, 1, 0], np.int32)
    jl, jc = jllama.paged_prefill_into(jparams, jnp.asarray(toks),
                                       jnp.asarray(lens), jcfg, jc,
                                       jnp.asarray(row), 0, PS)
    tl, tc = tllama.paged_prefill_into(tparams, toks, lens, tcfg, tc, row, 0,
                                       PS)
    return (jl, jc), (tl, tc)


@pytest.mark.parametrize("kv_bits", KV_BITS)
def test_paged_prefill_into_matches_jax(pairs, kv_bits):
    (jl, jc), (tl, tc) = _prefilled(pairs[kv_bits], np.random.default_rng(0))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_pool_equal(tc, jc)
    assert int(tc["len"][0]) == 11


@pytest.mark.parametrize("kv_bits", KV_BITS)
def test_paged_suffix_prefill_matches_jax(pairs, kv_bits):
    """A 5-token suffix at virtual offset 10 (mid-page) over the prefilled
    pages: it attends them through the table, writes its own positions
    into pages 1 and 9 of the table [3, 7, 1, 9, 5, 2]."""
    jcfg, jparams, tcfg, tparams = pairs[kv_bits]
    r = np.random.default_rng(1)
    (_, jc), (_, tc) = _prefilled(pairs[kv_bits], r)
    row = np.array([3, 7, 1, 9, 5, 2], np.int32)
    toks, lens = _tokens(r, 5, 8), np.array([5], np.int32)
    jl, jc = jllama.paged_suffix_prefill(jparams, jnp.asarray(toks),
                                         jnp.asarray(lens), jcfg, jc,
                                         jnp.asarray(row), 10, PS)
    tl, tc = tllama.paged_suffix_prefill(tparams, toks, lens, tcfg, tc, row,
                                         10, PS)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_pool_equal(tc, jc)


@pytest.mark.parametrize("kv_bits", KV_BITS)
def test_paged_suffix_prefill_past_capacity_writes_scratch(pairs, kv_bits):
    """A segment running past the table's virtual capacity (P_MAX * PS = 24
    positions) writes its overflow into scratch page 0, never into a real
    page, and matches JAX where it is read."""
    jcfg, jparams, tcfg, tparams = pairs[kv_bits]
    r = np.random.default_rng(2)
    (_, jc), (_, tc) = _prefilled(pairs[kv_bits], r)
    row = np.array([3, 7, 1, 9, 5, 2], np.int32)
    toks, lens = _tokens(r, 8, 8), np.array([8], np.int32)
    before = {k: v.clone() for k, v in tc.items()}
    jl, jc = jllama.paged_suffix_prefill(jparams, jnp.asarray(toks),
                                         jnp.asarray(lens), jcfg, jc,
                                         jnp.asarray(row), 20, PS)
    tl, tc = tllama.paged_suffix_prefill(tparams, toks, lens, tcfg, tc, row,
                                         20, PS)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_pool_equal(tc, jc)
    untouched = [p for p in range(1, N_PAGES) if p != 2]  # page 2: 20..23
    for key in ("k", "v"):
        assert torch.equal(tc[key][:, untouched], before[key][:, untouched])
    assert not torch.equal(tc["k"][:, 0], before["k"][:, 0])


@pytest.mark.parametrize("kv_bits", KV_BITS)
def test_paged_decode_step_matches_jax(pairs, kv_bits):
    """Three decode steps of two rows: row 0 at position 15 (it crosses
    into the table's fifth page), row 1 at virtual capacity (its writes
    land in scratch page 0 and nowhere else). Logits within TOL, pool
    equal, and a gather of 5 table columns (enough for row 0) gives the
    same logits as all 6."""
    jcfg, jparams, tcfg, tparams = pairs[kv_bits]
    r = np.random.default_rng(3)
    (_, jc), (_, tc) = _prefilled(pairs[kv_bits], r)
    table = np.array([[3, 7, 1, 9, 5, 2], [4, 6, 8, 10, 11, 12]], np.int32)
    lens = np.array([15, P_MAX * PS], np.int32)
    jc = {**jc, "len": jnp.asarray(lens)}
    tc["len"] = torch.from_numpy(lens.copy())
    tc_full = {k: v.clone() for k, v in tc.items()}
    row1_pages = [int(p) for p in table[1]]
    before = {k: v[:, row1_pages].clone() for k, v in tc.items() if k != "len"}
    tok = np.array([5, 9], np.int32)
    for _ in range(3):
        jl, jc = jllama.paged_decode_step(jparams, jnp.asarray(tok), jc,
                                          jnp.asarray(table), jcfg)
        tl, tc = tllama.paged_decode_step(tparams, tok, tc, table, tcfg,
                                          n_cols=5)
        full, tc_full = tllama.paged_decode_step(tparams, tok, tc_full,
                                                 table, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(tl.numpy(), full.numpy())
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    _assert_pool_equal(tc, jc)
    assert tc["len"].tolist() == [18, P_MAX * PS]
    for key, was in before.items():
        assert torch.equal(tc[key][:, row1_pages], was), key


@pytest.mark.parametrize("kv_bits", KV_BITS)
def test_chip_smoke_paged_reference_reads_the_pool_as_the_path_does(
        pairs, kv_bits):
    """``chip_smoke.paged_attention_reference`` (the card check's reference
    for the paged decode kernels) reads the pool apart from the path and
    must compute the path's attention: on the CPU both are plain, so they
    agree within TOL at every layer, over a table in scattered order with
    rows of different live lengths."""
    import chip_smoke

    _, _, tcfg, _ = pairs[kv_bits]
    r = np.random.default_rng(11)
    (_, _), (_, tc) = _prefilled(pairs[kv_bits], r)
    table = torch.tensor([[3, 7, 1, 9, 5, 2], [4, 6, 8, 10, 11, 12]],
                         dtype=torch.int32)
    virt = table[:, :5].reshape(-1)
    kv_len = torch.tensor([11, 17], dtype=torch.int32)
    q = torch.from_numpy(r.standard_normal(
        (2, 1, tcfg.n_heads, tcfg.head_dim)).astype(np.float32))
    for layer in range(tcfg.n_layers):
        want = tllama._paged_attention(tcfg, q, tc, layer, virt, kv_len)
        got = chip_smoke.paged_attention_reference(tcfg, q, tc, layer, virt,
                                                   kv_len)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_prefill_segment_into_matches_jax(pairs, kv_bits):
    """A 13-token prompt as segments of 8 into slot 1 of the dense cache
    (the first non-final with len = capacity, the second final), then one
    decode step in which slot 1 is parked at capacity (its write is
    dropped: JAX's out-of-bounds scatter, the port's masked write)."""
    jcfg, jparams, tcfg, tparams = pairs[kv_bits]
    r = np.random.default_rng(4)
    S = 32
    jc = jllama.init_cache(jcfg, 2, S)
    tc = tllama.init_cache(tcfg, 2, S, device="cpu")
    ids = r.integers(0, 512, 13).astype(np.int32)
    for start, final in ((0, False), (8, True)):
        seg = ids[start:start + 8]
        toks = np.zeros((1, 8), np.int32)
        toks[0, :len(seg)] = seg
        lens = np.array([len(seg)], np.int32)
        new_len = 13 if final else S
        jl, jc = jllama.prefill_segment_into(
            jparams, jnp.asarray(toks), jnp.asarray(lens), jcfg, jc,
            jnp.int32(1), jnp.int32(start), jnp.int32(new_len))
        tl, tc = tllama.prefill_segment_into(tparams, toks, lens, tcfg, tc,
                                             1, start, new_len)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        if not final:
            parked = {k: v[:, 1].clone() for k, v in tc.items() if k != "len"}
            dl, jc_d = jllama.decode_step(jparams, jnp.asarray([3, 4]), jc,
                                          jcfg)
            tdl, tc_d = tllama.decode_step(
                tparams, np.array([3, 4], np.int32),
                {k: v.clone() for k, v in tc.items()}, tcfg)
            np.testing.assert_allclose(tdl.numpy()[0], np.asarray(dl)[0],
                                       **TOL)
            for key, was in parked.items():
                assert torch.equal(tc_d[key][:, 1], was), key
            assert tc_d["len"].tolist() == np.asarray(jc_d["len"]).tolist()
    for key in jc:
        want, got = _bits(jc[key]), _bits(tc[key])
        if got.dtype == np.float32:
            np.testing.assert_allclose(got, want, **TOL)
        else:
            np.testing.assert_array_equal(got, want, key)


# -- the Generator against the JAX Generator ------------------------------------

def _both(pairs, kv_bits, scenario, **kw):
    """Run ``scenario(gen)`` on a JAX Generator and on the port's, built
    with the same options ``kw``; returns (JAX result, port result)."""
    jcfg, jparams, tcfg, tparams = pairs[kv_bits]
    want = scenario(JGenerator(jparams, jcfg, **kw), JPrefixEvicted)
    got = scenario(Generator(tparams, tcfg, device="cpu", **kw),
                   PrefixEvicted)
    return want, got


def _run_all(gen, streamed):
    while gen.n_live:
        gen.step()
    gen.drain()
    return streamed


def _sink(streamed, key):
    return lambda _slot, toks: streamed.setdefault(key, []).extend(toks)


@pytest.mark.parametrize("kv_bits", KV_BITS)
def test_paged_generator_matches_jax_and_dense(pairs, kv_bits):
    """Paged greedy output equals the JAX paged Generator's, across slots
    and slot reuse; at f32 it also equals the port's own dense output
    (int8: dense int8), and every page comes back after release."""
    prompts = [[3, 1, 4, 1, 5], [2, 7], [9, 9, 2, 6]]
    kw = dict(batch_slots=2, max_seq=32, prefill_buckets=(8,), chunk=2,
              page_size=8)

    def scenario(gen, _evicted):
        outs = [gen.generate(p, max_new_tokens=7) for p in prompts]
        return outs, gen.free_pages == gen.n_pages - 1

    want, got = _both(pairs, kv_bits, scenario, **kw)
    assert got == want and got[1]
    if kv_bits != 4:
        _, _, tcfg, tparams = pairs[kv_bits]
        dense = Generator(tparams, tcfg, device="cpu", batch_slots=2,
                          max_seq=32, prefill_buckets=(8,), chunk=2)
        assert [dense.generate(p, 7) for p in prompts] == got[0]


def test_int4_needs_pages(pairs):
    _, _, tcfg, tparams = pairs[4]
    with pytest.raises(ValueError, match="page_size"):
        Generator(tparams, tcfg, device="cpu", batch_slots=1, max_seq=32)


def test_paged_capacity_beyond_dense_equivalent(pairs):
    """With a pool HALF the dense worst case, 4 slots still serve short
    requests concurrently, each equal to its JAX twin, none evicted."""
    kw = dict(batch_slots=4, max_seq=32, prefill_buckets=(8,), chunk=2,
              page_size=8, n_pages=1 + 4 * 4 // 2)
    prompts = [[i + 1, i + 2, i + 3] for i in range(4)]

    def scenario(gen, _evicted):
        streamed: dict = {}
        slots = [gen.add_request(p, 5, callback=_sink(streamed, i))
                 for i, p in enumerate(prompts)]
        _run_all(gen, streamed)
        return [streamed[i] for i in range(4)], slots, gen.evictions

    want, got = _both(pairs, 16, scenario, **kw)
    assert got == want and got[2] == 0


def test_paged_pool_exhaustion_truncates_not_corrupts(pairs):
    """A dry pool truncates the growing slot (``evictions``) instead of
    corrupting neighbours; the pages come back, and the next request
    decodes as in JAX."""
    kw = dict(batch_slots=2, max_seq=32, prefill_buckets=(8,), chunk=2,
              page_size=8, n_pages=4)

    def scenario(gen, _evicted):
        a = gen.add_request([3, 1, 4], 24)
        _run_all(gen, {})
        toks = list(gen.slots[a].tokens)
        evicted = gen.slots[a].evicted
        gen.release(a)
        return toks, evicted, gen.evictions, gen.free_pages, \
            gen.generate([2, 7], 5)

    want, got = _both(pairs, 16, scenario, **kw)
    assert got == want
    toks, evicted, evictions, free, _ = got
    assert evicted and evictions >= 1 and 1 <= len(toks) < 24 and free == 3


def test_paged_admission_without_pages_raises(pairs):
    """No pages, no slot: admission raises the typed back-pressure error
    and leaves nothing admitted."""
    _, _, tcfg, tparams = pairs[16]
    gen = Generator(tparams, tcfg, device="cpu", batch_slots=2, max_seq=32,
                    prefill_buckets=(8,), chunk=2, page_size=8, n_pages=3)
    a = gen.add_request([1, 2, 3, 4, 5, 6, 7], 9)  # holds both real pages
    with pytest.raises(PagePoolExhausted):
        gen.add_request([5, 6], 4)
    assert gen.n_live == 1 and gen.slots[a].live


@pytest.mark.parametrize("kv_bits", KV_BITS)
def test_shared_prefix_matches_full_prompt(pairs, kv_bits):
    """register_prefix + suffix admission equals JAX's: two slots BORROW
    the same physical page, releases keep it with the prefix. At fp and
    int8 pages it also equals the full prompt through the port's own paged
    path (as JAX's tests hold it); at int4 the suffix attends the prefix
    dequantized where a whole-prompt prefill attends it exact, and the
    coarser codes move greedy tokens."""
    prefix = [5, 9, 2, 7, 1, 4, 8, 3]
    suffixes = [[6, 2], [9, 9, 1]]
    kw = dict(batch_slots=2, max_seq=32, prefill_buckets=(8, 16), chunk=2,
              page_size=8)

    def scenario(gen, _evicted):
        pid = gen.register_prefix(prefix)
        streamed: dict = {}
        slots = [gen.add_request(sfx, 6, prefix=pid,
                                 callback=_sink(streamed, i))
                 for i, sfx in enumerate(suffixes)]
        shared = gen._table[slots[0], 0] == gen._table[slots[1], 0] != 0
        _run_all(gen, streamed)
        for slot in slots:
            gen.release(slot)
        refs = gen._prefixes[pid]["refs"]
        gen.drop_prefix(pid)
        return ([streamed[i] for i in range(2)], bool(shared), refs,
                gen.free_pages == gen.n_pages - 1)

    want, got = _both(pairs, kv_bits, scenario, **kw)
    assert got == want and got[1:] == (True, 0, True)
    if kv_bits == 4:
        return
    _, _, tcfg, tparams = pairs[kv_bits]
    full = Generator(tparams, tcfg, device="cpu", **kw)
    assert [full.generate(prefix + s, 6) for s in suffixes] == got[0]


def test_shared_prefix_partial_page_tail(pairs):
    """A prefix that is not page-aligned shares its whole pages only; the
    tail re-prefills with each suffix — as in JAX."""
    prefix = [5, 9, 2, 7, 1, 4, 8, 3, 6, 6]
    kw = dict(batch_slots=2, max_seq=32, prefill_buckets=(8, 16), chunk=2,
              page_size=8)

    def scenario(gen, _evicted):
        pid = gen.register_prefix(prefix)
        info = (gen._prefixes[pid]["len"], gen._prefixes[pid]["tail"])
        streamed: dict = {}
        gen.add_request([2, 2], 6, prefix=pid, callback=_sink(streamed, 0))
        return info, _run_all(gen, streamed)[0]

    want, got = _both(pairs, 16, scenario, **kw)
    assert got == want and got[0] == (8, [6, 6])


def test_prefix_lru_eviction_rotating_prompts(pairs):
    """Rotating registered prefixes never exhaust the pool: idle ones
    LRU-evict, a borrowed one never does, admitting on an evicted id raises
    the typed PrefixEvicted; the counts equal JAX's."""
    kw = dict(batch_slots=2, max_seq=32, prefill_buckets=(8, 16), chunk=2,
              page_size=8, n_pages=5)

    def scenario(gen, evicted_error):
        first = gen.register_prefix([1, 2, 3, 4, 5, 6, 7, 8])
        slot = gen.add_request([9, 9], 2, prefix=first)
        pids = [gen.register_prefix([i + 1] * 8) for i in range(6)]
        state = (gen.prefix_evictions, gen.has_prefix(first),
                 gen.has_prefix(pids[-1]), gen.has_prefix(pids[0]))
        with pytest.raises(evicted_error):
            gen.add_request([7], 2, prefix=pids[0])
        _run_all(gen, {})
        gen.release(slot)
        refs = gen._prefixes[first]["refs"]
        for _ in range(4):
            gen.register_prefix([3] * 8)
        return state, refs, gen.has_prefix(first), gen.prefix_evictions

    want, got = _both(pairs, 16, scenario, **kw)
    assert got == want
    (evictions, first_kept, newest_kept, oldest_kept), refs, first_left, _ \
        = got
    assert evictions > 0 and first_kept and newest_kept and not oldest_kept
    assert refs == 0 and not first_left


def test_grow_pages_reclaims_idle_prefix_before_truncating(pairs):
    """Under pool pressure mid-decode an idle prefix's pages go before a
    live stream is truncated: the stream gets its full budget."""
    kw = dict(batch_slots=1, max_seq=32, prefill_buckets=(8,), chunk=2,
              page_size=8, n_pages=5)

    def scenario(gen, _evicted):
        pid = gen.register_prefix([1, 2, 3, 4, 5, 6, 7, 8])
        streamed: dict = {}
        slot = gen.add_request([5, 3, 2, 6, 1, 9, 4, 7], 20,
                               callback=_sink(streamed, 0))
        _run_all(gen, streamed)
        return (streamed[0], gen.slots[slot].evicted, gen.evictions,
                gen.has_prefix(pid), gen.prefix_evictions)

    want, got = _both(pairs, 16, scenario, **kw)
    assert got == want
    assert len(got[0]) == 20 and got[1:] == (False, 0, False, 1)


@pytest.mark.parametrize("kv_bits,paged", [
    (16, False), (8, False), (16, True), (8, True), (4, True)])
def test_chunked_prefill_matches_jax_and_whole_prompt(pairs, kv_bits, paged):
    """prefill_chunk=8: a 40-token prompt admitted while a short stream
    decodes prefills in segments between decode dispatches, and the short
    stream keeps receiving tokens meanwhile; both streams equal their JAX
    twins (dense and paged; int4 is paged only). At fp and int8 the long
    stream also equals the port's whole-prompt decode; at int4 a later
    segment attends earlier ones dequantized, which the coarser codes make
    visible in greedy tokens (the short stream still equals it)."""
    long_prompt = list((np.arange(40) % 200 + 3).astype(int))
    short = [5, 3, 2]
    kw = dict(batch_slots=2, max_seq=64, prefill_buckets=(8, 64), chunk=2,
              prefill_chunk=8, **({"page_size": 8} if paged else {}))

    def scenario(gen, _evicted):
        streamed: dict = {}
        gen.add_request(short, 12, callback=_sink(streamed, 0))
        gen.step()
        gen.add_request(long_prompt, 8, callback=_sink(streamed, 1))
        interleaved = 0
        while gen._chunked:  # the long prompt is mid-prefill
            before = len(streamed[0])
            gen.step()
            interleaved += len(streamed[0]) > before
        _run_all(gen, streamed)
        return (streamed[0], streamed[1], gen.prefill_segments_run,
                interleaved)

    want, got = _both(pairs, kv_bits, scenario, **kw)
    assert got == want
    assert got[2] == 5 and got[3] >= 1
    _, _, tcfg, tparams = pairs[kv_bits]
    whole = Generator(tparams, tcfg, device="cpu", batch_slots=1, max_seq=64,
                      prefill_buckets=(64,), **({"page_size": 8} if paged
                                                 else {}))
    assert whole.generate(short, 12) == got[0]
    if kv_bits != 4:
        assert whole.generate(long_prompt, 8) == got[1]


def test_gather_columns_follow_the_live_rows(pairs):
    """A paged step gathers a power of two of table columns covering the
    live slot with the most pages, never more than the table holds."""
    _, _, tcfg, tparams = pairs[16]
    gen = Generator(tparams, tcfg, device="cpu", batch_slots=2, max_seq=64,
                    prefill_buckets=(8, 64), chunk=2, page_size=4)
    assert gen._gather_cols() == 1
    gen.add_request(list(range(1, 10)), 2)  # 9 + max_new 2 -> 3 pages
    assert gen._gather_cols() == 4
    gen.add_request(list(range(1, 22)), 2)  # 21 + 2 -> 6 pages
    assert gen._gather_cols() == 8
    stats = gen.pool_stats()
    assert stats["free_pages"] == gen.n_pages - 1 - 9
    assert stats["page_bytes"] == 2 * tcfg.n_layers * 4 * tcfg.n_kv_heads \
        * tcfg.head_dim * 4


def test_warmup_leaves_paged_output_unchanged(pairs):
    """warmup runs the paged decode, prefill per bucket, suffix and segment
    programs on scratch pages only: output after it is unchanged."""
    _, _, tcfg, tparams = pairs[8]
    kw = dict(batch_slots=2, max_seq=64, prefill_buckets=(8, 64), chunk=2,
              page_size=8, prefill_chunk=16)
    cold = Generator(tparams, tcfg, device="cpu", **kw)
    warm = Generator(tparams, tcfg, device="cpu", **kw)
    warm.warmup()
    assert warm.free_pages == warm.n_pages - 1
    prompt = list(range(3, 40))
    assert warm.generate(prompt, 6) == cold.generate(prompt, 6)


def test_scheduler_segment_budget_matches_jax():
    """The port's segment budget plans what the JAX scheduler plans, at
    its default prefill share: (chunk, segments) for every decodable count
    with and without prefill pending, light and busy batches."""
    from gofr_tpu.ml.scheduler import TokenBudgetScheduler as JScheduler
    from gofr_tpu_torch.ml.generate import _chunk_ladder
    from gofr_tpu_torch.ml.scheduler import TokenBudgetScheduler

    for budget, chunk, prefill_chunk, slots in ((1056, 4, 512, 8),
                                                (20, 2, 8, 2),
                                                (64, 8, 16, None)):
        ladder = _chunk_ladder(chunk)
        j = JScheduler(budget, ladder, prefill_chunk, slots=slots)
        t = TokenBudgetScheduler(budget, ladder, prefill_chunk, slots=slots)
        for n in range(0, 10):
            for pending in (False, True):
                assert t.plan(n, pending) == j.plan(n, pending), \
                    (budget, n, pending)
                assert t.last_segments == j.last_segments
