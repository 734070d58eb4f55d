"""PyTorch port, speculative decoding (``ml/speculate.py``, the verify
window of ``models/llama.py`` and the speculative ``Generator``), held
against the JAX package on the CPU at f32 (tiny config, the JAX weights
carried across with ``params_from_jax``, the same seeded numpy inputs).

- The verify window: ``decode_window`` and ``paged_decode_window`` logits
  and cache arrays against JAX's (1e-4 at f32; quantized codes and planes
  bit for bit, logits within 1e-3 as ``test_torch_llama.py`` holds the
  int8 path), dense f32 / int8 and pages f32 / int8 / int4; the window
  dispatcher's plain path against JAX's ``ops.attention`` with a per-row
  ``q_offset``.
- Drafts: ``propose_lookup`` equals JAX's on hypothesis histories; the
  standalone ``SpeculativeDecoder`` gives JAX's tokens and counters.
- The Generator: twins of ``tests/test_speculate.py``'s generator tests —
  the same tokens and the same ``spec_windows`` / ``spec_emitted`` /
  ``spec_disables`` as the JAX Generator on the same scenario.
- ``draft_from_env``: the presets, and a checkpoint raising ROADMAP A.12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gofr_tpu import ops as jops
from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.ml.generate import Sampler as JSampler
from gofr_tpu.ml.speculate import SpeculativeDecoder as JSpeculativeDecoder
from gofr_tpu.ml.speculate import propose_lookup as jpropose_lookup
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch import ops as tops
from gofr_tpu_torch.ml.generate import Generator, Sampler
from gofr_tpu_torch.ml.speculate import SpeculativeDecoder, propose_lookup
from gofr_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.timeout(300)

TOL = dict(atol=1e-4, rtol=1e-4)
Q_TOL = dict(atol=1e-3, rtol=1e-3)
PS, P_MAX, N_PAGES = 4, 6, 16


def _pair(seed=0, **kw):
    jcfg = jllama.tiny_llama(dtype=jnp.float32, use_flash=False,
                             max_seq_len=128, **kw)
    tcfg = tllama.tiny_llama(dtype=torch.float32, max_seq_len=128, **kw)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    if kw.get("w8"):
        jparams = jllama.quantize_weights(jparams)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def pairs():
    return {name: _pair(**kw) for name, kw in (
        ("f32", {}), ("int8", {"kv_quant": True}), ("int4", {"kv_bits": 4}))}


def _bits(x) -> np.ndarray:
    """A cache array as comparable numpy: bf16 by its 16-bit pattern."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_arrays(tcache, jcache, first: int = 0):
    """Same keys, shapes and dtypes; f32 arrays within TOL, quantized
    codes and planes bit for bit (from index ``first`` of axis 1: a pool's
    scratch page 0 holds whichever row wrote there last), ``len`` equal."""
    assert set(tcache) == set(jcache)
    for key in jcache:
        want, got = _bits(jcache[key]), _bits(tcache[key])
        assert got.shape == want.shape and got.dtype == want.dtype, key
        if key == "len":
            np.testing.assert_array_equal(got, want)
        elif got.dtype == np.float32:
            np.testing.assert_allclose(got[:, first:], want[:, first:], **TOL)
        else:
            np.testing.assert_array_equal(got[:, first:], want[:, first:],
                                          key)


# -- the verify window ------------------------------------------------------------

@pytest.mark.parametrize("name", ["f32", "int8"])
def test_decode_window_matches_jax(pairs, name):
    """Three rows after a prefill wave, one of them near capacity so part
    of its window falls past S_max (written nowhere, as JAX drops it): the
    window's logits and the cache arrays equal JAX's; ``len`` does not
    move."""
    jcfg, jparams, tcfg, tparams = pairs[name]
    r = np.random.default_rng(0)
    B, S = 3, 24
    toks = r.integers(0, 512, (B, 16)).astype(np.int32)
    lens = np.array([5, 16, 9], np.int32)
    jc = jllama.init_cache(jcfg, B, S)
    tc = tllama.init_cache(tcfg, B, S, device="cpu")
    _, jc = jllama.prefill_into_many(jparams, jnp.asarray(toks),
                                     jnp.asarray(lens), jcfg, jc,
                                     jnp.arange(B), jnp.ones(B, bool))
    _, tc = tllama.prefill_into_many(tparams, toks, lens, tcfg, tc,
                                     np.arange(B), np.ones(B, bool))
    at = np.array([5, 21, 9], np.int32)
    jc = {**jc, "len": jnp.asarray(at)}
    tc["len"] = torch.from_numpy(at.copy())
    window = r.integers(0, 512, (B, 5)).astype(np.int32)
    jl, jc = jllama.decode_window(jparams, jnp.asarray(window), jc, jcfg)
    tl, tc = tllama.decode_window(tparams, torch.from_numpy(window), tc,
                                  tcfg)
    assert tl.shape == (B, 5, 512) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               **(TOL if name == "f32" else Q_TOL))
    _assert_arrays(tc, jc)
    assert tc["len"].tolist() == at.tolist()


def test_decode_window_int4_needs_pages(pairs):
    jcfg, jparams, tcfg, tparams = pairs["int4"]
    window = np.zeros((1, 3), np.int32)
    with pytest.raises(ValueError) as want:
        jllama.decode_window(jparams, jnp.asarray(window),
                             jllama.init_paged_cache(jcfg, 1, 4, PS), jcfg)
    with pytest.raises(ValueError) as got:
        tllama.decode_window(tparams, window,
                             tllama.init_paged_cache(tcfg, 1, 4, PS,
                                                     device="cpu"), tcfg)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["f32", "int8", "int4"])
def test_paged_decode_window_matches_jax(pairs, name):
    """Two rows through their page tables after a paged prefill: row 0's
    window crosses into its third page, row 1's runs past virtual capacity
    (those cells go to scratch page 0). Logits and pool (pages 1..) equal
    JAX's, and a gather of the first 5 table columns (enough for row 0's
    window) gives row 0 the same logits as all 6."""
    jcfg, jparams, tcfg, tparams = pairs[name]
    r = np.random.default_rng(1)
    jc = jllama.init_paged_cache(jcfg, 2, N_PAGES, PS)
    tc = tllama.init_paged_cache(tcfg, 2, N_PAGES, PS, device="cpu")
    toks = np.zeros((1, 16), np.int32)
    toks[0, :11] = r.integers(0, 512, 11)
    row = np.array([3, 7, 1, 0], np.int32)
    _, jc = jllama.paged_prefill_into(jparams, jnp.asarray(toks),
                                      jnp.asarray([11]), jcfg, jc,
                                      jnp.asarray(row), 0, PS)
    _, tc = tllama.paged_prefill_into(tparams, toks, np.array([11]), tcfg,
                                      tc, row, 0, PS)
    table = np.array([[3, 7, 1, 9, 5, 2], [4, 6, 8, 10, 11, 12]], np.int32)
    at = np.array([11, P_MAX * PS - 2], np.int32)
    jc = {**jc, "len": jnp.asarray(at)}
    tc["len"] = torch.from_numpy(at.copy())
    tc_cols = {k: v.clone() for k, v in tc.items()}
    window = r.integers(0, 512, (2, 5)).astype(np.int32)
    jl, jc = jllama.paged_decode_window(jparams, jnp.asarray(window), jc,
                                        jnp.asarray(table), jcfg)
    tl, tc = tllama.paged_decode_window(tparams, torch.from_numpy(window),
                                        tc, torch.from_numpy(table), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               **(TOL if name == "f32" else Q_TOL))
    _assert_arrays(tc, jc, first=1)
    assert tc["len"].tolist() == at.tolist()
    part, _ = tllama.paged_decode_window(tparams, torch.from_numpy(window),
                                         tc_cols, torch.from_numpy(table),
                                         tcfg, n_cols=5)
    np.testing.assert_array_equal(part[0].numpy(), tl[0].numpy())


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_window_dispatcher_plain_path_matches_jax_attention(int8):
    """``ops.cached_decode_attention`` with q [B, W, H, D] on the CPU (the
    window kernel's plain version) equals JAX's ``attention`` over the
    ``repeat_kv``'d cache with ``causal=True, q_offset=kv_len - 1``, rows
    at the kv_len edges (1, inside, at and past capacity) included."""
    r = np.random.default_rng(2)
    L, B, S, KV, D, H, W, layer = 2, 4, 40, 2, 16, 8, 5, 1
    q = r.standard_normal((B, W, H, D)).astype(np.float32)
    kv = r.standard_normal((2, L, B, S, KV, D)).astype(np.float32)
    kv_len = np.array([1, 17, 38, S + 1], np.int32)
    if int8:
        codes, scales = jops.quantize_kv(jnp.asarray(kv))
        k_fp, v_fp = (np.asarray(jops.dequantize_kv(codes[i], scales[i],
                                                    jnp.float32))
                      for i in range(2))
        codes = np.array(codes).reshape(2, L, B, S, KV * D)
        scales = np.asarray(scales).transpose(0, 1, 2, 4, 3)
        got = tops.cached_decode_attention(
            torch.from_numpy(q), torch.from_numpy(codes[0]),
            torch.from_numpy(codes[1]), torch.from_numpy(kv_len),
            layer=layer,
            k_scale=tllama._tensor_from_numpy(scales[0], "cpu"),
            v_scale=tllama._tensor_from_numpy(scales[1], "cpu"))
    else:
        k_fp, v_fp = kv
        got = tops.cached_decode_attention(
            torch.from_numpy(q), torch.from_numpy(kv[0]),
            torch.from_numpy(kv[1]), torch.from_numpy(kv_len), layer=layer)
    n_rep = H // KV
    want = jops.attention(jnp.asarray(q),
                          jops.repeat_kv(jnp.asarray(k_fp[layer]), n_rep),
                          jops.repeat_kv(jnp.asarray(v_fp[layer]), n_rep),
                          causal=True, q_offset=jnp.asarray(kv_len - 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- drafts and the standalone decoder --------------------------------------------

@settings(max_examples=200, deadline=None)
@given(history=st.lists(st.integers(0, 5), max_size=24),
       k=st.integers(1, 6), max_ngram=st.integers(1, 4))
def test_propose_lookup_matches_jax(history, k, max_ngram):
    assert propose_lookup(history, k, max_ngram) == \
        jpropose_lookup(history, k, max_ngram)


def test_propose_lookup_examples():
    """The JAX module's own examples: longest trailing n-gram, the most
    recent occurrence, nothing repeating."""
    assert propose_lookup([1, 2, 3, 9, 9, 1, 2, 3], k=2) == [9, 9]
    assert propose_lookup([5, 6, 5], k=3) == [6, 5]
    assert propose_lookup([1, 2, 3], k=2) == []
    assert propose_lookup([7], k=2) == []
    assert propose_lookup([1, 2, 8, 8, 1, 2, 5, 5, 1, 2], k=1) == [5]


@pytest.mark.parametrize("style,k,new", [("repetitive", 4, 24),
                                         ("random", 4, 24),
                                         ("loop", 4, 30), ("w8", 3, 16)])
def test_speculative_decoder_matches_jax(style, k, new):
    """Token for token, with the same accepted and proposed counts, on a
    repeated phrase (drafts land), random ids (they miss), a model that
    falls into a loop (generated repetition feeds the drafts) and int8
    weights."""
    pair = _pair(seed={"loop": 1, "w8": 2}.get(style, 0),
                 **({"w8": True} if style == "w8" else {}))
    jcfg, jparams, tcfg, tparams = pair
    rng = np.random.default_rng(5)
    if style == "random":
        prompt = rng.integers(1, 512, (18,)).astype(np.int32)
    elif style == "repetitive":
        prompt = np.tile(rng.integers(1, 512, (6,)), 3).astype(np.int32)
    else:
        prompt = np.tile(np.arange(2 + (style == "w8"), 8 + (style == "w8"),
                                   dtype=np.int32), 3)
    jdec = JSpeculativeDecoder(jparams, jcfg, k=k)
    tdec = SpeculativeDecoder(tparams, tcfg, k=k)
    assert tdec.generate(prompt, new) == jdec.generate(prompt, new)
    assert (tdec.accepted, tdec.proposed) == (jdec.accepted, jdec.proposed)
    assert tdec.proposed > 0
    assert tdec.acceptance_rate == jdec.acceptance_rate
    tdec.reset_counters()
    assert tdec.acceptance_rate == 0.0


def test_speculative_decoder_refusals_match_jax():
    jcfg, jparams, tcfg, tparams = _pair(kv_quant=True)
    with pytest.raises(ValueError, match="fp KV cache"):
        SpeculativeDecoder(tparams, tcfg)
    jcfg, jparams, tcfg, tparams = _pair()
    with pytest.raises(ValueError) as want:
        JSpeculativeDecoder(jparams, jcfg, k=4, max_seq=32).generate(
            np.arange(1, 20, dtype=np.int32), 16)
    with pytest.raises(ValueError) as got:
        SpeculativeDecoder(tparams, tcfg, k=4, max_seq=32).generate(
            np.arange(1, 20, dtype=np.int32), 16)
    assert str(got.value) == str(want.value)


# -- the Generator: twins of tests/test_speculate.py ------------------------------

def _gens(pair, **kw):
    """The JAX and the port Generator on the same weights and options."""
    jcfg, jparams, tcfg, tparams = pair
    return (JGenerator(jparams, jcfg, **kw),
            Generator(tparams, tcfg, device="cpu", **kw))


def _counters(gen) -> tuple:
    return (gen.spec_windows, gen.spec_emitted, gen.spec_disables)


def _stream(gen, prompts, n, prefix=None):
    """Admit every prompt, decode to the end; each slot's streamed tokens
    in admission order."""
    got: dict[int, list[int]] = {}
    kw = {} if prefix is None else {"prefix": prefix}
    slots = [gen.add_request(
        p, n, callback=lambda i, t: got.setdefault(i, []).extend(
            int(x) for x in t), **kw) for p in prompts]
    while gen.n_live:
        gen.step()
    gen.drain()
    return [got[s] for s in slots]


def _twin(pair, scenario, **kw):
    """``scenario(gen)`` on both Generators: the port's output and
    counters equal JAX's; returns the port's output and Generator."""
    jgen, tgen = _gens(pair, **kw)
    want, got = scenario(jgen), scenario(tgen)
    assert got == want
    assert _counters(tgen) == _counters(jgen)
    return got, tgen


def test_generator_speculative_lossless_and_accepting(pairs):
    pair = pairs["f32"]
    prompt = [5, 9, 2, 7] * 4
    jcfg, jparams, _, _ = pair
    expect = JGenerator(jparams, jcfg, batch_slots=2, max_seq=64,
                        prefill_buckets=(16,), chunk=2).generate(prompt, 14)
    got, gen = _twin(pair, lambda g: g.generate(prompt, max_new_tokens=14),
                     batch_slots=2, max_seq=64, prefill_buckets=(16,),
                     chunk=2, spec_k=3)
    assert got == expect and len(got) == 14
    assert 0 < gen.spec_windows < gen.spec_emitted
    assert gen.spec_emitted >= 14 - 1


def test_generator_speculative_concurrent_slots(pairs):
    prompts = [[3, 1, 4, 3, 1, 4, 3, 1], [2, 7, 2, 7, 2, 7]]
    _twin(pairs["f32"], lambda g: _stream(g, prompts, 8), batch_slots=2,
          max_seq=64, prefill_buckets=(16,), chunk=2, spec_k=3)


def test_generator_speculative_guards(pairs):
    """Greedy-only, a shared vocabulary, a draft only with spec_k, the fp
    cache for the draft: each raises JAX's message."""
    jcfg, jparams, tcfg, tparams = pairs["f32"]
    small = dict(vocab_size=32)
    cases = [
        (dict(spec_k=2, sampler=(JSampler(temperature=0.7),
                                 Sampler(temperature=0.7))), "greedy"),
        (dict(spec_k=2, draft=(
            (jparams, jllama.tiny_llama(use_flash=False, **small)),
            (tparams, tllama.tiny_llama(**small)))), "vocabulary"),
        (dict(draft=((jparams, jcfg), (tparams, tcfg))), "spec_k"),
        (dict(spec_k=2, draft=(
            (jparams, jllama.tiny_llama(use_flash=False, kv_quant=True)),
            (tparams, tllama.tiny_llama(kv_quant=True)))), "fp cache"),
    ]
    for kw, match in cases:
        jkw, tkw = dict(batch_slots=1, max_seq=64), dict(batch_slots=1,
                                                        max_seq=64)
        for key, value in kw.items():
            if key == "sampler":
                jkw[key], tkw[key] = value
            elif key == "draft":
                (jkw["draft_params"], jkw["draft_cfg"]), \
                    (tkw["draft_params"], tkw["draft_cfg"]) = value
            else:
                jkw[key] = tkw[key] = value
        with pytest.raises(ValueError, match=match) as want:
            JGenerator(jparams, jcfg, **jkw)
        with pytest.raises(ValueError, match=match) as got:
            Generator(tparams, tcfg, device="cpu", **tkw)
        assert str(got.value) == str(want.value)


def test_generator_speculative_on_paged_cache(pairs):
    prompts = [[5, 9, 2, 7] * 3, [3, 1, 3, 1, 3, 1]]
    _, gen = _twin(pairs["f32"], lambda g: _stream(g, prompts, 10),
                   batch_slots=2, max_seq=64, prefill_buckets=(16,),
                   chunk=2, spec_k=3, page_size=8)
    assert gen.spec_windows > 0


@pytest.mark.parametrize("name", ["int8", "int4"])
def test_generator_spec_paged_quantized_lossless(pairs, name):
    """Speculation x pages x int8 (JAX's test_generator_spec_paged_int8_
    lossless) and x int4 pages: the plain quantized chain exactly."""
    pair = pairs[name]
    prompt = [5, 3, 2, 6, 1, 9, 4, 7]
    jcfg, jparams, _, _ = pair
    ref = JGenerator(jparams, jcfg, batch_slots=1, max_seq=64,
                     prefill_buckets=(8,), page_size=8).generate(prompt, 12)
    got, gen = _twin(pair, lambda g: g.generate(prompt, 12), batch_slots=2,
                     max_seq=64, prefill_buckets=(8,), chunk=2, spec_k=3,
                     page_size=8)
    assert got == ref and gen.spec_windows > 0


def test_generator_spec_composes_with_int8_kv(pairs):
    pair = pairs["int8"]
    prompt = [5, 3, 2, 6, 1, 9, 4, 7]
    jcfg, jparams, _, _ = pair
    ref = JGenerator(jparams, jcfg, batch_slots=1, max_seq=64,
                     prefill_buckets=(8,)).generate(prompt, 12)
    got, gen = _twin(pair, lambda g: g.generate(prompt, 12), batch_slots=2,
                     max_seq=64, prefill_buckets=(8,), chunk=2, spec_k=3)
    assert got == ref and gen.spec_windows > 0


def _draft_twin(pair, draft_seed, scenario, **kw):
    jcfg, jparams, tcfg, tparams = pair
    if draft_seed is None:
        jd, td = jparams, tparams
    else:
        jd = jllama.init_params(jcfg, jax.random.PRNGKey(draft_seed))
        td = tllama.params_from_jax(jax.tree.map(np.asarray, jd),
                                    device="cpu")
    jgen = JGenerator(jparams, jcfg, draft_params=jd, draft_cfg=jcfg, **kw)
    tgen = Generator(tparams, tcfg, device="cpu", draft_params=td,
                     draft_cfg=tcfg, **kw)
    want, got = scenario(jgen), scenario(tgen)
    assert got == want
    assert _counters(tgen) == _counters(jgen)
    return got, tgen


def test_generator_draft_model_speculation(pairs):
    """A perfect draft (the target itself) accepts nearly everything, a
    random one next to nothing; both give the plain greedy chain and
    JAX's counters."""
    pair = pairs["f32"]
    prompt = [5, 3, 2, 6, 1, 9, 4, 7]
    jcfg, jparams, _, _ = pair
    ref = JGenerator(jparams, jcfg, batch_slots=1, max_seq=64,
                     prefill_buckets=(8,)).generate(prompt, 12)
    kw = dict(batch_slots=2, max_seq=64, prefill_buckets=(8,), chunk=2,
              spec_k=3)
    got, perfect = _draft_twin(pair, None, lambda g: g.generate(prompt, 12),
                               **kw)
    assert got == ref
    acc = ((perfect.spec_emitted - perfect.spec_windows)
           / (perfect.spec_windows * 3))
    assert acc > 0.7
    got, rand = _draft_twin(pair, 7, lambda g: g.generate(prompt, 12), **kw)
    assert got == ref
    assert ((rand.spec_emitted - rand.spec_windows)
            / (rand.spec_windows * 3)) < acc


def test_generator_draft_model_concurrent_slots(pairs):
    prompts = [[5, 3, 2, 6], [9, 1, 4, 7, 8, 2]]
    _draft_twin(pairs["f32"], None, lambda g: _stream(g, prompts, 8),
                batch_slots=2, max_seq=64, prefill_buckets=(8,), chunk=2,
                spec_k=3)


def test_spec_accept_metric_exported(pairs, run):
    """The stream's acceptance rate reaches ``app_llm_spec_accept`` once,
    as in JAX, high for the perfect draft."""
    from gofr_tpu.ml.llm import LLMServer as JLLMServer
    from gofr_tpu_torch.ml.llm import LLMServer

    jcfg, jparams, tcfg, tparams = pairs["f32"]
    recorded: dict = {"jax": [], "torch": []}

    class _Metrics:
        def __init__(self, side):
            self.side = side

        def record_histogram(self, name, value, **labels):
            recorded[self.side].append((name, value))

    async def scenario(server):
        try:
            return await server.generate([5, 3, 2, 6], 8)
        finally:
            server.close()

    kw = dict(batch_slots=2, max_seq=64, prefill_buckets=(8,), chunk=2,
              spec_k=3)
    want = run(scenario(JLLMServer(
        JGenerator(jparams, jcfg, draft_params=jparams, draft_cfg=jcfg, **kw),
        metrics=_Metrics("jax"))))
    got = run(scenario(LLMServer(
        Generator(tparams, tcfg, device="cpu", draft_params=tparams,
                  draft_cfg=tcfg, **kw), metrics=_Metrics("torch"))))
    assert got == want
    accept = {side: [v for n, v in rec if n == "app_llm_spec_accept"]
              for side, rec in recorded.items()}
    assert len(accept["torch"]) == 1
    assert accept["torch"] == pytest.approx(accept["jax"])
    assert accept["torch"][0] > 0.5


@pytest.mark.parametrize("name", ["f32", "int8"])
def test_spec_composes_with_shared_prefix(pairs, name):
    """Prefixed admission seeds the history row with the whole prefix +
    suffix: the dense whole-prompt chain, JAX's counters."""
    pair = pairs[name]
    jcfg, jparams, _, _ = pair
    prefix = [7, 3, 9, 2, 7, 3, 9, 2]
    suffixes = [[7, 3], [9, 2, 7]]
    dense = JGenerator(jparams, jcfg, batch_slots=1, max_seq=32,
                       prefill_buckets=(16,))
    expects = [dense.generate(prefix + sfx, 6) for sfx in suffixes]

    def scenario(gen):
        return _stream(gen, suffixes, 6, prefix=gen.register_prefix(prefix))

    got, gen = _twin(pair, scenario, batch_slots=2, max_seq=32,
                     prefill_buckets=(8, 16), chunk=2, page_size=8, spec_k=2)
    assert got == expects and gen.spec_windows > 0


def test_draft_model_composes_with_shared_prefix(pairs):
    pair = pairs["f32"]
    jcfg, jparams, _, _ = pair
    prefix = [7, 3, 9, 2, 7, 3, 9, 2]
    suffixes = [[7, 3], [9, 2, 7]]
    dense = JGenerator(jparams, jcfg, batch_slots=1, max_seq=32,
                       prefill_buckets=(16,))
    expects = [dense.generate(prefix + sfx, 6) for sfx in suffixes]

    def scenario(gen):
        return _stream(gen, suffixes, 6, prefix=gen.register_prefix(prefix))

    got, gen = _draft_twin(pair, None, scenario, batch_slots=2, max_seq=32,
                           prefill_buckets=(8, 16), chunk=2, page_size=8,
                           spec_k=2)
    assert got == expects
    assert ((gen.spec_emitted - gen.spec_windows)
            / max(gen.spec_windows * 2, 1)) > 0.5


# -- draft_from_env -------------------------------------------------------------

def test_draft_from_env_presets(pairs, monkeypatch):
    """None without the knobs; ``self`` reuses the target's weights under
    a config clone with the quantized cache off; ``tiny`` and ``1b`` are
    random drafts of the target's vocabulary on its device; a draft
    checkpoint that is not an HF directory raises (JAX's message), as a
    missing target does for ``self``; an HF draft loads (A.12,
    ``tests/test_torch_hf_import.py`` holds the import)."""
    _, _, tcfg, tparams = pairs["int8"]
    for name in ("LLM_DRAFT_PRESET", "LLM_DRAFT_CKPT"):
        monkeypatch.delenv(name, raising=False)
    assert tllama.draft_from_env(tcfg, tparams) == (None, None)
    monkeypatch.setenv("LLM_DRAFT_PRESET", "self")
    dparams, dcfg = tllama.draft_from_env(tcfg, tparams)
    assert dparams is tparams and not dcfg.kv_quant
    assert (dcfg.dim, dcfg.n_layers, dcfg.vocab_size, dcfg.dtype) == \
        (tcfg.dim, tcfg.n_layers, tcfg.vocab_size, tcfg.dtype)
    with pytest.raises(ValueError, match="needs target params"):
        tllama.draft_from_env(tcfg)
    monkeypatch.setenv("LLM_DRAFT_PRESET", "tiny")
    dparams, dcfg = tllama.draft_from_env(tcfg, tparams)
    assert dcfg.vocab_size == tcfg.vocab_size and dcfg.dim == 128
    assert dparams["embed"].device == tparams["embed"].device
    monkeypatch.setenv("LLM_DRAFT_PRESET", "1b")
    built = []  # the 1b shape is ~1B weights: record the call, build none
    monkeypatch.setattr(tllama, "params_from_config",
                        lambda cfg, seed=0, device=None: built.append(
                            (cfg, seed, device)) or {"cfg": cfg})
    dparams, dcfg = tllama.draft_from_env(tcfg, tparams)
    assert (dcfg.dim, dcfg.n_layers, dcfg.n_heads, dcfg.n_kv_heads,
            dcfg.ffn_dim) == (2048, 16, 16, 8, 8192)
    assert dcfg.vocab_size == tcfg.vocab_size and dparams == {"cfg": dcfg}
    assert built[0][1:] == (1, torch.device("cpu"))
    monkeypatch.setenv("LLM_DRAFT_CKPT", "/nonexistent")
    with pytest.raises(ValueError, match="is not a HF model directory"):
        tllama.draft_from_env(tcfg, tparams)
