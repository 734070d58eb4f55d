"""PyTorch port, Llama model: the JAX parameter tree carried across bit for
bit, then forward / prefill / prefill_into_many / decode_step held against
the JAX package on the tiny config at f32.

Tolerance 1e-4 absolute on logits and cache contents: both sides run the
same f32 arithmetic, summed in different orders (XLA's dot vs ATen's), over
two layers of O(1) activations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jllama
from gofr_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.timeout(180)

TOL = dict(atol=1e-4, rtol=1e-4)
S_MAX = 32


@pytest.fixture(scope="module")
def pair():
    jcfg = jllama.tiny_llama(dtype=jnp.float32)
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_cache_equal(tcache, jcache, **tol):
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]),
                                   **(tol or TOL))
    np.testing.assert_array_equal(tcache["len"].numpy(),
                                  np.asarray(jcache["len"]))


def _filled_caches(jcfg, tcfg, batch, seed):
    """The same random cache contents on both sides."""
    r = np.random.default_rng(seed)
    shape = (jcfg.n_layers, batch, S_MAX, jcfg.n_kv_heads, jcfg.head_dim)
    k, v = (r.standard_normal(shape).astype(np.float32) for _ in range(2))
    lens = r.integers(1, S_MAX // 2, batch).astype(np.int32)
    jcache = {"k": jnp.asarray(k), "v": jnp.asarray(v), "len": jnp.asarray(lens)}
    tcache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
              "len": torch.from_numpy(lens.copy())}
    return jcache, tcache


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_jax_is_bit_exact(dtype):
    jcfg = jllama.tiny_llama(dtype=getattr(jnp, dtype))
    tree = jax.tree.map(np.asarray, jllama.init_params(jcfg,
                                                       jax.random.PRNGKey(1)))
    tparams = tllama.params_from_jax(tree, device="cpu")
    flat_j = {"embed": tree["embed"], "final_norm": tree["final_norm"],
              "lm_head": tree["lm_head"],
              **{f"layers/{k}": v for k, v in tree["layers"].items()}}
    flat_t = {"embed": tparams["embed"], "final_norm": tparams["final_norm"],
              "lm_head": tparams["lm_head"],
              **{f"layers/{k}": v for k, v in tparams["layers"].items()}}
    assert flat_j.keys() == flat_t.keys()
    for name, a in flat_j.items():
        t = flat_t[name]
        assert tuple(t.shape) == a.shape, name
        bits = np.uint16 if a.dtype.itemsize == 2 else np.uint32
        tbits = torch.int16 if a.dtype.itemsize == 2 else torch.int32
        np.testing.assert_array_equal(t.view(tbits).numpy().view(bits),
                                      a.view(bits), err_msg=name)
    assert tparams["layers"]["attn_norm"].dtype == torch.float32
    assert tparams["layers"]["wq"].dtype == getattr(torch, dtype)


def test_forward_matches_jax(pair):
    jcfg, jparams, tcfg, tparams = pair
    r = np.random.default_rng(2)
    tokens = r.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    seq_lens = np.array([12, 7], np.int32)
    want = jllama.forward(jparams, jnp.asarray(tokens), jcfg,
                          seq_lens=jnp.asarray(seq_lens))
    got = tllama.forward(tparams, tokens, tcfg, seq_lens=seq_lens)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_prefill_matches_jax(pair):
    jcfg, jparams, tcfg, tparams = pair
    r = np.random.default_rng(3)
    tokens = r.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    seq_lens = np.array([16, 5], np.int32)
    want, jcache = jllama.prefill(jparams, jnp.asarray(tokens),
                                  jnp.asarray(seq_lens), jcfg,
                                  jllama.init_cache(jcfg, 2, S_MAX))
    got, tcache = tllama.prefill(tparams, tokens, seq_lens, tcfg,
                                 tllama.init_cache(tcfg, 2, S_MAX, device="cpu"))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    _assert_cache_equal(tcache, jcache)


def test_prefill_into_many_matches_jax(pair):
    """A wave of three rows (one of them padding) into a cache that already
    holds other rows: last-token logits, every cache row, and ``len``."""
    jcfg, jparams, tcfg, tparams = pair
    jcache, tcache = _filled_caches(jcfg, tcfg, batch=4, seed=4)
    r = np.random.default_rng(5)
    tokens = r.integers(0, jcfg.vocab_size, (3, 16)).astype(np.int32)
    seq_lens = np.array([9, 16, 1], np.int32)
    slots = np.array([2, 0, 3], np.int32)
    valid = np.array([True, True, False])
    want, jcache = jllama.prefill_into_many(
        jparams, jnp.asarray(tokens), jnp.asarray(seq_lens), jcfg, jcache,
        jnp.asarray(slots), jnp.asarray(valid))
    untouched = tcache["k"][:, 3].clone()
    got, tcache = tllama.prefill_into_many(tparams, tokens, seq_lens, tcfg,
                                           tcache, slots, valid)
    np.testing.assert_allclose(_np(got)[:2], _np(want)[:2], **TOL)
    _assert_cache_equal(tcache, jcache)
    torch.testing.assert_close(tcache["k"][:, 3], untouched, rtol=0, atol=0)


def test_decode_steps_match_jax_with_a_row_at_capacity(pair):
    """Three decode steps over rows at different positions; row 1 sits at
    capacity (len == S_max): JAX drops its write, the port masks it. Logits
    and caches agree at every step, the full row's K/V never change and its
    len stays capped."""
    jcfg, jparams, tcfg, tparams = pair
    jcache, tcache = _filled_caches(jcfg, tcfg, batch=3, seed=6)
    lens = np.array([4, S_MAX, S_MAX - 2], np.int32)
    jcache["len"] = jnp.asarray(lens)
    tcache["len"] = torch.from_numpy(lens.copy())
    full_row = tcache["k"][:, 1].clone(), tcache["v"][:, 1].clone()
    r = np.random.default_rng(7)
    for _ in range(3):
        tok = r.integers(0, jcfg.vocab_size, 3).astype(np.int32)
        want, jcache = jllama.decode_step(jparams, jnp.asarray(tok), jcache,
                                          jcfg)
        got, tcache = tllama.decode_step(tparams, torch.from_numpy(tok),
                                         tcache, tcfg)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        _assert_cache_equal(tcache, jcache)
    assert tcache["len"].tolist() == [7, S_MAX, S_MAX]
    torch.testing.assert_close(tcache["k"][:, 1], full_row[0], rtol=0, atol=0)
    torch.testing.assert_close(tcache["v"][:, 1], full_row[1], rtol=0, atol=0)


def test_unported_configurations_raise():
    for kw in ({"kv_quant": True}, {"kv_bits": 8}, {"w8": True},
               {"attn_impl": "ring"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tllama.tiny_llama(**kw)


def test_out_of_vocabulary_tokens_are_refused(pair):
    """JAX clamps the gather; torch would fault on the device: refused on
    the host instead."""
    _, _, tcfg, tparams = pair
    with pytest.raises(ValueError, match="token ids"):
        tllama.forward(tparams, np.array([[1, tcfg.vocab_size]]), tcfg)


def test_init_params_is_seeded_and_shaped():
    cfg = tllama.tiny_llama()
    a = tllama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = tllama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.tree.map(lambda x: x.shape, jax.eval_shape(
        lambda: jllama.init_params(jllama.tiny_llama(), jax.random.PRNGKey(0))))
    assert tuple(a["lm_head"].shape) == jshapes["lm_head"]
    for k, v in a["layers"].items():
        assert tuple(v.shape) == jshapes["layers"][k], k
        torch.testing.assert_close(v, b["layers"][k], rtol=0, atol=0)
    assert a["layers"]["wq"].dtype == torch.bfloat16
    assert a["layers"]["attn_norm"].dtype == torch.float32
