"""PyTorch port, Llama model: the JAX parameter tree carried across bit for
bit, then forward / prefill / prefill_into_many / decode_step held against
the JAX package on the tiny config at f32, with the fp cache and with the
int8 cache and int8 weights (``kv_quant`` + ``w8``).

Tolerance 1e-4 absolute on logits and cache contents: both sides run the
same f32 arithmetic, summed in different orders (XLA's dot vs ATen's), over
two layers of O(1) activations. On the int8 path: logits 1e-3; int8 codes
equal, or off by one on at most 0.1 % of entries (a summation order may move
a value across a .5); scales within one bf16 ulp.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jllama
from gofr_tpu.ops import quantize_kv as jquantize_kv
from gofr_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.timeout(180)

TOL = dict(atol=1e-4, rtol=1e-4)
Q_TOL = dict(atol=1e-3, rtol=1e-3)
S_MAX = 32


@pytest.fixture(scope="module")
def pair():
    jcfg = jllama.tiny_llama(dtype=jnp.float32)
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def q_pair():
    """The tiny config with the int8 cache and int8 weights: JAX quantizes
    its own tree, the port carries the quantized tree across."""
    jcfg = jllama.tiny_llama(dtype=jnp.float32, kv_quant=True, w8=True)
    tcfg = tllama.tiny_llama(dtype=torch.float32, kv_quant=True, w8=True)
    jparams = jllama.quantize_weights(
        jllama.init_params(jcfg, jax.random.PRNGKey(0)))
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


def _assert_int8_cache_close(tcache, jcache):
    """Same keys, shapes and dtypes; int8 codes equal or off by one on at
    most 0.1 % of entries; bf16 scales within one bf16 ulp; ``len`` equal."""
    assert sorted(tcache) == sorted(jcache)
    for key, j in jcache.items():
        t = tcache[key]
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape, key
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name, key
        if key in ("k", "v"):
            diff = np.abs(t.numpy().astype(np.int32) - j.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, key
        elif key == "len":
            np.testing.assert_array_equal(t.numpy(), j)
        else:
            a, b = t.float().numpy(), j.astype(np.float32)
            mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1e-30)
            ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
            assert (np.abs(a - b) <= ulp).all(), key


def _int8_filled_caches(jcfg, batch, seed):
    """The same random int8 cache contents on both sides (quantized by
    JAX from random K/V)."""
    r = np.random.default_rng(seed)
    L, KV, D = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    jcache = {}
    for name in ("k", "v"):
        q, sc = jquantize_kv(jnp.asarray(
            r.standard_normal((L, batch, S_MAX, KV, D)).astype(np.float32)))
        jcache[name] = q.reshape(L, batch, S_MAX, KV * D)
        jcache[f"{name}_scale"] = sc.transpose(0, 1, 3, 2)
    jcache = {k: jcache[k] for k in ("k", "v", "k_scale", "v_scale")}
    jcache["len"] = jnp.asarray(
        r.integers(1, S_MAX // 2, batch).astype(np.int32))
    tcache = {k: tllama._tensor_from_numpy(v, "cpu") for k, v in jcache.items()}
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


def test_unported_configurations_raise(monkeypatch):
    """Sequence-parallel attention is ported: ``attn_impl`` takes ring and
    Ulysses and refuses anything else, as JAX's config does. int4 KV is
    ported as a paged-cache
    precision: the config takes it, and the dense paths refuse it as JAX
    does. Restoring a checkpoint in params_from_config is ported (A.12): a
    directory that does not exist raises FileNotFoundError, as JAX's
    restore of an empty run does, and is not created."""
    for impl in ("ring", "ulysses"):
        assert tllama.tiny_llama(attn_impl=impl).sequence_parallel
    assert not tllama.tiny_llama().sequence_parallel
    with pytest.raises(ValueError, match="attn_impl"):
        tllama.tiny_llama(attn_impl="nope")
    for kw in ({"kv_bits": 4}, {"kv_quant": True, "kv_bits": 4}):
        cfg4 = tllama.tiny_llama(**kw)
        assert (cfg4.kv_bits, cfg4.kv_quant) == (4, True)
        with pytest.raises(ValueError, match="paged"):
            tllama.decode_step(None, np.zeros(1, np.int32), {}, cfg4)
        with pytest.raises(ValueError, match="paged"):
            tllama.prefill_segment_into(None, np.zeros((1, 4), np.int32),
                                        [4], cfg4, {}, 0, 0, 4)
    cfg = tllama.tiny_llama()
    missing = "/nonexistent/gofr-checkpoint"
    with pytest.raises(FileNotFoundError, match="no checkpoint directory"):
        tllama.params_from_config(cfg, checkpoint_dir=missing, device="cpu")
    monkeypatch.setenv("LLAMA_CKPT", missing)
    with pytest.raises(FileNotFoundError, match="no checkpoint directory"):
        tllama.params_from_config(cfg, device="cpu")
    assert not os.path.exists(missing)


@pytest.mark.parametrize("kw,want", [
    ({}, (16, False, False)),
    ({"kv_quant": True}, (8, True, False)),
    ({"kv_bits": 8}, (8, True, False)),
    ({"kv_bits": 16, "w8": True}, (16, False, True)),
    ({"kv_quant": True, "w8": True}, (8, True, True)),
])
def test_config_quantization_fields_match_jax(kw, want):
    t, j = tllama.tiny_llama(**kw), jllama.tiny_llama(**kw)
    assert (t.kv_bits, t.kv_quant, t.w8) == (j.kv_bits, j.kv_quant, j.w8) \
        == want


def test_config_refuses_contradictions_like_jax():
    for kw in ({"kv_quant": True, "kv_bits": 16}, {"kv_bits": 6}):
        with pytest.raises(ValueError):
            jllama.tiny_llama(**kw)
        with pytest.raises(ValueError, match="kv_"):
            tllama.tiny_llama(**kw)


@pytest.mark.parametrize("env,want", [
    ({"LLAMA_KV_QUANT": "1"}, (8, True, False)),
    ({"LLAMA_W8": "1"}, (16, False, True)),
    ({"LLAMA_KV_QUANT": "1", "LLAMA_W8": "1"}, (8, True, True)),
    ({"GOFR_ML_KV_BITS": "8"}, (8, True, False)),
    ({"GOFR_ML_KV_BITS": "4"}, (4, True, False)),
    ({"LLAMA_KV_QUANT": "1", "GOFR_ML_KV_BITS": "16"}, (16, False, False)),
])
def test_config_from_env_matches_jax(monkeypatch, env, want):
    for name in ("LLAMA_PRESET", "LLAMA_DTYPE", "LLAMA_CKPT",
                 "LLAMA_KV_QUANT", "LLAMA_W8", "GOFR_ML_KV_BITS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    t, j = tllama.config_from_env(), jllama.config_from_env()
    assert (t.kv_bits, t.kv_quant, t.w8) == (j.kv_bits, j.kv_quant, j.w8) \
        == want


def test_config_from_env_refuses_bad_kv_bits(monkeypatch):
    monkeypatch.delenv("LLAMA_CKPT", raising=False)
    for raw in ("eight", "6"):
        monkeypatch.setenv("GOFR_ML_KV_BITS", raw)
        with pytest.raises(ValueError, match="GOFR_ML_KV_BITS"):
            tllama.config_from_env()
        with pytest.raises(ValueError, match="GOFR_ML_KV_BITS"):
            jllama.config_from_env()
    # 4 is a precision, not a malformed value: both packages take it
    monkeypatch.setenv("GOFR_ML_KV_BITS", "4")
    assert tllama.config_from_env().kv_bits == jllama.config_from_env().kv_bits == 4


# -- int8 weights and the int8 cache ---------------------------------------------

def _flat_params(tree):
    flat = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    for name, leaf in [("lm_head", tree["lm_head"]),
                       *((f"layers/{k}", v) for k, v in tree["layers"].items())]:
        if isinstance(leaf, dict):
            flat.update({f"{name}/{n}": t for n, t in leaf.items()})
        else:
            flat[name] = leaf
    return flat


def _bits(x):
    """The raw bytes of a torch or numpy array (bf16 through int16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().view(np.uint8)
    return np.asarray(x).view(np.uint8)


def test_params_from_jax_carries_int8_weights_bit_exact(q_pair):
    _, jparams, _, tparams = q_pair
    fj = _flat_params(jax.tree.map(np.asarray, jparams))
    ft = _flat_params(tparams)
    assert fj.keys() == ft.keys()
    assert "layers/w_gate/q" in ft and "lm_head/s" in ft
    for name, a in fj.items():
        t = ft[name]
        assert tuple(t.shape) == a.shape, name
        np.testing.assert_array_equal(_bits(t), _bits(a), err_msg=name)
    assert tparams["layers"]["wq"]["q"].dtype == torch.int8
    assert tparams["layers"]["wq"]["s"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantize_weights_matches_jax(dtype):
    """The port quantizes one layer (and lm_head a block of columns) at a
    time; JAX quantizes the stack: the same codes and scales, bit for bit."""
    jcfg = jllama.tiny_llama(dtype=getattr(jnp, dtype))
    tree = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    want = _flat_params(jax.tree.map(np.asarray, jllama.quantize_weights(tree)))
    got = _flat_params(tllama.quantize_weights(tllama.params_from_jax(
        jax.tree.map(np.asarray, tree), device="cpu")))
    assert want.keys() == got.keys()
    for name, a in want.items():
        np.testing.assert_array_equal(_bits(got[name]), _bits(a),
                                      err_msg=name)


def test_params_from_config_quantizes_seeded_weights():
    cfg = tllama.tiny_llama(w8=True)
    a = tllama.params_from_config(cfg, seed=5, device="cpu")
    b = tllama.quantize_weights(tllama.init_params(
        cfg, torch.Generator().manual_seed(5), device="cpu"))
    for name, t in _flat_params(a).items():
        torch.testing.assert_close(t, _flat_params(b)[name], rtol=0, atol=0)
    assert a["lm_head"]["q"].dtype == torch.int8
    assert not isinstance(tllama.params_from_config(
        tllama.tiny_llama(), device="cpu")["lm_head"], dict)


def test_int8_init_cache_matches_jax():
    jcfg = jllama.tiny_llama(kv_quant=True)
    tcfg = tllama.tiny_llama(kv_quant=True)
    _assert_int8_cache_close(tllama.init_cache(tcfg, 3, S_MAX, device="cpu"),
                             jllama.init_cache(jcfg, 3, S_MAX))


def test_int8_forward_matches_jax(q_pair):
    jcfg, jparams, tcfg, tparams = q_pair
    tokens = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    want = jllama.forward(jparams, jnp.asarray(tokens), jcfg)
    got = tllama.forward(tparams, tokens, tcfg)
    np.testing.assert_allclose(_np(got), _np(want), **Q_TOL)


def test_int8_prefill_matches_jax(q_pair):
    """Prefill attends the fp K/V and stores them quantized: values flat,
    scales seq-minor, zeros past the bucket."""
    jcfg, jparams, tcfg, tparams = q_pair
    r = np.random.default_rng(9)
    tokens = r.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    seq_lens = np.array([16, 5], np.int32)
    want, jcache = jllama.prefill(jparams, jnp.asarray(tokens),
                                  jnp.asarray(seq_lens), jcfg,
                                  jllama.init_cache(jcfg, 2, S_MAX))
    got, tcache = tllama.prefill(tparams, tokens, seq_lens, tcfg,
                                 tllama.init_cache(tcfg, 2, S_MAX, device="cpu"))
    np.testing.assert_allclose(_np(got), _np(want), **Q_TOL)
    _assert_int8_cache_close(tcache, jcache)
    assert not tcache["k"][:, :, 16:].any()
    assert not tcache["k_scale"][..., 16:].float().any()


def test_int8_prefill_into_many_matches_jax(q_pair):
    """A wave of three rows (one of them padding) into an int8 cache that
    already holds other rows: a valid row is replaced whole, values and
    scales; the padding row's slot keeps its contents."""
    jcfg, jparams, tcfg, tparams = q_pair
    jcache, tcache = _int8_filled_caches(jcfg, batch=4, seed=10)
    r = np.random.default_rng(11)
    tokens = r.integers(0, jcfg.vocab_size, (3, 16)).astype(np.int32)
    seq_lens = np.array([9, 16, 1], np.int32)
    slots = np.array([2, 0, 3], np.int32)
    valid = np.array([True, True, False])
    want, jcache = jllama.prefill_into_many(
        jparams, jnp.asarray(tokens), jnp.asarray(seq_lens), jcfg, jcache,
        jnp.asarray(slots), jnp.asarray(valid))
    untouched = {k: tcache[k][:, 3].clone() for k in ("k", "v", "k_scale",
                                                      "v_scale")}
    got, tcache = tllama.prefill_into_many(tparams, tokens, seq_lens, tcfg,
                                           tcache, slots, valid)
    np.testing.assert_allclose(_np(got)[:2], _np(want)[:2], **Q_TOL)
    _assert_int8_cache_close(tcache, jcache)
    for k, before in untouched.items():
        torch.testing.assert_close(tcache[k][:, 3], before, rtol=0, atol=0)


def test_int8_decode_steps_match_jax_with_a_row_at_capacity(q_pair):
    """Three decode steps over an int8 cache with rows at different
    positions; row 1 sits at capacity: its values and scales never change
    and its len stays capped. The new tokens are quantized on write, the
    values scattered flat and the scales seq-minor."""
    jcfg, jparams, tcfg, tparams = q_pair
    jcache, tcache = _int8_filled_caches(jcfg, batch=3, seed=12)
    lens = np.array([4, S_MAX, S_MAX - 2], np.int32)
    jcache["len"] = jnp.asarray(lens)
    tcache["len"] = torch.from_numpy(lens.copy())
    full_row = {k: tcache[k][:, 1].clone() for k in ("k", "v", "k_scale",
                                                     "v_scale")}
    r = np.random.default_rng(13)
    for _ in range(3):
        tok = r.integers(0, jcfg.vocab_size, 3).astype(np.int32)
        want, jcache = jllama.decode_step(jparams, jnp.asarray(tok), jcache,
                                          jcfg)
        got, tcache = tllama.decode_step(tparams, torch.from_numpy(tok),
                                         tcache, tcfg)
        np.testing.assert_allclose(_np(got), _np(want), **Q_TOL)
        _assert_int8_cache_close(tcache, jcache)
    assert tcache["len"].tolist() == [7, S_MAX, S_MAX]
    for k, before in full_row.items():
        torch.testing.assert_close(tcache[k][:, 1], before, rtol=0, atol=0)


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
