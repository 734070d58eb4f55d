"""Tensor-parallel serving in the port (the serving half of ROADMAP A.11)
against the JAX package on the CPU.

JAX splits Llama over a mesh's tp axis with ``SHARDING_RULES`` and GSPMD
(``tests/test_llama.py::test_sharded_forward_matches_single_device``); the
port splits the same weights with ``parallel.shard_params`` into
``ShardedTensor`` blocks and runs each decoder block a shard at a time:
column-parallel q/k/v/gate/up, each shard's heads attended over its own
KV-head block of the cache, row-parallel wo/w_down joined by ``psum``, the
vocabulary-split head joined by ``all_gather``. The port's meshes repeat
the CPU (``[cpu] * tp``); JAX's run on the conftest's virtual devices.

Held here, at ``tiny_llama`` (8 heads, 4 KV heads: tp = 2 and 4 divide
both) with JAX's weights (``PRNGKey(0)``) carried across at f32:

- shard shapes equal JAX's addressable shards, bf16 and int8 trees;
- forward, prefill and decode logits within 1e-4 of range of JAX's
  sharded forward;
- greedy tokens equal JAX's for the dense, paged and int8 Generators, a
  prefix hit, chunked prefill, fused windows and the host tier;
- a 2-replica x 2-device pool's streams equal JAX's tensor-parallel pool;
- a KV ship from a tp = 2 replica lands bit for bit on a tp = 1 one, and
  back;
- a tp that does not divide the KV heads raises (JAX replicates K/V);
  speculation over split weights equals JAX's spec Generator; sequence
  parallelism over split weights raises A.11;
- ``psum`` / ``all_gather`` on a repeated device copy nothing; unsplit
  params are one shard.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu import parallel as jpar
from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.ml.replica import ReplicaPool as JReplicaPool
from gofr_tpu.ml.replica import \
    build_replica_generators as jbuild_replica_generators
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch import parallel as par
from gofr_tpu_torch.ml.generate import Generator
from gofr_tpu_torch.ml.kv_offload import HostKVStore, OffloadConfig
from gofr_tpu_torch.ml.kv_transport import decode_entry, encode_entry
from gofr_tpu_torch.ml.replica import ReplicaPool, build_replica_generators
from gofr_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.timeout(300)

CPU = torch.device("cpu")
TPS = [2, 4]
TOL = 1e-4  # of the reference's range, at f32
KW = dict(batch_slots=2, max_seq=64, prefill_buckets=(16,), chunk=4)
PROMPT = [5, 9, 2, 7, 1, 4, 8, 3, 6, 11, 13, 2]
N_NEW = 12
LAYOUTS = {"dense": ({}, 0), "paged": ({}, 8), "int8": ({"kv_bits": 8}, 0),
           "paged_int8": ({"kv_bits": 8}, 8)}


@pytest.fixture(scope="module")
def setup():
    """JAX's tiny weights at f32 and the port's copy of them."""
    jcfg = jllama.tiny_llama(use_flash=False, dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    params = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    return jcfg, jparams, params


def _mesh(tp):
    return par.make_mesh(par.MeshConfig(tp=tp), devices=[CPU] * tp)


def _jmesh(tp):
    return jpar.make_mesh(jpar.MeshConfig(dp=8 // tp, tp=tp))


def _split(params, tp):
    return par.shard_params(params, tllama.sharding_specs(params), _mesh(tp))


def _cfg(**kw):
    return tllama.tiny_llama(dtype=torch.float32, **kw)


def _jcfg(**kw):
    return jllama.tiny_llama(use_flash=False, dtype=jnp.float32, **kw)


def _range_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (want.max() - want.min()))


def _blocks(leaf) -> list:
    """Every block of a (possibly nested) ShardedTensor, or the leaf."""
    out = [leaf]
    while isinstance(out[0], par.ShardedTensor):
        out = [b for x in out for b in x.shards]
    return out


# ------------------------------------------------------------- placement
@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("tp", TPS)
def test_shard_shapes_match_jax(setup, tp, w8):
    """Every leaf's shard shape equals JAX's addressable shards under the
    same rules on a (dp, tp) mesh; int8 scales follow the rules' ``/s``
    entries (split column-parallel, replicated row-parallel); a
    column-parallel block is a view of the weight (nothing copied)."""
    _, jparams, params = setup
    if w8:
        jparams = jllama.quantize_weights(jparams)
        params = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    jsharded = jpar.shard_params(
        jparams, jpar.specs_from_rules(jparams, jllama.SHARDING_RULES),
        _jmesh(tp))
    placed = _split(params, tp)
    jleaves = jax.tree_util.tree_leaves_with_path(jsharded)
    n_split = 0
    for path, jleaf in jleaves:
        keys = [p.key for p in path]
        leaf = placed
        for k in keys:
            leaf = leaf[k]
        want = {s.data.shape for s in jleaf.addressable_shards}
        got = {tuple(b.shape) for b in _blocks(leaf)}
        assert got == want, keys
        n_split += isinstance(leaf, par.ShardedTensor)
    assert n_split == (8 + 1 + 5 if w8 else 8)
    wq = placed["layers"]["wq"]
    wq = wq["q"] if w8 else wq
    src = params["layers"]["wq"]
    src = src["q"] if w8 else src
    assert wq.shards[0].data_ptr() == src.data_ptr()


@pytest.mark.parametrize("kv_bits, page_size", [(16, 0), (8, 0), (16, 8),
                                                (8, 8), (4, 8)])
def test_head_split_cache_layout(kv_bits, page_size):
    """``init_cache`` / ``init_paged_cache`` over a tp mesh: JAX's
    ``CACHE_SPEC`` split of the KV-head axis (the flat int8 values
    head-contiguously, the seq-minor planes on their head axis), each
    shard's block its own contiguous tensor; ``len`` stays whole."""
    cfg = _cfg(kv_bits=kv_bits)
    mesh = _mesh(2)
    if page_size:
        cache = tllama.init_paged_cache(cfg, 2, 9, page_size, device="cpu",
                                        mesh=mesh)
        whole = tllama.init_paged_cache(cfg, 2, 9, page_size, device="cpu")
    else:
        cache = tllama.init_cache(cfg, 2, 32, device="cpu", mesh=mesh)
        whole = tllama.init_cache(cfg, 2, 32, device="cpu")
    assert tllama.CACHE_SPEC == par.P(None, "dp", None, "tp", None)
    assert set(cache) == set(whole)
    for name, arr in cache.items():
        if name == "len":
            assert arr.shape == whole["len"].shape
            continue
        assert isinstance(arr, par.ShardedTensor)
        assert tuple(arr.shape) == tuple(whole[name].shape), name
        assert arr.axis == (2 if name.endswith(("_scale", "_zero")) else 3)
        assert all(b.is_contiguous() for b in arr.shards)
        assert arr.shards[0].data_ptr() != arr.shards[1].data_ptr()


# ---------------------------------------------------------------- logits
@pytest.mark.parametrize("tp", TPS)
def test_forward_prefill_decode_logits_match_jax(setup, tp):
    """The port's tp forward, its prefill into a head-split cache and its
    decode steps against JAX's sharded forward at the same positions."""
    jcfg, jparams, params = setup
    cfg = _cfg()
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                             (2, 16)).astype(np.int32)
    jmesh = _jmesh(tp)
    jsharded = jpar.shard_params(
        jparams, jpar.specs_from_rules(jparams, jllama.SHARDING_RULES), jmesh)
    with jmesh:
        full = np.asarray(jax.jit(lambda p, t: jllama.forward(p, t, jcfg))(
            jsharded, jnp.asarray(toks)))
    placed = _split(params, tp)
    assert _range_err(tllama.forward(placed, toks, cfg), full) <= TOL
    lens = np.array([10, 7], np.int32)
    cache = tllama.init_cache(cfg, 2, 32, device="cpu", mesh=_mesh(tp))
    logits, cache = tllama.prefill_into_many(placed, toks, lens, cfg, cache,
                                             [0, 1], [True, True])
    assert _range_err(logits, full[[0, 1], lens - 1]) <= TOL
    for t in range(4):
        step = toks[[0, 1], lens + t]
        logits, cache = tllama.decode_step(placed, step, cache, cfg)
        assert _range_err(logits, full[[0, 1], lens + t]) <= TOL
    np.testing.assert_array_equal(cache["len"].numpy(), lens + 4)


# ------------------------------------------------------------ generators
_JAX_TOKENS: dict = {}


def _jax_generate(jparams, layout, prompt=PROMPT, n=N_NEW, **kw):
    """JAX's greedy tokens for a layout (memoized)."""
    key = (layout, tuple(prompt), n, tuple(sorted(kw.items())))
    if key not in _JAX_TOKENS:
        cfg_kw, page_size = LAYOUTS[layout]
        gen = JGenerator(jparams, _jcfg(**cfg_kw), page_size=page_size,
                         **{**KW, **kw})
        _JAX_TOKENS[key] = gen.generate(list(prompt), n)
    return _JAX_TOKENS[key]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("tp", TPS)
def test_generator_tokens_match_jax(setup, layout, tp):
    """Greedy tokens of the port's tp Generator (dense, paged, int8 cache
    and int8 pages) equal JAX's at f32; its cache is head-split and its
    decode runs eagerly."""
    _, jparams, params = setup
    cfg_kw, page_size = LAYOUTS[layout]
    gen = Generator(_split(params, tp), _cfg(**cfg_kw), device="cpu",
                    page_size=page_size, mesh=_mesh(tp), **KW)
    assert isinstance(gen.cache["k"], par.ShardedTensor)
    assert gen.cache["k"].n == tp and gen._graphs is None
    assert gen.generate(PROMPT, N_NEW) == _jax_generate(jparams, layout)


def _both(jparams, params, tp, scenario, layout="paged", **kw):
    cfg_kw, page_size = LAYOUTS[layout]
    want = scenario(JGenerator(jparams, _jcfg(**cfg_kw), page_size=page_size,
                               **{**KW, **kw}))
    got = scenario(Generator(_split(params, tp), _cfg(**cfg_kw),
                             device="cpu", page_size=page_size,
                             **{**KW, **kw}))
    return want, got


def _drive(gen, slots) -> list:
    while any(gen.slots[s].live for s in slots):
        gen.step()
    gen.drain()
    out = [list(gen.slots[s].tokens) for s in slots]
    for s in slots:
        gen.release(s)
    return out


@pytest.mark.parametrize("layout", ["paged", "paged_int8"])
def test_prefix_hit_and_host_tier_match_jax(setup, layout):
    """A registered prefix borrowed by two suffixes, then spilled to the
    host tier (the shards' heads concatenated) and restored (split again):
    every stream equals JAX's, and the restored pages equal the spilled
    ones bit for bit."""
    from gofr_tpu.ml.kv_offload import HostKVStore as JHostKVStore
    from gofr_tpu.ml.kv_offload import OffloadConfig as JOffloadConfig

    _, jparams, params = setup
    cfg_kw, page_size = LAYOUTS[layout]
    prefix, suffixes = PROMPT[:8], [[6, 2], [9, 9, 1]]

    def scenario(gen):
        pid = gen.register_prefix(prefix)
        out = _drive(gen, [gen.add_request(s, 6, prefix=pid)
                           for s in suffixes])
        port = isinstance(gen, Generator)
        if port:
            idx = torch.as_tensor(gen._prefixes[pid]["pages"])
            before = {k: v.index_select(1, idx)
                      for k, v in gen.cache.items() if k != "len"}
        assert gen.drop_prefix(pid, spill=True)
        pid = gen.restore_prefix(prefix)
        if port:
            idx = torch.as_tensor(gen._prefixes[pid]["pages"])
            for k, v in before.items():
                assert torch.equal(gen.cache[k].index_select(1, idx), v), k
        return out + _drive(gen, [gen.add_request(suffixes[0], 6,
                                                  prefix=pid)])

    want = scenario(JGenerator(
        jparams, _jcfg(**cfg_kw), page_size=page_size,
        host_kv=JHostKVStore(JOffloadConfig(budget_mb=64)), **KW))
    got = scenario(Generator(
        _split(params, 2), _cfg(**cfg_kw), device="cpu", page_size=page_size,
        host_kv=HostKVStore(OffloadConfig(budget_mb=64)), **KW))
    assert got == want


@pytest.mark.parametrize("paged", [False, True])
def test_chunked_prefill_matches_jax(setup, paged):
    """prefill_chunk=8: a 40-token prompt prefills in segments between the
    decode dispatches of a short stream; both streams equal JAX's."""
    _, jparams, params = setup
    long_prompt = list((np.arange(40) % 200 + 3).astype(int))

    def scenario(gen):
        a = gen.add_request([5, 3, 2], 10)
        gen.step()
        b = gen.add_request(long_prompt, 8)
        return _drive(gen, [a, b]), gen.prefill_segments_run

    want, got = _both(jparams, params, 2, scenario,
                      "paged" if paged else "dense",
                      prefill_buckets=(8, 64), prefill_chunk=8)
    assert got == want and got[1] == 5


def test_fused_windows_and_pipeline_match_jax(setup):
    """Fused decode windows (K = 4) with the double-buffered pipeline over
    a tp = 4 paged Generator: tokens equal JAX's."""
    _, jparams, params = setup

    def scenario(gen):
        return _drive(gen, [gen.add_request(PROMPT, N_NEW),
                            gen.add_request([3, 1], 7)])

    want, got = _both(jparams, params, 4, scenario, decode_window=4,
                      pipeline=1)
    assert got == want


# ---------------------------------------------------------------- fleet
def test_two_replicas_of_two_devices_match_jax_pool(setup, run):
    """``build_replica_generators`` over four devices in two replicas:
    each replica tensor-parallel over two (JAX's layout), and the pool's
    streams equal JAX's tensor-parallel pool's."""
    jcfg, jparams, params = setup
    kw = dict(warmup=False, batch_slots=2, max_seq=64,
              prefill_buckets=(8, 16))
    gens = build_replica_generators(params, _cfg(), 2, devices=[CPU] * 4,
                                    **kw)
    assert [g.mesh.shape["tp"] for g in gens] == [2, 2]
    jgens = jbuild_replica_generators(jparams, jcfg, 2,
                                      devices=jax.devices()[:4], **kw)
    pool = ReplicaPool(gens, name="tp-pool")
    jpool = JReplicaPool(jgens, name="jtp-pool")
    prompts = [[5, 9, 2, 7], [3, 1], [8, 6, 4], [2, 2, 9, 1]]

    async def scenario():
        got = await asyncio.gather(*(pool.generate(p, 6) for p in prompts))
        want = await asyncio.gather(*(jpool.generate(p, 6)
                                      for p in prompts))
        assert got == want

    try:
        run(scenario())
    finally:
        pool.close()
        jpool.close()


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_kv_ship_between_tp2_and_tp1_lands_bit_identically(setup, kv_bits):
    """A prefix spilled by a tp = 2 replica leaves in JAX's full-head
    layout (the tp = 1 replica's array shapes), crosses the wire codec and
    lands on a tp = 1 replica bit for bit, whose decode then equals JAX's
    on the same prefix + suffix split; the reverse ship splits the heads
    again onto the tp = 2 replica's shards."""
    _, jparams, params = setup
    layout = "paged" if kv_bits == 16 else "paged_int8"
    cfg = _cfg(**LAYOUTS[layout][0])
    tier = dict(host_kv=HostKVStore(OffloadConfig(budget_mb=64)))
    src = Generator(_split(params, 2), cfg, device="cpu", page_size=8,
                    **KW, **tier)
    dst = Generator(params, cfg, device="cpu", page_size=8, **KW,
                    host_kv=HostKVStore(OffloadConfig(budget_mb=64)))
    prefix = PROMPT[:8]
    key = tuple(prefix)

    def ship(a, b):
        pid = a.register_prefix(prefix)
        assert a.drop_prefix(pid, spill=True)
        arrays, meta = a.host_kv.pop(key)
        for name, arr in arrays.items():
            assert tuple(arr.shape) == (cfg.n_layers, 1,
                                        *b.cache[name].shape[2:]), name
        k2, arrays2, meta2 = decode_entry(encode_entry(key, arrays, meta))
        assert b.host_kv.receive(k2, arrays2, meta2)
        pid = b.restore_prefix(prefix)
        idx = torch.as_tensor(b._prefixes[pid]["pages"])
        for name, arr in arrays.items():
            assert torch.equal(b.cache[name].index_select(1, idx), arr), name
        return pid

    pid = ship(src, dst)
    got = _drive(dst, [dst.add_request([6, 2], 6, prefix=pid)])
    jgen = JGenerator(jparams, _jcfg(**LAYOUTS[layout][0]), page_size=8,
                      **KW)
    jpid = jgen.register_prefix(prefix)
    assert got == _drive(jgen, [jgen.add_request([6, 2], 6, prefix=jpid)])
    dst.drop_prefix(pid)
    src.drop_prefix(src.register_prefix(prefix))
    ship(dst, src)


# --------------------------------------------------------- what raises
def test_tp_must_divide_the_kv_heads(setup):
    """tiny_llama has 4 KV heads: tp = 8 splits the weights (JAX runs it,
    replicating K/V) but the port's shards own whole KV heads, so the
    model and the Generator raise ValueError (ROADMAP C)."""
    _, _, params = setup
    placed = _split(params, 8)
    with pytest.raises(ValueError, match="n_kv_heads=4"):
        tllama.forward(placed, np.ones((1, 4), np.int32), _cfg())
    with pytest.raises(ValueError, match="n_kv_heads=4"):
        Generator(placed, _cfg(), device="cpu", **KW)


def test_speculation_and_sp_over_split_weights_raise(setup):
    """Speculative decoding and sequence parallelism over split weights
    (no longer raises: the name is kept from when they did).
    Speculation gives JAX's spec Generator's greedy tokens and counts,
    dense and paged, its windows through each shard's window launch; the
    forward with ring or Ulysses over an sp = 2 x tp = 2 mesh (each tp
    shard's heads over its own row of the mesh) equals JAX's sharded
    forward within 1e-4 of range; the striped pool over a mesh with tp >
    1 raises JAX's message; a tp mesh over unsplit weights raises with
    the call that splits them."""
    jcfg, jparams, params = setup
    placed = _split(params, 2)
    prompt = [5, 9, 2, 7, 5, 9, 2, 7, 5, 9, 2, 7]
    for page_size in (0, 8):
        jgen = JGenerator(jparams, jcfg, page_size=page_size, spec_k=2, **KW)
        want = jgen.generate(prompt, max_new_tokens=N_NEW)
        gen = Generator(placed, _cfg(), device="cpu", spec_k=2,
                        page_size=page_size, **KW)
        assert gen.generate(prompt, max_new_tokens=N_NEW) == want
        assert (gen.spec_windows, gen.spec_emitted) == (
            jgen.spec_windows, jgen.spec_emitted)
    tokens = np.random.default_rng(6).integers(0, 512, (2, 16)).astype(
        np.int32)
    mesh = par.make_mesh(par.MeshConfig(sp=2, tp=2), devices=[CPU] * 4)
    sp_placed = par.shard_params(params, tllama.sharding_specs(params), mesh)
    jmesh = jpar.make_mesh(jpar.MeshConfig(sp=2, tp=2),
                           devices=jax.devices()[:4])
    jplaced = jpar.shard_params(
        jparams, jpar.specs_from_rules(jparams, jllama.SHARDING_RULES), jmesh)
    for impl in ("ring", "ulysses"):
        with jmesh:
            want = jax.jit(lambda p, t, impl=impl: jllama.forward(
                p, t, _jcfg(attn_impl=impl), mesh=jmesh))(jplaced, tokens)
        got = tllama.forward(sp_placed, tokens, _cfg(attn_impl=impl),
                             mesh=mesh)
        assert _range_err(got.numpy(), want) <= TOL
    with pytest.raises(ValueError, match="striped KV pages"):
        Generator(sp_placed, _cfg(), device="cpu", mesh=mesh, sp="ring",
                  page_size=8, **{**KW, "prefill_buckets": (16,)})
    with pytest.raises(ValueError, match="shard_params"):
        Generator(params, _cfg(), device="cpu", mesh=_mesh(2), **KW)
    with pytest.raises(ValueError, match="shard_cache requires a mesh"):
        Generator(params, _cfg(), device="cpu", shard_cache=True, **KW)


def test_collectives_copy_nothing_on_a_repeated_device():
    """``psum(to=)`` adds the shards where they are and returns one sum;
    ``all_gather`` builds one concatenation a device, shared by the shards
    on it; both equal their definitions."""
    xs = [torch.full((2, 3), float(i + 1)) for i in range(4)]
    total = par.psum(xs, to=CPU)
    assert torch.equal(total, torch.full((2, 3), 10.0))
    outs = par.psum(xs)
    assert all(torch.equal(o, total) for o in outs)
    gathered = par.all_gather(xs, -1)
    assert len({g.data_ptr() for g in gathered}) == 1
    assert torch.equal(gathered[0], torch.cat(xs, -1))
    assert torch.equal(par.all_gather(xs, 0, to=CPU), torch.cat(xs, 0))


def test_unsplit_params_are_one_shard(setup):
    """Each model has one layer body: unsplit weights are its one shard
    (``shards_of``), whose collectives return their one input uncopied,
    and unsplit Llama params name no tp devices."""
    t = torch.arange(6.0).reshape(2, 3)
    assert par.shards_of(t) == [t]
    assert par.psum([t], to=CPU) is t
    assert par.all_gather([t], -1, to=CPU) is t
    split = par.ShardedTensor([t[:1], t[1:]], 0)
    assert par.shards_of(split) == split.shards
    *_, tparams = setup
    assert tllama.tp_devices(tparams) is None
    placed = par.shard_params(tparams, tllama.sharding_specs(tparams),
                              _mesh(2))
    assert tllama.tp_devices(placed) == [CPU, CPU]
