"""Sequence parallelism over tensor-parallel weights in the port (the last
item of ROADMAP A.11) against the JAX package on the CPU.

JAX serves a long prompt sequence-parallel over params split by
``SHARDING_RULES`` on a mesh with sp and tp both > 1: ring or Ulysses
shard each tp shard's heads over the sp axis (``head_axis="tp"``) and the
dense cache's specs split KV heads over tp. The port runs each tp shard's
heads through ring or Ulysses over its own row of the mesh
(``mesh.sub(tp=d)``), its cache block split by sequence over that row
(``init_cache(tp_heads=True)``), and the decode combine a tp shard at a
time. The port's meshes repeat the CPU; JAX's run on the conftest's
virtual devices.

Held here at ``tiny_llama`` (8 heads, 4 KV heads) with JAX's weights at
f32: greedy tokens equal JAX's SP Generator on the same mesh shape and
the single-device Generator's, every long prompt through the SP prefill
(no fallback); the cache's layout; Ulysses refusing an sp that does not
divide a tp shard's heads; JAX's refusal of the striped pool over tp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu import parallel as jpar
from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.ml.sp_serving import SPConfig as JSPConfig
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch import parallel as par
from gofr_tpu_torch.ml.generate import Generator
from gofr_tpu_torch.ml.sp_serving import SPConfig
from gofr_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.timeout(300)

CPU = torch.device("cpu")
KW = dict(batch_slots=2, max_seq=64, prefill_buckets=(8, 32), chunk=4)
PROMPTS = ([int(i) for i in np.arange(1, 21) % 512],
           [int(i) for i in np.arange(40, 63) % 512])
N_NEW = 20  # 20 + 20 > 32 = max_seq / sp: decode crosses the shards


@pytest.fixture(scope="module")
def setup():
    jcfg = jllama.tiny_llama(use_flash=False, dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    params = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    return jcfg, jparams, params


def _mesh(sp=2, tp=2):
    return par.make_mesh(par.MeshConfig(sp=sp, tp=tp),
                         devices=[CPU] * (sp * tp))


def _cfg():
    return tllama.tiny_llama(dtype=torch.float32)


def _run(gen):
    """Both prompts at once, then the first alone again on its freed
    slot."""
    slots = [gen.add_request(p, N_NEW) for p in PROMPTS]
    while any(gen.slots[s].live for s in slots):
        gen.step()
    gen.drain()
    out = [list(gen.slots[s].tokens) for s in slots]
    for s in slots:
        gen.release(s)
    return out + [gen.generate(PROMPTS[0], max_new_tokens=N_NEW)]


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_sp_over_tp_tokens_match_jax(setup, mode):
    """The dense SP Generator over params split tp = 2 on an sp = 2 x tp
    = 2 mesh: greedy tokens equal JAX's SP Generator on its mesh and the
    port's single-device Generator; every prompt (>= min_tokens 16) took
    the SP prefill, none fell back."""
    jcfg, jparams, params = setup
    jmesh = jpar.make_mesh(jpar.MeshConfig(sp=2, tp=2),
                           devices=jax.devices()[:4])
    jplaced = jpar.shard_params(
        jparams, jpar.specs_from_rules(jparams, jllama.SHARDING_RULES), jmesh)
    want = _run(JGenerator(jplaced, jcfg, mesh=jmesh,
                           sp=JSPConfig(mode, min_tokens=16), **KW))
    mesh = _mesh()
    split = par.shard_params(params, tllama.sharding_specs(params), mesh)
    gen = Generator(split, _cfg(), mesh=mesh,
                    sp=SPConfig(mode, min_tokens=16), device="cpu", **KW)
    assert _run(gen) == want
    assert gen.sp_stats()["prefills"] == 3 and gen.sp_stats()["fallbacks"] == 0
    assert _run(Generator(params, _cfg(), device="cpu", **KW)) == want


def test_sp_over_tp_cache_layout(setup):
    """The cache splits KV heads over tp and each tp block's sequence
    over that shard's sp devices: k [L, B, 64, 4, D] over tp on the head
    axis, each block [L, B, 64, 2, D] over sp on the sequence axis, the
    blocks on the devices of their mesh positions; decode writes in
    place."""
    _, _, params = setup
    mesh = _mesh()
    split = par.shard_params(params, tllama.sharding_specs(params), mesh)
    gen = Generator(split, _cfg(), mesh=mesh, sp=SPConfig("ring",
                                                          min_tokens=16),
                    device="cpu", **KW)
    k = gen.cache["k"]
    assert isinstance(k, par.ShardedTensor) and k.axis == 3 and k.n == 2
    assert tuple(k.shape) == (2, 2, 64, 4, 16)
    for d, inner in enumerate(k.shards):
        assert isinstance(inner, par.ShardedTensor) and inner.axis == 2
        assert [tuple(t.shape) for t in inner.shards] == [(2, 2, 32, 2, 16)] * 2
        assert [t.device for t in inner.shards] == \
            mesh.sub(tp=d).axis_devices("sp")
    ptrs = [t.data_ptr() for _, t in k.leaf_blocks()]
    gen.generate(PROMPTS[0], max_new_tokens=N_NEW)
    assert [t.data_ptr() for _, t in gen.cache["k"].leaf_blocks()] == ptrs
    assert all(float(t.abs().sum()) > 0 for _, t in k.leaf_blocks())


def test_ulysses_needs_sp_to_divide_a_shards_heads(setup):
    """Ulysses over tp = 2 reshards each shard's 4 heads over sp: sp = 8
    divides the model's 8 heads but not a shard's 4, and the Generator
    raises at construction (JAX's ``ulysses_attention`` message); ring
    takes the same mesh."""
    _, _, params = setup
    mesh = _mesh(sp=8, tp=2)
    split = par.shard_params(params, tllama.sharding_specs(params), mesh)
    kw = {**KW, "prefill_buckets": (32,)}
    with pytest.raises(ValueError, match="local .per-tp-shard. head count 4"):
        Generator(split, _cfg(), mesh=mesh, sp=SPConfig("ulysses",
                                                        min_tokens=16),
                  device="cpu", **kw)
    gen = Generator(split, _cfg(), mesh=mesh,
                    sp=SPConfig("ring", min_tokens=16), device="cpu", **kw)
    assert gen.generate(PROMPTS[0], max_new_tokens=4) == Generator(
        params, _cfg(), device="cpu", **kw).generate(PROMPTS[0],
                                                     max_new_tokens=4)


def test_striped_pool_over_tp_is_refused_as_jax_refuses(setup):
    """JAX's plan refuses striped pages on a mesh with another axis > 1;
    the port's says the same."""
    jcfg, jparams, params = setup
    kw = {**KW, "page_size": 8}
    jmesh = jpar.make_mesh(jpar.MeshConfig(sp=2, tp=2),
                           devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="striped KV pages"):
        JGenerator(jparams, jcfg, mesh=jmesh, sp="ring", **kw)
    mesh = _mesh()
    split = par.shard_params(params, tllama.sharding_specs(params), mesh)
    with pytest.raises(ValueError, match="striped KV pages"):
        Generator(split, _cfg(), mesh=mesh, sp="ring", device="cpu", **kw)
