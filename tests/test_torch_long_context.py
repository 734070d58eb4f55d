"""Long-context serving in the port: ring / Ulysses attention wired into the
Generator through a bare sequence-parallel config and a mesh (twins of
``tests/test_long_context_serving.py``).

A Generator built with ``attn_impl="ring"`` (or ``"ulysses"``) and an
sp > 1 mesh prefills through the sequence-parallel attention and decodes
over a KV cache whose sequence axis is split across the mesh's shards
(one ``ShardedTensor`` block a shard). On the tiny config at f32 with
JAX's weights, its greedy tokens equal the port's single-device tokens,
JAX's single-device tokens and JAX's SP Generator's, the fp cache and the
int8 one, past the 32-position shard boundary. The port's mesh is
``[cpu] * 8`` (dp 1, tp 4, sp 2), JAX's the conftest's 8 devices.
Function-level tolerances at f32: the sp decode combine 1e-5 against
JAX's (int8: the same codes), 0.05 against fp attention for int8; the
ring forward 2e-4 against the single-device forward (JAX's own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu import parallel as jpar
from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch import parallel as par
from gofr_tpu_torch.ml.generate import Generator
from gofr_tpu_torch.models import llama as tllama
from gofr_tpu_torch.parallel import ShardedTensor

pytestmark = pytest.mark.timeout(240)

CPU = torch.device("cpu")
N_NEW = 30  # 10 prompt + 30 new > 32 = S / sp: decode crosses the shards


def _mesh_sp2():
    # every virtual device: heads over tp, sequence over sp
    return par.make_mesh(par.MeshConfig(dp=1, tp=4, sp=2), devices=[CPU] * 8)


@pytest.fixture(scope="module")
def setup():
    """JAX's tiny weights (fp and int8-cache configs share them) and the
    port's copy; the prompt."""
    jcfg = jllama.tiny_llama(use_flash=False, dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    prompt = np.arange(1, 11, dtype=np.int32) % jcfg.vocab_size
    return jparams, tparams, prompt


def _tcfg(**kw):
    return tllama.tiny_llama(dtype=torch.float32, **kw)


def _generate(params, cfg, prompt, mesh=None, n=N_NEW, chunk=4):
    gen = Generator(params, cfg, batch_slots=2, max_seq=64,
                    prefill_buckets=(16,), mesh=mesh, chunk=chunk,
                    device="cpu")
    return gen.generate(prompt, max_new_tokens=n)


@pytest.fixture(scope="module")
def jax_tokens(setup):
    """JAX's greedy tokens: single-device fp and int8 cache, and its ring
    SP Generator over the sp = 2 mesh."""
    jparams, _, prompt = setup

    def run(mesh=None, **kw):
        cfg = jllama.tiny_llama(use_flash=False, dtype=jnp.float32, **kw)
        gen = JGenerator(jparams, cfg, batch_slots=2, max_seq=64,
                         prefill_buckets=(16,), mesh=mesh, chunk=4)
        return gen.generate(prompt, max_new_tokens=N_NEW)

    jmesh = jpar.make_mesh(jpar.MeshConfig(dp=1, tp=4, sp=2))
    return {"fp": run(), "int8": run(kv_quant=True),
            "ring": run(jmesh, attn_impl="ring")}


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sp_generator_matches_unsharded(setup, jax_tokens, impl):
    _, params, prompt = setup
    want = _generate(params, _tcfg(), prompt, n=12)
    got = _generate(params, _tcfg(attn_impl=impl), prompt, mesh=_mesh_sp2(),
                    n=12)
    assert got == want == jax_tokens["fp"][:12]
    assert got == jax_tokens["ring"][:12]


def test_sp_cache_is_sequence_sharded(setup):
    """The dense cache splits its sequence axis over sp: one [L, B, 32,
    KV, D] block a shard; decode steps write in place and keep it split."""
    _, params, prompt = setup
    gen = Generator(params, _tcfg(attn_impl="ring"), batch_slots=2,
                    max_seq=64, prefill_buckets=(16,), mesh=_mesh_sp2(),
                    chunk=2, device="cpu")
    k = gen.cache["k"]
    assert isinstance(k, ShardedTensor) and k.axis == 2 and k.n == 2
    assert tuple(k.shape) == (2, 2, 64, 4, 16)
    assert [tuple(s.shape) for s in k.shards] == [(2, 2, 32, 4, 16)] * 2
    ptrs = [s.data_ptr() for s in k.shards]
    gen.add_request(prompt, max_new_tokens=8)
    gen.step()
    gen.drain()
    assert gen.cache["k"] is k and [s.data_ptr() for s in k.shards] == ptrs
    assert float(k.shards[0].abs().sum()) > 0


@pytest.mark.parametrize("int8", [False, True])
def test_sp_decode_attention_exact_vs_dense(int8):
    """The distributed softmax combine over sp = 2 is exact: JAX's
    ``sp_decode_attention`` on the same inputs (int8: the same codes and
    seq-minor scales) within 1e-5, the single-device decode within 1e-5
    (fp) or 0.05 (int8)."""
    from gofr_tpu.parallel.ring import sp_decode_attention as jsp
    from gofr_tpu_torch.ops import gqa_decode_attention, quantize_kv
    from gofr_tpu_torch.parallel.ring import sp_decode_attention

    rng = np.random.default_rng(7 if int8 else 3)
    B, S, KV, R, D, L = 2, 32, 2, 3, 8, 2
    q = rng.normal(size=(B, 1, KV * R, D)).astype(np.float32)
    k = rng.normal(size=(L, B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(L, B, S, KV, D)).astype(np.float32)
    lens = np.array([7, 29], np.int32)
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, lens))
    args, kw, jargs, jkw = (tk, tv), {}, (k, v), {}
    if int8:
        # init_cache's layout: flat [L, B, S, KV*D] values, [L, B, KV, S]
        # scales
        (kq, ks), (vq, vs) = quantize_kv(tk), quantize_kv(tv)
        args = (kq.reshape(L, B, S, KV * D), vq.reshape(L, B, S, KV * D))
        kw = {"k_scale": ks.transpose(2, 3), "v_scale": vs.transpose(2, 3)}
        jargs = tuple(jnp.asarray(a.numpy()) for a in args)
        jkw = {n: jnp.asarray(s.float().numpy()).astype(jnp.bfloat16)
               for n, s in kw.items()}
    jmesh = jpar.make_mesh(jpar.MeshConfig(dp=1, tp=4, sp=2))
    for layer in (0, 1):
        got = sp_decode_attention(tq, *args, tl, _mesh_sp2(), layer=layer,
                                  **kw)
        want = jsp(jnp.asarray(q), *jargs, jnp.asarray(lens), jmesh,
                   layer=jnp.int32(layer), **jkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
        single = gqa_decode_attention(tq, tk[layer], tv[layer], tl)
        tol = 0.05 if int8 else 1e-5
        np.testing.assert_allclose(got.numpy(), single.numpy(), atol=tol,
                                   rtol=tol)


def test_attn_impl_validation():
    with pytest.raises(ValueError, match="attn_impl"):
        tllama.LlamaConfig(attn_impl="nope")


def test_forward_with_ring_matches_dense(setup):
    """The full-sequence forward under sp = 2 ring equals the unsharded
    one, and JAX's, on the valid positions."""
    jparams, params, _ = setup
    toks = np.arange(32, dtype=np.int32)[None, :] % 512
    lens = np.array([27], np.int32)
    want = np.asarray(jllama.forward(
        jparams, jnp.asarray(toks),
        jllama.tiny_llama(use_flash=False, dtype=jnp.float32),
        seq_lens=jnp.asarray(lens)))
    plain = tllama.forward(params, toks, _tcfg(), seq_lens=lens)
    got = tllama.forward(params, toks, _tcfg(attn_impl="ring"), seq_lens=lens,
                         mesh=_mesh_sp2())
    np.testing.assert_allclose(got.numpy()[:, :27], plain.numpy()[:, :27],
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got.numpy()[:, :27], want[:, :27], atol=2e-4,
                               rtol=2e-4)


def test_sp_generator_kv_quant_matches_unsharded_quant(setup, jax_tokens):
    """kv_quant composes with sp: the ring Generator over the int8 cache
    gives the unsharded int8 tokens (the port's and JAX's), decoding far
    enough that late tokens attend keys on BOTH shards."""
    _, params, prompt = setup
    want = _generate(params, _tcfg(kv_quant=True), prompt)
    got = _generate(params, _tcfg(attn_impl="ring", kv_quant=True), prompt,
                    mesh=_mesh_sp2())
    assert got == want == jax_tokens["int8"]
    assert len(got) == N_NEW


def test_sp_generator_fp_long_decode_crosses_shard_boundary(setup,
                                                            jax_tokens):
    _, params, prompt = setup
    got = _generate(params, _tcfg(attn_impl="ring"), prompt,
                    mesh=_mesh_sp2())
    assert got == jax_tokens["fp"] == jax_tokens["ring"]


def test_sp_quantized_cache_shardings(setup):
    """int8 SP cache: flat values split S (axis 2), seq-minor scales split
    S (axis 3), one block a shard, kept through decode."""
    _, params, prompt = setup
    gen = Generator(params, _tcfg(attn_impl="ring", kv_quant=True),
                    batch_slots=2, max_seq=64, prefill_buckets=(16,),
                    mesh=_mesh_sp2(), chunk=2, device="cpu")
    assert gen.cache["k"].axis == 2 and gen.cache["k_scale"].axis == 3
    assert tuple(gen.cache["k_scale"].shards[1].shape) == (2, 2, 4, 32)
    gen.add_request(prompt, max_new_tokens=8)
    gen.step()
    gen.drain()
    assert gen.cache["k"].axis == 2 and gen.cache["k_scale"].axis == 3
    assert gen.cache["k"].dtype == torch.int8
