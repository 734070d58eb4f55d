"""Ulysses, the MoE layer, the pipeline schedule and the sequence-parallel
kernels under the serving mask, held against the JAX package (twins of
``tests/test_parallel_advanced.py``) on the conftest's 8-device CPU mesh;
the port's meshes are ``[cpu] * n`` with JAX's ``n``.

Inputs come from numpy seeds (weights through the MoE bridge, since JAX
draws them with its PRNG). Tolerances at f32: attention and pipeline
outputs 1e-5 (JAX's own), the MoE layer 1e-4 against JAX's and against
the dense per-token reference (JAX's own), the int8 sp decode 1e-5
against JAX's int8 result (the same codes) and 0.05 against fp attention.
JAX's ``test_expert_parallel_matches_single_device`` (GSPMD placement over
ep = 4) has its twin in ``test_expert_parallel_raises_naming_a11``: the
port's experts split over ep (and tp) against JAX's sharded layer, 1e-5 of
range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu import parallel as jpar
from gofr_tpu_torch import parallel as par

pytestmark = pytest.mark.timeout(180)

CPU = torch.device("cpu")
TOL = dict(atol=1e-5, rtol=1e-5)


def _mesh(**axes):
    cfg = par.MeshConfig(**axes)
    return par.make_mesh(cfg, devices=[CPU] * int(np.prod(cfg.sizes())))


def _jmesh(**axes):
    cfg = jpar.MeshConfig(**axes)
    return jpar.make_mesh(cfg, devices=jax.devices()[:int(np.prod(
        cfg.sizes()))])


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------------------ ulysses
class TestUlysses:
    @pytest.mark.parametrize("causal", [True, False])
    def test_matches_reference(self, causal):
        from gofr_tpu.parallel.ulysses import ulysses_attention as julysses
        from gofr_tpu_torch.ops import attention
        from gofr_tpu_torch.parallel.ulysses import ulysses_attention

        q, k, v = _qkv(0, (2, 64, 4, 16))
        jmesh = _jmesh(dp=2, tp=2, sp=2)
        with jmesh:
            want = np.asarray(jax.jit(
                lambda q, k, v: julysses(q, k, v, jmesh, causal=causal))(
                    q, k, v))
        tq, tk, tv = _t(q, k, v)
        got = ulysses_attention(tq, tk, tv, _mesh(dp=2, tp=2, sp=2),
                                causal=causal)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(
            got.numpy(), attention(tq, tk, tv, causal=causal).numpy(), **TOL)

    def test_sp4(self):
        from gofr_tpu_torch.ops import attention
        from gofr_tpu_torch.parallel.ulysses import ulysses_attention

        # heads counted per tp shard, as JAX's: 8 / 2 = 4 divide sp = 4
        q, k, v = _t(*_qkv(1, (1, 128, 8, 8)))
        got = ulysses_attention(q, k, v, _mesh(tp=2, sp=4), causal=True)
        np.testing.assert_allclose(
            got.numpy(), attention(q, k, v, causal=True).numpy(), **TOL)

    def test_head_divisibility_raises(self):
        from gofr_tpu_torch.parallel.ulysses import ulysses_attention

        q, k, v = _t(*_qkv(2, (1, 16, 4, 8)))
        with pytest.raises(ValueError, match="local .per-tp-shard. head "
                                             "count 2"):
            ulysses_attention(q, k, v, _mesh(tp=2, sp=4))


# ---------------------------------------------------------------------- moe
@pytest.fixture(scope="module")
def moe_pair():
    """JAX's MoE weights (dim 16, ffn 32, 4 experts, f32) and the port's
    copy of them, bit for bit."""
    from gofr_tpu.models.moe import MoEConfig as JMoEConfig
    from gofr_tpu.models.moe import init_moe_params as jinit
    from gofr_tpu_torch.models.moe import params_from_jax

    jcfg = JMoEConfig(dim=16, ffn_dim=32, n_experts=4, top_k=2,
                      capacity_factor=100.0, dtype=jnp.float32)
    jparams = jinit(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jparams, tparams


def _cfgs(top_k=2, capacity_factor=100.0):
    from gofr_tpu.models.moe import MoEConfig as JMoEConfig
    from gofr_tpu_torch.models.moe import MoEConfig

    kw = dict(dim=16, ffn_dim=32, n_experts=4, top_k=top_k,
              capacity_factor=capacity_factor)
    return JMoEConfig(dtype=jnp.float32, **kw), MoEConfig(
        dtype=torch.float32, **kw)


class TestMoE:
    def _dense_reference(self, params, x, top_k):
        """Every token through its top-k experts with no capacity limit."""
        n, d = x.shape
        probs = torch.softmax(x @ params["router"], dim=-1)
        vals, idx = torch.topk(probs, top_k, dim=-1)
        vals = vals / vals.sum(-1, keepdim=True)
        ex = {k: v.numpy() for k, v in params["experts"].items()}
        out = np.zeros((n, d), np.float32)
        for i in range(n):
            xi = x[i].numpy()
            for j in range(top_k):
                e = int(idx[i, j])
                h = xi @ ex["w_gate"][e]
                u = xi @ ex["w_up"][e]
                out[i] += float(vals[i, j]) * ((h / (1 + np.exp(-h)) * u)
                                               @ ex["w_down"][e])
        return out

    def test_matches_dense_reference_with_ample_capacity(self, moe_pair):
        from gofr_tpu_torch.models.moe import moe_layer

        _, params = moe_pair
        _, cfg = _cfgs()
        x = torch.from_numpy(np.random.default_rng(1).normal(
            size=(2, 6, 16)).astype(np.float32))
        y, aux = moe_layer(params, x, cfg)
        ref = self._dense_reference(params, x.reshape(12, 16), 2)
        np.testing.assert_allclose(y.reshape(12, 16).numpy(), ref,
                                   atol=1e-4, rtol=1e-4)
        assert np.isfinite(float(aux))

    def test_capacity_drops_tokens_to_zero(self):
        from gofr_tpu_torch.models.moe import (MoEConfig, init_moe_params,
                                               moe_layer)

        cfg = MoEConfig(dim=8, ffn_dim=16, n_experts=2, top_k=1,
                        capacity_factor=0.01, dtype=torch.float32)  # C = 1
        params = init_moe_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        tok = torch.from_numpy(np.random.default_rng(2).normal(
            size=(1, 1, 8)).astype(np.float32))
        # identical tokens all route to one expert of capacity 1
        y, _ = moe_layer(params, tok.expand(1, 6, 8).contiguous(), cfg)
        assert int((y[0].abs().sum(-1) > 1e-9).sum()) == 1
        assert y[0, 0].abs().sum() > 0  # the first token got the slot

    @pytest.mark.parametrize("top_k, capacity_factor",
                             [(2, 100.0), (2, 0.5), (1, 0.3)])
    def test_matches_jax_moe_layer(self, moe_pair, top_k, capacity_factor):
        """The same weights and tokens give JAX's output, aux loss and
        dispatch / combine tensors: the leftmost-first, k = 0-first slot
        order, and the tokens dropped past capacity (0.5 and 0.3 drop)."""
        from gofr_tpu.models.moe import _dispatch_combine as jdc
        from gofr_tpu.models.moe import moe_layer as jmoe
        from gofr_tpu_torch.models.moe import _dispatch_combine, moe_layer

        jparams, tparams = moe_pair
        jcfg, tcfg = _cfgs(top_k, capacity_factor)
        x = np.random.default_rng(3).normal(size=(4, 8, 16)).astype(
            np.float32)
        jy, jaux = jmoe(jparams, jnp.asarray(x), jcfg)
        ty, taux = moe_layer(tparams, torch.from_numpy(x), tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
        probs = np.array(jax.nn.softmax(
            jnp.asarray(x.reshape(-1, 16)) @ jparams["router"], axis=-1))
        cap = max(1, int(capacity_factor * 32 * top_k / 4))
        want = jdc(jnp.asarray(probs), top_k, cap)
        got = _dispatch_combine(torch.from_numpy(probs), top_k, cap)
        for g, w in zip(got[:2], want[:2], strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
        if capacity_factor < 1:
            assert float(got[0].sum()) < 32 * top_k  # some tokens dropped

    # The name is kept from when ep raised: this is now a parity test of
    # the experts over ep (and tp) against JAX's sharded layer.
    @pytest.mark.parametrize("axes", [{"dp": 2, "ep": 4}, {"ep": 2},
                                      {"ep": 2, "tp": 2}])
    def test_expert_parallel_raises_naming_a11(self, moe_pair, axes):
        """Expert parallelism against JAX's GSPMD-sharded layer on the same
        mesh shape: ``MOE_SHARDING_RULES`` split the experts over ep (and
        their ffn over tp) and the layer equals JAX's sharded one within
        1e-5 of range at f32. At ep = 1 the rules place everything on the
        mesh's first device and the layer is unchanged; a router split over
        fsdp is gathered where the tokens are and the layer equals JAX's
        over the same placement."""
        from gofr_tpu.models.moe import MOE_SHARDING_RULES as JRULES
        from gofr_tpu.models.moe import moe_layer as jmoe_layer
        from gofr_tpu_torch.models.moe import MOE_SHARDING_RULES, moe_layer

        jparams, params = moe_pair
        jcfg, cfg = _cfgs()
        specs = par.specs_from_rules(params, MOE_SHARDING_RULES)
        assert specs["experts"]["w_down"] == par.P("ep", "tp", None)
        x = np.random.default_rng(4).normal(size=(4, 8, 16)).astype(
            np.float32)
        jmesh = _jmesh(**axes)
        jplaced = jpar.shard_params(
            jparams, jpar.specs_from_rules(jparams, JRULES), jmesh)
        with jmesh:
            want, _ = jax.jit(lambda p, x: jmoe_layer(p, x, jcfg))(
                jplaced, jnp.asarray(x))
        mesh = _mesh(**axes)
        placed = par.shard_params(params, specs, mesh)
        assert isinstance(placed["experts"]["w_gate"], par.ShardedTensor)
        with mesh:
            got, _ = moe_layer(placed, torch.from_numpy(x), cfg)
        want = np.asarray(want)
        scale = float(want.max() - want.min())
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * scale)
        mesh = _mesh(dp=2, sp=4)
        with mesh:
            same, _ = moe_layer(par.shard_params(params, specs, mesh),
                                torch.from_numpy(x), cfg)
        assert torch.equal(same, moe_layer(params, torch.from_numpy(x),
                                           cfg)[0])
        fspecs = {"router": par.P("fsdp", None), "experts": specs["experts"]}
        fmesh = _mesh(fsdp=2, **{k: v for k, v in axes.items()
                                 if k != "dp"})
        fplaced = par.shard_params(params, fspecs, fmesh)
        assert fplaced["router"].mesh_axis == "fsdp"
        with fmesh:
            fgot, _ = moe_layer(fplaced, torch.from_numpy(x), cfg)
        jfmesh = _jmesh(fsdp=2, **{k: v for k, v in axes.items()
                                   if k != "dp"})
        jfspecs = {"router": jpar.P("fsdp", None),
                   "experts": jpar.specs_from_rules(jparams,
                                                    JRULES)["experts"]}
        with jfmesh:
            fwant, _ = jax.jit(lambda p, x: jmoe_layer(p, x, jcfg))(
                jpar.shard_params(jparams, jfspecs, jfmesh), jnp.asarray(x))
        np.testing.assert_allclose(fgot.numpy(), np.asarray(fwant), rtol=0,
                                   atol=1e-5 * scale)


# ----------------------------------------------------------------- pipeline
class TestPipeline:
    def _layer_params(self, L, D, seed, bias=True):
        rng = np.random.default_rng(seed)
        lp = {"w": (rng.normal(size=(L, D, D)) * 0.3).astype(np.float32)}
        if bias:
            lp["b"] = (rng.normal(size=(L, D)) * 0.1).astype(np.float32)
        return lp

    def test_matches_sequential(self):
        """pp = 4, 8 layers, 4 microbatches: equal to the layers run in
        order and to JAX's ``pipeline_layers`` on the same weights."""
        from gofr_tpu.parallel.pipeline import pipeline_layers as jpipe
        from gofr_tpu_torch.parallel.pipeline import pipeline_layers

        L, D = 8, 16
        lp = self._layer_params(L, D, 0)
        x = np.random.default_rng(1).normal(size=(8, D)).astype(np.float32)
        jmesh = _jmesh(pp=4, tp=2)
        with jmesh:
            want = np.asarray(jax.jit(lambda p, x: jpipe(
                lambda q, a: jnp.tanh(a @ q["w"] + q["b"]), p, x, jmesh,
                n_micro=4))(lp, x))
        tlp = {k: torch.from_numpy(v) for k, v in lp.items()}
        got = pipeline_layers(lambda q, a: torch.tanh(a @ q["w"] + q["b"]),
                              tlp, torch.from_numpy(x), _mesh(pp=4, tp=2),
                              n_micro=4)
        seq = torch.from_numpy(x)
        for i in range(L):
            seq = torch.tanh(seq @ tlp["w"][i] + tlp["b"][i])
        np.testing.assert_allclose(got.numpy(), seq.numpy(), **TOL)
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    def test_more_microbatches_than_stages(self):
        from gofr_tpu_torch.parallel.pipeline import pipeline_layers

        L, D = 4, 8
        w = torch.from_numpy(self._layer_params(L, D, 2, bias=False)["w"])
        x = torch.from_numpy(np.random.default_rng(3).normal(
            size=(12, D)).astype(np.float32))
        seq = x
        for i in range(L):
            seq = torch.tanh(seq @ w[i])
        got = pipeline_layers(lambda p, a: torch.tanh(a @ p["w"]), {"w": w},
                              x, _mesh(pp=2, tp=4), n_micro=6)
        np.testing.assert_allclose(got.numpy(), seq.numpy(), **TOL)

    def test_stage_stacked_params_through_the_bridge(self):
        """JAX's stage-stacked tree ([pp, L/pp, ...]) carried across with
        ``tree_from_numpy`` equals the port's ``stack_stages`` bit for bit,
        and ``pipeline_apply`` over it equals the layers run in order."""
        from gofr_tpu.parallel.pipeline import stack_stages as jstack
        from gofr_tpu_torch.models import tree_from_numpy
        from gofr_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                       stack_stages)

        L, D = 4, 8
        lp = self._layer_params(L, D, 5)
        staged = tree_from_numpy(jax.tree.map(np.asarray, jstack(lp, 2)),
                                 CPU)
        mine = stack_stages({k: torch.from_numpy(v) for k, v in lp.items()},
                            2)
        for k in lp:
            assert torch.equal(staged[k], mine[k])
        x = torch.from_numpy(np.random.default_rng(6).normal(
            size=(3, 2, D)).astype(np.float32))

        def stage_fn(p, a):
            for i in range(p["w"].shape[0]):
                a = torch.tanh(a @ p["w"][i] + p["b"][i])
            return a

        got = pipeline_apply(stage_fn, staged, x, _mesh(pp=2))
        seq = x
        for s in range(2):
            seq = stage_fn({k: v[s] for k, v in staged.items()}, seq)
        np.testing.assert_allclose(got.numpy(), seq.numpy(), **TOL)

    def test_stack_stages_validates(self):
        from gofr_tpu_torch.parallel.pipeline import stack_stages

        with pytest.raises(ValueError, match="not divisible"):
            stack_stages({"w": torch.zeros((7, 3))}, 2)
        assert stack_stages({"w": torch.zeros((8, 3))}, 4)["w"].shape == (
            4, 2, 3)


# ------------------------------------------- kv_len masking parity (serving)
class TestSeqParallelKvLenParity:
    """The SP kernels under the SERVING mask: every row has a true length
    (``kv_len``) and the padded tail is masked on global positions, as
    JAX's ring and Ulysses mask it."""

    @pytest.mark.parametrize("impl", ["ring", "ulysses"])
    def test_prefill_attention_masks_padded_tail(self, impl):
        from gofr_tpu.parallel.ring import ring_attention as jring
        from gofr_tpu.parallel.ulysses import ulysses_attention as julysses
        from gofr_tpu_torch.ops import attention
        from gofr_tpu_torch.parallel.ring import ring_attention
        from gofr_tpu_torch.parallel.ulysses import ulysses_attention

        jfn = jring if impl == "ring" else julysses
        fn = ring_attention if impl == "ring" else ulysses_attention
        q, k, v = _qkv(11, (2, 64, 4, 16))
        lens = np.array([37, 64], np.int32)  # one padded, one full
        jmesh = _jmesh(dp=2, tp=2, sp=2)
        with jmesh:
            want = np.asarray(jax.jit(
                lambda q, k, v, n: jfn(q, k, v, jmesh, kv_len=n,
                                       causal=True))(q, k, v, lens))
        tq, tk, tv, tl = _t(q, k, v, lens)
        got = fn(tq, tk, tv, _mesh(dp=2, tp=2, sp=2), kv_len=tl,
                 causal=True).numpy()
        ref = attention(tq, tk, tv, causal=True, kv_len=tl).numpy()
        # only the VALID rows must agree: padded-tail rows are garbage on
        # both sides by contract
        for b, n in enumerate(lens):
            np.testing.assert_allclose(got[b, :n], ref[b, :n], **TOL)
            np.testing.assert_allclose(got[b, :n], want[b, :n], **TOL)

    @pytest.mark.parametrize("int8", [False, True])
    def test_sp_decode_matches_single_device_decode(self, int8):
        """The stacked cache at each layer, lengths straddling the S/sp =
        12 shard boundaries: JAX's ``sp_decode_attention`` on the same
        inputs (int8: the same codes and seq-minor scales), and the
        single-device decode."""
        from gofr_tpu.parallel.ring import sp_decode_attention as jsp
        from gofr_tpu_torch.ops import gqa_decode_attention, quantize_kv
        from gofr_tpu_torch.parallel.ring import sp_decode_attention

        rng = np.random.default_rng(5)
        B, S, KV, R, D, L = 2, 48, 2, 4, 8, 2
        q = rng.normal(size=(B, 1, KV * R, D)).astype(np.float32)
        k = rng.normal(size=(L, B, S, KV, D)).astype(np.float32)
        v = rng.normal(size=(L, B, S, KV, D)).astype(np.float32)
        lens = np.array([11, 37], np.int32)
        tq, tk, tv, tl = _t(q, k, v, lens)
        kw, jkw, args, jargs = {}, {}, (tk, tv), (k, v)
        if int8:
            (kq, ks), (vq, vs) = quantize_kv(tk), quantize_kv(tv)
            flat = (lambda a: a.reshape(L, B, S, KV * D))
            args = (flat(kq), flat(vq))
            kw = {"k_scale": ks.transpose(2, 3), "v_scale": vs.transpose(2, 3)}
            jargs = tuple(jnp.asarray(a.numpy()) for a in args)
            jkw = {n: jnp.asarray(s.float().numpy()).astype(jnp.bfloat16)
                   for n, s in kw.items()}
        jmesh = _jmesh(tp=2, sp=4)
        mesh = _mesh(tp=2, sp=4)
        for layer in range(L):
            got = sp_decode_attention(tq, *args, tl, mesh, layer=layer, **kw)
            want = np.asarray(jsp(jnp.asarray(q), *jargs, jnp.asarray(lens),
                                  jmesh, layer=jnp.int32(layer), **jkw))
            np.testing.assert_allclose(got.numpy(), want, **TOL)
            single = gqa_decode_attention(tq, tk[layer], tv[layer], tl)
            np.testing.assert_allclose(got.numpy(), single.numpy(),
                                       **(dict(atol=0.05, rtol=0.05) if int8
                                          else TOL))
            # the per-layer cache (no layer index) gives the same
            per_layer = {n: s[layer] for n, s in kw.items()}
            alone = sp_decode_attention(tq, *(a[layer] for a in args), tl,
                                        mesh, **per_layer)
            assert torch.equal(alone, got)
