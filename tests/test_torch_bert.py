"""PyTorch port, the BERT encoder (BASELINE config #3, config #5's text
encoder): ``gofr_tpu_torch.models.bert`` against ``gofr_tpu.models.bert``
on the CPU, on the JAX tree carried across with ``params_from_jax`` and
the same numpy tokens.

``forward``'s hidden states, pooled [CLS] and masked mean are held at f32
within 1e-4 of the JAX output's range and at bf16 within 2e-2 (the repo's
bf16 rule), for ``tiny_bert`` and a 2-layer BERT at BERT-base width (768,
12 heads, FFN 3072, vocab 30522). Then the port's twins of
``tests/test_bert.py``: shapes, padding invariance, bidirectionality and
batched serving through the engine (held against the JAX engine too);
JAX's ``test_sharded_forward_matches``: the port's tensor-parallel forward
(``sharding_specs`` over a tp = 2 mesh of repeated CPU devices) against
JAX's sharded one at f32 within 1e-5 of range.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import bert as jbert
from gofr_tpu_torch.models import bert as tbert

pytestmark = pytest.mark.timeout(300)

TOL = {"f32": 1e-4, "bf16": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SIZES = {"tiny": {},
         "base_width": dict(n_layers=2)}  # bert_base's widths, 2 layers


def _range_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(want.max() - want.min())


def _models(size: str, dtype: str, seed: int = 0):
    jdt, tdt = DTYPES[dtype]
    make_j = jbert.tiny_bert if size == "tiny" else jbert.bert_base
    make_t = tbert.tiny_bert if size == "tiny" else tbert.bert_base
    jcfg = make_j(dtype=jdt, **SIZES[size])
    tcfg = make_t(dtype=tdt, **SIZES[size])
    jparams = jbert.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = tbert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def tiny():
    jcfg, jparams, tcfg, tparams = _models("tiny", "bf16")
    return tcfg, tparams


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forward_matches_jax(size, dtype):
    jcfg, jparams, tcfg, tparams = _models(size, dtype)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (3, 24)).astype(np.int32)
    lens = np.array([24, 9, 1], np.int32)
    types = rng.integers(0, 2, (3, 24)).astype(np.int32)
    want = jbert.forward(jparams, jnp.asarray(toks), jcfg,
                         seq_lens=jnp.asarray(lens),
                         token_types=jnp.asarray(types))
    got = tbert.forward(tparams, torch.from_numpy(toks), tcfg,
                        seq_lens=torch.from_numpy(lens),
                        token_types=torch.from_numpy(types))
    for key in ("hidden", "pooled", "mean"):
        assert got[key].shape == tuple(want[key].shape)
        err = _range_err(got[key].float().numpy(), want[key])
        assert err <= TOL[dtype], (key, err)
    assert got["hidden"].dtype == DTYPES[dtype][1]
    assert got["pooled"].dtype == got["mean"].dtype == torch.float32


def test_out_of_vocabulary_ids_gather_as_jax_does():
    """A negative id counts from the end, a large one clamps: JAX's gather,
    where a torch gather would fault."""
    jcfg, jparams, tcfg, tparams = _models("tiny", "f32")
    toks = np.array([[-1, 3, jcfg.vocab_size + 5, -jcfg.vocab_size - 9]],
                    np.int32)
    want = jbert.forward(jparams, jnp.asarray(toks), jcfg)["hidden"]
    got = tbert.forward(tparams, torch.from_numpy(toks), tcfg)["hidden"]
    assert _range_err(got.numpy(), want) <= TOL["f32"]


# -- twins of tests/test_bert.py ------------------------------------------------

def test_forward_shapes(tiny):
    cfg, params = tiny
    out = tbert.forward(params, torch.zeros((2, 8), dtype=torch.int32), cfg)
    assert out["hidden"].shape == (2, 8, cfg.dim)
    assert out["pooled"].shape == (2, cfg.dim)
    assert out["mean"].shape == (2, cfg.dim)


def test_padding_invariance(tiny):
    """A padded row with seq_lens embeds as the unpadded sequence — the
    dynamic batcher's correctness property."""
    cfg, params = tiny
    ids = torch.tensor([[5, 9, 2, 6]], dtype=torch.int32)
    short = tbert.forward(params, ids, cfg, seq_lens=torch.tensor([4]))
    padded = torch.full((1, 12), 7, dtype=torch.int32)  # garbage pad tokens
    padded[0, :4] = ids[0]
    long = tbert.forward(params, padded, cfg, seq_lens=torch.tensor([4]))
    for key in ("mean", "pooled"):
        np.testing.assert_allclose(short[key].numpy(), long[key].numpy(),
                                   atol=2e-2)


def test_bidirectional_not_causal(tiny):
    """Changing a later token changes earlier hidden states."""
    cfg, params = tiny
    a = tbert.forward(params, torch.tensor([[1, 2, 3, 4]], dtype=torch.int32),
                      cfg)
    b = tbert.forward(params, torch.tensor([[1, 2, 3, 9]], dtype=torch.int32),
                      cfg)
    assert not np.allclose(a["hidden"][0, 0].float().numpy(),
                           b["hidden"][0, 0].float().numpy(), atol=1e-4)


# The name is kept from when tp raised: this is now a parity test of
# BERT over tp against JAX's sharded forward.
@pytest.mark.parametrize("tp", [2, 4])
def test_sharding_specs_waits_for_a11(tp):
    """Tensor parallelism, JAX's ``test_sharded_forward_matches``: JAX's
    rules over its (dp=2, tp) mesh, the port's ``sharding_specs`` over tp
    repeated CPU devices; hidden, pooled and mean within 1e-5 of range at
    f32, padded rows masked by ``seq_lens``."""
    from gofr_tpu import parallel as jpar
    from gofr_tpu_torch import parallel as par

    jcfg, jparams, tcfg, tparams = _models("tiny", "f32")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    lens = np.array([16, 9, 3, 16], np.int32)
    jmesh = jpar.make_mesh(jpar.MeshConfig(dp=2, tp=tp),
                           devices=jax.devices()[:2 * tp])
    jsharded = jpar.shard_params(
        jparams, jpar.specs_from_rules(jparams, jbert.SHARDING_RULES), jmesh)
    with jmesh:
        want = jax.jit(lambda p, t, n: jbert.forward(p, t, jcfg, seq_lens=n))(
            jsharded, jnp.asarray(toks), jnp.asarray(lens))
    specs = tbert.Bert(tcfg, params=tparams).sharding_specs()
    assert specs["layers"]["wo"] == par.P(None, "tp", None)
    placed = par.shard_params(tparams, specs, par.make_mesh(
        par.MeshConfig(tp=tp), devices=[torch.device("cpu")] * tp))
    assert isinstance(placed["layers"]["wq"], par.ShardedTensor)
    got = tbert.forward(placed, torch.from_numpy(toks), tcfg,
                        seq_lens=torch.from_numpy(lens))
    for key in ("hidden", "pooled", "mean"):
        assert _range_err(got[key], want[key]) <= 1e-5, key


def test_engine_batched_serving(run):
    """Bert through MLDatasource + DynamicBatcher: concurrent single
    requests coalesce, every caller gets its own row, equal to the row
    served alone and to the JAX engine's batched answer."""
    from gofr_tpu.ml import MLDatasource as JMLDatasource
    from gofr_tpu_torch.ml import MLDatasource

    jcfg, jparams, tcfg, tparams = _models("tiny", "bf16")
    jm = jbert.Bert(jcfg)
    tm = tbert.Bert(tcfg, params=tparams)
    example = (np.zeros((1, 8), np.int32), np.full((1,), 1, np.int32))
    jm.example_inputs = tm.example_inputs = example
    jml, tml = JMLDatasource(), MLDatasource()
    jml.register("bert", jm, batching=True)
    tml.register("bert", tm, batching=True)

    ids = [np.array([i + 1, i + 2, 0, 0, 0, 0, 0, 0], np.int32)
           for i in range(5)]
    lens = np.int32(2)

    async def scenario(ml):
        return await asyncio.gather(*(ml.predict("bert", x, lens)
                                      for x in ids))

    try:
        got, want = run(scenario(tml)), run(scenario(jml))
        solo = [tm.apply(tparams, torch.from_numpy(x[None]),
                         torch.tensor([2], dtype=torch.int32))[0].numpy()
                for x in ids]
        for g, s, w in zip(got, solo, want):
            np.testing.assert_allclose(g, s, atol=2e-2)
            assert _range_err(g, w) <= TOL["bf16"]
        assert tml.engine("bert").compiled_buckets == \
            jml.engine("bert").compiled_buckets
    finally:
        jml.close()
        tml.close()
