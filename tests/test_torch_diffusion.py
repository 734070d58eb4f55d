"""PyTorch port, the DiT and its DDIM sampler (BASELINE config #5):
``gofr_tpu_torch.models.diffusion`` against ``gofr_tpu.models.diffusion``
on the CPU, on the JAX tree carried across with ``params_from_jax``.

``ada_w`` and ``patch_out`` start at zero, so an unperturbed DiT predicts
eps = 0 whatever its trunk computes: every comparison here first perturbs
them with seeded noise (x 0.02), as JAX's
``test_conditioning_changes_output`` does. ``forward`` is held within
1e-4 of the JAX output's range at f32 and 2e-2 at bf16; ``ddim_sample``,
given JAX's own initial noise (``jax.random.normal(key)``, which the port
cannot draw), within 1e-4 at f32; the timestep schedule equals JAX's for
every step count 1..50. Then the port's twins of
``tests/test_diffusion.py``; JAX's ``test_sharded_forward_matches``: the
port's tensor-parallel forward (``sharding_specs`` over tp = 4 repeated
CPU devices) against JAX's sharded one within 1e-5 of range at f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import diffusion as jdit
from gofr_tpu_torch.models import diffusion as tdit

pytestmark = pytest.mark.timeout(300)

TOL = {"f32": 1e-4, "bf16": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _range_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(want.max() - want.min())


def _perturbed(cfg, params):
    """JAX's params with ``patch_out`` and ``ada_w`` drawn from seeded
    noise (the JAX test's keys and scale)."""
    params = dict(params)
    params["patch_out"] = (jax.random.normal(
        jax.random.PRNGKey(1), params["patch_out"].shape) * 0.02
    ).astype(cfg.dtype)
    layers = dict(params["layers"])
    layers["ada_w"] = (jax.random.normal(
        jax.random.PRNGKey(11), layers["ada_w"].shape) * 0.02
    ).astype(cfg.dtype)
    params["layers"] = layers
    return params


def _models(dtype: str):
    jdt, tdt = DTYPES[dtype]
    jcfg, tcfg = jdit.tiny_dit(dtype=jdt), tdit.tiny_dit(dtype=tdt)
    jparams = _perturbed(jcfg, jdit.init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = tdit.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def f32():
    return _models("f32")


def _inputs(cfg, b: int = 2, seed: int = 2):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((b, cfg.latent_size, cfg.latent_size,
                               cfg.latent_channels)).astype(np.float32)
    ctx = rng.standard_normal((b, 5, cfg.ctx_dim)).astype(np.float32)
    return lat, ctx


def test_patchify_roundtrip(f32):
    jcfg, _, tcfg, _ = f32
    x = np.arange(2 * 8 * 8 * 4, dtype=np.float32).reshape(2, 8, 8, 4)
    patches = tdit.patchify(torch.from_numpy(x), tcfg)
    assert patches.shape == (2, tcfg.n_patches, tcfg.patch_dim)
    np.testing.assert_array_equal(
        patches.numpy(), np.asarray(jdit.patchify(jnp.asarray(x), jcfg)))
    np.testing.assert_array_equal(
        tdit.unpatchify(patches, tcfg).numpy(), x)


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 10, 499, 999], np.int32)
    want = jdit._timestep_embedding(jnp.asarray(t), 64)
    got = tdit._timestep_embedding(torch.from_numpy(t), 64)
    assert _range_err(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forward_matches_jax(dtype):
    jcfg, jparams, tcfg, tparams = _models(dtype)
    lat, ctx = _inputs(jcfg)
    t = np.array([10, 500], np.int32)
    want = jdit.forward(jparams, jnp.asarray(lat), jnp.asarray(t),
                        jnp.asarray(ctx), jcfg)
    got = tdit.forward(tparams, torch.from_numpy(lat), torch.from_numpy(t),
                       torch.from_numpy(ctx), tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _range_err(got.numpy(), want) <= TOL[dtype]


@pytest.mark.parametrize("steps,guidance", [(4, 2.0), (7, 5.0)])
def test_ddim_sample_matches_jax_given_its_noise(f32, steps, guidance):
    jcfg, jparams, tcfg, tparams = f32
    _, ctx = _inputs(jcfg, seed=5)
    key = jax.random.PRNGKey(7)
    noise = np.array(jax.random.normal(key, (2, 8, 8, 4), jnp.float32))
    want = jdit.ddim_sample(jparams, jnp.asarray(ctx), jcfg, key,
                            steps=steps, guidance=guidance)
    got = tdit.ddim_sample(tparams, torch.from_numpy(ctx), tcfg,
                           torch.from_numpy(noise), steps=steps,
                           guidance=guidance)
    assert got.shape == want.shape and np.isfinite(got.numpy()).all()
    assert _range_err(got.numpy(), want) <= TOL["f32"]


def test_timesteps_equal_jax_for_every_step_count():
    """``jnp.linspace(999, 0, steps).astype(int32)`` as JAX computes it:
    a true division would pick another t at steps 28 and 38."""
    for steps in range(1, 51):
        want = np.asarray(jnp.linspace(999, 0, steps).astype(jnp.int32))
        assert tdit.ddim_timesteps(steps) == want.tolist(), steps


def test_alphas_bar_matches_jax():
    want = np.asarray(jnp.cumprod(
        1.0 - jnp.linspace(1e-4, 0.02, 1000, dtype=jnp.float32)))
    got = tdit.alphas_bar()
    assert got.dtype == np.float32 and got.shape == (1000,)
    np.testing.assert_allclose(got, want, rtol=1e-6)


# -- twins of tests/test_diffusion.py -----------------------------------------

def test_forward_shapes(f32):
    _, _, cfg, params = f32
    lat = torch.zeros((2, 8, 8, 4))
    ctx = torch.zeros((2, 5, cfg.ctx_dim))
    eps = tdit.forward(params, lat, torch.tensor([10, 500]), ctx, cfg)
    assert eps.shape == lat.shape and eps.dtype == torch.float32


def test_conditioning_changes_output(f32):
    """Different text context, and a different timestep, steer the
    predicted noise (the perturbed model's conditioning is live)."""
    _, _, cfg, params = f32
    g = torch.Generator().manual_seed(3)
    lat = torch.randn((1, 8, 8, 4), generator=g)
    c1 = torch.randn((1, 5, cfg.ctx_dim), generator=g)
    c2 = torch.randn((1, 5, cfg.ctx_dim), generator=g)
    t = torch.tensor([300])
    e1 = tdit.forward(params, lat, t, c1, cfg)
    e2 = tdit.forward(params, lat, t, c2, cfg)
    assert not np.allclose(e1.numpy(), e2.numpy(), atol=1e-5)
    e3 = tdit.forward(params, lat, torch.tensor([900]), c1, cfg)
    assert not np.allclose(e1.numpy(), e3.numpy(), atol=1e-5)


def test_ddim_sampler_runs_and_is_deterministic(f32):
    _, _, cfg, params = f32
    ctx = torch.randn((2, 4, cfg.ctx_dim), generator=torch.Generator()
                      .manual_seed(5))

    def sample(seed):
        gen = torch.Generator().manual_seed(seed)
        return tdit.ddim_sample(params, ctx, cfg, gen, steps=4, guidance=2.0)

    out1, out2 = sample(7), sample(7)
    assert out1.shape == (2, 8, 8, 4) and np.isfinite(out1.numpy()).all()
    np.testing.assert_array_equal(out1.numpy(), out2.numpy())
    assert not np.allclose(out1.numpy(), sample(8).numpy())  # other noise
    with pytest.raises(ValueError, match="noise shape"):
        tdit.ddim_sample(params, ctx, cfg, torch.zeros((1, 8, 8, 4)))


# The name is kept from when tp raised: this is now a parity test of
# the DiT over tp against JAX's sharded forward.
def test_sharding_specs_waits_for_a11(f32):
    """Tensor parallelism, JAX's ``test_sharded_forward_matches``: JAX's
    rules over its (dp=2, tp=4) mesh, the port's ``sharding_specs`` over
    four repeated CPU devices; the denoiser within 1e-5 of range at f32."""
    from gofr_tpu import parallel as jpar
    from gofr_tpu_torch import parallel as par

    jcfg, jparams, cfg, params = f32
    lat, ctx = _inputs(cfg, b=4, seed=5)
    t = np.array([10, 200, 500, 900], np.int32)
    jmesh = jpar.make_mesh(jpar.MeshConfig(dp=2, tp=4))
    jsharded = jpar.shard_params(
        jparams, jpar.specs_from_rules(jparams, jdit.SHARDING_RULES), jmesh)
    with jmesh:
        want = np.asarray(jax.jit(
            lambda p, x, tt, c: jdit.forward(p, x, tt, c, jcfg))(
            jsharded, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx)))
    placed = par.shard_params(
        params, tdit.DiT(cfg, params=params).sharding_specs(),
        par.make_mesh(par.MeshConfig(tp=4), devices=[torch.device("cpu")] * 4))
    assert isinstance(placed["layers"]["xq"], par.ShardedTensor)
    got = tdit.forward(placed, torch.from_numpy(lat), torch.from_numpy(t),
                       torch.from_numpy(ctx), cfg).numpy()
    scale = float(want.max() - want.min())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
