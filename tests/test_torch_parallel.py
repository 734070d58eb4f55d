"""The port's mesh, sharding rules, collectives and ring attention, held
against the JAX package's ``parallel`` on the conftest's 8-device CPU mesh
(twins of ``tests/test_parallel.py``).

The port's mesh is a grid of ``torch.device`` and may name one device
several times: its tests run on ``[cpu] * n`` with JAX's ``n``. Inputs are
drawn with numpy from a seed and handed to both packages; outputs compare
at f32 within ``TOL`` (1e-5, JAX's own tolerance for ring attention).
``shard_params`` splits a leaf over a ``tp``, ``ep``, ``dp`` or ``fsdp``
axis of size > 1 into JAX's shard shapes (``test_shard_params_places_on_mesh``;
fsdp innermost, so ``shards_of`` stays one entry a tp shard);
``constrain`` checks a spec without placing anything. JAX's ``test_sharded_matmul_inserts_collectives`` /
``test_shard_like_batch_on_dp`` (GSPMD inserting collectives) have no
counterpart: the port's modules call ``psum`` / ``all_gather`` themselves
(``tests/test_torch_tensor_parallel.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu import parallel as jpar
from gofr_tpu_torch import parallel as par
from gofr_tpu_torch.parallel import P

pytestmark = pytest.mark.timeout(120)

CPU = torch.device("cpu")
TOL = dict(atol=1e-5, rtol=1e-5)


def _mesh(**axes):
    cfg = par.MeshConfig(**axes)
    return par.make_mesh(cfg, devices=[CPU] * int(np.prod(cfg.sizes())))


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n, kw", [(8, {}), (8, {"tp": 4}),
                                   (8, {"tp": 2, "sp": 2}),
                                   (8, {"tp": 2, "ep": 2, "pp": 2})])
def test_mesh_shape_inference(n, kw):
    got = par.mesh_shape_for(n, **kw).sizes()
    assert got == jpar.mesh_shape_for(n, **kw).sizes()


def test_mesh_shape_inference_rejects_uncovered():
    with pytest.raises(ValueError, match="does not cover"):
        par.mesh_shape_for(8, tp=3)


def test_make_mesh_axes():
    mesh = _mesh(dp=2, tp=4)
    jmesh = jpar.make_mesh(jpar.MeshConfig(dp=2, tp=4))
    assert mesh.axis_names == ("dp", "fsdp", "pp", "ep", "tp", "sp")
    assert mesh.axis_names == tuple(jmesh.axis_names)
    assert mesh.shape == dict(jmesh.shape)
    assert mesh.shape["dp"] == 2 and mesh.shape["tp"] == 4
    with pytest.raises(ValueError, match="devices"):
        par.make_mesh(par.MeshConfig(dp=2, tp=4), devices=[CPU] * 6)


def test_make_mesh_accepts_repeated_devices(monkeypatch):
    """The deliberate difference from JAX: one device may fill several
    positions (four shards on one card). Without a card, the default mesh
    raises and names the CPU spelling instead of quietly using the host."""
    mesh = par.make_mesh(par.MeshConfig(sp=4), devices=["cpu"] * 4)
    assert mesh.axis_devices("sp") == [CPU] * 4
    assert mesh.first == CPU and mesh.devices.shape[-1] == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert par.visible_devices() == []
    with pytest.raises(RuntimeError, match="devices="):
        par.make_mesh(par.MeshConfig(sp=2))


def test_specs_from_rules_first_match_wins_and_default_replicates():
    shapes = {"layers": {"wq": (2, 4, 8), "bias": (4,)}, "embed": (16, 4)}
    tparams = {"layers": {k: torch.zeros(s) for k, s in
                          shapes["layers"].items()},
               "embed": torch.zeros(shapes["embed"])}
    jparams = {"layers": {k: jnp.zeros(s) for k, s in
                          shapes["layers"].items()},
               "embed": jnp.zeros(shapes["embed"])}
    rules = ((r"layers/wq", (None, None, "tp")), (r"embed", ("tp", None)))
    specs = par.specs_from_rules(tparams, [(r, P(*s)) for r, s in rules])
    jspecs = jpar.specs_from_rules(jparams, [(r, jpar.P(*s))
                                             for r, s in rules])
    assert specs["layers"]["wq"] == P(None, None, "tp")
    assert specs["layers"]["bias"] == P()
    assert specs["embed"] == P("tp", None)
    for path in (("layers", "wq"), ("layers", "bias"), ("embed",)):
        got, want = specs, jspecs
        for k in path:
            got, want = got[k], want[k]
        assert tuple(got) == tuple(want)


def test_shard_params_replicates_or_raises():
    """Specs over size-1 axes place every leaf on the mesh's first device.
    A tp, dp, ep or fsdp axis of size > 1 splits the leaf into JAX's shard
    shapes on the same mesh (its ``device_put`` with a NamedSharding),
    block i on the i-th device of the axis; fsdp is the innermost split
    (a weight over fsdp and tp is one entry a tp shard for ``shards_of``,
    its fsdp blocks inside), every block equal to JAX's shard at its
    index; an axis that does not divide raises ValueError."""
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    params = {"w": torch.from_numpy(w)}
    placed = par.shard_params(params, {"w": P(None, "tp")}, _mesh(sp=2))
    assert torch.equal(placed["w"], params["w"])
    for axes, spec in (({"dp": 2, "tp": 4}, P(None, "tp")),
                       ({"dp": 2, "tp": 4}, P("dp", None)),
                       ({"ep": 4, "dp": 2}, P("ep", None)),
                       ({"dp": 2, "tp": 4}, P("dp", "tp")),
                       ({"fsdp": 2, "dp": 4}, P("fsdp", None)),
                       ({"dp": 2, "fsdp": 2, "tp": 2}, P("fsdp", "tp")),
                       ({"dp": 2, "fsdp": 2, "tp": 2}, P("tp", "fsdp"))):
        jmesh = jpar.make_mesh(jpar.MeshConfig(**axes))
        jplaced = jpar.shard_params({"w": jnp.asarray(w)},
                                    {"w": jpar.P(*spec)}, jmesh)["w"]
        want = {s.data.shape for s in jplaced.addressable_shards}
        got = par.shard_params(params, {"w": spec}, _mesh(**axes))["w"]
        assert isinstance(got, par.ShardedTensor)
        leaves = [got]
        while isinstance(leaves[0], par.ShardedTensor):
            leaves = [b for x in leaves for b in x.shards]
        assert {tuple(b.shape) for b in leaves} == want
        assert tuple(got.shape) == w.shape
        jdata = {tuple((sl.start or 0) for sl in s.index): np.asarray(s.data)
                 for s in jplaced.addressable_shards}
        for idx, b in got.leaf_blocks():
            np.testing.assert_array_equal(
                b.numpy(), jdata[tuple(sl.start for sl in idx)])
        if "tp" in spec and "fsdp" in spec:
            assert got.mesh_axis == "tp"
            assert len(par.shards_of(got)) == axes["tp"]
    got = par.shard_params(params, {"w": P(None, "tp")}, _mesh(tp=4))["w"]
    np.testing.assert_array_equal(got.full().numpy(), w)
    for i, blk in enumerate(got.shards):
        np.testing.assert_array_equal(blk.numpy(), w[:, 2 * i:2 * i + 2])
    fs = par.shard_params(params, {"w": P("fsdp", None)}, _mesh(fsdp=2))["w"]
    assert fs.mesh_axis == "fsdp" and par.shards_of(fs) == [fs]
    assert torch.equal(par.gather(fs), params["w"])
    with pytest.raises(ValueError, match="does not divide"):
        par.shard_params(params, {"w": P(None, "tp")}, _mesh(tp=3))


def test_constrain_noop_outside_mesh():
    x = torch.ones((4, 4))
    assert par.constrain(x, P("dp", None)) is x


def test_constrain_checks_against_the_ambient_mesh():
    """Inside a mesh a good spec returns its input; an unknown axis, a
    dimension the axes do not divide or a spec past the rank raises, as
    JAX's ``constrain`` promises."""
    mesh = _mesh(dp=2, tp=4)
    x = torch.ones((4, 8))
    with mesh:
        assert par.constrain(x, P("dp", "tp")) is x
        assert par.constrain(x, P(None, ("dp", "tp"))) is x
        with pytest.raises(ValueError, match="unknown mesh axis"):
            par.constrain(x, P("nope", None))
        with pytest.raises(ValueError, match="does not divide"):
            par.constrain(torch.ones((3, 8)), P("dp", None))
        with pytest.raises(ValueError, match="rank"):
            par.constrain(x, P(None, None, "tp"))
    assert par.constrain(torch.ones((3, 8)), P("dp", None)) is not None


def test_pad_to_multiple():
    for n, m in ((5, 8), (8, 8), (9, 8), (0, 4)):
        assert par.pad_to_multiple(n, m) == jpar.pad_to_multiple(n, m)


def test_init_distributed_single_process_is_a_noop():
    import torch.distributed as dist

    par.init_distributed(None)
    par.init_distributed({"JAX_COORDINATOR_ADDRESS": ""})
    assert not dist.is_initialized()


def test_collectives_match_jax_shard_map():
    """ppermute, psum, pmax, all_to_all and all_gather over four shards
    equal JAX's collectives inside ``shard_map`` over sp=4, bit for bit."""
    n = 4
    rng = np.random.default_rng(3)
    full = rng.normal(size=(n * 2, 8, 3)).astype(np.float32)
    jmesh = jpar.make_mesh(jpar.MeshConfig(sp=n),
                           devices=jax.devices()[:n])
    perm = [(i, (i + 1) % n) for i in range(n)]

    def body(x):
        return (jax.lax.ppermute(x, "sp", perm), jax.lax.psum(x, "sp"),
                jax.lax.pmax(x, "sp"),
                jax.lax.all_to_all(x, "sp", 1, 0, tiled=True),
                jax.lax.all_gather(x, "sp", axis=0, tiled=True))

    spec = jpar.P("sp")
    outs = jax.jit(jpar.shard_map(body, mesh=jmesh, in_specs=(spec,),
                                  out_specs=(spec,) * 5,
                                  check_vma=False))(jnp.asarray(full))
    want = [np.asarray(o).reshape(n, -1, *np.asarray(o).shape[1:])
            for o in outs]
    xs = par.shard(torch.from_numpy(full), [CPU] * n, 0)
    got = [par.ppermute(xs, perm), par.psum(xs), par.pmax(xs),
           par.all_to_all(xs, split_axis=1, concat_axis=0),
           par.all_gather(xs, axis=0)]
    for name, g, w in zip(("ppermute", "psum", "pmax", "all_to_all",
                           "all_gather"), got, want, strict=True):
        np.testing.assert_allclose(np.stack([t.numpy() for t in g]), w,
                                   rtol=0, atol=1e-6, err_msg=name)


def test_sharded_tensor_routes_indices():
    """A ``ShardedTensor``'s logical shape and its routed
    ``index_select`` / ``index_copy_`` equal the whole tensor's; a
    shard's trailing entries past its block are no part of it."""
    full = torch.arange(6 * 3, dtype=torch.float32).reshape(1, 6, 3)
    shards = [torch.cat([b, torch.full((1, 1, 3), -1.0)], dim=1)
              for b in full.chunk(2, dim=1)]
    st = par.ShardedTensor(shards, 1, block=3)
    assert st.shape == full.shape and st.numel() == full.numel()
    assert torch.equal(st.full(), full)
    idx = [5, 0, 3, 1]
    assert torch.equal(st.index_select(1, torch.tensor(idx)),
                       full.index_select(1, torch.tensor(idx)))
    src = -torch.ones((1, 2, 3))
    st.index_copy_(1, [4, 2], src)
    full.index_copy_(1, torch.tensor([4, 2]), src)
    assert torch.equal(st.full(), full)
    assert torch.equal(shards[1][:, 3], torch.full((1, 3), -1.0))


def _split(full, axis, n, dump=False):
    """``full`` and a ``ShardedTensor`` of it along ``axis`` over ``n``
    CPU shards (with ``dump``: each shard one zero entry past its
    block, as the striped pool keeps)."""
    blocks = full.clone().chunk(n, dim=axis)
    if dump:
        shape = list(blocks[0].shape)
        shape[axis] = 1
        blocks = [torch.cat([b, torch.zeros(shape)], dim=axis)
                  for b in blocks]
    return full.clone(), par.ShardedTensor(list(blocks), axis,
                                           full.shape[axis] // n)


def _row_write(arr):
    par.row_write(arr, 1, 0, 0, 3, torch.full((3, 3), 7.0), zero_to=7)


def _set_at_pos(arr):
    rows = torch.arange(2)
    par.set_at_pos(arr, 1, lambda p, dev: (rows.to(dev), p.long()),
                   torch.tensor([5, 6]), torch.full((2, 3), 7.0),
                   torch.tensor([True, False]))


def _pool_put(arr):
    par.pool_put(arr, 0, torch.tensor([1, 6, 3]), (torch.tensor([0, 1, 1]),),
                 torch.full((3, 3), 7.0))


CACHE_ACCESSES = {
    # name: (axis split, dump page, an in-place write or None, a read)
    "row_write": (2, False, _row_write, None),
    "row_read": (2, False, None, lambda a: par.row_read(a, 1, 1, 0)),
    "set_at_pos": (2, False, _set_at_pos, None),
    "pool_put": (1, True, _pool_put, None),
    "pool_take": (1, True, None,
                  lambda a: par.pool_take(a, 1, torch.tensor([5, 0, 6, 2]))),
}


@pytest.mark.parametrize("name", sorted(CACHE_ACCESSES))
def test_cache_accesses_take_plain_and_sharded_alike(name):
    """Each cache access takes a plain tensor or a ``ShardedTensor`` (a
    dense cache split over its sequence axis, a pool striped over its
    pages with a dump page a shard) and gives the same logical result:
    the owner arithmetic lives in ``parallel`` alone."""
    axis, dump, write, read = CACHE_ACCESSES[name]
    full = torch.randn((2, 8, 2, 3) if dump else (2, 2, 8, 3),
                       generator=torch.Generator().manual_seed(0))
    plain, st = _split(full, axis, 4, dump)
    if write is not None:
        write(plain)
        write(st)
        assert not torch.equal(plain, full)
    else:
        assert torch.equal(read(st), read(plain))
    assert torch.equal(st.full(), plain)
    assert [par.owner(st, g) for g in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert par.owner(plain, 7) == 0


class TestRingAttention:
    """Ring attention over sp is EXACT against single-device attention,
    and equals JAX's ring on the same inputs."""

    @pytest.mark.parametrize("causal", [True, False])
    def test_matches_reference(self, causal):
        from gofr_tpu.parallel.ring import ring_attention as jring
        from gofr_tpu_torch.ops import attention
        from gofr_tpu_torch.parallel.ring import ring_attention

        q, k, v = _qkv(0, (2, 64, 4, 16))
        jmesh = jpar.make_mesh(jpar.MeshConfig(dp=2, tp=2, sp=2))
        with jmesh:
            want = np.asarray(jax.jit(
                lambda q, k, v: jring(q, k, v, jmesh, causal=causal))(
                    q, k, v))
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        got = ring_attention(tq, tk, tv, _mesh(dp=2, tp=2, sp=2),
                             causal=causal)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(
            got.numpy(), attention(tq, tk, tv, causal=causal).numpy(), **TOL)

    def test_sp4_longer_ring(self):
        from gofr_tpu_torch.ops import attention
        from gofr_tpu_torch.parallel.ring import ring_attention

        q, k, v = (torch.from_numpy(a) for a in _qkv(1, (1, 128, 2, 8)))
        got = ring_attention(q, k, v, _mesh(tp=2, sp=4), causal=True)
        np.testing.assert_allclose(
            got.numpy(), attention(q, k, v, causal=True).numpy(), **TOL)

    def test_masked_rows_match_jax(self):
        """A row whose keys are all masked (``kv_len`` 0) gets what JAX's
        ring gives it, and a partly masked one its valid prefix: the same
        finite -1e30 mask and the same clamp of the denominator."""
        from gofr_tpu.parallel.ring import ring_attention as jring
        from gofr_tpu_torch.parallel.ring import ring_attention

        q, k, v = _qkv(2, (2, 16, 2, 8))
        lens = np.array([0, 9], np.int32)
        jmesh = jpar.make_mesh(jpar.MeshConfig(sp=4),
                               devices=jax.devices()[:4])
        with jmesh:
            want = np.asarray(jax.jit(
                lambda q, k, v, n: jring(q, k, v, jmesh, kv_len=n,
                                         causal=False))(q, k, v, lens))
        got = ring_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             _mesh(sp=4), causal=False,
                             kv_len=torch.from_numpy(lens))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
