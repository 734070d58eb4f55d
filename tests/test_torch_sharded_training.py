"""Sharded training in the port (the training half of ROADMAP A.11) against
the JAX package on the CPU.

JAX trains over a mesh with GSPMD: ``shard_params`` with
``SHARDING_RULES_FSDP`` (ZeRO-3: layer weights over fsdp on their input
and tp on their output dimension), a batch placed on ``P("dp")``, one
jitted step whose gradient reductions XLA inserts
(``tests/test_llama.py::test_fsdp_training_matches_unsharded``,
``gofr_tpu.ml.train.Trainer``). The port places the same weights as
nested ``ShardedTensor`` blocks (tp outside, fsdp inside), runs each dp
group on its devices, gathers fsdp blocks a layer at a time and lets
autograd sum the groups' gradients. The port's meshes repeat the CPU
(``[cpu] * n``); JAX's run on the conftest's 8 virtual devices.

Held here, at ``tiny_llama`` with JAX's weights (``PRNGKey(0)``)
carried across at f32, tolerances stated before the runs:

- placement: every block equals the data of JAX's addressable shard at
  the same index, bf16, bit for bit;
- one sgd step at dp = 2, fsdp = 2, tp = 2 against ``jax.jit(step)`` on
  the same mesh: the loss within 1e-5 relative, every updated param leaf
  within 1e-5 of its range; three adamw ``Trainer`` steps against JAX's
  ``Trainer(mesh=, param_specs=, batch_spec=)``, the same tolerances;
- masks that differ across the dp groups: the loss is JAX's global
  masked mean (not the mean of the groups' means, which differs here);
- remat on and off equal; tp-only, dp-only and fsdp-only meshes equal
  the unsharded step;
- ``DataLoader(mesh=, spec=)`` blocks equal the dp shards of JAX's loader
  batch; a sharded save restores unsharded and onto another mesh bit for
  bit;
- two torch processes over gloo (``parallel.init_distributed``): the
  counterparts of ``tests/test_multihost.py``'s two-process collectives
  (576 both ways) and dp training step (both ranks the same loss, within
  1e-6 of JAX's MLP loss on the global batch);
- the backend choice of ``init_distributed``: gloo where ranks share a
  card or have none, NCCL where each has its own;
- speculation over tp = 2: greedy tokens equal JAX's spec Generator over
  a tp mesh, dense and paged.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gofr_tpu import parallel as jpar
from gofr_tpu.ml.data import DataLoader as JDataLoader
from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.ml.train import Trainer as JTrainer
from gofr_tpu.ml.train import make_train_step as jmake_train_step
from gofr_tpu.models import llama as jllama
from gofr_tpu.models.mlp import MLP as JMLP
from gofr_tpu.testutil import get_free_port
from gofr_tpu_torch import parallel as par
from gofr_tpu_torch.ml import optim
from gofr_tpu_torch.ml.checkpoint import Checkpointer
from gofr_tpu_torch.ml.data import DataLoader
from gofr_tpu_torch.ml.generate import Generator
from gofr_tpu_torch.ml.train import Trainer, value_and_grad
from gofr_tpu_torch.models import llama as tllama
from gofr_tpu_torch.models import mlp as tmlp
from gofr_tpu_torch.parallel import P

pytestmark = pytest.mark.timeout(300)

CPU = torch.device("cpu")
LOSS_REL = 1e-5
LEAF_TOL = 1e-5   # of the JAX leaf's range
MESH = {"dp": 2, "fsdp": 2, "tp": 2}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    jcfg = jllama.tiny_llama(use_flash=False, dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams


def _tparams(jparams):
    """A fresh port copy of JAX's params (training updates in place)."""
    return tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                  device="cpu")


def _tcfg(**kw):
    return tllama.tiny_llama(dtype=torch.float32, **kw)


def _mesh(**axes):
    cfg = par.MeshConfig(**axes)
    return par.make_mesh(cfg, devices=[CPU] * int(np.prod(cfg.sizes())))


def _batch(vocab, b=4, s=16, seed=0, uneven=False):
    r = np.random.default_rng(seed)
    toks = r.integers(0, vocab, (b, s)).astype(np.int32)
    tgts = np.roll(toks, -1, axis=1).astype(np.int32)
    mask = (r.random((b, s)) > 0.25).astype(np.int32)
    mask[:, -1] = 0
    if uneven:  # dp group 0 (rows 0-1) keeps 3 positions, group 1 all
        mask[: b // 2] = 0
        mask[0, :3] = 1
        mask[b // 2:] = 1
    return toks, tgts, mask


def _whole(x):
    return par.gather(x) if isinstance(x, par.ShardedTensor) else x


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def _assert_leaves_close(got, want):
    want = dict(_leaves(jax.tree.map(np.asarray, want)))
    for path, g in _leaves(got):
        w = want[path].astype(np.float32)
        scale = max(float(w.max() - w.min()), 1e-30)
        np.testing.assert_allclose(_whole(g).float().numpy(), w, rtol=0,
                                   atol=LEAF_TOL * scale, err_msg=path)


def _loss(cfg):
    return lambda p, t, y, m: tllama.loss_fn(p, t, y, m, cfg)


# ------------------------------------------------------------------ placement
def test_fsdp_placement_equals_jax_shards():
    """``shard_params`` with ``SHARDING_RULES_FSDP`` at dp = 2, fsdp = 2, tp
    = 2: tp outside, fsdp inside (``shards_of`` one entry a tp shard), and
    every innermost block equal to the data of JAX's addressable shard at
    its index, bf16, bit for bit; the set of indices equal JAX's."""
    jcfg = jllama.tiny_llama(use_flash=False)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = _tparams(jparams)
    jmesh = jpar.make_mesh(jpar.MeshConfig(**MESH))
    jplaced = jpar.shard_params(
        jparams, jpar.specs_from_rules(jparams, jllama.SHARDING_RULES_FSDP),
        jmesh)
    specs = par.specs_from_rules(tparams, tllama.SHARDING_RULES_FSDP)
    placed = par.shard_params(tparams, specs, _mesh(**MESH))
    wq = placed["layers"]["wq"]
    assert wq.mesh_axis == "tp" and len(par.shards_of(wq)) == 2
    assert all(s.mesh_axis == "fsdp" for s in par.shards_of(wq))
    assert par.shards_of(placed["embed"]) == [placed["embed"]]
    want = dict(_leaves(jplaced))
    for path, leaf in _leaves(placed):
        shards = {}
        for s in want[path].addressable_shards:
            idx = tuple((sl.start or 0, sl.stop or dim) for sl, dim in
                        zip(s.index, want[path].shape))
            shards[idx] = np.asarray(s.data.astype(jnp.float32))
        blocks = (leaf.leaf_blocks() if isinstance(leaf, par.ShardedTensor)
                  else [(tuple(slice(0, n) for n in leaf.shape), leaf)])
        got = {}
        for idx, b in blocks:
            got[tuple((sl.start, sl.stop) for sl in idx)] = \
                b.float().numpy()
        assert set(got) == set(shards), path
        for idx, b in got.items():
            np.testing.assert_array_equal(b, shards[idx], err_msg=path)


# ------------------------------------------------------------------- the step
def test_sgd_step_matches_jax_on_the_mesh(pair):
    """One f32 sgd step at dp = 2, fsdp = 2, tp = 2, JAX's ``jax.jit(step)``
    on its mesh against the port's ``Trainer``: the loss within 1e-5
    relative, every param leaf within 1e-5 of its range."""
    jcfg, jparams = pair
    batch = _batch(jcfg.vocab_size)
    opt = optax.sgd(0.5)
    step = jmake_train_step(
        lambda p, t, y, m: jllama.loss_fn(p, t, y, m, jcfg), opt)
    jmesh = jpar.make_mesh(jpar.MeshConfig(**MESH))
    jspecs = jpar.specs_from_rules(jparams, jllama.SHARDING_RULES_FSDP)
    jsharded = jpar.shard_params(jparams, jspecs, jmesh)
    with jmesh:
        jnew, _, jloss = jax.jit(step)(
            jsharded, opt.init(jsharded),
            *(jpar.shard_like(jnp.asarray(a), jpar.P("dp"), jmesh)
              for a in batch))
    tparams = _tparams(jparams)
    trainer = Trainer(_loss(_tcfg()), tparams, mesh=_mesh(**MESH),
                      param_specs=par.specs_from_rules(
                          tparams, tllama.SHARDING_RULES_FSDP),
                      optimizer=optim.sgd(0.5))
    loss = trainer.step(*batch)
    assert isinstance(trainer.params["layers"]["w_up"], par.ShardedTensor)
    assert loss == pytest.approx(float(jloss), rel=LOSS_REL)
    _assert_leaves_close(trainer.params, jnew)


@pytest.mark.parametrize("eps", [1e-8, 1e-3], ids=["eps1e-8", "eps1e-3"])
def test_adamw_trainer_matches_jax_trainer(pair, eps):
    """Three adamw ``Trainer`` steps (f32 ``mu``) at dp = 2, fsdp = 2, tp
    = 2 against JAX's ``Trainer(mesh=, param_specs=, batch_spec=)``: each
    loss within 1e-5 relative; the optimizer state of a block lives beside
    it (a ``ShardedTensor`` of the same layout). At optax's default eps
    (1e-8) Adam's step ``lr g / (|g| + eps)`` has slope lr / eps at g = 0:
    a gradient that nearly cancels turns the ~3e-7 rounding difference
    between XLA's and ATen's sums into up to lr on a few elements, in the
    unsharded trainers as much as in these (4 of the tiny embedding's
    65536 elements after three steps). At eps = 1e-3 the slope is 10 and
    every param leaf is held within 1e-5 of its range."""
    jcfg, jparams = pair
    jparams = jax.tree.map(jnp.array, jparams)  # JAX's trainer donates
    jmesh = jpar.make_mesh(jpar.MeshConfig(**MESH))
    jt = JTrainer(lambda p, t, y, m: jllama.loss_fn(p, t, y, m, jcfg),
                  jparams, mesh=jmesh,
                  param_specs=jpar.specs_from_rules(
                      jparams, jllama.SHARDING_RULES_FSDP),
                  batch_spec=jpar.P("dp"),
                  optimizer=optax.adamw(1e-2, eps=eps, mu_dtype=jnp.float32))
    tparams = _tparams(jparams)
    tt = Trainer(_loss(_tcfg()), tparams, mesh=_mesh(**MESH),
                 param_specs=par.specs_from_rules(
                     tparams, tllama.SHARDING_RULES_FSDP),
                 batch_spec=P("dp"),
                 optimizer=optim.adamw(1e-2, eps=eps,
                                       mu_dtype=torch.float32))
    mu = tt.opt_state["mu"]["layers"]["wq"]
    assert isinstance(mu, par.ShardedTensor) and mu.dtype == torch.float32
    assert [b.shape for _, b in mu.leaf_blocks()] == [
        b.shape for _, b in tt.params["layers"]["wq"].leaf_blocks()]
    for seed in range(3):
        batch = _batch(jcfg.vocab_size, seed=seed)
        assert tt.step(*batch) == pytest.approx(jt.step(*batch),
                                                rel=LOSS_REL)
    if eps >= 1e-3:
        _assert_leaves_close(tt.params, jt.params)


def test_uneven_masks_give_the_global_masked_mean(pair):
    """dp group 0 keeps 3 target positions and group 1 all 32: the loss is
    JAX's global masked mean over the whole batch (its sharded jit), and
    the mean of the two groups' means is not."""
    jcfg, jparams = pair
    toks, tgts, mask = _batch(jcfg.vocab_size, uneven=True)
    jmesh = jpar.make_mesh(jpar.MeshConfig(dp=2, fsdp=2, tp=2))
    jsharded = jpar.shard_params(
        jparams, jpar.specs_from_rules(jparams, jllama.SHARDING_RULES_FSDP),
        jmesh)
    with jmesh:
        want = float(jax.jit(
            lambda p, *b: jllama.loss_fn(p, *b, jcfg))(
                jsharded, *(jpar.shard_like(jnp.asarray(a), jpar.P("dp"),
                                            jmesh)
                            for a in (toks, tgts, mask))))
    tparams = _tparams(jparams)
    mesh = _mesh(**MESH)
    placed = par.shard_params(
        tparams, par.specs_from_rules(tparams, tllama.SHARDING_RULES_FSDP),
        mesh)
    with mesh:
        got, _ = value_and_grad(
            _loss(_tcfg()), placed,
            *(par.shard_like(a, P("dp"), mesh) for a in (toks, tgts, mask)))
    assert float(got) == pytest.approx(want, rel=LOSS_REL)
    halves = [float(jllama.loss_fn(jparams, toks[i:i + 2], tgts[i:i + 2],
                                   mask[i:i + 2], jcfg)) for i in (0, 2)]
    assert abs(np.mean(halves) - want) > 100 * LOSS_REL * abs(want)


@pytest.mark.parametrize("axes", [{"tp": 2}, {"dp": 2}, {"fsdp": 2},
                                  {"dp": 2, "tp": 2}, {"fsdp": 4}],
                         ids=["tp", "dp", "fsdp", "dp_tp", "fsdp4"])
def test_meshes_match_the_unsharded_step(pair, axes):
    """One sgd step over a tp-only, dp-only, fsdp-only (2 and 4) and a dp
    x tp mesh: the loss within 1e-5 relative of the unsharded step, the
    params after within 1e-5 of range."""
    jcfg, jparams = pair
    batch = _batch(jcfg.vocab_size, seed=3)
    ref = Trainer(_loss(_tcfg()), _tparams(jparams),
                  optimizer=optim.sgd(0.5))
    want = ref.step(*batch)
    tparams = _tparams(jparams)
    tt = Trainer(_loss(_tcfg()), tparams, mesh=_mesh(**axes),
                 param_specs=par.specs_from_rules(
                     tparams, tllama.SHARDING_RULES_FSDP),
                 optimizer=optim.sgd(0.5))
    assert tt.step(*batch) == pytest.approx(want, rel=LOSS_REL)
    _assert_leaves_close(tt.params, jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), ref.params))


def test_remat_on_and_off_are_equal(pair):
    """``cfg.remat`` recomputes each block (and re-gathers its fsdp
    blocks) in the backward pass: the loss and every gradient block equal
    the run that keeps them, at dp = 2, fsdp = 2, tp = 2."""
    _, jparams = pair
    tparams = _tparams(jparams)
    mesh = _mesh(**MESH)
    placed = par.shard_params(
        tparams, par.specs_from_rules(tparams, tllama.SHARDING_RULES_FSDP),
        mesh)
    batch = [par.shard_like(a, P("dp"), mesh)
             for a in _batch(_tcfg().vocab_size, seed=5)]
    with mesh:
        a_loss, a = value_and_grad(_loss(_tcfg(remat=False)), placed, *batch)
        b_loss, b = value_and_grad(_loss(_tcfg(remat=True)), placed, *batch)
    assert float(a_loss) == float(b_loss)
    for (p, x), (_, y) in zip(_leaves(a), _leaves(b), strict=True):
        torch.testing.assert_close(_whole(x), _whole(y), rtol=0, atol=1e-6,
                                   msg=p)


# ----------------------------------------------------------- data, checkpoint
def test_data_loader_blocks_equal_jax_dp_shards():
    """``DataLoader(mesh=, spec=P("dp"))``: each batch entry a
    ``ShardedTensor`` of dp row blocks on the groups' devices, equal to the
    dp shards of JAX's loader batch under ``NamedSharding(mesh, P("dp"))``
    (the same seeded shuffle)."""
    def source():
        for i in range(16):
            yield {"x": np.full((3,), i, np.float32), "y": np.int32(i)}

    jmesh = jpar.make_mesh(jpar.MeshConfig(dp=2, tp=4))
    jb = next(iter(JDataLoader(source, batch_size=8, shuffle_buffer=8,
                               seed=4, mesh=jmesh, spec=jpar.P("dp"))))
    mesh = _mesh(dp=2, tp=4)
    dl = DataLoader(source, batch_size=8, shuffle_buffer=8, seed=4,
                    mesh=mesh, spec=P("dp"))
    tb = next(iter(dl))
    assert dl.device == mesh.first
    for key in ("x", "y"):
        st = tb[key]
        assert isinstance(st, par.ShardedTensor) and st.n == 2
        want = {}
        for s in jb[key].addressable_shards:
            want[(s.index[0].start or 0)] = np.asarray(s.data)
        for g in range(2):
            np.testing.assert_array_equal(st.block_of(g).numpy(),
                                          want[4 * g])
    # sharding=(mesh, spec) is the same placement
    sb = next(iter(DataLoader(source, batch_size=8, shuffle_buffer=8,
                              seed=4, sharding=(mesh, P("dp")))))
    assert torch.equal(sb["y"].full(), tb["y"].full())


def test_sharded_checkpoint_restores_bit_for_bit(tmp_path, pair):
    """A save of fsdp x tp params writes each logical leaf (a block at a
    time); it restores unsharded, onto a tp = 4 mesh and onto the fsdp
    mesh again, every block bit for bit; an unsharded save restores onto
    the mesh the same."""
    _, jparams = pair
    tparams = _tparams(jparams)
    mesh = _mesh(**MESH)
    specs = par.specs_from_rules(tparams, tllama.SHARDING_RULES_FSDP)
    placed = par.shard_params(tparams, specs, mesh)
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, placed)
    ck.save(2, tparams, wait=False)
    whole = ck.restore(1, like=tparams, device="cpu")
    for (p, a), (_, b) in zip(_leaves(whole), _leaves(tparams), strict=True):
        assert torch.equal(a, b), p
    tp4 = ck.restore(1, mesh=_mesh(tp=4),
                     specs=tllama.sharding_specs(tparams))
    assert tp4["layers"]["wq"].n == 4
    for step in (1, 2):
        again = ck.restore(step, like=tparams, mesh=mesh, specs=specs)
        for (p, a), (_, b) in zip(_leaves(again), _leaves(placed),
                                  strict=True):
            if isinstance(b, par.ShardedTensor):
                for (ia, x), (ib, y) in zip(a.leaf_blocks(), b.leaf_blocks(),
                                            strict=True):
                    assert ia == ib and torch.equal(x, y), p
            else:
                assert torch.equal(a, b), p
    for (p, a), (_, b) in zip(_leaves(tp4), _leaves(tparams), strict=True):
        assert torch.equal(_whole(a), b), p
    with pytest.raises(ValueError, match="together"):
        ck.restore(1, mesh=mesh)
    ck.close()


# ------------------------------------------------------------- two processes
_DCN_WORKER = r"""
import sys
import numpy as np
import torch
from gofr_tpu_torch import parallel as par

rank, coord = int(sys.argv[1]), sys.argv[2]
par.init_distributed({"JAX_COORDINATOR_ADDRESS": coord,
                      "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(rank)})
import torch.distributed as dist
assert dist.get_backend() == "gloo" and dist.get_world_size() == 2
mesh = par.make_mesh(par.MeshConfig(dp=2, tp=4),
                     devices=[torch.device("cpu")] * 4, process_axis="dp")
assert mesh.shape["dp"] == 1 and mesh.n_processes == 2
row_vals = np.arange(1, 9, dtype=np.float32)
local = np.repeat(row_vals[rank * 4:(rank + 1) * 4, None], 16, axis=1)
arr = par.shard_like(local, par.P("dp", None), mesh)
total = par.process_sum([arr.sum()], mesh)[0]
summed = par.process_sum([arr.clone()], mesh)[0]
print(f"OK proc={rank} total={float(total)} psum_sum={float(summed.sum())}",
      flush=True)
# leave together: a rank exiting with the group up aborts in gloo's threads
dist.barrier()
dist.destroy_process_group()
"""

_TRAIN_WORKER = r"""
import sys
import numpy as np
import torch
from gofr_tpu_torch import parallel as par
from gofr_tpu_torch.ml import optim
from gofr_tpu_torch.ml.train import Trainer, value_and_grad
from gofr_tpu_torch.models.mlp import MLP

rank, coord, saved = int(sys.argv[1]), sys.argv[2], sys.argv[3]
par.init_distributed({"JAX_COORDINATOR_ADDRESS": coord,
                      "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(rank)})
params = torch.load(saved)
# dp = 8 over two processes: each splits its 8 rows over its 4 positions,
# JAX's P(("dp", "tp")) over dp = 2 processes x tp = 4
mesh = par.make_mesh(par.MeshConfig(dp=8), devices=[torch.device("cpu")] * 4,
                     process_axis="dp")

def loss_fn(p, x, y):
    out = MLP.apply(p, x)
    sq = [((o - t) ** 2).sum() for (_, o), (_, t) in
          zip(out.leaf_blocks(), y.leaf_blocks(), strict=True)]
    return par.dp_mean(sq, [t.numel() for _, t in y.leaf_blocks()])

rng = np.random.default_rng(rank)
x = rng.normal(size=(8, 16)).astype(np.float32)
y = rng.normal(size=(8, 4)).astype(np.float32)
with mesh:
    loss, grads = value_and_grad(loss_fn, params,
                                 *(par.shard_like(a, par.P("dp"), mesh)
                                   for a in (x, y)))
g0 = float(grads[0]["b"][0])
step = Trainer(loss_fn, params, mesh=mesh, optimizer=optim.sgd(0.1)).step(x, y)
print(f"OK proc={rank} loss={float(loss):.9g} g0={g0:.9g} step={step:.9g}",
      flush=True)
import torch.distributed as dist
dist.barrier()
dist.destroy_process_group()
"""


def _run_two(tmp_path, source, *args, timeout=120):
    worker = tmp_path / "worker.py"
    worker.write_text(source)
    coord = f"127.0.0.1:{get_free_port()}"
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(worker), str(i), coord,
                               *args], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=REPO) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs, strict=True)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-2000:]}"
        assert f"OK proc={i}" in out
    return [next(ln for ln in out.splitlines() if ln.startswith("OK proc"))
            for out in outs]


@pytest.mark.timeout(180)
def test_two_process_dcn_collectives(tmp_path):
    """Counterpart of ``tests/test_multihost.py::
    test_two_process_dcn_collectives``: two torch processes over gloo, a
    mesh whose dp axis spans them; the global sum and the psum over dp
    both fold both processes' rows: 576 (local rows alone: 160 or 416)."""
    for line in _run_two(tmp_path, _DCN_WORKER):
        assert "total=576.0" in line and "psum_sum=576.0" in line, line


@pytest.mark.timeout(180)
def test_two_process_dp_training_step(tmp_path):
    """Counterpart of ``test_two_process_dp_training_step``: JAX's MLP
    (16, 32, 4), seed 0, bf16, carried across; each rank its own 8 rows;
    ``value_and_grad`` over a process-spanning dp mesh gives both ranks the
    same loss and first gradient, within 1e-6 of JAX's loss on the
    global batch (computed here), and a ``Trainer`` step the same loss."""
    jm = JMLP(sizes=(16, 32, 4), seed=0)
    saved = tmp_path / "mlp.pt"
    torch.save(tmlp.params_from_jax(jax.tree.map(np.asarray, jm.params),
                                    device="cpu"), saved)
    lines = _run_two(tmp_path, _TRAIN_WORKER, str(saved))
    vals = [dict(kv.split("=") for kv in ln.split()[1:]) for ln in lines]
    assert vals[0]["loss"] == vals[1]["loss"]
    assert vals[0]["g0"] == vals[1]["g0"]
    assert vals[0]["step"] == vals[1]["step"] == vals[0]["loss"]
    xs, ys = [], []
    for pid in range(2):
        rng = np.random.default_rng(pid)
        xs.append(rng.normal(size=(8, 16)).astype(np.float32))
        ys.append(rng.normal(size=(8, 4)).astype(np.float32))
    want = float(jnp.mean((JMLP.apply(jm.params, np.concatenate(xs))
                           - np.concatenate(ys)) ** 2))
    assert float(vals[0]["loss"]) == pytest.approx(want, rel=1e-6)


def test_init_distributed_picks_the_backend():
    """NCCL refuses two ranks on one device: ``dist_backend`` picks gloo
    when the host's ranks outnumber its cards or it has none, NCCL when
    each rank has a card; ``init_distributed`` counts the ranks of a
    coordinator on this host as local (``LOCAL_WORLD_SIZE`` over it)."""
    assert par.dist_backend(2, n_cards=1) == "gloo"
    assert par.dist_backend(2, n_cards=0) == "gloo"
    assert par.dist_backend(1, n_cards=1) == "nccl"
    assert par.dist_backend(2, n_cards=2) == "nccl"
    assert par.dist_backend(4, n_cards=8) == "nccl"
    local = par._local_processes
    assert local({}, "127.0.0.1:1234", 4) == 4
    assert local({}, "localhost:1234", 2) == 2
    assert local({}, "10.0.0.7:1234", 16) == 1
    assert local({"LOCAL_WORLD_SIZE": "2"}, "10.0.0.7:1234", 16) == 2
    # on this host (no card) two local ranks get gloo
    assert par.dist_backend(local({}, "127.0.0.1:1", 2)) == "gloo"
    with pytest.raises(RuntimeError, match="torch.distributed"):
        par.make_mesh(par.MeshConfig(dp=2), devices=[CPU],
                      process_axis="dp")


# -------------------------------------------------------------- speculation
@pytest.mark.parametrize("page_size", [0, 8], ids=["dense", "paged"])
def test_speculation_over_tp_matches_jax(page_size):
    """Prompt-lookup speculation (K = 2) over params split tp = 2: greedy
    tokens equal JAX's spec Generator over ``SHARDING_RULES`` params on a
    tp mesh at f32 (``shard_cache=True``, its multi-host arm; JAX's paged
    generator takes no ``shard_cache``, so the paged reference is its
    single-device spec Generator), and the port's own tp = 1 spec
    Generator's; windows and emitted counts equal JAX's."""
    jcfg = jllama.tiny_llama(use_flash=False, dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    kw = dict(batch_slots=2, max_seq=64, prefill_buckets=(16,), chunk=4,
              spec_k=2, page_size=page_size)
    prompt = [5, 9, 2, 7, 1, 4, 5, 9, 2, 7, 1, 4]
    if page_size:
        jgen = JGenerator(jparams, jcfg, **kw)
    else:
        jmesh = jpar.make_mesh(jpar.MeshConfig(tp=2),
                               devices=jax.devices()[:2])
        jplaced = jpar.shard_params(
            jparams, jpar.specs_from_rules(jparams, jllama.SHARDING_RULES),
            jmesh)
        jgen = JGenerator(jplaced, jcfg, mesh=jmesh, shard_cache=True, **kw)
    want = jgen.generate(prompt, max_new_tokens=12)
    tparams = _tparams(jparams)
    one = Generator(tparams, _tcfg(), device="cpu", **kw)
    assert one.generate(prompt, max_new_tokens=12) == want
    split = par.shard_params(tparams, tllama.sharding_specs(tparams),
                             _mesh(tp=2))
    gen = Generator(split, _tcfg(), device="cpu", **kw)
    assert gen._tp and isinstance(gen.cache["k"], par.ShardedTensor)
    assert gen.generate(prompt, max_new_tokens=12) == want
    assert (gen.spec_windows, gen.spec_emitted) == (jgen.spec_windows,
                                                    jgen.spec_emitted)
    # the target's own split weights as the draft: its cache splits too
    selfd = Generator(split, _tcfg(), device="cpu", draft_params=split,
                      draft_cfg=_tcfg(), **kw)
    assert isinstance(selfd._draft_cache["k"], par.ShardedTensor)
    assert selfd.generate(prompt, max_new_tokens=12) == want
