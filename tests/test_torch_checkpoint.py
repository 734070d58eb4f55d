"""PyTorch port, checkpoints: twins of ``tests/test_checkpoint.py``. The
port's ``Checkpointer`` keeps the JAX one's surface in a format of its own
(a safetensors file of the leaves and a JSON skeleton a step): round trip
with dtypes, latest step and rotation, a missing checkpoint, a sharded
restore (each block read onto its device, JAX's shard shapes), a
``Trainer`` resumed from a
checkpoint at f32 (within the JAX test's 1e-6, and the losses within 1e-5
of JAX's ``Trainer`` with optax), and ``LLAMA_CKPT`` serving the saved
weights (a params tree, a training state, through w8). A directory the JAX
package wrote with orbax is refused with an error that says why.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gofr_tpu.ml.checkpoint import Checkpointer as JCheckpointer
from gofr_tpu.ml.train import Trainer as JTrainer
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch.ml import checkpoint as ckpt_mod
from gofr_tpu_torch.ml import optim
from gofr_tpu_torch.ml.checkpoint import Checkpointer
from gofr_tpu_torch.ml.train import Trainer
from gofr_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.timeout(180)


@pytest.fixture()
def tree():
    return {
        "w": torch.arange(32, dtype=torch.float32).reshape(4, 8),
        "nested": {"b": torch.ones((3,), dtype=torch.bfloat16),
                   "i": torch.tensor([7, -1], dtype=torch.int32)},
        "pair": (torch.zeros(2), [1.5, None]),
        "step": 3,
    }


def test_roundtrip(tmp_path, tree):
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    ckpt.save(1, tree)
    out = ckpt.restore(1, like=tree)
    np.testing.assert_array_equal(out["w"].numpy(), tree["w"].numpy())
    assert out["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(out["nested"]["i"], tree["nested"]["i"])
    assert isinstance(out["pair"], tuple) and out["pair"][1] == [1.5, None]
    assert out["step"] == 3
    # without ``like``: the saved dtypes, on the device asked for
    bare = ckpt.restore(1, device="cpu")
    assert bare["nested"]["b"].dtype == torch.bfloat16
    assert bare["nested"]["i"].dtype == torch.int32
    # ``like`` casts to the target's dtypes
    cast = ckpt.restore(1, like={**tree, "w": tree["w"].to(torch.bfloat16)})
    assert cast["w"].dtype == torch.bfloat16
    # a target of another structure or shape is refused before any load
    with pytest.raises(ValueError):
        ckpt.restore(1, like={"w": tree["w"]})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(1, like={**tree, "w": torch.zeros(2, 2)})
    ckpt.close()


def test_latest_and_rotation(tmp_path, tree):
    ckpt = Checkpointer(str(tmp_path / "ckpt"), max_to_keep=2)
    for step in (1, 2, 3):
        ckpt.save(step, tree)
    assert ckpt.latest_step() == 3
    assert ckpt.all_steps() == [2, 3]  # step 1 rotated out
    with pytest.raises(FileExistsError):
        ckpt.save(3, tree)
    # a background save lands once waited for
    ckpt.save(4, tree, wait=False)
    assert ckpt.latest_step() == 4
    assert ckpt.all_steps() == [3, 4]
    ckpt.close()


def test_restore_missing_raises(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        ckpt.restore()
    ckpt.close()


def test_sharded_restore(tmp_path, tree):
    """Twin of ``tests/test_checkpoint.py::test_sharded_restore``: leaves
    restore straight onto the mesh with the requested specs (each block
    read from the file onto its device), ``w`` in JAX's shard shapes on the
    same mesh, values bit for bit; leaves the specs leave out replicate on
    the mesh's first device; a save of the placed tree restores unsharded
    bit for bit."""
    from gofr_tpu import parallel as jpar
    from gofr_tpu_torch import parallel as par

    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    ckpt.save(5, tree)
    mesh = par.make_mesh(par.MeshConfig(dp=2, tp=4),
                         devices=[torch.device("cpu")] * 8)
    specs = {"w": par.P(None, "tp"), "nested": {"b": par.P()}}
    out = ckpt.restore(like=tree, mesh=mesh, specs=specs)
    jmesh = jpar.make_mesh(jpar.MeshConfig(dp=2, tp=4))
    jw = jax.device_put(jnp.asarray(tree["w"].numpy()),
                        jax.sharding.NamedSharding(jmesh, jpar.P(None, "tp")))
    assert isinstance(out["w"], par.ShardedTensor)
    assert {tuple(b.shape) for _, b in out["w"].leaf_blocks()} == \
        {s.data.shape for s in jw.addressable_shards} == {(4, 2)}
    np.testing.assert_array_equal(out["w"].full().numpy(),
                                  tree["w"].numpy())
    assert torch.equal(out["nested"]["b"], tree["nested"]["b"])
    assert torch.equal(out["nested"]["i"], tree["nested"]["i"])
    assert out["step"] == 3 and out["pair"][1] == [1.5, None]
    ckpt.save(6, out)
    back = ckpt.restore(6, like=tree, device="cpu")
    assert torch.equal(back["w"], tree["w"])
    ckpt.close()


def test_interrupted_save_leaves_no_step(tmp_path, tree, monkeypatch):
    """A save that dies mid-write leaves the previous step the latest and
    no partial directory behind."""
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    ckpt.save(1, tree)

    def boom(path, tensors):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise OSError("disk gone")

    monkeypatch.setattr(ckpt_mod, "write_safetensors", boom)
    with pytest.raises(OSError, match="disk gone"):
        ckpt.save(2, tree)
    assert ckpt.latest_step() == 1
    assert sorted(os.listdir(ckpt.directory)) == ["1"]
    ckpt.close()


def test_orbax_directory_is_refused(tmp_path):
    """A JAX checkpoint (orbax) cannot be read without orbax and
    tensorstore: the port says so instead of failing later."""
    jc = JCheckpointer(str(tmp_path / "orbax"))
    jc.save(1, {"w": jnp.ones((2, 2))})
    jc.close()
    with pytest.raises(ValueError, match="orbax and tensorstore"):
        Checkpointer(str(tmp_path / "orbax"))


def test_trainer_resume(tmp_path):
    """Save mid-training, restore, and continue exactly (f32, the CPU)."""

    def loss_fn(params, x, y):
        pred = x @ params["w"]
        return ((pred - y) ** 2).mean()

    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 4)).astype(np.float32)
    y = rng.normal(size=(8, 2)).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)

    t1 = Trainer(loss_fn, {"w": torch.ones((4, 2))},
                 optimizer=optim.adam(1e-2))
    losses = [t1.step(tx, ty) for _ in range(3)]
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    ckpt.save(3, {"params": t1.params, "opt": t1.opt_state,
                  "step": t1.step_count})
    loss_after_4 = t1.step(tx, ty)

    like = {"params": t1.params, "opt": t1.opt_state, "step": 0}
    state = ckpt.restore(3, like=like)
    assert state["step"] == 3 and state["opt"]["count"].dtype == torch.int32
    t2 = Trainer(loss_fn, state["params"], optimizer=optim.adam(1e-2))
    t2.opt_state = state["opt"]
    resumed_loss = t2.step(tx, ty)
    assert resumed_loss == pytest.approx(loss_after_4, rel=1e-6)
    ckpt.close()

    # the same four steps through JAX's Trainer and optax
    jt = JTrainer(lambda p, a, b: jnp.mean((a @ p["w"] - b) ** 2),
                  {"w": jnp.ones((4, 2), jnp.float32)},
                  optimizer=optax.adam(1e-2))
    want = [jt.step(x, y) for _ in range(4)]
    np.testing.assert_allclose(losses + [loss_after_4], want, rtol=1e-5)


def test_serving_boots_from_checkpoint(tmp_path, monkeypatch):
    """LLAMA_CKPT on the shared boot path: the port serves the SAVED
    weights, not a fresh init, through w8 quantization and from a training
    state ({"params": ...}, whose params entry alone is read)."""
    cfg = tllama.tiny_llama(dtype=torch.float32)
    trained = tllama.params_from_jax(jax.tree.map(
        np.asarray, jllama.init_params(
            jllama.tiny_llama(use_flash=False, dtype=jnp.float32),
            jax.random.PRNGKey(123))), device="cpu")

    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(7, trained)
    ckpt.close()
    monkeypatch.setenv("LLAMA_CKPT", str(tmp_path / "ck"))
    got = tllama.params_from_config(cfg, device="cpu")
    assert torch.equal(got["embed"], trained["embed"])
    assert torch.equal(got["layers"]["wq"], trained["layers"]["wq"])

    opt = optim.adamw(1e-3, mu_dtype=torch.float32)
    ckpt2 = Checkpointer(str(tmp_path / "ck2"))
    ckpt2.save(1, {"params": trained, "opt": opt.init(trained), "step": 1})
    ckpt2.close()
    monkeypatch.setenv("LLAMA_CKPT", str(tmp_path / "ck2"))
    got2 = tllama.params_from_config(cfg, device="cpu")
    assert torch.equal(got2["lm_head"], trained["lm_head"])
    # cast to the config's dtype on the way in
    bf = tllama.params_from_config(tllama.tiny_llama(), device="cpu")
    assert bf["lm_head"].dtype == torch.bfloat16
    assert torch.equal(bf["lm_head"], trained["lm_head"].to(torch.bfloat16))

    # w8 quantizes the RESTORED weights, not a fresh init
    cfg_w8 = tllama.tiny_llama(dtype=torch.float32, w8=True)
    q = tllama.params_from_config(cfg_w8, device="cpu")
    want_q, want_s = tllama.quantize_weight(trained["lm_head"])
    assert torch.equal(q["lm_head"]["q"], want_q)
    assert torch.equal(q["lm_head"]["s"], want_s)


@pytest.mark.parametrize("state", [False, True], ids=["params", "state"])
def test_checkpoint_of_another_shape_names_the_shapes(tmp_path, monkeypatch,
                                                      state):
    """A checkpoint saved for one config and served under another (a wrong
    LLAMA_PRESET) raises with the saved and the target shapes, whether it
    holds a bare params tree or a training state."""
    small = tllama.tiny_llama(dtype=torch.float32)
    params = tllama.init_params(small, torch.Generator().manual_seed(0),
                                device="cpu")
    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(1, {"params": params, "step": 1} if state else params)
    ckpt.close()
    monkeypatch.setenv("LLAMA_CKPT", str(tmp_path / "ck"))
    wider = tllama.tiny_llama(dtype=torch.float32, dim=small.dim * 2)
    with pytest.raises(ValueError, match="saved shape"):
        tllama.params_from_config(wider, device="cpu")
