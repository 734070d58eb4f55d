"""PyTorch port, training: ``llama.loss_fn`` and its gradients, remat, the
optimizers (``ml.optim``) and ``Trainer`` held against the JAX package
(``gofr_tpu.models.llama.loss_fn``, ``jax.grad``, optax 0.2.6,
``gofr_tpu.ml.train.Trainer``) on the same numpy-seeded inputs.

Tolerances, stated before the runs: at f32 the loss within 1e-5 relative
and each gradient leaf within 1e-4 absolute (the same arithmetic summed in
another order: XLA's dots against ATen's, over two layers of O(1)
activations); five ``Trainer`` steps' losses within 1e-4 relative.
Optimizer steps: f32 leaves within 1e-6 relative; bf16 leaves (params and
the bf16 ``nu``) within one bf16 ulp (2**-7 relative), since XLA may keep
an f32 intermediate where torch rounds each bf16 op. The MLP's loss runs
bf16 matmuls on both sides: 1e-2 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gofr_tpu.ml.train import Trainer as JTrainer
from gofr_tpu.models import llama as jllama
from gofr_tpu.models.mlp import MLP as JMLP
from gofr_tpu_torch.ml import optim
from gofr_tpu_torch.ml.train import Trainer, _value_and_grad, make_train_step
from gofr_tpu_torch.ml.tree import tree_leaves, tree_map
from gofr_tpu_torch.models import llama as tllama
from gofr_tpu_torch.models import mlp as tmlp

pytestmark = pytest.mark.timeout(300)

BF16_ULP = 2.0 ** -7


@pytest.fixture(scope="module")
def pair():
    jcfg = jllama.tiny_llama(use_flash=False, dtype=jnp.float32)
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams


def _batch(vocab: int, b: int = 2, s: int = 16, seed: int = 0):
    r = np.random.default_rng(seed)
    toks = r.integers(0, vocab, (b, s)).astype(np.int32)
    tgts = np.roll(toks, -1, axis=1).astype(np.int32)
    mask = (r.random((b, s)) > 0.25).astype(np.int32)
    mask[:, -1] = 0
    return toks, tgts, mask


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _jax_paths(tree):
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_paths(v, f"{prefix}['{k}']"))
        return out
    return {prefix: tree}


def test_loss_matches_jax(pair):
    jcfg, jparams, tcfg, tparams = pair
    toks, tgts, mask = _batch(jcfg.vocab_size)
    want = float(jllama.loss_fn(jparams, toks, tgts, mask, jcfg))
    got = float(tllama.loss_fn(tparams, toks, tgts, mask, tcfg))
    assert np.isfinite(got)
    assert got == pytest.approx(want, rel=1e-5)


def test_grads_match_jax(pair):
    jcfg, jparams, tcfg, tparams = pair
    toks, tgts, mask = _batch(jcfg.vocab_size, seed=1)
    jg = _jax_paths(jax.grad(jllama.loss_fn)(jparams, toks, tgts, mask,
                                             jcfg))
    loss, tg = _value_and_grad(
        lambda p, *b: tllama.loss_fn(p, *b, tcfg), tparams, toks, tgts, mask)
    tg = _port_paths(tg)
    assert set(tg) == set(jg)
    for path, want in jg.items():
        np.testing.assert_allclose(_np(tg[path]), np.asarray(want),
                                   atol=1e-4, rtol=0, err_msg=path)
    assert float(loss) == pytest.approx(
        float(jllama.loss_fn(jparams, toks, tgts, mask, jcfg)), rel=1e-5)


def test_remat_gives_the_same_grads(pair):
    _, _, tcfg, tparams = pair
    rcfg = tllama.tiny_llama(dtype=torch.float32, remat=True)
    toks, tgts, mask = _batch(tcfg.vocab_size, seed=2)
    grads = {}
    for name, cfg in (("plain", tcfg), ("remat", rcfg)):
        _, g = _value_and_grad(lambda p, *b, c=cfg: tllama.loss_fn(p, *b, c),
                               tparams, toks, tgts, mask)
        grads[name] = _port_paths(g)
    for path, want in grads["plain"].items():
        # the recomputed forward is the same arithmetic: equal values
        np.testing.assert_array_equal(_np(grads["remat"][path]), _np(want),
                                      err_msg=path)


def _opt_tree(seed: int):
    """A tree with f32 and bf16 leaves, as numpy f32 (bf16 leaves rounded)."""
    r = np.random.default_rng(seed)
    return {"w": r.standard_normal((4, 8)).astype(np.float32),
            "b": r.standard_normal((8,)).astype(np.float32),
            "n": {"e": r.standard_normal((3, 5)).astype(np.float32)}}


_BF16 = ("b", "e")


def _as_jax(tree):
    return {"w": jnp.asarray(tree["w"]),
            "b": jnp.asarray(tree["b"], jnp.bfloat16),
            "n": {"e": jnp.asarray(tree["n"]["e"], jnp.bfloat16)}}


def _as_port(tree):
    return {"w": torch.from_numpy(tree["w"].copy()),
            "b": torch.from_numpy(tree["b"].copy()).to(torch.bfloat16),
            "n": {"e": torch.from_numpy(tree["n"]["e"].copy()).to(
                torch.bfloat16)}}


def _assert_leaves_close(got: dict, want: dict, what: str):
    for path, w in want.items():
        g = _np(got[path])
        w = np.asarray(w, np.float32)
        if any(path.endswith(f"['{k}']") for k in _BF16):
            np.testing.assert_allclose(g, w, rtol=BF16_ULP, atol=1e-30,
                                       err_msg=f"{what} {path}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                       err_msg=f"{what} {path}")


@pytest.mark.parametrize("name", ["adamw", "adamw_bf16_mu", "adam", "sgd"])
def test_optimizer_steps_match_optax(name):
    jopt, topt = {
        "adamw": (optax.adamw(1e-2, mu_dtype=jnp.float32),
                  optim.adamw(1e-2, mu_dtype=torch.float32)),
        "adamw_bf16_mu": (optax.adamw(1e-2, mu_dtype=jnp.bfloat16,
                                      weight_decay=0.1),
                          optim.adamw(1e-2, mu_dtype=torch.bfloat16,
                                      weight_decay=0.1)),
        "adam": (optax.adam(1e-2), optim.adam(1e-2)),
        "sgd": (optax.sgd(0.1), optim.sgd(0.1)),
    }[name]
    p0 = _opt_tree(0)
    jp, tp = _as_jax(p0), _as_port(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = _opt_tree(10 + step)
        ju, js = jopt.update(_as_jax(g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update(_as_port(g), ts, tp)
        tp = optim.apply_updates(tp, tu)
        _assert_leaves_close(_port_paths(tp), _jax_paths(jp),
                             f"{name} step {step}")
    # params keep their dtypes; the state's moments have optax's dtypes
    for path, leaf in _port_paths(tp).items():
        want = torch.bfloat16 if path.endswith(("['b']", "['e']")) \
            else torch.float32
        assert leaf.dtype == want, path
    if name.startswith("adam"):
        jstate = js[0]
        for moment in ("mu", "nu"):
            jm = _jax_paths(getattr(jstate, moment))
            tm = _port_paths(ts[moment])
            assert {k: str(v.dtype) for k, v in jm.items()} == {
                k: str(v.dtype).replace("torch.", "")
                for k, v in tm.items()}, moment
            _assert_leaves_close(tm, jm, f"{name} {moment}")
        assert int(ts["count"]) == int(jstate.count) == 3
        # optax's nu follows the params' dtype: bf16 for the bf16 leaves
        assert ts["nu"]["b"].dtype == torch.bfloat16


def test_trainer_five_steps_match_jax(pair):
    jcfg, jparams, tcfg, tparams = pair
    batches = [_batch(jcfg.vocab_size, seed=10 + i) for i in range(5)]
    jt = JTrainer(lambda p, t, y, m: jllama.loss_fn(p, t, y, m, jcfg),
                  jax.tree.map(jnp.copy, jparams))
    tt = Trainer(lambda p, t, y, m: tllama.loss_fn(p, t, y, m, tcfg),
                 _clone(tparams))
    want = [jt.step(*b) for b in batches]
    got = [tt.step(*b) for b in batches]
    assert tt.step_count == jt.step_count == 5
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # the default optimizer: adamw with an f32 first moment
    assert tt.opt_state["mu"]["embed"].dtype == torch.float32


def test_make_train_step_updates_in_place(pair):
    """The step's params and state are those passed in, updated in place
    (JAX's donated buffers)."""
    _, _, tcfg, tparams = pair
    params = _clone(tparams)
    opt = optim.sgd(0.1)
    step = make_train_step(lambda p, *b: tllama.loss_fn(p, *b, tcfg), opt)
    state = opt.init(params)
    before = params["embed"].clone()
    ptr = params["embed"].data_ptr()
    out, state2, loss = step(params, state, *_batch(tcfg.vocab_size))
    assert state2 is state
    assert all(a is b for a, b in zip(tree_leaves(out), tree_leaves(params)))
    assert out["embed"].data_ptr() == ptr
    assert not torch.equal(params["embed"], before)
    assert loss.dim() == 0 and bool(torch.isfinite(loss))


def test_mlp_loss_matches_jax():
    jm = JMLP(sizes=(16, 32, 4), seed=0)
    tparams = tmlp.params_from_jax(jax.tree.map(np.asarray, jm.params),
                                   device="cpu")
    r = np.random.default_rng(0)
    x = r.standard_normal((8, 16)).astype(np.float32)
    y = r.integers(0, 4, 8).astype(np.int32)
    want = float(JMLP.loss(jm.params, x, y))
    got = float(tmlp.MLP.loss(tparams, torch.from_numpy(x),
                              torch.from_numpy(y)))
    assert got == pytest.approx(want, rel=1e-2)
    # and the trainer steps it
    t = Trainer(lambda p, a, b: tmlp.MLP.loss(p, a, b), _clone(tparams),
                optimizer=optim.sgd(0.1))
    losses = [t.step(torch.from_numpy(x), torch.from_numpy(y))
              for _ in range(5)]
    assert losses[-1] < losses[0]


def test_trainer_loss_decreases():
    """Twin of ``tests/test_llama.py::test_trainer_loss_decreases`` on the
    bf16 tiny model (the JAX test's mesh is A.11: it raises here)."""
    jcfg = jllama.tiny_llama(use_flash=False)
    tcfg = tllama.tiny_llama()
    params = tllama.params_from_jax(
        jax.tree.map(np.asarray, jllama.init_params(jcfg,
                                                    jax.random.PRNGKey(1))),
        device="cpu")
    loss = (lambda p, t, y, m: tllama.loss_fn(p, t, y, m, tcfg))
    with pytest.raises(NotImplementedError, match="A.11"):
        Trainer(loss, params, mesh=object())
    trainer = Trainer(loss, params, learning_rate=1e-2)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab_size, (8, 16)).astype(np.int32)
    tgts = np.roll(toks, -1, axis=1).astype(np.int32)
    mask = np.ones_like(toks)
    mask[:, -1] = 0
    losses = [trainer.step(toks, tgts, mask) for _ in range(5)]
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(params)
               if x.dim() == 3)


def test_flash_function_backward_is_the_plain_vjp(monkeypatch):
    """``ops._FlashDiff`` (the kernel forward, the plain backward) on the
    CPU with the plain version standing in for the kernel: outputs and
    q/k/v gradients equal autograd through the plain version, GQA, kv_len
    and q_offset included. On a card the forward is the CUDA kernel
    (``tests/test_torch_cuda.py``)."""
    from gofr_tpu_torch import ops
    from gofr_tpu_torch.ops.flash_attention import flash_attention_plain

    monkeypatch.setattr(ops, "flash_attention_cuda", flash_attention_plain)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 12, 4, 16, generator=g)
    k, v = (torch.randn(2, 20, 2, 16, generator=g) for _ in range(2))
    up = torch.randn(2, 12, 4, 16, generator=g)
    kv_len = torch.tensor([20, 13], dtype=torch.int32)
    grads = []
    for fn in (lambda *t: ops._FlashDiff.apply(*t, kv_len, True, 8),
               lambda *t: flash_attention_plain(*t, kv_len, causal=True,
                                                q_offset=8)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        out.backward(up)
        grads.append((out.detach(), [t.grad for t in leaves]))
    assert torch.equal(grads[0][0], grads[1][0])
    for a, b in zip(grads[0][1], grads[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_fused_apply_equals_update_then_apply(name):
    """``apply`` (update and apply a leaf at a time, what ``Trainer`` runs)
    gives the params and state of ``update`` + ``apply_updates`` bit for
    bit, and consumes the gradients."""
    make = {"adamw": lambda: optim.adamw(1e-2, mu_dtype=torch.float32),
            "adam": lambda: optim.adam(1e-2),
            "sgd": lambda: optim.sgd(0.1)}[name]
    a, b = make(), make()
    pa, pb = _as_port(_opt_tree(0)), _as_port(_opt_tree(0))
    sa, sb = a.init(pa), b.init(pb)
    for step in range(3):
        ga, gb = _as_port(_opt_tree(10 + step)), _as_port(_opt_tree(10 + step))
        ua, sa = a.update(ga, sa, pa)
        pa = optim.apply_updates(pa, ua)
        sb = b.apply(gb, sb, pb)
        assert all(g is None for g in tree_leaves(gb))
    for x, y in zip(tree_leaves((pa, sa)), tree_leaves((pb, sb))):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
