"""The training step and ``Trainer`` — counterpart of
``gofr_tpu/ml/train.py``, the subsystem that lets the framework fine-tune
the models it serves.

Params are a tree of tensors on the device. A step runs ``loss_fn`` under
autograd over detached copies of the float leaves (they share the params'
storage), takes the gradients with ``torch.autograd.grad``, and runs the
optimizer (``ml.optim``: optax's shape and arithmetic) in place: the
counterpart of JAX's ``jit(..., donate_argnums=(0, 1))``, so no second
copy of the params or of the optimizer state exists. The optimizer
updates and applies a leaf at a time (``apply``), so no tree of updates
exists either. Activation recomputation is the model's
concern: ``LlamaConfig(remat=True)``. Sharded training (``mesh``,
``param_specs``, ``batch_spec``) is not ported yet (ROADMAP A.11).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .optim import _trainable, adamw
from .tree import tree_leaves, tree_map

__all__ = ["Trainer", "make_train_step"]


def _value_and_grad(loss_fn: Callable, params: Any, *batch) -> tuple:
    """(loss, grads): the gradient of every floating-point leaf (a leaf the
    loss does not reach gets zeros, as ``jax.grad`` gives), None for the
    others."""
    live = tree_map(lambda p: p.detach().requires_grad_(True)
                    if _trainable(p) else p, params)
    with torch.enable_grad():
        loss = loss_fn(live, *batch)
    xs = [x for x in tree_leaves(live) if _trainable(x)]
    grads = iter(torch.autograd.grad(loss, xs, allow_unused=True,
                                     materialize_grads=True))
    return loss.detach(), tree_map(lambda x: next(grads) if _trainable(x)
                                   else None, live)


def make_train_step(loss_fn: Callable, optimizer) -> Callable:
    """Build ``step(params, opt_state, *batch) -> (params, opt_state,
    loss)`` with ``loss_fn(params, *batch) -> scalar``. The returned params
    and state are the ones passed in, updated in place."""

    def step(params, opt_state, *batch):
        loss, grads = _value_and_grad(loss_fn, params, *batch)
        opt_state = optimizer.apply(grads, opt_state, params)
        return params, opt_state, loss

    return step


class Trainer:
    """Owns the params and optimizer state and steps them."""

    def __init__(
        self,
        loss_fn: Callable,
        params: Any,
        *,
        mesh: Any = None,
        param_specs: Any = None,
        batch_spec: Any = None,
        optimizer=None,
        learning_rate: float = 3e-4,
    ) -> None:
        if mesh is not None or param_specs is not None \
                or batch_spec is not None:
            raise NotImplementedError(
                "sharded training (mesh=, param_specs=, batch_spec=) is not "
                "ported yet (ROADMAP A.11)")
        # mu_dtype=f32: bf16 params must not drag the first moment down to
        # bf16 (optax keeps nu in the params' dtype: ml.optim)
        self.optimizer = optimizer or adamw(learning_rate,
                                            mu_dtype=torch.float32)
        self.params = params
        self.opt_state = self.optimizer.init(params)
        self._step_fn = make_train_step(loss_fn, self.optimizer)
        self.step_count = 0

    def step(self, *batch) -> float:
        self.params, self.opt_state, loss = self._step_fn(
            self.params, self.opt_state, *batch)
        self.step_count += 1
        return float(loss)
