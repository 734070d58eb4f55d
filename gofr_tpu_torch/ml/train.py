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
concern: ``LlamaConfig(remat=True)``.

Sharded training (``mesh``, ``param_specs``, ``batch_spec``) places the
params with ``parallel.shard_params`` and each batch with
``parallel.shard_like`` (default ``P("dp")``), and steps under ``with
mesh:``, as JAX's does. A split weight is a leaf a block
(``parallel.ShardedTensor``): each block is differentiated, and its
optimizer state lives on its device. The model computes each dp group
on its own devices and gathers fsdp blocks just in time
(``models.llama``); the dp gradient reduction is autograd's sum over the
groups' copies of each weight. Where the mesh's dp axis spans processes
(``make_mesh(..., process_axis="dp")``), each process's ``loss_fn``
returns its part of the global loss (``llama.loss_fn`` divides its
masked sum by the global mask count), and the step sums the gradients
and the loss over the group once (``parallel.process_sum``): the psum
GSPMD inserts across hosts.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..parallel import P, ShardedTensor, current_mesh, process_sum, \
    shard_like, shard_params
from .optim import _trainable, adamw
from .tree import tree_leaves, tree_map

__all__ = ["Trainer", "make_train_step", "value_and_grad",
           "reduce_over_processes"]


def _value_and_grad(loss_fn: Callable, params: Any, *batch) -> tuple:
    """(loss, grads) of this process: the gradient of every floating-point
    leaf (a leaf the loss does not reach gets zeros, as ``jax.grad``
    gives), None for the others."""
    live = tree_map(lambda p: p.detach().requires_grad_(True)
                    if _trainable(p) else p, params)
    with torch.enable_grad():
        loss = loss_fn(live, *batch)
    xs = [x for x in tree_leaves(live) if _trainable(x)]
    grads = iter(torch.autograd.grad(loss, xs, allow_unused=True,
                                     materialize_grads=True))
    return loss.detach(), tree_map(lambda x: next(grads) if _trainable(x)
                                   else None, live)


def reduce_over_processes(loss: torch.Tensor, grads: Any, mesh) -> None:
    """Sum ``loss`` and every gradient in place over the processes the
    mesh's dp axis spans (one all-reduce a dtype); nothing without such
    an axis."""
    process_sum([loss, *(g for g in tree_leaves(grads) if g is not None)],
                mesh, "dp")


def value_and_grad(loss_fn: Callable, params: Any, *batch) -> tuple:
    """(loss, grads) of the global batch: this process's, summed over the
    processes of the ambient mesh's dp axis when it spans any."""
    loss, grads = _value_and_grad(loss_fn, params, *batch)
    reduce_over_processes(loss, grads, current_mesh())
    return loss, grads


def make_train_step(loss_fn: Callable, optimizer) -> Callable:
    """Build ``step(params, opt_state, *batch) -> (params, opt_state,
    loss)`` with ``loss_fn(params, *batch) -> scalar``. The returned params
    and state are the ones passed in, updated in place."""

    def step(params, opt_state, *batch):
        loss, grads = value_and_grad(loss_fn, params, *batch)
        opt_state = optimizer.apply(grads, opt_state, params)
        return params, opt_state, loss

    return step


class Trainer:
    """Owns the params and optimizer state and steps them; with ``mesh``
    and ``param_specs`` the params are placed on the mesh and each batch
    by ``batch_spec`` (default ``P("dp")``); ``mesh`` alone leaves the
    params as they are."""

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
        self.mesh = mesh
        if batch_spec is None:
            batch_spec = P("dp")
        # mu_dtype=f32: bf16 params must not drag the first moment down to
        # bf16 (optax keeps nu in the params' dtype: ml.optim)
        self.optimizer = optimizer or adamw(learning_rate,
                                            mu_dtype=torch.float32)
        if mesh is not None and param_specs is not None:
            params = shard_params(params, param_specs, mesh)
        self.params = params
        self.opt_state = self.optimizer.init(params)
        self._batch_spec = batch_spec
        self._step_fn = make_train_step(loss_fn, self.optimizer)
        self.step_count = 0

    def _place(self, b):
        """A batch entry on the mesh: placed by ``batch_spec`` unless it
        is placed already (a ``DataLoader(mesh=, spec=)`` batch)."""
        if isinstance(b, ShardedTensor):
            return b
        return shard_like(b, self._batch_spec, self.mesh)

    def step(self, *batch) -> float:
        if self.mesh is None:
            self.params, self.opt_state, loss = self._step_fn(
                self.params, self.opt_state, *batch)
        else:
            batch = tuple(self._place(b) for b in batch)
            with self.mesh:
                self.params, self.opt_state, loss = self._step_fn(
                    self.params, self.opt_state, *batch)
        self.step_count += 1
        return float(loss)
