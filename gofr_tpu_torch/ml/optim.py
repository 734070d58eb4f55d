"""Optimizers of the trainer: the port's copy of the three optax transforms
the JAX package's trainer and its tests use (``adamw``, ``adam``, ``sgd``)
and ``apply_updates``, with optax's ``init`` / ``update`` shape:

    opt = adamw(3e-4, mu_dtype=torch.float32)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

The arithmetic is optax 0.2.6's, op for op and dtype for dtype, not the
JAX trainer's docstring:

- ``mu`` is kept in ``mu_dtype`` (f32 in ``Trainer``) but ``nu`` is
  ``zeros_like(params)``, so it is bf16 for bf16 params;
- a Python constant takes the dtype of the tensor it meets (JAX's weak
  typing: ``0.1 * g`` multiplies by bf16(0.1) for a bf16 ``g``), and two
  tensors promote as in JAX (bf16 with f32 gives f32);
- the order is the moments, the bias correction (cast to each moment's
  dtype), ``m̂ / (sqrt(v̂ + eps_root) + eps)``, ``+ weight_decay · p``
  (adamw), ``· −lr``, then ``p + u`` cast back to p's dtype.

``torch.optim.AdamW`` is not a substitute: its weight decay defaults to
0.01 and scales the weights before the step.

Each leaf is finished before the next starts, so no stage of the update
exists for the whole tree at once, and the state passed in is updated in
place and returned: the counterpart of JAX's trainer donating its state
(``donate_argnums``). ``apply(grads, state, params)`` does ``update`` and
``apply_updates`` a leaf at a time with the same arithmetic, writing each
param as its update is made and dropping each gradient once used, so no
tree of (f32) updates exists at all: ``ml.train`` steps through it. Leaves
that are not floating-point tensors (or have a None gradient) are frozen:
their update is None. A weight split over a mesh (``parallel.
ShardedTensor``) is a leaf a block: its state lives beside each block, on
the block's device, and each block is updated as its own leaf.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..parallel import ShardedTensor
from .tree import tree_map

__all__ = ["GradientTransformation", "adamw", "adam", "sgd", "apply_updates"]


class GradientTransformation(NamedTuple):
    """optax's pair: ``init(params) -> state`` and ``update(grads, state,
    params) -> (updates, state)``; and ``apply(grads, state, params) ->
    state``, the update applied in place a leaf at a time (it consumes
    ``grads``: each leaf is set to None once used)."""

    init: Callable[[Any], Any]
    update: Callable[..., tuple]
    apply: Callable[..., Any]


def _trainable(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _c(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant in ``like``'s dtype, as a JAX weak-typed scalar
    meets an array (a CPU scalar: it joins CUDA tensors without a copy)."""
    return torch.tensor(value, dtype=like.dtype)


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b``, into ``a`` (an intermediate) when the result keeps its
    dtype."""
    return a.div_(b) if torch.result_type(a, b) == a.dtype else a / b


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.add_(b) if torch.result_type(a, b) == a.dtype else a + b


def _slots(tree):
    """(container, key) of every leaf, in ``tree_map``'s order: a
    ``ShardedTensor``'s blocks are leaves of its shard list."""
    if isinstance(tree, dict):
        box, items = tree, tree.items()
    else:
        box = tree.shards if isinstance(tree, ShardedTensor) else tree
        items = enumerate(box)
    for k, v in items:
        if isinstance(v, (dict, list, tuple, ShardedTensor)):
            yield from _slots(v)
        else:
            yield box, k


def _fused(leaf: Callable, grads, params, *states) -> None:
    """``p <- p + leaf(g, *state leaves, p)`` a leaf at a time, each
    gradient dropped from ``grads`` once used (tuples keep theirs)."""
    for (gc, gk), (pc, pk), *st in zip(_slots(grads), _slots(params),
                                        *map(_slots, states)):
        g = gc[gk]
        if not isinstance(gc, tuple):
            gc[gk] = None
        u = leaf(g, *(c[k] for c, k in st), pc[pk])
        del g
        if u is not None:
            with torch.no_grad():
                pc[pk].copy_(pc[pk] + u)


def _adam(learning_rate: float, b1: float, b2: float, eps: float,
          eps_root: float, mu_dtype: torch.dtype | None,
          weight_decay: float | None) -> GradientTransformation:
    """optax's ``scale_by_adam`` (+ ``add_decayed_weights`` when
    ``weight_decay`` is not None) + ``scale_by_learning_rate``, per leaf.
    State: ``{"count": int32 scalar, "mu": tree, "nu": tree}``."""

    def init(params):
        return {"count": torch.zeros((), dtype=torch.int32),
                "mu": tree_map(lambda p: torch.zeros_like(
                    p, dtype=mu_dtype or p.dtype) if _trainable(p) else None,
                    params),
                "nu": tree_map(lambda p: torch.zeros_like(p)
                               if _trainable(p) else None, params)}

    def step(state):
        """(the next count, the per-leaf update over that count)."""
        count = state["count"]
        # optax's safe_increment: the count stops at its dtype's maximum
        count = torch.where(count < torch.iinfo(count.dtype).max, count + 1,
                            count)
        steps = count.to(torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** steps
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** steps

        def leaf(g, m, v, p):
            if g is None or m is None:
                return None
            with torch.no_grad():
                # optax casts mu to mu_dtype only after m̂ is taken from it
                m_new = _c(1 - b1, g) * g + _c(b1, m) * m
                v.copy_(_c(1 - b2, g) * (g * g) + _c(b2, v) * v)
                den = v / bc2.to(v.dtype)
                den = den.add_(_c(eps_root, den)).sqrt_()
                den = den.add_(_c(eps, den))
                u = _div(m_new / bc1.to(m_new.dtype), den)
                m.copy_(m_new)
                del den, m_new
                if weight_decay is not None:
                    u = _add(u, _c(weight_decay, p) * p)
                return u.mul_(_c(-learning_rate, u))

        return count, leaf

    def update(grads, state, params=None):
        if weight_decay is not None and params is None:
            raise ValueError("adamw's weight decay needs the params")
        count, leaf = step(state)
        plist = params if params is not None else tree_map(lambda g: None,
                                                           grads)
        updates = tree_map(leaf, grads, state["mu"], state["nu"], plist)
        state["count"] = count
        return updates, state

    def apply(grads, state, params):
        count, leaf = step(state)
        _fused(leaf, grads, params, state["mu"], state["nu"])
        state["count"] = count
        return state

    return GradientTransformation(init, update, apply)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          mu_dtype: torch.dtype | None = None,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """optax.adamw: Adam with decoupled weight decay (default 1e-4, applied
    to the Adam step before the learning rate)."""
    return _adam(learning_rate, b1, b2, eps, eps_root, mu_dtype,
                 weight_decay)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0,
         mu_dtype: torch.dtype | None = None) -> GradientTransformation:
    """optax.adam."""
    return _adam(learning_rate, b1, b2, eps, eps_root, mu_dtype, None)


def sgd(learning_rate: float) -> GradientTransformation:
    """optax.sgd without momentum: ``u = -lr · g``. State: ``{}``."""

    def leaf(g, p=None):
        return None if g is None else _c(-learning_rate, g) * g

    def update(grads, state, params=None):
        return tree_map(leaf, grads), state

    def apply(grads, state, params):
        _fused(leaf, grads, params)
        return state

    return GradientTransformation(lambda params: {}, update, apply)


def apply_updates(params, updates):
    """``p + u`` cast back to p's dtype, written into each param in place
    (JAX's donated buffers); a None update leaves its param as it is.
    Returns ``params``."""

    def leaf(p, u):
        if u is not None:
            with torch.no_grad():
                p.copy_(p + u)
        return p

    return tree_map(leaf, params, updates)
