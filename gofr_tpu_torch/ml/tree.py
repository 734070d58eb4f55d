"""Nested containers of tensors ("trees"): the port's counterpart of the
``jax.tree`` functions its modules use. A tree is nested dicts, lists and
tuples; anything else is a leaf (a tensor, a number, None). A
``parallel.ShardedTensor`` (a weight split over a mesh) is a container of
its blocks, as a sharded ``jax.Array`` is one array of many shards: a
function maps over each block on its device, and the result keeps the
layout (the optimizer state of a block lives beside it, as optax's state
inherits the params' shardings)."""

from __future__ import annotations

from typing import Any, Callable, Iterator

from ..parallel import ShardedTensor

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and, leaf for leaf, of ``rest``
    (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if isinstance(tree, ShardedTensor):
        return ShardedTensor(
            [tree_map(fn, sh, *(r.shards[i] if isinstance(r, ShardedTensor)
                                else r for r in rest))
             for i, sh in enumerate(tree.shards)],
            tree.axis, tree.block, tree.mesh_axis)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> Iterator[Any]:
    """The leaves of ``tree``, in ``tree_map``'s order (a
    ``ShardedTensor``'s blocks in shard order)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    elif isinstance(tree, ShardedTensor):
        for v in tree.shards:
            yield from tree_leaves(v)
    else:
        yield tree
