"""Pipeline parallelism over the ``pp`` mesh axis (GPipe) — counterpart of
``gofr_tpu/parallel/pipeline.py``.

Layers split into pp contiguous stages; each stage's parameters live on
its stage's device. Microbatches flow through the stage ring one hop a
tick (``ppermute``), with the classic bubble of (pp - 1) ticks at fill
and drain:

    tick:      0    1    2    3   ...
    stage 0:  mb0  mb1  mb2  mb3
    stage 1:   -   mb0  mb1  mb2
    stage 2:   -    -   mb0  mb1

Stage 0 injects microbatch t at tick t, the last stage banks its result
at tick t - (pp - 1), and the results are broadcast back (here: returned
on the first stage's device). JAX's compiled loop runs every stage at
every tick and zeroes what falls outside the schedule; the port runs
eagerly and skips those ticks' stage calls, which changes nothing in the
result.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..ml.tree import tree_leaves, tree_map
from . import ppermute

__all__ = ["pipeline_apply", "pipeline_layers", "stack_stages"]


def stack_stages(layer_params: Any, n_stages: int) -> Any:
    """Regroup a layer-stacked tree [L, ...] into [n_stages, L/pp, ...]."""

    def regroup(leaf):
        n = leaf.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers not divisible by {n_stages} stages")
        return leaf.reshape(n_stages, n // n_stages, *leaf.shape[1:])

    return tree_map(regroup, layer_params)


def pipeline_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor,
                   mesh, *, axis_name: str = "pp") -> torch.Tensor:
    """Run ``x`` through the staged network on the mesh's pp ring.

    ``stage_fn(params_one_stage, activation [B_m, ...]) -> activation``;
    ``stage_params``: a tree with a leading [pp, ...] stage axis;
    ``x``: [n_micro, B_m, ...] microbatches. Returns [n_micro, B_m, ...],
    the last stage's results, on ``x``'s device."""
    devs = mesh.axis_devices(axis_name)
    n_stages = len(devs)
    n_micro = x.shape[0]
    params = [tree_map(lambda a, s=s: a[s].to(devs[s]), stage_params)
              for s in range(n_stages)]
    carry = [torch.zeros_like(x[0], device=dev) for dev in devs]
    outs = torch.zeros_like(x, device=devs[-1])
    fwd_perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    for t in range(n_micro + n_stages - 1):
        out = []
        for s in range(n_stages):
            mb = t - s
            if not 0 <= mb < n_micro:
                out.append(torch.zeros_like(carry[s]))
                continue
            a_in = x[mb].to(devs[0]) if s == 0 else carry[s]
            a_out = stage_fn(params[s], a_in)
            if s == n_stages - 1:
                outs[mb] = a_out
            out.append(a_out)
        # every stage passes its activation one hop around the ring
        carry = ppermute(out, fwd_perm)
    return outs.to(x.device)


def pipeline_layers(layer_fn: Callable, layer_params: Any, x: torch.Tensor,
                    mesh, *, n_micro: int | None = None,
                    axis_name: str = "pp") -> torch.Tensor:
    """Run a layer-stacked [L, ...] tree as a pipeline: the layers split
    into ``mesh.shape[pp]`` stages (the layers of a stage in order inside
    it) and the batch into ``n_micro`` microbatches (default: pp)."""
    n_stages = mesh.shape[axis_name]
    n_micro = n_micro or n_stages
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible into {n_micro} microbatches")
    staged = stack_stages(layer_params, n_stages)
    xm = x.reshape(n_micro, b // n_micro, *x.shape[1:])

    def stage_fn(params_stage, a):
        n_layers = next(iter(tree_leaves(params_stage))).shape[0]
        for i in range(n_layers):
            a = layer_fn(tree_map(lambda p, i=i: p[i], params_stage), a)
        return a

    out = pipeline_apply(stage_fn, staged, xm, mesh, axis_name=axis_name)
    return out.reshape(b, *x.shape[1:])
