"""Ulysses sequence parallelism — counterpart of ``gofr_tpu/parallel/ulysses.py``.

Where the ring rotates K/V blocks and keeps attention local, Ulysses
reshards: one ``all_to_all`` a tensor swaps the sequence split over
``sp`` for a head split, each shard computes exact attention over the
FULL sequence for H/sp of the heads, and one more ``all_to_all`` swaps
back. It needs the heads to divide over ``sp``.

JAX attends each shard with the plain ``ops.attention``. The port hands
the same function to ``ops.flash_attention``: on a card the hand-written
flash kernel (causal, per-row ``kv_len``, K/V with as many heads as q),
on the CPU its plain version, which is ``attention``.
"""

from __future__ import annotations

import torch

from . import all_to_all, shard, unshard

__all__ = ["ulysses_attention"]


def ulysses_attention(q, k, v, mesh, kv_len=None, *, causal: bool = True,
                      seq_axis: str = "sp", head_axis: str = "tp"
                      ) -> torch.Tensor:
    """Exact attention over [B, S, H, D] q/k/v (GQA expanded) with the
    sequence split over ``seq_axis``; ``kv_len`` [B] masks padded tails
    (positions are global after the reshard). The heads a ``head_axis``
    shard would hold (H / its size, as JAX counts them) must divide over
    ``seq_axis``. Returns [B, S, H, D] on q's device."""
    from ..ops import flash_attention

    devs = mesh.axis_devices(seq_axis)
    n = len(devs)
    local_heads = q.shape[2] // mesh.shape.get(head_axis, 1)
    if local_heads % n:
        raise ValueError(
            f"{seq_axis}={n} must divide the local (per-tp-shard) head "
            f"count {local_heads}")
    # sequence-split -> head-split: split heads across the axis, gather seq
    qh, kh, vh = (all_to_all(shard(x, devs, 1), split_axis=2, concat_axis=1)
                  for x in (q, k, v))
    o = [flash_attention(qh[i].contiguous(), kh[i].contiguous(),
                         vh[i].contiguous(), causal=causal,
                         kv_len=None if kv_len is None
                         else kv_len.to(devs[i]))
         for i in range(n)]
    # head-split -> sequence-split
    return unshard(all_to_all(o, split_axis=1, concat_axis=2), 1, q.device)
