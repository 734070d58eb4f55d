"""Ring attention and the sequence-parallel decode combine — counterpart of
``gofr_tpu/parallel/ring.py``.

``ring_attention``: q/k/v [B, S, H, D] are split along the sequence into
one block a shard of the mesh's ``sp`` axis, each on its shard's device.
K/V blocks rotate around the ring (``ppermute``: shard i hands its block
to shard i+1), and after step j shard i holds block ``(i - j) % n``; an
f32 online softmax merges the blocks, so the result is exact. Causal and
``kv_len`` masks act on global positions; a fully masked row comes out 0.

``sp_decode_attention``: one query token a row against a KV cache whose
sequence axis is split over ``sp`` (stacked [L, ...] with a layer index,
or per layer; the int8 cache flat [.., S, KV*D] with seq-minor scales
[.., KV, S]). Each shard runs the grouped (no ``repeat_kv``) softmax over
its own keys, dequantizing only its own slice, and the shards combine
exactly with one ``pmax`` and two ``psum``s.

The math is JAX's, in plain torch on each shard's device; the collectives
are ``parallel``'s. The mesh's ``dp`` and ``tp`` axes are not used: a
shard computes its whole batch and every head (their blocks are
independent, so the result is the same). The caches arrive either as full
tensors (split here, as JAX's ``shard_map`` splits them) or already split
as ``ShardedTensor``s (the serving path's).
"""

from __future__ import annotations

import torch

from . import ShardedTensor, pmax, ppermute, psum, shard, unshard

__all__ = ["ring_attention", "sp_decode_attention", "combine_decode"]

_NEG = -1e30


def ring_attention(q, k, v, mesh, kv_len=None, *, causal: bool = True,
                   seq_axis: str = "sp") -> torch.Tensor:
    """Exact attention over [B, S, H, D] q/k/v (GQA expanded first, so
    q and k/v have the same heads) with the sequence split over the mesh's
    ``seq_axis``. ``kv_len`` [B] masks padded tails. Returns [B, S, H, D]
    in q's dtype on q's device."""
    devs = mesh.axis_devices(seq_axis)
    n = len(devs)
    b, s, h, d = q.shape
    if s % n:
        raise ValueError(f"sequence {s} does not divide over {seq_axis}={n}")
    t_loc = s // n
    scale = d ** -0.5
    qs = [x.float() * scale for x in shard(q, devs, 1)]
    kc, vc = shard(k, devs, 1), shard(v, devs, 1)
    lens = ([kv_len.to(dev) for dev in devs] if kv_len is not None
            else [None] * n)
    ar = [torch.arange(t_loc, device=dev) for dev in devs]
    acc = [torch.zeros((b, h, t_loc, d), dtype=torch.float32, device=dev)
           for dev in devs]
    m = [torch.full((b, h, t_loc, 1), _NEG, dtype=torch.float32, device=dev)
         for dev in devs]
    l_ = [torch.zeros((b, h, t_loc, 1), dtype=torch.float32, device=dev)
          for dev in devs]
    perm = [(j, (j + 1) % n) for j in range(n)]
    for j in range(n):
        for idx in range(n):
            src = (idx - j) % n  # the global block shard idx holds now
            logits = torch.einsum("bqhd,bkhd->bhqk", qs[idx],
                                  kc[idx].float())
            k_pos = src * t_loc + ar[idx]
            if causal:
                q_pos = idx * t_loc + ar[idx]
                mask = k_pos[None, :] <= q_pos[:, None]
                logits = torch.where(mask[None, None], logits, _NEG)
            if lens[idx] is not None:
                valid = k_pos[None, :] < lens[idx][:, None]
                logits = torch.where(valid[:, None, None, :], logits, _NEG)
            m_new = torch.maximum(m[idx], logits.amax(dim=-1, keepdim=True))
            p = torch.exp(logits - m_new)
            alpha = torch.exp(m[idx] - m_new)
            l_[idx] = alpha * l_[idx] + p.sum(dim=-1, keepdim=True)
            acc[idx] = acc[idx] * alpha + torch.einsum(
                "bhqk,bkhd->bhqd", p, vc[idx].float())
            m[idx] = m_new
            del logits, p
        kc, vc = ppermute(kc, perm), ppermute(vc, perm)
    out = [(a / torch.clamp(li, min=1e-30)).transpose(1, 2).to(q.dtype)
           for a, li in zip(acc, l_, strict=True)]
    return unshard(out, 1, q.device)


def combine_decode(q, parts, out_dtype) -> torch.Tensor:
    """The grouped online softmax of one query token a row over keys
    split across shards, combined exactly: per shard the logits of
    ``parts[i] = (k [B, S_i, KV, D], v, valid [B, S_i])`` on that shard's
    device, one ``pmax`` of the row maxima and two ``psum``s of the
    rescaled numerators and denominators. q [B, H, D]; returns
    [B, 1, H, D] in ``out_dtype`` on q's device."""
    b, h, d = q.shape
    kv = parts[0][0].shape[2]
    qg = q.reshape(b, kv, h // kv, d).float() * d ** -0.5
    logits, maxes = [], []
    for k, _, valid in parts:
        lg = torch.einsum("bgrd,bsgd->bgrs", qg.to(k.device), k.float())
        lg = torch.where(valid[:, None, None, :], lg, _NEG)
        logits.append(lg)
        maxes.append(lg.amax(dim=-1, keepdim=True))
    m_glob = pmax(maxes)
    ls, accs = [], []
    for lg, mg, (_, v, _) in zip(logits, m_glob, parts, strict=True):
        p = torch.exp(lg - mg)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bgrs,bsgd->bgrd", p, v.float()))
    l_glob, acc_glob = psum(ls)[0], psum(accs)[0]
    out = acc_glob / torch.clamp(l_glob, min=1e-30)
    return out.reshape(b, 1, h, d).to(out_dtype).to(q.device)


def sp_decode_attention(q, k_cache, v_cache, kv_len, mesh, *, layer=None,
                        seq_axis: str = "sp", k_scale=None, v_scale=None
                        ) -> torch.Tensor:
    """Decode attention of q [B, 1, H, D] over a cache whose sequence axis
    is split over ``seq_axis``: stacked [L, B, S, KV, D] with ``layer``,
    or per layer [B, S, KV, D]; int8 values flat [L?, B, S, KV*D] with
    ``k_scale``/``v_scale`` [L?, B, KV, S] (the sequence their last axis).
    Returns [B, 1, H, D] in q's dtype on q's device."""
    from ..ops import dequantize_kv

    quantized = k_scale is not None
    stacked = k_cache.dim() == (4 if quantized else 5)
    seq = 2 if stacked else 1
    devs = mesh.axis_devices(seq_axis)
    kc = ShardedTensor.of(k_cache, devs, seq)
    vc = ShardedTensor.of(v_cache, devs, seq)
    if quantized:
        ks = ShardedTensor.of(k_scale, devs, seq + 1)
        vs = ShardedTensor.of(v_scale, devs, seq + 1)
    lay = 0 if layer is None else int(layer)
    b = q.shape[0]
    parts = []
    for d, dev, kb in kc.blocks():
        vb = vc.block_of(d)
        if stacked:
            kb, vb = kb[lay], vb[lay]
        if quantized:
            ksb, vsb = ks.block_of(d), vs.block_of(d)
            if stacked:
                ksb, vsb = ksb[lay], vsb[lay]
            s_loc = kb.shape[1]
            kvh = ksb.shape[1]
            kb = dequantize_kv(kb.reshape(b, s_loc, kvh, -1),
                               ksb.transpose(1, 2), q.dtype)
            vb = dequantize_kv(vb.reshape(b, s_loc, kvh, -1),
                               vsb.transpose(1, 2), q.dtype)
        valid = kc.positions(d)[None, :] < kv_len.to(dev)[:, None]
        parts.append((kb, vb, valid))
    return combine_decode(q[:, 0], parts, q.dtype)
