"""Mixture-of-Experts layer — counterpart of ``gofr_tpu/models/moe.py``.

GShard-style capacity dispatch as dense products, the JAX package's
formulation:

- router: top-k softmax over the expert logits, in f32;
- dispatch: each (token, choice) claims a capacity slot in its expert by
  a cumulative-sum position, leftmost first and every token's first
  choice before any second one; a token past its expert's capacity is
  DROPPED (its residual path carries it);
- experts: stacked [E, ...] SwiGLU weights, one batched product a
  projection;
- combine: a weighted scatter back, zeros for dropped tokens, plus the
  Switch load-balancing loss.

Expert parallelism: ``parallel.shard_params`` with ``MOE_SHARDING_RULES``
over a mesh with ``ep`` > 1 splits the stacked experts over the ep devices
(E/ep experts a shard) and, with ``tp`` > 1, each expert's ffn over the tp
devices at that ep position, as Llama's MLP is split. ``moe_layer`` runs
each shard's experts on its device over its slice of ``expert_in`` (the
all_to_all boundary in JAX: here a copy to the shard), combines each
shard's outputs with its slice of the combine weights, and a ``psum``
adds the shards' partial results: the row-parallel ``w_down`` partials
and the ep shards' disjoint experts at once. Unsplit experts are one
shard. ``constrain`` checks ``expert_in``'s spec against an ambient mesh.
``init_moe_params`` draws with torch, not JAX's PRNG: to hold the port
against the JAX package, carry its tree across with ``params_from_jax``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import P, ShardedTensor, constrain, gather, psum
from . import normal, tree_from_numpy

__all__ = ["MoEConfig", "init_moe_params", "params_from_jax", "moe_layer",
           "MOE_SHARDING_RULES"]


class MoEConfig:
    def __init__(self, dim: int, ffn_dim: int, n_experts: int = 8,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        self.dim = dim
        self.ffn_dim = ffn_dim
        self.n_experts = n_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype


MOE_SHARDING_RULES = (
    (r"router", P(None, None)),
    (r"experts/(w_gate|w_up)", P("ep", None, "tp")),
    (r"experts/w_down", P("ep", "tp", None)),
)


def init_moe_params(cfg: MoEConfig, generator: torch.Generator,
                    device=None) -> dict:
    """Random weights with JAX's shapes and scales (router f32, experts in
    ``cfg.dtype``), drawn from ``generator`` on ``device``."""
    from .. import resolve_device

    device = resolve_device(device)
    E, D, Fd = cfg.n_experts, cfg.dim, cfg.ffn_dim
    return {
        "router": normal(generator, (D, E), D ** -0.5, torch.float32, device),
        "experts": {
            "w_gate": normal(generator, (E, D, Fd), D ** -0.5, cfg.dtype,
                             device),
            "w_up": normal(generator, (E, D, Fd), D ** -0.5, cfg.dtype,
                           device),
            "w_down": normal(generator, (E, Fd, D), Fd ** -0.5, cfg.dtype,
                             device),
        },
    }


def params_from_jax(tree: dict, device=None) -> dict:
    """JAX's MoE tree as numpy (``jax.tree.map(np.asarray,
    init_moe_params(cfg, key))``) -> the port's, bit for bit."""
    from .. import resolve_device

    return tree_from_numpy(
        {"router": tree["router"],
         "experts": {k: tree["experts"][k]
                     for k in ("w_gate", "w_up", "w_down")}},
        resolve_device(device))


def _dispatch_combine(probs: torch.Tensor, top_k: int, capacity: int):
    """probs [N, E] -> (dispatch [N, E, C] 0/1, combine [N, E, C] weights,
    aux loss). Slots go leftmost first, every k = 0 choice before any
    k = 1 (GShard priority)."""
    n, e = probs.shape
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)     # [N, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)              # renormalize
    onehot = F.one_hot(gate_idx, e).float()                    # [N, k, E]
    # priority order: all k=0 choices (token order), then all k=1 ...
    flat = onehot.transpose(0, 1).reshape(top_k * n, e)        # [kN, E]
    pos = torch.cumsum(flat, dim=0) - flat                     # slot index
    pos = (pos * flat).sum(-1)                                 # [kN]
    kept = (pos < capacity) & (flat.sum(-1) > 0)
    pos = pos.reshape(top_k, n).transpose(0, 1)                # [N, k]
    kept = kept.reshape(top_k, n).transpose(0, 1)              # [N, k]
    # JAX's one_hot of a slot past capacity is all zeros; ``kept`` zeroes
    # that seat below either way, so the clamp changes nothing
    slot_onehot = F.one_hot(torch.clamp(pos.long(), max=capacity - 1),
                            capacity).float()                  # [N, k, C]
    seat = onehot[..., None] * slot_onehot[:, :, None, :]      # [N,k,E,C]
    seat = seat * kept[:, :, None, None]
    dispatch = seat.sum(1)                                     # [N, E, C]
    combine = (seat * gate_vals[:, :, None, None]).sum(1)      # [N, E, C]
    # load-balancing auxiliary loss (Switch): E * sum(frac_tokens * frac_probs)
    me = probs.mean(0)                                         # [E]
    ce = onehot[:, 0, :].mean(0)                               # top-1 choice
    aux = (me * ce).sum() * e
    return dispatch, combine, aux


def moe_layer(params: dict, x: torch.Tensor, cfg: MoEConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], aux loss): the block's MLP replaced by
    the routed experts; add the aux loss (weighted ~1e-2) to the task loss
    when training."""
    b, s, d = x.shape
    n = b * s
    capacity = max(1, int(cfg.capacity_factor * n * cfg.top_k
                          / cfg.n_experts))
    xf = x.reshape(n, d)
    # a router split over fsdp is gathered whole where the tokens are
    logits = xf.float() @ gather(params["router"], xf.device)
    probs = torch.softmax(logits, dim=-1)
    dispatch, combine, aux = _dispatch_combine(probs, cfg.top_k, capacity)
    dt = cfg.dtype
    # [N, D] x [N, E, C] -> [E, C, D]: the all_to_all boundary when ep > 1
    expert_in = torch.einsum("nd,nec->ecd", xf.float(), dispatch).to(dt)
    expert_in = constrain(expert_in, P("ep", None, None))
    y = psum(_expert_shards(params["experts"], expert_in, combine),
             to=x.device)
    return y.reshape(b, s, d).to(x.dtype), aux


def _blocks_of(w, axis: int) -> list:
    """(block, its offset along ``axis``) of a weight split along that
    axis, or the weight whole at offset 0."""
    if isinstance(w, ShardedTensor) and w.axis == axis:
        return [(sh, i * w.block) for i, sh in enumerate(w.shards)]
    return [(w, 0)]


def _expert_shards(ex: dict, expert_in, combine) -> list:
    """Each shard's partial [N, D] f32 result: its experts (a block of the
    stacked axis) over their rows of ``expert_in``, through its ffn slice
    (a block of the tp split, whose ``w_down`` rows give a partial sum),
    combined with its experts' columns of ``combine``, on its device.
    Unsplit experts are one shard."""
    parts = []
    for (wg, e0), (wu, _), (wd, _) in zip(
            _blocks_of(ex["w_gate"], 0), _blocks_of(ex["w_up"], 0),
            _blocks_of(ex["w_down"], 0), strict=True):
        n_e = wg.shape[0]
        for (g_w, _), (u_w, _), (d_w, _) in zip(
                _blocks_of(wg, 2), _blocks_of(wu, 2), _blocks_of(wd, 1),
                strict=True):
            dev = g_w.device
            xin = expert_in[e0:e0 + n_e].to(dev)
            g = F.silu(torch.einsum("ecd,edf->ecf", xin, g_w))
            u = torch.einsum("ecd,edf->ecf", xin, u_w)
            out = torch.einsum("ecf,efd->ecd", g * u, d_w)
            parts.append(torch.einsum("ecd,nec->nd", out.float(),
                                      combine[:, e0:e0 + n_e].to(dev)))
    return parts
