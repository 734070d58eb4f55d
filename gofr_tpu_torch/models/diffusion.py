"""Latent diffusion transformer (DiT) and its DDIM sampler — counterpart of
``gofr_tpu/models/diffusion.py``, BASELINE config #5's model family.

The JAX tree's layout and arithmetic: patchified latents -> DiT blocks
(self-attention, cross-attention over the text context, MLP), each
modulated adaLN-zero style by the timestep embedding (9 vectors a layer in
JAX's split order: shift, scale, gate for each branch), stacked layer
weights walked by a Python loop, bf16 matmuls with f32 norm statistics.
``ada_w`` and ``patch_out`` start at zero, as in JAX, so a fresh model
predicts eps = 0 whatever its trunk computes: a check of the trunk perturbs
them first.

``ddim_sample`` is the whole sampler (classifier-free guidance by batch
doubling, linear-beta DDPM schedule, eta = 0, x0 clipped to +-4), run by
the engine as one apply and, on a card, replayed as one CUDA graph per
batch shape. What differs from JAX:

- the initial noise: JAX draws it with ``jax.random.normal(key)`` inside
  the sampler, and threefry has no torch counterpart, so the port takes it
  as an argument (a tensor, or a ``torch.Generator`` on the device to draw
  it from); tests pass JAX's noise in;
- the timestep schedule is built on the host (``ddim_timesteps``) with
  ``jnp.linspace``'s own float32 arithmetic, so each step's ``t`` is JAX's
  exactly, and each step's scalar coefficients are f32 values computed on
  the host from the same ``alphas_bar`` table.

Tensor parallelism: ``sharding_specs`` returns JAX's rules
(``SHARDING_RULES``); params split by them over a mesh with tp > 1
(``parallel.shard_params``) carry their sharding. Each branch of a block
runs a shard at a time (unsplit params are one shard holding every weight
whole): the shard's heads of the column-parallel self- and cross-attention
projections, its ffn slice, its rows of the row-parallel outputs, and a
``psum`` before each gate. The modulation and the norms stay replicated.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import attention, gelu, layer_norm
from ..parallel import P, psum, shards_of, specs_from_rules
from . import normal, tensor_from_numpy

__all__ = ["DiTConfig", "DiT", "dit_xl", "tiny_dit", "init_params",
           "params_from_jax", "patchify", "unpatchify", "forward",
           "ddim_timesteps", "alphas_bar", "ddim_sample", "SHARDING_RULES"]

_LAYER_KEYS = ("wq", "wk", "wv", "wo", "xq", "xk", "xv", "xo", "w_in",
               "w_out", "ada_w", "ada_b")
N_TRAIN = 1000  # DDPM training timesteps


class DiTConfig:
    def __init__(
        self,
        latent_size: int = 32,     # latent grid (32 ~ 256 px)
        latent_channels: int = 4,
        patch: int = 2,
        dim: int = 1152,
        n_layers: int = 28,
        n_heads: int = 16,
        ffn_dim: int = 4608,
        ctx_dim: int = 768,        # text-encoder hidden size
        norm_eps: float = 1e-6,
        dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        self.latent_size = latent_size
        self.latent_channels = latent_channels
        self.patch = patch
        self.dim = dim
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.head_dim = dim // n_heads
        self.ffn_dim = ffn_dim
        self.ctx_dim = ctx_dim
        self.norm_eps = norm_eps
        self.dtype = dtype
        self.n_patches = (latent_size // patch) ** 2
        self.patch_dim = latent_channels * patch * patch


def dit_xl(**kw) -> DiTConfig:
    return DiTConfig(**kw)


def tiny_dit(**kw) -> DiTConfig:
    defaults = dict(latent_size=8, patch=2, dim=64, n_layers=2, n_heads=4,
                    ffn_dim=128, ctx_dim=32)
    defaults.update(kw)
    return DiTConfig(**defaults)


SHARDING_RULES = (
    (r"layers/(wq|wk|wv|xq|xk|xv|w_in)", P(None, None, "tp")),
    (r"layers/(wo|xo|w_out)", P(None, "tp", None)),
    (r"layers/", P(None)),
    (r".*", P()),
)


def _timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of diffusion time t in [0, 1000): [B] ->
    [B, dim], cos then sin."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def init_params(cfg: DiTConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random weights in ``cfg.dtype`` from ``generator`` (on ``device``);
    ``ada_w``, ``ada_b`` and ``patch_out`` zero, the final norm one and
    zero (f32): the JAX tree's layout."""
    from .. import resolve_device

    device = resolve_device(device)
    L, D, Fd, C = cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.ctx_dim

    def dense(*shape, fan_in):
        return normal(generator, shape, fan_in ** -0.5, cfg.dtype, device)

    def zeros(*shape, dtype=cfg.dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "patch_in": dense(cfg.patch_dim, D, fan_in=cfg.patch_dim),
        "pos_embed": dense(cfg.n_patches, D, fan_in=D),
        "t_mlp1": dense(D, D, fan_in=D),
        "t_mlp2": dense(D, D, fan_in=D),
        "ctx_proj": dense(C, D, fan_in=C),
        "layers": {
            "wq": dense(L, D, D, fan_in=D),
            "wk": dense(L, D, D, fan_in=D),
            "wv": dense(L, D, D, fan_in=D),
            "wo": dense(L, D, D, fan_in=D),
            "xq": dense(L, D, D, fan_in=D),
            "xk": dense(L, D, D, fan_in=D),
            "xv": dense(L, D, D, fan_in=D),
            "xo": dense(L, D, D, fan_in=D),
            "w_in": dense(L, D, Fd, fan_in=D),
            "w_out": dense(L, Fd, D, fan_in=Fd),
            "ada_w": zeros(L, D, 9 * D),
            "ada_b": zeros(L, 9 * D, dtype=torch.float32),
        },
        "final_norm_scale": torch.ones((D,), dtype=torch.float32,
                                       device=device),
        "final_norm_bias": zeros(D, dtype=torch.float32),
        "patch_out": zeros(D, cfg.patch_dim),
    }


def params_from_jax(tree: dict, device=None) -> dict:
    """The JAX tree as numpy arrays (``jax.tree.map(np.asarray,
    diffusion.init_params(cfg, key))``) -> the port's params on
    ``device``, bit for bit."""
    from .. import resolve_device

    device = resolve_device(device)
    top = ("patch_in", "pos_embed", "t_mlp1", "t_mlp2", "ctx_proj",
           "final_norm_scale", "final_norm_bias", "patch_out")
    return {**{k: tensor_from_numpy(tree[k], device) for k in top},
            "layers": {k: tensor_from_numpy(tree["layers"][k], device)
                       for k in _LAYER_KEYS}}


def patchify(x: torch.Tensor, cfg: DiTConfig) -> torch.Tensor:
    """[B, H, W, C] latents -> [B, n_patches, patch_dim]."""
    b, h, w, c = x.shape
    p = cfg.patch
    x = x.reshape(b, h // p, p, w // p, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p),
                                               p * p * c)


def unpatchify(x: torch.Tensor, cfg: DiTConfig) -> torch.Tensor:
    b = x.shape[0]
    p, c = cfg.patch, cfg.latent_channels
    g = cfg.latent_size // p
    x = x.reshape(b, g, g, p, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * p, g * p, c)


def _modulation_norm(h: torch.Tensor, eps: float) -> torch.Tensor:
    """Parameter-free LayerNorm in f32 (adaLN supplies shift and scale)."""
    hf = h.float()
    mean = hf.mean(dim=-1, keepdim=True)
    var = (hf - mean).square().mean(dim=-1, keepdim=True)
    return ((hf - mean) * torch.rsqrt(var + eps)).to(h.dtype)


def forward(params: dict, latents: torch.Tensor, t: torch.Tensor,
            context: torch.Tensor, cfg: DiTConfig) -> torch.Tensor:
    """Predict noise: latents [B, H, W, C], t [B], context [B, S, ctx_dim]
    -> eps [B, H, W, C] f32."""
    dt = cfg.dtype
    x = patchify(latents.to(dt), cfg) @ params["patch_in"]
    x = x + params["pos_embed"][None]

    temb = _timestep_embedding(t, cfg.dim).to(dt)
    temb = F.silu(temb @ params["t_mlp1"]) @ params["t_mlp2"]  # [B, D]
    ctx = context.to(dt) @ params["ctx_proj"]

    for i in range(cfg.n_layers):
        x = _block(params["layers"], i, x, temb, ctx, cfg)

    x = layer_norm(x, params["final_norm_scale"], params["final_norm_bias"],
                   cfg.norm_eps)
    eps = x @ params["patch_out"]
    return unpatchify(eps.float(), cfg)


def _attention(layers: dict, i: int, names: tuple, h, kv, hd: int):
    """One attention branch, a shard at a time (unsplit weights are one
    shard): each shard's heads of q (from ``h``) and k, v (from ``kv``)
    through its blocks of the three column-parallel projections, then its
    rows of the output projection; the partial outputs summed on ``h``'s
    device."""
    wq, wk, wv, wo = (shards_of(layers[n]) for n in names)
    b, s, sk = h.shape[0], h.shape[1], kv.shape[1]
    parts = []
    for q_w, k_w, v_w, o_w in zip(wq, wk, wv, wo, strict=True):
        dev = q_w.device
        hq, hkv = h.to(dev), kv.to(dev)
        o = attention((hq @ q_w[i]).reshape(b, s, -1, hd),
                      (hkv @ k_w[i]).reshape(b, sk, -1, hd),
                      (hkv @ v_w[i]).reshape(b, sk, -1, hd), causal=False)
        parts.append(o.reshape(b, s, -1) @ o_w[i])
    return psum(parts, to=h.device)


def _block(layers: dict, i: int, x, temb, ctx, cfg: DiTConfig):
    """DiT block ``i``, a shard at a time (module docstring): bidirectional
    self-attention over the patches, cross-attention over the text tokens,
    the mlp."""
    dt, hd = cfg.dtype, cfg.head_dim
    mod = F.silu(temb) @ layers["ada_w"][i] + layers["ada_b"][i].to(dt)
    (sa_shift, sa_scale, sa_gate, xa_shift, xa_scale, xa_gate,
     mlp_shift, mlp_scale, mlp_gate) = mod[:, None, :].chunk(9, dim=-1)
    h = _modulation_norm(x, cfg.norm_eps) * (1 + sa_scale) + sa_shift
    x = x + sa_gate * _attention(layers, i, ("wq", "wk", "wv", "wo"), h, h,
                                 hd)
    h = _modulation_norm(x, cfg.norm_eps) * (1 + xa_scale) + xa_shift
    x = x + xa_gate * _attention(layers, i, ("xq", "xk", "xv", "xo"), h,
                                 ctx, hd)
    h = _modulation_norm(x, cfg.norm_eps) * (1 + mlp_scale) + mlp_shift
    h = psum([gelu(h.to(w_in.device) @ w_in[i]) @ w_out[i]
              for w_in, w_out in zip(shards_of(layers["w_in"]),
                                     shards_of(layers["w_out"]),
                                     strict=True)],
             to=x.device)
    return x + mlp_gate * h


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` at float32 as compiled by XLA:
    JAX's formula ``start * (1 - i / div) + stop * i / div`` (the stop
    appended), with the division by the constant ``div`` compiled as a
    product with its f32 reciprocal. So the values are JAX's bit for bit;
    ``np.linspace``, ``torch.linspace`` and a true division round
    differently (steps 28 and 38 pick other timesteps)."""
    start32, stop32 = np.float32(start), np.float32(stop)
    if num == 1:
        return np.array([start32], np.float32)
    div = num - 1
    step = np.arange(div, dtype=np.float32) * (np.float32(1) / np.float32(div))
    out = start32 * (np.float32(1) - step) + stop32 * step
    return np.concatenate([out, [stop32]]).astype(np.float32)


def ddim_timesteps(steps: int) -> list[int]:
    """The sampler's descending timesteps, JAX's
    ``jnp.linspace(999, 0, steps).astype(int32)`` exactly."""
    return [int(v) for v in _linspace_f32(N_TRAIN - 1, 0, steps)
            .astype(np.int32)]


def alphas_bar() -> np.ndarray:
    """Cumulative products of 1 - beta over the linear-beta schedule
    (1e-4 .. 0.02 over 1000 steps), float32."""
    betas = _linspace_f32(1e-4, 0.02, N_TRAIN)
    return np.cumprod(np.float32(1) - betas, dtype=np.float32)


def ddim_sample(params: dict, context: torch.Tensor, cfg: DiTConfig,
                noise: torch.Tensor | torch.Generator, *, steps: int = 20,
                guidance: float = 5.0,
                uncond_context: torch.Tensor | None = None) -> torch.Tensor:
    """The DDIM sampler: [B, S, ctx] -> latents [B, H, W, C] f32, starting
    from ``noise`` (a [B, H, W, C] tensor, or a generator on the device to
    draw it from). Classifier-free guidance doubles the batch (cond +
    uncond, zeros unless given) so both passes share one matmul stream."""
    b = context.shape[0]
    shape = (b, cfg.latent_size, cfg.latent_size, cfg.latent_channels)
    if isinstance(noise, torch.Generator):
        x = torch.randn(shape, generator=noise, device=context.device,
                        dtype=torch.float32)
    else:
        if tuple(noise.shape) != shape:
            raise ValueError(f"noise shape {tuple(noise.shape)} != {shape}")
        x = noise.float()
    if uncond_context is None:
        uncond_context = torch.zeros_like(context)
    ctx2 = torch.cat([context, uncond_context], dim=0)

    ab = torch.from_numpy(alphas_bar())
    one = torch.tensor(1.0)
    ts = ddim_timesteps(steps)
    for i, t in enumerate(ts):
        a_t = ab[t]
        a_next = ab[ts[i + 1]] if i + 1 < steps else one
        # each step's f32 coefficients, as JAX computes them on device
        c_eps = torch.sqrt(one - a_t).item()
        c_inv = torch.rsqrt(a_t).item()
        c_x0 = torch.sqrt(a_next).item()
        c_dir = torch.sqrt(one - a_next).item()

        x2 = torch.cat([x, x], dim=0)
        t2 = torch.full((2 * b,), t, dtype=torch.int32, device=x.device)
        eps2 = forward(params, x2, t2, ctx2, cfg)
        eps_c, eps_u = eps2[:b], eps2[b:]
        eps = eps_u + guidance * (eps_c - eps_u)

        x0 = ((x - c_eps * eps) * c_inv).clamp(-4.0, 4.0)
        x = c_x0 * x0 + c_dir * eps
    return x


class DiT:
    """Engine-facing wrapper: ``apply`` is one denoiser call; the serving
    entry is ``ddim_sample`` (the example's apply). ``params`` (e.g. from
    ``params_from_jax``) replaces the seeded draw."""

    def __init__(self, cfg: DiTConfig | None = None, seed: int = 0, *,
                 device=None, params: dict | None = None) -> None:
        from .. import resolve_device

        self.cfg = cfg or dit_xl()
        if params is None:
            self.device = resolve_device(device)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(self.cfg, gen, self.device)
        else:
            self.device = params["patch_in"].device
        self.params = params

    def apply(self, params: Any, latents, t, context):
        return forward(params, latents, t, context, self.cfg)

    def sharding_specs(self):
        return specs_from_rules(self.params, SHARDING_RULES)
