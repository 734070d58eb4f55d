"""Llama-3-family decoder in PyTorch — counterpart of ``gofr_tpu/models/llama.py``.

Layouts are the JAX package's, so the two hold the same parameters and the
tests compare like with like:

- every layer weight is STACKED on a leading [n_layers] axis, and a matmul
  is ``x @ W`` with W stored [in, out];
- activations are [batch, seq, dim]; attention tensors are BSHD;
- the KV cache is a padded [L, B, S_max, KV, D] pair plus a per-row ``len``.

What differs from JAX, and why:

- PyTorch runs eagerly, so the layer ``scan`` is a Python loop over the
  stacked weights, and the cache is updated IN PLACE (one [B, KV, D] write
  per layer per decode step) instead of donated and re-bound;
- an out-of-range cache write is dropped by JAX's ``.at[].set`` but is a
  device-side fault in torch, so ``decode_step`` masks the writes of rows
  already at capacity explicitly (their ``len`` stays capped at S_max);
- attention goes through the two dispatchers of ``ops``: the hand-written
  CUDA kernels for a CUDA tensor, their plain versions for a CPU tensor.
  The device decides, so the JAX config's ``use_flash`` has no
  counterpart.

Only the dense bf16/f32 serving path is ported in this slice: int8 weights,
quantized KV caches, paged caches and sequence-parallel attention raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import (apply_rope, cached_decode_attention, flash_attention,
                   rms_norm, rope_table)

__all__ = ["LlamaConfig", "llama3_8b", "tiny_llama", "config_from_env",
           "init_params", "params_from_jax", "forward", "init_cache",
           "prefill", "prefill_into", "prefill_into_many", "decode_step"]

_LAYER_KEYS = ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate",
               "w_up", "w_down")


class LlamaConfig:
    def __init__(
        self,
        vocab_size: int = 128_256,
        dim: int = 4096,
        n_layers: int = 32,
        n_heads: int = 32,
        n_kv_heads: int = 8,
        ffn_dim: int = 14_336,
        max_seq_len: int = 8192,
        rope_theta: float = 500_000.0,
        norm_eps: float = 1e-5,
        dtype: torch.dtype = torch.bfloat16,
        attn_impl: str = "auto",
        kv_quant: bool = False,
        kv_bits: int | None = None,
        w8: bool = False,
        rope_scaling: dict | None = None,
    ) -> None:
        if attn_impl != "auto":
            raise NotImplementedError(
                f"attn_impl={attn_impl!r}: sequence-parallel attention is not "
                "ported yet (ROADMAP A.11)")
        if kv_quant or (kv_bits is not None and int(kv_bits) != 16):
            raise NotImplementedError(
                "quantized KV caches (kv_quant / kv_bits < 16) are not ported "
                "yet (ROADMAP A.5 and B.3, the int8 decode kernel)")
        if w8:
            raise NotImplementedError(
                "int8 weights (w8) are not ported yet (ROADMAP A.5)")
        if dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"dtype must be bfloat16 or float32, got {dtype}")
        self.vocab_size = vocab_size
        self.dim = dim
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads
        self.head_dim = dim // n_heads
        self.ffn_dim = ffn_dim
        self.max_seq_len = max_seq_len
        self.rope_theta = rope_theta
        self.rope_scaling = rope_scaling
        self.norm_eps = norm_eps
        self.dtype = dtype

    @property
    def n_rep(self) -> int:
        return self.n_heads // self.n_kv_heads


def llama3_8b(**kw) -> LlamaConfig:
    """Meta-Llama-3-8B's published shape (the ``LlamaConfig`` defaults)."""
    return LlamaConfig(**kw)


def tiny_llama(**kw) -> LlamaConfig:
    """Test-scale config: same topology, toy widths."""
    defaults = dict(
        vocab_size=512, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
        ffn_dim=256, max_seq_len=128, rope_theta=10_000.0,
    )
    defaults.update(kw)
    return LlamaConfig(**defaults)


def config_from_env(tiny_vocab_size: int | None = None) -> LlamaConfig:
    """``LLAMA_PRESET=tiny|1b|8b`` and ``LLAMA_DTYPE=bf16|f32``, as in the
    JAX package. ``LLAMA_KV_QUANT=1`` and ``LLAMA_W8=1`` raise
    ``NotImplementedError`` through ``LlamaConfig``."""
    preset = os.environ.get("LLAMA_PRESET", "tiny")
    kw: dict = {"kv_quant": os.environ.get("LLAMA_KV_QUANT") == "1",
                "w8": os.environ.get("LLAMA_W8") == "1"}
    raw_dtype = os.environ.get("LLAMA_DTYPE", "").strip().lower()
    if raw_dtype:
        names = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                 "f32": torch.float32, "float32": torch.float32}
        if raw_dtype not in names:
            raise ValueError(f"LLAMA_DTYPE must be one of {sorted(names)}, "
                             f"got {raw_dtype!r}")
        kw["dtype"] = names[raw_dtype]
    if preset == "tiny":
        if tiny_vocab_size is not None:
            kw["vocab_size"] = tiny_vocab_size
        return tiny_llama(**kw)
    if preset == "1b":
        return LlamaConfig(vocab_size=32_128, dim=2048, n_layers=16,
                           n_heads=16, n_kv_heads=8, ffn_dim=8192,
                           max_seq_len=2048, **kw)
    if preset == "8b":
        return llama3_8b(**kw)
    raise ValueError(f"unknown LLAMA_PRESET {preset!r}")


# -- parameters -----------------------------------------------------------------

def _param_shapes(cfg: LlamaConfig) -> dict:
    """(stacked shape, fan_in) of every layer matmul weight."""
    L, D, H, KV, hd, F = (cfg.n_layers, cfg.dim, cfg.n_heads,
                          cfg.n_kv_heads, cfg.head_dim, cfg.ffn_dim)
    return {
        "wq": ((L, D, H * hd), D), "wk": ((L, D, KV * hd), D),
        "wv": ((L, D, KV * hd), D), "wo": ((L, H * hd, D), H * hd),
        "w_gate": ((L, D, F), D), "w_up": ((L, D, F), D),
        "w_down": ((L, F, D), F),
    }


def _fill_normal(dst: torch.Tensor, fan_in: int, gen: torch.Generator,
                 rows: int = 8192) -> None:
    """dst <- N(0, 1) * fan_in**-0.5, drawn in f32 a block of leading rows at
    a time, so the f32 draw never exceeds ``rows`` rows of ``dst``."""
    for r0 in range(0, dst.shape[0], rows):
        blk = dst[r0:r0 + rows]
        draw = torch.randn(blk.shape, generator=gen, device=dst.device,
                           dtype=torch.float32)
        blk.copy_(draw.mul_(fan_in ** -0.5))


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random weights in ``cfg.dtype`` (norms f32, all ones), the JAX tree's
    layout. Draws one layer of one weight at a time on ``device`` from
    ``generator`` (which must live on that device), so no f32 copy of the
    whole model ever exists. The draws are not JAX's: to hold the port
    against the JAX package, carry its tree across with ``params_from_jax``."""
    from .. import resolve_device

    device = resolve_device(device)
    L, D = cfg.n_layers, cfg.dim
    layers = {"attn_norm": torch.ones((L, D), dtype=torch.float32, device=device),
              "mlp_norm": torch.ones((L, D), dtype=torch.float32, device=device)}
    for name, (shape, fan_in) in _param_shapes(cfg).items():
        w = torch.empty(shape, dtype=cfg.dtype, device=device)
        for layer in range(L):
            _fill_normal(w[layer], fan_in, generator)
        layers[name] = w
    embed = torch.empty((cfg.vocab_size, D), dtype=cfg.dtype, device=device)
    _fill_normal(embed, D, generator)
    lm_head = torch.empty((D, cfg.vocab_size), dtype=cfg.dtype, device=device)
    _fill_normal(lm_head, D, generator, rows=512)
    return {"embed": embed, "layers": layers,
            "final_norm": torch.ones((D,), dtype=torch.float32, device=device),
            "lm_head": lm_head}


def _tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy -> torch, bit for bit. bfloat16 (``ml_dtypes``, the dtype JAX
    hands to numpy) goes through its raw 16-bit pattern."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_jax(tree: dict, device=None) -> dict:
    """The JAX parameter tree as numpy arrays (``jax.tree.map(np.asarray,
    llama.init_params(cfg, key))``) -> the port's parameters on ``device``,
    bit-exact: bf16 stays bf16, the f32 norms stay f32."""
    from .. import resolve_device

    device = resolve_device(device)
    if isinstance(tree["lm_head"], dict) or any(
            isinstance(tree["layers"][k], dict) for k in _LAYER_KEYS):
        raise NotImplementedError(
            "int8 weights (w8) are not ported yet (ROADMAP A.5)")
    return {
        "embed": _tensor_from_numpy(tree["embed"], device),
        "layers": {k: _tensor_from_numpy(tree["layers"][k], device)
                   for k in _LAYER_KEYS},
        "final_norm": _tensor_from_numpy(tree["final_norm"], device),
        "lm_head": _tensor_from_numpy(tree["lm_head"], device),
    }


# -- the model ------------------------------------------------------------------

def _swiglu(x, lp):
    g = torch.nn.functional.silu(x @ lp["w_gate"])
    return (g * (x @ lp["w_up"])) @ lp["w_down"]


def _layer_params(params: dict, layer: int) -> dict:
    return {k: v[layer] for k, v in params["layers"].items()}


def _layer(cfg: LlamaConfig, x, lp, cos, sin, *, kv_len=None):
    """One full-sequence decoder block (prefill). Returns (x, k, v) with k
    and v GROUPED [B, S, KV, D]: the flash dispatcher takes them as they are
    (its plain version expands them with ``repeat_kv`` itself)."""
    b, s, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = apply_rope((h @ lp["wq"]).reshape(b, s, H, hd), cos, sin)
    k = apply_rope((h @ lp["wk"]).reshape(b, s, KV, hd), cos, sin)
    v = (h @ lp["wv"]).reshape(b, s, KV, hd)
    o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=True, kv_len=kv_len)
    x = x + o.reshape(b, s, H * hd) @ lp["wo"]
    x = x + _swiglu(rms_norm(x, lp["mlp_norm"], cfg.norm_eps), lp)
    return x, k, v


def _embed(params, tokens, cfg):
    return params["embed"][tokens.long()].to(cfg.dtype)


def _tokens(tokens, cfg: LlamaConfig, device) -> torch.Tensor:
    """Host token ids -> int32 on ``device``. An id outside the vocabulary
    is clamped by JAX's gather but is a device-side fault in torch: it is
    refused here, before the upload."""
    ids = np.asarray(tokens)
    if ids.size and (ids.min() < 0 or ids.max() >= cfg.vocab_size):
        raise ValueError(f"token ids must lie in [0, {cfg.vocab_size})")
    return _int32(ids, device)


def _int32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.int32).to(device)


@torch.no_grad()
def forward(params: dict, tokens, cfg: LlamaConfig, *, seq_lens=None
            ) -> torch.Tensor:
    """Full-sequence forward: tokens [B, S] -> f32 logits [B, S, V].
    ``seq_lens`` [B] masks padded tail positions out of attention."""
    dev = params["embed"].device
    tokens = _tokens(tokens, cfg, dev)
    kv_len = None if seq_lens is None else _int32(seq_lens, dev)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=dev)[None, :]
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta,
                          scaling=cfg.rope_scaling)
    for layer in range(cfg.n_layers):
        x, _, _ = _layer(cfg, x, _layer_params(params, layer), cos, sin,
                         kv_len=kv_len)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float()


# -- KV-cache serving path ------------------------------------------------------

def init_cache(cfg: LlamaConfig, batch: int, max_seq: int | None = None,
               device=None) -> dict:
    """Dense fp cache: k/v [L, B, S_max, KV, D] in ``cfg.dtype``, ``len`` [B]
    int32, all zeros."""
    from .. import resolve_device

    device = resolve_device(device)
    S = max_seq or cfg.max_seq_len
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _prefill_layers(params, tokens, seq_lens, cfg, write):
    """Run the prompt wave [B, S_pad] through every layer, handing each
    layer's (layer, k, v) to ``write``; returns last-valid-token logits
    [B, V] in f32 (``x[rows, seq_lens - 1]``, as the JAX code gathers)."""
    b, s = tokens.shape
    dev = tokens.device
    x = _embed(params, tokens, cfg)
    cos, sin = rope_table(torch.arange(s, device=dev)[None, :], cfg.head_dim,
                          cfg.rope_theta, scaling=cfg.rope_scaling)
    for layer in range(cfg.n_layers):
        x, k, v = _layer(cfg, x, _layer_params(params, layer), cos, sin,
                         kv_len=seq_lens)
        write(layer, k, v)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = x[torch.arange(b, device=dev), seq_lens.long() - 1]
    return (last @ params["lm_head"]).float()


@torch.no_grad()
def prefill(params: dict, tokens, seq_lens, cfg: LlamaConfig, cache: dict
            ) -> tuple[torch.Tensor, dict]:
    """Run the prompt [B, S_pad] through the model into a NEW cache shaped
    like ``cache`` (S_max = its length; the bucket is zero-padded to it).
    Returns (last-token logits [B, V], cache)."""
    dev = params["embed"].device
    tokens, seq_lens = _tokens(tokens, cfg, dev), _int32(seq_lens, dev)
    b, s = tokens.shape
    S_max = cache["k"].shape[2]
    if s > S_max:
        raise ValueError(f"prompt bucket {s} exceeds cache length {S_max}")
    out = init_cache(cfg, b, S_max, device=dev)

    def write(layer, k, v):
        out["k"][layer, :, :s] = k
        out["v"][layer, :, :s] = v

    logits = _prefill_layers(params, tokens, seq_lens, cfg, write)
    out["len"] = seq_lens.clone()
    return logits, out


@torch.no_grad()
def prefill_into_many(params: dict, tokens, seq_lens, cfg: LlamaConfig,
                      cache: dict, slots, valid) -> tuple[torch.Tensor, dict]:
    """Prefill a WAVE of B prompts [B, S_pad] into rows ``slots`` [B] of the
    shared cache, in place. ``valid`` [B] masks padding rows (B is a shape
    bucket): an invalid row writes nothing. A valid row's cache row is
    replaced whole — the prompt's K/V, then zeros to S_max — and its ``len``
    set, as the JAX version's fresh-cache scatter does. Returns
    (last-token logits [B, V], cache)."""
    dev = params["embed"].device
    tokens, seq_lens = _tokens(tokens, cfg, dev), _int32(seq_lens, dev)
    s = tokens.shape[1]
    S_max = cache["k"].shape[2]
    if s > S_max:
        raise ValueError(f"prompt bucket {s} exceeds cache length {S_max}")
    slots = [int(x) for x in np.asarray(slots).reshape(-1)]
    rows = [i for i, ok in enumerate(np.asarray(valid).reshape(-1)) if ok]

    def write(layer, k, v):
        for i in rows:  # in order: a later row for the same slot wins
            for name, new in (("k", k), ("v", v)):
                dst = cache[name][layer, slots[i]]
                dst[:s] = new[i]
                dst[s:] = 0

    logits = _prefill_layers(params, tokens, seq_lens, cfg, write)
    for i in rows:
        cache["len"][slots[i]] = seq_lens[i]
    return logits, cache


def prefill_into(params: dict, tokens, seq_lens, cfg: LlamaConfig,
                 cache: dict, slot) -> tuple[torch.Tensor, dict]:
    """Prefill ONE prompt [1, S_pad] into row ``slot`` of the shared cache
    (in place): ``prefill_into_many`` with a one-row wave."""
    return prefill_into_many(params, tokens, seq_lens, cfg, cache,
                             [int(slot)], [True])


@torch.no_grad()
def decode_step(params: dict, tokens, cache: dict, cfg: LlamaConfig
                ) -> tuple[torch.Tensor, dict]:
    """One token per row: tokens [B] -> (f32 logits [B, V], cache).

    Rows may sit at different positions (continuous batching); each row
    writes its K/V at its own ``len`` and attends to len+1 keys. A row at
    capacity (len == S_max) writes nothing — its write is masked here, where
    JAX drops it as out of bounds — and attends the whole row (the decode
    kernel clamps kv_len to S_max). The cache is updated in place; ``len``
    comes back as a new tensor capped at S_max."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens).to(dev)
    b = tokens.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S_max = cache["k"].shape[2]
    pos = cache["len"]
    kv_len = pos + 1
    fits = (pos < S_max)[:, None, None]
    pos_w = pos.clamp(max=S_max - 1).long()
    rows = torch.arange(b, device=dev)
    x = _embed(params, tokens, cfg)[:, None, :]
    cos, sin = rope_table(pos[:, None], hd, cfg.rope_theta,
                          scaling=cfg.rope_scaling)
    for layer in range(cfg.n_layers):
        lp = _layer_params(params, layer)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q = apply_rope((h @ lp["wq"]).reshape(b, 1, H, hd), cos, sin)
        k = apply_rope((h @ lp["wk"]).reshape(b, 1, KV, hd), cos, sin)
        v = (h @ lp["wv"]).reshape(b, 1, KV, hd)
        for name, new in (("k", k), ("v", v)):
            arr = cache[name][layer]
            arr[rows, pos_w] = torch.where(fits, new[:, 0], arr[rows, pos_w])
        o = cached_decode_attention(q.contiguous(), cache["k"], cache["v"],
                                    kv_len, layer=layer)
        x = x + o.reshape(b, 1, H * hd) @ lp["wo"]
        x = x + _swiglu(rms_norm(x, lp["mlp_norm"], cfg.norm_eps), lp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ params["lm_head"]).float()
    cache["len"] = torch.clamp(kv_len, max=S_max).to(torch.int32)
    return logits, cache
