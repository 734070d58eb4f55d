"""Llama-3-family decoder in PyTorch — counterpart of ``gofr_tpu/models/llama.py``.

Layouts are the JAX package's, so the two hold the same parameters and the
tests compare like with like:

- every layer weight is STACKED on a leading [n_layers] axis, and a matmul
  is ``x @ W`` with W stored [in, out]; with ``w8`` the seven layer
  matmuls and ``lm_head`` are ``{"q": int8, "s": f32}`` (``_mm``);
- activations are [batch, seq, dim]; attention tensors are BSHD;
- the KV cache is a padded [L, B, S_max, KV, D] pair plus a per-row ``len``;
  with ``kv_quant`` the values are int8 stored FLAT [L, B, S_max, KV*D] and
  bf16 ``k_scale``/``v_scale`` planes ride seq-minor [L, B, KV, S_max].

What differs from JAX, and why:

- PyTorch runs eagerly, so the layer ``scan`` is a Python loop over the
  stacked weights, and the cache is updated IN PLACE (one [B, KV, D] write
  per layer per decode step) instead of donated and re-bound; the int8
  cache's prefill writes each layer as the layer finishes, where JAX
  quantizes the stacked K/V after the scan (the same values: the
  quantization is per vector);
- an out-of-range cache write is dropped by JAX's ``.at[].set`` but is a
  device-side fault in torch, so ``decode_step`` masks the writes of rows
  already at capacity explicitly (their ``len`` stays capped at S_max);
- attention goes through the two dispatchers of ``ops``: the hand-written
  CUDA kernels for a CUDA tensor, their plain versions for a CPU tensor.
  The device decides, so the JAX config's ``use_flash`` has no
  counterpart;
- ``quantize_weights`` quantizes one layer at a time, so no f32 copy of a
  whole stacked weight exists on the card.

The dense serving path is ported at bf16/f32, with the int8 cache and int8
weights. int4 caches (a paged-cache precision), sequence-parallel attention
and checkpoint restore raise ``NotImplementedError`` naming the ROADMAP
item that brings them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import (apply_rope, cached_decode_attention, flash_attention,
                   quantize_kv, quantize_weight, rms_norm, rope_table)

__all__ = ["LlamaConfig", "llama3_8b", "tiny_llama", "kv_bits_from_env",
           "config_from_env", "init_params", "quantize_weights",
           "params_from_config", "params_from_jax", "forward", "init_cache",
           "prefill", "prefill_into", "prefill_into_many", "decode_step"]

_LAYER_KEYS = ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate",
               "w_up", "w_down")
_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


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
        # kv_bits as in the JAX config: 8 (the int8 cache, the default with
        # kv_quant) or 16 (the fp cache); setting 8 implies kv_quant
        if kv_bits is None:
            kv_bits = 8 if kv_quant else 16
        kv_bits = int(kv_bits)
        if kv_bits not in (4, 8, 16):
            raise ValueError(f"kv_bits must be 4, 8 or 16, got {kv_bits}")
        if kv_bits == 16 and kv_quant:
            raise ValueError("kv_quant=True contradicts kv_bits=16")
        if kv_bits == 4:
            raise NotImplementedError(
                "kv_bits=4: int4 KV is a paged-cache precision, and the paged "
                "cache is not ported yet (ROADMAP A.8)")
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
        self.kv_bits = kv_bits
        self.kv_quant = kv_bits < 16
        self.w8 = bool(w8)

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


def kv_bits_from_env() -> int | None:
    """``GOFR_ML_KV_BITS`` -> 4 | 8 | 16, or None when unset. A malformed
    value raises here, as in the JAX package, instead of serving at the
    wrong precision."""
    raw = os.environ.get("GOFR_ML_KV_BITS", "").strip()
    if not raw:
        return None
    try:
        bits = int(raw)
    except ValueError:
        raise ValueError(
            f"GOFR_ML_KV_BITS must be 4, 8 or 16, got {raw!r}") from None
    if bits not in (4, 8, 16):
        raise ValueError(f"GOFR_ML_KV_BITS must be 4, 8 or 16, got {bits}")
    return bits


def config_from_env(tiny_vocab_size: int | None = None) -> LlamaConfig:
    """``LLAMA_PRESET=tiny|1b|8b``, ``LLAMA_DTYPE=bf16|f32``,
    ``LLAMA_KV_QUANT=1`` (the int8 cache), ``GOFR_ML_KV_BITS=8|16`` (the KV
    precision, over ``LLAMA_KV_QUANT``; 4 raises through ``LlamaConfig``)
    and ``LLAMA_W8=1`` (int8 weights: pair with ``params_from_config``), as
    in the JAX package."""
    preset = os.environ.get("LLAMA_PRESET", "tiny")
    kv_quant = os.environ.get("LLAMA_KV_QUANT") == "1"
    kv_bits = kv_bits_from_env()
    if kv_bits is not None:
        kv_quant = kv_bits < 16
    elif kv_quant:
        kv_bits = 8
    kw: dict = {"kv_quant": kv_quant, "kv_bits": kv_bits,
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


def quantize_weights(params: dict) -> dict:
    """int8 weights (w8a16): the seven layer matmuls and ``lm_head`` become
    ``{"q": int8, "s": f32}`` (``ops.quantize_weight``); norms and the
    embedding stay as they are. One layer (and ``lm_head`` a block of
    columns) at a time on the weights' device: the scale reduces over each
    layer's contraction axis, so the result equals quantizing the stack,
    and no f32 copy of a stacked weight (7.5 GB for ``w_gate`` at 8b) is
    ever made. Returns a new tree; the caller drops the fp one."""
    layers = dict(params["layers"])
    for name in _QUANT_KEYS:
        w = layers[name]
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        s = torch.empty((w.shape[0], w.shape[2]), dtype=torch.float32,
                        device=w.device)
        for layer in range(w.shape[0]):
            q[layer], s[layer] = quantize_weight(w[layer])
        layers[name] = {"q": q, "s": s}
    head = params["lm_head"]
    q = torch.empty(head.shape, dtype=torch.int8, device=head.device)
    s = torch.empty(head.shape[1:], dtype=torch.float32, device=head.device)
    cols = 16_384
    for c in range(0, head.shape[1], cols):
        q[:, c:c + cols], s[c:c + cols] = quantize_weight(head[:, c:c + cols])
    return {**params, "layers": layers, "lm_head": {"q": q, "s": s}}


def params_from_config(cfg: LlamaConfig, seed: int = 0,
                       checkpoint_dir: str | None = None, device=None) -> dict:
    """Random weights from ``seed`` (``init_params``), quantized when
    ``cfg.w8`` — the one place that applies ``w8``, as in the JAX package.
    A checkpoint (``checkpoint_dir`` or ``LLAMA_CKPT``) raises: restoring
    one is not ported yet."""
    from .. import resolve_device

    if checkpoint_dir or os.environ.get("LLAMA_CKPT"):
        raise NotImplementedError(
            "checkpoint restore (LLAMA_CKPT / checkpoint_dir) is not ported "
            "yet (ROADMAP A.12)")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device=device)
    return quantize_weights(params) if cfg.w8 else params


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
    llama.init_params(cfg, key))``, or of ``llama.quantize_weights`` of it)
    -> the port's parameters on ``device``, bit-exact: bf16 stays bf16, the
    f32 norms stay f32, an int8 weight's ``{"q", "s"}`` stays int8 and
    f32."""
    from .. import resolve_device

    device = resolve_device(device)

    def leaf(a):
        if isinstance(a, dict):
            return {k: _tensor_from_numpy(a[k], device) for k in ("q", "s")}
        return _tensor_from_numpy(a, device)

    return {
        "embed": leaf(tree["embed"]),
        "layers": {k: leaf(tree["layers"][k]) for k in _LAYER_KEYS},
        "final_norm": leaf(tree["final_norm"]),
        "lm_head": leaf(tree["lm_head"]),
    }


# -- the model ------------------------------------------------------------------

def _mm(x, w):
    """x @ w for a plain or an int8 (``{"q": int8, "s": f32}``) weight. The
    per-output-channel scale commutes out of the contraction:
    ``(x @ q) * s``, in ``x.dtype``, in the JAX code's order. Eager PyTorch
    materialises the widened copy of ``q`` for each call; a fused int8-weight
    GEMM is later work."""
    if isinstance(w, dict):
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return x @ w


def _swiglu(x, lp):
    g = torch.nn.functional.silu(_mm(x, lp["w_gate"]))
    return _mm(g * _mm(x, lp["w_up"]), lp["w_down"])


def _layer_params(params: dict, layer: int) -> dict:
    return {k: ({n: t[layer] for n, t in v.items()} if isinstance(v, dict)
                else v[layer])
            for k, v in params["layers"].items()}


def _layer(cfg: LlamaConfig, x, lp, cos, sin, *, kv_len=None):
    """One full-sequence decoder block (prefill). Returns (x, k, v) with k
    and v GROUPED [B, S, KV, D]: the flash dispatcher takes them as they are
    (its plain version expands them with ``repeat_kv`` itself)."""
    b, s, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = apply_rope(_mm(h, lp["wq"]).reshape(b, s, H, hd), cos, sin)
    k = apply_rope(_mm(h, lp["wk"]).reshape(b, s, KV, hd), cos, sin)
    v = _mm(h, lp["wv"]).reshape(b, s, KV, hd)
    o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=True, kv_len=kv_len)
    x = x + _mm(o.reshape(b, s, H * hd), lp["wo"])
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
    return _mm(x, params["lm_head"]).float()


# -- KV-cache serving path ------------------------------------------------------

def init_cache(cfg: LlamaConfig, batch: int, max_seq: int | None = None,
               device=None) -> dict:
    """Dense cache, all zeros, with the JAX package's keys, shapes and
    dtypes: k/v [L, B, S_max, KV, D] in ``cfg.dtype``, or with
    ``kv_quant`` k/v int8 FLAT [L, B, S_max, KV*D] and ``k_scale``/
    ``v_scale`` bf16 [L, B, KV, S_max] (seq minor); ``len`` [B] int32."""
    from .. import resolve_device

    device = resolve_device(device)
    S = max_seq or cfg.max_seq_len
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    if cfg.kv_quant:
        cache = {name: torch.zeros((L, batch, S, KV * hd), dtype=torch.int8,
                                   device=device) for name in ("k", "v")}
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros((L, batch, KV, S), dtype=torch.bfloat16,
                                      device=device)
    else:
        cache = {name: torch.zeros((L, batch, S, KV, hd), dtype=cfg.dtype,
                                   device=device) for name in ("k", "v")}
    cache["len"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache


def _kv_planes(cfg: LlamaConfig, k, v) -> dict:
    """One layer's prefilled K/V [B, s, KV, D] as the cache stores them:
    name -> (tensor [B, ...], seq axis within one row). fp: k/v as they are;
    int8: the quantized values flat [B, s, KV*D] and the scales transposed
    to seq-minor [B, KV, s]. Prefill attends the fp K/V: only what is
    stored is quantized."""
    if not cfg.kv_quant:
        return {"k": (k, 0), "v": (v, 0)}
    b, s = k.shape[:2]
    planes = {}
    for name, x in (("k", k), ("v", v)):
        codes, scale = quantize_kv(x)
        planes[name] = (codes.reshape(b, s, -1), 0)
        planes[f"{name}_scale"] = (scale.transpose(1, 2), 1)
    return planes


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
    return _mm(last, params["lm_head"]).float()


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
        for name, (new, axis) in _kv_planes(cfg, k, v).items():
            out[name][layer].narrow(axis + 1, 0, s).copy_(new)

    logits = _prefill_layers(params, tokens, seq_lens, cfg, write)
    out["len"] = seq_lens.clone()
    return logits, out


@torch.no_grad()
def prefill_into_many(params: dict, tokens, seq_lens, cfg: LlamaConfig,
                      cache: dict, slots, valid) -> tuple[torch.Tensor, dict]:
    """Prefill a WAVE of B prompts [B, S_pad] into rows ``slots`` [B] of the
    shared cache, in place. ``valid`` [B] masks padding rows (B is a shape
    bucket): an invalid row writes nothing. A valid row's cache row is
    replaced whole — the prompt's K/V (values and scales of an int8 cache),
    then zeros to S_max — and its ``len`` set, as the JAX version's
    fresh-cache scatter does. Returns (last-token logits [B, V], cache)."""
    dev = params["embed"].device
    tokens, seq_lens = _tokens(tokens, cfg, dev), _int32(seq_lens, dev)
    s = tokens.shape[1]
    S_max = cache["k"].shape[2]
    if s > S_max:
        raise ValueError(f"prompt bucket {s} exceeds cache length {S_max}")
    slots = [int(x) for x in np.asarray(slots).reshape(-1)]
    rows = [i for i, ok in enumerate(np.asarray(valid).reshape(-1)) if ok]

    def write(layer, k, v):
        planes = _kv_planes(cfg, k, v)
        for i in rows:  # in order: a later row for the same slot wins
            for name, (new, axis) in planes.items():
                dst = cache[name][layer, slots[i]]
                dst.narrow(axis, 0, s).copy_(new[i])
                dst.narrow(axis, s, S_max - s).zero_()

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


def _masked_set(arr, idx, new, fits) -> None:
    """arr[idx] = new, in place, for the rows where ``fits`` [B] holds."""
    keep = fits.view(-1, *([1] * (new.dim() - 1)))
    arr[idx] = torch.where(keep, new, arr[idx])


def _write_token_kv(cfg: LlamaConfig, cache: dict, layer: int, k, v, rows,
                    pos, fits) -> None:
    """Write one token's K/V [B, KV, D] of each row at ``[layer, rows,
    pos]``, in place, masked to the rows where ``fits``. int8: quantize,
    scatter the flat [B, KV*D] values at ``[layer, rows, pos]`` and the
    [B, KV] scales at ``[layer, rows, :, pos]`` (seq minor)."""
    if not cfg.kv_quant:
        for name, x in (("k", k), ("v", v)):
            _masked_set(cache[name][layer], (rows, pos), x, fits)
        return
    heads = torch.arange(cfg.n_kv_heads, device=k.device)[None, :]
    for name, x in (("k", k), ("v", v)):
        codes, scale = quantize_kv(x)
        _masked_set(cache[name][layer], (rows, pos),
                    codes.reshape(x.shape[0], -1), fits)
        _masked_set(cache[f"{name}_scale"][layer],
                    (rows[:, None], heads, pos[:, None]), scale, fits)


@torch.no_grad()
def decode_step(params: dict, tokens, cache: dict, cfg: LlamaConfig
                ) -> tuple[torch.Tensor, dict]:
    """One token per row: tokens [B] -> (f32 logits [B, V], cache).

    Rows may sit at different positions (continuous batching); each row
    writes its K/V at its own ``len`` and attends to len+1 keys. A row at
    capacity (len == S_max) writes nothing — its write is masked here, where
    JAX drops it as out of bounds — and attends the whole row (the decode
    kernels clamp kv_len to S_max). The cache is updated in place; ``len``
    comes back as a new tensor capped at S_max. With an int8 cache the new
    token's K/V are quantized on write and attention reads the int8 cache
    with its scales."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens).to(dev)
    b = tokens.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S_max = cache["k"].shape[2]
    pos = cache["len"]
    kv_len = pos + 1
    fits = pos < S_max
    pos_w = pos.clamp(max=S_max - 1).long()
    rows = torch.arange(b, device=dev)
    scales = ({"k_scale": cache["k_scale"], "v_scale": cache["v_scale"]}
              if cfg.kv_quant else {})
    x = _embed(params, tokens, cfg)[:, None, :]
    cos, sin = rope_table(pos[:, None], hd, cfg.rope_theta,
                          scaling=cfg.rope_scaling)
    for layer in range(cfg.n_layers):
        lp = _layer_params(params, layer)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q = apply_rope(_mm(h, lp["wq"]).reshape(b, 1, H, hd), cos, sin)
        k = apply_rope(_mm(h, lp["wk"]).reshape(b, 1, KV, hd), cos, sin)
        v = _mm(h, lp["wv"]).reshape(b, 1, KV, hd)
        _write_token_kv(cfg, cache, layer, k[:, 0], v[:, 0], rows, pos_w, fits)
        o = cached_decode_attention(q.contiguous(), cache["k"], cache["v"],
                                    kv_len, layer=layer, **scales)
        x = x + _mm(o.reshape(b, 1, H * hd), lp["wo"])
        x = x + _swiglu(rms_norm(x, lp["mlp_norm"], cfg.norm_eps), lp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _mm(x[:, 0], params["lm_head"]).float()
    cache["len"] = torch.clamp(kv_len, max=S_max).to(torch.int32)
    return logits, cache
