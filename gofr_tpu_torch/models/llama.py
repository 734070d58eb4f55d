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

The paged cache is a pool of pages shared by every slot
(``init_paged_cache``): bf16/f32 values [L, N, page, KV, D], or quantized
values flat [L, N, page, KV*W] (int8, or two int4 codes a byte) with their
bf16 planes [L, N, KV, page]; page 0 is scratch. ``paged_prefill_into``,
``paged_suffix_prefill`` (a segment or suffix at a virtual offset) and
``paged_decode_step`` read and write it through a page table, and gather a
row's pages into a virtual sequence for the kernels. Where JAX attends that
sequence with its plain ``attention``, the port hands it to the same two
kernels as the dense path: flash with ``q_offset`` for a suffix or segment,
the decode kernel for a step (the bf16 one over bf16 pages and over int4
pages dequantized, the int8 one over int8 pages with their scales
transposed to [B, KV, S]). A decode step gathers only the table columns the
caller says the live rows need (``n_cols``); ``kv_len`` masks the rest, so
the result is unchanged.

The dense serving path is ported at bf16/f32 with the int8 cache and int8
weights, chunked prefill (``prefill_segment_into``) and the paged cache at
bf16/f32, int8 and int4. Speculative decoding's verify pass is
``decode_window`` / ``paged_decode_window``: W tokens a row written at
``len .. len+W-1`` (``len`` is not advanced) and attended through the
decode kernels' window launch, position t over the first ``len + 1 + t``
positions; ``draft_from_env`` builds its draft model.

Training: ``loss_fn`` (masked next-token cross-entropy over f32 logits)
runs the differentiable full-sequence forward, through the flash kernel
under autograd (``ops._FlashDiff``) on a card; ``LlamaConfig(remat=True)``
recomputes each layer in the backward pass
(``torch.utils.checkpoint``, JAX's ``jax.checkpoint``). The stacked
weights are unbound once a forward, so a layer's gradient lands in its
slice of the stacked gradient in one copy. ``LLAMA_CKPT`` /
``checkpoint_dir`` restore real weights (an HF directory through
``ml.hf_import``, a ``ml.checkpoint.Checkpointer`` directory of a params
tree or of a training state) and ``LLM_DRAFT_CKPT`` loads an HF draft.
Sequence-parallel attention raises ``NotImplementedError`` naming the
ROADMAP item that brings it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import tensor_from_numpy as _tensor_from_numpy
from ..ops import (apply_rope, cached_decode_attention, dequantize_kv,
                   dequantize_kv4, flash_attention, quantize_kv, quantize_kv4,
                   quantize_weight, rms_norm, rope_table)

__all__ = ["LlamaConfig", "llama3_8b", "tiny_llama", "kv_bits_from_env",
           "config_from_env", "init_params", "quantize_weights",
           "params_from_config", "params_from_jax", "forward", "loss_fn",
           "kv_plane_names", "kv_store_width", "kv_encode", "kv_decode",
           "init_cache", "prefill", "prefill_into", "prefill_into_many",
           "prefill_segment_into", "decode_step", "decode_window",
           "init_paged_cache", "paged_prefill_into", "paged_suffix_prefill",
           "paged_decode_step", "paged_decode_window", "draft_from_env"]

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
        remat: bool = False,
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
        # kv_quant), 4 (packed int4 codes with a scale and a zero point a
        # vector; paged caches only) or 16 (the fp cache); 4 and 8 imply
        # kv_quant
        if kv_bits is None:
            kv_bits = 8 if kv_quant else 16
        kv_bits = int(kv_bits)
        if kv_bits not in (4, 8, 16):
            raise ValueError(f"kv_bits must be 4, 8 or 16, got {kv_bits}")
        if kv_bits == 16 and kv_quant:
            raise ValueError("kv_quant=True contradicts kv_bits=16")
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
        # recompute each layer's activations in the backward pass
        # (``loss_fn``): the memory of training stays O(1) in depth
        self.remat = bool(remat)
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
    ``LLAMA_KV_QUANT=1`` (the int8 cache), ``GOFR_ML_KV_BITS=4|8|16`` (the KV
    precision, over ``LLAMA_KV_QUANT``; 4 needs a paged generator)
    and ``LLAMA_W8=1`` (int8 weights: pair with ``params_from_config``), as
    in the JAX package. ``LLAMA_CKPT`` naming an HF directory defines the
    architecture (``hf_import.hf_config``): the preset then only brings
    the serving knobs."""
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
    from ..ml.hf_import import hf_config, is_hf_dir

    ckpt = os.environ.get("LLAMA_CKPT")
    if ckpt and is_hf_dir(ckpt):
        return hf_config(ckpt, **kw)
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


def draft_from_env(target_cfg: LlamaConfig, target_params=None,
                   device=None) -> tuple:
    """(draft_params, draft_cfg) for speculative decoding from the
    environment, or (None, None) when no draft is configured, as in the
    JAX package. ``LLM_DRAFT_PRESET=self`` reuses the target's weights
    under a clone of its config with the quantized and paged knobs off
    (the draft keeps its own fp dense cache): the acceptance upper bound of
    the draft-model path. ``tiny`` and ``1b`` build random drafts of that
    shape (``params_from_config``, seed 1) on the target's device (or
    ``device``): lossless, accepting next to nothing. ``LLM_DRAFT_CKPT``
    names an HF directory of a shared-vocab draft (anything else raises, as
    in the JAX package: a random draft in its place would serve slower with
    no sign why)."""
    from .. import resolve_device
    from ..ml.hf_import import hf_config, is_hf_dir

    ckpt = os.environ.get("LLM_DRAFT_CKPT")
    preset = os.environ.get("LLM_DRAFT_PRESET")
    if not ckpt and not preset:
        return None, None
    if device is None and target_params is not None:
        device = target_params["embed"].device
    if ckpt:
        if not is_hf_dir(ckpt):
            raise ValueError(
                f"LLM_DRAFT_CKPT={ckpt!r} is not a HF model directory "
                "(config.json + *.safetensors)")
        dcfg = hf_config(ckpt)
        if dcfg.vocab_size != target_cfg.vocab_size:
            raise ValueError(
                f"draft vocab {dcfg.vocab_size} != target "
                f"{target_cfg.vocab_size}: speculation needs a shared vocab")
        return params_from_config(dcfg, checkpoint_dir=ckpt,
                                  device=resolve_device(device)), dcfg
    if preset == "self":
        if target_params is None:
            raise ValueError("LLM_DRAFT_PRESET=self needs target params")
        dcfg = LlamaConfig(
            vocab_size=target_cfg.vocab_size, dim=target_cfg.dim,
            n_layers=target_cfg.n_layers, n_heads=target_cfg.n_heads,
            n_kv_heads=target_cfg.n_kv_heads, ffn_dim=target_cfg.ffn_dim,
            max_seq_len=target_cfg.max_seq_len,
            rope_theta=target_cfg.rope_theta, norm_eps=target_cfg.norm_eps,
            dtype=target_cfg.dtype, w8=target_cfg.w8,
            rope_scaling=target_cfg.rope_scaling)
        return target_params, dcfg
    if preset == "1b":
        dcfg = LlamaConfig(
            vocab_size=target_cfg.vocab_size, dim=2048, n_layers=16,
            n_heads=16, n_kv_heads=8, ffn_dim=8192,
            max_seq_len=target_cfg.max_seq_len)
    else:
        dcfg = tiny_llama(vocab_size=target_cfg.vocab_size)
    if dcfg.vocab_size != target_cfg.vocab_size:
        raise ValueError(
            f"draft vocab {dcfg.vocab_size} != target "
            f"{target_cfg.vocab_size}: speculation needs a shared vocab")
    return params_from_config(dcfg, seed=1,
                              device=resolve_device(device)), dcfg


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
    """Random weights from ``seed`` (``init_params``), or real ones from
    ``checkpoint_dir`` / ``LLAMA_CKPT``, quantized when ``cfg.w8`` — the one
    place that applies ``w8`` and ``LLAMA_CKPT``, as in the JAX package.
    Two layouts restore: an HF model directory (``ml.hf_import``), and a
    ``ml.checkpoint.Checkpointer`` directory whose latest step holds a
    bare params tree or a training state's ``"params"`` entry (cast to
    ``cfg.dtype``; only that entry is read). ``w8`` quantizes AFTER the
    restore: checkpoints hold fp weights."""
    from .. import resolve_device
    from ..ml.hf_import import import_hf_llama, is_hf_dir

    checkpoint_dir = checkpoint_dir or os.environ.get("LLAMA_CKPT")
    device = resolve_device(device)
    if checkpoint_dir and is_hf_dir(checkpoint_dir):
        _, params = import_hf_llama(checkpoint_dir, cfg, device=device)
    elif checkpoint_dir:
        params = _restore_params(checkpoint_dir, cfg, device)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_params(cfg, gen, device=device)
    return quantize_weights(params) if cfg.w8 else params


def _param_like(cfg: LlamaConfig) -> dict:
    """The params tree's shapes and dtypes as meta tensors (no memory): the
    ``like`` of a checkpoint restore."""
    L, D, V = cfg.n_layers, cfg.dim, cfg.vocab_size

    def meta(shape, dtype=cfg.dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    layers = {"attn_norm": meta((L, D), torch.float32),
              "mlp_norm": meta((L, D), torch.float32)}
    layers.update({name: meta(shape)
                   for name, (shape, _) in _param_shapes(cfg).items()})
    return {"embed": meta((V, D)), "layers": layers,
            "final_norm": meta((D,), torch.float32),
            "lm_head": meta((D, V))}


def _restore_params(directory: str, cfg: LlamaConfig, device) -> dict:
    """The latest step of a ``Checkpointer`` directory on ``device``: a bare
    params tree, else a training state's ``"params"`` entry."""
    from ..ml.checkpoint import Checkpointer

    if not os.path.isdir(directory):
        # a mistyped LLAMA_CKPT must not create an empty run directory
        raise FileNotFoundError(f"no checkpoint directory {directory!r}")
    ckpt = Checkpointer(directory)
    try:
        step = ckpt.latest_step()
        keys = ckpt.saved_keys(step) or []
        # a training state {"params": ..., "opt": ..., "step": ...}: read
        # its params entry alone; a bare params tree whole, so a mismatch
        # (a wrong LLAMA_PRESET) raises with the saved and target shapes
        item = "params" if "params" in keys and "embed" not in keys else None
        return ckpt.restore(step, like=_param_like(cfg), device=device,
                            item=item)
    finally:
        ckpt.close()


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
    """Host ints -> int32 on ``device``. To a card the copy goes through
    pinned memory without blocking, so the host never waits for queued
    work to upload an index."""
    t = torch.as_tensor(np.asarray(x), dtype=torch.int32)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _token_tensor(tokens, cfg: LlamaConfig, device) -> torch.Tensor:
    """``_tokens`` for host ids or for a tensor (a ``DataLoader`` batch
    already on the device: its range is checked there)."""
    if not isinstance(tokens, torch.Tensor):
        return _tokens(tokens, cfg, device)
    tokens = tokens.to(device)
    if tokens.numel() and bool(((tokens < 0) | (tokens >= cfg.vocab_size))
                               .any()):
        raise ValueError(f"token ids must lie in [0, {cfg.vocab_size})")
    return tokens


def _forward(params: dict, tokens, cfg: LlamaConfig, seq_lens=None
             ) -> torch.Tensor:
    """The full-sequence forward, differentiable: autograd records it when
    grad is on. Each stacked layer weight is unbound once, so the backward
    stacks a weight's per-layer gradients in one pass; with ``cfg.remat``
    (and grad on) a layer keeps only its input and recomputes the rest in
    the backward pass."""
    dev = params["embed"].device
    tokens = _token_tensor(tokens, cfg, dev)
    kv_len = None if seq_lens is None else _int32(seq_lens, dev)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=dev)[None, :]
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta,
                          scaling=cfg.rope_scaling)
    unbound = {k: ({n: t.unbind(0) for n, t in v.items()}
                   if isinstance(v, dict) else v.unbind(0))
               for k, v in params["layers"].items()}

    def body(x, lp):
        return _layer(cfg, x, lp, cos, sin, kv_len=kv_len)[0]

    remat = cfg.remat and torch.is_grad_enabled()
    for layer in range(cfg.n_layers):
        lp = {k: ({n: t[layer] for n, t in v.items()} if isinstance(v, dict)
                  else v[layer]) for k, v in unbound.items()}
        if remat:
            x = torch.utils.checkpoint.checkpoint(body, x, lp,
                                                  use_reentrant=False)
        else:
            x = body(x, lp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _mm(x, params["lm_head"]).float()


@torch.no_grad()
def forward(params: dict, tokens, cfg: LlamaConfig, *, seq_lens=None
            ) -> torch.Tensor:
    """Full-sequence forward: tokens [B, S] -> f32 logits [B, S, V].
    ``seq_lens`` [B] masks padded tail positions out of attention."""
    return _forward(params, tokens, cfg, seq_lens)


def loss_fn(params: dict, tokens, targets, mask, cfg: LlamaConfig
            ) -> torch.Tensor:
    """Masked next-token cross-entropy over f32 logits, as JAX's
    ``loss_fn``: -sum(log p(target) * mask) / max(sum(mask), 1).
    ``tokens``, ``targets`` and ``mask`` are [B, S], host arrays or tensors;
    differentiable when grad is on (``ml.train``)."""
    logits = _forward(params, tokens, cfg)
    dev = logits.device
    targets = torch.as_tensor(targets, device=dev).long()
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets[..., None])[..., 0]
    maskf = torch.as_tensor(mask, device=dev).float()
    return -(ll * maskf).sum() / torch.clamp(maskf.sum(), min=1.0)


# -- KV-cache serving path ------------------------------------------------------

def kv_plane_names(cfg: LlamaConfig) -> tuple[str, ...]:
    """Per-vector side planes riding next to the quantized values:
    ``scale`` for symmetric int8, ``scale`` + ``zero`` for asymmetric int4.
    Cache keys are ``k_<plane>`` / ``v_<plane>``, always sequence-minor
    ([..., KV, S] / [..., KV, page])."""
    return ("scale", "zero") if cfg.kv_bits == 4 else ("scale",)


def kv_store_width(cfg: LlamaConfig) -> int:
    """Stored width of ONE kv vector: ``head_dim`` int8 codes, or
    ``head_dim / 2`` bytes of packed int4 codes."""
    return cfg.head_dim // 2 if cfg.kv_bits == 4 else cfg.head_dim


def kv_encode(cfg: LlamaConfig, x: torch.Tensor):
    """Quantize [..., KV, hd] at the config's precision. Returns
    (values [..., KV, kv_store_width], {plane: [..., KV]})."""
    if cfg.kv_bits == 4:
        q, sc, zp = quantize_kv4(x)
        return q, {"scale": sc, "zero": zp}
    q, sc = quantize_kv(x)
    return q, {"scale": sc}


def kv_decode(cfg: LlamaConfig, q: torch.Tensor, planes: dict,
              dtype: torch.dtype | None = None) -> torch.Tensor:
    """Dequantize values [..., KV, kv_store_width] with their planes back to
    [..., KV, hd]: the inverse of ``kv_encode``."""
    dtype = dtype or cfg.dtype
    if cfg.kv_bits == 4:
        return dequantize_kv4(q, planes["scale"], planes["zero"], dtype)
    return dequantize_kv(q, planes["scale"], dtype)


def _kv_value_dtype(cfg: LlamaConfig) -> torch.dtype:
    return torch.uint8 if cfg.kv_bits == 4 else torch.int8


def _quant_cache(cfg: LlamaConfig, lead: tuple, seq: int, device) -> dict:
    """Zeroed quantized K/V with their planes: values flat
    [*lead, seq, KV*W], planes bf16 [*lead, KV, seq] (seq minor)."""
    KV = cfg.n_kv_heads
    cache = {name: torch.zeros((*lead, seq, KV * kv_store_width(cfg)),
                               dtype=_kv_value_dtype(cfg), device=device)
             for name in ("k", "v")}
    for pl in kv_plane_names(cfg):
        for name in ("k", "v"):
            cache[f"{name}_{pl}"] = torch.zeros((*lead, KV, seq),
                                                dtype=torch.bfloat16,
                                                device=device)
    return cache


def init_cache(cfg: LlamaConfig, batch: int, max_seq: int | None = None,
               device=None) -> dict:
    """Dense cache, all zeros, with the JAX package's keys, shapes and
    dtypes: k/v [L, B, S_max, KV, D] in ``cfg.dtype``, or with
    ``kv_quant`` the values FLAT [L, B, S_max, KV*W] (int8, or uint8 holding
    two int4 codes) and their bf16 planes (``k_scale``/``v_scale``, and
    ``k_zero``/``v_zero`` at int4) [L, B, KV, S_max] (seq minor); ``len``
    [B] int32."""
    from .. import resolve_device

    device = resolve_device(device)
    S = max_seq or cfg.max_seq_len
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    if cfg.kv_quant:
        cache = _quant_cache(cfg, (L, batch), S, device)
    else:
        cache = {name: torch.zeros((L, batch, S, KV, hd), dtype=cfg.dtype,
                                   device=device) for name in ("k", "v")}
    cache["len"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache


def _kv_planes(cfg: LlamaConfig, k, v) -> dict:
    """K/V [B, s, KV, D] as the cache stores them: name -> (tensor [B, ...],
    seq axis within one row). fp: k/v as they are; quantized: the values
    flat [B, s, KV*W] and each plane transposed to seq-minor [B, KV, s].
    Prefill attends the fp K/V: only what is stored is quantized."""
    if not cfg.kv_quant:
        return {"k": (k, 0), "v": (v, 0)}
    b, s = k.shape[:2]
    planes = {}
    for name, x in (("k", k), ("v", v)):
        codes, side = kv_encode(cfg, x)
        planes[name] = (codes.reshape(b, s, -1), 0)
        for pl, val in side.items():
            planes[f"{name}_{pl}"] = (val.transpose(1, 2), 1)
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
    replaced whole — the prompt's K/V (values and planes of a quantized
    cache), then zeros to S_max — and its ``len`` set, as the JAX version's
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


def _qkv(cfg: LlamaConfig, x, lp, cos, sin):
    """The attention inputs of one block: rope'd q [B, T, H, D], rope'd k
    and v [B, T, KV, D]."""
    b, t, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = apply_rope(_mm(h, lp["wq"]).reshape(b, t, H, hd), cos, sin)
    k = apply_rope(_mm(h, lp["wk"]).reshape(b, t, KV, hd), cos, sin)
    v = _mm(h, lp["wv"]).reshape(b, t, KV, hd)
    return q, k, v


def _block_out(cfg: LlamaConfig, x, o, lp):
    """Close one block: the output projection of attention ``o`` [B, T, H,
    D], then the MLP, each with its residual."""
    b, t = o.shape[:2]
    x = x + _mm(o.reshape(b, t, -1), lp["wo"])
    return x + _swiglu(rms_norm(x, lp["mlp_norm"], cfg.norm_eps), lp)


def _logits_at(params, cfg: LlamaConfig, x, row: int) -> torch.Tensor:
    """f32 logits [1, V] of position ``row`` of the one-row stream x."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _mm(x[:, row], params["lm_head"]).float()


@torch.no_grad()
def prefill_segment_into(params: dict, tokens, seg_len, cfg: LlamaConfig,
                         cache: dict, slot, start, new_len
                         ) -> tuple[torch.Tensor, dict]:
    """CHUNKED prefill: one segment [1, C] of a longer prompt into row
    ``slot`` of the dense cache at positions start..start+C-1 (in place),
    attending the row's already-prefilled positions plus the segment,
    causally from ``start``. ``seg_len`` [1] is the segment's valid length
    (padding positions are written too, as in JAX, and overwritten later).
    Returns (logits of the segment's last valid token [1, V], cache).

    ``new_len`` lands in ``cache["len"][slot]``: the cache capacity for a
    non-final segment, so interleaved decode steps drop this row's writes
    (the masked write of ``decode_step``) instead of corrupting prefilled
    positions; the prompt's length on the final segment. Attention is the
    flash kernel over the slot's row of the layer with ``q_offset=start``
    and ``kv_len = start + seg_len``; an int8 row is dequantized first with
    the plain op, as JAX does. ``start`` and ``new_len`` are host ints. A
    segment past the row's end raises (JAX would clamp its start)."""
    if cfg.kv_bits == 4:
        raise ValueError("int4 KV is a paged-cache precision — use "
                         "page_size > 0 (paged_suffix_prefill)")
    dev = params["embed"].device
    tokens = _tokens(tokens, cfg, dev)
    seg = int(np.asarray(seg_len).reshape(-1)[0])
    start, slot = int(start), int(slot)
    c = tokens.shape[1]
    S_max = cache["k"].shape[2]
    if start + c > S_max:
        raise ValueError(f"segment {start}..{start + c} exceeds cache "
                         f"length {S_max}")
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    valid_to = _int32([start + seg], dev)
    cos, sin = rope_table(torch.arange(start, start + c, device=dev)[None],
                          hd, cfg.rope_theta, scaling=cfg.rope_scaling)
    x = _embed(params, tokens, cfg)
    for layer in range(cfg.n_layers):
        lp = _layer_params(params, layer)
        q, k, v = _qkv(cfg, x, lp, cos, sin)
        for name, (new, axis) in _kv_planes(cfg, k, v).items():
            cache[name][layer, slot].narrow(axis, start, c).copy_(new[0])
        if cfg.kv_quant:
            k_row, v_row = (
                dequantize_kv(cache[name][layer, slot].view(S_max, KV, hd),
                              cache[f"{name}_scale"][layer, slot].t(),
                              cfg.dtype)
                for name in ("k", "v"))
        else:
            k_row, v_row = cache["k"][layer, slot], cache["v"][layer, slot]
        o = flash_attention(q.contiguous(), k_row[None], v_row[None],
                            causal=True, q_offset=start, kv_len=valid_to)
        x = _block_out(cfg, x, o, lp)
    cache["len"][slot] = int(new_len)
    return _logits_at(params, cfg, x, seg - 1), cache


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
        codes, planes = kv_encode(cfg, x)
        _masked_set(cache[name][layer], (rows, pos),
                    codes.reshape(x.shape[0], -1), fits)
        for pl, val in planes.items():
            _masked_set(cache[f"{name}_{pl}"][layer],
                        (rows[:, None], heads, pos[:, None]), val, fits)


@torch.no_grad()
def decode_step(params: dict, tokens, cache: dict, cfg: LlamaConfig
                ) -> tuple[torch.Tensor, dict]:
    """One token per row: tokens [B] -> (f32 logits [B, V], cache).

    Rows may sit at different positions (continuous batching); each row
    writes its K/V at its own ``len`` and attends to len+1 keys. A row at
    capacity (len == S_max) writes nothing — its write is masked here, where
    JAX drops it as out of bounds — and attends the whole row (the decode
    kernels clamp kv_len to S_max). The cache is updated in place, ``len``
    too (capped at S_max): a CUDA graph of the step keeps its pointers. With an int8 cache the new
    token's K/V are quantized on write and attention reads the int8 cache
    with its scales. int4 is a paged precision and raises, as in JAX."""
    if cfg.kv_bits == 4:
        raise ValueError("int4 KV is a paged-cache precision — use "
                         "page_size > 0 (paged_decode_step)")
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens).to(dev)
    b = tokens.shape[0]
    S_max = cache["k"].shape[2]
    pos = cache["len"]
    kv_len = pos + 1
    fits = pos < S_max
    pos_w = pos.clamp(max=S_max - 1).long()
    rows = torch.arange(b, device=dev)
    scales = ({"k_scale": cache["k_scale"], "v_scale": cache["v_scale"]}
              if cfg.kv_quant else {})
    x = _embed(params, tokens, cfg)[:, None, :]
    cos, sin = rope_table(pos[:, None], cfg.head_dim, cfg.rope_theta,
                          scaling=cfg.rope_scaling)
    for layer in range(cfg.n_layers):
        lp = _layer_params(params, layer)
        q, k, v = _qkv(cfg, x, lp, cos, sin)
        _write_token_kv(cfg, cache, layer, k[:, 0], v[:, 0], rows, pos_w, fits)
        o = cached_decode_attention(q.contiguous(), cache["k"], cache["v"],
                                    kv_len, layer=layer, **scales)
        x = _block_out(cfg, x, o, lp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _mm(x[:, 0], params["lm_head"]).float()
    cache["len"].copy_(torch.clamp(kv_len, max=S_max))
    return logits, cache


def _window_positions(cache: dict, w: int):
    """(pos0 [B], positions [B, W]) of a verify window at each row's
    ``len``."""
    pos0 = cache["len"]
    positions = pos0[:, None] + torch.arange(w, device=pos0.device)[None, :]
    return pos0, positions


def _window_logits(params, cfg: LlamaConfig, x) -> torch.Tensor:
    """f32 logits [B, W, V] of every window position."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _mm(x, params["lm_head"]).float()


@torch.no_grad()
def decode_window(params: dict, tokens, cache: dict, cfg: LlamaConfig
                  ) -> tuple[torch.Tensor, dict]:
    """Speculative verify window (JAX's ``decode_window``): W tokens a row
    [B, W] at positions ``len .. len+W-1`` -> (f32 logits [B, W, V],
    cache). Each row's W K/V rows are written in place at their positions
    (a position past capacity writes nothing: JAX drops it) and query t
    attends the row's first ``len + 1 + t`` positions: its prefix plus the
    window so far, through the decode kernels' window launch. ``len`` is
    NOT advanced: the caller advances it by 1 + the accepted drafts, and a
    rejected position's row is written again before any query reaches it.
    With the int8 cache the window rows are quantized on write and
    attention reads int8. int4 is a paged precision and raises, as in
    JAX."""
    if cfg.kv_bits == 4:
        raise ValueError("int4 KV is a paged-cache precision — use "
                         "page_size > 0 (paged_decode_window)")
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens).to(dev)
    b, w = tokens.shape
    S_max = cache["k"].shape[2]
    pos0, positions = _window_positions(cache, w)
    fits = positions < S_max
    pos_w = positions.clamp(max=S_max - 1).long()
    rows = torch.arange(b, device=dev)
    scales = ({"k_scale": cache["k_scale"], "v_scale": cache["v_scale"]}
              if cfg.kv_quant else {})
    x = _embed(params, tokens, cfg)
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta,
                          scaling=cfg.rope_scaling)
    kv_len = pos0 + 1
    for layer in range(cfg.n_layers):
        lp = _layer_params(params, layer)
        q, k, v = _qkv(cfg, x, lp, cos, sin)
        # one position at a time: a position past capacity rewrites what
        # an earlier one wrote at the clamped index, in order
        for t in range(w):
            _write_token_kv(cfg, cache, layer, k[:, t], v[:, t], rows,
                            pos_w[:, t], fits[:, t])
        o = cached_decode_attention(q.contiguous(), cache["k"], cache["v"],
                                    kv_len, layer=layer, **scales)
        x = _block_out(cfg, x, o, lp)
    return _window_logits(params, cfg, x), cache


# -- the paged cache ------------------------------------------------------------

def init_paged_cache(cfg: LlamaConfig, batch: int, n_pages: int, page_s: int,
                     device=None) -> dict:
    """Block-paged KV cache: a POOL of ``n_pages`` pages of ``page_s``
    positions shared by every slot, all zeros. bf16/f32 values [L, N, ps,
    KV, D]; quantized values flat [L, N, ps, KV*W] (uint8 at int4) with
    their bf16 planes [L, N, KV, ps]; ``len`` [B] int32. Slots map virtual
    positions onto pages through a host-owned page table; page 0 is
    scratch: unallocated table entries point at it, over-capacity writes
    land there, and ``kv_len`` keeps reads of it out of every live row."""
    from .. import resolve_device

    device = resolve_device(device)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    if cfg.kv_quant:
        cache = _quant_cache(cfg, (L, n_pages), page_s, device)
    else:
        cache = {name: torch.zeros((L, n_pages, page_s, KV, hd),
                                   dtype=cfg.dtype, device=device)
                 for name in ("k", "v")}
    cache["len"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache


def _write_paged(cfg: LlamaConfig, cache: dict, layer: int, k, v, page, off
                 ) -> None:
    """Write K/V [N, KV, D] of N positions at pool coordinates (``page``
    [N], ``off`` [N]) of ``layer``, in place, quantizing at the config's
    precision. Index assignment, never an accumulating scatter: rows that
    share a scratch position (page 0) overwrite one another."""
    if not cfg.kv_quant:
        for name, x in (("k", k), ("v", v)):
            cache[name][layer][page, off] = x.to(cache[name].dtype)
        return
    heads = torch.arange(cfg.n_kv_heads, device=k.device)[None, :]
    for name, x in (("k", k), ("v", v)):
        codes, planes = kv_encode(cfg, x)
        cache[name][layer][page, off] = codes.reshape(x.shape[0], -1)
        for pl, val in planes.items():
            cache[f"{name}_{pl}"][layer][page[:, None], heads,
                                         off[:, None]] = val


def _gather_pages(cfg: LlamaConfig, cache: dict, layer: int, idx,
                  b: int) -> dict:
    """The pages ``idx`` [b * n] (row-major: each row's pages in table
    order) of ``layer``, copied out of the pool into one contiguous
    virtual sequence per row: values [b, n*ps, KV, D] (quantized [b, n*ps,
    KV*W]) and each plane [b, n, KV, ps]."""
    out = {}
    for name, arr in cache.items():
        if name == "len":
            continue
        pages = arr[layer].index_select(0, idx)
        if name in ("k", "v"):
            out[name] = pages.view(b, -1, *pages.shape[2:])
        else:
            out[name] = pages.view(b, -1, *pages.shape[1:])
    return out


def _virtual_kv(cfg: LlamaConfig, pages: dict):
    """Gathered pages (``_gather_pages``) -> K and V [b, S, KV, D] in
    ``cfg.dtype``: as they are for an fp pool, dequantized with the planes
    transposed to [b, S, KV] for a quantized one (JAX's ``virt``)."""
    if not cfg.kv_quant:
        return pages["k"], pages["v"]
    KV = cfg.n_kv_heads
    out = []
    for name in ("k", "v"):
        b = pages[name].shape[0]
        values = pages[name].view(b, -1, KV, kv_store_width(cfg))
        planes = {pl: pages[f"{name}_{pl}"].transpose(-1, -2).reshape(b, -1,
                                                                      KV)
                  for pl in kv_plane_names(cfg)}
        out.append(kv_decode(cfg, values, planes, cfg.dtype))
    return tuple(out)


@torch.no_grad()
def paged_prefill_into(params: dict, tokens, seq_lens, cfg: LlamaConfig,
                       cache: dict, table_row, slot, page_s: int,
                       set_len: bool = True) -> tuple[torch.Tensor, dict]:
    """Prefill ONE prompt [1, S_pad] (the flash kernel through
    ``_prefill_layers``) and write its K/V, page-sized slab by slab, into
    the pages ``table_row`` [S_pad // page_s] (host ints) names, in place:
    one index assignment a cache array a layer. Entries past the prompt
    point at scratch page 0, so whole-page writes need no mask.
    ``set_len=False`` fills pages without admitting a slot (a prefix
    build). Returns (last-token logits [1, V], cache)."""
    dev = params["embed"].device
    tokens, seq_lens = _tokens(tokens, cfg, dev), _int32(seq_lens, dev)
    n_pg = tokens.shape[1] // page_s
    pages = _int32(np.asarray(table_row)[:n_pg], dev).long()
    span = n_pg * page_s

    def write(layer, k, v):
        for name, (new, axis) in _kv_planes(cfg, k, v).items():
            row = new[0].narrow(axis, 0, span)
            if axis == 0:    # values [S, ...] -> [n_pg, ps, ...]
                slabs = row.reshape(n_pg, page_s, *row.shape[1:])
            else:            # planes [KV, S] -> [n_pg, KV, ps]
                slabs = row.reshape(row.shape[0], n_pg, page_s).transpose(0, 1)
            cache[name][layer][pages] = slabs

    logits = _prefill_layers(params, tokens, seq_lens, cfg, write)
    if set_len:
        cache["len"][int(slot)] = seq_lens[0]
    return logits, cache


@torch.no_grad()
def paged_suffix_prefill(params: dict, tokens, seq_lens, cfg: LlamaConfig,
                         cache: dict, table_row, start, page_s: int
                         ) -> tuple[torch.Tensor, dict]:
    """Prefill ONE segment [1, S_pad] at virtual positions
    ``start..start+S_pad-1`` of a paged slot (in place): a shared prefix's
    suffix (``start`` = the shared length) or a chunked-prefill segment.
    Each layer writes the segment's K/V through ``table_row`` [P_max]
    (positions past virtual capacity go to scratch page 0), gathers the
    slot's pages that the segment can see (through ``start + S_pad``) into
    a virtual sequence, dequantizing int8 and int4 pages as JAX does, and
    attends it through the flash kernel, causally from ``q_offset=start``.
    Rows beyond ``seq_lens`` write positions decode overwrites before any
    read reaches them. ``start`` is a host int. Returns (logits of the last
    valid token [1, V], cache); ``len`` is the caller's to set."""
    dev = params["embed"].device
    tokens = _tokens(tokens, cfg, dev)
    if tokens.shape[0] != 1:
        raise ValueError("paged_suffix_prefill takes one row")
    s = tokens.shape[1]
    start = int(start)
    row = np.asarray(table_row, np.int64).reshape(-1)
    p_max = len(row)
    vpos = start + np.arange(s)
    page = np.where(vpos < p_max * page_s,
                    row[np.minimum(vpos // page_s, p_max - 1)], 0)
    n_virt = min(p_max, -(-(start + s) // page_s))
    idx = _int32(np.concatenate([page, vpos % page_s, row[:n_virt]]),
                 dev).long()
    page_d, off_d, virt = idx[:s], idx[s:2 * s], idx[2 * s:]
    cos, sin = rope_table(torch.arange(start, start + s, device=dev)[None],
                          cfg.head_dim, cfg.rope_theta,
                          scaling=cfg.rope_scaling)
    x = _embed(params, tokens, cfg)
    for layer in range(cfg.n_layers):
        lp = _layer_params(params, layer)
        q, k, v = _qkv(cfg, x, lp, cos, sin)
        _write_paged(cfg, cache, layer, k[0], v[0], page_d, off_d)
        k_virt, v_virt = _virtual_kv(cfg, _gather_pages(cfg, cache, layer,
                                                        virt, 1))
        o = flash_attention(q.contiguous(), k_virt, v_virt, causal=True,
                            q_offset=start)
        x = _block_out(cfg, x, o, lp)
    last = int(np.asarray(seq_lens).reshape(-1)[0]) - 1
    return _logits_at(params, cfg, x, last), cache


def _paged_attention(cfg: LlamaConfig, q, cache: dict, layer: int, virt,
                     kv_len):
    """Decode attention of q [B, 1, H, D] (or a verify window [B, W, H,
    D]) over each row's gathered pages (``virt`` [B * n]): an int8 pool
    goes to the int8 decode kernel with the values flat [B, S, KV*D] and
    the scales transposed to [B, KV, S]; a bf16 pool, and an int4 pool
    dequantized, to the bf16 one."""
    b = q.shape[0]
    pages = _gather_pages(cfg, cache, layer, virt, b)
    if cfg.kv_bits == 8:
        scales = {f"{name}_scale": pages[f"{name}_scale"].transpose(1, 2)
                  .reshape(b, cfg.n_kv_heads, -1) for name in ("k", "v")}
        return cached_decode_attention(q, pages["k"], pages["v"], kv_len,
                                       **scales)
    k_virt, v_virt = _virtual_kv(cfg, pages)
    return cached_decode_attention(q, k_virt, v_virt, kv_len)


@torch.no_grad()
def paged_decode_step(params: dict, tokens, cache: dict, table,
                      cfg: LlamaConfig, n_cols: int | None = None
                      ) -> tuple[torch.Tensor, dict]:
    """One token per row against the page pool: tokens [B] -> (f32 logits
    [B, V], cache). ``table`` [B, P_max] int32 (a device tensor, or host
    ints) maps each row's virtual pages in order. The new token's K/V go to
    ``(table[b, pos // ps], pos % ps)``; a row at virtual capacity writes
    into scratch page 0. Attention gathers the first ``n_cols`` table
    columns of every row (all of them by default) into a virtual
    [B, n_cols * ps] sequence for the decode kernel; ``kv_len = pos + 1``
    masks the rest, so any ``n_cols`` that covers every live row gives the
    same result. The pool is updated in place, ``len`` too (capped at
    P_max * ps): a CUDA graph of the step keeps its pointers."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens).to(dev)
    if not torch.is_tensor(table):
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("paged_decode_step under CUDA graph capture "
                               "needs the page table as a device tensor")
        table = _int32(table, dev)
    b = tokens.shape[0]
    page_s = cache["k"].shape[2]
    p_max = table.shape[1]
    n = p_max if n_cols is None else max(1, min(int(n_cols), p_max))
    pos = cache["len"]
    s_virt = p_max * page_s
    col = torch.clamp(pos // page_s, max=p_max - 1).long()
    page = torch.where(pos < s_virt, table.gather(1, col[:, None])[:, 0],
                       0).long()
    off = (pos % page_s).long()
    virt = table[:, :n].reshape(-1)
    kv_len = pos + 1
    x = _embed(params, tokens, cfg)[:, None, :]
    cos, sin = rope_table(pos[:, None], cfg.head_dim, cfg.rope_theta,
                          scaling=cfg.rope_scaling)
    for layer in range(cfg.n_layers):
        lp = _layer_params(params, layer)
        q, k, v = _qkv(cfg, x, lp, cos, sin)
        _write_paged(cfg, cache, layer, k[:, 0], v[:, 0], page, off)
        o = _paged_attention(cfg, q.contiguous(), cache, layer, virt, kv_len)
        x = _block_out(cfg, x, o, lp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _mm(x[:, 0], params["lm_head"]).float()
    cache["len"].copy_(torch.clamp(kv_len, max=s_virt))
    return logits, cache


@torch.no_grad()
def paged_decode_window(params: dict, tokens, cache: dict, table,
                        cfg: LlamaConfig, n_cols: int | None = None
                        ) -> tuple[torch.Tensor, dict]:
    """``decode_window`` against the page pool (JAX's
    ``paged_decode_window``): tokens [B, W] at each row's virtual
    positions ``len .. len+W-1``; K/V rows go through the row's page table
    (a cell past virtual capacity into scratch page 0), quantized on write
    for int8 and int4 pages; attention gathers the first ``n_cols`` table
    columns (all by default) and attends position t over the first
    ``len + 1 + t``, through the decode kernels' window launch (int4 pages
    dequantized to bf16 first, as the decode step does). ``len`` is NOT
    advanced. ``table`` as ``paged_decode_step`` takes it. Returns (f32
    logits [B, W, V], cache)."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens).to(dev)
    if not torch.is_tensor(table):
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("paged_decode_window under CUDA graph capture "
                               "needs the page table as a device tensor")
        table = _int32(table, dev)
    b, w = tokens.shape
    page_s = cache["k"].shape[2]
    p_max = table.shape[1]
    n = p_max if n_cols is None else max(1, min(int(n_cols), p_max))
    pos0, positions = _window_positions(cache, w)
    col = torch.clamp(positions // page_s, max=p_max - 1).long()
    page = torch.where(positions < p_max * page_s, table.gather(1, col),
                       0).long().reshape(-1)
    off = (positions % page_s).long().reshape(-1)
    virt = table[:, :n].reshape(-1)
    kv_len = pos0 + 1
    x = _embed(params, tokens, cfg)
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta,
                          scaling=cfg.rope_scaling)
    for layer in range(cfg.n_layers):
        lp = _layer_params(params, layer)
        q, k, v = _qkv(cfg, x, lp, cos, sin)
        _write_paged(cfg, cache, layer, k.reshape(b * w, *k.shape[2:]),
                     v.reshape(b * w, *v.shape[2:]), page, off)
        o = _paged_attention(cfg, q.contiguous(), cache, layer, virt, kv_len)
        x = _block_out(cfg, x, o, lp)
    return _window_logits(params, cfg, x), cache
