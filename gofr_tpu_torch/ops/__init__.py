"""Core tensor ops, PyTorch counterparts of ``gofr_tpu/ops/__init__.py``.

Two tiers, as in the JAX package:

- plain PyTorch versions (this file): the arithmetic of the JAX reference,
  run on any device; the CPU tests hold them against the JAX functions;
- hand-written CUDA kernels (``flash_attention.py``, ``decode_attention.py``
  with sources in ``csrc/``) behind the two dispatchers at the bottom; the
  decode dispatcher takes an fp cache or an int8 cache with its scales,
  and one token a row or a speculative verify window; the flash
  dispatcher is differentiable (``_FlashDiff``: the kernel forward, the
  plain version's backward), so training runs through the kernel.

The dispatchers take no gate on shapes: a CUDA tensor always goes through
its kernel (which masks its own ragged edges), a CPU tensor always goes to
the plain version. There is no fallback from one to the other.

Everything is shaped [batch, seq, heads, head_dim] ("BSHD"), as in JAX.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "NEG_INF",
    "rms_norm",
    "layer_norm",
    "gelu",
    "scale_rope_freqs",
    "rope_table",
    "apply_rope",
    "repeat_kv",
    "attention",
    "gqa_decode_attention",
    "swiglu",
    "quantize_kv",
    "dequantize_kv",
    "quantize_kv4",
    "dequantize_kv4",
    "quantize_weight",
    "flash_attention",
    "cached_decode_attention",
]

# finite mask value (not -inf): a fully masked row (padded wave rows, dead
# slots) softmaxes to a uniform row instead of NaN — the JAX convention
NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with f32 statistics, cast back to the input dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm with f32 statistics (BERT-family encoders), cast back to
    the input dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default
    is the exact erf form, which would drift every BERT and DiT layer)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def scale_rope_freqs(freqs: torch.Tensor, scaling: dict) -> torch.Tensor:
    """Apply a HF ``rope_scaling`` spec (``llama3`` NTK-by-parts or
    ``linear``) to the base rotary frequencies; anything else raises."""
    rtype = str(scaling.get("rope_type") or scaling.get("type") or "").lower()
    if rtype == "linear":
        return freqs / float(scaling["factor"])
    if rtype != "llama3":
        raise ValueError(
            f"unsupported rope_scaling type {rtype!r}; "
            "supported: 'llama3', 'linear'")
    factor = float(scaling.get("factor", 8.0))
    low_ff = float(scaling.get("low_freq_factor", 1.0))
    high_ff = float(scaling.get("high_freq_factor", 4.0))
    orig = float(scaling.get("original_max_position_embeddings", 8192))
    wavelen = 2.0 * math.pi / freqs
    smooth = ((orig / wavelen - low_ff) / (high_ff - low_ff)).clamp(0.0, 1.0)
    scaled = (1.0 - smooth) * freqs / factor + smooth * freqs
    return torch.where(wavelen < orig / high_ff, freqs,
                       torch.where(wavelen > orig / low_ff, freqs / factor,
                                   scaled))


def rope_table(positions: torch.Tensor, head_dim: int, theta: float = 500_000.0,
               scaling: dict | None = None):
    """cos/sin tables [..., head_dim // 2] in float32 for integer
    ``positions`` [...]."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    if scaling is not None:
        freqs = scale_rope_freqs(freqs, scaling)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate (x[..., :half], x[..., half:]) — the rotate-half convention —
    in f32. x: [..., seq, heads, head_dim]; cos/sin: [..., seq, half]."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def repeat_kv(kv: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: expand [B, S, n_kv, D] -> [B, S, n_kv * n_rep, D]."""
    if n_rep == 1:
        return kv
    b, s, h, d = kv.shape
    return kv[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int | torch.Tensor = 0,
              kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """Reference softmax attention, BSHD, f32 logits.

    q: [B, Tq, H, D]; k, v: [B, Tk, H, D] (``repeat_kv`` first for GQA).
    ``q_offset`` is the absolute position of q[0]: an int, or a [B] tensor
    when rows sit at different positions. ``kv_len`` [B] masks key slots at
    and beyond each row's valid length.
    """
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    tq, tk = q.shape[1], k.shape[1]
    kpos = torch.arange(tk, device=q.device)
    mask = None
    if causal:
        if isinstance(q_offset, torch.Tensor) and q_offset.dim() == 1:
            qpos = q_offset[:, None] + torch.arange(tq, device=q.device)[None, :]
            mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]  # [B,1,Tq,Tk]
        else:
            qpos = torch.arange(tq, device=q.device) + q_offset
            mask = (kpos[None, :] <= qpos[:, None])[None, None]  # [1,1,Tq,Tk]
    if kv_len is not None:
        valid = (kpos[None, :] < kv_len[:, None])[:, None, None, :]  # [B,1,1,Tk]
        mask = valid if mask is None else mask & valid
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def gqa_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, kv_len: torch.Tensor) -> torch.Tensor:
    """Grouped-query attention straight off the un-expanded cache.

    q: [B, Tq, H, D]; caches: [B, S_max, KV, D]; kv_len: [B]. Query heads
    fold to [KV, n_rep] and contract against the grouped cache. A ``kv_len``
    above S_max attends the whole row, the same as S_max.
    """
    b, tq, h, d = q.shape
    kv = k_cache.shape[2]
    if h == kv:
        return attention(q, k_cache, v_cache, causal=False, kv_len=kv_len)
    qg = q.reshape(b, tq, kv, h // kv, d)
    logits = torch.einsum("bqkrd,bskd->bkrqs", qg.float(), k_cache.float()) * d ** -0.5
    valid = (torch.arange(k_cache.shape[1], device=q.device)[None, :]
             < kv_len[:, None])
    logits = logits.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrqs,bskd->bqkrd", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, tq, h, d).to(q.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: silu(x @ w_gate) * (x @ w_up) @ w_down."""
    g = torch.nn.functional.silu(x @ w_gate)
    return (g * (x @ w_up)) @ w_down


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-vector int8 quantization over the last (head_dim)
    axis: (int8 values, bf16 scales with the last axis dropped). As in the
    JAX code, the values divide by the f32 scale and only then is the scale
    rounded to bf16; codes round half to even and clip to +-127."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale.float()[..., None]).to(dtype)


def quantize_kv4(x: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Asymmetric per-vector int4 quantization over the last (head_dim)
    axis, two codes packed per byte: (packed uint8 with the last axis
    halved, bf16 scales, bf16 zero points, both with the last axis
    dropped). Codes 0..15 are ``round((x - lo) / scale)`` in f32, rounded
    half to even and clipped, as in the JAX code; the even code takes the
    low nibble."""
    xf = x.float()
    lo = xf.amin(dim=-1)
    hi = xf.amax(dim=-1)
    scale = torch.clamp(hi - lo, min=1e-6) / 15.0
    codes = torch.clamp(torch.round((xf - lo[..., None]) / scale[..., None]),
                        0, 15).to(torch.uint8)
    packed = codes[..., ::2] | (codes[..., 1::2] << 4)
    return packed, scale.to(torch.bfloat16), lo.to(torch.bfloat16)


def dequantize_kv4(packed: torch.Tensor, scale: torch.Tensor,
                   zero: torch.Tensor,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of ``quantize_kv4``: unpack the nibbles (the last axis
    doubles back) and apply ``code * scale + zero`` in f32."""
    codes = torch.stack([packed & 0xF, packed >> 4], dim=-1).reshape(
        *packed.shape[:-1], packed.shape[-1] * 2)
    return (codes.float() * scale.float()[..., None]
            + zero.float()[..., None]).to(dtype)


def quantize_weight(w: torch.Tensor, eps: float = 1e-8
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 weight quantization (w8a16): the
    f32 scale reduces over the contraction axis (second-to-last), so
    ``x @ W == (x @ q) * s``. No clip, and ``eps`` floors the scale after
    the division by 127, as in the JAX code."""
    wf = w.float()
    s = torch.clamp(wf.abs().amax(dim=-2, keepdim=True) / 127.0, min=eps)
    return torch.round(wf / s).to(torch.int8), s.squeeze(-2)


# The kernel modules share their names with the dispatchers below: import
# them first, so the dispatcher functions (defined after) are what
# ``ops.flash_attention`` and ``ops.cached_decode_attention`` name.
from .decode_attention import (gqa_decode_attention_cuda,  # noqa: E402
                               gqa_decode_attention_int8_cuda,
                               gqa_decode_attention_int8_plain,
                               gqa_decode_attention_plain,
                               gqa_decode_window_cuda,
                               gqa_decode_window_int8_cuda,
                               gqa_decode_window_int8_plain,
                               gqa_decode_window_plain)
from .flash_attention import (flash_attention_cuda,  # noqa: E402
                              flash_attention_plain)


class _FlashDiff(torch.autograd.Function):
    """The flash kernel under autograd, the counterpart of JAX's
    ``_flash_diff`` (``custom_vjp``): the forward launches the hand-written
    kernel, the backward recomputes attention through the plain version
    and returns ITS vector-Jacobian product. Flash forward speed,
    standard-attention backward: the [Tq, Tk] logits materialise in the
    backward, so long-sequence training pairs this with
    ``LlamaConfig(remat=True)``. The kernel writes its output through
    ``ctypes``, so without this Function a loss through it would carry no
    gradient to q, k or v."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, q_offset):
        ctx.save_for_backward(q, k, v, kv_len)
        ctx.causal, ctx.q_offset = causal, q_offset
        return flash_attention_cuda(q, k, v, kv_len, causal=causal,
                                    q_offset=q_offset)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_len = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = flash_attention_plain(*qkv, kv_len, causal=ctx.causal,
                                        q_offset=ctx.q_offset)
        dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    kv_len=None):
    """Prefill attention over GROUPED K/V [B, Tk, KV, D] (KV divides H).

    A CUDA tensor goes through the hand-written kernel, which reads the
    grouped K/V directly (no ``repeat_kv``): under autograd, when grad is
    on and an input requires it, through ``_FlashDiff`` (the kernel's
    forward, the plain version's backward). A CPU tensor goes to the plain
    version, ``attention`` over ``repeat_kv``-expanded K/V, which autograd
    differentiates as it is.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_len, causal=causal,
                                     q_offset=q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashDiff.apply(q, k, v, kv_len, causal, q_offset)
    return flash_attention_cuda(q, k, v, kv_len, causal=causal,
                                q_offset=q_offset)


def cached_decode_attention(q, k_cache, v_cache, kv_len, *, layer: int = 0,
                            k_scale=None, v_scale=None):
    """Decode attention over the STACKED cache at ``layer``: the CUDA
    kernel for a CUDA tensor (it reads the layer's slab in place and only
    the live positions), the plain version for a CPU tensor.

    q is one token a row [B, 1, H, D] (a decode step: attends the first
    ``kv_len`` positions), or a speculative verify window [B, W, H, D] with
    W > 1 (position t attends the first ``kv_len + t``, JAX's
    ``attention(..., causal=True, q_offset=kv_len - 1)``). An fp cache is
    [L, B, S_max, KV, D]. With ``k_scale``/``v_scale`` the cache is int8,
    stored FLAT [L, B, S_max, KV*D] with bf16 scales seq-minor
    [L, B, KV, S_max] (the JAX package's layouts), and goes to the int8
    kernel or its plain version."""
    cpu = q.device.type == "cpu"
    window = q.shape[1] > 1
    if k_scale is None:
        if window:
            fn = gqa_decode_window_plain if cpu else gqa_decode_window_cuda
        else:
            fn = gqa_decode_attention_plain if cpu else gqa_decode_attention_cuda
        return fn(q, k_cache, v_cache, kv_len, layer=layer)
    if window:
        fn = (gqa_decode_window_int8_plain if cpu
              else gqa_decode_window_int8_cuda)
    else:
        fn = (gqa_decode_attention_int8_plain if cpu
              else gqa_decode_attention_int8_cuda)
    return fn(q, k_cache, v_cache, kv_len, layer=layer, k_scale=k_scale,
              v_scale=v_scale)
