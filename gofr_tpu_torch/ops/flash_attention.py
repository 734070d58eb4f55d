"""Flash prefill attention: the CUDA kernel, its wrapper and its plain version.

Replaces the Pallas TPU kernel ``gofr_tpu/ops/flash_attention.py``
(``flash_attention_tpu``). The kernel (``csrc/flash_attention.cu``) is a
Hopper kernel: TMA loads from a producer warpgroup into a ring of K/V
tiles, ``wgmma`` for Q K^T and P V in two consumer warpgroups. It is
bounded by memory traffic and latency at the 512-token wave and by
tensor-core throughput at 2048-token prompts; its source note says how its
design answers both. ``flash_attention_cuda.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import attention, repeat_kv
from ._build import library

__all__ = ["flash_attention_cuda", "flash_attention_plain"]

_HEAD_DIMS = (16, 64, 128)
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = library("flash_attention")
        lib.gofr_flash_attention.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.gofr_flash_attention.restype = ctypes.c_int
        _lib = lib
    return _lib


def flash_attention_plain(q, k, v, kv_len=None, *, causal: bool = True,
                          q_offset: int = 0):
    """The kernel's function in plain PyTorch: ``attention`` over
    ``repeat_kv``-expanded K/V. q: [B, Tq, H, D]; k, v: [B, Tk, KV, D]."""
    n_rep = q.shape[2] // k.shape[2]
    return attention(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                     causal=causal, q_offset=q_offset, kv_len=kv_len)


def flash_attention_cuda(q, k, v, kv_len=None, *, causal: bool = True,
                         q_offset: int = 0):
    """Launch the CUDA flash kernel. q: [B, Tq, H, D]; k, v: [B, Tk, KV, D]
    with KV dividing H (grouped, not expanded); kv_len: optional int32 [B].
    All on one CUDA device, bf16, contiguous, q/k/v at 16-byte-aligned
    addresses (the kernel's TMA loads need them). Returns [B, Tq, H, D]
    bf16. Raises on anything the kernel does not take."""
    tensors = [("q", q), ("k", k), ("v", v)]
    if kv_len is not None:
        tensors.append(("kv_len", kv_len))
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention_cuda: {name} must be on "
                             f"{q.device} (CUDA), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_cuda: {name} must be contiguous")
    for name, t in tensors[:3]:
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention_cuda: {name} must be bfloat16, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} must start at a "
                             "16-byte-aligned address")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_cuda: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, tq, h, d = q.shape
    _, tk, kv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or h % kv:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head_dim {d} not in {_HEAD_DIMS}")
    if kv_len is not None and (kv_len.dtype != torch.int32 or kv_len.shape != (b,)):
        raise ValueError("flash_attention_cuda: kv_len must be int32 [B]")
    if not isinstance(q_offset, int):
        raise ValueError("flash_attention_cuda: q_offset must be a Python int")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel().gofr_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kv_len.data_ptr() if kv_len is not None else None, out.data_ptr(),
            b, tq, tk, h, kv, d, int(causal), q_offset, stream)
    if err:
        raise RuntimeError(
            f"flash_attention kernel launch failed: error {err} (a "
            "cudaError_t, or 10000 + the CUresult of a tensor map)")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
