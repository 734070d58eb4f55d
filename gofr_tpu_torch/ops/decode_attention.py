"""GQA decode attention: the CUDA kernel, its wrapper and its plain version.

Replaces the Pallas TPU kernel ``gofr_tpu/ops/decode_attention.py``
(``gqa_decode_attention_tpu`` over the fp cache). The kernel
(``csrc/decode_attention.cu``) is bounded by the bytes of the live cache
prefix; it splits each row's cache over CTAs (flash-decoding) so a small
slot count still fills the card, reads the stacked cache in place at
``layer``, and clamps ``kv_len`` to S_max. ``gqa_decode_attention_cuda
.launches`` counts kernel launches (one per call: split and combine pass).
"""

from __future__ import annotations

import ctypes

import torch

from . import gqa_decode_attention
from ._build import library

__all__ = ["gqa_decode_attention_cuda", "gqa_decode_attention_plain"]

_HEAD_DIMS = (16, 64, 128)
_N_REPS = (1, 2, 4, 8)
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = library("decode_attention")
        lib.gofr_gqa_decode_attention.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.gofr_gqa_decode_attention.restype = ctypes.c_int
        lib.gofr_decode_split_len.argtypes = []
        lib.gofr_decode_split_len.restype = ctypes.c_int
        _lib = lib
    return _lib


def _stacked(k_cache, v_cache, layer: int):
    if k_cache.dim() == 4:  # one layer's [B, S, KV, D]
        return k_cache[None], v_cache[None], 0
    return k_cache, v_cache, layer


def gqa_decode_attention_plain(q, k_cache, v_cache, kv_len, *, layer: int = 0):
    """The kernel's function in plain PyTorch. q: [B, 1, H, D]; caches:
    stacked [L, B, S_max, KV, D] (or one layer's [B, S_max, KV, D]);
    kv_len [B] (above S_max attends the whole row)."""
    k_cache, v_cache, layer = _stacked(k_cache, v_cache, layer)
    return gqa_decode_attention(q, k_cache[layer], v_cache[layer], kv_len)


def gqa_decode_attention_cuda(q, k_cache, v_cache, kv_len, *, layer: int = 0):
    """Launch the CUDA decode kernel. q: [B, 1, H, D] bf16; caches: stacked
    [L, B, S_max, KV, D] bf16 (or [B, S_max, KV, D]); kv_len: int32 [B];
    ``layer`` a Python int. All on one CUDA device, contiguous. Returns
    [B, 1, H, D] bf16. Raises on anything the kernel does not take."""
    k_cache, v_cache, layer = _stacked(k_cache, v_cache, layer)
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("kv_len", kv_len)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"gqa_decode_attention_cuda: {name} must be on "
                             f"{q.device} (CUDA), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"gqa_decode_attention_cuda: {name} must be contiguous")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"gqa_decode_attention_cuda: {name} must be "
                             f"bfloat16, got {t.dtype}")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"gqa_decode_attention_cuda: q must be [B, 1, H, D], "
                         f"got {tuple(q.shape)}")
    n_layers, b, s_max, kv, d = k_cache.shape
    h = q.shape[2]
    if (v_cache.shape != k_cache.shape or q.shape[0] != b or q.shape[3] != d
            or h % kv):
        raise ValueError(f"gqa_decode_attention_cuda: q {tuple(q.shape)} does "
                         f"not match caches {tuple(k_cache.shape)}")
    if d not in _HEAD_DIMS or h // kv not in _N_REPS:
        raise ValueError(f"gqa_decode_attention_cuda: head_dim {d} / n_rep "
                         f"{h // kv} not in {_HEAD_DIMS} / {_N_REPS}")
    if kv_len.dtype != torch.int32 or kv_len.shape != (b,):
        raise ValueError("gqa_decode_attention_cuda: kv_len must be int32 [B]")
    if not isinstance(layer, int) or not 0 <= layer < n_layers:
        raise ValueError(f"gqa_decode_attention_cuda: layer {layer!r} out of "
                         f"range for {n_layers} layers")
    lib = _kernel()
    n_rep = h // kv
    n_splits = -(-s_max // lib.gofr_decode_split_len())
    part_acc = torch.empty((b, kv, n_splits, n_rep, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, kv, n_splits, n_rep, 2), dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gofr_gqa_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            kv_len.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            out.data_ptr(), b, s_max, kv, n_rep, d, layer, n_splits, stream)
    if err:
        raise RuntimeError(f"decode attention kernel launch failed: cudaError_t {err}")
    gqa_decode_attention_cuda.launches += 1
    return out


gqa_decode_attention_cuda.launches = 0
