"""GQA decode attention: the CUDA kernels, their wrappers and their plain
versions, for an fp cache and for an int8 cache.

Replaces the Pallas TPU kernel ``gofr_tpu/ops/decode_attention.py``
(``gqa_decode_attention_tpu``: ``_decode_kernel`` over the fp cache and
``_decode_kernel_quant`` over the int8 one). Both kernels
(``csrc/decode_attention.cu``) are bounded by the bytes of the live cache
prefix. Each call is one launch: the grid splits every row's cache over
CTAs (``split_plan``) so a few slots still fill the card, each CTA streams
its tiles through a shared-memory ring with an online softmax on the
tensor cores, and the splits of a row and KV head form one thread-block
cluster that merges them through distributed shared memory (no scratch in
HBM, no state between calls). The stacked cache is
read in place at ``layer`` and ``kv_len`` is clamped to S_max on the
device. The int8 kernel reads the flat int8 values and the bf16 seq-minor
scales and folds the scales into the scores and the probabilities, so only
int8 and the scales leave HBM.
``gqa_decode_attention_cuda.launches`` and
``gqa_decode_attention_int8_cuda.launches`` count kernel launches (one per
call).

The verify window of speculative decoding (q [B, W, H, D], position t of
row b attending the first ``kv_len[b] + t`` positions) is the same kernel
with more query rows in its tiles: ``gqa_decode_window_cuda`` and
``gqa_decode_window_int8_cuda`` launch it over the bf16 and the int8 cache,
one launch per block of up to ``MAX_ROWS`` query rows (window positions
times n_rep) of a KV head, and count their launches the same way. JAX
computes the window with its plain ``attention`` and a per-row
``q_offset`` (``gofr_tpu/models/llama.py:1404-1406, 1504-1506``); the
plain versions here are exactly that.
"""

from __future__ import annotations

import ctypes

import torch

from . import attention, dequantize_kv, gqa_decode_attention, repeat_kv
from ._build import library

__all__ = ["gqa_decode_attention_cuda", "gqa_decode_attention_plain",
           "gqa_decode_attention_int8_cuda", "gqa_decode_attention_int8_plain",
           "gqa_decode_window_cuda", "gqa_decode_window_plain",
           "gqa_decode_window_int8_cuda", "gqa_decode_window_int8_plain",
           "split_plan"]

_HEAD_DIMS = (16, 64, 128)
_N_REPS = (1, 2, 4, 8)
# positions per staged tile, per CTA at most, splits (one cluster) per row
# at most, and query rows (window positions x n_rep) per launch at most, as
# csrc/decode_attention.cu has them (checked on load)
TILE, MAX_SPAN, MAX_SPLITS, MAX_ROWS = 64, 8192, 8, 32
_lib = None
_sms: dict = {}


def _kernel():
    global _lib
    if _lib is None:
        lib = library("decode_attention")
        lib.gofr_gqa_decode_attention.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.gofr_gqa_decode_attention.restype = ctypes.c_int
        lib.gofr_gqa_decode_attention_int8.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.gofr_gqa_decode_attention_int8.restype = ctypes.c_int
        lib.gofr_gqa_decode_window.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        lib.gofr_gqa_decode_window.restype = ctypes.c_int
        lib.gofr_gqa_decode_window_int8.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        lib.gofr_gqa_decode_window_int8.restype = ctypes.c_int
        limits = (lib.gofr_decode_tile_len, lib.gofr_decode_max_span,
                  lib.gofr_decode_max_splits, lib.gofr_decode_max_rows)
        for fn in limits:
            fn.argtypes, fn.restype = [], ctypes.c_int
        if tuple(fn() for fn in limits) != (TILE, MAX_SPAN, MAX_SPLITS,
                                            MAX_ROWS):
            raise RuntimeError("decode_attention library and wrapper disagree "
                               "on the tile, the span, the splits or the "
                               "rows")
        _lib = lib
    return _lib


def split_plan(b: int, kv: int, s_max: int, n_sm: int) -> tuple[int, int]:
    """(span, n_splits) of one launch: CTAs per row and KV head (one
    cluster, at most ``MAX_SPLITS``) and the most positions one of them
    takes (a multiple of ``TILE``, at most ``MAX_SPAN``). The grid
    (KV, B, n_splits) holds about 2 CTAs per SM: a power of two of splits,
    no more than S_max has tiles. Split k takes the tiles k, k + n_splits,
    ... of each row's live prefix. Raises for an S_max past
    ``MAX_SPLITS * MAX_SPAN``."""
    if s_max > MAX_SPLITS * MAX_SPAN:
        raise ValueError(f"decode attention: S_max {s_max} above "
                         f"{MAX_SPLITS * MAX_SPAN}")
    tiles = -(-s_max // TILE)
    want = max(1, 2 * n_sm // (b * kv))
    n_splits = min(MAX_SPLITS, tiles, 1 << (want.bit_length() - 1))
    n_splits = max(n_splits, -(-tiles * TILE // MAX_SPAN))
    return -(-tiles // n_splits) * TILE, n_splits


def _n_sm(device) -> int:
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device]


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


def _check_tensors(name: str, q, tensors, window: bool = False) -> None:
    """Each (what, tensor, dtype) on q's CUDA device, contiguous and of its
    dtype (None: checked elsewhere); q one token per row, or with
    ``window`` [B, W, H, D]."""
    for what, t, dtype in tensors:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: {what} must be on {q.device} (CUDA), "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name}: {what} must be {dtype}, got {t.dtype}")
    if q.dim() != 4 or (q.shape[1] != 1 and not window) or q.shape[1] < 1:
        shape = "[B, W, H, D]" if window else "[B, 1, H, D]"
        raise ValueError(f"{name}: q must be {shape}, got {tuple(q.shape)}")


def _launch(name: str, entry: str, q, caches, kv_len, *, n_layers: int,
            s_max: int, kv: int, layer: int) -> tuple:
    """The checks every kernel shares (head_dim, n_rep, kv_len, layer),
    then the output and the launches of ``entry`` on the current stream:
    (q, *caches, kv_len, out, sizes, stream), with a window entry's
    (W, w0, wn) after the sizes for each block of window positions.
    Returns (out, launches)."""
    b, w, h, d = q.shape
    if d not in _HEAD_DIMS or h // kv not in _N_REPS:
        raise ValueError(f"{name}: head_dim {d} / n_rep {h // kv} not in "
                         f"{_HEAD_DIMS} / {_N_REPS}")
    if kv_len.dtype != torch.int32 or kv_len.shape != (b,):
        raise ValueError(f"{name}: kv_len must be int32 [B]")
    if not isinstance(layer, int) or not 0 <= layer < n_layers:
        raise ValueError(f"{name}: layer {layer!r} out of range for "
                         f"{n_layers} layers")
    if q.data_ptr() % 16:
        raise ValueError(f"{name}: q must be 16-byte aligned")
    lib = _kernel()
    n_rep = h // kv
    span, n_splits = split_plan(b, kv, s_max, _n_sm(q.device))
    out = torch.empty_like(q)
    window = "window" in entry
    # a window's positions in blocks of MAX_ROWS query rows a KV head
    per = MAX_ROWS // n_rep
    blocks = [(w0, min(per, w - w0)) for w0 in range(0, w, per)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        for w0, wn in blocks if window else [(0, 1)]:
            extra = (w, w0, wn) if window else ()
            err = getattr(lib, entry)(
                q.data_ptr(), *(t.data_ptr() for t in caches),
                kv_len.data_ptr(), out.data_ptr(), b, s_max, kv, n_rep, d,
                layer, span, n_splits, *extra, stream)
            if err:
                raise RuntimeError(
                    f"{name}: kernel launch failed: cudaError_t {err}")
    return out, len(blocks) if window else 1


def _fp_launch(name: str, entry: str, q, k_cache, v_cache, kv_len,
               layer: int, window: bool) -> tuple:
    """Check and launch a bf16-cache entry; returns (out, launches)."""
    k_cache, v_cache, layer = _stacked(k_cache, v_cache, layer)
    _check_tensors(name, q, (("q", q, torch.bfloat16),
                             ("k_cache", k_cache, torch.bfloat16),
                             ("v_cache", v_cache, torch.bfloat16),
                             ("kv_len", kv_len, None)), window)
    n_layers, b, s_max, kv, d = k_cache.shape
    if (v_cache.shape != k_cache.shape or q.shape[0] != b or q.shape[3] != d
            or q.shape[2] % kv):
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match caches "
                         f"{tuple(k_cache.shape)}")
    return _launch(name, entry, q, (k_cache, v_cache), kv_len,
                   n_layers=n_layers, s_max=s_max, kv=kv, layer=layer)


def gqa_decode_attention_cuda(q, k_cache, v_cache, kv_len, *, layer: int = 0):
    """Launch the CUDA decode kernel. q: [B, 1, H, D] bf16; caches: stacked
    [L, B, S_max, KV, D] bf16 (or [B, S_max, KV, D]); kv_len: int32 [B];
    ``layer`` a Python int. All on one CUDA device, contiguous. Returns
    [B, 1, H, D] bf16. Raises on anything the kernel does not take."""
    out, n = _fp_launch("gqa_decode_attention_cuda",
                        "gofr_gqa_decode_attention", q, k_cache, v_cache,
                        kv_len, layer, False)
    gqa_decode_attention_cuda.launches += n
    return out


gqa_decode_attention_cuda.launches = 0


def gqa_decode_window_plain(q, k_cache, v_cache, kv_len, *, layer: int = 0):
    """The verify window's attention in plain PyTorch, as JAX's
    ``decode_window`` computes it: ``attention(q, repeat_kv(k),
    repeat_kv(v), causal=True, q_offset=kv_len - 1)`` over the layer's
    whole cache row. q: [B, W, H, D]; caches as ``gqa_decode_attention_plain``
    takes them; position t of row b attends the first ``kv_len[b] + t``
    positions."""
    k_cache, v_cache, layer = _stacked(k_cache, v_cache, layer)
    n_rep = q.shape[2] // k_cache.shape[3]
    return attention(q, repeat_kv(k_cache[layer], n_rep),
                     repeat_kv(v_cache[layer], n_rep), causal=True,
                     q_offset=kv_len - 1)


def gqa_decode_window_cuda(q, k_cache, v_cache, kv_len, *, layer: int = 0):
    """Launch the decode kernel over a verify window. q: [B, W, H, D] bf16;
    everything else as ``gqa_decode_attention_cuda``. Position t of row b
    attends the first ``kv_len[b] + t`` positions. One launch per block of
    ``MAX_ROWS // n_rep`` window positions. Returns [B, W, H, D] bf16."""
    out, n = _fp_launch("gqa_decode_window_cuda", "gofr_gqa_decode_window",
                        q, k_cache, v_cache, kv_len, layer, True)
    gqa_decode_window_cuda.launches += n
    return out


gqa_decode_window_cuda.launches = 0


def _stacked_int8(k_cache, v_cache, k_scale, v_scale, layer: int):
    if k_cache.dim() == 3:  # one layer's [B, S, KV*D] and [B, KV, S]
        return k_cache[None], v_cache[None], k_scale[None], v_scale[None], 0
    return k_cache, v_cache, k_scale, v_scale, layer


def gqa_decode_attention_int8_plain(q, k_cache, v_cache, kv_len, *,
                                    layer: int = 0, k_scale, v_scale):
    """The int8 kernel's function in plain PyTorch, as the JAX package's
    XLA path computes it: unflatten the layer's values to [B, S, KV, D],
    dequantize them with the transposed scales to ``q.dtype``, then
    ``gqa_decode_attention``. q: [B, 1, H, D]; values: stacked int8
    [L, B, S_max, KV*D] (or [B, S_max, KV*D]); scales: bf16
    [L, B, KV, S_max] (or [B, KV, S_max]); kv_len [B]."""
    k_cache, v_cache, k_scale, v_scale, layer = _stacked_int8(
        k_cache, v_cache, k_scale, v_scale, layer)
    b, s = k_cache.shape[1], k_cache.shape[2]
    kv = k_scale.shape[2]

    def fp(values, scale):
        return dequantize_kv(values[layer].reshape(b, s, kv, -1),
                             scale[layer].transpose(1, 2), q.dtype)

    return gqa_decode_attention(q, fp(k_cache, k_scale), fp(v_cache, v_scale),
                                kv_len)


def _int8_launch(name: str, entry: str, q, k_cache, v_cache, kv_len,
                 layer: int, k_scale, v_scale, window: bool) -> tuple:
    """Check and launch an int8-cache entry; returns (out, launches)."""
    k_cache, v_cache, k_scale, v_scale, layer = _stacked_int8(
        k_cache, v_cache, k_scale, v_scale, layer)
    _check_tensors(name, q, (("q", q, torch.bfloat16),
                             ("k_cache", k_cache, torch.int8),
                             ("v_cache", v_cache, torch.int8),
                             ("k_scale", k_scale, torch.bfloat16),
                             ("v_scale", v_scale, torch.bfloat16),
                             ("kv_len", kv_len, None)), window)
    if k_cache.dim() != 4 or k_scale.dim() != 4:
        raise ValueError(f"{name}: values must be [L, B, S, KV*D] and scales "
                         f"[L, B, KV, S], got {tuple(k_cache.shape)} and "
                         f"{tuple(k_scale.shape)}")
    n_layers, b, s_max, width = k_cache.shape
    kv, h, d = k_scale.shape[2], q.shape[2], q.shape[3]
    if (v_cache.shape != k_cache.shape or v_scale.shape != k_scale.shape
            or tuple(k_scale.shape) != (n_layers, b, kv, s_max)
            or width != kv * d or q.shape[0] != b or h % kv):
        raise ValueError(f"{name}: q {tuple(q.shape)}, values "
                         f"{tuple(k_cache.shape)} and scales "
                         f"{tuple(k_scale.shape)} do not match")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError(f"{name}: values must be 16-byte aligned")
    return _launch(name, entry, q, (k_cache, v_cache, k_scale, v_scale),
                   kv_len, n_layers=n_layers, s_max=s_max, kv=kv, layer=layer)


def gqa_decode_attention_int8_cuda(q, k_cache, v_cache, kv_len, *,
                                   layer: int = 0, k_scale, v_scale):
    """Launch the int8 CUDA decode kernel. q: [B, 1, H, D] bf16; values:
    stacked int8 [L, B, S_max, KV*D] (or [B, S_max, KV*D]); scales: bf16
    [L, B, KV, S_max] (or [B, KV, S_max]); kv_len: int32 [B]; ``layer`` a
    Python int. All on one CUDA device, contiguous. Returns [B, 1, H, D]
    bf16. Raises on anything the kernel does not take."""
    out, n = _int8_launch("gqa_decode_attention_int8_cuda",
                          "gofr_gqa_decode_attention_int8", q, k_cache,
                          v_cache, kv_len, layer, k_scale, v_scale, False)
    gqa_decode_attention_int8_cuda.launches += n
    return out


gqa_decode_attention_int8_cuda.launches = 0


def gqa_decode_window_int8_plain(q, k_cache, v_cache, kv_len, *,
                                 layer: int = 0, k_scale, v_scale):
    """The verify window over the int8 cache in plain PyTorch, as JAX's
    ``decode_window`` computes it: dequantize the layer's row to
    ``q.dtype``, then ``gqa_decode_window_plain``."""
    k_cache, v_cache, k_scale, v_scale, layer = _stacked_int8(
        k_cache, v_cache, k_scale, v_scale, layer)
    b, s = k_cache.shape[1], k_cache.shape[2]
    kv = k_scale.shape[2]

    def fp(values, scale):
        return dequantize_kv(values[layer].reshape(b, s, kv, -1),
                             scale[layer].transpose(1, 2), q.dtype)

    return gqa_decode_window_plain(q, fp(k_cache, k_scale),
                                   fp(v_cache, v_scale), kv_len)


def gqa_decode_window_int8_cuda(q, k_cache, v_cache, kv_len, *,
                                layer: int = 0, k_scale, v_scale):
    """Launch the int8 decode kernel over a verify window. q: [B, W, H, D]
    bf16; everything else as ``gqa_decode_attention_int8_cuda``. Returns
    [B, W, H, D] bf16."""
    out, n = _int8_launch("gqa_decode_window_int8_cuda",
                          "gofr_gqa_decode_window_int8", q, k_cache, v_cache,
                          kv_len, layer, k_scale, v_scale, True)
    gqa_decode_window_int8_cuda.launches += n
    return out


gqa_decode_window_int8_cuda.launches = 0
