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
slice of the stacked gradient in one copy. Sharded training
(``SHARDING_RULES_FSDP`` over a mesh with dp, fsdp and tp, a batch on
``P("dp")``: ``ml.train.Trainer(mesh=, param_specs=)``) runs each dp group
on its devices and gathers each layer's fsdp blocks inside the layer (the
section "tensor parallelism" below). ``LLAMA_CKPT`` /
``checkpoint_dir`` restore real weights (an HF directory through
``ml.hf_import``, a ``ml.checkpoint.Checkpointer`` directory of a params
tree or of a training state) and ``LLM_DRAFT_CKPT`` loads an HF draft.

Sequence parallelism (``LlamaConfig(attn_impl="ring"|"ulysses")`` with a
``parallel.Mesh``): the forward and the prefills attend through
``parallel.ring`` / ``parallel.ulysses`` over the mesh's sp axis;
``init_cache(mesh=)`` splits the dense cache's sequence axis over the
shards and ``decode_step(mesh=)`` combines them through
``sp_decode_attention``; ``init_paged_cache(mesh=)`` stripes the page
pool and ``sp_paged_decode_step`` decodes it. Split arrays are
``parallel.ShardedTensor``s, one block a shard on its device; every
cache write or read here goes through ``parallel``'s cache accesses
(``row_write``, ``row_read``, ``set_at_pos``, ``pool_put``,
``pool_take``), which route a position or a page to its owner, so the
single-device paths (a short prompt's prefill, a segment, a suffix) run
on a split cache too. Weights and activations stay
on the mesh's first device, as JAX's are replicated.

Tensor parallelism (params split by ``SHARDING_RULES`` through
``parallel.shard_params`` over a mesh with tp > 1): every function here
sees the split weights and runs each decoder block a shard at a time
(``_blocks``), each shard's heads attended through the same two kernels
over its own KV-head block of a cache split by ``init_cache(mesh=)`` /
``init_paged_cache(mesh=)``; ``psum`` joins the row-parallel outputs and
``all_gather`` the vocabulary-split logits (the section "tensor
parallelism" below). A tp that does not divide the KV heads raises, where
JAX replicates K/V.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from . import tensor_from_numpy as _tensor_from_numpy
from ..ops import (apply_rope, cached_decode_attention, dequantize_kv,
                   dequantize_kv4, flash_attention, quantize_kv, quantize_kv4,
                   quantize_weight, repeat_kv, rms_norm, rope_table)
from ..parallel import (P, ShardedTensor, all_gather, current_mesh, dp_mean,
                        gather, pool_put, pool_take, psum, row_read,
                        row_write, set_at_pos, shards_of, specs_from_rules)

__all__ = ["LlamaConfig", "llama3_8b", "tiny_llama", "kv_bits_from_env",
           "config_from_env", "init_params", "quantize_weights",
           "params_from_config", "params_from_jax", "forward", "loss_fn",
           "kv_plane_names", "kv_store_width", "kv_encode", "kv_decode",
           "init_cache", "prefill", "prefill_into", "prefill_into_many",
           "prefill_segment_into", "decode_step", "decode_window",
           "init_paged_cache", "paged_prefill_into", "paged_suffix_prefill",
           "paged_decode_step", "sp_paged_decode_step",
           "paged_decode_window", "draft_from_env", "SHARDING_RULES",
           "SHARDING_RULES_FSDP", "CACHE_SPEC", "sharding_specs",
           "tp_devices"]

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
        # "auto" (single-device flash), "ring" or "ulysses": sequence-
        # parallel attention over the mesh's sp axis, the long-context
        # path; it needs ``mesh=`` passed to the forward, the prefills
        # and ``decode_step`` (the Generator does this with a mesh)
        if attn_impl not in ("auto", "ring", "ulysses"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.attn_impl = attn_impl
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

    @property
    def sequence_parallel(self) -> bool:
        return self.attn_impl in ("ring", "ulysses")


def llama3_8b(**kw) -> LlamaConfig:
    """Meta-Llama-3-8B's published shape (the ``LlamaConfig`` defaults)."""
    return LlamaConfig(**kw)


def tiny_llama(**kw) -> LlamaConfig:
    """Test-scale config: same topology, toy widths (divisible by tp=4)."""
    defaults = dict(
        vocab_size=512, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
        ffn_dim=256, max_seq_len=128, rope_theta=10_000.0,
    )
    defaults.update(kw)
    return LlamaConfig(**defaults)


# Megatron-style TP over the canonical mesh, JAX's rules. The leading axis
# of every layer weight is the stacked n_layers axis (never sharded). The
# ``/s`` rules (first match wins) cover int8 weights' per-out-channel
# scales: column-parallel outputs shard the scale over tp, row-parallel
# outputs are full-width so their scales replicate.
SHARDING_RULES = (
    (r"layers/(wq|wk|wv|w_gate|w_up)/s", P(None, "tp")),
    (r"layers/(wo|w_down)/s", P(None, None)),
    (r"lm_head/s", P("tp")),
    (r"layers/(wq|wk|wv|w_gate|w_up)", P(None, None, "tp")),  # column parallel
    (r"layers/(wo|w_down)", P(None, "tp", None)),             # row parallel
    (r"layers/(attn_norm|mlp_norm)", P(None)),
    (r"embed", P(None, None)),
    (r"lm_head", P(None, "tp")),                              # vocab sharded
    (r"final_norm", P(None)),
)

# FSDP variant (JAX's, for training): weights also sharded over the fsdp
# axis, ZeRO-3's layout: each tp shard's entry holds its fsdp blocks, which
# ``_blocks`` gathers onto the shard's device a layer at a time.
SHARDING_RULES_FSDP = (
    (r"layers/(wq|wk|wv|w_gate|w_up)/s", P(None, "tp")),
    (r"layers/(wo|w_down)/s", P(None, "fsdp")),
    (r"lm_head/s", P("tp")),
    (r"layers/(wq|wk|wv|w_gate|w_up)", P(None, "fsdp", "tp")),
    (r"layers/(wo|w_down)", P(None, "tp", "fsdp")),
    (r"layers/(attn_norm|mlp_norm)", P(None)),
    (r"embed", P("fsdp", None)),
    (r"lm_head", P("fsdp", "tp")),
    (r"final_norm", P(None)),
)

# KV cache [L, B, S, KV, D]: batch on dp, kv heads on tp.
CACHE_SPEC = P(None, "dp", None, "tp", None)


def sharding_specs(params: dict) -> dict:
    """The spec tree of ``params`` under ``SHARDING_RULES`` (JAX's
    ``Llama.sharding_specs``): ``parallel.shard_params(params,
    sharding_specs(params), mesh)`` splits them over the mesh's tp axis."""
    return specs_from_rules(params, SHARDING_RULES)


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
    ``(x @ q) * s``, in ``x.dtype``, in the JAX code's order (a row-parallel
    shard reads its replicated scale on ``x``'s device). Eager PyTorch
    materialises the widened copy of ``q`` for each call; a fused
    int8-weight GEMM is later work."""
    if isinstance(w, dict):
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.device, x.dtype)
    return x @ w


def _swiglu(x, lp):
    g = torch.nn.functional.silu(_mm(x, lp["w_gate"]))
    return _mm(g * _mm(x, lp["w_up"]), lp["w_down"])


def _unstack(w) -> list:
    """A stacked weight's per-layer slices: ``unbind(0)`` of a tensor, of
    each entry of an int8 weight's dict, of each block of a weight split
    along a later axis (its fsdp blocks: a split slice a layer)."""
    if isinstance(w, dict):
        per = {n: _unstack(t) for n, t in w.items()}
        return [{n: p[i] for n, p in per.items()}
                for i in range(len(next(iter(per.values()))))]
    if isinstance(w, ShardedTensor):
        per = [_unstack(sh) for sh in w.shards]
        return [ShardedTensor([p[i] for p in per], w.axis - 1, w.block,
                              w.mesh_axis) for i in range(len(per[0]))]
    return w.unbind(0)


def _per_layer(layers: dict, n_layers: int) -> list:
    """Stacked layer weights -> one dict a layer. Each weight is unbound
    once, so a backward pass stacks its per-layer gradients in one pass."""
    un = {k: _unstack(v) for k, v in layers.items()}
    return [{k: v[i] for k, v in un.items()} for i in range(n_layers)]


def _take(lp: dict, keys: tuple, device) -> dict:
    """A layer's weights ``keys`` whole on ``device``: a weight there as it
    is, fsdp blocks gathered (``parallel.gather``, differentiable), a
    weight elsewhere copied (a dp group's devices)."""
    return {k: gather(lp[k], device) for k in keys}


# -- tensor parallelism ---------------------------------------------------------
#
# Params split by ``SHARDING_RULES`` (``parallel.shard_params`` over a mesh
# with tp > 1) carry their own sharding, as JAX's arrays do. Every function
# below runs each decoder block a shard at a time (``_blocks``); unsplit
# params are one shard holding every weight whole. Shard i owns query heads
# [i*H/tp, (i+1)*H/tp), KV heads [i*KV/tp, ...) and an ffn slice; it
# projects them from the block's normed input (column-parallel
# wq/wk/wv/w_gate/w_up), attends over ITS heads of a cache split along the
# KV-head axis (one contiguous block a shard, ``_split_cache``) through the
# same two kernels, and multiplies by its rows of wo / w_down (row
# parallel); ``psum`` adds the shards' partial outputs onto the
# activations' device (the params' first), where norms, residuals and the
# embedding stay replicated. ``lm_head`` is split by vocabulary columns and
# ``all_gather`` joins the logits for sampling. With one shard the
# collectives return their one input and nothing is copied.
#
# Training adds two splits (``SHARDING_RULES_FSDP`` and a dp-placed batch,
# ``ml.train``). A tp shard's weight may be fsdp blocks
# (``parallel.ShardedTensor`` over fsdp): ``_blocks`` gathers a layer's
# blocks onto the shard's device inside the layer's body, so under
# ``cfg.remat`` the backward pass gathers them again rather than keeping
# them (ZeRO-3's trade), and autograd through the gather returns each block
# its own gradient (the reduce-scatter). A batch split over dp (a
# ``ShardedTensor`` of row blocks) runs a group at a time, group g on the
# mesh's devices at dp position g (the ambient mesh, ``with mesh:``); its
# weights ``.to()`` there, nothing copied on a repeated device, and the
# backward pass of that copy adds the groups' gradients onto each weight
# (the dp all-reduce). ``loss_fn`` sums the groups' masked sums and mask
# counts before it divides: the global batch's mean.


def _split(w) -> list:
    """A weight's blocks in shard order: a split weight's shards (an int8
    weight's codes and scales zipped, a replicated scale repeated), or the
    weight whole as the one block of an unsplit one."""
    if not isinstance(w, dict):
        return shards_of(w)
    parts = {k: shards_of(v) for k, v in w.items()}
    n = max(len(p) for p in parts.values())
    return [{k: p[d] if len(p) == n else p[0] for k, p in parts.items()}
            for d in range(n)]


def _device_of(w) -> torch.device:
    return (w["q"] if isinstance(w, dict) else w).device


def _shards(params: dict) -> list:
    """(device, its blocks of the seven stacked layer weights) of each
    tensor-parallel shard, in shard order: one for unsplit params."""
    layers = {k: _split(params["layers"][k]) for k in _QUANT_KEYS}
    n = len(layers["wq"])
    for k, blocks in layers.items():
        if len(blocks) != n:
            raise ValueError(f"layers/{k} is split {len(blocks)} ways, wq "
                             f"{n}: split every weight by "
                             f"llama.SHARDING_RULES")
    return [(_device_of(layers["wq"][d]),
             {k: blocks[d] for k, blocks in layers.items()})
            for d in range(n)]


def tp_devices(params: dict) -> list | None:
    """The devices of tensor-parallel params' shards, in shard order, or
    None for unsplit params."""
    shards = _shards(params)
    return None if len(shards) == 1 else [dev for dev, _ in shards]


def _shard_cfg(cfg: LlamaConfig, n: int, index: int = 0) -> LlamaConfig:
    """Shard ``index``'s view of ``cfg`` of ``n``: H/n query heads, KV/n KV
    heads and an ffn slice of F/n (head_dim and n_rep unchanged), and
    ``tp_shard`` = ``index`` (a sequence-parallel shard attends over its
    own row of the mesh, ``_sp_mesh``); ``cfg`` itself for one shard. A
    tp that does not divide the heads raises (JAX would replicate K/V,
    ROADMAP C)."""
    if n == 1:
        return cfg
    if cfg.n_kv_heads % n or cfg.n_heads % n or cfg.ffn_dim % n:
        raise ValueError(
            f"tp={n} must divide n_kv_heads={cfg.n_kv_heads}, "
            f"n_heads={cfg.n_heads} and ffn_dim={cfg.ffn_dim}: each shard "
            f"owns whole KV heads")
    c = copy.copy(cfg)
    c.n_heads, c.n_kv_heads = cfg.n_heads // n, cfg.n_kv_heads // n
    c.ffn_dim = cfg.ffn_dim // n
    c.tp_shard = index
    return c


def _sp_mesh(cfg: LlamaConfig, mesh):
    """The mesh a shard's heads run ring or Ulysses attention over: for a
    tp shard's view of ``cfg`` (``_shard_cfg``), its row of ``mesh`` along
    sp (``mesh.sub(tp=shard)``), so shard d's sequence blocks live on the
    devices at tp position d; ``mesh`` itself for unsplit params."""
    shard = getattr(cfg, "tp_shard", None)
    if mesh is None or shard is None or mesh.shape.get("tp", 1) == 1:
        return mesh
    return mesh.sub(tp=shard)


def _split_cache(cfg: LlamaConfig, devices, batch: int, make,
                 device) -> dict:
    """A cache split along its KV-head axis over ``devices`` (JAX's
    ``CACHE_SPEC`` tp entry): shard d's block is ``make(shard d's cfg, its
    device)``, its own contiguous allocation, so values [.., KV/tp, D]
    (int8 flat [.., KV/tp * D], head-contiguous) and planes [.., KV/tp,
    S] (a block may itself be split by sequence over the shard's sp
    devices); ``len`` [B] stays on ``device``."""
    blocks = [make(_shard_cfg(cfg, len(devices), d), dev)
              for d, dev in enumerate(devices)]
    cache = {name: ShardedTensor([blk[name] for blk in blocks],
                                 2 if name.endswith(("_scale", "_zero"))
                                 else 3)
             for name in blocks[0] if name != "len"}
    cache["len"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache


def _cache_views(cache, n: int) -> list:
    """Each of ``n`` shards' view of ``cache``: the cache itself for one
    shard; of a head-split cache, shard d's blocks (plain tensors, or
    split by sequence over the shard's sp devices under sequence
    parallelism; ``len`` stays the shared one)."""
    if cache is None or n == 1:
        return [cache] * n
    return [{name: arr.shards[d] if isinstance(arr, ShardedTensor) else arr
             for name, arr in cache.items()} for d in range(n)]


_ATTN_KEYS = ("wq", "wk", "wv", "wo")
_MLP_KEYS = ("w_gate", "w_up", "w_down")


def _blocks(params: dict, cfg: LlamaConfig, x, cos, sin, attend,
            cache=None, devices=None):
    """Every decoder block over x [B, T, D], in layer order, a shard at a
    time (the section above). ``attend(cfg, cache, layer, q, k, v)`` -> o
    [B, T, H, D] is the block's attention (and its cache writes) over
    rope'd q [B, T, H, D] and k, v [B, T, KV, D], called with the shard's
    config, its view of ``cache`` and its heads (on its device).
    ``devices`` (default: the shards' own) are the devices the shards
    compute on, a dp group's; each layer's weights are taken there
    (``_take``). With ``cfg.remat`` (and grad on) a block keeps only its
    input and recomputes the rest, the gathers included, in the backward
    pass."""
    shards = _shards(params)
    devs = devices or [dev for dev, _ in shards]
    scfgs = [_shard_cfg(cfg, len(shards), d) for d in range(len(shards))]
    views = _cache_views(cache, len(shards))
    ropes = [(cos.to(dev), sin.to(dev)) for dev in devs]
    lps = [_per_layer(blocks, cfg.n_layers) for _, blocks in shards]
    norms = _per_layer({k: params["layers"][k]
                        for k in ("attn_norm", "mlp_norm")}, cfg.n_layers)

    def block(x, layer):
        h = rms_norm(x, norms[layer]["attn_norm"].to(x.device), cfg.norm_eps)
        parts = []
        for dev, scfg, view, (c, s), lp in zip(devs, scfgs, views, ropes,
                                               lps, strict=True):
            w = _take(lp[layer], _ATTN_KEYS, dev)
            q, k, v = _project_qkv(scfg, h.to(dev), w, c, s)
            o = attend(scfg, view, layer, q, k, v)
            parts.append(_mm(o.reshape(*o.shape[:2], -1), w["wo"]))
        x = x + psum(parts, to=x.device)
        h = rms_norm(x, norms[layer]["mlp_norm"].to(x.device), cfg.norm_eps)
        return x + psum([_swiglu(h.to(dev), _take(lp[layer], _MLP_KEYS, dev))
                         for dev, lp in zip(devs, lps, strict=True)],
                        to=x.device)

    remat = cfg.remat and torch.is_grad_enabled()
    for layer in range(cfg.n_layers):
        if remat:
            x = torch.utils.checkpoint.checkpoint(block, x, layer,
                                                  use_reentrant=False)
        else:
            x = block(x, layer)
    return x


def _head(params: dict, x, devices=None) -> torch.Tensor:
    """f32 logits of the final-normed x [..., D]: each vocabulary block of
    ``lm_head`` on its device (or on ``devices``, a dp group's; fsdp
    blocks gathered there), joined on the activations' device."""
    ws = _split(params["lm_head"])
    devs = devices or [_device_of(w) for w in ws]
    return all_gather([_mm(x.to(dev), gather(w, dev))
                       for w, dev in zip(ws, devs, strict=True)], -1,
                      to=x.device).float()

def _causal_attention(cfg: LlamaConfig, q, k, v, kv_len, mesh):
    """Full-sequence causal attention of q [B, S, H, D] over GROUPED k, v
    [B, S, KV, D]: the flash dispatcher, or for a sequence-parallel ``cfg``
    with a ``mesh`` ring or Ulysses attention over its sp axis with K/V
    GQA-expanded first, as JAX does (a tp shard's heads over its own row
    of the mesh, ``_sp_mesh``)."""
    if cfg.sequence_parallel and mesh is not None:
        from ..parallel.ring import ring_attention
        from ..parallel.ulysses import ulysses_attention

        sp_attn = (ring_attention if cfg.attn_impl == "ring"
                   else ulysses_attention)
        return sp_attn(q, repeat_kv(k, cfg.n_rep), repeat_kv(v, cfg.n_rep),
                       _sp_mesh(cfg, mesh), kv_len=kv_len, causal=True)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True, kv_len=None if kv_len is None
                           else kv_len.to(q.device))


def _embed(params, tokens, cfg):
    return gather(params["embed"], tokens.device)[tokens.long()].to(
        cfg.dtype)


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


def _forward(params: dict, tokens, cfg: LlamaConfig, seq_lens=None,
             mesh=None, devices=None) -> torch.Tensor:
    """The full-sequence forward, differentiable: autograd records it when
    grad is on (``_blocks``: each stacked weight unbound once, ``cfg.remat``
    recomputing a block in the backward pass). ``devices`` are a dp
    group's devices, one a tp shard (default: the params' own)."""
    dev = devices[0] if devices else params["embed"].device
    tokens = _token_tensor(tokens, cfg, dev)
    kv_len = None if seq_lens is None else _int32(seq_lens, dev)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=dev)[None, :]
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta,
                          scaling=cfg.rope_scaling)

    def attend(c, _, layer, q, k, v):
        return _causal_attention(c, q, k, v, kv_len, mesh)

    x = _blocks(params, cfg, x, cos, sin, attend, devices=devices)
    return _head(params, rms_norm(x, params["final_norm"].to(dev),
                                  cfg.norm_eps), devices)


def _dp_groups(params: dict, *batch) -> list:
    """[(a dp group's devices or None, its rows of each batch entry)]: one
    group of the whole batch unless the first entry is split over dp
    (a ``ShardedTensor`` of row blocks, ``parallel.shard_like``). Group g
    computes on the ambient mesh's devices at dp position g, one a tp
    shard (a replicated model: its rows' device); an entry that is not
    split is cut into the same row blocks."""
    first = batch[0]
    if not isinstance(first, ShardedTensor):
        return [(None, batch)]
    n = first.n
    n_tp = len(_shards(params))
    mesh = current_mesh()
    if n_tp > 1 and (mesh is None or mesh.shape.get("dp", 1) != n
                     or mesh.shape.get("tp", 1) != n_tp):
        raise ValueError(
            f"a batch split {n} ways over dp with params split {n_tp} ways "
            f"over tp runs under its mesh (with mesh:), dp={n}, tp={n_tp}")

    def rows(b, g):
        if isinstance(b, ShardedTensor):
            return b.block_of(g)
        return torch.as_tensor(b).chunk(n, dim=0)[g]

    return [(mesh.axis_devices("tp", dp=g) if n_tp > 1
             else [first.shards[g].device],
             tuple(rows(b, g) for b in batch)) for g in range(n)]


@torch.no_grad()
def forward(params: dict, tokens, cfg: LlamaConfig, *, seq_lens=None,
            mesh=None) -> torch.Tensor:
    """Full-sequence forward: tokens [B, S] -> f32 logits [B, S, V].
    ``seq_lens`` [B] masks padded tail positions out of attention; a
    sequence-parallel ``cfg`` attends over ``mesh``'s sp axis."""
    return _forward(params, tokens, cfg, seq_lens, mesh)


def loss_fn(params: dict, tokens, targets, mask, cfg: LlamaConfig
            ) -> torch.Tensor:
    """Masked next-token cross-entropy over f32 logits, as JAX's
    ``loss_fn``: -sum(log p(target) * mask) / max(sum(mask), 1).
    ``tokens``, ``targets`` and ``mask`` are [B, S], host arrays or tensors;
    differentiable when grad is on (``ml.train``). Split over dp, each
    group's masked sum and mask count are summed over the groups before
    the one division (the global batch's mean, not a mean of the groups'
    means); under a mesh whose dp axis spans processes the count is
    summed over them too, so each process returns its part of the global
    loss (``ml.train`` sums the parts)."""
    nums, dens = [], []
    for devs, (tok, tgt, msk) in _dp_groups(params, tokens, targets, mask):
        logits = _forward(params, tok, cfg, devices=devs)
        dev = logits.device
        tgt = torch.as_tensor(tgt, device=dev).long()
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, tgt[..., None])[..., 0]
        maskf = torch.as_tensor(msk, device=dev).float()
        nums.append(-(ll * maskf).sum())
        dens.append(maskf.sum())
    return dp_mean(nums, dens)


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
               device=None, mesh=None, tp_heads: bool = False) -> dict:
    """Dense cache, all zeros, with the JAX package's keys, shapes and
    dtypes: k/v [L, B, S_max, KV, D] in ``cfg.dtype``, or with
    ``kv_quant`` the values FLAT [L, B, S_max, KV*W] (int8, or uint8 holding
    two int4 codes) and their bf16 planes (``k_scale``/``v_scale``, and
    ``k_zero``/``v_zero`` at int4) [L, B, KV, S_max] (seq minor); ``len``
    [B] int32.

    With ``mesh`` (sequence-parallel serving) every K/V array splits its
    sequence axis over the mesh's sp axis: a ``ShardedTensor`` of one
    [.., S_max / sp, ..] block a shard on the shard's device (JAX's
    ``P(None, "dp", "sp", ...)``); ``len`` stays on ``device``. A mesh
    with tp > 1 splits the KV-head axis over its tp devices instead
    (``CACHE_SPEC``): the cache of tensor-parallel serving. With both sp
    and tp > 1, ``tp_heads`` (params split over tp) splits the heads over
    tp and each tp block's sequence over that shard's sp devices
    (``mesh.sub(tp=d)``): sequence parallelism over split weights;
    without it the tp axis is unused, as ring and Ulysses leave it."""
    from .. import resolve_device

    device = resolve_device(device)
    S = max_seq or cfg.max_seq_len
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    if (tp_heads and mesh is not None and mesh.shape.get("tp", 1) > 1
            and mesh.shape.get("sp", 1) > 1):
        return _split_cache(
            cfg, mesh.axis_devices("tp"), batch,
            lambda c, dev: init_cache(c, batch, S, dev,
                                      mesh=mesh.sub(tp=c.tp_shard)),
            device)
    if _mesh_tp(mesh) > 1:
        return _split_cache(cfg, mesh.axis_devices("tp"), batch,
                            lambda c, dev: init_cache(c, batch, S, dev),
                            device)
    if mesh is not None:
        devs = mesh.axis_devices("sp")
        if S % len(devs):
            raise ValueError(f"max_seq {S} does not divide over sp="
                             f"{len(devs)}")
        blocks = [init_cache(cfg, batch, S // len(devs), device=dev)
                  for dev in devs]
        cache = {name: ShardedTensor([blk[name] for blk in blocks],
                                     3 if name.endswith(("_scale", "_zero"))
                                     else 2)
                 for name in blocks[0] if name != "len"}
    elif cfg.kv_quant:
        cache = _quant_cache(cfg, (L, batch), S, device)
    else:
        cache = {name: torch.zeros((L, batch, S, KV, hd), dtype=cfg.dtype,
                                   device=device) for name in ("k", "v")}
    cache["len"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache


def _mesh_tp(mesh) -> int:
    """The tp size a cache splits its KV heads over: ``mesh``'s tp axis
    when it has no sp axis > 1 (a sequence split takes precedence: ring
    and Ulysses leave the tp axis unused), else 1."""
    if mesh is None or mesh.shape.get("sp", 1) > 1:
        return 1
    return mesh.shape.get("tp", 1)


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


def _prefill_layers(params, tokens, seq_lens, cfg, cache, write,
                    mesh=None):
    """Run the prompt wave [B, S_pad] through every layer, handing each
    layer's K/V to ``write(cfg, cache, layer, k, v)`` (a shard's config
    and view of ``cache`` under tensor parallelism); returns
    last-valid-token logits [B, V] in f32 (``x[rows, seq_lens - 1]``, as
    the JAX code gathers). A sequence-parallel ``cfg`` attends over
    ``mesh`` (ring or Ulysses, K/V GQA-expanded first, as JAX does)."""
    b, s = tokens.shape
    dev = tokens.device
    x = _embed(params, tokens, cfg)
    cos, sin = rope_table(torch.arange(s, device=dev)[None, :], cfg.head_dim,
                          cfg.rope_theta, scaling=cfg.rope_scaling)

    def attend(c, view, layer, q, k, v):
        o = _causal_attention(c, q, k, v, seq_lens, mesh)
        write(c, view, layer, k, v)
        return o

    x = _blocks(params, cfg, x, cos, sin, attend, cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _head(params, x[torch.arange(b, device=dev), seq_lens.long() - 1])


@torch.no_grad()
def prefill(params: dict, tokens, seq_lens, cfg: LlamaConfig, cache: dict,
            mesh=None) -> tuple[torch.Tensor, dict]:
    """Run the prompt [B, S_pad] through the model into a NEW cache shaped
    like ``cache`` (S_max = its length; the bucket is zero-padded to it).
    Returns (last-token logits [B, V], cache). A sequence-parallel ``cfg``
    attends over ``mesh``."""
    dev = params["embed"].device
    tokens, seq_lens = _tokens(tokens, cfg, dev), _int32(seq_lens, dev)
    b, s = tokens.shape
    S_max = cache["k"].shape[2]
    if s > S_max:
        raise ValueError(f"prompt bucket {s} exceeds cache length {S_max}")
    devs = tp_devices(params)
    out = (init_cache(cfg, b, S_max, device=dev) if devs is None else
           _split_cache(cfg, devs, b,
                        lambda c, d: init_cache(c, b, S_max, d), dev))

    def write(c, view, layer, k, v):
        for name, (new, axis) in _kv_planes(c, k, v).items():
            view[name][layer].narrow(axis + 1, 0, s).copy_(new)

    logits = _prefill_layers(params, tokens, seq_lens, cfg, out, write,
                             mesh)
    out["len"] = seq_lens.clone()
    return logits, out


@torch.no_grad()
def prefill_into_many(params: dict, tokens, seq_lens, cfg: LlamaConfig,
                      cache: dict, slots, valid, mesh=None
                      ) -> tuple[torch.Tensor, dict]:
    """Prefill a WAVE of B prompts [B, S_pad] into rows ``slots`` [B] of the
    shared cache, in place. ``valid`` [B] masks padding rows (B is a shape
    bucket): an invalid row writes nothing. A valid row's cache row is
    replaced whole — the prompt's K/V (values and planes of a quantized
    cache), then zeros to S_max — and its ``len`` set, as the JAX version's
    fresh-cache scatter does. Returns (last-token logits [B, V], cache).
    A sequence-parallel ``cfg`` attends over ``mesh``; a cache split over
    a mesh (``init_cache(mesh=)``) takes each position on its shard."""
    dev = params["embed"].device
    tokens, seq_lens = _tokens(tokens, cfg, dev), _int32(seq_lens, dev)
    s = tokens.shape[1]
    S_max = cache["k"].shape[2]
    if s > S_max:
        raise ValueError(f"prompt bucket {s} exceeds cache length {S_max}")
    slots = [int(x) for x in np.asarray(slots).reshape(-1)]
    rows = [i for i, ok in enumerate(np.asarray(valid).reshape(-1)) if ok]

    def write(c, view, layer, k, v):
        planes = _kv_planes(c, k, v)
        for i in rows:  # in order: a later row for the same slot wins
            for name, (new, axis) in planes.items():
                row_write(view[name], layer, slots[i], axis, 0, new[i],
                           zero_to=S_max)

    logits = _prefill_layers(params, tokens, seq_lens, cfg, cache, write,
                             mesh)
    for i in rows:
        cache["len"][slots[i]] = seq_lens[i]
    return logits, cache


def prefill_into(params: dict, tokens, seq_lens, cfg: LlamaConfig,
                 cache: dict, slot, mesh=None) -> tuple[torch.Tensor, dict]:
    """Prefill ONE prompt [1, S_pad] into row ``slot`` of the shared cache
    (in place): ``prefill_into_many`` with a one-row wave."""
    return prefill_into_many(params, tokens, seq_lens, cfg, cache,
                             [int(slot)], [True], mesh)


def _project_qkv(cfg: LlamaConfig, h, lp, cos, sin):
    """The attention inputs of one block from its normed input ``h``:
    rope'd q [B, T, H, D], rope'd k and v [B, T, KV, D]."""
    b, t, _ = h.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = apply_rope(_mm(h, lp["wq"]).reshape(b, t, H, hd), cos, sin)
    k = apply_rope(_mm(h, lp["wk"]).reshape(b, t, KV, hd), cos, sin)
    v = _mm(h, lp["wv"]).reshape(b, t, KV, hd)
    return q, k, v


def _logits_at(params, cfg: LlamaConfig, x, row: int) -> torch.Tensor:
    """f32 logits [1, V] of position ``row`` of the one-row stream x."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _head(params, x[:, row])


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
    hd = cfg.head_dim
    valid_to = _int32([start + seg], dev)
    cos, sin = rope_table(torch.arange(start, start + c, device=dev)[None],
                          hd, cfg.rope_theta, scaling=cfg.rope_scaling)
    x = _embed(params, tokens, cfg)

    def attend(cf, view, layer, q, k, v):
        for name, (new, axis) in _kv_planes(cf, k, v).items():
            row_write(view[name], layer, slot, axis, start, new[0])
        if cf.kv_quant:
            k_row, v_row = (
                dequantize_kv(row_read(view[name], layer, slot, 0)
                              .view(S_max, cf.n_kv_heads, hd),
                              row_read(view[f"{name}_scale"], layer, slot,
                                        1).t(),
                              cf.dtype)
                for name in ("k", "v"))
        else:
            k_row, v_row = (row_read(view[name], layer, slot, 0)
                            for name in ("k", "v"))
        return flash_attention(q.contiguous(), k_row[None], v_row[None],
                               causal=True, q_offset=start,
                               kv_len=valid_to.to(q.device))

    x = _blocks(params, cfg, x, cos, sin, attend, cache)
    cache["len"][slot] = int(new_len)
    return _logits_at(params, cfg, x, seg - 1), cache


def _write_token_kv(cfg: LlamaConfig, cache: dict, layer: int, k, v, rows,
                    pos, fits) -> None:
    """Write one token's K/V [B, KV, D] of each row at ``[layer, rows,
    pos]``, in place, masked to the rows where ``fits``. int8: quantize,
    scatter the flat [B, KV*D] values at ``[layer, rows, pos]`` and the
    [B, KV] scales at ``[layer, rows, :, pos]`` (seq minor). A cache split
    over a mesh takes each row's write on the shard owning ``pos``."""
    def values_at(p, dev):
        return rows.to(dev), p

    def planes_at(p, dev):
        heads = torch.arange(cfg.n_kv_heads, device=dev)[None, :]
        return rows.to(dev)[:, None], heads, p[:, None]

    if not cfg.kv_quant:
        for name, x in (("k", k), ("v", v)):
            set_at_pos(cache[name], layer, values_at, pos, x, fits)
        return
    for name, x in (("k", k), ("v", v)):
        codes, planes = kv_encode(cfg, x)
        set_at_pos(cache[name], layer, values_at, pos,
                    codes.reshape(x.shape[0], -1), fits)
        for pl, val in planes.items():
            set_at_pos(cache[f"{name}_{pl}"], layer, planes_at, pos, val,
                        fits)


@torch.no_grad()
def decode_step(params: dict, tokens, cache: dict, cfg: LlamaConfig,
                mesh=None) -> tuple[torch.Tensor, dict]:
    """One token per row: tokens [B] -> (f32 logits [B, V], cache).

    Rows may sit at different positions (continuous batching); each row
    writes its K/V at its own ``len`` and attends to len+1 keys. A row at
    capacity (len == S_max) writes nothing — its write is masked here, where
    JAX drops it as out of bounds — and attends the whole row (the decode
    kernels clamp kv_len to S_max). The cache is updated in place, ``len``
    too (capped at S_max): a CUDA graph of the step keeps its pointers. With an int8 cache the new
    token's K/V are quantized on write and attention reads the int8 cache
    with its scales. int4 is a paged precision and raises, as in JAX.

    A sequence-parallel ``cfg`` with ``mesh`` attends through
    ``parallel.ring.sp_decode_attention`` over the cache's sequence split
    across the mesh (``init_cache(mesh=)``): each shard over its own
    positions, one pmax and two psums to combine; the new token's K/V go
    to the shard owning its position."""
    if cfg.kv_bits == 4:
        raise ValueError("int4 KV is a paged-cache precision — use "
                         "page_size > 0 (paged_decode_step)")
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens).to(dev)
    b = tokens.shape[0]
    S_max = cache["k"].shape[2]
    sp = cfg.sequence_parallel and mesh is not None
    pos = cache["len"]
    kv_len = pos + 1
    fits = pos < S_max
    pos_w = pos.clamp(max=S_max - 1).long()
    rows = torch.arange(b, device=dev)
    x = _embed(params, tokens, cfg)[:, None, :]
    cos, sin = rope_table(pos[:, None], cfg.head_dim, cfg.rope_theta,
                          scaling=cfg.rope_scaling)

    def attend(c, view, layer, q, k, v):
        d = q.device
        _write_token_kv(c, view, layer, k[:, 0], v[:, 0], rows.to(d),
                        pos_w.to(d), fits.to(d))
        scales = ({"k_scale": view["k_scale"], "v_scale": view["v_scale"]}
                  if c.kv_quant else {})
        if sp:
            from ..parallel.ring import sp_decode_attention

            return sp_decode_attention(q, view["k"], view["v"], kv_len,
                                       mesh, layer=layer, **scales)
        return cached_decode_attention(q.contiguous(), view["k"], view["v"],
                                       kv_len.to(d), layer=layer, **scales)

    x = _blocks(params, cfg, x, cos, sin, attend, cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _head(params, x[:, 0])
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
    return _head(params, rms_norm(x, params["final_norm"], cfg.norm_eps))


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
    x = _embed(params, tokens, cfg)
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta,
                          scaling=cfg.rope_scaling)
    kv_len = pos0 + 1

    def attend(c, view, layer, q, k, v):
        d = q.device
        # one position at a time: a position past capacity rewrites what
        # an earlier one wrote at the clamped index, in order
        for t in range(w):
            _write_token_kv(c, view, layer, k[:, t], v[:, t], rows.to(d),
                            pos_w[:, t].to(d), fits[:, t].to(d))
        scales = ({"k_scale": view["k_scale"], "v_scale": view["v_scale"]}
                  if c.kv_quant else {})
        return cached_decode_attention(q.contiguous(), view["k"], view["v"],
                                       kv_len.to(d), layer=layer, **scales)

    x = _blocks(params, cfg, x, cos, sin, attend, cache)
    return _window_logits(params, cfg, x), cache


# -- the paged cache ------------------------------------------------------------

def init_paged_cache(cfg: LlamaConfig, batch: int, n_pages: int, page_s: int,
                     device=None, mesh=None) -> dict:
    """Block-paged KV cache: a POOL of ``n_pages`` pages of ``page_s``
    positions shared by every slot, all zeros. bf16/f32 values [L, N, ps,
    KV, D]; quantized values flat [L, N, ps, KV*W] (uint8 at int4) with
    their bf16 planes [L, N, KV, ps]; ``len`` [B] int32. Slots map virtual
    positions onto pages through a host-owned page table; page 0 is
    scratch: unallocated table entries point at it, over-capacity writes
    land there, and ``kv_len`` keeps reads of it out of every live row.

    With ``mesh`` the pool is STRIPED over the mesh's sp axis: shard d owns
    pages ``[d * N/sp, (d+1) * N/sp)`` (a ``ShardedTensor`` along the page
    axis, one block a shard on its device) plus one dump page of its own
    past its block, where a write of a page it does not own lands (JAX
    drops such writes as out of bounds); ``len`` stays on ``device``. A
    mesh with tp > 1 splits the KV-head axis of every page over its tp
    devices instead (tensor-parallel serving; the page ids, the table and
    the free list are shared by the shards)."""
    from .. import resolve_device

    device = resolve_device(device)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    if _mesh_tp(mesh) > 1:
        return _split_cache(
            cfg, mesh.axis_devices("tp"), batch,
            lambda c, dev: init_paged_cache(c, batch, n_pages, page_s, dev),
            device)
    if mesh is not None:
        devs = mesh.axis_devices("sp")
        if n_pages % len(devs):
            raise ValueError(f"{n_pages} pages do not stripe over sp="
                             f"{len(devs)}")
        p_loc = n_pages // len(devs)
        blocks = [init_paged_cache(cfg, batch, p_loc + 1, page_s, device=dev)
                  for dev in devs]
        cache = {name: ShardedTensor([blk[name] for blk in blocks], 1, p_loc)
                 for name in blocks[0] if name != "len"}
    elif cfg.kv_quant:
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
    share a scratch position (page 0) overwrite one another. A striped
    pool writes each position on the shard owning its page."""
    if not cfg.kv_quant:
        for name, x in (("k", k), ("v", v)):
            pool_put(cache[name], layer, page, (off,), x)
        return
    heads = torch.arange(cfg.n_kv_heads, device=k.device)[None, :]
    for name, x in (("k", k), ("v", v)):
        codes, planes = kv_encode(cfg, x)
        pool_put(cache[name], layer, page, (off,),
                  codes.reshape(x.shape[0], -1))
        for pl, val in planes.items():
            pool_put(cache[f"{name}_{pl}"], layer, page[:, None],
                      (heads, off[:, None]), val)


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
        pages = pool_take(arr, layer, idx)
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
                       mesh=None, set_len: bool = True
                       ) -> tuple[torch.Tensor, dict]:
    """Prefill ONE prompt [1, S_pad] (the flash kernel through
    ``_prefill_layers``) and write its K/V, page-sized slab by slab, into
    the pages ``table_row`` [S_pad // page_s] (host ints) names, in place:
    one index assignment a cache array a layer. Entries past the prompt
    point at scratch page 0, so whole-page writes need no mask.
    ``set_len=False`` fills pages without admitting a slot (a prefix
    build). Returns (last-token logits [1, V], cache).

    A sequence-parallel ``cfg`` with ``mesh`` is the long-context prefill:
    attention shards the prompt over the mesh's sp axis (ring or
    Ulysses), and a striped pool takes each page on the shard owning
    it."""
    dev = params["embed"].device
    tokens, seq_lens = _tokens(tokens, cfg, dev), _int32(seq_lens, dev)
    n_pg = tokens.shape[1] // page_s
    pages = _int32(np.asarray(table_row)[:n_pg], dev).long()
    span = n_pg * page_s

    def write(c, view, layer, k, v):
        for name, (new, axis) in _kv_planes(c, k, v).items():
            row = new[0].narrow(axis, 0, span)
            if axis == 0:    # values [S, ...] -> [n_pg, ps, ...]
                slabs = row.reshape(n_pg, page_s, *row.shape[1:])
            else:            # planes [KV, S] -> [n_pg, KV, ps]
                slabs = row.reshape(row.shape[0], n_pg, page_s).transpose(0, 1)
            pool_put(view[name], layer, pages.to(slabs.device), (), slabs)

    logits = _prefill_layers(params, tokens, seq_lens, cfg, cache, write,
                             mesh)
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

    def attend(c, view, layer, q, k, v):
        d = q.device
        _write_paged(c, view, layer, k[0], v[0], page_d.to(d), off_d.to(d))
        k_virt, v_virt = _virtual_kv(c, _gather_pages(c, view, layer,
                                                      virt.to(d), 1))
        return flash_attention(q.contiguous(), k_virt, v_virt, causal=True,
                               q_offset=start)

    x = _blocks(params, cfg, x, cos, sin, attend, cache)
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

    def attend(c, view, layer, q, k, v):
        d = q.device
        _write_paged(c, view, layer, k[:, 0], v[:, 0], page.to(d), off.to(d))
        return _paged_attention(c, q.contiguous(), view, layer, virt.to(d),
                                kv_len.to(d))

    x = _blocks(params, cfg, x, cos, sin, attend, cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _head(params, x[:, 0])
    cache["len"].copy_(torch.clamp(kv_len, max=s_virt))
    return logits, cache


@torch.no_grad()
def sp_paged_decode_step(params: dict, tokens, cache: dict, table,
                         cfg: LlamaConfig, mesh, n_cols: int | None = None
                         ) -> tuple[torch.Tensor, dict]:
    """``paged_decode_step`` against a pool STRIPED over the mesh's sp
    axis (``init_paged_cache(mesh=)``; JAX's ``sp_paged_decode_step``):
    shard d owns pages ``[d * N/sp, (d+1) * N/sp)``, and the host allocator
    round-robins a slot's pages across the shards, so one request's KV
    spans every shard. The new token's K/V row is written only by the
    page's owner. Each shard gathers its own pages of every row's first
    ``n_cols`` table columns (all by default) into a virtual sequence,
    masks the pages it does not own and the positions past ``len``, and
    runs the grouped softmax over them; the shards combine exactly (one
    pmax, two psums: ``parallel.ring.combine_decode``). Activations and
    weights stay on the mesh's first device (the params' device), as
    JAX's replicated layers do; only the pool is sharded. int8 and int4
    pages dequantize on their own shard. ``table`` holds GLOBAL page ids,
    as the single-device layout's. The pool is updated in place, ``len``
    too (capped at P_max * ps)."""
    from ..parallel.ring import combine_decode

    dev = params["embed"].device
    tokens = torch.as_tensor(tokens).to(dev)
    if not torch.is_tensor(table):
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
    kv_len = pos + 1
    pool = {name: arr for name, arr in cache.items() if name != "len"}
    vpos = torch.arange(n * page_s, device=dev).reshape(n, page_s)
    views = []  # per shard: (shard, local gather index, valid [B, S])
    for d, sdev, _ in cache["k"].blocks():
        ltab, owned = cache["k"].local(d, table[:, :n].long())
        valid = (owned[:, :, None] & (vpos.to(sdev)[None]
                                      < kv_len.to(sdev)[:, None, None]))
        views.append((d, ltab.reshape(-1), valid.reshape(b, -1)))
    x = _embed(params, tokens, cfg)[:, None, :]
    cos, sin = rope_table(pos[:, None], cfg.head_dim, cfg.rope_theta,
                          scaling=cfg.rope_scaling)

    def attend(c, _, layer, q, k, v):
        _write_paged(c, cache, layer, k[:, 0], v[:, 0], page, off)
        parts = []
        for d, ltab, valid in views:
            local = {name: arr.block_of(d) for name, arr in pool.items()}
            k_virt, v_virt = _virtual_kv(
                c, _gather_pages(c, local, layer, ltab, b))
            parts.append((k_virt, v_virt, valid))
        return combine_decode(q[:, 0], parts, x.dtype)

    x = _blocks(params, cfg, x, cos, sin, attend)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _head(params, x[:, 0])
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

    def attend(c, view, layer, q, k, v):
        d = q.device
        _write_paged(c, view, layer, k.reshape(b * w, *k.shape[2:]),
                     v.reshape(b * w, *v.shape[2:]), page.to(d), off.to(d))
        return _paged_attention(c, q.contiguous(), view, layer, virt.to(d),
                                kv_len.to(d))

    x = _blocks(params, cfg, x, cos, sin, attend, cache)
    return _window_logits(params, cfg, x), cache
