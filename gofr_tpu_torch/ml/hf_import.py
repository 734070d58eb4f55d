"""Real weights: HF-layout Llama checkpoints and tokenizers — counterpart of
``gofr_tpu/ml/hf_import.py``.

An HF model directory (``config.json`` + ``*.safetensors``, and optionally
``tokenizer.json``) becomes the port's stacked ``[n_layers, ...]`` param
tree and its ``BPETokenizer``, so ``LLAMA_CKPT=/path/to/hf_model`` serves
real weights.

- **safetensors is parsed from scratch** (``read_safetensors``): an 8-byte
  little-endian header length, a JSON header of ``{name: {dtype, shape,
  data_offsets}}``, then the raw little-endian bytes, memory-mapped.
  ``write_safetensors`` writes the same format (the ``Checkpointer``
  stores its leaves in it). BF16 is the uint16 pattern viewed as
  ``torch.bfloat16``: neither ``safetensors`` nor ``ml_dtypes`` is needed.
- **Streaming**: ``import_hf_llama`` maps one tensor at a time, copies it to
  the device and unmaps it, and writes it (transposed on the device) into
  its slice of the preallocated stacked weight. A whole model never exists
  in host memory: the host holds at most one mapped tensor's pages.
- **Layout**: ``nn.Linear`` stores ``[out, in]``; the port's matmuls take
  ``[in, out]``, so every projection is transposed. RoPE needs no
  permutation: ``ops.apply_rope`` rotates halves, as HF's modeling_llama.
- **Sharded checkpoints**: ``model.safetensors.index.json``'s weight_map
  names each tensor's shard; without it every ``*.safetensors`` file is
  searched.
"""

from __future__ import annotations

import contextlib
import json
import mmap
import os
import struct
from typing import Any, Iterator

import torch

__all__ = ["read_safetensors", "write_safetensors", "hf_config",
           "import_hf_llama", "load_hf_tokenizer", "is_hf_dir"]

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {dt: name for name, dt in _ST_DTYPES.items()}


def _st_dtype(name: str) -> torch.dtype:
    try:
        return _ST_DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported safetensors dtype {name!r}") from None


def _header(path: str) -> tuple[dict, int]:
    """(the JSON header without ``__metadata__``, the data's file offset)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def _view(buf, offset: int, meta: dict) -> torch.Tensor:
    """The tensor ``meta`` describes over ``buf`` at ``offset`` (no copy
    unless its bytes sit off their dtype's alignment)."""
    dt = _st_dtype(meta["dtype"])
    beg, end = meta["data_offsets"]
    shape = meta["shape"]
    if end == beg:
        return torch.empty(shape, dtype=dt)
    raw = torch.frombuffer(buf, dtype=torch.uint8, count=end - beg,
                           offset=offset + beg)
    if (offset + beg) % dt.itemsize:
        raw = raw.clone()
    return raw.view(dt).reshape(shape)


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Parse one .safetensors file: {tensor name: CPU tensor}. The tensors
    are views into one private memory map of the file: reading a tensor
    touches only its pages."""
    header, start = _header(path)
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        # a private (copy-on-write) map: writable, so torch takes it
        # without a warning, and a write never reaches the file
        buf = (mmap.mmap(f.fileno(), size, access=mmap.ACCESS_COPY)
               if size else b"")
    return {name: _view(buf, start, meta) for name, meta in header.items()}


@contextlib.contextmanager
def _mapped(path: str, start: int, meta: dict) -> Iterator[torch.Tensor]:
    """One tensor of a safetensors file over a map of its own bytes, which
    is closed (its pages leave the process) when the block ends; the
    caller copies what it keeps."""
    beg, end = meta["data_offsets"]
    if end == beg:
        yield torch.empty(meta["shape"], dtype=_st_dtype(meta["dtype"]))
        return
    lo = (start + beg) // mmap.ALLOCATIONGRANULARITY \
        * mmap.ALLOCATIONGRANULARITY
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), start + end - lo,
                       access=mmap.ACCESS_COPY, offset=lo)
    try:
        yield _view(mm, start - lo, meta)
    finally:
        try:
            mm.close()
        except BufferError:
            pass  # a view outlived the block: the map closes with it


def write_safetensors(path: str, tensors: dict[str, torch.Tensor]) -> None:
    """Write ``tensors`` (any device; copied to the host one at a time) as
    one .safetensors file, in the order given."""
    header: dict[str, Any] = {}
    off = 0
    for name, t in tensors.items():
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            if t.numel():
                host = t.detach().contiguous().cpu().reshape(-1)
                f.write(memoryview(host.view(torch.uint8).numpy()))
        f.flush()
        os.fsync(f.fileno())


class _ShardedWeights:
    """Where each tensor of an HF directory lives: (file, data offset,
    header entry), across one or many shards, headers read lazily."""

    def __init__(self, model_dir: str) -> None:
        self.model_dir = model_dir
        self._headers: dict[str, tuple[dict, int]] = {}
        index = os.path.join(model_dir, "model.safetensors.index.json")
        if os.path.isfile(index):
            with open(index) as f:
                self.weight_map: dict[str, str] | None = (
                    json.load(f)["weight_map"])
        else:
            self.weight_map = None
            self._files = sorted(fn for fn in os.listdir(model_dir)
                                 if fn.endswith(".safetensors"))
            if not self._files:
                raise FileNotFoundError(
                    f"no .safetensors files in {model_dir}")

    def _shard(self, fn: str) -> tuple[dict, int]:
        if fn not in self._headers:
            self._headers[fn] = _header(os.path.join(self.model_dir, fn))
        return self._headers[fn]

    def _locate(self, name: str) -> tuple[str, int, dict]:
        if self.weight_map is None:
            files = self._files
        else:
            files = [self.weight_map[name]] if name in self.weight_map else []
        for fn in files:
            header, start = self._shard(fn)
            if name in header:
                return os.path.join(self.model_dir, fn), start, header[name]
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        try:
            self._locate(name)
            return True
        except KeyError:
            return False

    def load(self, name: str, dst: torch.Tensor, transpose: bool) -> None:
        """Tensor ``name`` (transposed when asked) into ``dst``: mapped,
        copied to ``dst``'s device whole, transposed and cast there."""
        path, start, meta = self._locate(name)
        with _mapped(path, start, meta) as t:
            src = t.to(dst.device)  # the whole tensor in one copy
            dst.copy_(src.T if transpose else src)
            del src, t


def is_hf_dir(path: str | None) -> bool:
    """True when ``path`` looks like an HF model directory (config.json +
    safetensors): ``LLAMA_CKPT`` may name it or a ``Checkpointer`` run."""
    if not path or not os.path.isdir(path):
        return False
    if not os.path.isfile(os.path.join(path, "config.json")):
        return False
    return (os.path.isfile(os.path.join(path, "model.safetensors.index.json"))
            or any(fn.endswith(".safetensors") for fn in os.listdir(path)))


def hf_config(model_dir: str, **overrides: Any):
    """config.json -> LlamaConfig (serving knobs pass through
    ``overrides``). An unsupported ``rope_scaling`` raises here, at load
    time. The config also carries ``eos_id`` (an int or a list, as
    config.json gives it) and ``tie_word_embeddings``."""
    from ..models.llama import LlamaConfig
    from ..ops import scale_rope_freqs

    with open(os.path.join(model_dir, "config.json")) as f:
        hc = json.load(f)
    kw = dict(
        vocab_size=hc["vocab_size"],
        dim=hc["hidden_size"],
        n_layers=hc["num_hidden_layers"],
        n_heads=hc["num_attention_heads"],
        n_kv_heads=hc.get("num_key_value_heads", hc["num_attention_heads"]),
        ffn_dim=hc["intermediate_size"],
        max_seq_len=hc.get("max_position_embeddings", 8192),
        # HF's LlamaConfig default (Llama-2 era configs omit it)
        rope_theta=float(hc.get("rope_theta", 10_000.0)),
        norm_eps=float(hc.get("rms_norm_eps", 1e-5)),
        # Llama-3.1/3.2 scale their rotations past the original context
        rope_scaling=hc.get("rope_scaling") or None,
    )
    kw.update(overrides)
    cfg = LlamaConfig(**kw)
    if cfg.rope_scaling is not None:
        half = cfg.head_dim // 2
        scale_rope_freqs(1.0 / (cfg.rope_theta ** (
            torch.arange(half, dtype=torch.float32) / half)),
            cfg.rope_scaling)
    cfg.eos_id = hc.get("eos_token_id")
    cfg.tie_word_embeddings = bool(hc.get("tie_word_embeddings", False))
    return cfg


_PROJS = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
          "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
          "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
          "w_down": "mlp.down_proj"}
_NORMS = {"attn_norm": "input_layernorm",
          "mlp_norm": "post_attention_layernorm"}


def import_hf_llama(model_dir: str, cfg=None, device=None) -> tuple[Any, dict]:
    """HF Llama checkpoint directory -> (LlamaConfig, stacked param tree) on
    ``device`` (default the first CUDA card; ``"cpu"`` for the host).

        model.embed_tokens.weight              embed         [V, D]
        model.layers.{i}.input_layernorm       layers/attn_norm  [L, D] f32
        model.layers.{i}.self_attn.q_proj      layers/wq     [L, D, H*hd]
        ...k_proj / v_proj / o_proj            wk / wv / wo
        model.layers.{i}.post_attention_layernorm  layers/mlp_norm
        model.layers.{i}.mlp.gate_proj/up_proj/down_proj  w_gate/w_up/w_down
        model.norm.weight                      final_norm    [D] f32
        lm_head.weight (or the tied embedding) lm_head       [D, V]

    Projections are transposed to [in, out] and cast to ``cfg.dtype``,
    norms to f32, layers stacked on a leading [L] axis: the layout of
    ``init_params`` and ``params_from_jax``."""
    from .. import resolve_device
    from ..models.llama import _param_shapes

    device = resolve_device(device)
    if cfg is None:
        cfg = hf_config(model_dir)
    w = _ShardedWeights(model_dir)
    L, D, V, dt = cfg.n_layers, cfg.dim, cfg.vocab_size, cfg.dtype

    def empty(shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=device)

    embed = empty((V, D))
    w.load("model.embed_tokens.weight", embed, transpose=False)
    lm_head = empty((D, V))
    if getattr(cfg, "tie_word_embeddings", False) or "lm_head.weight" not in w:
        lm_head.copy_(embed.T)
    else:
        w.load("lm_head.weight", lm_head, transpose=True)
    layers = {k: empty((L, D), torch.float32) for k in _NORMS}
    layers.update({k: empty(shape)
                   for k, (shape, _) in _param_shapes(cfg).items()})
    for i in range(L):
        base = f"model.layers.{i}"
        for ours, hf in _NORMS.items():
            w.load(f"{base}.{hf}.weight", layers[ours][i], transpose=False)
        for ours, hf in _PROJS.items():
            w.load(f"{base}.{hf}.weight", layers[ours][i], transpose=True)
    final_norm = empty((D,), torch.float32)
    w.load("model.norm.weight", final_norm, transpose=False)
    return cfg, {"embed": embed, "layers": layers, "final_norm": final_norm,
                 "lm_head": lm_head}


# -- tokenizer.json (HF tokenizers byte-level BPE) -> BPETokenizer ---------------

def _gpt2_byte_decoder() -> dict[str, int]:
    """The GPT-2 printable-unicode <-> byte bijection of every byte-level
    BPE tokenizer (Llama-3, GPT-2, Qwen, Mistral v3): printable bytes keep
    their codepoint, the rest map to 256+n."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs, strict=True)}


def _token_bytes(tok: str, byte_decoder: dict[str, int]) -> bytes:
    try:
        return bytes(byte_decoder[ch] for ch in tok)
    except KeyError:
        # added/special tokens are literal text, not byte-encoded
        return tok.encode("utf-8")


def load_hf_tokenizer(path: str, *, use_native: bool = True):
    """``tokenizer.json`` (or a model dir holding one) -> the port's
    ``BPETokenizer``. Decode is exact; encode runs merge-rank BPE over raw
    bytes without HF's regex pre-tokenizer, as in the JAX package.
    ``use_native`` is accepted for the JAX signature and has no effect
    (the port's tokenizer is pure Python)."""
    from ..tokenizer import BPETokenizer

    del use_native
    if os.path.isdir(path):
        path = os.path.join(path, "tokenizer.json")
    with open(path, encoding="utf-8") as f:
        tj = json.load(f)
    model = tj["model"]
    if model.get("type") not in (None, "BPE"):
        raise ValueError(f"unsupported tokenizer model {model.get('type')!r}")
    dec = _gpt2_byte_decoder()
    vocab_map: dict[str, int] = model["vocab"]
    size = max(vocab_map.values()) + 1
    vocab: list[bytes] = [b""] * size
    for tok, idx in vocab_map.items():
        vocab[idx] = _token_bytes(tok, dec)
    specials: dict[str, int] = {}
    for added in tj.get("added_tokens", ()):
        idx = added["id"]
        if idx >= size:
            vocab.extend([b""] * (idx + 1 - size))
            size = idx + 1
        vocab[idx] = added["content"].encode("utf-8")
        specials[added["content"]] = idx
    merges = []
    for m in model.get("merges", ()):
        left, right = m.split(" ", 1) if isinstance(m, str) else m
        li, ri = vocab_map.get(left), vocab_map.get(right)
        mi = vocab_map.get(left + right)
        if li is None or ri is None or mi is None:
            continue  # a merge over tokens outside the vocab: unreachable
        merges.append((li, ri, mi))
    # byte -> base token id (the single-char byte-level tokens)
    enc = {b: ch for ch, b in dec.items()}
    byte_map = [vocab_map.get(enc[b], 0) for b in range(256)]
    return BPETokenizer(vocab, merges, byte_map, specials=specials)
