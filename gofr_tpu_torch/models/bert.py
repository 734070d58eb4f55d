"""BERT-family encoder — counterpart of ``gofr_tpu/models/bert.py``,
BASELINE config #3's model (embeddings over gRPC unary at batch 32) and
config #5's text encoder.

The JAX tree's layout and dtype flow: layer weights STACKED on a leading
[n_layers] axis (the ``lax.scan`` becomes a Python loop over them), bf16
matmuls with the f32 biases cast to bf16, ``layer_norm`` with f32
statistics, GELU in ``jax.nn.gelu``'s tanh form, the pooler in f32.
Attention is the plain ``ops.attention``, bidirectional, masked only by
``kv_len=seq_lens``, so a padded row from the dynamic batcher embeds as
its unpadded sequence. Token ids outside the vocabulary are wrapped and
clamped on the device as JAX's gather does (a torch gather would fault).

Tensor parallelism: ``sharding_specs`` returns JAX's rules
(``SHARDING_RULES``); params split by them over a mesh with tp > 1
(``parallel.shard_params``) carry their sharding. Each layer runs a shard
at a time (unsplit params are one shard holding every weight whole): the
shard's heads of the column-parallel q/k/v (with its slice of the
replicated biases) through ``ops.attention``, its rows of ``wo``, its ffn
slice, a ``psum`` after each row-parallel product (the bias added once
after it), and the pooler's column blocks joined by ``all_gather``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops import attention, gelu, layer_norm
from ..parallel import P, all_gather, psum, shards_of, specs_from_rules
from . import normal, tensor_from_numpy

__all__ = ["BertConfig", "Bert", "bert_base", "tiny_bert", "init_params",
           "params_from_jax", "forward", "SHARDING_RULES"]

_LAYER_KEYS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo",
               "attn_norm_scale", "attn_norm_bias", "w_in", "b_in", "w_out",
               "b_out", "mlp_norm_scale", "mlp_norm_bias")


class BertConfig:
    def __init__(
        self,
        vocab_size: int = 30_522,
        dim: int = 768,
        n_layers: int = 12,
        n_heads: int = 12,
        ffn_dim: int = 3072,
        max_pos: int = 512,
        n_types: int = 2,
        norm_eps: float = 1e-12,
        dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        self.vocab_size = vocab_size
        self.dim = dim
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.head_dim = dim // n_heads
        self.ffn_dim = ffn_dim
        self.max_pos = max_pos
        self.n_types = n_types
        self.norm_eps = norm_eps
        self.dtype = dtype


def bert_base(**kw) -> BertConfig:
    return BertConfig(**kw)


def tiny_bert(**kw) -> BertConfig:
    defaults = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                    ffn_dim=128, max_pos=64)
    defaults.update(kw)
    return BertConfig(**defaults)


SHARDING_RULES = (
    (r"layers/(wq|wk|wv|w_in)", P(None, None, "tp")),   # column parallel
    (r"layers/(wo|w_out)", P(None, "tp", None)),        # row parallel
    (r"layers/", P(None)),                              # biases/norms replicate
    (r"pooler/w", P(None, "tp")),
    (r".*", P()),
)


def init_params(cfg: BertConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random weights in ``cfg.dtype`` from ``generator`` (on ``device``),
    biases zero and norms one in f32, the JAX tree's layout."""
    from .. import resolve_device

    device = resolve_device(device)
    L, D, F = cfg.n_layers, cfg.dim, cfg.ffn_dim

    def dense(*shape, fan_in):
        return normal(generator, shape, fan_in ** -0.5, cfg.dtype, device)

    def const(value, *shape):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    return {
        "tok_embed": dense(cfg.vocab_size, D, fan_in=D),
        "pos_embed": dense(cfg.max_pos, D, fan_in=D),
        "type_embed": dense(cfg.n_types, D, fan_in=D),
        "embed_norm_scale": const(1.0, D),
        "embed_norm_bias": const(0.0, D),
        "layers": {
            "wq": dense(L, D, D, fan_in=D),
            "wk": dense(L, D, D, fan_in=D),
            "wv": dense(L, D, D, fan_in=D),
            "wo": dense(L, D, D, fan_in=D),
            "bq": const(0.0, L, D),
            "bk": const(0.0, L, D),
            "bv": const(0.0, L, D),
            "bo": const(0.0, L, D),
            "attn_norm_scale": const(1.0, L, D),
            "attn_norm_bias": const(0.0, L, D),
            "w_in": dense(L, D, F, fan_in=D),
            "b_in": const(0.0, L, F),
            "w_out": dense(L, F, D, fan_in=F),
            "b_out": const(0.0, L, D),
            "mlp_norm_scale": const(1.0, L, D),
            "mlp_norm_bias": const(0.0, L, D),
        },
        "pooler": {"w": dense(D, D, fan_in=D),
                   "b": const(0.0, D)},
    }


def params_from_jax(tree: dict, device=None) -> dict:
    """The JAX tree as numpy arrays (``jax.tree.map(np.asarray,
    bert.init_params(cfg, key))``) -> the port's params on ``device``, bit
    for bit."""
    from .. import resolve_device

    device = resolve_device(device)

    def leaf(a):
        return tensor_from_numpy(a, device)

    return {
        **{k: leaf(tree[k]) for k in ("tok_embed", "pos_embed", "type_embed",
                                      "embed_norm_scale", "embed_norm_bias")},
        "layers": {k: leaf(tree["layers"][k]) for k in _LAYER_KEYS},
        "pooler": {k: leaf(tree["pooler"][k]) for k in ("w", "b")},
    }


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with JAX's gather semantics: a negative id counts from
    the end, then every id is clamped into the table."""
    n = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)
    return table[ids]


def forward(params: dict, tokens: torch.Tensor, cfg: BertConfig, *,
            seq_lens: torch.Tensor | None = None,
            token_types: torch.Tensor | None = None) -> dict:
    """tokens [B, S] (+ optional [B] valid lengths) -> {"hidden": [B, S, D],
    "pooled": [B, D] f32, "mean": [B, D] f32}: pooled is the tanh-projected
    [CLS], mean the masked mean over the valid positions."""
    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device)
    x = take_rows(params["tok_embed"], tokens)
    x = x + take_rows(params["pos_embed"], pos)[None]
    types = token_types if token_types is not None else torch.zeros_like(tokens)
    x = x + take_rows(params["type_embed"], types)
    x = layer_norm(x.to(cfg.dtype), params["embed_norm_scale"],
                   params["embed_norm_bias"], cfg.norm_eps)

    for i in range(cfg.n_layers):
        x = _layer(params["layers"], i, x, cfg, seq_lens)

    x0 = x[:, 0].float()
    proj = all_gather([x0.to(w.device) @ w.float()
                       for w in shards_of(params["pooler"]["w"])], -1,
                      to=x.device)
    pooled = torch.tanh(proj + params["pooler"]["b"])
    if seq_lens is not None:
        mask = (pos[None, :] < seq_lens[:, None]).float()
    else:
        mask = torch.ones((b, s), dtype=torch.float32, device=tokens.device)
    mean = (x.float() * mask[..., None]).sum(1) / torch.clamp(
        mask.sum(1, keepdim=True), min=1.0)
    return {"hidden": x, "pooled": pooled, "mean": mean}


def _column(x, w, layer: int, bias, dt) -> list:
    """A column-parallel product a shard at a time: ``x`` [.., D] on each
    block's device times its [D, F/tp] block of ``w[layer]`` (the whole
    weight, one block, when it is not split), plus its slice of the
    replicated ``bias`` [F]."""
    out = []
    for d, blk in enumerate(shards_of(w)):
        n = blk.shape[-1]
        out.append(x.to(blk.device) @ blk[layer]
                   + bias[d * n:(d + 1) * n].to(blk.device, dt))
    return out


def _layer(layers: dict, i: int, x, cfg: BertConfig, seq_lens):
    """Encoder layer ``i``, a shard at a time (module docstring); unsplit
    weights are one shard."""
    b, s, _ = x.shape
    dt, hd = cfg.dtype, cfg.head_dim
    qs, ks, vs = (_column(x, layers[w], i, layers[bn][i], dt)
                  for w, bn in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
    parts = []
    for q, k, v, wo in zip(qs, ks, vs, shards_of(layers["wo"]), strict=True):
        o = attention(q.reshape(b, s, -1, hd), k.reshape(b, s, -1, hd),
                      v.reshape(b, s, -1, hd), causal=False,
                      kv_len=None if seq_lens is None
                      else seq_lens.to(q.device))
        parts.append(o.reshape(b, s, -1) @ wo[i])
    o = psum(parts, to=x.device) + layers["bo"][i].to(dt)
    x = layer_norm(x + o, layers["attn_norm_scale"][i],
                   layers["attn_norm_bias"][i], cfg.norm_eps)
    hs = _column(x, layers["w_in"], i, layers["b_in"][i], dt)
    h = psum([gelu(h) @ w[i] for h, w in zip(hs, shards_of(layers["w_out"]),
                                              strict=True)], to=x.device)
    h = h + layers["b_out"][i].to(dt)
    return layer_norm(x + h, layers["mlp_norm_scale"][i],
                      layers["mlp_norm_bias"][i], cfg.norm_eps)


class Bert:
    """Engine-facing wrapper: ``apply(params, tokens, seq_lens)`` returns the
    masked-mean sentence embedding (the gRPC Embed payload). ``params``
    (e.g. from ``params_from_jax``) replaces the seeded draw."""

    def __init__(self, cfg: BertConfig | None = None, seed: int = 0, *,
                 device=None, params: dict | None = None) -> None:
        from .. import resolve_device

        self.cfg = cfg or bert_base()
        if params is None:
            self.device = resolve_device(device)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(self.cfg, gen, self.device)
        else:
            self.device = params["tok_embed"].device
        self.params = params
        self.example_inputs = (
            np.zeros((1, 16), np.int32),
            np.full((1,), 16, np.int32),
        )

    def apply(self, params: Any, tokens, seq_lens):
        return forward(params, tokens, self.cfg, seq_lens=seq_lens)["mean"]

    def sharding_specs(self):
        return specs_from_rules(self.params, SHARDING_RULES)
