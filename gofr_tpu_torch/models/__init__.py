"""Models of the port: ``llama`` (the Llama-3 decoder of the chat path),
``mlp`` (the MNIST classifier), ``bert`` (the encoder of the embeddings
service and of the text-to-image prompt), ``diffusion`` (the DiT and its
DDIM sampler) and ``moe`` (the Mixture-of-Experts layer).
``tensor_from_numpy`` carries a JAX parameter leaf across bit for bit,
``tree_from_numpy`` a whole tree (the MoE tree, stage-stacked pipeline
parameters); ``normal`` draws a seeded weight."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["tensor_from_numpy", "tree_from_numpy", "normal"]


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy -> torch, bit for bit. bfloat16 (``ml_dtypes``, the dtype JAX
    hands to numpy) goes through its raw 16-bit pattern."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def tree_from_numpy(tree, device):
    """A tree of numpy leaves (``jax.tree.map(np.asarray, params)``) as the
    same tree of tensors on ``device``, each leaf bit for bit."""
    from ..ml.tree import tree_map

    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def normal(generator: torch.Generator, shape, std: float,
           dtype: torch.dtype, device) -> torch.Tensor:
    """N(0, std²) drawn in f32 on ``device`` from ``generator`` (which lives
    there), then cast to ``dtype``. The draws are not JAX's: a test that
    holds a model against the JAX package carries the JAX tree across with
    the model's ``params_from_jax``."""
    draw = torch.randn(tuple(shape), generator=generator, device=device,
                       dtype=torch.float32)
    return draw.mul_(std).to(dtype)
