"""MNIST MLP classifier — counterpart of ``gofr_tpu/models/mlp.py``,
BASELINE config #2's model.

Params are a list of ``{"w": [in, out], "b": [out] f32}`` layers, the JAX
tree's layout; ``apply`` is a pure function the engine runs (and on a card
captures, one CUDA graph per batch shape). The hidden layers run in the
weights' dtype (bf16, as JAX's ``x.astype(bfloat16)``) with the bias cast
to it; the logits come back in f32 with the f32 bias added. ``loss`` is the
mean cross-entropy the trainer (``ml.train``) differentiates, as JAX's.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import normal, tensor_from_numpy

__all__ = ["MLP", "mnist_mlp", "params_from_jax"]


def _init_linear(gen: torch.Generator, in_dim: int, out_dim: int,
                 device) -> dict:
    return {"w": normal(gen, (in_dim, out_dim), (2.0 / in_dim) ** 0.5,
                        torch.bfloat16, device),
            "b": torch.zeros((out_dim,), dtype=torch.float32, device=device)}


def params_from_jax(tree: list, device=None) -> list:
    """The JAX MLP's params (``jax.tree.map(np.asarray, model.params)``) ->
    the port's on ``device``, bit for bit."""
    from .. import resolve_device

    device = resolve_device(device)
    return [{k: tensor_from_numpy(layer[k], device) for k in ("w", "b")}
            for layer in tree]


class MLP:
    """Feed-forward classifier: input -> hidden... -> logits. ``params``
    (e.g. from ``params_from_jax``) replaces the seeded draw."""

    def __init__(self, sizes: tuple[int, ...] = (784, 512, 512, 10),
                 seed: int = 0, *, device=None, params: list | None = None
                 ) -> None:
        from .. import resolve_device

        self.sizes = tuple(sizes)
        if params is None:
            self.device = resolve_device(device)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = [_init_linear(gen, a, b, self.device)
                      for a, b in zip(self.sizes[:-1], self.sizes[1:],
                                      strict=True)]
        else:
            self.device = params[0]["w"].device
        self.params = params
        self.example_inputs = (np.zeros((1, self.sizes[0]), np.float32),)

    @staticmethod
    def apply(params: Any, x: torch.Tensor) -> torch.Tensor:
        h = x.to(params[0]["w"].dtype)
        for layer in params[:-1]:
            h = torch.relu(h @ layer["w"] + layer["b"].to(h.dtype))
        last = params[-1]
        return (h @ last["w"]).float() + last["b"]

    @staticmethod
    def loss(params: Any, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Mean cross-entropy of the f32 logits against int labels ``y``."""
        logp = torch.log_softmax(MLP.apply(params, x), dim=-1)
        return -torch.gather(logp, 1, y.long()[:, None]).mean()


def mnist_mlp(hidden: int = 512, seed: int = 0, *, device=None,
              params: list | None = None) -> MLP:
    return MLP((784, hidden, hidden, 10), seed, device=device, params=params)
