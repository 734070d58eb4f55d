"""PyTorch/CUDA port of the gofr-tpu ML serving path, for NVIDIA Hopper.

The JAX package ``gofr_tpu`` is the reference; this package keeps its
module names (``ops``, ``models.llama``, ``ml.generate``, ``ml.llm``) so a
reader can find each counterpart, and imports nothing from it. The two
Pallas kernels on the serving path are CUDA C++ kernels here
(``ops/csrc``), compiled with ``nvcc`` for ``sm_90a`` on first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without an explicit ``cpu`` they raise instead of
quietly running on the host.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    first CUDA card. Raises when no card is present and the caller did not
    ask for the CPU explicitly."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"device {dev} requested but CUDA is not available")
            if dev.index is None:  # "cuda" names the current card
                dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch path "
            "on the host")
    return torch.device("cuda", torch.cuda.current_device())
