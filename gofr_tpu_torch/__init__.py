"""PyTorch/CUDA port of the gofr-tpu ML serving path, for NVIDIA Hopper.

The JAX package ``gofr_tpu`` is the reference; this package keeps its
module names (``ops``, ``models.llama``, ``ml.generate``, ``ml.llm``) so a
reader can find each counterpart, and imports nothing from it. The two
Pallas kernels on the serving path are CUDA C++ kernels here
(``ops/csrc``), compiled with ``nvcc`` for ``sm_90a`` on first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without an explicit ``cpu`` they raise instead of
quietly running on the host. The framework's names are exported as
``gofr_tpu`` exports them (``new_app``, ``App``, ``Context``, ``errors``,
``Raw``, ``Redirect``, ``Response``, ``Template``, ``File``,
``EventStream``, ``UploadedFile``, ``Zip``, ``Migrate``, the config and
logging types), imported on first use so ``import gofr_tpu_torch`` stays
torch alone.
"""

from __future__ import annotations

import torch

# name -> the module that defines it
_EXPORTS = {
    "App": "app", "new_app": "app", "Context": "context",
    "Config": "config", "EnvConfig": "config", "MapConfig": "config",
    "Zip": "fileutil", "errors": "http", "UploadedFile": "http.request",
    "File": "http.response", "Raw": "http.response",
    "Redirect": "http.response", "Response": "http.response",
    "Template": "http.response", "EventStream": "http.sse",
    "Level": "logging", "Logger": "logging", "new_logger": "logging",
    "Migrate": "migration"}

__all__ = ["resolve_device", "new", *_EXPORTS]


def __getattr__(name: str):
    if name == "new":  # the JAX package's constructor alias
        name = "new_app"
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(f".{_EXPORTS[name]}",
                                               __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
