"""The native executor — counterpart of ``gofr_tpu/native/pjrt.py``.

JAX traces a function to StableHLO and its own C binding compiles and runs
it on a PJRT plugin. Here ``torch.export`` traces, AOTInductor compiles
ahead of time into a model package (a ``.pt2`` holding a shared library,
with the Triton kernels embedded on a card), and the port's own C++
binding (``aoti_shim.cpp``) loads the package and runs it without the GIL:

    path = compile(fn, example_args, device=dev)   # fn(*tensors) -> tensors
    exe = Executable(path, dev)
    outs = exe.run(*tensors)                       # list of tensors
    exe.destroy()

``compile`` exports a module whose ``forward(*leaves)`` calls ``fn`` and
returns its outputs flattened; every tensor ``fn`` needs is an argument
(the engine passes its resident params as the leading ones), so the package
holds code and no weights. Packages are cached on disk in ``PACKAGE_DIR``
(``build/gofr_tpu_torch/aoti/``), keyed by the exported graph's code
and constants, the input signature, the device type and the torch version:
a second process with the same function and shapes loads the package
without compiling (``Compiled.cached``).

There is no plugin: JAX's ``PjrtPlugin`` / ``PjrtClient`` / buffers have
no counterpart, tensors are PyTorch's own. An empty program, one the
exporter cannot trace or Inductor cannot compile, raises ``AotiError`` with
the exporter's or compiler's message; so does a run with the wrong number
of inputs ("takes N args"). Nothing falls back to eager.
"""

from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Sequence

import torch

from . import (BUILD_DIR, BuildError, inductor_cxx, load_extension,
               use_build_cache)

__all__ = ["AotiError", "Compiled", "Executable", "PACKAGE_DIR", "compile",
           "export"]

PACKAGE_DIR = BUILD_DIR.parent / "aoti"


class AotiError(RuntimeError):
    """A failure of the native executor: export, compile, load or run."""


class _Flat(torch.nn.Module):
    """The module ``torch.export`` takes: ``forward(*leaves)`` calls
    ``fn``."""

    def __init__(self, fn: Callable[..., Any]) -> None:
        super().__init__()
        self.fn = fn

    def forward(self, *leaves):
        return self.fn(*leaves)


@dataclass
class Compiled:
    """One compiled program: the package, the tree of ``fn``'s outputs, and
    what it cost (``cached``: the package came from disk)."""

    path: Path
    out_spec: Any
    export_s: float
    compile_s: float
    cached: bool


def export(fn: Callable[..., Any], example_args: Sequence[torch.Tensor]):
    """``torch.export`` of ``fn`` over ``example_args`` (non-strict: the
    function's Python runs while tracing). Returns (the exported program,
    the outputs' tree)."""
    from torch.utils import _pytree

    # the outputs' tree, seen while tracing (a closure: export copies the
    # module, not the functions it holds)
    specs: list = []

    def flat(*leaves):
        outs, spec = _pytree.tree_flatten(fn(*leaves))
        specs.append(spec)
        return tuple(outs)

    try:
        ep = torch.export.export(_Flat(flat), tuple(example_args),
                                 strict=False)
    except Exception as exc:
        raise AotiError(f"export: {type(exc).__name__}: {exc}") from exc
    if not ep.graph_signature.user_outputs:
        raise AotiError("export: empty program (the function returns no "
                        "tensor)")
    return ep, specs[-1]


def _distinct(args: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The example inputs with every repeat of a tensor (one object given
    twice: tied weights, ``f(x, x)``) replaced by a copy: export would trace
    the two as one input. A run may still pass the same tensor twice."""
    seen: set[int] = set()
    out = []
    for a in args:
        out.append(a.clone() if id(a) in seen else a)
        seen.add(id(a))
    return out


def _key(ep, example_args: Sequence[torch.Tensor], device_type: str) -> str:
    """What decides the package: the graph's code, its constants' bytes,
    the input signature, the device type and the torch version."""
    h = hashlib.sha256(ep.graph_module.code.encode())
    for name, value in sorted({**ep.constants, **ep.state_dict}.items()):
        h.update(name.encode())
        if isinstance(value, torch.Tensor):
            t = value.detach().cpu().contiguous()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.view(torch.uint8).numpy().tobytes() if t.numel()
                     else b"")
    for a in example_args:
        h.update(f"{tuple(a.shape)}:{a.dtype};".encode())
    h.update(f"{device_type}|{torch.__version__}".encode())
    return h.hexdigest()[:24]


def compile(fn: Callable[..., Any], example_args: Sequence[torch.Tensor], *,
            device) -> Compiled:
    """Export ``fn`` over ``example_args`` (tensors on ``device``) and
    compile it with AOTInductor into a package, or find the package on
    disk. Raises ``AotiError`` with the exporter's or compiler's message."""
    device = torch.device(device)
    use_build_cache()
    cache = PACKAGE_DIR
    t0 = time.perf_counter()
    ep, out_spec = export(fn, _distinct(example_args))
    export_s = time.perf_counter() - t0
    n_in = len(ep.graph_signature.user_inputs)
    n_out = len(ep.graph_signature.user_outputs)
    if n_in != len(example_args):
        raise AotiError(f"export: the program takes {n_in} inputs, not the "
                        f"{len(example_args)} given")
    path = cache / f"{_key(ep, example_args, device.type)}.pt2"
    if path.exists():
        return Compiled(path, out_spec, export_s, 0.0, True)
    cache.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.pt2")
    t0 = time.perf_counter()
    try:
        from torch._inductor import aoti_compile_and_package

        configs = {"aot_inductor.metadata": {
            "gofr_num_inputs": str(n_in), "gofr_num_outputs": str(n_out)}}
        cxx = inductor_cxx()
        if cxx is not None:
            configs["cpp.cxx"] = (None, cxx)
        aoti_compile_and_package(ep, package_path=str(tmp),
                                 inductor_configs=configs)
    except Exception as exc:
        tmp.unlink(missing_ok=True)
        raise AotiError(f"compile: {type(exc).__name__}: {exc}") from exc
    os.replace(tmp, path)  # atomic publish: a racing process loads either
    return Compiled(path, out_spec, export_s, time.perf_counter() - t0,
                    False)


def _shim():
    try:
        mod = load_extension()
    except BuildError as exc:
        raise AotiError(f"the native executor's binding did not build: "
                        f"{exc}") from exc
    mod.set_error_type(AotiError)
    return mod


class Executable:
    """One loaded package: ``run`` its program on tensors of the package's
    device. ``destroy`` frees it (idempotent); a run after it raises."""

    def __init__(self, path, device) -> None:
        device = torch.device(device)
        self.path = Path(path)
        self.device = device
        index = device.index if device.type == "cuda" else -1
        if device.type == "cuda" and index is None:
            index = torch.cuda.current_device()
        self._exe = _shim().Executable(str(self.path), index)

    @property
    def num_inputs(self) -> int:
        return self._exe.num_inputs

    @property
    def num_outputs(self) -> int:
        return self._exe.num_outputs

    @property
    def device_type(self) -> str:
        """The device the package was compiled for, as it reports it."""
        return self._exe.device_type

    def run(self, *inputs: torch.Tensor, stream: int = 0
            ) -> list[torch.Tensor]:
        """Run the program on ``inputs`` (on the package's device), on
        ``stream`` (a raw CUDA stream; 0: the thread's current one) without
        synchronising. The GIL is released while it runs."""
        return self._exe.run(list(inputs), stream)

    def destroy(self) -> None:
        self._exe.destroy()
