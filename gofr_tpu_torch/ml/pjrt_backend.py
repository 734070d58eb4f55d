"""The native executor behind ``Engine(backend="pjrt")`` — counterpart of
``gofr_tpu/ml/pjrt_backend.py``, with JAX's module and class names kept so
a reader finds it.

In JAX, jax only traces (StableHLO on the CPU backend) and the framework's
own PJRT C binding compiles and runs the program on the plugin. There is
no PJRT here. ``PjrtExecutor`` runs ``apply_fn(params, *inputs)`` through
the port's own native executor (``native/aoti.py``): ``torch.export``
traces, AOTInductor compiles ahead of time into a model package, and the
port's C++ binding (``native/aoti_shim.cpp``) loads the package and runs
it with the GIL released. As JAX's:

- the params go to the device once, at construction, and are passed as the
  program's leading inputs (JAX's ``execute_buffers(param_bufs +
  in_bufs)``): they are not baked into the package, so the weights are
  never on the card twice;
- one executable per input signature (shapes and dtypes, after the
  engine's narrowing of 64-bit inputs to 32), compiled at its first use
  (``Engine.warmup_buckets`` pays them at registration), or loaded from
  the disk cache when another executor or process compiled it before;
- outputs come back as numpy in the function's tree; bf16 widens to f32,
  as the port's jit path does;
- ``stats`` = ``{"compiles", "compile_s", "entries"}``, and each
  executable adds a ``ProgramLog`` row ``pjrt/<shape>#n`` of kind
  ``pjrt_native`` (``cache`` ``"disk"`` when the package was loaded, not
  compiled);
- ``close`` frees the params and the executables.

On a card a run goes on the executor's own stream, under the flight
recorder's ``LAUNCH_GATE`` (no profiler start or stop while it is in
flight), and ends in a synchronise before the host copy. Known
differences: there is no plugin, so ``plugin_path`` or ``client_options``
raise ``ValueError``; Inductor fuses and reorders reductions, so the
outputs equal the jit path's within tolerance, not bit for bit.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable

import numpy as np
import torch

from ..flight_recorder import LAUNCH_GATE

__all__ = ["PjrtExecutor"]


def _host(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy()


class PjrtExecutor:
    """Callable that runs ``apply_fn(params, *inputs)`` through the native
    executor on ``device``, with the params resident there."""

    def __init__(self, apply_fn: Callable[..., Any], params: Any, *,
                 device, plugin_path: str | None = None,
                 client_options: dict | None = None,
                 programs: Any = None) -> None:
        from torch.utils import _pytree

        from .. import resolve_device

        if plugin_path is not None or client_options is not None:
            raise ValueError(
                "the port's native executor has no PJRT plugin: it runs "
                "AOTInductor packages through its own binding, so "
                "plugin_path and client_options do not apply")
        self.device = resolve_device(device)
        self._apply = apply_fn
        leaves, self._params_spec = _pytree.tree_flatten(params)
        if not all(isinstance(x, torch.Tensor) for x in leaves):
            raise TypeError("the native executor takes params whose leaves "
                            "are all tensors (the program's inputs)")
        self._param_bufs = [x.to(self.device) for x in leaves]
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._cache: dict[tuple, tuple] = {}
        self.stats = {"compiles": 0, "compile_s": 0.0, "entries": 0}
        self._programs = programs

    @property
    def platform_name(self) -> str:
        """The device type the packages run on (JAX: the plugin's platform
        name)."""
        return self.device.type

    def _fn(self, *leaves):
        """``apply_fn`` over the flat inputs: the param tensors, then the
        call's inputs."""
        from torch.utils import _pytree

        n = len(self._param_bufs)
        params = _pytree.tree_unflatten(list(leaves[:n]), self._params_spec)
        return self._apply(params, *leaves[n:])

    def _compile_for(self, inputs: list[torch.Tensor]) -> tuple:
        """The executable of one input signature: exported and compiled, or
        loaded from the disk cache; one program row."""
        from ..native import aoti

        t0 = time.perf_counter()
        compiled = aoti.compile(self._fn, [*self._param_bufs, *inputs],
                                device=self.device)
        t1 = time.perf_counter()
        exe = aoti.Executable(compiled.path, self.device)
        load_s = time.perf_counter() - t1
        if exe.device_type != self.device.type:
            exe.destroy()
            raise aoti.AotiError(
                f"the package at {compiled.path} runs on "
                f"{exe.device_type!r}, not on {self.device.type!r}")
        wall = time.perf_counter() - t0
        if not compiled.cached:
            self.stats["compiles"] += 1
            self.stats["compile_s"] += compiled.export_s + compiled.compile_s
        self.stats["entries"] = len(self._cache) + 1
        if self._programs is not None:
            shapes = [list(a.shape) for a in inputs]
            first = "x".join(str(s) for s in (shapes[0] if shapes else ()))
            self._programs.record(
                f"pjrt/{first}#{self.stats['entries']}", wall_s=wall,
                kind="pjrt_native", shapes={"inputs": shapes},
                cache="disk" if compiled.cached else "none",
                export_s=round(compiled.export_s, 6),
                compile_s=round(compiled.compile_s, 6),
                load_s=round(load_s, 6))
        return exe, compiled.out_spec

    def __call__(self, *inputs: torch.Tensor) -> Any:
        from torch.utils import _pytree

        sig = tuple((tuple(a.shape), a.dtype) for a in inputs)
        stream = self._stream
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            xs = [a.to(self.device) for a in inputs]
            entry = self._cache.get(sig)
            if entry is None:
                entry = self._cache[sig] = self._compile_for(xs)
            exe, out_spec = entry
            # no profiler start or stop while the run is in flight
            with LAUNCH_GATE.serving():
                outs = exe.run(*self._param_bufs, *xs,
                               stream=stream.cuda_stream if stream else 0)
                if stream is not None:
                    stream.synchronize()
        return _pytree.tree_unflatten([_host(o) for o in outs], out_spec)

    def close(self) -> None:
        for exe, _ in self._cache.values():
            exe.destroy()
        self._cache.clear()
        self._param_bufs = []
