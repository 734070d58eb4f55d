"""Model execution engine — counterpart of ``gofr_tpu/ml/engine.py``.

One engine owns one model: a pure ``apply(params, *inputs)`` with the
params resident on the device, one executor thread that owns all device
work (callers get futures, so the event loop never blocks on a capture or
a copy), and results handed back as numpy arrays, as JAX's ``np.asarray``
does (bf16 widens to f32: numpy has no bf16).

JAX compiles one program per input shape. On a card the port captures one
CUDA graph per input shape instead: the first time a shape is seen (or in
``warmup_buckets``) the apply runs once eagerly on a side stream (library
state, cached tensors), then is captured over static input buffers the
engine owns. Every execute fills those buffers with ``copy_``, replays the
graph and copies the outputs off. A capture or replay that fails raises;
nothing drops to eager on a card. On the CPU each shape runs eagerly. Host
arrays of 64 bits narrow to 32 bits first, as JAX's default (x64 off)
does.

- ``donate_inputs=True`` keeps JAX's promise that a caller's array is
  never consumed; it holds by construction, the static buffers being the
  engine's own, so the flag changes nothing here.
- Each first-seen shape adds a ``ProgramLog`` row ``apply/b{B}``: shapes,
  capture (or first-run) seconds, the graph pool bytes the capture added,
  ``cache`` "none".
- Each execute opens the ``ml.device_step`` span (``ml.model``,
  ``ml.backend``, ``ml.batch``); ``app_tpu_step_seconds{model}`` counts
  successful steps only (JAX's series name, kept for the dashboards).
- ``backend="pjrt"`` (the native executor slot, JAX's PJRT C binding)
  runs the apply through the port's own native executor instead
  (``ml/pjrt_backend.py``: an AOTInductor package per input shape, loaded
  and run by the port's C++ binding without the GIL), on the same executor
  thread; it captures no CUDA graph and writes ``pjrt/…`` rows in place of
  ``apply/b{B}``. There is no fallback: a binding that does not build, an
  export or compile that fails, or a package for another device raises in
  the caller's future. ``plugin_path`` raises (the port has no plugin).
- ``out_sharding`` is a ``(parallel.Mesh, parallel.P)`` pair (JAX's
  ``NamedSharding``): each output is checked against the spec over the
  mesh (``parallel.constrain``: an unknown axis or a dimension it does not
  divide raises in the caller's future) before it returns to the host as
  numpy, as every output does in both packages. Any other backend raises
  JAX's ``ValueError``.
"""

from __future__ import annotations

import asyncio
import concurrent.futures as cf
import queue
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .. import parallel as par
from ..flight_recorder import LAUNCH_GATE
from ..tracing import current_context
from .programs import ProgramLog
from .tree import tree_leaves, tree_map

__all__ = ["Engine", "EngineConfig"]


def _next_bucket(n: int, buckets: Sequence[int] | None) -> int:
    if not buckets:
        return n
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}


def _host_tensor(x: Any) -> torch.Tensor:
    """A caller's input as a tensor: a tensor as it is, anything else as a
    host copy (64-bit narrowed to 32)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.array(x)
    narrow = _NARROW.get(a.dtype)
    return torch.from_numpy(a.astype(narrow) if narrow is not None else a)


def _to_numpy(x: Any) -> Any:
    if not isinstance(x, torch.Tensor):
        return x
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy()


def _param_to(x: Any, device: torch.device) -> Any:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (np.ndarray, np.generic, int, float)):
        return _host_tensor(x).to(device)
    return x


class EngineConfig:
    def __init__(
        self,
        batch_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
        donate_inputs: bool = False,
        warmup: bool = True,
    ) -> None:
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.donate_inputs = donate_inputs
        self.warmup = warmup


class Engine:
    """Owns one model: params on the device, one program per input shape,
    the executor thread. ``device`` defaults to the params' device, else
    the first card."""

    def __init__(
        self,
        name: str,
        apply_fn: Callable[..., Any],
        params: Any,
        *,
        config: EngineConfig | None = None,
        logger=None,
        metrics=None,
        tracer=None,
        example_inputs: tuple | None = None,
        out_sharding=None,
        backend: str = "jit",
        plugin_path: str | None = None,
        device=None,
    ) -> None:
        from .. import resolve_device

        if backend not in ("jit", "pjrt"):
            raise ValueError(f"unknown engine backend {backend!r}")
        if out_sharding is not None:
            pair = (tuple(out_sharding)
                    if isinstance(out_sharding, (tuple, list)) else ())
            if (len(pair) != 2 or not isinstance(pair[0], par.Mesh)
                    or not isinstance(pair[1], par.P)):
                raise TypeError(
                    f"engine {name}: out_sharding is a (parallel.Mesh, "
                    f"parallel.P) pair")
        self.out_sharding = out_sharding
        self.name = name
        self.config = config or EngineConfig()
        self._logger = logger
        self._metrics = metrics
        self._tracer = tracer
        self.backend = backend
        if device is None:
            device = next((x.device for x in tree_leaves(params)
                           if isinstance(x, torch.Tensor)), None)
        self.device = resolve_device(device)
        self.apply_fn = apply_fn
        self.params = tree_map(lambda x: _param_to(x, self.device), params)
        self.compiled_buckets: set[int] = set()  # batch dims seen
        # program telemetry (ml/programs.py): one row per batch bucket,
        # the /debug/programs inventory
        self.programs = ProgramLog()
        # input shape -> (static inputs, graph, static outputs, pool bytes);
        # a card only
        self.graphs: dict[tuple, tuple] = {}
        self._shapes: set[tuple] = set()
        self._pjrt = None
        if backend == "pjrt":
            # the native path: the executor holds the params as the
            # program's leading inputs and writes its own pjrt/… rows
            from .pjrt_backend import PjrtExecutor

            self._pjrt = PjrtExecutor(apply_fn, self.params,
                                      device=self.device,
                                      plugin_path=plugin_path,
                                      programs=self.programs)
        elif self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        self._work: queue.Queue = queue.Queue()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"gofr-ml-{name}")
        self.steps = 0
        self._example_inputs = example_inputs
        self._thread.start()
        if example_inputs is not None and self.config.warmup:
            self.predict_sync(*example_inputs)  # capture before a request

    # -- executor thread ------------------------------------------------------
    def _loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            item = self._work.get()
            if item is None:
                return
            fut, args, parent_ctx = item
            if fut.set_running_or_notify_cancel():
                try:
                    fut.set_result(self._execute(args, parent_ctx))
                except BaseException as exc:  # noqa: BLE001 - relayed via future
                    fut.set_exception(exc)

    def _capture(self, key: tuple, arrays: list) -> tuple:
        """The graph of one input shape over static buffers of the engine's
        own: one eager run on the side stream, then the capture. The entry
        keeps the reserved bytes the capture added to the graph pool."""
        static_in = [torch.empty(a.shape, dtype=a.dtype, device=self.device)
                     for a in arrays]
        for buf, a in zip(static_in, arrays, strict=True):
            buf.copy_(a)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            self.apply_fn(self.params, *static_in)
        reserved0 = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        try:
            # no profiler start or stop (its device synchronize would
            # invalidate the capture) while capturing
            with LAUNCH_GATE.serving(), torch.cuda.stream(self._stream):
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    static_out = self.apply_fn(self.params, *static_in)
                finally:
                    graph.capture_end()
        except Exception as exc:
            raise RuntimeError(
                f"engine {self.name}: CUDA graph capture of input shapes "
                f"{[list(k[0]) for k in key]} failed "
                f"({type(exc).__name__}: {exc})") from exc
        torch.cuda.current_stream(self.device).wait_stream(self._stream)
        pool_bytes = torch.cuda.memory_reserved(self.device) - reserved0
        entry = (static_in, graph, static_out, int(pool_bytes))
        self.graphs[key] = entry
        return entry

    def _run(self, key: tuple, arrays: list) -> Any:
        """One execute: the native executor's run (``backend="pjrt"``), a
        graph replay on a card (captured on first use of the shape), an
        eager run on the CPU."""
        if self._pjrt is not None:
            return self._pjrt(*arrays)
        if self.device.type != "cuda":
            return self.apply_fn(self.params, *arrays)
        entry = self.graphs.get(key)
        if entry is None:
            entry = self._capture(key, arrays)
        static_in, graph, static_out, _ = entry
        for buf, a in zip(static_in, arrays, strict=True):
            buf.copy_(a)
        graph.replay()
        return static_out

    def _execute(self, inputs: tuple, parent_ctx=None) -> Any:
        span = None
        if self._tracer is not None:
            # the caller's span context was captured at enqueue (contexts do
            # not follow the hop to this thread); activate=False keeps the
            # span from leaking into the thread's next item
            span = self._tracer.start_span(
                "ml.device_step", parent=parent_ctx, activate=False,
                attributes={"ml.model": self.name, "ml.backend": self.backend},
            )
        start = time.perf_counter()
        arrays: list | None = None
        batch = None
        try:
            arrays = [_host_tensor(x) for x in inputs]
            if arrays and arrays[0].dim() > 0:
                batch = int(arrays[0].shape[0])
            key = tuple((tuple(a.shape), a.dtype) for a in arrays)
            new_shape = key not in self._shapes
            out = self._run(key, arrays)
            if self.out_sharding is not None:
                mesh, spec = self.out_sharding
                with mesh:
                    tree_map(lambda t: par.constrain(t, spec), out)
            out = tree_map(_to_numpy, out)  # blocks
        except BaseException as exc:
            if span is not None:
                span.record_exception(exc)
            raise
        finally:
            if span is not None:
                if batch is not None:
                    span.set_attribute("ml.batch", batch)
                span.end()
        # successful steps only: a failed execute must not count as served
        # work or skew the step-latency histogram with its error path
        dur = time.perf_counter() - start
        if new_shape:
            self._shapes.add(key)
            # the native path records its own pjrt/… rows: an apply/bN row
            # as well would count every compile second twice
            if batch is not None and self._pjrt is None:
                extra = {}
                if key in self.graphs:
                    extra["pool_bytes"] = self.graphs[key][3]
                self.programs.record(
                    f"apply/b{batch}", wall_s=dur,
                    kind="graph" if self.device.type == "cuda" else "eager",
                    shapes={"inputs": [list(a.shape) for a in arrays]},
                    **extra)
        if batch is not None:
            self.compiled_buckets.add(batch)
        self.steps += 1
        if self._metrics is not None:
            try:
                self._metrics.record_histogram(
                    "app_tpu_step_seconds", dur, model=self.name)
            except Exception:
                pass  # a bare metrics manager without the series
        if self._logger is not None:
            self._logger.debug(
                {"ml_step": self.name, "duration_us": int(dur * 1e6)})
        return out

    # -- API -------------------------------------------------------------------
    def predict_sync(self, *inputs: Any, trace_parent=None) -> Any:
        fut: cf.Future = cf.Future()
        self._work.put((fut, inputs, trace_parent or current_context()))
        return fut.result()

    async def predict(self, *inputs: Any, trace_parent=None) -> Any:
        fut: cf.Future = cf.Future()
        self._work.put((fut, inputs, trace_parent or current_context()))
        return await asyncio.wrap_future(fut)

    def queue_depth(self) -> int:
        """Work items awaiting the executor thread (sampled as
        ``app_ml_queue_depth{component="engine"}``)."""
        return self._work.qsize()

    def bucket_for(self, n: int) -> int:
        return _next_bucket(n, self.config.batch_buckets)

    def warmup_buckets(self) -> None:
        """Capture every batch bucket up front by tiling the example row,
        so no capture ever lands on a live request."""
        if self._example_inputs is None or not self.config.warmup:
            return
        examples = [np.asarray(x) for x in self._example_inputs]
        if examples[0].ndim == 0:
            return  # no batch axis to tile along
        example_b = examples[0].shape[0]
        for b in self.config.batch_buckets:
            if b == example_b:
                continue  # the constructor's warmup captured this one
            # scalars (0-d side inputs) pass through untiled
            tiled = [x if x.ndim == 0 else np.repeat(x[:1], b, axis=0)
                     for x in examples]
            self.predict_sync(*tiled)

    def memory_stats(self) -> dict | None:
        """The card's allocator counts (None on the CPU, as JAX's CPU
        devices answer)."""
        if self.device.type != "cuda":
            return None
        _, total = torch.cuda.mem_get_info(self.device)
        return {"bytes_in_use": int(torch.cuda.memory_allocated(self.device)),
                "peak_bytes_in_use": int(
                    torch.cuda.max_memory_allocated(self.device)),
                "bytes_limit": int(total)}

    def close(self) -> None:
        """Stop the executor thread after the queued work; the graphs, or
        the native executables and params, are freed once it has stopped.
        A thread still busy (a slow compile, a stalled device) keeps them:
        freeing a package under a run would be a use after free, so they
        leak instead, as JAX's engine leaks its client."""
        self._work.put(None)
        self._thread.join(timeout=5)
        if self._thread.is_alive():
            return
        self.graphs.clear()
        if self._pjrt is not None:
            self._pjrt.close()
