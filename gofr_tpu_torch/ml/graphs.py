"""CUDA graphs of the decode dispatches: the port's counterpart of the JAX
package's compiled decode programs.

JAX runs a whole decode chunk or fused window as ONE ``jax.jit`` program
(``lax.scan`` over the steps). Eager PyTorch would launch every kernel of
every step from Python, about a thousand launches a Llama-3-8B step, and
the host, not the card, would set the pace. ``DecodeGraphs`` captures each
dispatch shape once and replays it with one ``graph.replay()``.

A graph replays fixed pointers, so everything a captured dispatch reads or
writes keeps its storage for the graph's life: the cache (``len``
included: every writer updates it in place), the page table's device
buffer, the token row, the window masks and, under speculation, the
history rows, the enable mask and the draft cache. The outputs are the graph's
own tensors, overwritten by its next replay: a caller copies them off
(``_HostBlock``) before it replays again.

- All graphs of one generator share one memory pool
  (``torch.cuda.graph_pool_handle()``); they run on one stream, never at
  once, and each keeps its outputs referenced, so no graph's intermediates
  land on another's outputs.
- Capture runs on a side stream with ``capture_error_mode="thread_local"``
  (only the serving thread must not touch the card meanwhile). A failed
  capture, or a stream already capturing, raises: nothing falls back to
  the eager loop on a card.
- Sampling: the generator's own ``torch.Generator`` is registered with
  every graph (``CUDAGraph.register_generator_state``), so each replay
  draws fresh numbers from it.
- Launch counts: a kernel wrapper counts its launches
  (``flash_attention_cuda.launches``, ...). Capture enqueues nothing on the
  card, so the launches counted while capturing are taken back and added
  again on every replay: the counts stay the number of kernel runs.
"""

from __future__ import annotations

import time

import torch

from ..flight_recorder import LAUNCH_GATE

__all__ = ["DecodeGraphs"]


def _kernel_wrappers() -> tuple:
    """Every kernel wrapper that counts its launches."""
    from ..ops.decode_attention import (gqa_decode_attention_cuda,
                                        gqa_decode_attention_int8_cuda,
                                        gqa_decode_window_cuda,
                                        gqa_decode_window_int8_cuda)
    from ..ops.flash_attention import flash_attention_cuda

    return (flash_attention_cuda, gqa_decode_attention_cuda,
            gqa_decode_attention_int8_cuda, gqa_decode_window_cuda,
            gqa_decode_window_int8_cuda)


class DecodeGraphs:
    """Captured decode dispatches of one generator, by key."""

    def __init__(self, device: torch.device, rng: torch.Generator | None,
                 dtype: torch.dtype) -> None:
        self.device = device
        self.rng = rng
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self._graphs: dict = {}
        self.capture_s = 0.0            # wall seconds spent capturing
        self.pool_reserved_bytes = 0    # reserved memory capture added
        # lazy library state (cuBLAS handle and workspace) for the side
        # stream, made before any capture instead of inside one
        self.stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self.stream):
            x = torch.ones((16, 16), dtype=dtype, device=device)
            x @ x
        torch.cuda.current_stream(device).wait_stream(self.stream)

    def __contains__(self, key) -> bool:
        return key in self._graphs

    def __len__(self) -> int:
        return len(self._graphs)

    def capture(self, key, body) -> None:
        """Capture ``body()`` (which returns its output tensors) as the
        graph of ``key``."""
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"decode graph {key}: the current stream is already "
                f"capturing a CUDA graph")
        wrappers = _kernel_wrappers()
        counts0 = [fn.launches for fn in wrappers]
        reserved0 = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        if self.rng is not None:
            graph.register_generator_state(self.rng)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        try:
            # no profiler start or stop (its device synchronize would
            # invalidate the capture) while capturing
            with LAUNCH_GATE.serving(), torch.cuda.stream(self.stream):
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    outputs = body()
                finally:
                    graph.capture_end()
        except Exception as exc:
            raise RuntimeError(
                f"CUDA graph capture of decode dispatch {key} failed "
                f"({type(exc).__name__}: {exc})") from exc
        finally:
            counts = [fn.launches for fn in wrappers]
            for fn, n0 in zip(wrappers, counts0, strict=True):
                fn.launches = n0
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        launches = [(fn, n - n0) for fn, n, n0
                    in zip(wrappers, counts, counts0, strict=True) if n > n0]
        self._graphs[key] = (graph, outputs, launches)
        self.capture_s += time.perf_counter() - t0
        self.pool_reserved_bytes += (torch.cuda.memory_reserved(self.device)
                                     - reserved0)

    def replay(self, key):
        """Replay the graph of ``key`` on the current stream; returns its
        output tensors (valid until its next replay)."""
        graph, outputs, launches = self._graphs[key]
        graph.replay()
        for fn, n in launches:
            fn.launches += n
        return outputs

    def stats(self) -> dict:
        return {"graphs": len(self._graphs),
                "capture_s": self.capture_s,
                "pool_reserved_bytes": self.pool_reserved_bytes}
