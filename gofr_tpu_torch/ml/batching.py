"""Dynamic request batching — counterpart of ``gofr_tpu/ml/batching.py``.

Coalesces concurrent single requests into one padded, bucket-shaped engine
batch, so the card sees batch-32 matmuls instead of batch-1 dribble:

- requests enqueue (input arrays, future); a collector drains the queue up
  to ``max_batch`` or until ``max_delay_s`` has passed since the first
  request, and at most ``max_inflight`` batches run at once;
- the batch pads to the engine's next bucket (one captured graph each)
  from a cached zero block, runs once, and each caller's future gets its
  row, cut from every array of the output (``_slice_row``);
- the ``ml.queue`` span, ``app_ml_batch_size`` and ``app_ml_queue_seconds``
  record the wait and the realized batch; an error reaches every caller of
  the batch.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any

import numpy as np

from ..tracing import current_context
from .engine import tree_map

__all__ = ["DynamicBatcher"]


class _Pending:
    __slots__ = ("inputs", "future", "enqueued_at", "trace_ctx", "queue_span")

    def __init__(self, inputs: tuple, future: asyncio.Future,
                 trace_ctx=None, queue_span=None) -> None:
        self.inputs = inputs
        self.future = future
        self.enqueued_at = time.perf_counter()
        self.trace_ctx = trace_ctx    # request span ctx captured at enqueue
        self.queue_span = queue_span  # ml.queue, open until batch formation


class DynamicBatcher:
    """Coalesces ``submit`` calls into padded engine batches.

    Each submitted input is ONE example (no batch dim). The batcher stacks
    examples along a new leading axis, pads the batch up to the engine's
    bucket with zeros, executes, and hands row i back to caller i.
    """

    def __init__(
        self,
        engine,
        *,
        max_batch: int = 64,
        max_delay_s: float = 0.005,
        max_inflight: int = 2,
        metrics=None,
        tracer=None,
    ) -> None:
        self._engine = engine
        self._max_batch = max_batch
        self._max_delay = max_delay_s
        self._max_inflight = max_inflight
        self._metrics = metrics
        self._tracer = tracer
        self._queue: asyncio.Queue[_Pending] = asyncio.Queue()
        self._task: asyncio.Task | None = None
        self._inflight: set[asyncio.Task] = set()
        self._inflight_slots: asyncio.Semaphore | None = None
        # zero-pad blocks keyed by (rows, row shape, dtype): the pad rows of
        # a (bucket, shape) pair are the same every batch
        self._pad_cache: dict[tuple, np.ndarray] = {}
        self._closed = False

    def _ensure_collector(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(
                self._collect(), name=f"gofr-batcher-{self._engine.name}")

    async def submit(self, *inputs: Any) -> Any:
        if self._closed:
            raise RuntimeError("batcher is closed")
        self._ensure_collector()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        # the request's span context, captured HERE: the collector that
        # later forms the batch runs in its own context
        ctx = current_context()
        queue_span = None
        if self._tracer is not None:
            queue_span = self._tracer.start_span(
                "ml.queue", parent=ctx, activate=False,
                attributes={"ml.model": self._engine.name})
        await self._queue.put(_Pending(inputs, fut, ctx, queue_span))
        return await fut

    def queue_depth(self) -> int:
        """Requests waiting for batch formation (sampled as
        ``app_ml_queue_depth{component="batcher"}``)."""
        return self._queue.qsize()

    async def _collect(self) -> None:
        while not self._closed:
            first = await self._queue.get()
            batch = [first]
            # the backlog that built up while the previous batch ran is
            # past its delay window already: it rides the very next batch
            while len(batch) < self._max_batch:
                try:
                    batch.append(self._queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            deadline = first.enqueued_at + self._max_delay
            while len(batch) < self._max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(self._queue.get(),
                                                        remaining))
                except asyncio.TimeoutError:
                    break
            # the batch runs as a task, so collecting the next one overlaps
            # this one on the device; the semaphore bounds batches in
            # flight, so under overload requests back up in the queue
            if self._inflight_slots is None:
                self._inflight_slots = asyncio.Semaphore(self._max_inflight)
            await self._inflight_slots.acquire()

            async def _run_and_release(b=batch) -> None:
                try:
                    await self._run_batch(b)
                finally:
                    self._inflight_slots.release()

            task = asyncio.get_running_loop().create_task(_run_and_release())
            self._inflight.add(task)
            task.add_done_callback(self._inflight.discard)

    async def _run_batch(self, batch: list[_Pending]) -> None:
        n = len(batch)
        bucket = self._engine.bucket_for(n)
        now = time.perf_counter()
        for p in batch:
            if p.queue_span is not None:
                p.queue_span.set_attributes({"ml.batch": n, "ml.bucket": bucket})
                p.queue_span.end()
        if self._metrics is not None:
            try:
                self._metrics.record_histogram("app_ml_batch_size", n,
                                               model=self._engine.name)
                for p in batch:
                    self._metrics.record_histogram(
                        "app_ml_queue_seconds", now - p.enqueued_at,
                        model=self._engine.name)
            except Exception:
                pass  # a bare metrics manager without the series
        # one pad span and one device step a BATCH, parented to the first
        # rider's request; the other riders' trace ids ride an attribute
        pad_span = None
        if self._tracer is not None:
            pad_span = self._tracer.start_span(
                "ml.pad", parent=batch[0].trace_ctx, activate=False,
                attributes={"ml.model": self._engine.name,
                            "ml.batch": n, "ml.bucket": bucket})
            if n > 1:
                pad_span.set_attribute(
                    "ml.linked_traces",
                    ",".join(p.trace_ctx.trace_id for p in batch[1:]
                             if p.trace_ctx is not None))
        try:
            stacked = []
            for j in range(len(batch[0].inputs)):
                arr = np.stack([np.asarray(p.inputs[j]) for p in batch], axis=0)
                if bucket > n:  # zero-pad to the shape bucket
                    key = (bucket - n, arr.shape[1:], arr.dtype.str)
                    pad = self._pad_cache.get(key)
                    if pad is None:
                        pad = self._pad_cache[key] = np.zeros(
                            (bucket - n,) + arr.shape[1:], dtype=arr.dtype)
                    arr = np.concatenate([arr, pad], axis=0)
                stacked.append(arr)
            if pad_span is not None:
                pad_span.end()
            if self._tracer is not None:
                out = await self._engine.predict(
                    *stacked, trace_parent=batch[0].trace_ctx)
            else:  # duck-typed engines (tests, fakes) stay kwarg-free
                out = await self._engine.predict(*stacked)
        except Exception as exc:
            if pad_span is not None and pad_span.end_time is None:
                pad_span.record_exception(exc)
                pad_span.end()
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(exc)
            return
        for i, p in enumerate(batch):
            if not p.future.done():
                p.future.set_result(_slice_row(out, i))

    def close(self) -> None:
        self._closed = True
        if self._task is not None:
            self._task.cancel()


def _slice_row(out: Any, i: int):
    """Row i of every array leaf of the batched output."""
    return tree_map(lambda a: a[i], out)
