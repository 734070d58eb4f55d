"""Training input pipeline: records read, shuffled and stacked on a
background thread, and copied to the device ahead of the step — counterpart
of ``gofr_tpu/ml/data.py``.

- The host work (read, decode, shuffle, stack) runs on a prefetch thread,
  so the card never waits on Python; ``prefetch`` batches wait ready.
- A batch goes to the card from pinned host memory with
  ``non_blocking=True`` on a side CUDA stream of the prefetch thread; the
  consumer's stream waits on that copy's event before the batch is used,
  so the copy of batch N+1 overlaps the step on batch N (JAX's
  ``device_put`` one step ahead). On the CPU a batch is its numpy arrays'
  tensors.
- ``shard_by_process`` reads a round-robin slice of the record stream: the
  rank and world size of an initialised ``torch.distributed`` group (0 and
  1 without one). Placement over a mesh (``sharding``, ``mesh``, ``spec``)
  is not ported yet (ROADMAP A.11).

The record stream, the seeded shuffle buffer (numpy's ``default_rng(seed
+ epoch)``), ``repeat`` and the dropped remainder are the JAX loader's,
line for line, so a seed gives the same order in both packages. Arrays keep
numpy's dtype (JAX narrows int64 to int32 when x64 is off).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

__all__ = ["DataLoader", "jsonl_source", "csv_source"]

_END = object()


def _iter_lines(fh, chunk: int = 1 << 16):
    """Lines of a ``filesystem`` handle, read a chunk at a time: a
    multi-GB JSONL never sits in memory whole."""
    buf = b""
    while True:
        data = fh.read(chunk)
        if not data:
            break
        buf += data
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            yield line
    if buf:
        yield buf


def jsonl_source(path: str, filesystem=None) -> Callable[[], Iterator[dict]]:
    """Record source over a JSONL file: local disk, or ``filesystem``, any
    object whose ``open(path)`` returns a handle with ``read(n)`` and
    ``close()``."""
    import json

    def gen() -> Iterator[dict]:
        if filesystem is not None:
            fh = filesystem.open(path)
            try:
                for line in _iter_lines(fh):
                    if line.strip():
                        yield json.loads(line)
            finally:
                fh.close()
            return
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                if line.strip():
                    yield json.loads(line)

    return gen


def csv_source(path: str, filesystem=None) -> Callable[[], Iterator[dict]]:
    """Record source over a CSV file with a header row (``jsonl_source``'s
    ``filesystem``)."""
    import csv

    def gen() -> Iterator[dict]:
        if filesystem is not None:
            fh = filesystem.open(path)
            try:
                yield from csv.DictReader(
                    line.decode("utf-8") for line in _iter_lines(fh))
            finally:
                fh.close()
            return
        with open(path, newline="", encoding="utf-8") as fh:
            yield from csv.DictReader(fh)

    return gen


class DataLoader:
    """Iterate training batches on ``device`` (default the first CUDA card;
    ``"cpu"`` for the host).

    ``source`` is a zero-arg callable returning a fresh record iterator (so
    ``repeat`` can re-open it each epoch); records are dicts of array-likes
    (or anything ``transform`` turns into one). Batches are dicts of
    stacked tensors of ``batch_size`` rows; a short remainder is dropped.
    """

    def __init__(
        self,
        source: Callable[[], Iterable[Any]],
        batch_size: int,
        *,
        transform: Callable[[Any], dict] | None = None,
        shuffle_buffer: int = 0,
        seed: int = 0,
        sharding: Any | None = None,
        mesh: Any | None = None,
        spec: Any | None = None,
        prefetch: int = 2,
        repeat: bool = False,
        shard_by_process: bool = False,
        device=None,
    ) -> None:
        from .. import resolve_device

        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if sharding is not None or mesh is not None or spec is not None:
            raise NotImplementedError(
                "placing batches over a mesh (sharding=, mesh=, spec=) is "
                "not ported yet (ROADMAP A.11)")
        self._source = source
        self.batch_size = batch_size
        self._transform = transform
        self._shuffle = shuffle_buffer
        self._seed = seed
        self._prefetch = max(1, prefetch)
        self._repeat = repeat
        self._shard_by_process = shard_by_process
        self.device = resolve_device(device)

    # -- host-side record stream ----------------------------------------------
    def _records(self) -> Iterator[Any]:
        pid, nproc = 0, 1
        if self._shard_by_process:
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                pid, nproc = dist.get_rank(), dist.get_world_size()
        epoch = 0
        while True:
            rng = np.random.default_rng(self._seed + epoch)
            buf: list[Any] = []
            n_yielded = 0
            for i, rec in enumerate(self._source()):
                if nproc > 1 and i % nproc != pid:
                    continue
                if self._transform is not None:
                    rec = self._transform(rec)
                if self._shuffle > 1:
                    buf.append(rec)
                    if len(buf) >= self._shuffle:
                        j = int(rng.integers(len(buf)))
                        buf[j], buf[-1] = buf[-1], buf[j]
                        n_yielded += 1
                        yield buf.pop()
                else:
                    n_yielded += 1
                    yield rec
            if self._shuffle > 1:
                rng.shuffle(buf)  # type: ignore[arg-type]
                n_yielded += len(buf)
                yield from buf
            if n_yielded == 0:
                # an empty source with repeat=True would otherwise spin a
                # core re-opening it forever while the consumer hangs
                raise ValueError(
                    "data source yielded no records"
                    + (f" for process {pid}/{nproc}" if nproc > 1 else ""))
            epoch += 1
            if not self._repeat:
                return

    def _host_batches(self) -> Iterator[dict]:
        batch: list[Any] = []
        for rec in self._records():
            batch.append(rec)
            if len(batch) == self.batch_size:
                yield self._stack(batch)
                batch = []
        # a short remainder is dropped: every step sees the same shapes

    @staticmethod
    def _stack(records: Sequence[Any]) -> dict:
        first = records[0]
        if not isinstance(first, dict):
            return {"data": np.stack([np.asarray(r) for r in records])}
        return {key: np.stack([np.asarray(r[key]) for r in records])
                for key in first}

    # -- device placement ------------------------------------------------------
    def _to_device(self, host_batch: dict, stream) -> tuple[dict, Any]:
        """(the batch on the device, the event its copies end at)."""
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in host_batch.items()}
        if stream is None:
            return tensors, None
        with torch.cuda.stream(stream):
            out = {k: t.pin_memory().to(self.device, non_blocking=True)
                   for k, t in tensors.items()}
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def __iter__(self) -> Iterator[dict]:
        """Yield device batches; the prefetch thread keeps ``prefetch``
        batches stacked and on their way to the device ahead of the
        consumer."""
        q: queue.Queue = queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)

        def producer() -> None:
            try:
                for host_batch in self._host_batches():
                    if stop.is_set():
                        return
                    q.put(self._to_device(host_batch, stream))
                q.put(_END)
            except BaseException as exc:  # surface in the consumer
                q.put(exc)

        t = threading.Thread(target=producer, daemon=True,
                             name="gofr-data-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, event = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for v in batch.values():
                        # the side stream's memory is in use on this one
                        v.record_stream(current)
                yield batch
        finally:
            stop.set()
            # unblock a producer parked on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                pass
