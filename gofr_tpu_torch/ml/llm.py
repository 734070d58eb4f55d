"""Async LLM serving — counterpart of the core of ``gofr_tpu/ml/llm.py``.

Many concurrent asyncio callers feed ONE continuous-batching ``Generator``
owned by a dedicated serving thread, so the event loop never blocks on
device work and every device call comes from one thread.

Flow per request: a caller awaits ``stream_chunks()`` / ``stream()`` /
``generate()`` → the request goes on a thread-safe queue → the serving
thread collects the burst that arrives within the admission window, orders
it by priority class with aging, and admits what fits as one prefill wave
→ each processed decode block pushes the slot's token burst to the caller's
asyncio queue via ``call_soon_threadsafe`` → the slot is released on
completion with its finish reason.

Kept from the JAX class: the burst-collection window, priority admission,
deadlines (reaped while queued or mid-decode), ``check_admissible`` and the
graceful ``close(drain_s)``. An exception on the serving thread fails every
live and queued request with ``GeneratorCrashed``, is logged with its
traceback and kept in ``LLMServer.error``, and leaves the server dead
(``health() == "dead"``); restart under a watchdog, the flight recorder,
journeys, capture, goodput, the prefix cache, fault injection and replicas
wait for later slices.
"""

from __future__ import annotations

import asyncio
import logging
import queue as _queue
import threading
import time
from typing import AsyncIterator

import numpy as np

from .errors import DeadlineExceeded, GeneratorCrashed, ServerClosed
from .scheduler import AgingPriorityQueue, normalize_priority

__all__ = ["LLMServer"]

_log = logging.getLogger("gofr_tpu_torch.ml.llm")
_DONE = object()

# burst collection: how long the serving thread keeps collecting arrivals
# before admitting them as one wave (concurrent clients land over a few ms)
_ADMIT_WINDOW_S = 0.004
# idle wait for the next request, backing off to 50 ms so an idle server
# does not spin
_IDLE_WAIT_S = 0.002
# seconds of waiting that promote a queued request one priority class
_AGING_S = 2.0


class _Finish:
    """Completion marker carrying the slot's finish reason: 'stop' (eos) or
    'length' (max_new or capacity reached)."""

    __slots__ = ("reason",)

    def __init__(self, reason: str) -> None:
        self.reason = reason


class _Request:
    __slots__ = ("prompt", "max_new", "out_q", "loop", "priority",
                 "enqueued_at", "deadline_at", "deadline_hit", "cancelled")

    def __init__(self, prompt, max_new, out_q, loop, priority: int,
                 deadline_s: float) -> None:
        self.prompt = prompt
        self.max_new = max_new
        self.out_q = out_q
        self.loop = loop
        self.priority = priority
        self.enqueued_at = time.perf_counter()
        self.deadline_at = (self.enqueued_at + deadline_s
                            if deadline_s > 0 else None)
        self.deadline_hit = False
        self.cancelled = False  # consumer went away: stop decoding the slot

    def send(self, item) -> None:
        """Hand ``item`` to the consumer's loop (thread-safe)."""
        try:
            self.loop.call_soon_threadsafe(self.out_q.put_nowait, item)
        except RuntimeError:
            pass  # the consumer's loop is already closed


class LLMServer:
    """Owns a Generator on a serving thread; async API for callers."""

    def __init__(self, generator, *, name: str = "llm") -> None:
        self.gen = generator
        self.name = name
        self._idle_backoff = _IDLE_WAIT_S
        self._requests: _queue.Queue[_Request | None] = _queue.Queue()
        self._waiting = AgingPriorityQueue(aging_s=_AGING_S)
        self._active: dict[int, _Request] = {}
        self._closed = False
        self._draining = False
        self._dead = False
        self.error: BaseException | None = None
        self.served = 0
        self.deadline_expired = 0
        self._thread = threading.Thread(target=self._serve_loop, daemon=True,
                                        name=f"gofr-torch-llm-{name}")
        self._thread.start()

    # -- serving thread -------------------------------------------------------
    def _serve_loop(self) -> None:
        try:
            self._serve()
        except Exception as exc:
            # not swallowed: logged, kept, and every consumer is failed
            # typed below — the server is dead from here on
            self.error = exc
            self._dead = True
            _log.exception("llm %s: serving thread crashed", self.name)
        finally:
            self._flush_on_close()

    def _serve(self) -> None:
        while not self._closed:
            self._reap_cancelled()
            self._admit_waiting()
            if self._closed:
                return
            if self.gen.n_live:
                self.gen.step()
                self._finish_dead_slots()
                continue
            self.gen.drain()
            self._finish_dead_slots()
            try:  # idle: block briefly, backing off toward 50 ms
                req = self._requests.get(timeout=self._idle_backoff)
            except _queue.Empty:
                self._idle_backoff = min(self._idle_backoff * 2, 0.05)
                continue
            self._idle_backoff = _IDLE_WAIT_S
            if req is None:
                return
            self._waiting.push(req)
            # collect the rest of the burst before admitting: one wave (one
            # batched prefill + one mini-chunk) gives every stream of the
            # burst the first wave's TTFT
            deadline = time.perf_counter() + _ADMIT_WINDOW_S
            while (remaining := deadline - time.perf_counter()) > 0:
                try:
                    more = self._requests.get(timeout=remaining)
                except _queue.Empty:
                    break
                if more is None:
                    self._closed = True
                    return
                self._waiting.push(more)

    def _flush_on_close(self) -> None:
        """Wake every parked, queued or live consumer with the typed error:
        ``GeneratorCrashed`` when the serving thread died, ``ServerClosed``
        on a clean close."""
        self._closed = True
        leftovers = self._waiting.drain()
        while True:
            try:
                req = self._requests.get_nowait()
            except _queue.Empty:
                break
            if req is not None:
                leftovers.append(req)
        leftovers.extend(self._active.values())
        self._active.clear()
        exc = self._closed_error()
        for req in leftovers:
            self._reject(req, exc)

    def _closed_error(self) -> Exception:
        if self._dead:
            return GeneratorCrashed(
                f"llm server is dead: {type(self.error).__name__}: "
                f"{self.error}")
        return ServerClosed()

    @staticmethod
    def _reject(req: _Request, exc: Exception) -> None:
        req.send(exc)
        req.send(_DONE)

    def _admit_waiting(self) -> None:
        while True:  # pull everything queued
            try:
                req = self._requests.get_nowait()
            except _queue.Empty:
                break
            if req is None:
                self._closed = True
                return
            self._waiting.push(req)
        while len(self._waiting) and not self._draining:
            if self.gen.free_slot() is None:
                # no admission possible: keep the decode pipeline one
                # dispatch deep instead of draining it every pass
                break
            # settle device bookkeeping and release finished slots FIRST,
            # so free_slot() never hands back a slot still in _active
            self.gen.drain()
            self._finish_dead_slots()
            n_free = sum(not s.live for s in self.gen.slots)
            batch = []
            while len(self._waiting) and len(batch) < n_free:
                req = self._waiting.pop()
                if (req.deadline_at is not None
                        and time.perf_counter() >= req.deadline_at):
                    self._expire(req, "while queued")
                    continue
                try:
                    # one bad request rejects alone, not the whole wave
                    self.check_admissible(req.prompt, req.max_new)
                except ValueError as exc:
                    self._reject(req, exc)
                    continue
                batch.append((req, req.prompt))
            if not batch:
                continue
            try:
                slots = self.gen.add_requests([
                    (ids, req.max_new,
                     (lambda i, toks, r=req: self._emit(r, toks)))
                    for req, ids in batch])
            except ValueError as exc:
                # a client mistake the generator's own checks caught
                for req, _ in batch:
                    self._reject(req, exc)
                continue
            except Exception as exc:
                # a device-side prefill failure: this wave's consumers get
                # the typed crash, then the serving thread dies with it
                crash = GeneratorCrashed(
                    f"prefill dispatch failed ({type(exc).__name__}: {exc})")
                for req, _ in batch:
                    self._reject(req, crash)
                raise
            for (req, _), slot in zip(batch, slots, strict=True):
                self._active[slot] = req

    @staticmethod
    def _emit(req: _Request, tokens: list[int]) -> None:
        """Push one BURST of tokens to the consumer — one loop wakeup per
        burst, not per token."""
        req.send(list(tokens))

    def _expire(self, req: _Request, where: str) -> None:
        self.deadline_expired += 1
        self._reject(req, DeadlineExceeded(
            f"request deadline exceeded {where}"))

    def _reap_cancelled(self) -> None:
        """Stop decoding for consumers that went away and for requests past
        their deadline: queued ones are dropped before any prefill,
        decoding ones have their slot cancelled (finished as
        ``DeadlineExceeded`` by ``_finish_dead_slots``)."""
        now = time.perf_counter()
        for r in self._waiting.prune(
                lambda r: r.cancelled or (r.deadline_at is not None
                                          and now >= r.deadline_at)):
            if not r.cancelled:
                self._expire(r, "while queued")
        for slot, req in self._active.items():
            s = self.gen.slots[slot]
            if not s.live:
                continue
            if req.cancelled:
                s.live = False
            elif req.deadline_at is not None and now >= req.deadline_at:
                req.deadline_hit = True
                s.live = False

    def _finish_dead_slots(self) -> None:
        for slot, req in list(self._active.items()):
            s = self.gen.slots[slot]
            if s.live:
                continue
            self.gen.release(slot)
            del self._active[slot]
            if req.deadline_hit:
                self._expire(req, "mid-generation")
                continue
            self.served += 1
            req.send(_Finish("stop" if s.eos_hit else "length"))

    # -- caller side ------------------------------------------------------------
    def check_admissible(self, prompt_ids, max_new_tokens: int = 1) -> None:
        """Raise ValueError if this request can NEVER admit: prompt length
        against ``max_seq``, token ids against the vocabulary. Busy slots
        are not a reason — those requests queue."""
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        n = len(ids)
        if n == 0 or n >= self.gen.max_seq:
            raise ValueError(
                f"prompt length {n} out of range (1..{self.gen.max_seq - 1})")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        vocab = self.gen.cfg.vocab_size
        if ids.min() < 0 or ids.max() >= vocab:
            raise ValueError(f"token ids must lie in [0, {vocab})")

    async def stream_chunks(self, prompt_ids, max_new_tokens: int = 64,
                            info: dict | None = None,
                            priority: int | str | None = None,
                            deadline_s: float | None = None
                            ) -> AsyncIterator[list[int]]:
        """Yield BURSTS of tokens — each list is the slot's share of one
        processed decode block (the first is ``[first_token]``).

        ``priority``: ``"high"`` / ``"normal"`` / ``"low"`` or the class
        index (unknown values raise ValueError before enqueue).
        ``deadline_s``: the request's TTL (0 or None = none); past it the
        request fails with ``DeadlineExceeded`` wherever it sits. Pass ``info={}`` to receive
        ``info["finish_reason"]`` (``"stop"`` or ``"length"``)."""
        if self._closed or self._draining:
            raise self._closed_error()
        prio = normalize_priority(priority)
        ttl = 0.0 if deadline_s is None else deadline_s
        if not ttl >= 0:  # rejects NaN too
            raise ValueError(f"deadline_s must be >= 0, got {ttl}")
        out_q: asyncio.Queue = asyncio.Queue()
        req = _Request(np.asarray(prompt_ids).reshape(-1), max_new_tokens,
                       out_q, asyncio.get_running_loop(), prio, ttl)
        self._requests.put(req)
        if self._closed:
            # close() may have flushed before our put landed: never park on
            # a queue nobody reads
            req.cancelled = True
            raise self._closed_error()
        try:
            while True:
                item = await out_q.get()
                if item is _DONE:
                    return
                if isinstance(item, _Finish):
                    if info is not None:
                        info["finish_reason"] = item.reason
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # consumer closed the stream (disconnect, break, cancellation):
            # the serving thread frees the slot instead of decoding on
            req.cancelled = True

    async def stream(self, prompt_ids, max_new_tokens: int = 64,
                     info: dict | None = None,
                     priority: int | str | None = None,
                     deadline_s: float | None = None) -> AsyncIterator[int]:
        """Yield tokens one at a time (a view of ``stream_chunks``)."""
        agen = self.stream_chunks(prompt_ids, max_new_tokens, info=info,
                                  priority=priority, deadline_s=deadline_s)
        try:
            async for burst in agen:
                for tok in burst:
                    yield tok
        finally:
            await agen.aclose()

    async def generate(self, prompt_ids, max_new_tokens: int = 64,
                       info: dict | None = None,
                       priority: int | str | None = None,
                       deadline_s: float | None = None) -> list[int]:
        """Collect the full completion."""
        out: list[int] = []
        async for burst in self.stream_chunks(prompt_ids, max_new_tokens,
                                              info=info, priority=priority,
                                              deadline_s=deadline_s):
            out.extend(burst)
        return out

    def health(self) -> str:
        """``serving``, or ``dead`` once closed or crashed."""
        if self._dead or self._closed or not self._thread.is_alive():
            return "dead"
        return "serving"

    def close(self, drain_s: float = 0.0) -> None:
        """Shut the server down. With ``drain_s`` > 0 admission stops first
        (new calls fail with ``ServerClosed``, queued requests stay parked),
        in-flight decode runs to completion up to the deadline, then the
        serving thread stops and every remaining consumer gets
        ``ServerClosed``."""
        if drain_s > 0 and not self._closed and self._thread.is_alive():
            self._draining = True
            deadline = time.monotonic() + drain_s
            while time.monotonic() < deadline:
                if not self._active and self.gen.n_live == 0:
                    break
                time.sleep(0.005)
        if not self._closed:
            self._closed = True
            self._requests.put(None)
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            raise RuntimeError(f"llm {self.name}: serving thread did not stop")
