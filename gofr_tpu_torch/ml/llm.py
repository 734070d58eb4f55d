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

Kept from the JAX class: the burst-collection window, priority admission
with aging (``GOFR_ML_PRIORITY_AGING_S``), deadlines (``deadline_s=``,
default ``GOFR_ML_DEFAULT_DEADLINE_S``; reaped while queued or mid-decode),
bounded admission with lowest-priority-first shedding
(``GOFR_ML_MAX_QUEUE`` / ``GOFR_ML_MAX_QUEUED_TOKENS``: a typed
``Overloaded`` with a Retry-After from the observed admission rate), the
SLO controller steering the token-budget scheduler's prefill share
(``GOFR_ML_TTFT_TARGET_MS`` / ``GOFR_ML_TPOT_TARGET_MS``), the serving
metrics (``app_llm_*``, ``app_ml_kv_offload_*``) and the ``ml.queue`` /
``ml.decode`` spans, ``check_admissible`` and the graceful
``close(drain_s)`` (default ``GOFR_ML_DRAIN_S``). Over a paged generator
(``page_size`` > 0):

- the shared-prefix cache (``prefix_cache.py``) is on by default:
  admission longest-matches each prompt against a radix trie of cached
  prefixes, prefills only the suffix on a hit, and registers hot prefixes
  with no caller opt-in (``prefix_cache=False`` turns it off, a
  ``PrefixCacheConfig`` tunes it); ``register_prefix`` pins a prefix and
  ``drop_prefix`` releases it, both run on the serving thread;
- admission goes one request at a time, a dry page pool requeues the
  request at the head of its class (transient back-pressure, not an
  error), a prefix evicted in the race window falls back to the full
  prompt, and a slot truncated by a dry pool finishes as ``"eviction"``.

``snapshot()`` reports the pool (host-tier counters included), the host
tier, the scheduler, the fused-window and pipeline counters, the decode
graphs and the prefix cache.

Resilience, as in the JAX server: every dispatch of a serving pass runs
under the WATCHDOG. An exception fails only the requests in flight (typed
``GeneratorCrashed``), resets the generator's decode state
(``Generator.recover``) and resumes the waiting queue, which survives the
crash untouched; past the restart budget (``max_restarts`` /
``GOFR_ML_MAX_RESTARTS``, default 3, per ``restart_window_s`` /
``GOFR_ML_RESTART_WINDOW_S``, default 60) or when recovery itself fails
(a sticky device error) the server is ``dead``. States: ``serving``,
``recovering``, ``degraded`` (a restart inside the window) and ``dead``.
``fault`` / ``GOFR_ML_FAULT`` arms the chaos hook
(``testutil/faults.py``). The serving recorders are on by default as in
JAX: the flight recorder (a ``DispatchRecorder`` record per dispatch, the
event log, crash bundles; ``GOFR_ML_FLIGHT_RECORDER``), the auto-profiler
(``GOFR_ML_AUTOPROF``), request journeys (``GOFR_ML_JOURNEY``) and the
goodput ledger (``GOFR_ML_GOODPUT``). Traffic capture
(``GOFR_ML_CAPTURE``) is ROADMAP A.16: a positive value raises
``NotImplementedError``.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import os
import queue as _queue
import threading
import time
import traceback
from typing import Any, AsyncIterator

import numpy as np

from ..flight_recorder import (LAUNCH_GATE, AutoProfiler, DispatchRecorder,
                               autoprof_enabled, crash_vault, event_log,
                               recorder_enabled)
from ..testutil.faults import FaultInjector, fault_snapshot
from ..tracing import current_context
from .errors import DeadlineExceeded, GeneratorCrashed, Overloaded, ServerClosed
from .generate import PagePoolExhausted, PrefixEvicted
from .goodput import goodput_ledger
from .journey import Journey, journey_log, next_rid
from .journey import seal as seal_journey
from .prefix_cache import PrefixCacheConfig, RadixPrefixCache
from .scheduler import (PRIORITIES, AgingPriorityQueue, SLOController,
                        normalize_priority, retry_after_s)

__all__ = ["LLMServer", "drain_s_from_env", "capture_from_env"]

_log = logging.getLogger("gofr_tpu_torch.ml.llm")
_DONE = object()

# burst collection: how long the serving thread keeps collecting arrivals
# before admitting them as one wave (concurrent clients land over a few ms)
_ADMIT_WINDOW_S = 0.004
# idle wait for the next request, backing off to 50 ms so an idle server
# does not spin
_IDLE_WAIT_S = 0.002


def _abort_reason(exc: Exception) -> str | None:
    """``ml.finish_reason`` of a request ended by a typed error."""
    if isinstance(exc, DeadlineExceeded):
        return "deadline"
    if isinstance(exc, Overloaded):
        return "shed"
    if isinstance(exc, GeneratorCrashed):
        return "crashed"
    return None


def drain_s_from_env() -> float:
    """``GOFR_ML_DRAIN_S`` as a drain budget in seconds (0 = immediate
    close). A malformed, negative, NaN or infinite value raises, as in the
    JAX package, instead of quietly dropping in-flight requests."""
    raw = os.environ.get("GOFR_ML_DRAIN_S", "").strip()
    if not raw:
        return 0.0
    try:
        drain_s = float(raw)
    except ValueError:
        raise ValueError(
            f"GOFR_ML_DRAIN_S must be seconds, got {raw!r}") from None
    if not 0.0 <= drain_s < float("inf"):
        raise ValueError(
            f"GOFR_ML_DRAIN_S must be finite and >= 0, got {raw!r}")
    return drain_s


def capture_from_env() -> None:
    """``GOFR_ML_CAPTURE``, parsed as the JAX package parses it: unset,
    empty or ``0`` is capture off; a malformed or negative value raises the
    JAX message; a positive ring size raises ``NotImplementedError``:
    traffic capture and replay are ROADMAP A.16."""
    raw = os.environ.get("GOFR_ML_CAPTURE", "").strip()
    if not raw:
        return
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"GOFR_ML_CAPTURE must be a ring size (requests), "
            f"got {raw!r}") from None
    if n < 0:
        raise ValueError(
            f"GOFR_ML_CAPTURE must be >= 0 (0 disables), got {raw!r}")
    if n > 0:
        raise NotImplementedError(
            f"traffic capture (GOFR_ML_CAPTURE={raw}) is not ported yet "
            f"(ROADMAP A.16)")


class _Finish:
    """Completion marker carrying the slot's finish reason: 'stop' (eos),
    'length' (max_new or capacity reached) or 'eviction' (a dry page pool
    truncated the answer)."""

    __slots__ = ("reason",)

    def __init__(self, reason: str) -> None:
        self.reason = reason


class _Request:
    __slots__ = ("prompt", "max_new", "out_q", "loop", "priority",
                 "enqueued_at", "deadline_at", "deadline_hit", "cancelled",
                 "prefix", "full_prompt", "cache_seen", "n_tokens",
                 "first_token_at", "last_burst_at", "trace_ctx",
                 "queue_span", "decode_span", "slot", "rid", "journey")

    def __init__(self, prompt, max_new, out_q, loop, priority: int,
                 deadline_s: float, prefix: int | None = None,
                 trace_ctx=None, queue_span=None, rid: str | None = None,
                 journey=None) -> None:
        self.prompt = prompt
        self.prefix = prefix      # registered shared-prefix id (paged)
        self.full_prompt = None   # the original ids when the prefix cache
        #                           split the prompt (prompt = the suffix)
        self.cache_seen = False   # the prefix cache looked at it once
        self.max_new = max_new
        self.out_q = out_q
        self.loop = loop
        self.priority = priority
        self.enqueued_at = time.perf_counter()
        self.deadline_at = (self.enqueued_at + deadline_s
                            if deadline_s > 0 else None)
        self.deadline_hit = False
        self.cancelled = False  # consumer went away: stop decoding the slot
        self.n_tokens = len(prompt)  # the queued-tokens shedding bound
        self.first_token_at = None
        self.last_burst_at = None  # the SLO controller's cadence anchor
        self.trace_ctx = trace_ctx    # the caller's span at enqueue time
        self.queue_span = queue_span  # ml.queue: enqueue -> admission
        self.decode_span = None       # ml.decode: admission -> finish
        self.slot = None
        self.rid = rid                # process-unique id (the journey key)
        self.journey = journey        # its timeline (None: journeys off)

    def finish_spans(self, status: str = "OK", message: str = "") -> None:
        """End the phase spans still open."""
        for span in (self.queue_span, self.decode_span):
            if span is not None and span.end_time is None:
                if status != "OK":
                    span.set_status(status, message)
                span.end()

    def send(self, item) -> None:
        """Hand ``item`` to the consumer's loop (thread-safe)."""
        try:
            self.loop.call_soon_threadsafe(self.out_q.put_nowait, item)
        except RuntimeError:
            pass  # the consumer's loop is already closed


class LLMServer:
    """Owns a Generator on a serving thread; async API for callers.

    Register through ``MLDatasource.register_llm`` (``app.register_llm``)
    so health and metrics flow to the front, or build one standalone.
    ``logger``, ``metrics`` (a ``metrics.Manager``) and ``tracer`` are
    optional; ``max_queue``, ``max_queued_tokens`` and
    ``default_deadline_s`` left at None read ``GOFR_ML_MAX_QUEUE``,
    ``GOFR_ML_MAX_QUEUED_TOKENS`` and ``GOFR_ML_DEFAULT_DEADLINE_S`` (0 =
    off), as the JAX server does."""

    def __init__(self, generator, *, name: str = "llm", logger=None,
                 metrics=None, tracer=None, prefix_cache=None,
                 max_restarts: int | None = None,
                 restart_window_s: float | None = None,
                 default_deadline_s: float | None = None,
                 max_queue: int | None = None,
                 max_queued_tokens: int | None = None,
                 fault: Any = None) -> None:
        # capture first: asking for it fails the boot before a serving
        # thread exists
        capture_from_env()
        self.gen = generator
        self.name = name
        self._logger = logger
        self._metrics = metrics
        self._tracer = tracer
        # the shared-prefix cache: on by default over a paged generator;
        # False turns it off, a PrefixCacheConfig tunes it
        self.prefix_cache = None
        if getattr(generator, "page_size", 0) and prefix_cache is not False:
            cfg = (prefix_cache
                   if isinstance(prefix_cache, PrefixCacheConfig) else None)
            self.prefix_cache = RadixPrefixCache(generator, cfg,
                                                 metrics=metrics, model=name)
        self._idle_backoff = _IDLE_WAIT_S
        self._requests: _queue.Queue[_Request | None] = _queue.Queue()
        self._setup_q: _queue.Queue = _queue.Queue()  # run on serving thread
        self._waiting = AgingPriorityQueue(
            aging_s=float(os.environ.get("GOFR_ML_PRIORITY_AGING_S", "2.0")))
        # SLO steering of the token-budget scheduler's prefill share
        self._controller = (SLOController.from_env(generator.scheduler)
                            if generator.scheduler is not None else None)
        self._steered_dispatches = -1  # ladder dispatches recorded so far
        # the generator counts spills and restores; the gauge pass
        # publishes the deltas as counters
        self._kv_spills_seen = 0
        self._kv_restores_seen = 0
        self._default_deadline = (
            float(os.environ.get("GOFR_ML_DEFAULT_DEADLINE_S", "0"))
            if default_deadline_s is None else float(default_deadline_s))
        # admission bounds (0 = unbounded): queued requests and queued
        # prompt tokens; past either, lowest-priority-first shedding
        self._max_queue = (int(os.environ.get("GOFR_ML_MAX_QUEUE", "0"))
                           if max_queue is None else int(max_queue))
        self._max_queued_tokens = (
            int(os.environ.get("GOFR_ML_MAX_QUEUED_TOKENS", "0"))
            if max_queued_tokens is None else int(max_queued_tokens))
        self._shed_counts = dict.fromkeys(PRIORITIES, 0)
        # admission times feed the Retry-After estimate
        self._admit_times: collections.deque[float] = collections.deque(
            maxlen=64)
        # parsed now: a malformed GOFR_ML_DRAIN_S fails the boot, not the
        # SIGTERM
        self._drain_default = drain_s_from_env()
        self._active: dict[int, _Request] = {}
        self._closed = False
        self._draining = False
        self.closed_cleanly = True
        self.served = 0
        self.deadline_expired = 0
        # -- the watchdog: at most GOFR_ML_MAX_RESTARTS recoveries per
        # GOFR_ML_RESTART_WINDOW_S sliding window; past it the server is
        # dead instead of crash-looping
        self._max_restarts = (int(os.environ.get("GOFR_ML_MAX_RESTARTS", "3"))
                              if max_restarts is None else int(max_restarts))
        self._restart_window = (
            float(os.environ.get("GOFR_ML_RESTART_WINDOW_S", "60"))
            if restart_window_s is None else float(restart_window_s))
        self._state = "serving"  # serving | recovering | degraded | dead
        # written by the serving thread mid-crash, read by health and
        # debug scrapes from the event loop: the lock keeps an append from
        # turning a scrape into a RuntimeError
        self._restart_lock = threading.Lock()
        self._restart_times: collections.deque[float] = collections.deque()
        self._restart_history: collections.deque[dict] = collections.deque(
            maxlen=16)
        self._restarts_total = 0
        self._fatal: BaseException | None = None  # a failed recovery's error
        # the flight recorder: the generator stamps decide / launch /
        # d2h_issue / device_wait / emit through the shared recorder, this
        # thread stamps queue_pop / assemble and commits once a dispatch
        self.recorder = (DispatchRecorder(model=name, metrics=metrics)
                         if recorder_enabled() else None)
        generator.recorder = self.recorder
        self.autoprof = None
        if self.recorder is not None and autoprof_enabled():
            self.autoprof = AutoProfiler(model=name)
            self.recorder.observer = self.autoprof.observe
        # the goodput ledger: model-bound handles for the generator, the
        # prefix cache and the host tier, whose charge sites stay one-liners
        self._goodput = goodput_ledger()
        handle = (self._goodput.handle(name)
                  if self._goodput is not None else None)
        generator.goodput = handle
        if self.prefix_cache is not None:
            self.prefix_cache.goodput = handle
        host = getattr(generator, "host_kv", None)
        if host is not None:
            host.goodput = handle
            host.model = name  # labels the tier's spill/restore events
        self._journeys = journey_log()
        self._events = event_log()
        self._crashes = crash_vault()
        # the chaos hook on the generator's dispatch points and the emit
        # path; None costs one attribute test a site
        self._fault = (FaultInjector.from_env() if fault is None
                       else (fault or None))
        if self._fault is not None:
            generator.fault = self._fault
            if logger is not None:
                logger.warnf("llm %s: fault injection ARMED (%s)", name,
                             os.environ.get("GOFR_ML_FAULT", ""))
        self._thread = threading.Thread(target=self._serve_loop, daemon=True,
                                        name=f"gofr-torch-llm-{name}")
        self._thread.start()

    # -- serving thread -------------------------------------------------------
    def _serve_loop(self) -> None:
        try:
            self._serve()
        finally:
            self._flush_on_close()

    def _serve(self) -> None:
        while not self._closed:
            # WATCHDOG: every dispatch this pass makes (step, drain, the
            # prefills, spill and restore) and the emit callbacks run
            # supervised; see ``_recover_or_die``
            rec = self.recorder
            try:
                # one pass of device work: a profiler start or stop waits
                # for its end (flight_recorder.LAUNCH_GATE)
                with LAUNCH_GATE.serving():
                    self._run_setup_tasks()
                    self._reap_cancelled()
                    if rec is not None:
                        # assemble: the admission wave (validation,
                        # radix split, the prefills) less what its inner
                        # drain noted itself, so a record's phases never
                        # sum past its wall
                        t0 = time.perf_counter()
                        nested0 = rec.pending_total
                        self._admit_waiting()
                        nested = rec.pending_total - nested0
                        rec.note("assemble", max(
                            0.0, time.perf_counter() - t0 - nested))
                    else:
                        self._admit_waiting()
                    if self._closed:
                        return
                    if self.gen.n_live:
                        self.gen.step()
                        self._finish_dead_slots()
                        self._steer()
                        if rec is not None:
                            rec.commit()  # one record a dispatch
                        continue
                    self.gen.drain()
                    self._finish_dead_slots()
                    if rec is not None and rec.pending_device_work:
                        rec.commit()  # the tail flush of the last block
            except Exception as exc:
                # a crash racing close() skips recovery: the final flush
                # wakes every consumer with the typed error anyway
                if self._closed:
                    return
                with LAUNCH_GATE.serving():  # recovery replays a graph
                    recovered = self._recover_or_die(exc)
                if not recovered:
                    return
                if rec is not None:
                    # the crashed pass and the recovery must not be billed
                    # to the next dispatch's record
                    rec.reset()
                continue
            t_pop = time.perf_counter()
            try:  # idle: block briefly, backing off toward 50 ms
                req = self._requests.get(timeout=self._idle_backoff)
            except _queue.Empty:
                self._idle_backoff = min(self._idle_backoff * 2, 0.05)
                if rec is not None:
                    rec.reset()  # pure idle: no dispatch to charge
                continue
            self._idle_backoff = _IDLE_WAIT_S
            if req is None:
                return
            self._enqueue_waiting(req)
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
                self._enqueue_waiting(more)
            if rec is not None:
                # the wait for the arrival that woke us plus the burst
                # window before the admission wave
                rec.note("queue_pop", time.perf_counter() - t_pop)

    def _steer(self) -> None:
        """After a dispatch: record the ladder entry it ran
        (``app_llm_chunk_tokens``) and let the SLO controller re-steer the
        prefill share (at most every controller interval)."""
        sched = self.gen.scheduler
        if sched is None:
            return
        dispatched = sum(sched.dispatches.values())
        if self._metrics is not None and dispatched != self._steered_dispatches:
            self._steered_dispatches = dispatched
            self._metric("record_histogram", "app_llm_chunk_tokens",
                         float(sched.last_chunk))
        if self._controller is not None:
            self._controller.maybe_update()

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
        for slot, req in list(self._active.items()):
            # tokens of an in-flight slot a force-close dropped never ship
            # as a completed answer (a graceful drain finished them first)
            self._note_goodput("disconnected", self._slot_produced(slot))
            leftovers.append(req)
            del self._active[slot]
        exc = self._closed_error()
        for req in leftovers:
            self._reject(req, exc)

    def _closed_error(self) -> Exception:
        """The typed error the consumers of a server no longer serving
        get: ``GeneratorCrashed`` once dead, ``ServerClosed`` on a close."""
        if self._state == "dead":
            return GeneratorCrashed(
                "llm server is dead: generator restart budget exhausted "
                f"({self._max_restarts} restarts/"
                f"{self._restart_window:g}s)")
        return ServerClosed()

    def _note_goodput(self, reason: str, tokens: int) -> None:
        """Classify device-computed tokens in the goodput ledger: one call
        a fate decision, never one a token."""
        if self._goodput is not None and tokens > 0:
            self._goodput.note(self.name, reason, int(tokens))

    def _slot_produced(self, slot: int | None) -> int:
        """Tokens the device computed for a slot, read defensively (the
        crash paths run while the wreck is mid-teardown)."""
        try:
            return 0 if slot is None else int(self.gen.slots[slot].produced)
        except Exception:
            return 0

    def _finish_journey(self, req: _Request, reason: str,
                        error: str | None = None) -> None:
        seal_journey(req.journey, reason, error, log=self._journeys,
                     metrics=self._metrics)

    def _reject(self, req: _Request, exc: Exception) -> None:
        """End a request that will never (or no longer) decode: its spans
        carry the typed outcome (``ml.finish_reason``), its journey is
        sealed with it, its consumer gets the error."""
        reason = _abort_reason(exc)
        if reason is not None:
            for span in (req.queue_span, req.decode_span):
                if span is not None and span.end_time is None:
                    span.set_attribute("ml.finish_reason", reason)
        req.finish_spans("ERROR", str(exc))
        if req.journey is not None:
            self._finish_journey(req, reason or "error", str(exc))
        req.send(exc)
        req.send(_DONE)

    # -- watchdog / crash recovery --------------------------------------------
    def _recover_or_die(self, exc: BaseException) -> bool:
        """A supervised dispatch raised. In the JAX server's order:
        forensics first (the crash bundle, while the wreck is intact), then
        the state flip, then the rejects — ONLY the requests bound to live
        slots fail, with ``GeneratorCrashed``; then ``Generator.recover``
        resets decode state and True resumes the waiting queue, untouched.
        Past the restart budget, or when recovery itself raises (a sticky
        device error fails its synchronisation), False: the server is
        ``dead`` and every consumer is flushed with the typed error."""
        _log.error("llm %s: generator crashed (%s: %s)", self.name,
                   type(exc).__name__, exc)
        if self._logger is not None:
            self._logger.error("llm generator crashed", model=self.name,
                               error=str(exc), type=type(exc).__name__,
                               stack=traceback.format_exc())
        crash_id = self._capture_crash(exc)
        crash = GeneratorCrashed(
            f"generator dispatch failed ({type(exc).__name__}: {exc})")
        now = time.monotonic()
        with self._restart_lock:
            while (self._restart_times
                   and now - self._restart_times[0] > self._restart_window):
                self._restart_times.popleft()
            in_window = len(self._restart_times)
        if in_window >= self._max_restarts:
            self._state = "dead"
            self._record_restart(exc, recovered=False, crash_id=crash_id)
            self._events.emit("dead", model=self.name, crash_id=crash_id,
                              restarts=self._restarts_total,
                              budget=self._max_restarts)
            self._fail_in_flight(crash)
            if self._logger is not None:
                self._logger.error(
                    "llm restart budget exhausted; server is dead",
                    model=self.name, restarts=self._restarts_total,
                    budget=self._max_restarts,
                    window_s=self._restart_window)
            return False
        with self._restart_lock:
            self._restart_times.append(now)
        self._state = "recovering"
        # quarantine the borrowed prefixes BEFORE waking the crashed
        # slots' consumers: a woken consumer must never see a suspect
        # registration as live (host bookkeeping only)
        try:
            quarantined = self.gen.quarantine_borrowed()
        except Exception:
            quarantined = []
        self._fail_in_flight(crash)
        t0 = time.perf_counter()
        try:
            invalidated = self.gen.recover()
        except Exception as rexc:
            self._state = "dead"
            # kept, with its traceback and so the failed pass's frames:
            # after a sticky device error, freeing the tensors they hold
            # (a pinned block records a CUDA event when freed) aborts the
            # process, and a dead server has no use for the memory
            self._fatal = rexc
            self._record_restart(exc, recovered=False, crash_id=crash_id)
            self._events.emit("dead", model=self.name, crash_id=crash_id,
                              error=f"recovery failed: {rexc}")
            _log.error("llm %s: recovery failed, the server is dead "
                       "(%s: %s)", self.name, type(rexc).__name__, rexc)
            if self._logger is not None:
                self._logger.error(
                    "llm generator recovery failed; server is dead",
                    model=self.name, error=str(rexc),
                    stack=traceback.format_exc())
            return False
        if self.prefix_cache is not None:
            for pid in (*quarantined, *invalidated):
                self.prefix_cache.invalidate(pid)
        self._restarts_total += 1
        self._state = "degraded"  # until the restart window drains
        recovery_ms = round((time.perf_counter() - t0) * 1e3, 1)
        self._record_restart(exc, recovered=True, recovery_ms=recovery_ms,
                             crash_id=crash_id)
        self._events.emit("recover", model=self.name, crash_id=crash_id,
                          recovery_ms=recovery_ms,
                          queued=len(self._waiting))
        self._steered_dispatches = -1
        self._metric("add_counter", "app_ml_generator_restarts_total", 1)
        if self._logger is not None:
            self._logger.warnf(
                "llm %s generator recovered (restart %d/%d in window); "
                "resuming the waiting queue (%d queued)", self.name,
                len(self._restart_times), self._max_restarts,
                len(self._waiting))
        return True

    def _fail_in_flight(self, crash: Exception) -> None:
        """Fail the requests bound to slots, their tokens charged as
        ``crashed``."""
        for slot, req in list(self._active.items()):
            self._note_goodput("crashed", self._slot_produced(slot))
            self._reject(req, crash)
            del self._active[slot]

    def _record_restart(self, exc: BaseException, recovered: bool,
                        recovery_ms: float | None = None,
                        crash_id: str | None = None) -> None:
        with self._restart_lock:
            self._restart_history.append({
                "at": time.time(),
                "error": f"{type(exc).__name__}: {exc}",
                "recovered": recovered,
                "recovery_ms": recovery_ms,
                "crash_id": crash_id,  # the /debug/crash/<id> bundle
            })

    def _capture_crash(self, exc: BaseException) -> str | None:
        """Snapshot the crash into a forensics bundle (the trigger event,
        the last events, the scheduler and pool state, the in-flight slot
        table, the victims' journeys and the newest dispatch records) and
        return its ``/debug/crash/<id>`` id. Runs before the slots are
        failed; a failure here never blocks recovery."""
        try:
            now = time.perf_counter()
            active = sorted(self._active.items())
            slot_table = [{
                "slot": slot,
                "rid": req.rid,
                "prompt_tokens": req.n_tokens,
                "produced": self._slot_produced(slot),
                "priority": PRIORITIES[req.priority],
                "age_s": round(now - req.enqueued_at, 4),
                "streamed": req.first_token_at is not None,
            } for slot, req in active]
            trigger = self._events.emit(
                "crash", model=self.name,
                error=f"{type(exc).__name__}: {exc}",
                in_flight=len(slot_table), queued=len(self._waiting))
            state: dict = {
                "server_state": self._state,
                "restarts_total": self._restarts_total,
                "slots": slot_table,
                "scheduler": self.scheduler_snapshot(),
            }
            journeys = [req.journey.snapshot() for _, req in active
                        if req.journey is not None]
            if journeys:
                state["journeys"] = journeys
            if self.recorder is not None:
                state["dispatches"] = self.recorder.tail(16)
            try:  # the pool counters may be mid-wreck; best effort
                state["pool"] = self.gen.pool_stats()
            except Exception:
                pass
            return self._crashes.capture(
                model=self.name, trigger=trigger, state=state,
                events=self._events.tail(128))
        except Exception:
            return None

    # -- admission bounds and shedding --------------------------------------
    def _enqueue_waiting(self, req: _Request) -> None:
        """Within the bounds the request joins its priority class. Past
        ``GOFR_ML_MAX_QUEUE`` / ``GOFR_ML_MAX_QUEUED_TOKENS`` the NEWEST
        request of the lowest class worse than the arrival is shed in its
        place; with none worse, the arrival is shed. The request bound
        measures backlog, not staging: requests that free slots will
        admit on the next pass count against it less those slots, so an
        idle server never sheds a burst it is about to serve."""
        w = self._waiting
        n_free = sum(1 for s in self.gen.slots if not s.live)
        over = ((self._max_queue > 0
                 and len(w) - n_free >= self._max_queue)
                or (self._max_queued_tokens > 0 and len(w) > n_free
                    and w.tokens + req.n_tokens > self._max_queued_tokens))
        if not over:
            w.push(req)
            return
        victim = w.shed_lowest(worse_than=req.priority)
        if victim is None:
            victim = req  # nothing queued is worse: shed the arrival
        else:
            w.push(req)
        self._shed(victim)

    def _shed(self, req: _Request) -> None:
        retry_after = self._retry_after_s()
        prio = PRIORITIES[req.priority]
        self._shed_counts[prio] += 1
        self._events.emit("shed", model=self.name, priority=prio,
                          rid=req.rid, queued=len(self._waiting),
                          queued_tokens=self._waiting.tokens,
                          retry_after_s=round(retry_after, 3))
        self._metric("add_counter", "app_llm_shed_total", 1, priority=prio)
        self._reject(req, Overloaded(
            f"server overloaded ({len(self._waiting)} queued, "
            f"{self._waiting.tokens} queued tokens); "
            f"retry in ~{retry_after:.1f}s", retry_after=retry_after))

    def _retry_after_s(self) -> float:
        """Retry-After from this server's observed admission rate, scaled
        by the backlog ahead of a retry."""
        return retry_after_s(self._admit_times, len(self._waiting))

    def _admit_waiting(self) -> None:
        while True:  # pull everything queued
            try:
                req = self._requests.get_nowait()
            except _queue.Empty:
                break
            if req is None:
                self._closed = True
                return
            self._enqueue_waiting(req)
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
            if getattr(self.gen, "page_size", 0):
                # one at a time: add_requests is all-or-nothing, and a
                # batch that ran the pool dry on its last member would
                # unwind the others and livelock on retry
                n_free = min(n_free, 1)
            batch = []
            req = None
            try:
                while len(self._waiting) and len(batch) < n_free:
                    req = self._waiting.pop()
                    if (req.deadline_at is not None
                            and time.perf_counter() >= req.deadline_at):
                        self._expire(req, "while queued")
                        req = None
                        continue
                    try:
                        # one bad request rejects alone, not the whole wave
                        ids = self._split_prefix(req)
                        self.check_admissible(
                            req.full_prompt if req.full_prompt is not None
                            else ids, req.max_new,
                            prefix=None if req.full_prompt is not None
                            else req.prefix)
                    except ValueError as exc:
                        self._reject(req, exc)
                        req = None
                        continue
                    batch.append((req, ids))
                    req = None
            except Exception as exc:
                # the radix lookup dispatches device work (a restore, a
                # spill, a prefix prefill): a crash there leaves the popped
                # request and the batch in neither _waiting nor _active,
                # where the watchdog cannot see them — fail them here
                crash = GeneratorCrashed(
                    f"admission dispatch failed "
                    f"({type(exc).__name__}: {exc})")
                for r in ([req] if req is not None else []) + \
                        [r for r, _ in batch]:
                    self._reject(r, crash)
                raise
            if not batch:
                continue
            try:
                # a request on a prefix comes in a paged batch of one
                slots = self.gen.add_requests([
                    (ids, req.max_new,
                     (lambda i, toks, r=req: self._emit(r, toks)), req.prefix)
                    for req, ids in batch])
            except PrefixEvicted as exc:
                req = batch[0][0]
                if req.full_prompt is not None:
                    # the cache split this prompt and the generator evicted
                    # the prefix before admission: requeue with the full
                    # prompt — the caller never learns caching was tried;
                    # the prefix tokens prefill again (restore_fallback)
                    self.prefix_cache.invalidate(req.prefix)
                    self.prefix_cache.record_miss(
                        lost_tokens=len(req.full_prompt) - len(req.prompt))
                    req.prompt = req.full_prompt
                    req.prefix = None
                    req.full_prompt = None
                    self._waiting.push_front(req)
                    continue
                # an explicitly passed prefix: re-registering is the
                # caller's
                self._reject(req, exc)
                continue
            except PagePoolExhausted:
                # transient back-pressure: pages free as live slots finish,
                # so requeue at the FRONT of each class and let decode run
                for req, _ in reversed(batch):
                    self._waiting.push_front(req)
                break
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
            now = time.perf_counter()
            for (req, _), slot in zip(batch, slots, strict=True):
                req.slot = slot
                self._active[slot] = req
                # fused decode windows bound a row's device steps by it, so
                # a window does not run K steps for a slot the reaper is
                # about to cancel; the reaper stays authoritative
                self.gen.slots[slot].deadline_at = req.deadline_at
                self._admit_times.append(now)
                trace = (req.trace_ctx.trace_id
                         if req.trace_ctx is not None else None)
                self._events.emit(
                    "admit", model=self.name, slot=slot, rid=req.rid,
                    priority=PRIORITIES[req.priority],
                    prompt_tokens=req.n_tokens,
                    queued_ms=round((now - req.enqueued_at) * 1e3, 2),
                    **({"trace": trace} if trace is not None else {}))
                if req.journey is not None:
                    # the admit mark closes the queue-wait segment
                    extra: dict = {"slot": slot,
                                   "priority": PRIORITIES[req.priority]}
                    if req.full_prompt is not None:
                        extra["prefix_tokens"] = (len(req.full_prompt)
                                                  - len(req.prompt))
                    sched = self.gen.scheduler
                    if sched is not None and sched.restore_debt:
                        extra["restore_debt"] = sched.restore_debt
                    req.journey.mark("admit", **extra)
                if req.full_prompt is not None:
                    # the hit is real only now: the slot borrowed the
                    # prefix pages and only the suffix prefilled
                    self.prefix_cache.commit_hit(req.prefix)
                self._note_admitted(req, slot, now)

    def _note_admitted(self, req: _Request, slot: int, now: float) -> None:
        """Close the request's ``ml.queue`` span, open its ``ml.decode``
        span and record its queue wait (overall and per class)."""
        if req.queue_span is not None:
            req.queue_span.set_attribute("ml.slot", slot)
            req.queue_span.end()
        if self._tracer is not None:
            req.decode_span = self._tracer.start_span(
                "ml.decode", parent=req.trace_ctx, activate=False,
                attributes={"ml.model": self.name, "ml.slot": slot})
        wait = now - req.enqueued_at
        self._metric("record_histogram", "app_llm_queue_seconds", wait)
        self._metric("record_histogram", "app_llm_priority_queue_seconds",
                     wait, priority=PRIORITIES[req.priority])

    def _metric(self, method: str, name: str, value: float,
                **labels: str) -> None:
        """Record one value labelled with this model. A manager without
        the metric (a bare one in a test) never takes the serving thread
        down."""
        if self._metrics is None:
            return
        try:
            getattr(self._metrics, method)(name, value, model=self.name,
                                           **labels)
        except Exception:
            pass

    def _split_prefix(self, req: _Request) -> np.ndarray:
        """The ids to admit: the radix lookup splits the prompt into
        (registered prefix, suffix) so prefill covers only the suffix; hot
        prefixes promote inside ``observe``. Runs once a request
        (``cache_seen``): a requeued request keeps its split, and the
        PrefixEvicted fallback keeps its decision to go uncached."""
        ids = np.asarray(req.prompt, np.int32).reshape(-1)
        cache = self.prefix_cache
        if cache is None or req.prefix is not None or req.cache_seen:
            return ids
        req.cache_seen = True
        if len(ids) and (ids.min() < 0
                         or ids.max() >= self.gen.cfg.vocab_size):
            return ids  # check_admissible rejects it; keep it off the trie
        pid, reg_len = cache.observe(ids)
        if pid is None:
            return ids
        req.full_prompt = ids
        req.prefix = pid
        req.prompt = ids[reg_len:]
        return req.prompt

    def _run_setup_tasks(self) -> None:
        """Run queued device-touching work (``register_prefix``,
        ``drop_prefix``) on the serving thread, the one thread that
        touches the generator."""
        while True:
            try:
                work = self._setup_q.get_nowait()
            except _queue.Empty:
                return
            work()

    def _run_on_serving(self, work, timeout_s: float, what: str):
        """Run ``work`` on the serving thread and relay its result or
        exception here. It may wait one idle-poll interval (<= 50 ms) plus
        whatever device work ``work`` itself does."""
        done = threading.Event()
        box: dict = {}

        def wrapped() -> None:
            try:
                box["out"] = work()
            except Exception as exc:  # relayed to the caller below
                box["err"] = exc
            finally:
                done.set()

        if self._closed:
            raise self._closed_error()
        self._setup_q.put(wrapped)
        deadline = time.monotonic() + timeout_s
        while not done.wait(0.1):
            if self._closed:  # serving thread gone: fail fast
                raise self._closed_error()
            if time.monotonic() > deadline:
                raise DeadlineExceeded(
                    f"{what} timed out after {timeout_s:g}s")
        if "err" in box:
            raise box["err"]
        return box.get("out")

    def register_prefix(self, prefix_ids, timeout_s: float = 120.0) -> int:
        """PIN a shared prefix (a system prompt): registered through the
        prefix cache when one is on, so it is evicted under pool pressure
        only as a last resort and never while borrowed. Returns the id to
        pass as ``prefix=`` to ``stream_chunks``/``generate`` (with the
        cache on, plain submissions longest-match it anyway). Thread-safe:
        the prefill runs on the serving thread."""
        def work() -> int:
            if self.prefix_cache is not None:
                return self.prefix_cache.pin(prefix_ids)
            return self.gen.register_prefix(prefix_ids)

        return self._run_on_serving(work, timeout_s, "register_prefix")

    def drop_prefix(self, pid: int, timeout_s: float = 30.0) -> None:
        """Release a registered prefix's pages (raises if slots still
        borrow them). Runs on the serving thread like ``register_prefix``."""
        def work() -> None:
            if self.prefix_cache is not None:
                self.prefix_cache.drop(pid)
            else:
                self.gen.drop_prefix(pid)

        self._run_on_serving(work, timeout_s, "drop_prefix")

    def has_prefix(self, pid: int) -> bool:
        """False once the prefix was dropped or evicted under pool
        pressure."""
        return self.gen.has_prefix(pid)

    def _emit(self, req: _Request, tokens: list[int]) -> None:
        """Push one BURST of tokens to the consumer — one loop wakeup per
        burst, not per token — and feed TTFT / cadence to the metrics and
        the SLO controller."""
        if self._fault is not None:
            self._fault("emit")  # chaos point: a poisoned token callback
        if req.journey is not None:
            # one mark a burst: the first closes the prefill segment (the
            # TTFT boundary), later ones are decode; each carries the
            # in-flight depth and the dispatch seq this pass commits as
            name = "prefill" if req.first_token_at is None else "decode"
            depth = len(self.gen._inflight)
            rec = self.recorder
            if rec is not None:
                rec.note_rid(req.rid)
                req.journey.mark(name, tokens=len(tokens), inflight=depth,
                                 dispatch=rec.dispatches + 1)
            else:
                req.journey.mark(name, tokens=len(tokens), inflight=depth)
        now = time.perf_counter()
        if (self._controller is not None and tokens
                and req.last_burst_at is not None):
            # live cadence per burst: waiting for the stream's end would
            # leave the controller blind for a long stream's lifetime
            self._controller.observe_tpot(
                (now - req.last_burst_at) / len(tokens))
        req.last_burst_at = now
        if req.first_token_at is None:
            req.first_token_at = now
            ttft = now - req.enqueued_at
            if self._controller is not None:
                self._controller.observe_ttft(ttft)
            if req.decode_span is not None:
                req.decode_span.add_event("first_token", {"ttft_s": ttft})
            self._metric("record_histogram", "app_llm_ttft_seconds", ttft)
        self._metric("add_counter", "app_llm_tokens_total", len(tokens))
        req.send(list(tokens))

    def _expire(self, req: _Request, where: str) -> None:
        self.deadline_expired += 1
        self._events.emit("deadline", model=self.name, where=where,
                          rid=req.rid, priority=PRIORITIES[req.priority])
        self._metric("add_counter", "app_llm_deadline_exceeded_total", 1)
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
            if r.cancelled:
                r.finish_spans("ERROR", "cancelled before admission")
            else:
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

    def _export_pool_gauges(self) -> None:
        """Slot and pool pressure, the host tier's traffic and the
        scheduler's budget split, for ``/metrics``."""
        if self._metrics is None:
            return
        gen = self.gen
        self._metric("set_gauge", "app_llm_active_slots", float(gen.n_live))
        self._metric("set_gauge", "app_llm_evictions", float(gen.evictions))
        if getattr(gen, "page_size", 0):
            self._metric("set_gauge", "app_llm_prefix_evictions",
                         float(gen.prefix_evictions))
            self._metric("set_gauge", "app_llm_free_pages",
                         float(gen.free_pages))
            self._export_offload_metrics()
        sched = gen.scheduler
        if sched is not None:
            self._metric("set_gauge", "app_llm_token_budget",
                         float(sched.budget))
            self._metric("set_gauge", "app_llm_prefill_share",
                         float(sched.prefill_share))

    def _export_offload_metrics(self) -> None:
        """The host tier's bytes held, and its spill / restore counts as
        counter deltas."""
        host = getattr(self.gen, "host_kv", None)
        if host is None:
            return
        self._metric("set_gauge", "app_ml_kv_offload_bytes",
                     float(host.bytes_used))
        spills, restores = int(self.gen.kv_spills), int(self.gen.kv_restores)
        if spills > self._kv_spills_seen:
            self._metric("add_counter", "app_ml_kv_offload_spills_total",
                         spills - self._kv_spills_seen)
            self._kv_spills_seen = spills
        if restores > self._kv_restores_seen:
            self._metric("add_counter", "app_ml_kv_offload_restores_total",
                         restores - self._kv_restores_seen)
            self._kv_restores_seen = restores

    def _finish_dead_slots(self) -> None:
        self._export_pool_gauges()
        for slot, req in list(self._active.items()):
            s = self.gen.slots[slot]
            if s.live:
                continue
            produced = s.produced
            self.gen.release(slot)
            del self._active[slot]
            if req.deadline_hit:
                # its tokens never ship as a whole answer
                self._note_goodput("deadline_cancelled", produced)
                self._expire(req, "mid-generation")
                continue
            reason = ("eviction" if s.evicted
                      else "stop" if s.eos_hit else "length")
            if produced > 1 and req.first_token_at is not None:
                # the stream's cadence after its first token: the SLO pair
                # of TTFT
                self._metric("record_histogram", "app_llm_tpot_seconds",
                             (time.perf_counter() - req.first_token_at)
                             / (produced - 1))
            if req.decode_span is not None:
                req.decode_span.set_attributes({"ml.tokens": produced,
                                                "ml.finish_reason": reason})
            if req.journey is not None:
                req.journey.note(tokens=produced)
                self._finish_journey(req, reason)
            req.finish_spans()
            # a natural finish delivered every token; a consumer that went
            # away mid-stream received nothing it will use
            self._note_goodput(
                "disconnected" if req.cancelled else "delivered", produced)
            self.served += 1
            req.send(_Finish(reason))

    # -- caller side ------------------------------------------------------------
    def check_admissible(self, prompt_ids, max_new_tokens: int = 1,
                         prefix: int | None = None) -> None:
        """Raise ValueError if this request can NEVER admit under the
        generator's static shape rules: prompt (or prefix + suffix) length
        against ``max_seq`` and the prefill buckets, token ids against the
        vocabulary, and a page pool too small to ever cover it. A prompt
        longer than every bucket is admissible when chunked prefill takes
        it or a cached prefix covers all but a suffix that fits. Busy
        slots and recoverable pool pressure are not reasons — those
        requests queue."""
        gen = self.gen
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        n = len(ids)
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        vocab = gen.cfg.vocab_size
        if n and (ids.min() < 0 or ids.max() >= vocab):
            raise ValueError(f"token ids must lie in [0, {vocab})")
        buckets = gen.prefill_buckets
        if prefix is not None:
            info = getattr(gen, "_prefixes", {}).get(prefix)
            if info is None:
                return  # evicted: the PrefixEvicted path answers it
            n_suf = len(info["tail"]) + n
            if n_suf == 0 or info["len"] + n_suf >= gen.max_seq:
                raise ValueError(
                    f"prefix {info['len']} + suffix {n_suf} out of range "
                    f"(1..{gen.max_seq - 1})")
            if n_suf > buckets[-1]:
                raise ValueError(
                    f"suffix length {n_suf} exceeds the largest prefill "
                    f"bucket {buckets[-1]}")
            return
        if n == 0 or n >= gen.max_seq:
            raise ValueError(
                f"prompt length {n} out of range (1..{gen.max_seq - 1})")
        chunked = getattr(gen, "prefill_chunk", 0) and n > gen.prefill_chunk
        if not chunked and n > buckets[-1]:
            # a cached prefix can still admit it: only the suffix prefills
            if (self.prefix_cache is None
                    or self.prefix_cache.peek(ids)[0] is None):
                raise ValueError(
                    f"prompt length {n} exceeds the largest prefill bucket "
                    f"{buckets[-1]}")
        if getattr(gen, "page_size", 0):
            upto = min(n + 2 * gen.chunk, n + max_new_tokens, gen.max_seq)
            need = -(-upto // gen.page_size)
            if need > gen._pages_ever_free():
                raise ValueError(
                    f"request needs {need} pages but the pool can only "
                    f"ever free {gen._pages_ever_free()}")

    async def stream_chunks(self, prompt_ids, max_new_tokens: int = 64,
                            info: dict | None = None,
                            priority: int | str | None = None,
                            deadline_s: float | None = None,
                            prefix: int | None = None
                            ) -> AsyncIterator[list[int]]:
        """Yield BURSTS of tokens — each list is the slot's share of one
        processed decode block (the first is ``[first_token]``).

        ``priority``: ``"high"`` / ``"normal"`` / ``"low"`` or the class
        index (unknown values raise ValueError before enqueue).
        ``deadline_s``: the request's TTL (None reads
        ``GOFR_ML_DEFAULT_DEADLINE_S``; 0 = none); past it the request
        fails with ``DeadlineExceeded`` wherever it sits. Past the queue
        bounds the request (or a lower-priority one queued before it)
        fails with ``Overloaded``.
        ``prefix``: a ``register_prefix`` id (paged); ``prompt_ids`` is
        then the suffix. Pass ``info={}`` to receive
        ``info["finish_reason"]`` (``"stop"``, ``"length"`` or
        ``"eviction"``)."""
        if self._closed or self._draining:
            raise self._closed_error()
        prio = normalize_priority(priority)
        ttl = self._default_deadline if deadline_s is None else deadline_s
        if not ttl >= 0:  # rejects NaN too
            raise ValueError(f"deadline_s must be >= 0, got {ttl}")
        out_q: asyncio.Queue = asyncio.Queue()
        # the caller's span, captured here: the serving thread parents
        # ml.queue / ml.decode on it explicitly
        ctx = current_context()
        queue_span = None
        if self._tracer is not None:
            queue_span = self._tracer.start_span(
                "ml.queue", parent=ctx, activate=False,
                attributes={"ml.model": self.name})
        rid = next_rid()
        journey = None
        if self._journeys is not None:
            journey = self._journeys.start(Journey(
                rid, model=self.name,
                trace_id=ctx.trace_id if ctx is not None else None))
        req = _Request(np.asarray(prompt_ids).reshape(-1), max_new_tokens,
                       out_q, asyncio.get_running_loop(), prio, ttl,
                       prefix=prefix, trace_ctx=ctx, queue_span=queue_span,
                       rid=rid, journey=journey)
        self._requests.put(req)
        if self._closed:
            # close() may have flushed before our put landed: never park on
            # a queue nobody reads
            req.cancelled = True
            if journey is not None:
                self._finish_journey(req, "error", "server closed")
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
            if journey is not None and not journey.done:
                # abandonment, not a serving failure (errors and natural
                # finishes sealed the journey before this)
                self._finish_journey(req, "cancelled")

    async def stream(self, prompt_ids, max_new_tokens: int = 64,
                     info: dict | None = None,
                     priority: int | str | None = None,
                     deadline_s: float | None = None,
                     prefix: int | None = None) -> AsyncIterator[int]:
        """Yield tokens one at a time (a view of ``stream_chunks``)."""
        agen = self.stream_chunks(prompt_ids, max_new_tokens, info=info,
                                  priority=priority, deadline_s=deadline_s,
                                  prefix=prefix)
        try:
            async for burst in agen:
                for tok in burst:
                    yield tok
        finally:
            await agen.aclose()

    async def generate(self, prompt_ids, max_new_tokens: int = 64,
                       info: dict | None = None,
                       priority: int | str | None = None,
                       deadline_s: float | None = None,
                       prefix: int | None = None) -> list[int]:
        """Collect the full completion."""
        out: list[int] = []
        async for burst in self.stream_chunks(prompt_ids, max_new_tokens,
                                              info=info, priority=priority,
                                              deadline_s=deadline_s,
                                              prefix=prefix):
            out.extend(burst)
        return out

    def queue_depth(self) -> int:
        """Requests waiting for a decode slot (sampled as
        ``app_ml_queue_depth{component="llm"}``)."""
        return len(self._waiting) + self._requests.qsize()

    def scheduler_snapshot(self) -> dict:
        """The token budget and realized ladder mix, the SLO controller's
        last percentiles against its targets, and each priority class's
        depth and oldest wait. Safe from any thread."""
        out: dict = {"waiting": self._waiting.snapshot()}
        sched = self.gen.scheduler
        if sched is not None:
            out.update(sched.snapshot())
        else:
            out["budget"] = None  # fixed-chunk dispatch
        out["prefill_segments"] = self.gen.prefill_segments_run
        if self._controller is not None:
            out["slo"] = self._controller.snapshot()
        return out

    def resilience_snapshot(self) -> dict:
        """The ``resilience`` block of ``/debug/serving``: state, the
        restart budget and history, shed and deadline counters, the queue
        bounds and the armed fault config. Safe from any thread."""
        with self._restart_lock:
            in_window = len(self._restart_times)
            recent = list(self._restart_history)
        return {
            "state": self.health(),
            "draining": self._draining,
            "closed_cleanly": self.closed_cleanly,
            "restarts": {
                "total": self._restarts_total,
                "in_window": in_window,
                "budget": self._max_restarts,
                "window_s": self._restart_window,
                "recent": recent,
            },
            "shed": dict(self._shed_counts),
            "deadline_expired": self.deadline_expired,
            "queue_bounds": {
                "max_requests": self._max_queue or None,
                "max_tokens": self._max_queued_tokens or None,
                "queued": len(self._waiting),
                "queued_tokens": self._waiting.tokens,
            },
            "default_deadline_s": self._default_deadline or None,
            "fault": fault_snapshot(self._fault),
        }

    def snapshot(self) -> dict:
        """The serving state a status page shows: the generator's pool
        counters (the host tier's spills, restores and fallbacks among
        them), the host tier's occupancy, the scheduler's plan, the fused
        window and pipeline counters (None when off), the decode graphs
        (None on the CPU) and the prefix cache. Reads counters the serving
        thread writes; safe from any thread."""
        gen = self.gen
        host = getattr(gen, "host_kv", None)
        sched = gen.scheduler
        return {
            "health": self.health(),
            "served": self.served,
            "deadline_expired": self.deadline_expired,
            "resilience": self.resilience_snapshot(),
            "pool": gen.pool_stats(),
            "kv_host_tier": None if host is None else host.stats(),
            "scheduler": None if sched is None else sched.snapshot(),
            "window": gen.window_stats(),
            "pipeline": gen.pipeline_stats(),
            "graphs": gen.graph_stats(),
            "prefix_cache": (None if self.prefix_cache is None
                             else self.prefix_cache.snapshot()),
        }

    def health(self) -> str:
        """``serving``; ``recovering`` while a crash recovery runs;
        ``degraded`` with a restart inside the restart window (still
        serving); ``dead`` once the budget is spent, recovery failed, or
        the server closed."""
        if (self._state == "dead" or self._closed
                or not self._thread.is_alive()):
            return "dead"
        if self._state == "recovering":
            return "recovering"
        now = time.monotonic()
        with self._restart_lock:
            degraded = any(now - t <= self._restart_window
                           for t in self._restart_times)
        return "degraded" if degraded else "serving"

    def health_check(self) -> dict:
        """The datasource contract: UP while serving, DEGRADED while
        recovering or degraded, DOWN when dead."""
        state = self.health()
        return {
            "status": {"serving": "UP", "degraded": "DEGRADED",
                       "recovering": "DEGRADED", "dead": "DOWN"}[state],
            "details": {
                "model": self.name,
                "state": state,
                "slots": self.gen.batch_slots,
                "live": self.gen.n_live,
                "queued": self.queue_depth(),
                "served": self.served,
                "decode_steps": self.gen.steps,
                "restarts": self._restarts_total,
            },
        }

    def close(self, drain_s: float | None = None) -> None:
        """Shut the server down. With ``drain_s`` > 0 (None reads
        ``GOFR_ML_DRAIN_S``; 0 = immediate) admission stops first (new
        calls fail with ``ServerClosed``, queued requests stay parked),
        in-flight decode runs to completion up to the deadline, then the
        serving thread stops and every remaining consumer gets
        ``ServerClosed``."""
        if drain_s is None:
            drain_s = self._drain_default
        if drain_s > 0 and not self._closed and self._thread.is_alive():
            self._draining = True
            self._events.emit("drain", model=self.name, drain_s=drain_s,
                              in_flight=len(self._active),
                              queued=len(self._waiting))
            deadline = time.monotonic() + drain_s
            while time.monotonic() < deadline:
                if not self._active and self.gen.n_live == 0:
                    break
                time.sleep(0.005)
            if self._logger is not None and self._active:
                self._logger.warnf(
                    "llm %s drain deadline (%.1fs) hit with %d request(s) "
                    "still in flight", self.name, drain_s, len(self._active))
        if not self._closed:
            self._closed = True
            self._requests.put(None)
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            self.closed_cleanly = False
            raise RuntimeError(f"llm {self.name}: serving thread did not stop")
