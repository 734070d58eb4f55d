"""Host-side admission and dispatch policy — counterpart of
``gofr_tpu/ml/scheduler.py``.

- ``normalize_priority`` and ``AgingPriorityQueue``: weighted priority
  classes (``high`` / ``normal`` / ``low``) with aging, the admission order
  of ``LLMServer``; the queue also keeps the queued prompt tokens and picks
  the shed victim under overload (``shed_lowest``);
- ``retry_after_s``: the ``Retry-After`` of a shed request, from the
  observed admission rate;
- ``TokenBudgetScheduler``: the per-dispatch planner a ``Generator``
  consults to pick a decode-ladder entry (a chunk size, or with fused
  decode windows a window size) and the prefill segments to run before
  it, paying down the debt host-tier restores charge to it and charging
  a speculative verify window K+1 positions a row (``unit_tokens``), and
  charging a sequence-parallel prefill wave at tokens over shards
  (``charge_sp``, on the same ledger as the restores);
- ``SLOController``: steers the scheduler's prefill share from observed
  TTFT / TPOT against ``GOFR_ML_TTFT_TARGET_MS`` /
  ``GOFR_ML_TPOT_TARGET_MS``.

Pure Python with no device work; all mutation happens on the serving thread
that owns the Generator.
"""

from __future__ import annotations

import collections
import os
import time

__all__ = ["PRIORITIES", "DEFAULT_PRIORITY", "normalize_priority",
           "TokenBudgetScheduler", "SLOController", "AgingPriorityQueue",
           "retry_after_s"]


def retry_after_s(admit_times, backlog: int) -> float:
    """Retry-After from the observed drain rate: admissions per second over
    the recent admission-timestamp window, scaled by the ``backlog`` ahead
    of a retry. 1 s before any drain was observed; clamped to [0.5, 300]
    s."""
    depth = backlog + 1
    rate = 0.0
    if len(admit_times) >= 2:
        span = admit_times[-1] - admit_times[0]
        if span > 0:
            rate = (len(admit_times) - 1) / span
    if rate <= 0:
        return 1.0
    return min(max(depth / rate, 0.5), 300.0)

# priority classes, best first; index == class number
PRIORITIES = ("high", "normal", "low")
_PRIORITY_BY_NAME = {name: i for i, name in enumerate(PRIORITIES)}
DEFAULT_PRIORITY = _PRIORITY_BY_NAME["normal"]


def normalize_priority(priority) -> int:
    """Map a caller-facing priority (class name, int, or None) onto a class
    index. Raises ValueError on unknown values (never demotes a typo to
    'normal'), on bools and on floats."""
    if priority is None:
        return DEFAULT_PRIORITY
    if isinstance(priority, str):
        try:
            return _PRIORITY_BY_NAME[priority.strip().lower()]
        except KeyError:
            raise ValueError(
                f"unknown priority {priority!r} (one of {PRIORITIES})"
            ) from None
    if isinstance(priority, bool) or not isinstance(priority, int):
        raise ValueError(
            f"priority must be a class name or int, got "
            f"{type(priority).__name__}")
    if not 0 <= priority < len(PRIORITIES):
        raise ValueError(
            f"priority {priority} out of range (0..{len(PRIORITIES) - 1})")
    return priority


class TokenBudgetScheduler:
    """Per-dispatch planner: one token budget split between decode and
    segmented prefill.

    - without prefill pending, ``plan`` picks the largest ladder entry
      whose decode tokens (``size * n_decodable * unit_tokens``) fit the
      budget, never below the ladder's first entry; ``unit_tokens`` is one
      ladder step's cost a row: 1 for plain decode, K+1 for a speculative
      verify window (``last_unit`` keeps the last plan's);
    - with prefill pending, ``prefill_share`` of the budget is reserved
      for prefill first (with a decode floor of half the largest chunk a
      live row), and the decode chunk shrinks down the ladder instead of
      delaying prefill a full chunk; a light batch (a quarter of the slots
      or fewer decoding) takes as many segments as the rest of the budget
      holds, a busy one the stall-free minimum of one.

    - ``prefill_share`` (clamped to [``min_share``, ``max_share``] by
      ``set_share``) is what the ``SLOController`` steers; above 0.6 even a
      busy batch takes as many segments as the budget holds;
    - a restore from the host KV tier charges its tokens as debt
      (``charge_restore``, capped at four budgets); each plan repays at
      most half a budget of it before budgeting the rest.

    ``plan`` returns ``(chunk_size, n_segments)``. ``note_dispatch`` counts
    the ladder entries dispatched; the Generator counts its TTFT
    mini-chunks, which are admission-driven rather than planned, in
    ``mini_dispatches``; ``last_segments`` is the last plan's segment
    count. A generator with fused decode windows sets ``window_mode``: its
    ladder entries are window sizes, planned by the same arithmetic."""

    def __init__(self, budget: int, ladder, prefill_chunk: int = 0, *,
                 slots: int | None = None, prefill_share: float = 0.5,
                 min_share: float = 0.05, max_share: float = 0.75) -> None:
        if budget <= 0:
            raise ValueError("token budget must be positive")
        self.budget = int(budget)
        self.ladder = tuple(sorted(int(c) for c in ladder))
        if not self.ladder:
            raise ValueError("chunk ladder is empty")
        self.prefill_chunk = int(prefill_chunk)
        self.slots = slots  # batch size hint for the decode-light test
        self.prefill_share = float(prefill_share)
        self.min_share = float(min_share)
        self.max_share = float(max_share)
        self.dispatches: collections.Counter = collections.Counter()
        self.mini_dispatches = 0
        self.last_chunk = self.ladder[-1]
        self.last_segments = 0
        self.last_unit = 1
        self.restore_debt = 0
        self.restores_charged = 0
        self.sp_charges = 0  # sequence-parallel prefill waves charged
        self.window_mode = False

    def charge_sp(self, tokens: int) -> None:
        """Charge one sequence-parallel prefill wave. The caller passes
        tokens / shards: each shard swept only its slice of the prompt, so
        the debt upcoming plans repay is one shard's work, not the whole
        prompt's. Rides the restore-debt ledger: the same cap, the same
        repayment."""
        self.restore_debt = min(self.restore_debt + max(0, int(tokens)),
                                4 * self.budget)
        self.sp_charges += 1

    def charge_restore(self, tokens: int) -> None:
        """Debit ``tokens`` of restore copy work against upcoming
        dispatch budgets, capped at four budgets so a burst of restores
        throttles the next dispatches but never starves decode."""
        self.restore_debt = min(self.restore_debt + max(0, int(tokens)),
                                4 * self.budget)
        self.restores_charged += 1

    def set_share(self, share: float) -> float:
        self.prefill_share = min(self.max_share,
                                 max(self.min_share, float(share)))
        return self.prefill_share

    def plan(self, n_decodable: int, prefill_pending: bool = False,
             unit_tokens: int = 1) -> tuple[int, int]:
        unit = max(1, int(unit_tokens))
        self.last_unit = unit
        budget = self.budget
        if self.restore_debt:
            # at most half a budget a dispatch: decode keeps the ladder
            # floor's cadence while the debt drains
            paid = min(self.restore_debt, budget // 2)
            self.restore_debt -= paid
            budget -= paid
        pending = prefill_pending and self.prefill_chunk > 0
        if pending:
            floor = (self.ladder[-1] // 2) * max(1, n_decodable) * unit
            decode_budget = max(budget - int(budget * self.prefill_share),
                                min(floor, budget))
        else:
            decode_budget = budget
        rows = max(1, n_decodable)
        size = self.ladder[0]
        for c in self.ladder:
            if c * rows * unit <= decode_budget:
                size = c
        if not pending:
            self.last_segments = 0
            return size, 0
        light = (self.slots is None
                 or n_decodable <= max(1, self.slots // 4)
                 or self.prefill_share > 0.6)
        spare = budget - size * n_decodable * unit
        segments = max(1, spare // self.prefill_chunk if light else 1)
        self.last_segments = segments
        return size, segments

    def note_dispatch(self, chunk_size: int) -> None:
        self.last_chunk = chunk_size
        self.dispatches[chunk_size] += 1

    def snapshot(self) -> dict:
        dispatches = dict(self.dispatches)  # atomic copy under the GIL
        return {
            "budget": self.budget,
            "plans": "windows" if self.window_mode else "chunks",
            "prefill_share": round(self.prefill_share, 4),
            "ladder": list(self.ladder),
            "last_chunk": self.last_chunk,
            "dispatches": {str(k): v for k, v in sorted(dispatches.items())},
            "mini_dispatches": self.mini_dispatches,
            "last_segments": self.last_segments,
            "last_unit": self.last_unit,
            "restore_debt": self.restore_debt,
            "restores_charged": self.restores_charged,
            "sp_charges": self.sp_charges,
        }


class SLOController:
    """Closed-loop steering of the prefill share from observed latency.

    The ``LLMServer`` feeds TTFT and TPOT samples as it measures them and
    calls ``maybe_update`` once a serve-loop pass; at most every
    ``interval_s`` it compares the window's p95s against the targets and
    nudges ``scheduler.prefill_share``: TPOT over target backs the share
    off by 0.7x (protect live streams), else TTFT over target adds 0.1
    (admit prompts faster), else the share drifts a tenth of the way back
    to neutral. Each update starts a fresh window. Serving thread only.
    """

    def __init__(self, scheduler: TokenBudgetScheduler, *,
                 ttft_target_s: float = 0.2, tpot_target_s: float = 0.05,
                 interval_s: float = 0.5, window: int = 64,
                 neutral_share: float = 0.5) -> None:
        self.scheduler = scheduler
        self.ttft_target_s = float(ttft_target_s)
        self.tpot_target_s = float(tpot_target_s)
        self.interval_s = float(interval_s)
        self.neutral_share = float(neutral_share)
        self._ttft: collections.deque = collections.deque(maxlen=window)
        self._tpot: collections.deque = collections.deque(maxlen=window)
        self._last_update = 0.0
        self.updates = 0
        self.last_ttft_p95 = float("nan")
        self.last_tpot_p95 = float("nan")

    @classmethod
    def from_env(cls, scheduler: TokenBudgetScheduler) -> "SLOController":
        """Targets from ``GOFR_ML_TTFT_TARGET_MS`` /
        ``GOFR_ML_TPOT_TARGET_MS`` (defaults 200 / 50 ms)."""
        ttft_ms = float(os.environ.get("GOFR_ML_TTFT_TARGET_MS", "200"))
        tpot_ms = float(os.environ.get("GOFR_ML_TPOT_TARGET_MS", "50"))
        return cls(scheduler, ttft_target_s=ttft_ms / 1e3,
                   tpot_target_s=tpot_ms / 1e3)

    def observe_ttft(self, seconds: float) -> None:
        self._ttft.append(seconds)

    def observe_tpot(self, seconds: float) -> None:
        self._tpot.append(seconds)

    @staticmethod
    def _p95(samples) -> float:
        if not samples:
            return float("nan")
        ordered = sorted(samples)
        return ordered[min(len(ordered) - 1, int(0.95 * len(ordered)))]

    def maybe_update(self, now: float | None = None) -> bool:
        now = time.monotonic() if now is None else now
        if now - self._last_update < self.interval_s:
            return False
        self._last_update = now
        ttft_p95 = self._p95(self._ttft)
        tpot_p95 = self._p95(self._tpot)
        self.last_ttft_p95, self.last_tpot_p95 = ttft_p95, tpot_p95
        self._ttft.clear()
        self._tpot.clear()
        sched = self.scheduler
        if tpot_p95 == tpot_p95 and tpot_p95 > self.tpot_target_s:
            sched.set_share(sched.prefill_share * 0.7)
        elif ttft_p95 == ttft_p95 and ttft_p95 > self.ttft_target_s:
            sched.set_share(sched.prefill_share + 0.1)
        else:
            sched.set_share(sched.prefill_share
                            + (self.neutral_share - sched.prefill_share)
                            * 0.1)
        self.updates += 1
        return True

    def snapshot(self) -> dict:
        def _ms(v: float):
            return None if v != v else round(v * 1e3, 2)

        return {"ttft_target_ms": self.ttft_target_s * 1e3,
                "tpot_target_ms": self.tpot_target_s * 1e3,
                "ttft_p95_ms": _ms(self.last_ttft_p95),
                "tpot_p95_ms": _ms(self.last_tpot_p95),
                "updates": self.updates}


class AgingPriorityQueue:
    """Weighted ready queues with aging — the admission order policy.

    One FIFO deque per priority class. ``pop`` compares the HEAD of each
    class by effective priority ``class - waited / aging_s``: a request ages
    one class per ``aging_s`` seconds waited, so nothing starves. Items
    expose ``priority`` (class index) and ``enqueued_at``
    (``time.perf_counter`` seconds); ``tokens`` sums the queued items'
    ``n_tokens`` (the ``GOFR_ML_MAX_QUEUED_TOKENS`` bound)."""

    def __init__(self, aging_s: float = 2.0) -> None:
        self.aging_s = max(1e-6, float(aging_s))
        self._queues: tuple[collections.deque, ...] = tuple(
            collections.deque() for _ in PRIORITIES)
        self.tokens = 0

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues)

    def __iter__(self):
        for q in self._queues:
            yield from q

    def push(self, item) -> None:
        self._queues[item.priority].append(item)
        self.tokens += getattr(item, "n_tokens", 0)

    def push_front(self, item) -> None:
        """Requeue ``item`` at the head of its class (a retry after
        transient back-pressure keeps its place)."""
        self._queues[item.priority].appendleft(item)
        self.tokens += getattr(item, "n_tokens", 0)

    def pop(self, now: float | None = None):
        """Next request to admit, or None when empty."""
        now = time.perf_counter() if now is None else now
        best_class = None
        best_eff = None
        for cls, q in enumerate(self._queues):
            if not q:
                continue
            eff = cls - (now - q[0].enqueued_at) / self.aging_s
            if best_eff is None or eff < best_eff:
                best_eff, best_class = eff, cls
        if best_class is None:
            return None
        item = self._queues[best_class].popleft()
        self.tokens -= getattr(item, "n_tokens", 0)
        return item

    def shed_lowest(self, worse_than: int | None = None):
        """Remove and return the shed victim under overload: the NEWEST
        request of the lowest-priority non-empty class (the oldest is
        closest to admission). With ``worse_than``, only classes strictly
        worse than it are candidates; None when there is no such victim."""
        floor = -1 if worse_than is None else int(worse_than)
        for cls in range(len(self._queues) - 1, floor, -1):
            q = self._queues[cls]
            if q:
                item = q.pop()
                self.tokens -= getattr(item, "n_tokens", 0)
                return item
        return None

    def prune(self, predicate) -> list:
        """Remove and return every item matching ``predicate``, preserving
        order among the kept."""
        removed: list = []
        for q in self._queues:
            kept = []
            for item in q:
                (removed if predicate(item) else kept).append(item)
            if len(kept) != len(q):
                q.clear()
                q.extend(kept)
        for item in removed:
            self.tokens -= getattr(item, "n_tokens", 0)
        return removed

    def drain(self) -> list:
        """Remove and return everything (close-flush path)."""
        out: list = []
        for q in self._queues:
            out.extend(q)
            q.clear()
        self.tokens = 0
        return out

    def snapshot(self, now: float | None = None) -> dict:
        """Depth and oldest wait of each class (safe from any thread)."""
        now = time.perf_counter() if now is None else now
        out = {}
        for name, q in zip(PRIORITIES, self._queues, strict=True):
            try:
                oldest = round(now - q[0].enqueued_at, 4)
            except IndexError:  # raced the serving thread's popleft
                oldest = 0.0
            out[name] = {"depth": len(q), "oldest_wait_s": oldest}
        return out
