"""Host-side admission and dispatch policy — counterpart of the parts of
``gofr_tpu/ml/scheduler.py`` the serving path uses.

- ``normalize_priority`` and ``AgingPriorityQueue``: weighted priority
  classes (``high`` / ``normal`` / ``low``) with aging, the admission order
  of ``LLMServer``;
- ``TokenBudgetScheduler``: the per-dispatch planner a ``Generator``
  consults to pick a decode-ladder entry (a chunk size, or with fused
  decode windows a window size) and the prefill segments to run before
  it, paying down the debt host-tier restores charge to it. The
  sequence-parallel debt waits for sequence parallelism (ROADMAP A.11);
  the speculative unit cost for speculation (A.10); ``SLOController``
  for the front (A.6).

Pure Python with no device work; all mutation happens on the serving thread
that owns the Generator.
"""

from __future__ import annotations

import collections
import time

__all__ = ["PRIORITIES", "DEFAULT_PRIORITY", "normalize_priority",
           "TokenBudgetScheduler", "AgingPriorityQueue"]

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
      whose decode tokens (``size * n_decodable``) fit the budget, never
      below the ladder's first entry;
    - with prefill pending, ``prefill_share`` of the budget is reserved
      for prefill first (with a decode floor of half the largest chunk a
      live row), and the decode chunk shrinks down the ladder instead of
      delaying prefill a full chunk; a light batch (a quarter of the slots
      or fewer decoding) takes as many segments as the rest of the budget
      holds, a busy one the stall-free minimum of one.

    - a restore from the host KV tier charges its tokens as debt
      (``charge_restore``, capped at four budgets); each plan repays at
      most half a budget of it before budgeting the rest.

    ``plan`` returns ``(chunk_size, n_segments)``. ``note_dispatch`` counts
    the ladder entries dispatched; the Generator counts its TTFT
    mini-chunks, which are admission-driven rather than planned, in
    ``mini_dispatches``; ``last_segments`` is the last plan's segment
    count. A generator with fused decode windows sets ``window_mode``: its
    ladder entries are window sizes, planned by the same arithmetic."""

    # the share of the budget reserved for pending prefill; in JAX the SLO
    # controller steers it (ROADMAP A.6), here it is fixed
    prefill_share = 0.5

    def __init__(self, budget: int, ladder, prefill_chunk: int = 0, *,
                 slots: int | None = None) -> None:
        if budget <= 0:
            raise ValueError("token budget must be positive")
        self.budget = int(budget)
        self.ladder = tuple(sorted(int(c) for c in ladder))
        if not self.ladder:
            raise ValueError("chunk ladder is empty")
        self.prefill_chunk = int(prefill_chunk)
        self.slots = slots  # batch size hint for the decode-light test
        self.dispatches: collections.Counter = collections.Counter()
        self.mini_dispatches = 0
        self.last_chunk = self.ladder[-1]
        self.last_segments = 0
        self.restore_debt = 0
        self.restores_charged = 0
        self.window_mode = False

    def charge_restore(self, tokens: int) -> None:
        """Debit ``tokens`` of restore copy work against upcoming
        dispatch budgets, capped at four budgets so a burst of restores
        throttles the next dispatches but never starves decode."""
        self.restore_debt = min(self.restore_debt + max(0, int(tokens)),
                                4 * self.budget)
        self.restores_charged += 1

    def plan(self, n_decodable: int, prefill_pending: bool = False
             ) -> tuple[int, int]:
        budget = self.budget
        if self.restore_debt:
            # at most half a budget a dispatch: decode keeps the ladder
            # floor's cadence while the debt drains
            paid = min(self.restore_debt, budget // 2)
            self.restore_debt -= paid
            budget -= paid
        pending = prefill_pending and self.prefill_chunk > 0
        if pending:
            floor = (self.ladder[-1] // 2) * max(1, n_decodable)
            decode_budget = max(budget - int(budget * self.prefill_share),
                                min(floor, budget))
        else:
            decode_budget = budget
        rows = max(1, n_decodable)
        size = self.ladder[0]
        for c in self.ladder:
            if c * rows <= decode_budget:
                size = c
        if not pending:
            self.last_segments = 0
            return size, 0
        light = self.slots is None or n_decodable <= max(1, self.slots // 4)
        spare = budget - size * n_decodable
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
            "prefill_share": self.prefill_share,
            "ladder": list(self.ladder),
            "last_chunk": self.last_chunk,
            "dispatches": {str(k): v for k, v in sorted(dispatches.items())},
            "mini_dispatches": self.mini_dispatches,
            "last_segments": self.last_segments,
            "restore_debt": self.restore_debt,
            "restores_charged": self.restores_charged,
        }


class AgingPriorityQueue:
    """Weighted ready queues with aging — the admission order policy.

    One FIFO deque per priority class. ``pop`` compares the HEAD of each
    class by effective priority ``class - waited / aging_s``: a request ages
    one class per ``aging_s`` seconds waited, so nothing starves. Items
    expose ``priority`` (class index) and ``enqueued_at``
    (``time.perf_counter`` seconds)."""

    def __init__(self, aging_s: float = 2.0) -> None:
        self.aging_s = max(1e-6, float(aging_s))
        self._queues: tuple[collections.deque, ...] = tuple(
            collections.deque() for _ in PRIORITIES)

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues)

    def push(self, item) -> None:
        self._queues[item.priority].append(item)

    def push_front(self, item) -> None:
        """Requeue ``item`` at the head of its class (a retry after
        transient back-pressure keeps its place)."""
        self._queues[item.priority].appendleft(item)

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
        return self._queues[best_class].popleft()

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
        return removed

    def drain(self) -> list:
        """Remove and return everything (close-flush path)."""
        out: list = []
        for q in self._queues:
            out.extend(q)
            q.clear()
        return out
