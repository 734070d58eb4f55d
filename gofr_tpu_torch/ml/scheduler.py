"""Host-side admission and dispatch policy — counterpart of the parts of
``gofr_tpu/ml/scheduler.py`` the dense serving path uses.

- ``normalize_priority`` and ``AgingPriorityQueue``: weighted priority
  classes (``high`` / ``normal`` / ``low``) with aging, the admission order
  of ``LLMServer``;
- ``TokenBudgetScheduler``: the per-dispatch planner a ``Generator``
  consults to pick a decode-ladder entry. The chunked-prefill half of its
  plan (segments per dispatch, restore and sequence-parallel debts) waits
  for chunked prefill (ROADMAP A.7); the speculative unit cost for
  speculation (A.10); ``SLOController`` for the front (A.6).

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
    """Per-dispatch planner: ``plan(n_decodable)`` is the largest ladder
    entry whose decode tokens (``size * n_decodable``) fit the budget,
    never below the ladder's first entry. ``dispatches`` counts the ladder
    entries planned; the Generator counts its TTFT mini-chunks, which are
    admission-driven rather than planned, in ``mini_dispatches``."""

    def __init__(self, budget: int, ladder) -> None:
        if budget <= 0:
            raise ValueError("token budget must be positive")
        self.budget = int(budget)
        self.ladder = tuple(sorted(int(c) for c in ladder))
        if not self.ladder:
            raise ValueError("chunk ladder is empty")
        self.dispatches: collections.Counter = collections.Counter()
        self.mini_dispatches = 0

    def plan(self, n_decodable: int) -> int:
        rows = max(1, n_decodable)
        size = self.ladder[0]
        for c in self.ladder:
            if c * rows <= self.budget:
                size = c
        self.dispatches[size] += 1
        return size


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
