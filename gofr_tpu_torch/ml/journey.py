"""Request journeys — counterpart of ``gofr_tpu/ml/journey.py``: one
bounded timeline per request, keyed by a process-unique ``rid``.

Each mark closes the segment since the previous one (admit, the prefill
burst, each decode burst, finish), so a journey's marks tile its wall; any
remainder is an explicit ``other``. Retention is tail-sampled: a ring of
finished journeys (``GOFR_ML_JOURNEY`` sets its size, default 512; ``0``
turns journeys off and the call sites see None) plus an exemplar store
that keeps every failed journey and the p99-slowest successes.

Served at ``GET /debug/requests`` (per-mark percentiles, indexes) and
``GET /debug/requests/<rid>`` (the waterfall). Cross-linked with the
flight recorder: a dispatch record names the rids it served, and a
journey's prefill/decode marks carry the dispatch ``seq`` and the
in-flight depth. Under a replica pool (``ml/replica.py``) the FRONT owns
one journey per request: the cores mark into it (``route``, ``ship``,
``land``, a ``reject`` on a replica that failed the request, the
survivor's ``admit``), so a rerouted or two-stage request stays one
timeline. Stdlib only.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time

__all__ = ["Journey", "JourneyLog", "journey_log", "journeys_enabled",
           "next_rid", "seal", "FAILURE_REASONS"]

# finish reasons that mark a journey as FAILED (always retained as
# exemplars): the typed serving outcomes plus the catch-all "error".
# "cancelled" (consumer walked away) is not a serving failure.
FAILURE_REASONS = ("deadline", "shed", "crashed", "error")

# a journey's timeline is bounded: past this many marks, a repeat of the
# newest mark's name folds into it (durations/tokens sum, ``folded``
# counts the collapsed segments) instead of growing the record — a
# 100k-token stream stays a bounded waterfall, not an unbounded log
MAX_MARKS = 96

_rid_counter = itertools.count(1)


def next_rid() -> str:
    """Process-unique request id (``itertools.count`` is atomic under the
    GIL — no lock on the submit path)."""
    return f"r{next(_rid_counter)}"


def journeys_enabled() -> bool:
    """``GOFR_ML_JOURNEY`` (default on, ring 512): ``0`` disables journey
    recording entirely — the instrumented sites see ``None``."""
    return os.environ.get("GOFR_ML_JOURNEY", "").strip() != "0"


def _ring_size() -> int:
    raw = os.environ.get("GOFR_ML_JOURNEY", "").strip()
    try:
        n = int(raw) if raw else 512
    except ValueError:
        n = 512
    # "0" means DISABLED, not "tiny ring": the process-global log is
    # sized at import, and a later in-process enable (an A/B that
    # re-pins the knob) must find the default ring, not a 16-slot one
    return max(16, n) if n > 0 else 512


class Journey:
    """One request's lifecycle timeline.

    ``mark(name, **data)`` closes the elapsed segment since the previous
    mark and labels it ``name`` — the marks tile the wall from enqueue to
    finish, so they sum to it by construction. Marks happen at burst
    cadence (never per token) from the serving thread and, under a
    replica pool, the consumer's event loop; a tiny lock keeps a
    concurrent pool/core mark pair from double-counting a segment.
    """

    __slots__ = ("rid", "model", "trace_id", "t0", "marks", "finish_reason",
                 "wall_s", "done", "data", "_anchor", "_lock")

    def __init__(self, rid: str, *, model: str = "llm",
                 trace_id: str | None = None) -> None:
        self.rid = rid
        self.model = model
        self.trace_id = trace_id
        self.t0 = time.perf_counter()
        self._anchor = self.t0
        self.marks: list[dict] = []
        self.finish_reason: str | None = None
        self.wall_s: float | None = None
        self.done = False
        self.data: dict = {}  # request-level summary (spec counts, tokens)
        self._lock = threading.Lock()

    def mark(self, name: str, **data) -> None:
        """Attribute the segment since the previous mark to ``name``."""
        now = time.perf_counter()
        with self._lock:
            if self.done:
                return  # a straggler mark after finish: the record is sealed
            dt = max(0.0, now - self._anchor)
            self._anchor = now
            marks = self.marks
            if marks and marks[-1]["mark"] == name and len(marks) >= MAX_MARKS:
                # bounded record: fold the repeat into the newest mark —
                # durations and VOLUME counts (tokens/bytes) sum, ``folded``
                # says how many segments collapsed, and the tiling
                # invariant holds. Identity-like fields (the ``dispatch``
                # seq of the request↔dispatch pivot) take the NEWEST
                # value — summing seqs would point forensics at a
                # dispatch that never existed.
                last = marks[-1]
                last["dur_s"] += dt
                last["folded"] = last.get("folded", 0) + 1
                for k, v in data.items():
                    if (k in ("tokens", "bytes")
                            and isinstance(v, (int, float))
                            and isinstance(last.get(k), (int, float))):
                        last[k] += v
                    else:
                        last[k] = v
                return
            marks.append({"mark": name,
                          "t_s": round(now - self.t0, 6),
                          "dur_s": dt, **data})

    def note(self, **data) -> None:
        """Attach request-level summary data (no segment attribution)."""
        with self._lock:
            self.data.update(data)

    def count_mark(self, name: str) -> int:
        """How many times this timeline recorded ``name``, folded repeats
        included. A pool's failover accounting compares
        ``count_mark("admit")`` against the charges it already made, so a
        replica that started the request (its prefill is lost work) is
        told apart from one that only queued it."""
        with self._lock:
            return sum(1 + m.get("folded", 0)
                       for m in self.marks if m["mark"] == name)

    def finish(self, reason: str, error: str | None = None) -> bool:
        """Seal the journey: close the tail segment as ``finish`` (carrying
        the reason), stamp the wall, and record any honesty remainder as
        an explicit ``other`` mark. Idempotent — the first caller wins
        (a pool and its core may both reach for it); returns whether THIS
        call sealed it."""
        now = time.perf_counter()
        with self._lock:
            if self.done:
                return False
            dt = max(0.0, now - self._anchor)
            self._anchor = now
            m: dict = {"mark": "finish", "t_s": round(now - self.t0, 6),
                       "dur_s": dt, "reason": reason}
            if error:
                m["error"] = error[:300]
            self.marks.append(m)
            self.finish_reason = reason
            self.wall_s = now - self.t0
            # the tiling makes attributed == wall up to clock clamping;
            # any residue is recorded honestly rather than hand-waved
            gap = self.wall_s - sum(x["dur_s"] for x in self.marks)
            if gap > 1e-9:
                self.marks.append({"mark": "other",
                                   "t_s": round(now - self.t0, 6),
                                   "dur_s": gap})
            self.done = True
            return True

    @property
    def failed(self) -> bool:
        return self.finish_reason in FAILURE_REASONS

    def snapshot(self) -> dict:
        """The waterfall (the ``/debug/requests/<rid>`` body)."""
        with self._lock:
            marks = [dict(m) for m in self.marks]
            data = dict(self.data)
        for m in marks:
            # nanosecond precision: a ~100-mark waterfall's durations
            # must still SUM to the wall within noise (microsecond
            # rounding accumulates past the honesty bound)
            m["dur_s"] = round(m["dur_s"], 9)
        out = {
            "rid": self.rid,
            "model": self.model,
            "trace_id": self.trace_id,
            "done": self.done,
            "finish_reason": self.finish_reason,
            "wall_s": (round(self.wall_s, 6) if self.wall_s is not None
                       else round(time.perf_counter() - self.t0, 6)),
            "marks": marks,
        }
        if data:
            out["request"] = data
        return out


class JourneyLog:
    """Tail-sampled retention of finished journeys + the in-flight set.

    One process-global instance (like the fleet event log): every
    serving component records into the same store, so ``/debug/requests``
    answers for the whole fleet.
    """

    def __init__(self, capacity: int | None = None) -> None:
        cap = _ring_size() if capacity is None else max(16, int(capacity))
        self._lock = threading.Lock()
        self._active: dict[str, Journey] = {}
        self._recent: collections.OrderedDict[str, Journey] = \
            collections.OrderedDict()
        self._capacity = cap
        # exemplars outlive the ring: every failure, plus rolling
        # p99-slowest successes — bounded separately so churn can't
        # flush an incident's evidence
        self._exemplars: collections.OrderedDict[str, Journey] = \
            collections.OrderedDict()
        self._exemplar_cap = max(16, cap // 4)
        self._walls: collections.deque[float] = collections.deque(maxlen=256)
        self.started = 0
        self.finished = 0

    def start(self, journey: Journey) -> Journey:
        with self._lock:
            self._active[journey.rid] = journey
            self.started += 1
        return journey

    def finish(self, journey: Journey) -> None:
        """Move a sealed journey into retention (call after
        ``Journey.finish``). Tail-sampling happens here: failures and
        p99-slow journeys also pin into the exemplar store."""
        wall = journey.wall_s if journey.wall_s is not None else 0.0
        with self._lock:
            self._active.pop(journey.rid, None)
            self.finished += 1
            self._recent[journey.rid] = journey
            while len(self._recent) > self._capacity:
                self._recent.popitem(last=False)
            slow = (len(self._walls) >= 32
                    and wall >= self._p(sorted(self._walls), 0.99))
            self._walls.append(wall)
            if journey.failed or slow:
                self._exemplars[journey.rid] = journey
                while len(self._exemplars) > self._exemplar_cap:
                    self._exemplars.popitem(last=False)

    def get(self, rid: str) -> Journey | None:
        with self._lock:
            return (self._active.get(rid) or self._exemplars.get(rid)
                    or self._recent.get(rid))

    @staticmethod
    def _p(ordered: list[float], q: float) -> float:
        if not ordered:
            return float("nan")
        return ordered[min(len(ordered) - 1, int(q * len(ordered)))]

    def snapshot(self) -> dict:
        """The ``/debug/requests`` summary: wall and per-mark duration
        percentiles over the retained ring, finish-reason mix, and the
        rid indexes an operator pivots from."""
        with self._lock:
            recent = list(self._recent.values())
            active = [(j.rid, j.model) for j in self._active.values()]
            exemplars = list(self._exemplars.values())
            started, finished = self.started, self.finished
        walls: list[float] = []
        per_mark: dict[str, list[float]] = {}
        reasons: collections.Counter = collections.Counter()
        for j in recent:
            if j.wall_s is not None:
                walls.append(j.wall_s)
            reasons[j.finish_reason] += 1
            sums: dict[str, float] = {}
            for m in j.marks:
                sums[m["mark"]] = sums.get(m["mark"], 0.0) + m["dur_s"]
            for name, v in sums.items():
                per_mark.setdefault(name, []).append(v)

        def _pcts(vals: list[float]) -> dict:
            ordered = sorted(vals)
            return {"count": len(ordered),
                    "p50_ms": round(self._p(ordered, 0.5) * 1e3, 3),
                    "p95_ms": round(self._p(ordered, 0.95) * 1e3, 3),
                    "p99_ms": round(self._p(ordered, 0.99) * 1e3, 3)}

        return {
            "started": started,
            "finished": finished,
            "retained": len(recent),
            "active": len(active),
            "active_rids": [{"rid": r, "model": m} for r, m in active[:64]],
            "wall": _pcts(walls) if walls else None,
            "marks": {name: _pcts(vals)
                      for name, vals in sorted(per_mark.items())},
            "finish_reasons": dict(reasons),
            "exemplars": [{
                "rid": j.rid, "model": j.model,
                "finish_reason": j.finish_reason,
                "wall_ms": (round(j.wall_s * 1e3, 3)
                            if j.wall_s is not None else None),
                "failed": j.failed,
            } for j in exemplars],
            "recent_rids": [j.rid for j in recent[-64:]],
        }


def seal(journey: Journey | None, reason: str, error: str | None = None,
         *, log: JourneyLog | None = None, metrics=None) -> bool:
    """Seal a journey with its final outcome and move it into retention —
    the ONE sequence behind ``LLMServer`` and ``ReplicaPool`` (so the
    ``app_ml_journeys_total`` labeling cannot drift between them: the
    counter's ``model`` is the journey's OWN model — the pool name for a
    fleet request regardless of which core happened to seal it).
    Idempotent; returns whether THIS call sealed it."""
    if journey is None or not journey.finish(reason, error):
        return False
    if log is not None:
        log.finish(journey)
    if metrics is not None:
        try:
            metrics.add_counter("app_ml_journeys_total", 1,
                                model=journey.model, reason=reason)
        except Exception:
            pass  # bare managers in tests: recording stays optional
    return True


# the process-global instance every serving component shares — ONE
# journey store per process, like the fleet event log. Sized from
# GOFR_ML_JOURNEY at import; ``journey_log()`` answers None when the
# knob disables journeys, so call sites get the is-not-None guard free.
_JOURNEYS = JourneyLog()


def journey_log() -> JourneyLog | None:
    return _JOURNEYS if journeys_enabled() else None
