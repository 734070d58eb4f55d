"""Serving flight recorder — counterpart of ``gofr_tpu/flight_recorder.py``:
stall attribution, fleet events, crash forensics and the auto-profiler.

- ``DispatchRecorder`` — per-dispatch stall attribution. The serving
  thread stamps phase durations (queue pop, scheduler decide, batch
  assemble, launch, the device-to-host copy's issue, device wait, emit) as
  it works; every device dispatch commits one record into a bounded ring
  with the unattributed remainder as ``other``, so a record's phases sum to
  its wall. Rolling shares feed the ``stalls`` block of ``/debug/serving``
  and ``app_llm_dispatch_phase_seconds{phase}``; ``top_stall`` names the
  top host-side phase. The device-idle estimate is the JAX package's: a
  settle that blocked on a dispatch launched onto an empty device times
  the device's work a step, and every settle then credits its estimated
  busy seconds. ``GOFR_ML_FLIGHT_RECORDER=0`` turns it off (the call sites
  guard on ``is not None``). Everything it does per dispatch is host-side
  and O(1): no synchronisation and no event query beyond what the dispatch
  already does.
- ``EventLog`` — one process-global bounded ring (``GOFR_ML_EVENT_RING``,
  default 2048) of typed serving events (admit, shed, deadline, spill,
  restore, evict, crash, recover, dead, drain, profile) with a monotonic
  cursor, read by ``GET /debug/events?since=``.
- ``CrashVault`` — the watchdog's forensics bundles (trigger event, last
  events, scheduler and pool state, the in-flight slot table, the victims'
  journeys, the newest dispatch records), served at ``/debug/crash/<id>``.
- ``AutoProfiler`` + ``ProfileVault`` — a rolling baseline over the
  recorder's step wall and phase shares; a regression (step p50 past
  ``GOFR_ML_AUTOPROF_MULT`` x baseline, or a host phase's share jumping
  by more than 25 points) starts one bounded ``torch.profiler`` capture
  (CPU and CUDA activities, a Chrome trace zipped by ``zip_dir_bytes``) on
  a background thread into an 8-deep vault (``/debug/profile/auto``).
  ``GOFR_ML_AUTOPROF_COOLDOWN_S`` bounds the rate, ``GOFR_ML_AUTOPROF=0``
  turns it off.

``PROFILE_LOCK`` makes the profiler one capture at a time, process-wide:
the manual ``/debug/profile``, the auto-profiler and any measurement that
runs ``torch.profiler`` in the same process take it. An auto-capture that
finds it held is skipped and counted (``skipped_busy``). ``LAUNCH_GATE``
keeps the profiler's start and stop apart from device work on other
threads: a serving pass holds it shared, a start or stop exclusively.

Everything but the capture itself is stdlib; ``torch`` is imported only
inside ``_capture_profile_trace``.
"""

from __future__ import annotations

import collections
import contextlib
import io
import os
import shutil
import tempfile
import threading
import time
import zipfile

__all__ = ["PHASES", "DispatchRecorder", "EventLog", "CrashVault",
           "AutoProfiler", "ProfileVault", "PROFILE_LOCK", "LAUNCH_GATE",
           "event_log", "crash_vault", "profile_vault",
           "recorder_enabled", "autoprof_enabled", "zip_dir_bytes"]

# the profiler is process-global state: ONE capture at a time, ever —
# shared by the manual /debug/profile endpoint, the auto-profiler and any
# in-process measurement, so none corrupts another's trace
PROFILE_LOCK = threading.Lock()


class _LaunchGate:
    """Serving passes against profiler transitions. Starting or stopping
    the profiler while another thread launches a CUDA graph can deadlock
    the process (CUPTI's flush in ``_disable_profiler`` against
    ``CUDAGraph.replay``, seen on an H100 under load). A serving thread
    holds the gate shared for each pass (``serving``), a profiler start or
    stop exclusively (``exclusive``); a waiting transition holds back new
    passes, so it gets in between two. Uncontended, a pass pays two lock
    round trips on the host."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._passes = 0
        self._exclusive = False
        self._waiting = 0

    @contextlib.contextmanager
    def serving(self):
        with self._cond:
            while self._exclusive or self._waiting:
                self._cond.wait()
            self._passes += 1
        try:
            yield
        finally:
            with self._cond:
                self._passes -= 1
                if not self._passes:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        with self._cond:
            self._waiting += 1
            while self._passes or self._exclusive:
                self._cond.wait()
            self._waiting -= 1
            self._exclusive = True
        try:
            yield
        finally:
            with self._cond:
                self._exclusive = False
                self._cond.notify_all()


LAUNCH_GATE = _LaunchGate()

# the dispatch-phase taxonomy (the label set of
# app_llm_dispatch_phase_seconds), the JAX package's. One serving thread
# stamps queue_pop, decide, assemble, launch (a graph replay or a
# prefill, chunked-prefill segments included), d2h_issue (enqueueing the
# token block's copy to pinned host memory), device_wait (the blocking
# read of it) and emit. ``route``, ``ship``, ``land`` and ``sp_prefill``
# belong to the fleet and sequence-parallel serving (ROADMAP A.14, A.11)
# and stay unstamped until those are ported. ``other`` is the honest
# remainder: wall time of a dispatch pass no
# instrumented site claimed (host bookkeeping loops, GC, OS scheduling).
PHASES = ("queue_pop", "decide", "assemble", "sp_prefill", "launch",
          "d2h_issue", "device_wait", "emit", "route", "ship", "land",
          "other")
# phases that burn HOST time; ``device_wait`` is the one phase where the
# host is merely blocked on device compute, so it never names a stall
_HOST_PHASES = tuple(p for p in PHASES if p != "device_wait")


def recorder_enabled() -> bool:
    """``GOFR_ML_FLIGHT_RECORDER`` (default on): 0 disables the dispatch
    recorder."""
    return os.environ.get("GOFR_ML_FLIGHT_RECORDER", "1").strip() != "0"


class DispatchRecorder:
    """Per-dispatch phase breakdown for one serving core.

    The serving thread calls ``note(phase, seconds)`` as it works and
    ``commit()`` once per device dispatch; ``reset()`` discards a pure
    idle pass (an idle server's poll wait is not a stall of any
    dispatch). ``snapshot()`` is safe from any thread.
    """

    def __init__(self, *, model: str = "llm", metrics=None,
                 ring: int = 256) -> None:
        self.model = model
        self._metrics = metrics
        self._ring: collections.deque[dict] = collections.deque(maxlen=ring)
        # guards the ring and lifetime totals only — note() is
        # serving-thread-private and takes no lock at all
        self._lock = threading.Lock()
        self._pending: dict[str, float] = {}
        self._pending_rids: list[str] = []  # rids served this pass
        # fused-decode-window dim of the current pass: (planned K,
        # realized steps, windows settled) — stamped by the generator's
        # processing pass so the committed record describes the window(s)
        # whose tokens it drained
        self._pending_window: tuple[int, int, int] | None = None
        # overlap dim of the current pass: the in-flight depth its
        # dispatch launched on top of (2 = double-buffered under
        # GOFR_ML_PIPELINE — per-dispatch phases no longer tile the wall)
        self._pending_overlap = 0
        # device-idle estimate state: settles credit estimated
        # device-busy seconds to the pass; blocking settles whose
        # dispatch launched onto an EMPTY device calibrate an EMA of
        # device seconds per planned step (their launch→settle span IS
        # the execution time — the device started at launch and the host
        # blocked until it finished)
        self._pending_busy = 0.0
        self._pending_settled = 0
        self._exec_ema: float | None = None  # device s per planned step
        self._anchor: float | None = None  # pass start (perf_counter)
        self.dispatches = 0
        self.totals = dict.fromkeys(PHASES, 0.0)  # lifetime seconds
        # optional per-commit observer (the auto-profiler's feed): called
        # with (wall_s, phases) after each committed record. None costs
        # one attribute test — the GOFR_ML_AUTOPROF=0 contract.
        self.observer = None

    @property
    def pending(self) -> bool:
        return bool(self._pending)

    @property
    def pending_total(self) -> float:
        """Seconds already attributed in the current pass — callers timing
        a COMPOSITE section (e.g. the admission wave, whose internal drain
        notes device_wait/emit itself) subtract the delta so nested notes
        are never double-counted against the section's own phase."""
        return sum(self._pending.values())

    @property
    def pending_device_work(self) -> bool:
        """True when the current pass actually touched the device (a
        dispatch, a blocking read-back, or token emission) — the gate for
        the serve loop's tail-flush commit, so idle passes that merely
        glanced at an empty queue never pollute the dispatch ring."""
        return any(k in self._pending
                   for k in ("launch", "d2h_issue", "device_wait", "emit",
                             "ship", "land"))

    def note(self, phase: str, seconds: float) -> None:
        """Attribute ``seconds`` of the current pass to ``phase``.
        Serving-thread only; one dict update, no lock."""
        self._pending[phase] = self._pending.get(phase, 0.0) + seconds

    def note_rid(self, rid: str) -> None:
        """Tag the current pass with a request id it served (burst
        delivery): the committed record carries the rid set, so forensics
        can pivot dispatch→requests (journeys carry the other direction).
        Serving-thread only, like ``note``."""
        self._pending_rids.append(rid)

    def note_window(self, k: int, realized: int) -> None:
        """Tag the current pass with a fused decode window it drained:
        ``k`` planned device steps, ``realized`` steps the early-exit
        masks actually ran. A pass can settle MORE than one window (the
        double-buffered pipeline drains both at a barrier), so calls
        accumulate into the committed record. Serving-thread only, like
        ``note``."""
        if self._pending_window is None:
            self._pending_window = (int(k), int(realized), 1)
        else:
            k0, r0, n0 = self._pending_window
            self._pending_window = (k0 + int(k), r0 + int(realized), n0 + 1)

    def note_overlap(self, depth: int) -> None:
        """Tag the current pass with the in-flight depth its dispatch
        launched on top of (1 = the classic lag-one pipeline, 2 =
        double-buffered under GOFR_ML_PIPELINE). The committed record
        keeps the max over the pass. Serving-thread only, like ``note``."""
        if depth > self._pending_overlap:
            self._pending_overlap = depth

    def note_settle(self, span_s: float, depth0: int, steps: int,
                    wait_s: float) -> None:
        """One in-flight dispatch settled: ``span_s`` seconds from its
        launch to now, ``depth0`` dispatches already outstanding when it
        launched, ``steps`` planned device positions, ``wait_s`` the
        blocking read-back tail just measured. Feeds the device-idle
        estimate: a settle that actually BLOCKED on a dispatch launched
        onto an empty device pins the execution time exactly (span =
        device run time), calibrating an EMA of device seconds per
        planned step; every settle then credits min(span, max(wait,
        ema*steps)) estimated device-busy seconds to the current pass.
        Serving-thread only, like ``note``."""
        if wait_s > 1e-6 and depth0 == 0:
            per = span_s / max(1, steps)
            self._exec_ema = (per if self._exec_ema is None
                              else 0.8 * self._exec_ema + 0.2 * per)
        est = (wait_s if self._exec_ema is None
               else max(wait_s, self._exec_ema * max(1, steps)))
        self._pending_busy += min(span_s, est)
        self._pending_settled += 1

    def reset(self) -> None:
        """Drop the current pass unrecorded (idle poll: no dispatch to
        attribute the wait to) and re-anchor the wall clock."""
        self._pending.clear()
        self._pending_rids.clear()
        self._pending_window = None
        self._pending_overlap = 0
        self._pending_busy = 0.0
        self._pending_settled = 0
        self._anchor = time.perf_counter()

    def commit(self) -> None:
        """Close one dispatch record: phases noted since the last
        commit/reset plus the unattributed remainder as ``other``, so a
        record's phases always sum to its wall time."""
        now = time.perf_counter()
        attributed = sum(self._pending.values())
        wall = (now - self._anchor if self._anchor is not None
                else attributed)
        phases = dict(self._pending)
        phases["other"] = max(0.0, wall - attributed)
        rec = {"wall_s": wall, "phases": phases}
        if self._pending_rids:
            # stable de-dup (a slot may burst twice in one pass): the
            # record names every request this dispatch served
            rec["rids"] = list(dict.fromkeys(self._pending_rids))
            self._pending_rids.clear()
        if self._pending_window is not None:
            k, realized, n = self._pending_window
            rec["window"] = {"k": k, "realized": realized, "n": n}
            self._pending_window = None
        if self._pending_overlap:
            rec["overlap"] = self._pending_overlap
            self._pending_overlap = 0
        if self._pending_settled:
            # estimated device-busy seconds the settles of this pass
            # vouch for — the device-idle share's numerator. Clipped at
            # wall so a span that began in an earlier pass (the
            # double-buffered lag) can never claim more than this record
            rec["busy_s"] = min(self._pending_busy, wall)
            self._pending_busy = 0.0
            self._pending_settled = 0
        with self._lock:
            self.dispatches += 1
            rec["seq"] = self.dispatches  # the journey marks' pivot key
            self._ring.append(rec)
            for name, v in phases.items():
                self.totals[name] = self.totals.get(name, 0.0) + v
        self._pending.clear()
        self._anchor = now
        obs = self.observer
        if obs is not None:
            try:
                obs(wall, phases)
            except Exception:
                pass  # a broken observer must never fail a dispatch
        m = self._metrics
        if m is not None:
            try:
                for name, v in phases.items():
                    if v > 0.0:
                        m.record_histogram("app_llm_dispatch_phase_seconds",
                                           v, model=self.model, phase=name)
            except Exception:
                pass  # bare managers in tests: recording stays optional

    def tail(self, n: int = 16) -> list[dict]:
        """The newest ``n`` raw dispatch records (seq, wall, phases, and
        the rids served) — crash bundles carry these so a postmortem can
        pivot the victims' journeys onto the exact dispatches that ran
        them. Safe from any thread."""
        with self._lock:
            records = list(self._ring)[-max(0, n):]
        return [{**r, "wall_s": round(r["wall_s"], 6),
                 "phases": {k: round(v, 6)
                            for k, v in r["phases"].items()}}
                for r in records]

    def snapshot(self) -> dict:
        """The ``stalls`` block of ``/debug/serving``: rolling per-phase
        seconds and share-of-wall over the ring, the top host-side phase
        by share, and how much of the wall the instrumented phases (i.e.
        everything but ``other``) actually explained."""
        with self._lock:
            records = list(self._ring)
            dispatches = self.dispatches
            totals = {name: round(v, 6)
                      for name, v in self.totals.items() if v > 0.0}
        wall = sum(r["wall_s"] for r in records)
        sums: dict[str, float] = {}
        for r in records:
            for name, v in r["phases"].items():
                sums[name] = sums.get(name, 0.0) + v
        phases = {
            name: {"s": round(v, 6),
                   "share": round(v / wall, 4) if wall > 0 else 0.0}
            for name, v in sorted(sums.items(), key=lambda kv: -kv[1])
        }
        host = {n: v for n, v in sums.items() if n in _HOST_PHASES}
        top = max(host, key=host.get) if host and wall > 0 else None
        attributed = sum(v for n, v in sums.items() if n != "other")
        # fused-window dim over the ring: how many dispatches were window
        # launches, the planned K vs what the early-exit masks realized —
        # named decode_window because "window" above is the ROLLING ring
        # window of this snapshot, a different thing entirely
        win_recs = [r["window"] for r in records if "window" in r]
        decode_window = None
        if win_recs:
            planned = sum(w["k"] for w in win_recs)
            realized = sum(w["realized"] for w in win_recs)
            n_windows = sum(w.get("n", 1) for w in win_recs)
            decode_window = {
                "windows": n_windows,
                "mean_k": round(planned / n_windows, 2),
                "mean_realized": round(realized / n_windows, 2),
                "realized_share": (round(realized / planned, 4)
                                   if planned else None),
            }
        # device-idle estimate over the ring: the settles' estimated
        # device-busy seconds (launch→settle spans, calibrated by
        # blocking settles) against the wall — the share of the serving
        # thread's wall during which the device had nothing to chew on.
        # An ESTIMATE: prefill dispatches aren't credited, so it reads
        # high on admission-heavy windows; the pipeline A/B compares
        # like against like
        busy = sum(r.get("busy_s", 0.0) for r in records)
        overlapped = sum(1 for r in records if r.get("overlap", 0) >= 2)
        return {
            "dispatches": dispatches,
            "window": {
                "records": len(records),
                "wall_s": round(wall, 6),
                "per_dispatch_ms": (round(wall / len(records) * 1e3, 3)
                                    if records else None),
                "phases": phases,
            },
            "top_stall": top,
            "decode_window": decode_window,
            "device_idle_share": (round(max(0.0, 1.0 - busy / wall), 4)
                                  if wall > 0 and busy > 0.0 else None),
            "overlapped_dispatches": overlapped,
            "attributed_share": (round(attributed / wall, 4)
                                 if wall > 0 else None),
            # lifetime per-phase seconds: the ring answers "what's slow
            # NOW", this answers "where has the wall gone since boot"
            "totals_s": totals,
        }


class EventLog:
    """Bounded ring of typed serving events with a monotonic cursor.

    The port emits the single server's kinds: admit, shed, deadline,
    spill, restore, evict, crash, recover, dead, drain and profile.
    """

    def __init__(self, capacity: int | None = None) -> None:
        if capacity is None:
            raw = os.environ.get("GOFR_ML_EVENT_RING", "").strip()
            try:
                capacity = int(raw) if raw else 2048
            except ValueError:
                capacity = 2048
        self._buf: collections.deque[dict] = collections.deque(
            maxlen=max(16, capacity))
        self._lock = threading.Lock()
        self._seq = 0
        # events silently overwritten by ring churn: consumers polling
        # with since= need to know their cursor gapped (the ``dropped``
        # field of /debug/events + app_ml_events_dropped_total)
        self.dropped = 0

    @property
    def cursor(self) -> int:
        """Seq of the newest event (pass it back as ``since=``)."""
        with self._lock:
            return self._seq

    def emit(self, kind: str, model: str | None = None, **data) -> dict:
        """Append one event; returns the stored record (its ``seq`` is
        the cursor callers quote, e.g. a crash bundle's trigger)."""
        with self._lock:
            self._seq += 1
            rec = {"seq": self._seq, "ts": round(time.time(), 6),
                   "kind": kind, "model": model, **data}
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1  # the append below overwrites the oldest
            self._buf.append(rec)
            return rec

    @staticmethod
    def _model_match(ev_model: str | None, want: str) -> bool:
        # "chat" also matches its replica cores "chat/0", "chat/1", …
        return (ev_model == want
                or (ev_model is not None and ev_model.startswith(want + "/")))

    def query(self, since: int = 0, *, model: str | None = None,
              kind=None, rid: str | None = None,
              limit: int = 256) -> dict:
        """Events with ``seq > since`` (oldest first), optionally filtered
        by model (a pool name matches its replica cores too), kind (one
        name or any collection of names — the multi-value ``kind=`` of
        /debug/events), and rid (the request-journey id stamped on
        admit/shed/deadline/route/failover/kv_ship/kv_land events).
        ``cursor`` is what the next poll passes as ``since=``: past the
        whole ring normally, or the last returned event when ``limit``
        truncated the page (so pagination never skips events).
        ``dropped`` counts events the ring has overwritten since boot —
        a consumer whose poll cadence lost to churn sees it move."""
        with self._lock:
            events = [e for e in self._buf if e["seq"] > since]
            cursor = self._seq
            dropped = self.dropped
        if model is not None:
            events = [e for e in events
                      if self._model_match(e.get("model"), model)]
        if kind is not None:
            kinds = {kind} if isinstance(kind, str) else set(kind)
            events = [e for e in events if e["kind"] in kinds]
        if rid is not None:
            events = [e for e in events if e.get("rid") == rid]
        truncated = len(events) > max(1, limit)
        if truncated:
            events = events[:max(1, limit)]
            cursor = events[-1]["seq"]
        return {"cursor": cursor, "truncated": truncated,
                "dropped": dropped, "events": events}

    def tail(self, n: int = 128) -> list[dict]:
        """Newest ``n`` events, oldest first (crash-bundle context)."""
        with self._lock:
            return list(self._buf)[-max(0, n):]


class CrashVault:
    """Bounded in-memory store of crash bundles, keyed by id."""

    def __init__(self, capacity: int = 8) -> None:
        self._bundles: collections.OrderedDict[str, dict] = \
            collections.OrderedDict()
        self._capacity = max(1, capacity)
        self._lock = threading.Lock()
        self._n = 0

    def capture(self, *, model: str, trigger: dict, state: dict,
                events: list[dict], capture: dict | None = None) -> str:
        """Store one bundle; returns its id (``/debug/crash/<id>``).
        Oldest bundles roll off past the capacity — postmortems read the
        bundle soon after the incident, not weeks later. ``capture`` is
        a traffic-capture tail; it lands under ``state.capture``
        (capture is ROADMAP A.16: the port passes None)."""
        with self._lock:
            self._n += 1
            # replica core names carry a slash ("chat/0") that would split
            # the URL path — flatten it for the id, keep it in the body
            crash_id = f"{model.replace('/', '-')}-{self._n}"
            if capture is not None:
                state = {**state, "capture": capture}
            self._bundles[crash_id] = {
                "id": crash_id,
                "at": round(time.time(), 6),
                "model": model,
                "trigger": trigger,
                "state": state,
                "events": events,
            }
            while len(self._bundles) > self._capacity:
                self._bundles.popitem(last=False)
            return crash_id

    def get(self, crash_id: str) -> dict | None:
        with self._lock:
            return self._bundles.get(crash_id)

    def list(self) -> list[dict]:
        """Summaries, oldest first (full bundles via ``get``)."""
        with self._lock:
            return [{"id": b["id"], "at": b["at"], "model": b["model"],
                     "error": b["trigger"].get("error")}
                    for b in self._bundles.values()]


def autoprof_enabled() -> bool:
    """``GOFR_ML_AUTOPROF`` (default on): 0 disables the auto-profiler —
    the recorder's ``observer`` stays ``None`` and commits do zero extra
    work (same contract as ``GOFR_ML_FLIGHT_RECORDER``)."""
    return os.environ.get("GOFR_ML_AUTOPROF", "").strip() != "0"


def _env_float(name: str, default: float, *, minimum: float,
               maximum: float = float("inf")) -> float:
    """Loudly-validated float env knob: a malformed threshold fails
    the boot instead of silently profiling never (or constantly)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = float(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}") from None
    if not minimum <= value <= maximum:  # NaN fails both compares
        raise ValueError(
            f"{name} must be in [{minimum:g}, {maximum:g}], got {raw!r}")
    return value


def zip_dir_bytes(root: str,
                  max_bytes: int | None = None) -> tuple[bytes, bool]:
    """Zip a directory tree into memory, stopping once the archive would
    exceed ``max_bytes`` (profiler traces can be large; a bounded vault
    must never eat the heap). Returns ``(data, truncated)``."""
    buf = io.BytesIO()
    truncated = False
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for base, _, files in os.walk(root):
            for fname in sorted(files):
                full = os.path.join(base, fname)
                if max_bytes is not None:
                    try:
                        size = os.path.getsize(full)
                    except OSError:
                        continue
                    # guard BEFORE deflating: one giant trace file must
                    # not blow the heap the cap exists to bound (deflate
                    # compresses, so raw size is a conservative bound)
                    if buf.tell() + size > max_bytes:
                        truncated = True
                        continue
                zf.write(full, os.path.relpath(full, root))
    return buf.getvalue(), truncated


def _capture_profile_trace(trace_dir: str, seconds: float) -> None:
    """Blocking profiler capture of ``seconds`` (the CPU activity, and the
    card's kernels when there is one: CUPTI records every kernel of the
    process, graph replays included), written as a Chrome trace into
    ``trace_dir``. The kineto result is saved as the profiler returns it,
    without ``torch.profiler``'s event parsing: at Llama-3-8B decode a
    second of graph replays is ~170k kernel events, and parsing them costs
    seconds of host time a second captured. Run off the serving thread;
    callers hold ``PROFILE_LOCK``. Module-level so tests can replace it."""
    import torch
    from torch.autograd import profiler as autograd_profiler

    prof = autograd_profiler.profile(
        use_device="cuda" if torch.cuda.is_available() else None,
        use_kineto=True)
    with LAUNCH_GATE.exclusive():
        prof.__enter__()
    try:
        time.sleep(seconds)
    finally:
        with LAUNCH_GATE.exclusive():
            result = autograd_profiler._disable_profiler()
    result.save(os.path.join(trace_dir, "trace.json"))


class ProfileVault:
    """Bounded in-memory store of auto-captured profile bundles, keyed
    by id — the CrashVault pattern applied to profiler trace zips."""

    def __init__(self, capacity: int = 8) -> None:
        self._bundles: collections.OrderedDict[str, dict] = \
            collections.OrderedDict()
        self._capacity = max(1, capacity)
        self._lock = threading.Lock()
        self._n = 0

    def capture(self, *, model: str, trigger: dict, data: bytes,
                truncated: bool = False) -> str:
        with self._lock:
            self._n += 1
            profile_id = f"{model.replace('/', '-')}-{self._n}"
            self._bundles[profile_id] = {
                "id": profile_id,
                "at": round(time.time(), 6),
                "model": model,
                "trigger": trigger,
                "bytes": len(data),
                "truncated": truncated,
                "data": data,
            }
            while len(self._bundles) > self._capacity:
                self._bundles.popitem(last=False)
            return profile_id

    def get(self, profile_id: str) -> dict | None:
        with self._lock:
            return self._bundles.get(profile_id)

    def list(self) -> list[dict]:
        """Summaries (no trace bytes), oldest first."""
        with self._lock:
            return [{k: v for k, v in b.items() if k != "data"}
                    for b in self._bundles.values()]


class AutoProfiler:
    """Anomaly-triggered profiling over one serving core's dispatches.

    Installed as the core's ``DispatchRecorder.observer``: every commit
    feeds ``observe(wall_s, phases)``. Dispatches accumulate in a short
    window; when it fills, its step-wall p50 and host-phase shares are
    compared against a rolling baseline of earlier windows. A regression
    — p50 ≥ ``multiplier`` × baseline p50, or a host phase's share of
    wall jumping by more than ``share_jump`` — spawns ONE background
    capture (``torch.profiler``, ``capture_s`` seconds, zipped and
    size-capped into the process-global :class:`ProfileVault`), emits a
    ``profile`` fleet event, and starts the cooldown. Everything on the
    serving thread is deque appends and, once per window, two small
    sorts — the capture itself never runs there.
    """

    def __init__(self, *, model: str = "llm", vault: "ProfileVault | None"
                 = None, events: "EventLog | None" = None,
                 multiplier: float | None = None,
                 cooldown_s: float | None = None,
                 capture_s: float | None = None,
                 share_jump: float = 0.25,
                 window: int = 16, baseline: int = 128,
                 min_baseline: int = 64,
                 max_bytes: int = 32 * 1024 * 1024,
                 capture_fn=None) -> None:
        self.model = model
        self._vault = vault if vault is not None else profile_vault()
        self._events = events if events is not None else event_log()
        self.multiplier = (_env_float("GOFR_ML_AUTOPROF_MULT", 2.0,
                                      minimum=1.01)
                           if multiplier is None else float(multiplier))
        self.cooldown_s = (_env_float("GOFR_ML_AUTOPROF_COOLDOWN_S", 120.0,
                                      minimum=0.0)
                           if cooldown_s is None else float(cooldown_s))
        self.capture_s = (_env_float("GOFR_ML_AUTOPROF_SECONDS", 1.0,
                                     minimum=0.05, maximum=30.0)
                          if capture_s is None else float(capture_s))
        self.share_jump = float(share_jump)
        self._win: list[tuple[float, dict]] = []
        self._win_n = max(4, int(window))
        # baseline of (wall, phases) records from PAST windows only — the
        # window under judgment never pollutes its own reference. The
        # serving thread extends it; /debug/serving snapshots read it —
        # the lock keeps a concurrent extend from crashing the iteration
        self._base_lock = threading.Lock()
        self._base: collections.deque[tuple[float, dict]] = \
            collections.deque(maxlen=max(self._win_n * 2, int(baseline)))
        self._min_baseline = max(self._win_n, int(min_baseline))
        self._max_bytes = int(max_bytes)
        self._capture_fn = (capture_fn if capture_fn is not None
                            else _capture_profile_trace)
        self._cooldown_until = 0.0
        self.dispatches = 0
        self.captures = 0
        self.failures = 0
        self.skipped_busy = 0  # trigger lost the profiler lock (manual
        # capture in flight): counted, cooldown still consumed
        self.last_trigger: dict | None = None

    # -- serving-thread side -------------------------------------------------
    def observe(self, wall_s: float, phases: dict) -> None:
        self.dispatches += 1
        self._win.append((wall_s, phases))
        if len(self._win) < self._win_n:
            return
        window, self._win = self._win, []
        with self._base_lock:
            base = list(self._base)
        trigger = self._judge(window, base) if len(base) >= \
            self._min_baseline else None
        with self._base_lock:
            self._base.extend(window)
        if trigger is not None:
            self._trigger(trigger)

    @staticmethod
    def _p50(walls: list[float]) -> float:
        ordered = sorted(walls)
        return ordered[len(ordered) // 2]

    @staticmethod
    def _shares(records) -> dict[str, float]:
        wall = sum(w for w, _ in records)
        if wall <= 0:
            return {}
        sums: dict[str, float] = {}
        for _, phases in records:
            for name, v in phases.items():
                sums[name] = sums.get(name, 0.0) + v
        return {name: v / wall for name, v in sums.items()
                if name in _HOST_PHASES}

    def _judge(self, window, base) -> dict | None:
        """Compare the just-filled window against a baseline copy; a
        dict describing the regression, or None."""
        now = time.monotonic()
        if now < self._cooldown_until:
            return None
        base_p50 = self._p50([w for w, _ in base])
        win_p50 = self._p50([w for w, _ in window])
        if base_p50 > 0 and win_p50 >= self.multiplier * base_p50:
            return {"reason": "step_ms_p50",
                    "step_ms": round(win_p50 * 1e3, 3),
                    "baseline_ms": round(base_p50 * 1e3, 3),
                    "multiplier": self.multiplier}
        base_shares = self._shares(base)
        for name, share in self._shares(window).items():
            ref = base_shares.get(name, 0.0)
            if share - ref > self.share_jump:
                return {"reason": "phase_share", "phase": name,
                        "share": round(share, 4),
                        "baseline_share": round(ref, 4),
                        "jump_points": self.share_jump}
        return None

    def _trigger(self, trigger: dict) -> None:
        """Start ONE bounded background capture; the cooldown begins now
        (capture time included), so a sustained regression produces one
        trace per cooldown window, not a trace storm."""
        self._cooldown_until = (time.monotonic() + self.cooldown_s
                                + self.capture_s)
        self.last_trigger = {**trigger, "at": round(time.time(), 3)}
        if not PROFILE_LOCK.acquire(blocking=False):
            # a manual /debug/profile capture (or another core's auto
            # capture) owns the process-global profiler right now
            self.skipped_busy += 1
            return
        try:
            t = threading.Thread(target=self._capture, args=(trigger,),
                                 daemon=True,
                                 name=f"gofr-autoprof-{self.model}")
            t.start()
        except BaseException:
            # a failed thread start (resource pressure — exactly when
            # regressions fire) must not leak the process-global
            # profiler lock: the manual endpoint would 409 forever
            PROFILE_LOCK.release()
            self.failures += 1

    # -- background capture thread ------------------------------------------
    def _capture(self, trigger: dict) -> None:
        try:
            trace_dir = tempfile.mkdtemp(prefix="gofr-autoprof-")
            try:
                self._capture_fn(trace_dir, self.capture_s)
                data, truncated = zip_dir_bytes(trace_dir, self._max_bytes)
            finally:
                shutil.rmtree(trace_dir, ignore_errors=True)
            profile_id = self._vault.capture(
                model=self.model, trigger=dict(self.last_trigger or trigger),
                data=data, truncated=truncated)
            self.captures += 1
            self._events.emit("profile", model=self.model,
                              profile_id=profile_id,
                              bytes=len(data), **trigger)
        except Exception:
            self.failures += 1
        finally:
            PROFILE_LOCK.release()

    def snapshot(self) -> dict:
        """The ``autoprof`` block of ``/debug/serving``. Safe from any
        thread (baseline copied under its lock)."""
        with self._base_lock:
            base = [w for w, _ in self._base]
        return {
            "dispatches": self.dispatches,
            "captures": self.captures,
            "failures": self.failures,
            "skipped_busy": self.skipped_busy,
            "multiplier": self.multiplier,
            "cooldown_s": self.cooldown_s,
            "capture_s": self.capture_s,
            "baseline_ms": (round(self._p50(base) * 1e3, 3)
                            if len(base) >= self._min_baseline else None),
            "cooling_down": time.monotonic() < self._cooldown_until,
            "last_trigger": self.last_trigger,
        }


# the process-global instances every serving component shares — ONE fleet
# event stream, ONE crash vault, and ONE profile vault per process, like
# the metrics registry
_EVENTS = EventLog()
_CRASHES = CrashVault()
_PROFILES = ProfileVault()


def event_log() -> EventLog:
    return _EVENTS


def crash_vault() -> CrashVault:
    return _CRASHES


def profile_vault() -> ProfileVault:
    return _PROFILES
