"""Traffic capture: record the serving request plane for deterministic
replay — counterpart of ``gofr_tpu/ml/capture.py``.

Armed by ``GOFR_ML_CAPTURE`` (a ring size; unset or ``0`` constructs no
capture machinery and leaves the hot path as it is), every request a
serving front (``LLMServer`` or a ``ReplicaPool``, whose cores see the
front's rid and skip) admits records what a replay needs:

- the prompt **token ids**, taken at submit, before any radix split (the
  replayed request makes its own cache decisions);
- the **arrival offset** (monotonic, relative to the capture epoch;
  exports normalize it to the window's start);
- **priority**, **deadline**, the consumer **mode**, ``max_new`` and the
  generator's sampling parameters;
- at finish: the **output-token digest** (sha256 over the int32 burst
  stream, folded once a burst), the finish reason, TTFT/TPOT, and the
  journey **rid** it shares with ``/debug/requests/<rid>``.

The bundle header snapshots the **runtime fingerprint**: the port's own
(torch and CUDA versions, the card's name and count, every armed
``GOFR_ML_*`` knob), so replay (``ml/replay.py``) diffs it against the
live runtime and warns before claiming identity. A bundle written by the
JAX package carries JAX's fields and so always warns here. ``GET
/debug/capture`` serves the bundle in JAX's codec, byte for byte: one
``>I``-prefixed JSON header followed by each request's contiguous
little-endian int32 prompt ids; a bundle from either package decodes in
the other. Crash bundles embed the newest captured requests
(``CrashVault.capture(capture=...)``).

Host-side stdlib; ``torch`` is imported only by ``runtime_fingerprint``.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import struct
import threading
import time

__all__ = ["TrafficCapture", "CapturedRequest", "traffic_capture",
           "capture_enabled", "token_digest", "sampler_snapshot",
           "encode_bundle", "decode_bundle", "runtime_fingerprint",
           "fingerprint_drift", "BUNDLE_FORMAT", "DELIVERY_REASONS"]

# bundle schema tag (the header's ``format`` field): replay refuses
# bundles from a future incompatible writer instead of mis-parsing them
BUNDLE_FORMAT = "gofr-capture/1"

# finish reasons that mean the consumer received a COMPLETE answer —
# only these records carry a digest worth comparing for identity
# (a deadline/shed/crash/cancel leaves a partial, meaningless stream)
DELIVERY_REASONS = ("stop", "length", "eviction")


def capture_enabled() -> bool:
    """``GOFR_ML_CAPTURE`` (default OFF — capture holds prompt tokens in
    memory, so it is an explicit opt-in unlike the always-on recorders):
    a positive ring size arms it, unset/empty/``0`` disables."""
    return _ring_size() > 0


def _ring_size() -> int:
    raw = os.environ.get("GOFR_ML_CAPTURE", "").strip()
    if not raw:
        return 0
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"GOFR_ML_CAPTURE must be a ring size (requests), "
            f"got {raw!r}") from None
    if n < 0:
        raise ValueError(
            f"GOFR_ML_CAPTURE must be >= 0 (0 disables), got {raw!r}")
    return n


def token_digest(tokens) -> str:
    """Digest of a whole token sequence — the one hash both capture and
    replay speak (sha256 over little-endian int32, truncated hex)."""
    h = hashlib.sha256()
    toks = [int(t) for t in tokens]
    h.update(struct.pack(f"<{len(toks)}i", *toks))
    return h.hexdigest()[:16]


def sampler_snapshot(gen) -> dict | None:
    """The generator's sampling config as a plain dict (bundle rows are
    self-describing about HOW tokens were drawn — greedy replay identity
    only holds at temperature 0, and the verdict should say why not
    otherwise). Attribute reads only: works on any generator."""
    s = getattr(gen, "sampler", None)
    if s is None:
        return None
    out = {}
    for field in ("temperature", "top_k", "top_p"):
        v = getattr(s, field, None)
        if v is not None:
            out[field] = v
    return out or None


def runtime_fingerprint() -> dict:
    """The runtime this process serves on, as a capture bundle (and the
    ``runtime`` block of ``/debug/serving``) snapshots it: torch and CUDA
    versions, the card's name and count, and every armed ``GOFR_ML_*``
    knob. Replay diffs this dict against the bundle's copy: the same
    traffic on another runtime is a comparison, not a reproduction."""
    import torch

    out: dict = {
        "knobs": {k: v for k, v in sorted(os.environ.items())
                  if k.startswith("GOFR_ML_")},
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    if torch.cuda.is_available():
        out["devices"] = {"kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()}
    else:
        out["devices"] = {"kind": "cpu", "count": 1}
    return out


def fingerprint_drift(recorded: dict, current: dict,
                      ignore=()) -> list[str]:
    """Human-readable differences between a bundle's recorded runtime
    fingerprint and the live one — the lines replay warns with. Empty
    means the runtimes match on everything the fingerprint tracks.
    ``ignore`` names extra knobs whose differences are expected (a tuned
    profile's own knob map differs from the tuning run by design). The
    fields are the port's: a JAX bundle (``jax``, ``backend``, no
    ``torch``) drifts on every one of them."""
    drift: list[str] = []
    recorded = recorded or {}
    current = current or {}
    for field in ("torch", "cuda"):
        a, b = recorded.get(field), current.get(field)
        if a != b:
            drift.append(f"{field}: recorded {a!r}, now {b!r}")
    rd, cd = recorded.get("devices") or {}, current.get("devices") or {}
    for field in ("kind", "count"):
        if rd.get(field) != cd.get(field):
            drift.append(f"device {field}: recorded {rd.get(field)!r}, "
                         f"now {cd.get(field)!r}")
    rk, ck = recorded.get("knobs") or {}, current.get("knobs") or {}
    # the time machine's own knobs always differ between a capturing run
    # and a replaying one — that is the tool working, not the workload
    # drifting
    for name in sorted((set(rk) | set(ck))
                       - {"GOFR_ML_CAPTURE", "GOFR_ML_REPLAY_SPEED"}
                       - set(ignore)):
        if rk.get(name) != ck.get(name):
            drift.append(f"knob {name}: recorded {rk.get(name)!r}, "
                         f"now {ck.get(name)!r}")
    return drift


class CapturedRequest:
    """One admitted request's replayable record.

    The owning stream loop (one consumer) calls ``add_tokens`` per burst
    and ``finish`` once — the digest folds incrementally so a 100k-token
    stream costs one hash update per burst, never per token.
    """

    __slots__ = ("rid", "model", "t_offset_s", "tokens", "max_new",
                 "priority", "deadline_s", "mode", "sampler", "prefix",
                 "n_out", "finish_reason", "done", "ttft_s", "tpot_s",
                 "digest", "_hash", "_t_submit", "_t_first", "_t_last")

    def __init__(self, rid: str, *, model: str, tokens, max_new: int,
                 priority: int, deadline_s: float, mode: str,
                 sampler: dict | None, prefix: bool,
                 t_offset_s: float) -> None:
        self.rid = rid
        self.model = model
        self.t_offset_s = t_offset_s
        self.tokens = [int(t) for t in tokens]
        self.max_new = int(max_new)
        self.priority = int(priority)
        self.deadline_s = float(deadline_s)
        self.mode = mode
        self.sampler = sampler
        # an explicitly-passed prefix id references server state a bundle
        # cannot carry (the captured ids are the suffix only): flagged so
        # replay skips the record honestly instead of replaying half a
        # prompt. Framework radix splits happen AFTER this tap — those
        # records hold the full prompt and replay fine.
        self.prefix = bool(prefix)
        self.n_out = 0
        self.finish_reason: str | None = None
        self.done = False
        self.ttft_s: float | None = None
        self.tpot_s: float | None = None
        self.digest: str | None = None
        self._hash = hashlib.sha256()
        self._t_submit = time.perf_counter()
        self._t_first: float | None = None
        self._t_last: float | None = None

    def add_tokens(self, burst) -> None:
        """Fold one delivered burst into the digest (owner-thread only)."""
        now = time.perf_counter()
        if self._t_first is None:
            self._t_first = now
        self._t_last = now
        toks = [int(t) for t in burst]
        self._hash.update(struct.pack(f"<{len(toks)}i", *toks))
        self.n_out += len(toks)

    def finish(self, reason: str) -> str | None:
        """Seal the record with its outcome; returns the output digest
        (``None`` when nothing was delivered). Idempotent — the first
        caller wins, like ``Journey.finish``."""
        if self.done:
            return self.digest
        self.done = True
        self.finish_reason = reason
        if self._t_first is not None:
            self.ttft_s = self._t_first - self._t_submit
            if self.n_out > 1 and self._t_last is not None:
                self.tpot_s = ((self._t_last - self._t_first)
                               / (self.n_out - 1))
        if self.n_out:
            self.digest = self._hash.hexdigest()[:16]
        return self.digest

    def row(self) -> dict:
        """The JSON-able record (prompt ids included — the binary codec
        strips them into the payload section)."""
        out: dict = {
            "rid": self.rid,
            "model": self.model,
            "t_offset_s": round(self.t_offset_s, 6),
            "tokens": list(self.tokens),
            "max_new": self.max_new,
            "priority": self.priority,
            "deadline_s": self.deadline_s,
            "mode": self.mode,
            "prefix": self.prefix,
            "done": self.done,
            "finish_reason": self.finish_reason,
            "n_out": self.n_out,
            "digest": self.digest,
            "ttft_s": (round(self.ttft_s, 6)
                       if self.ttft_s is not None else None),
            "tpot_s": (round(self.tpot_s, 6)
                       if self.tpot_s is not None else None),
        }
        if self.sampler is not None:
            out["sampler"] = dict(self.sampler)
        return out


class TrafficCapture:
    """Bounded ring of captured requests, process-global like the event
    log: every serving front records into the same store, so ``GET
    /debug/capture`` exports the whole process's traffic window as one
    bundle."""

    def __init__(self, capacity: int | None = None) -> None:
        cap = _ring_size() if capacity is None else int(capacity)
        # honor the requested bound EXACTLY: capture holds prompt tokens
        # in memory, and an operator who asked for a 4-deep ring meant 4
        self._capacity = max(1, cap)
        self._lock = threading.Lock()
        self._requests: collections.OrderedDict[str, CapturedRequest] = \
            collections.OrderedDict()
        # the capture epoch: arrival offsets are monotonic seconds since
        # this instant (perf_counter — immune to wall-clock steps); the
        # wall twin stamps the bundle header for humans
        self.epoch = time.perf_counter()
        self.epoch_wall = time.time()
        self.captured = 0
        self.dropped = 0   # ring overwrites (oldest records lost)
        # fleet shape registry: serving fronts note their shape at
        # construction so the bundle header names what served the window
        self._fleet: dict[str, dict] = {}

    def note_model(self, name: str, **shape) -> None:
        with self._lock:
            self._fleet[name] = dict(shape)

    def forget_model(self, name: str) -> None:
        """Drop a fleet-block entry: a ``ReplicaPool`` unregisters its
        replica cores (they never own capture records; the pool's entry
        is the serving front the bundle names)."""
        with self._lock:
            self._fleet.pop(name, None)

    def admit(self, rid: str, *, model: str, tokens, max_new: int,
              priority: int, deadline_s: float, mode: str,
              sampler: dict | None = None,
              prefix: bool = False) -> CapturedRequest:
        """Record one admitted request; returns the record the owning
        stream loop feeds bursts into."""
        rec = CapturedRequest(
            rid, model=model, tokens=tokens, max_new=max_new,
            priority=priority, deadline_s=deadline_s, mode=mode,
            sampler=sampler, prefix=prefix,
            t_offset_s=time.perf_counter() - self.epoch)
        with self._lock:
            self.captured += 1
            self._requests[rid] = rec
            while len(self._requests) > self._capacity:
                self._requests.popitem(last=False)
                self.dropped += 1
        return rec

    def get(self, rid: str) -> CapturedRequest | None:
        with self._lock:
            return self._requests.get(rid)

    def clear(self) -> None:
        """Drop every record and restart the epoch (a new window in the
        same process)."""
        with self._lock:
            self._requests.clear()
            self.epoch = time.perf_counter()
            self.epoch_wall = time.time()

    def stats(self) -> dict:
        with self._lock:
            return {"capacity": self._capacity,
                    "retained": len(self._requests),
                    "captured": self.captured,
                    "dropped": self.dropped}

    def export(self, *, rid: str | None = None,
               newest: int | None = None) -> dict:
        """The JSON-able bundle: self-describing header (format, wall
        epoch, runtime fingerprint, fleet shape, counts) + the request
        records, oldest first. Arrival offsets are NORMALIZED to the
        window start, so replaying an export never sleeps through the
        process uptime that preceded the window. ``rid=`` exports one
        request; ``newest=`` the newest N (the crash-bundle tail)."""
        with self._lock:
            recs = list(self._requests.values())
            fleet = dict(self._fleet)
            stats = {"capacity": self._capacity, "captured": self.captured,
                     "dropped": self.dropped}
        if rid is not None:
            recs = [r for r in recs if r.rid == rid]
        recs.sort(key=lambda r: r.t_offset_s)
        if newest is not None:
            recs = recs[-max(0, int(newest)):]
        rows = [r.row() for r in recs]
        base = min((r["t_offset_s"] for r in rows), default=0.0)
        for r in rows:
            r["t_offset_s"] = round(r["t_offset_s"] - base, 6)
        return {
            "format": BUNDLE_FORMAT,
            "captured_at": round(self.epoch_wall + base, 3),
            "runtime": runtime_fingerprint(),
            "fleet": fleet,
            "counts": {**stats, "exported": len(rows)},
            "requests": rows,
        }

    def encode(self, *, rid: str | None = None,
               newest: int | None = None) -> bytes:
        return encode_bundle(self.export(rid=rid, newest=newest))


# -- wire codec (JAX's bytes) -------------------------------------------------

def encode_bundle(bundle: dict) -> bytes:
    """Pack an exported bundle into one raw-bytes blob: a ``>I``
    length-prefixed JSON header followed by each request's contiguous
    little-endian int32 prompt ids in header order (no base64, a
    byte-exact round trip). The header's request rows carry ``n_tokens``
    instead of the id lists."""
    header = {k: v for k, v in bundle.items() if k != "requests"}
    rows = []
    payloads = []
    for r in bundle.get("requests", []):
        toks = [int(t) for t in r.get("tokens", ())]
        rows.append({**{k: v for k, v in r.items() if k != "tokens"},
                     "n_tokens": len(toks)})
        payloads.append(struct.pack(f"<{len(toks)}i", *toks))
    header["requests"] = rows
    hraw = json.dumps(header).encode()
    return b"".join([struct.pack(">I", len(hraw)), hraw, *payloads])


def decode_bundle(raw: bytes) -> dict:
    """Inverse of ``encode_bundle``: the JSON-able bundle with each
    request's token ids rebuilt from the payload section."""
    if len(raw) < 4:
        raise ValueError("truncated capture bundle (no header length)")
    (hlen,) = struct.unpack(">I", raw[:4])
    try:
        header = json.loads(raw[4:4 + hlen])
    except ValueError as exc:
        raise ValueError(f"corrupt capture bundle header: {exc}") from None
    if header.get("format") != BUNDLE_FORMAT:
        raise ValueError(
            f"unsupported capture bundle format {header.get('format')!r} "
            f"(this reader speaks {BUNDLE_FORMAT})")
    off = 4 + hlen
    for r in header.get("requests", []):
        n = int(r.pop("n_tokens", 0))
        nbytes = 4 * n
        if off + nbytes > len(raw):
            raise ValueError("truncated capture bundle payload")
        r["tokens"] = list(struct.unpack(f"<{n}i", raw[off:off + nbytes]))
        off += nbytes
    return header


# the process-global instance every serving front shares — created
# lazily on the first ENABLED access so its ring is sized by the
# GOFR_ML_CAPTURE value that armed it
_CAPTURE: TrafficCapture | None = None
_CAPTURE_LOCK = threading.Lock()


def traffic_capture() -> TrafficCapture | None:
    """The process-global capture, or ``None`` when ``GOFR_ML_CAPTURE``
    is unset/0 — call sites get the is-not-None guard free, and a
    disabled process never constructs the machinery at all. Re-arming
    the knob with a DIFFERENT ring size starts a fresh store (a kept old
    ring would ignore the new bound and leak the previous window's
    records into the next bundle); servers built before the re-arm keep
    writing their old handle, so re-size between boots, not under live
    traffic."""
    if not capture_enabled():
        return None
    global _CAPTURE
    size = max(1, _ring_size())
    with _CAPTURE_LOCK:
        if _CAPTURE is None or _CAPTURE._capacity != size:
            _CAPTURE = TrafficCapture(size)
        return _CAPTURE
