"""KV transport: move whole-prefix KV pages between serving replicas —
counterpart of ``gofr_tpu/ml/kv_transport.py``.

Disaggregated serving puts prefill and decode on different replicas so a
prompt burst stops taking decode's token budget: a prefill replica
computes a prefix's KV pages once and ships them; a decode replica
restores them and prefills only the suffix.

The handoff rides two halves the port already has:

- a prefill replica computes a prefix's pages (``Generator.register_prefix``,
  in chunked segments for a prefix longer than any prefill bucket) and
  spills them card → host as settled PINNED tensors
  (``drop_prefix(spill=True)`` through ``kv_offload.HostKVStore``), bit
  for bit at bf16/f32, int8 and int4 pages;
- a decode replica restores such slabs with one copy to the card and an
  in-place write into pool pages (``Generator.restore_prefix``), charges
  the restore to its token-budget scheduler, and admits the request
  suffix-only — with a full-prefill fallback when anything goes missing.

``KVTransport`` connects them:

- **In-process** (the replica pool's layout): ``ship`` takes the spilled
  entry out of the source replica's host store (``HostKVStore.take``) and
  lands it in the destination's store (``LLMServer.import_prefix_kv`` →
  ``HostKVStore.receive`` plus a radix-trie adoption, so the next matching
  prompt restores it at admission). The host tensors move **by
  reference**.
- **Cross-host**: ``encode_entry`` / ``decode_entry`` pack the slabs into
  one raw-bytes blob — a ``>I`` header length, a JSON header (key, meta,
  each array's name, dtype NAME and shape), then the arrays' contiguous
  bytes — that rides ``ml/multihost.py``'s binary frame (``send_bytes``).
  The bytes are the JAX package's exactly (dtype names ``bfloat16``,
  ``float32``, ``int8``, ``uint8``), and the paged slab layout is JAX's,
  so a frame either package writes lands in the other. ``ship_bytes`` /
  ``land_bytes`` are the socket-facing halves of ``ship``.

The same machinery carries **live KV migration** for elastic scale events
(``migrate``): a draining replica's hot radix subtrees leave through
``export_resident_prefix`` (spill + take, no recompute) and land on
survivors like a disaggregated ship, under a balanced ledger (ships ==
adoptions + failures).

Failure semantics are JAX's: any export or land failure — an armed
``ship``/``land`` fault, a dead replica, an over-budget entry, a pool too
tight to register — makes ``ship`` return ``None`` and the caller routes
the request for a FULL prefill on a decode replica; every such fallback
counts in ``failures``.

Observability: ``app_ml_kv_transport_ships_total`` /
``app_ml_kv_transport_lands_total`` / ``app_ml_kv_transport_bytes``,
``app_ml_kv_migrations_total{outcome}``, typed ``kv_ship`` / ``kv_land`` /
``migrate`` events in the fleet event log, ``ship`` / ``land`` phases in
the dispatch flight recorder, ``ml.kv_ship`` / ``ml.kv_land`` spans (the
wire header carries the W3C ``traceparent``, so both ends of a socket
share one trace) and ``ship`` / ``land`` journey marks.
"""

from __future__ import annotations

import json
import struct
import threading
from typing import Any

import warnings

import torch

from ..flight_recorder import event_log
from ..tracing import format_traceparent, parse_traceparent

__all__ = ["KVTransport", "encode_entry", "decode_entry",
           "encode_entry_shards"]

# reserved meta key carrying the W3C traceparent across the wire: it
# rides the entry's JSON header (the one structured field both hosts
# parse) and is popped back out before the meta reaches the host store
_TRACE_KEY = "_traceparent"
# reserved meta key flagging a cross-host MIGRATION (elastic scale
# event) so the receiving host's land_bytes closes the migration ledger
# there: sender ships == receiver adoptions + failures, fleet-wide
_MIGRATE_KEY = "_migration"
# reserved meta key marking one SHARD of a sequence-parallel ship:
# ``[shard_idx, n_shards]``. A sequence-parallel prefill worker's KV is
# page-striped across its devices, so the wire moves it as n_shards
# page-sliced frames (each settles as its device's D2H finishes —
# pipelining instead of one monolithic blob); the receiving host
# reassembles the page axis in shard order before landing
# (_pending_shards), so the store only ever sees whole entries.
# ``ship_bytes_sharded`` is the sender (a replica whose generator runs an
# SP plan ships ``sp_stats()["shards"]`` frames), ``land_bytes`` the
# receiver.
_SHARD_KEY = "_sp_shard"


# -- wire codec (cross-host: rides multihost.send_bytes) ----------------------

def _dtype_name(t: torch.Tensor) -> str:
    """A tensor's dtype by NAME (``bfloat16``, ``int8``, ...), as numpy
    and ``ml_dtypes`` name it in the JAX package's headers."""
    return str(t.dtype).removeprefix("torch.")


def _raw_bytes(t: torch.Tensor) -> bytes:
    """A tensor's contiguous bytes in memory order."""
    t = t.detach().to("cpu").contiguous().reshape(-1)
    return t.view(torch.uint8).numpy().tobytes()


def encode_entry(key, arrays: dict, meta: dict) -> bytes:
    """Pack one host-tier entry — ``(key, {name: tensor}, meta)`` — into a
    single raw-bytes blob: a length-prefixed JSON header (key, meta, array
    names / dtype names / shapes) followed by each array's contiguous
    bytes in header order. The values round-trip bit for bit at any KV
    precision (bf16/f32, int8, packed int4 with its scale and zero
    planes): raw buffer bytes, no re-quantization, no base64."""
    names = list(arrays)
    header = {
        "key": [int(t) for t in key],
        "meta": meta,
        "arrays": [{"name": n, "dtype": _dtype_name(arrays[n]),
                    "shape": list(arrays[n].shape)} for n in names],
    }
    hraw = json.dumps(header).encode()
    parts = [struct.pack(">I", len(hraw)), hraw]
    parts.extend(_raw_bytes(arrays[n]) for n in names)
    return b"".join(parts)


def _dtype_by_name(name: str) -> torch.dtype:
    """``torch.dtype`` from a dtype NAME; an unknown name raises."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r} in a KV frame")
    return dtype


def encode_entry_shards(key, arrays: dict, meta: dict,
                        n_shards: int) -> list[bytes]:
    """Pack one host-tier entry as ``n_shards`` page-sliced frames — the
    per-shard wire format of a sequence-parallel ship. Every slab plane
    is page-major ([L, n_pages, ...]), so slicing axis 1 into contiguous
    ranges cuts the entry exactly along the prefill worker's device
    striping; frame ``i`` carries ``meta[_SHARD_KEY] = [i, n]``. With
    ``n_shards <= 1`` (or fewer pages than shards) this degrades to the
    single ``encode_entry`` frame."""
    n_pg = min((a.shape[1] for a in arrays.values()), default=0)
    n = max(1, int(n_shards))
    if n <= 1 or n_pg < n:
        return [encode_entry(key, arrays, meta)]
    bounds = [round(i * n_pg / n) for i in range(n + 1)]
    frames = []
    for i in range(n):
        lo, hi = bounds[i], bounds[i + 1]
        frames.append(encode_entry(
            key, {name: a[:, lo:hi] for name, a in arrays.items()},
            {**meta, _SHARD_KEY: [i, n]}))
    return frames


def decode_entry(raw: bytes) -> tuple[tuple, dict, dict]:
    """Inverse of ``encode_entry``: ``(key, arrays, meta)`` with each
    tensor rebuilt over the blob's buffer (``torch.frombuffer``, no copy;
    the tensors are read-only views of ``raw``)."""
    (hlen,) = struct.unpack(">I", raw[:4])
    header = json.loads(raw[4:4 + hlen])
    arrays: dict = {}
    off = 4 + hlen
    for spec in header["arrays"]:
        dtype = _dtype_by_name(spec["dtype"])
        shape = tuple(int(d) for d in spec["shape"])
        count = 1
        for d in shape:
            count *= d
        nbytes = count * torch.empty((), dtype=dtype).element_size()
        if off + nbytes > len(raw):
            raise ValueError("truncated KV frame")
        if count == 0:
            arrays[spec["name"]] = torch.empty(shape, dtype=dtype)
        else:
            with warnings.catch_warnings():
                # bytes are immutable: the views are never written
                warnings.simplefilter("ignore", UserWarning)
                arrays[spec["name"]] = torch.frombuffer(
                    raw, dtype=dtype, count=count, offset=off).reshape(shape)
        off += nbytes
    return tuple(header["key"]), arrays, header["meta"]


def _owned_host(t: torch.Tensor) -> torch.Tensor:
    """A copy of a frame's view that outlives the frame: pinned when a
    card exists, so the restore's copy to the card does not block."""
    out = torch.empty(t.shape, dtype=t.dtype,
                      pin_memory=torch.cuda.is_available())
    out.copy_(t)
    return out


class KVTransport:
    """Whole-prefix KV page movement between replicas.

    One instance per replica pool (constructed ONLY when disaggregated
    mode is on — ``GOFR_ML_DISAGG`` unset never builds one). Thread-safe:
    ``ship`` is called from per-request worker threads; counters are
    lock-guarded and the heavy lifting runs on the source/destination
    replicas' own serving threads (``export_prefix_kv`` /
    ``import_prefix_kv``)."""

    def __init__(self, *, name: str = "llm", metrics=None,
                 tracer=None, pending_cap: int = 8) -> None:
        if pending_cap < 1:
            raise ValueError(
                f"pending_cap must be at least 1, got {pending_cap}")
        self.name = name
        self._metrics = metrics
        self._tracer = tracer   # ml.kv_ship / ml.kv_land spans
        self._events = event_log()
        self._lock = threading.Lock()
        self.ships = 0          # entries successfully exported (pages left
        self.lands = 0          # the prefill replica) / landed decode-side
        self.failures = 0       # handoffs that fell back to full prefill
        self.bytes_moved = 0    # payload bytes of successful ships
        # live-KV-migration ledger (elastic scale events, ml/replica.py):
        # every entry that left a draining replica ("ships") either
        # landed on a survivor ("adoptions") or is an accounted failure
        # ("failures") — ships == adoptions + failures, always. Exports
        # that never left (nothing migratable, spill rejected) are
        # "skipped": the survivor cold-starts that prefix, honestly.
        self.migrations = {"ships": 0, "adoptions": 0, "failures": 0,
                           "skipped": 0, "bytes": 0}
        # sequence-parallel per-shard reassembly (land_bytes): frames of
        # one sharded ship accumulate here, keyed by the prefix key,
        # until every shard arrived — only whole entries ever land.
        # BOUNDED: a sender dying mid-ship would otherwise pin its
        # partial frames (full host copies) forever; past the cap the
        # oldest incomplete set is dropped (counted, and the receiver
        # full-prefills that prefix like any other lost handoff)
        self._pending_shards: dict = {}
        self._pending_cap = int(pending_cap)
        self.sp_shard_frames = 0   # per-shard frames sent + received
        self.sp_shards_dropped = 0  # incomplete sets evicted at the cap

    def _span(self, name: str, parent, **attrs):
        """One transport-hop span (None without a tracer). ``activate``
        stays off: ship/land run on worker and serving threads whose
        next work item must not inherit this span."""
        if self._tracer is None:
            return None
        return self._tracer.start_span(
            name, parent=parent, activate=False,
            kind="PRODUCER" if name == "ml.kv_ship" else "CONSUMER",
            attributes={"ml.model": self.name, **attrs})

    @staticmethod
    def _end(span, error: str | None = None) -> None:
        if span is None:
            return
        if error is not None:
            span.set_status("ERROR", error)
        span.end()

    def _rid_extra(self, rid, span, parent) -> dict:
        """Event fields linking a handoff to its request and trace."""
        extra: dict = {}
        if rid is not None:
            extra["rid"] = rid
        ctx = span.context if span is not None else parent
        if ctx is not None:
            extra["trace"] = ctx.trace_id
        return extra

    # -- in-process handoff (the replica pool's path) ------------------------
    def ship(self, src: Any, dst: Any, prefix_ids,
             timeout_s: float = 120.0, *, journey=None, rid=None,
             parent=None, shards: int = 0) -> tuple | None:
        """Compute ``prefix_ids``'s KV on the ``src`` serving core
        (prefill replica), spill it through the host tier, and land the
        settled pages in ``dst``'s host tier + radix trie (decode
        replica). Returns the landed key, or ``None`` on ANY failure —
        the caller falls back to a full prefill; nothing is ever left
        half-landed (a lost entry just re-prefills). ``journey``/``rid``
        stamp the request's timeline and the fleet events; ``parent`` is
        the request's span context, so the ship/land spans ride its
        trace."""
        span = self._span("ml.kv_ship", parent, **(
            {"ml.rid": rid} if rid is not None else {}))
        try:
            entry = src.export_prefix_kv(prefix_ids, timeout_s)
        except Exception:
            entry = None
        if entry is None:
            with self._lock:
                self.failures += 1
            self._end(span, "export failed")
            return None
        key, arrays, meta = entry
        nbytes = sum(int(a.nbytes) for a in arrays.values())
        with self._lock:
            self.ships += 1
            self.bytes_moved += nbytes
        self._count("app_ml_kv_transport_ships_total", 1)
        self._count("app_ml_kv_transport_bytes", nbytes)
        # ``shards``: the source was a sequence-parallel prefill worker —
        # the pages left its devices as that many stripes (in-process the
        # handoff stays one zero-copy reference; the wire path moves real
        # per-shard frames via ship_bytes_sharded)
        sp_extra = {"sp_shards": shards} if shards else {}
        self._events.emit("kv_ship", model=self.name, tokens=len(key),
                          bytes=nbytes, **sp_extra,
                          **self._rid_extra(rid, span, parent))
        if journey is not None:
            journey.mark("ship", bytes=nbytes, tokens=len(key), **sp_extra)
        if span is not None:
            span.set_attributes({"ml.bytes": nbytes, "ml.tokens": len(key)})
        self._end(span)
        return self._land(dst, key, arrays, meta, timeout_s,
                          journey=journey, rid=rid,
                          parent=span.context if span is not None else parent)

    def _land(self, dst: Any, key: tuple, arrays: dict, meta: dict,
              timeout_s: float, *, journey=None, rid=None,
              parent=None) -> tuple | None:
        nbytes = sum(int(a.nbytes) for a in arrays.values())
        span = self._span("ml.kv_land", parent, **(
            {"ml.rid": rid} if rid is not None else {}))
        try:
            ok = dst.import_prefix_kv(key, arrays, meta, timeout_s)
        except Exception:
            ok = False
        if not ok:
            with self._lock:
                self.failures += 1
            self._end(span, "land failed")
            return None
        with self._lock:
            self.lands += 1
        self._count("app_ml_kv_transport_lands_total", 1)
        self._events.emit("kv_land", model=self.name, tokens=len(key),
                          bytes=nbytes,
                          **self._rid_extra(rid, span, parent))
        if journey is not None:
            journey.mark("land", bytes=nbytes, tokens=len(key))
        if span is not None:
            span.set_attributes({"ml.bytes": nbytes, "ml.tokens": len(key)})
        self._end(span)
        return key

    # -- live KV migration (elastic scale events, ml/replica.py) -------------
    def migrate(self, src: Any, dst: Any, prefix_ids,
                pid: int | None = None, timeout_s: float = 30.0, *,
                src_idx: int | None = None,
                dst_idx: int | None = None) -> str:
        """Move KV a draining replica ALREADY HOLDS to a survivor: take
        the registered (or already-offloaded) entry out of ``src``
        without recomputing it (``LLMServer.export_resident_prefix``) and
        land it in ``dst``'s host tier + radix trie exactly like a disagg
        ship. Returns the outcome — ``"adopted"`` (the survivor holds the
        pages), ``"failed"`` (they left the source and were lost on the
        way), or ``"skipped"`` (nothing migratable left the source). The
        ledger
        is the acceptance contract of a scale event: every export that
        left the source is a ship, and ships == adoptions + failures —
        a lost migration is ACCOUNTED (the prefix cold-starts on the
        survivor, bit-identically), never silent. Outcomes also publish
        as ``app_ml_kv_migrations_total{outcome=adopted|failed|skipped}``
        and one ``migrate`` fleet event per attempt that left the
        source."""
        span = self._span("ml.kv_ship", None, **(
            {"ml.migration": True}))
        try:
            entry = src.export_resident_prefix(prefix_ids, pid, timeout_s)
        except Exception:
            entry = None
        if entry is None:
            with self._lock:
                self.migrations["skipped"] += 1
            self._count_outcome("skipped")
            self._end(span, "nothing migratable")
            return "skipped"
        key, arrays, meta = entry
        nbytes = sum(int(a.nbytes) for a in arrays.values())
        with self._lock:
            self.migrations["ships"] += 1
            self.migrations["bytes"] += nbytes
        try:
            ok = dst.import_prefix_kv(key, arrays, meta, timeout_s)
        except Exception:
            ok = False
        outcome = "adopted" if ok else "failed"
        with self._lock:
            self.migrations["adoptions" if ok else "failures"] += 1
        self._count_outcome(outcome)
        self._events.emit("migrate", model=self.name, tokens=len(key),
                          bytes=nbytes, outcome=outcome,
                          **({"from_replica": src_idx}
                             if src_idx is not None else {}),
                          **({"to_replica": dst_idx}
                             if dst_idx is not None else {}))
        if span is not None:
            span.set_attributes({"ml.bytes": nbytes,
                                 "ml.tokens": len(key)})
        self._end(span, None if ok else "land failed")
        return outcome

    def migrate_bytes(self, src: Any, prefix_ids,
                      pid: int | None = None,
                      timeout_s: float = 30.0) -> bytes | None:
        """Cross-host sender half of a migration: export resident KV off
        a draining replica and encode it for the wire (pair with
        ``multihost.send_bytes``; the receiving host lands it with the
        ordinary ``land_bytes``, whose success/failure closes the ledger
        there: sender ships == receiver adoptions + failures,
        fleet-wide). ``None`` when nothing migratable left the source
        (counted ``skipped``)."""
        try:
            entry = src.export_resident_prefix(prefix_ids, pid, timeout_s)
        except Exception:
            entry = None
        if entry is None:
            with self._lock:
                self.migrations["skipped"] += 1
            self._count_outcome("skipped")
            return None
        key, arrays, meta = entry
        raw = encode_entry(key, arrays, {**meta, _MIGRATE_KEY: True})
        with self._lock:
            self.migrations["ships"] += 1
            self.migrations["bytes"] += len(raw)
        self._events.emit("migrate", model=self.name, tokens=len(key),
                          bytes=len(raw), outcome="shipped_bytes")
        return raw

    def account_lost_migration(self, n: int = 1) -> None:
        """Sender-side failure accounting for ``migrate_bytes`` frames
        that never reached a peer (the wire write failed, the link was
        partitioned). The export already counted a ship, but no receiver
        will ever count the adoption or failure — without this entry the
        fleet-wide ships == adoptions + failures ledger can never close."""
        if n <= 0:
            return
        with self._lock:
            self.migrations["failures"] += n
        for _ in range(n):
            self._count_outcome("failed")
        self._events.emit("migrate", model=self.name, outcome="lost_frame",
                          count=n)

    @staticmethod
    def _header_says_migration(raw: bytes) -> bool:
        """Best-effort peek at a frame's JSON header for the migration
        marker — used when the full decode failed, so every parse step
        may itself fail (then the frame is unattributable and only the
        generic failure counter moves)."""
        try:
            (hlen,) = struct.unpack(">I", raw[:4])
            header = json.loads(raw[4:4 + hlen])
            return bool(header.get("meta", {}).get(_MIGRATE_KEY))
        except Exception:
            return False

    def _count_outcome(self, outcome: str) -> None:
        if self._metrics is None:
            return
        try:
            self._metrics.add_counter("app_ml_kv_migrations_total", 1,
                                      model=self.name, outcome=outcome)
        except Exception:
            pass

    # -- cross-host halves (ride multihost.send_bytes) -----------------------
    def ship_bytes(self, src: Any, prefix_ids,
                   timeout_s: float = 120.0, *, journey=None, rid=None,
                   parent=None) -> bytes | None:
        """Export from ``src`` and encode for the wire (the sender half of
        a cross-host ship; pair with ``multihost.send_bytes``). The
        encoded header carries the ship span's W3C ``traceparent``, so
        the receiving host's ``land_bytes`` continues the SAME trace."""
        span = self._span("ml.kv_ship", parent, **(
            {"ml.rid": rid} if rid is not None else {}))
        try:
            entry = src.export_prefix_kv(prefix_ids, timeout_s)
        except Exception:
            entry = None
        if entry is None:
            with self._lock:
                self.failures += 1
            self._end(span, "export failed")
            return None
        key, arrays, meta = entry
        ctx = span.context if span is not None else parent
        if ctx is not None:
            # the wire carries the trace context INSIDE the entry header:
            # binary frames have no side channel, and this is exactly the
            # gap that made cross-host handoffs fall out of their traces
            meta = {**meta, _TRACE_KEY: format_traceparent(ctx)}
        raw = encode_entry(key, arrays, meta)
        with self._lock:
            self.ships += 1
            self.bytes_moved += len(raw)
        self._count("app_ml_kv_transport_ships_total", 1)
        self._count("app_ml_kv_transport_bytes", len(raw))
        self._events.emit("kv_ship", model=self.name, tokens=len(key),
                          bytes=len(raw),
                          **self._rid_extra(rid, span, parent))
        if journey is not None:
            journey.mark("ship", bytes=len(raw), tokens=len(key))
        if span is not None:
            span.set_attributes({"ml.bytes": len(raw),
                                 "ml.tokens": len(key)})
        self._end(span)
        return raw

    def ship_bytes_sharded(self, src: Any, prefix_ids, shards: int,
                           timeout_s: float = 120.0, *, journey=None,
                           rid=None, parent=None) -> list[bytes] | None:
        """Cross-host sender half of a SEQUENCE-PARALLEL ship: export
        once, encode as ``shards`` page-sliced frames (each one device's
        stripe of the prefill worker's pool). Send every frame through
        ``multihost.send_bytes``; the receiving host feeds each to
        ``land_bytes``, which reassembles and lands the whole entry when
        the last shard arrives. One ship in the counters regardless of
        the frame count (the shard frames have their own tally)."""
        span = self._span("ml.kv_ship", parent, **(
            {"ml.rid": rid} if rid is not None else {}))
        try:
            entry = src.export_prefix_kv(prefix_ids, timeout_s)
        except Exception:
            entry = None
        if entry is None:
            with self._lock:
                self.failures += 1
            self._end(span, "export failed")
            return None
        key, arrays, meta = entry
        ctx = span.context if span is not None else parent
        if ctx is not None:
            meta = {**meta, _TRACE_KEY: format_traceparent(ctx)}
        frames = encode_entry_shards(key, arrays, meta, shards)
        total = sum(len(f) for f in frames)
        with self._lock:
            self.ships += 1
            self.bytes_moved += total
            self.sp_shard_frames += len(frames)
        self._count("app_ml_kv_transport_ships_total", 1)
        self._count("app_ml_kv_transport_bytes", total)
        self._events.emit("kv_ship", model=self.name, tokens=len(key),
                          bytes=total, sp_shards=len(frames),
                          **self._rid_extra(rid, span, parent))
        if journey is not None:
            journey.mark("ship", bytes=total, tokens=len(key),
                         sp_shards=len(frames))
        if span is not None:
            span.set_attributes({"ml.bytes": total, "ml.tokens": len(key),
                                 "ml.sp_shards": len(frames)})
        self._end(span)
        return frames

    def land_bytes(self, dst: Any, raw: bytes,
                   timeout_s: float = 30.0, *, journey=None,
                   rid=None) -> tuple | None:
        """Decode a received binary frame and land it in ``dst`` (the
        receiver half of a cross-host ship). A corrupt or truncated
        frame counts as a failure and returns ``None`` — the receiver
        falls back like every other lost handoff, it never crashes. The
        frame header's ``traceparent`` (stamped by ``ship_bytes`` on the
        sending host) parents this side's ``ml.kv_land`` span, so both
        halves of the handoff share one trace id."""
        try:
            key, arrays, meta = decode_entry(raw)
            # frombuffer views are read-only over the frame, and the
            # store may outlive it: own the bytes
            arrays = {n: _owned_host(a) for n, a in arrays.items()}
        except Exception:
            with self._lock:
                self.failures += 1
            if self._header_says_migration(raw):
                # the payload was truncated/corrupt but the header still
                # names this frame a migration: account the failure so
                # the fleet-wide ledger (sender ships == receiver
                # adoptions + failures) holds for the common
                # lost-payload case
                with self._lock:
                    self.migrations["failures"] += 1
                self._count_outcome("failed")
            return None
        shard = meta.pop(_SHARD_KEY, None)
        if shard is not None:
            # one stripe of a sequence-parallel ship: park it until the
            # set completes, then land the reassembled entry whole. A
            # shard set that never completes (sender died mid-ship) just
            # ages here — the receiver falls back to full prefill like
            # every other lost handoff, and a fresh ship of the same key
            # restarts the set (idx collisions overwrite, harmlessly).
            idx, total = int(shard[0]), int(shard[1])
            with self._lock:
                self.sp_shard_frames += 1
                pend = self._pending_shards.setdefault(
                    key, {"total": total, "parts": {}, "meta": None})
                if pend["total"] != total:  # a restarted set wins
                    pend = {"total": total, "parts": {}, "meta": None}
                    self._pending_shards[key] = pend
                pend["parts"][idx] = arrays
                if idx == 0 or pend["meta"] is None:
                    pend["meta"] = dict(meta)
                # LRU by PROGRESS, not first arrival: re-inserting moves
                # the key to the end of the dict, so the eviction below
                # always hits the set that has gone longest without a
                # frame — a live, actively-filling set under >cap
                # concurrent sharded ships is never the victim
                self._pending_shards[key] = self._pending_shards.pop(key)
                if len(pend["parts"]) < total:
                    while len(self._pending_shards) > self._pending_cap:
                        oldest = next(k for k in self._pending_shards
                                      if k != key)
                        del self._pending_shards[oldest]
                        self.sp_shards_dropped += 1
                    return None  # waiting on the rest of the set
                del self._pending_shards[key]
            parts = pend["parts"]
            arrays = {
                name: torch.cat(
                    [parts[i][name] for i in range(total)], dim=1)
                for name in parts[0]
            }
            meta = pend["meta"]
        parent = parse_traceparent(meta.pop(_TRACE_KEY, None))
        migration = bool(meta.pop(_MIGRATE_KEY, False))
        landed = self._land(dst, key, arrays, meta, timeout_s,
                            journey=journey, rid=rid, parent=parent)
        if migration:
            # this frame was a cross-host MIGRATION (elastic scale
            # event): close the migration ledger on THIS side — the
            # sender counted the ship, adoption/failure lands here
            ok = landed is not None
            with self._lock:
                self.migrations["adoptions" if ok else "failures"] += 1
            self._count_outcome("adopted" if ok else "failed")
            self._events.emit("migrate", model=self.name,
                              tokens=len(key),
                              outcome="adopted" if ok else "failed")
        return landed

    # -- introspection -------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "ships": self.ships,
                "lands": self.lands,
                "failures": self.failures,
                "bytes_moved": self.bytes_moved,
                "migrations": dict(self.migrations),
                "sp_shard_frames": self.sp_shard_frames,
                "sp_shards_pending": len(self._pending_shards),
                "sp_shards_dropped": self.sp_shards_dropped,
            }

    def _count(self, name: str, value: int) -> None:
        if self._metrics is None:
            return
        try:
            self._metrics.add_counter(name, value, model=self.name)
        except Exception:
            pass
