"""Host-RAM spill tier under the paged KV pool — counterpart of
``gofr_tpu/ml/kv_offload.py``.

When pool pressure makes ``Generator._reclaim_prefix_pages`` (or the radix
cache's capacity eviction) drop an idle prefix, the tier keeps a copy of
its pages in host memory, so the next hit on that prefix restores them with
a copy instead of paying a full prefill again.

``HostKVStore`` is the host side of that tier:

- **put** takes the evicted prefix's page slabs as PINNED host tensors
  whose device-to-host copy was enqueued without blocking, with the CUDA
  event that marks it done (None on the CPU, where the slabs are already
  host memory). The store settles a copy lazily: everything but the newest
  entry settles on the next ``put``, and an entry settles when it is first
  read, so an eviction never blocks the serving thread on a copy.
- an **LRU budget** (``GOFR_ML_KV_HOST_BUDGET_MB``; 0 turns the tier off
  and evictions discard, as without it) bounds the host bytes: inserting
  past the budget drops the least-recently-used entries, and an entry
  larger than the whole budget is refused (the caller discards).
- **pop** hands the settled slabs back for a restore
  (``Generator.restore_prefix`` copies them to the card and writes them
  into freshly allocated pool pages in place); ``put_back`` reinserts them
  when the restore loses the race to pool pressure.

Keys are the prefix's full registered token tuple, the identity the radix
cache matches prompts by. The tier holds whatever page slabs the pool uses
(bf16/f32, int8 or packed int4 values with their scale and zero planes),
and its byte accounting follows the tensors; the raw bytes round-trip
untouched, so spill→restore is bit-identical at every precision.

All mutation happens on the serving thread that owns the Generator; a
small lock makes ``stats()`` and ``meta()`` safe from other threads, and
settling (which may wait on a copy) runs outside it. The JAX module's
fleet event log and goodput hooks come with ROADMAP A.6b.
"""

from __future__ import annotations

import collections
import os
import threading

__all__ = ["OffloadConfig", "HostKVStore"]


class OffloadConfig:
    """Host-tier policy knobs.

    - ``budget_mb``: host bytes the tier may hold; 0 disables offload
      entirely (evictions discard, exactly the pre-tier behavior).
    """

    def __init__(self, *, budget_mb: float = 0.0) -> None:
        self.budget_mb = float(budget_mb)

    @classmethod
    def from_env(cls) -> "OffloadConfig":
        """``GOFR_ML_KV_HOST_BUDGET_MB`` (default 0 = off: spilling is an
        explicit capacity decision — operators opt in with a budget)."""
        raw = os.environ.get("GOFR_ML_KV_HOST_BUDGET_MB", "0").strip()
        try:
            budget = float(raw) if raw else 0.0
        except ValueError:
            budget = 0.0
        return cls(budget_mb=max(0.0, budget))

    @property
    def budget_bytes(self) -> int:
        return int(self.budget_mb * 1024 * 1024)

    @property
    def enabled(self) -> bool:
        return self.budget_bytes > 0


class _Entry:
    __slots__ = ("arrays", "meta", "nbytes", "event")

    def __init__(self, arrays: dict, meta: dict, nbytes: int,
                 event=None) -> None:
        self.arrays = arrays      # host tensors (pinned on a card)
        self.meta = meta
        self.nbytes = nbytes
        self.event = event        # the pending copy's CUDA event, or None

    @property
    def settled(self) -> bool:
        return self.event is None


def _entry_nbytes(arrays: dict) -> int:
    """Host bytes an entry occupies, from shapes and dtypes: known before
    the copy lands."""
    return sum(t.numel() * t.element_size() for t in arrays.values())


class HostKVStore:
    """LRU-bounded host store of spilled prefix KV page slabs."""

    def __init__(self, config: OffloadConfig | None = None) -> None:
        self.config = config or OffloadConfig.from_env()
        self.budget_bytes = self.config.budget_bytes
        self._entries: collections.OrderedDict[tuple, _Entry] = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.bytes_used = 0
        # lifetime totals
        self.puts = 0
        self.hits = 0          # pops that fed a restore
        self.rejects = 0       # entries larger than the whole budget
        self.evictions = 0     # LRU drops under the byte budget

    @classmethod
    def from_env(cls) -> "HostKVStore | None":
        """The Generator's default wiring: a store when the env budget is
        positive, None (tier off, discard on eviction) otherwise."""
        cfg = OffloadConfig.from_env()
        return cls(cfg) if cfg.enabled else None

    def _insert(self, key: tuple, entry: _Entry) -> None:
        """Under the lock: make room LRU-first, then add ``entry`` as the
        most recently used."""
        old = self._entries.pop(key, None)
        if old is not None:
            self.bytes_used -= old.nbytes
        while self._entries and self.bytes_used + entry.nbytes > \
                self.budget_bytes:
            _, victim = self._entries.popitem(last=False)
            self.bytes_used -= victim.nbytes
            self.evictions += 1
        self._entries[key] = entry
        self.bytes_used += entry.nbytes

    # -- write side (eviction path) ---------------------------------------
    def put(self, key: tuple, arrays: dict, meta: dict, event=None) -> bool:
        """Admit one spilled prefix: host slabs whose copy ``event`` (None:
        already landed) marks done. False when the entry alone exceeds the
        budget — the caller discards, as without the tier."""
        nbytes = _entry_nbytes(arrays)
        with self._lock:
            if nbytes > self.budget_bytes:
                self.rejects += 1
                return False
            self._insert(key, _Entry(arrays, dict(meta), nbytes, event))
            self.puts += 1
            # double-buffer: every entry but the newest has had a whole
            # put-to-put interval for its copy to land — settle them
            settle_now = [e for k, e in self._entries.items()
                          if not e.settled and k != key]
        for e in settle_now:
            self._settle(e)
        return True

    def put_back(self, key: tuple, arrays: dict, meta: dict) -> bool:
        """Reinsert a popped (settled) entry after a failed restore, as the
        most recently used. False when the entry alone exceeds the budget
        (dropped, never evicted for)."""
        nbytes = _entry_nbytes(arrays)
        with self._lock:
            if nbytes > self.budget_bytes:
                return False
            self._insert(key, _Entry(arrays, dict(meta), nbytes))
        return True

    # -- KV-transport handoff ------------------------------------------------
    def take(self, key: tuple) -> tuple[dict, dict] | None:
        """Remove and return ``(arrays, meta)``, settled, for a handoff to
        another replica: like ``pop`` without counting a store hit."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return None
            self.bytes_used -= entry.nbytes
        self._settle(entry)
        return entry.arrays, entry.meta

    def receive(self, key: tuple, arrays: dict, meta: dict) -> bool:
        """Land an entry shipped from another replica as the most recently
        used; the budget contract of ``put``."""
        return self.put_back(key, arrays, meta)

    @staticmethod
    def _settle(entry: _Entry) -> None:
        """Wait for an entry's device-to-host copy. It was enqueued at
        spill time, so this usually returns at once."""
        if entry.event is not None:
            entry.event.synchronize()
            entry.event = None

    # -- read side (restore path) -----------------------------------------
    def pop(self, key: tuple) -> tuple[dict, dict] | None:
        """Remove and return ``(arrays, meta)``, settled, for a restore. A
        restore MOVES the entry to the card — on its next eviction it
        spills again — so host and card never both hold it."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return None
            self.bytes_used -= entry.nbytes
            self.hits += 1
        self._settle(entry)
        return entry.arrays, entry.meta

    def meta(self, key: tuple) -> dict | None:
        """Entry metadata without touching the LRU order — the radix
        cache's usability check reads it."""
        with self._lock:
            entry = self._entries.get(key)
            return dict(entry.meta) if entry is not None else None

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        """Tier occupancy and traffic."""
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self.bytes_used,
                "budget_bytes": self.budget_bytes,
                "store_hits": self.hits,
                "puts": self.puts,
                "rejects": self.rejects,
                "store_evictions": self.evictions,
                "pending_copies": sum(1 for e in self._entries.values()
                                      if not e.settled),
            }
