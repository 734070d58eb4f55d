"""Shared-prefix KV cache policy — counterpart of
``gofr_tpu/ml/prefix_cache.py``.

The Generator has the device-side primitives (``register_prefix`` computes
a prefix's KV pages once; prefixed admission prefills only the suffix while
attending the shared pages read-only). This module is the policy over them:

- a token-level **radix trie** records every admitted prompt (compressed
  edges, bounded node count); the longest shared prefix between prompts is
  a trie node, found in O(prompt length);
- **promotion**: a ≥K-token shared prefix observed ``promote_hits`` times
  within ``window_s`` is registered on the Generator automatically. The
  explicit ``LLMServer.register_prefix`` layers on the same trie as a
  *pinning* call (pinned prefixes evict only as a last resort);
- **ref-counted reuse**: the Generator refcounts borrowing slots; the
  cache never drops a borrowed prefix — eviction candidates with live
  borrowers are skipped in favor of the next-oldest;
- **pressure-aware eviction**: the Generator's own reclamation spends idle
  prefix pages before truncating a live stream or refusing a prefill
  (unpinned first, pinned last); the cache notices such evictions on the
  next lookup and clears its stale registration;
- **the host tier**: with the Generator's host KV tier on
  (``kv_offload.py``), an evicted registration whose pages were spilled
  moves to the OFFLOADED state (``offload_key``): a later prompt through
  it restores the pages (``Generator.restore_prefix``) instead of
  re-prefilling, and a capacity eviction spills before it drops.

Registration is precision-agnostic: the pages may be fp, int8 or packed
int4. All mutation happens on the LLMServer serving thread (the one thread
that touches the Generator); a small lock makes ``snapshot()`` and
``peek()`` safe from other threads, and device work (the prefix prefill
inside ``register_prefix``) runs outside it.

An eviction emits an ``evict`` event into the flight recorder's event log;
a restore that falls through (pool pressure, the tier dropped the entry, a
prefix evicted in the admission race) charges the prefix tokens that
prefill again to the goodput ledger as ``restore_fallback`` (``goodput``,
a model handle the owning LLMServer installs). The counters (``hits``,
``misses``, ``evictions``, ``tokens_saved``, ``offloads``, ``restores``)
are kept as in JAX. ``metrics`` (an object with ``add_counter``)
receives ``app_ml_prefix_hits_total``, ``app_ml_prefix_misses_total``,
``app_ml_prefix_evictions_total`` and
``app_ml_prefill_tokens_saved_total``.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from ..flight_recorder import event_log
from .generate import PagePoolExhausted

__all__ = ["PrefixCacheConfig", "RadixPrefixCache"]


class PrefixCacheConfig:
    """Promotion/eviction policy knobs.

    - ``promote_hits``: prompts sharing a prefix before it registers
      (2 = the second occurrence already reuses).
    - ``min_tokens``: shortest prefix worth registering; floored at
      ``page_size + 1`` so a registration always shares ≥ one whole page
      AND leaves a non-empty suffix.
    - ``window_s``: hit counts older than this decay to zero.
    - ``max_prefixes``: registered prefixes the cache will hold; beyond
      it the least-recently-hit *unborrowed, unpinned* one is dropped.
    - ``max_nodes``: trie size bound; unregistered cold leaves prune
      least-recently-hit first.
    """

    def __init__(self, *, promote_hits: int = 2, min_tokens: int = 0,
                 window_s: float = 300.0, max_prefixes: int = 16,
                 max_nodes: int = 512) -> None:
        self.promote_hits = int(promote_hits)
        self.min_tokens = int(min_tokens)
        self.window_s = float(window_s)
        self.max_prefixes = int(max_prefixes)
        self.max_nodes = int(max_nodes)


class _Node:
    """One radix-trie node: ``edge`` is the token run INTO the node,
    ``depth`` the total tokens from the root through it. Registration
    states: ``pid`` set (the pages are on the card), ``offload_key`` set
    (the pages are in the host tier, restorable; ``reg_len`` survives so a
    restore re-registers the same split), neither (a plain trie node)."""

    __slots__ = ("edge", "children", "parent", "depth", "pid", "reg_len",
                 "offload_key", "hits", "last_hit")

    def __init__(self, edge: tuple, parent, depth: int) -> None:
        self.edge = tuple(edge)
        self.children: dict[int, _Node] = {}
        self.parent = parent
        self.depth = depth
        self.pid: int | None = None   # generator prefix id when registered
        self.reg_len = 0              # tokens actually registered (≤ depth)
        self.offload_key: tuple | None = None  # host-tier key when spilled
        self.hits = 0
        self.last_hit = 0.0


class RadixPrefixCache:
    """Token-trie prefix cache over one paged Generator."""

    def __init__(self, gen: Any, config: PrefixCacheConfig | None = None,
                 *, metrics=None, model: str = "llm") -> None:
        if not getattr(gen, "page_size", 0):
            raise ValueError("prefix caching requires a paged generator")
        self.gen = gen
        self.cfg = config or PrefixCacheConfig()
        self._metrics = metrics
        self._model = model
        # registrations shorter than a page share nothing; the +1 keeps a
        # registration from ever swallowing a whole prompt (the suffix
        # prefill needs ≥1 token beyond the shared pages)
        self._min_tokens = max(self.cfg.min_tokens, gen.page_size + 1)
        # prompts longer than the largest prefill bucket can never register
        # whole — unless chunked prefill is on, which registers long
        # prefixes in segments: then the trie tracks to capacity
        self._track_cap = (int(gen.max_seq) - 1
                           if getattr(gen, "prefill_chunk", 0)
                           else int(gen.prefill_buckets[-1]))
        self._root = _Node((), None, 0)
        self._by_pid: dict[int, _Node] = {}
        self._n_nodes = 0
        self._lock = threading.Lock()
        self._events = event_log()
        # the goodput ledger's handle for this model (None = off),
        # installed by the owning LLMServer
        self.goodput = None
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.tokens_saved = 0
        self.offloads = 0   # registrations that moved to the host tier
        self.restores = 0   # offloaded registrations brought back

    # -- admission path -------------------------------------------------------
    def observe(self, prompt_ids) -> tuple[int | None, int]:
        """Record one admitted prompt and return ``(pid, reg_len)`` of the
        longest *usable* registered prefix — the caller prefills only
        ``prompt_ids[reg_len:]`` — or ``(None, 0)`` on a miss. Hot shared
        prefixes promote (register on the Generator) inside this call, so
        the very request that crosses the threshold already reuses. Only
        the miss is counted here, after any stale registration on the path
        was evicted; the HIT counts when admission succeeds
        (``commit_hit``)."""
        ids = tuple(int(t) for t in prompt_ids)
        if not ids:
            return None, 0
        now = time.monotonic()
        with self._lock:
            path = self._insert(ids[:self._track_cap], now)
            best = self._best_registered(path, len(ids))
            # a restore pays only when it REUSES more than the registered
            # match: compare reg_len (the shared split), not trie depth
            floor = best.reg_len if best is not None else 0
            restore_node = self._best_offloaded(path, len(ids), floor)
        if restore_node is not None:
            # the host-to-card copy outside the lock; only the serving
            # thread mutates the trie, so nothing races the release
            pid = None
            try:
                pid = self.gen.restore_prefix(restore_node.offload_key)
            except PagePoolExhausted:
                # the entry stays in the tier: this request falls back to
                # the shallower match or a full prefill, and the reuse it
                # lost past that floor prefills again
                lost = max(0, restore_node.reg_len - floor)
                if self.goodput is not None and lost:
                    self.goodput.note("restore_fallback", lost)
            except KeyError:
                lost = 0
                with self._lock:  # the tier dropped it (LRU): gone
                    if restore_node.pid is None:
                        lost = restore_node.reg_len
                        restore_node.offload_key = None
                        restore_node.reg_len = 0
                if self.goodput is not None and lost:
                    self.goodput.note("restore_fallback", lost)
            if pid is not None:
                with self._lock:
                    restore_node.pid = pid
                    restore_node.offload_key = None
                    self._by_pid[pid] = restore_node
                    self.restores += 1
                if self._usable_for(restore_node, len(ids)):
                    best = restore_node
                self._make_room(skip=restore_node)  # the cap holds too
        with self._lock:
            node = self._promotion_candidate(path, best)
            reg_len = self._reg_len_for(node) if node is not None else 0
            if node is not None and (
                    reg_len < self.gen.page_size
                    # permanently impossible: more pages than the whole
                    # pool — don't wipe useful idle prefixes trying
                    or (reg_len // self.gen.page_size
                        > self.gen.n_pages - 1)):
                node = None
        if node is not None and not self._make_room(skip=node):
            node = None
        if node is not None:
            # device work (the prefix prefill) outside the lock; only the
            # serving thread mutates the trie, so nothing races the release
            try:
                pid = self.gen.register_prefix(ids[:reg_len])
            except (PagePoolExhausted, ValueError):
                pid = None
                with self._lock:
                    # re-earn the promotion threshold instead of
                    # re-attempting (and re-running the generator's
                    # reclaim) on every request
                    node.hits = 0
            if pid is not None:
                with self._lock:
                    node.pid = pid
                    node.reg_len = reg_len
                    self._by_pid[pid] = node
                if self._usable_for(node, len(ids)):
                    best = node
        with self._lock:
            if best is None:
                self.misses += 1
                self._count("app_ml_prefix_misses_total", 1)
                return None, 0
            return best.pid, best.reg_len

    def commit_hit(self, pid: int) -> None:
        """Admission on a cache-split prompt SUCCEEDED: count the hit and
        the prefill tokens its shared pages saved."""
        with self._lock:
            info = self.gen._prefixes.get(pid)
            shared = int(info["len"]) if info else 0
            self.hits += 1
            self.tokens_saved += shared
            self._count("app_ml_prefix_hits_total", 1)
            self._count("app_ml_prefill_tokens_saved_total", shared)

    def record_miss(self, lost_tokens: int = 0) -> None:
        """A cache-split admission fell back to the full prompt (the
        prefix evicted in the race window): nothing was saved, and the
        ``lost_tokens`` of the prefix prefill again (``restore_fallback``)."""
        with self._lock:
            self.misses += 1
            self._count("app_ml_prefix_misses_total", 1)
        if self.goodput is not None and lost_tokens > 0:
            self.goodput.note("restore_fallback", int(lost_tokens))

    def peek(self, prompt_ids) -> tuple[int | None, int]:
        """READ-ONLY longest usable registered match — no insert, no hit
        accounting, no stale-entry cleanup. ``check_admissible`` uses it to
        accept prompts that only fit the shape rules via a cached split."""
        ids = tuple(int(t) for t in prompt_ids)
        best: tuple[int | None, int] = (None, 0)
        with self._lock:
            node = self._root
            pos = 0
            while pos < len(ids):
                child = node.children.get(ids[pos])
                if child is None or ids[pos:pos + len(child.edge)] != child.edge:
                    break
                pos += len(child.edge)
                node = child
                if (node.pid is not None and self.gen.has_prefix(node.pid)
                        and self._usable_for(node, len(ids))):
                    best = (node.pid, node.reg_len)
        return best

    def _usable_for(self, node: _Node, n: int) -> bool:
        """Can an ``n``-token prompt admit on this registration? The suffix
        (generator-held tail + tokens beyond the registration) must be
        non-empty and fit the prefill shape rules."""
        info = self.gen._prefixes.get(node.pid)
        if info is None:
            return False
        n_suf = len(info["tail"]) + (n - node.reg_len)
        return (n_suf >= 1 and info["len"] + n_suf < self.gen.max_seq
                and n_suf <= self.gen.prefill_buckets[-1])

    def _best_registered(self, path: list[_Node], n: int) -> _Node | None:
        """Deepest registered node on the matched path whose reuse is
        admissible for an ``n``-token prompt. Registrations the generator
        evicted under pool pressure (``has_prefix`` false) are noted here:
        spilled ones move to the offloaded state, the rest are cleared."""
        best = None
        for node in path:
            if node.pid is None:
                continue
            if not self.gen.has_prefix(node.pid):
                self._note_stale(node)  # evicted behind our back
                continue
            if self._usable_for(node, n):
                best = node  # path is root→leaf ordered: keep the deepest
        return best

    def _note_stale(self, node: _Node) -> None:
        """A registration the generator evicted: if its pages landed in the
        host tier, the node moves to the OFFLOADED state (its split
        survives; a later hit restores); otherwise it is gone — clear it
        and count the eviction."""
        pid = node.pid
        key = self._node_tokens(node)[:node.reg_len]
        has_offloaded = getattr(self.gen, "has_offloaded", None)
        if key and has_offloaded is not None and has_offloaded(key):
            self._by_pid.pop(pid, None)
            node.pid = None
            node.offload_key = key
            self.offloads += 1
        else:
            self._evict(pid, node)

    def _best_offloaded(self, path: list[_Node], n: int,
                        floor: int) -> _Node | None:
        """Deepest offloaded node whose registration beats ``floor`` (the
        registered best's ``reg_len``) and whose restored reuse is
        admissible for an ``n``-token prompt: the restore candidate.
        Entries the host tier dropped behind our back are cleared here."""
        store = getattr(self.gen, "host_kv", None)
        if store is None:
            return None
        best = None
        for node in path:
            if node.offload_key is None or node.pid is not None:
                continue
            meta = store.meta(node.offload_key)
            if meta is None:          # the host tier dropped it: gone
                node.offload_key = None
                node.reg_len = 0
                self._evict(None, node)
                continue
            if node.reg_len > floor and self._usable_meta(meta,
                                                          node.reg_len, n):
                best = node
        return best

    def _usable_meta(self, meta: dict, reg_len: int, n: int) -> bool:
        """``_usable_for`` of an offloaded entry: can an ``n``-token prompt
        admit on a restore of it?"""
        n_suf = len(meta["tail"]) + (n - reg_len)
        return (n_suf >= 1 and meta["len"] + n_suf < self.gen.max_seq
                and n_suf <= self.gen.prefill_buckets[-1])

    def _promotion_candidate(self, path: list[_Node],
                             best: _Node | None) -> _Node | None:
        """Deepest hot unregistered node that would beat the current best
        match: ``promote_hits`` distinct prompts through it inside the
        decay window make it worth a one-time prefix prefill. Offloaded
        nodes are left out: their KV exists in the host tier, and the
        restore path of ``observe`` owns them."""
        floor = best.depth if best is not None else 0
        for node in reversed(path):
            if (node.pid is None and node.offload_key is None
                    and node.depth >= self._min_tokens
                    and node.depth > floor
                    and node.hits >= self.cfg.promote_hits):
                return node
        return None

    def _reg_len_for(self, node: _Node) -> int:
        """Tokens to register for a trie node. Page-aligned depths register
        one token short so an exact-match prompt still has a suffix to
        prefill (the sub-page tail re-prefills with each suffix anyway)."""
        ps = self.gen.page_size
        return node.depth - 1 if ps > 1 and node.depth % ps == 0 \
            else node.depth

    def _make_room(self, skip: _Node | None = None) -> bool:
        """Hold the registered-prefix count under ``max_prefixes`` by
        dropping the least-recently-hit candidates. Borrowed (refs > 0) and
        pinned prefixes are SKIPPED in favor of the next-oldest — never
        popped-and-stranded. With the host tier on, a victim's pages spill
        and its node moves to the offloaded state. The spill's device work
        runs outside the lock. False when nothing can go."""
        while True:
            victim_pid = victim_node = victim_info = None
            with self._lock:
                if len(self._by_pid) < self.cfg.max_prefixes:
                    return True
                for pid, victim in sorted(self._by_pid.items(),
                                          key=lambda kv: kv[1].last_hit):
                    if victim is skip:
                        continue
                    info = self.gen._prefixes.get(pid)
                    if info is not None and (info["refs"] > 0
                                             or info.get("pinned")):
                        continue  # borrowed or pinned: try the next-oldest
                    victim_pid, victim_node, victim_info = pid, victim, info
                    break
                if victim_node is None:
                    return False
            spilled = False
            if victim_info is not None:
                spilled = bool(self.gen.drop_prefix(victim_pid, spill=True))
            with self._lock:
                if spilled:
                    self._offload(victim_pid, victim_node)
                elif victim_info is None:
                    # the generator evicted it already, maybe into the
                    # tier: keep it restorable as _best_registered would
                    self._note_stale(victim_node)
                else:
                    self._evict(victim_pid, victim_node)

    def _offload(self, pid: int, node: _Node) -> None:
        """Move one registration to the offloaded state: its pages now live
        in the host tier under the node's registered token run."""
        self._by_pid.pop(pid, None)
        if node.pid == pid:
            node.pid = None
            node.offload_key = self._node_tokens(node)[:node.reg_len]
        self.offloads += 1

    def _evict(self, pid: int, node: _Node) -> None:
        """Clear one registration's bookkeeping BY KEY (the generator-side
        pages are already released or owned by the generator), so a node
        whose pid moved on never leaves a ghost ``_by_pid`` entry."""
        self._by_pid.pop(pid, None)
        if node.pid == pid:
            node.pid = None
            node.reg_len = 0
        self.evictions += 1
        self._count("app_ml_prefix_evictions_total", 1)
        self._events.emit("evict", model=self._model,
                          prefix_tokens=node.depth)

    # -- pinning API (explicit register_prefix) -------------------------------
    def pin(self, prefix_ids) -> int:
        """Explicit registration layered on the trie: the full prefix is
        registered *pinned* — it evicts only as the generator's last
        resort. Returns the prefix id for ``prefix=`` admission."""
        ids = tuple(int(t) for t in prefix_ids)
        if not ids:
            raise ValueError("empty prefix")
        now = time.monotonic()
        with self._lock:
            path = self._insert(ids, now)
            node = path[-1] if path and path[-1].depth == len(ids) else None
            if node is not None and node.pid is not None:
                info = self.gen._prefixes.get(node.pid)
                if info is None:
                    # the generator dropped it behind us: clear the stale
                    # entry and register fresh below
                    self._evict(node.pid, node)
                elif node.reg_len == len(ids):
                    info["pinned"] = True  # promote the registration
                    return node.pid
                elif info["refs"] == 0:
                    # auto-registration one token short (page-aligned
                    # depth): replace it with the full pinned one
                    self.gen.drop_prefix(node.pid)
                    self._by_pid.pop(node.pid, None)
                    node.pid = None
                    node.reg_len = 0
                else:
                    # borrowed right now: detach the trie from the old
                    # registration (it drains with its slots and the
                    # generator reclaims it once idle) and point auto
                    # traffic at the fresh pinned copy below
                    self._by_pid.pop(node.pid, None)
                    node.pid = None
                    node.reg_len = 0
        self._make_room(skip=node)
        pid = self.gen.register_prefix(ids, pinned=True)
        with self._lock:
            if node is not None:
                node.pid = pid
                node.reg_len = len(ids)
                node.offload_key = None  # the fresh copy supersedes any
                self._by_pid[pid] = node  # host-tier remnant (LRU drops it)
        return pid

    def drop(self, pid: int) -> None:
        """Release an explicitly-registered prefix (raises while slots
        still borrow it, like ``Generator.drop_prefix``)."""
        with self._lock:
            node = self._by_pid.get(pid)
            self.gen.drop_prefix(pid)  # raises if borrowed: node stays
            if node is not None:
                self._by_pid.pop(pid, None)
                node.pid = None
                node.reg_len = 0  # an explicit drop is not an eviction

    def adopt_offloaded(self, key_ids) -> bool:
        """An entry for this prefix landed in the generator's HOST tier
        from elsewhere (another replica's handoff): seed the trie with an
        OFFLOADED node for it, so the next prompt through it restores the
        pages instead of re-prefilling. False when the key is too long to
        track or a registration on the card already supersedes it."""
        ids = tuple(int(t) for t in key_ids)
        if not ids or len(ids) > self._track_cap:
            return False
        now = time.monotonic()
        with self._lock:
            path = self._insert(ids, now)
            node = path[-1] if path and path[-1].depth == len(ids) else None
            if node is None:
                return False
            if node.pid is not None:
                if self.gen.has_prefix(node.pid):
                    return False  # the card's copy beats the host entry
                self._by_pid.pop(node.pid, None)  # stale: supersede it
                node.pid = None
            node.offload_key = ids
            node.reg_len = len(ids)
        return True

    def forget_offloaded(self, key_ids) -> None:
        """The host-tier entry for this exact key LEFT (a handoff took it):
        clear the node's offloaded state so admission never chases a
        restore that can only miss."""
        ids = tuple(int(t) for t in key_ids)
        with self._lock:
            node = self._root
            pos = 0
            while pos < len(ids):
                child = node.children.get(ids[pos])
                if (child is None
                        or ids[pos:pos + len(child.edge)] != child.edge):
                    return
                pos += len(child.edge)
                node = child
            if node.offload_key == ids and node.pid is None:
                node.offload_key = None
                node.reg_len = 0

    def invalidate(self, pid: int) -> None:
        """The generator evicted this pid under pool pressure (a
        ``PrefixEvicted`` admission race): clear the stale registration so
        the next lookup misses instead of looping — or, when the eviction
        spilled the pages, mark the node restorable."""
        with self._lock:
            node = self._by_pid.get(pid)
            if node is not None:
                self._note_stale(node)

    def hot_prefixes(self, limit: int | None = None) -> list[dict]:
        """The cache's hot prefixes, hit-count descending: the registered,
        unborrowed, unpinned ones and the offloaded ones, ``{"ids":
        <registered token run>, "hits": n, "state": "registered" |
        "offloaded", "pid": id | None}`` a row. Read-only under the lock,
        safe from any thread."""
        rows: list[dict] = []
        with self._lock:
            for pid, node in self._by_pid.items():
                info = self.gen._prefixes.get(pid)
                if info is None or info["refs"] > 0 or info.get("pinned"):
                    continue
                ids = self._node_tokens(node)[:node.reg_len]
                if ids:
                    rows.append({"ids": ids, "hits": node.hits,
                                 "state": "registered", "pid": pid})
            stack = [self._root]
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                if n.offload_key is not None and n.pid is None:
                    rows.append({"ids": n.offload_key, "hits": n.hits,
                                 "state": "offloaded", "pid": None})
        rows.sort(key=lambda r: -r["hits"])
        return rows if limit is None else rows[:limit]

    def _node_tokens(self, node: _Node) -> tuple:
        """Root→node token run (edges concatenated up the parent chain)."""
        parts = []
        while node is not None and node.parent is not None:
            parts.append(node.edge)
            node = node.parent
        out: list[int] = []
        for edge in reversed(parts):
            out.extend(edge)
        return tuple(out)

    # -- trie -----------------------------------------------------------------
    def _insert(self, ids: tuple, now: float) -> list[_Node]:
        """Insert one prompt, splitting edges at divergence points, and
        return the root→leaf list of fully-on-path nodes. Every node on the
        path takes a windowed hit."""
        node = self._root
        pos = 0
        path: list[_Node] = []
        while pos < len(ids):
            child = node.children.get(ids[pos])
            if child is None:
                leaf = _Node(ids[pos:], node, len(ids))
                leaf.hits = 1
                leaf.last_hit = now
                node.children[ids[pos]] = leaf
                self._n_nodes += 1
                path.append(leaf)
                break
            edge = child.edge
            k = min(len(edge), len(ids) - pos)
            i = 0
            while i < k and edge[i] == ids[pos + i]:
                i += 1
            if i == len(edge):  # edge fully matched: descend
                self._bump(child, now)
                path.append(child)
                node = child
                pos += i
                continue
            # split the edge at i (≥1: the dict key matched): the new mid
            # node IS the shared prefix between this prompt and the tree
            mid = _Node(edge[:i], node, child.depth - (len(edge) - i))
            mid.hits = child.hits       # every prompt through child
            mid.last_hit = child.last_hit
            node.children[edge[0]] = mid
            child.edge = edge[i:]
            child.parent = mid
            mid.children[child.edge[0]] = child
            self._n_nodes += 1
            self._bump(mid, now)
            path.append(mid)
            pos += i
            if pos < len(ids):  # diverging remainder becomes a new leaf
                leaf = _Node(ids[pos:], mid, len(ids))
                leaf.hits = 1
                leaf.last_hit = now
                mid.children[ids[pos]] = leaf
                self._n_nodes += 1
                path.append(leaf)
            break
        if self._n_nodes > self.cfg.max_nodes:
            self._prune()
        return path

    def _bump(self, node: _Node, now: float) -> None:
        if now - node.last_hit > self.cfg.window_s:
            node.hits = 0  # stale heat decays: the window starts over
        node.hits += 1
        node.last_hit = now

    def _prune(self) -> None:
        """Drop cold unregistered leaves (least-recently-hit first) until
        the trie is back under ``max_nodes``."""
        while self._n_nodes > self.cfg.max_nodes:
            coldest = None
            stack = [self._root]
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                if (n.children or n.pid is not None
                        or n.offload_key is not None or n is self._root):
                    continue
                if coldest is None or n.last_hit < coldest.last_hit:
                    coldest = n
            if coldest is None:
                return  # everything left is structural or registered
            del coldest.parent.children[coldest.edge[0]]
            self._n_nodes -= 1

    # -- introspection --------------------------------------------------------
    def snapshot(self) -> dict:
        """Cache contents: per-prefix lengths, refcounts and hit counts,
        plus the lifetime totals."""
        now = time.monotonic()
        with self._lock:
            prefixes = []
            for pid, node in sorted(self._by_pid.items()):
                info = self.gen._prefixes.get(pid, {})
                prefixes.append({
                    "pid": pid,
                    "tokens": node.reg_len,
                    "shared_page_tokens": info.get("len", 0),
                    "refs": info.get("refs", 0),
                    "pinned": bool(info.get("pinned", False)),
                    "hits": node.hits,
                    "idle_s": round(now - node.last_hit, 3),
                })
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "prefill_tokens_saved": self.tokens_saved,
                "offloads": self.offloads,
                "restores": self.restores,
                "trie_nodes": self._n_nodes,
                "prefixes": prefixes,
            }

    def _count(self, name: str, delta: float) -> None:
        if self._metrics is None:
            return
        try:
            self._metrics.add_counter(name, delta, model=self._model)
        except Exception:
            pass  # metrics must never break admission
