"""Continuous-batching token generation — counterpart of
``gofr_tpu/ml/generate.py`` without speculation, fused windows, the depth-2
pipeline, sequence parallelism and the host KV tier.

``Generator`` holds a fixed batch of slots over one KV cache; every decode
dispatch runs the whole batch (free slots decode garbage that is ignored).
The cache is dense [L, B, S_max, KV, D] by default, or with ``page_size``
a pool of pages shared by every slot, read and written through a
host-owned page table (``llama.init_paged_cache``). As in the JAX package:

- requests admit in WAVES: one batched prefill (``prefill_into_many``) per
  wave, shape-bucketed in rows (1 or the admission cap, padding rows masked)
  and in prompt length (the prefill buckets); paged mode admits one
  request a wave (each prefill writes its own pages);
- a dispatch runs ``chunk`` decode+sample steps (the ladder entry the
  token-budget scheduler picks) and returns a token block [chunk + 1, B]
  whose row 0 is the INPUT token row — that is how the first tokens sampled
  at admission reach the host; while first tokens are pending the dispatch
  is the 1-step mini-chunk (TTFT);
- host bookkeeping lags one dispatch behind the device (the lag-one
  pipeline): a block is copied to a pinned host buffer with
  ``non_blocking=True`` behind a CUDA event, and read only when the next
  dispatch is on its way;
- the page pool: page 0 is scratch, a slot's pages grow ahead of decode
  (``_grow_pages``), a dry pool truncates the growing slot (``evictions``)
  instead of corrupting another, and admission without pages raises
  ``PagePoolExhausted`` (transient: the server requeues);
- shared prefixes: ``register_prefix`` computes a prefix's whole pages
  once; ``add_request(prefix=)`` borrows them and prefills only the
  partial-page tail plus the suffix; idle prefixes are a cache that pool
  pressure evicts (unpinned first, least recently used);
- chunked prefill: with ``prefill_chunk`` a longer prompt prefills in
  segments between decode dispatches, as many a dispatch as the
  scheduler's budget leaves, so live streams keep their cadence.

What differs: PyTorch runs eagerly, so a dispatch is a Python loop of
``decode_step`` / ``paged_decode_step`` calls and there is nothing to
compile (``warmup`` builds the CUDA kernels and runs each shape once). The
page table's device copy is rewritten only when a slot's pages change, and
a paged step gathers only the table columns its live rows use (rounded up
to a power of two of pages, so the shapes stay few). Sampling draws from
one ``torch.Generator`` stream instead of ``fold_in(key, step)``: greedy
output matches the JAX package token for token, sampled output by
distribution.

Speculation, fused windows, the dispatch pipeline at depth 2, sequence
parallelism and the host KV tier raise ``NotImplementedError`` naming the
ROADMAP item that brings them.
"""

from __future__ import annotations

import collections
import os
from typing import Any

import numpy as np
import torch

from .. import resolve_device
from ..models import llama
from .scheduler import TokenBudgetScheduler

__all__ = ["Sampler", "greedy", "Generator", "PagePoolExhausted",
           "PrefixEvicted"]

NEG_INF = -1e30


class PagePoolExhausted(RuntimeError):
    """Paged-KV admission failed for lack of free pages — transient
    back-pressure (pages free as slots finish), not a bad request; the
    serving layer requeues instead of erroring the client."""


class PrefixEvicted(RuntimeError):
    """The registered prefix this request references was LRU-evicted under
    pool pressure. Callers re-register (or retry with the full prompt) —
    the suffix-only ids they hold are meaningless without the prefix."""


def _chunk_ladder(chunk: int) -> tuple[int, ...]:
    """Power-of-two dispatch sizes up to ``chunk`` (always including 1 and
    ``chunk`` itself). 16 -> (1, 2, 4, 8, 16); 3 -> (1, 2, 3)."""
    ladder = [1]
    while ladder[-1] * 2 < chunk:
        ladder.append(ladder[-1] * 2)
    if chunk > 1:
        ladder.append(chunk)
    return tuple(ladder)


def _host_tier_requested() -> bool:
    """Does ``GOFR_ML_KV_HOST_BUDGET_MB`` ask for the host KV tier (a
    positive budget, read as the JAX package reads it)?"""
    raw = os.environ.get("GOFR_ML_KV_HOST_BUDGET_MB", "0").strip()
    try:
        return float(raw or 0) > 0
    except ValueError:
        return False


class Sampler:
    """Sampling config: greedy at ``temperature <= 0``."""

    def __init__(self, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0) -> None:
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)


def greedy() -> Sampler:
    return Sampler()


def _sample_impl(logits: torch.Tensor, generator: torch.Generator | None,
                 sampler: Sampler) -> torch.Tensor:
    """logits [B, V] -> token ids [B] int32. Greedy is ``argmax`` (ties take
    the first index, as in JAX); otherwise temperature, then top-k, then
    top-p masking with the finite -1e30, then one categorical draw per row
    from ``generator``."""
    if sampler.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / sampler.temperature
    if sampler.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -sampler.top_k][:, None]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if sampler.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # smallest set of tokens whose mass exceeds top_p
        cutoff_idx = torch.sum(cum < sampler.top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, NEG_INF, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


class _Slot:
    __slots__ = ("live", "tokens", "max_new", "produced", "prompt_len",
                 "eos_hit", "evicted", "callback")

    def __init__(self) -> None:
        self.live = False
        self.tokens: list[int] = []
        self.max_new = 0
        self.produced = 0
        self.prompt_len = 0
        self.eos_hit = False
        # a dry page pool truncated this slot: it finished with the tokens
        # it had, not at eos or max_new (the server answers "eviction")
        self.evicted = False
        self.callback = None


class _HostBlock:
    """One dispatch's token block on its way to the host: on a card, a
    pinned buffer filled with ``non_blocking=True`` and the CUDA event that
    marks the copy done; on the CPU, the block itself."""

    __slots__ = ("host", "event")

    def __init__(self, block: torch.Tensor) -> None:
        if block.device.type == "cuda":
            self.host = torch.empty(block.shape, dtype=block.dtype,
                                    pin_memory=True)
            self.host.copy_(block, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = block
            self.event = None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class Generator:
    """Continuous-batching decode loop over a fixed slot batch.
    Synchronous: ``LLMServer`` drives it from its serving thread.

        gen = Generator(params, cfg, batch_slots=8, max_seq=2048)
        out = gen.generate(prompt_ids, max_new_tokens=64)   # one request
        # or: slot = gen.add_request(ids, n, cb); gen.step() in a loop

    ``page_size`` > 0 serves from a page pool of ``n_pages`` pages (default
    ``1 + batch_slots * max_seq / page_size``, the dense equivalent plus the
    scratch page); ``prefill_chunk`` > 0 prefills prompts longer than it in
    segments. ``device`` defaults to the first CUDA card and raises when
    there is none; pass ``device="cpu"`` to run the plain PyTorch path on
    the host. ``params`` must already live on that device.
    """

    def __init__(self, params: Any, cfg, *, batch_slots: int = 8,
                 max_seq: int = 2048, sampler: Sampler | None = None,
                 eos_id: int | None = None, prefill_buckets=(128, 512, 2048),
                 seed: int = 0, chunk: int = 1, token_budget: int | None = None,
                 page_size: int = 0, n_pages: int | None = None,
                 prefill_chunk: int = 0, spec_k: int = 0,
                 decode_window: int = 0, pipeline: int = 0, sp: Any = None,
                 host_kv: Any = None, device=None) -> None:
        for value, what, item in (
                (spec_k, "speculative decoding (spec_k)", "A.10"),
                (decode_window, "fused decode windows", "A.9"),
                (pipeline, "the depth-2 dispatch pipeline", "A.9"),
                (sp, "sequence-parallel serving (sp)", "A.11"),
                (host_kv not in (None, False),
                 "the host KV tier (host_kv)", "A.8's host tier")):
            if value:
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP {item})")
        if host_kv is None and _host_tier_requested():
            raise NotImplementedError(
                "GOFR_ML_KV_HOST_BUDGET_MB asks for the host KV tier, which "
                "is not ported yet (ROADMAP A.8's host tier)")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the generator on {self.device}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if getattr(cfg, "kv_bits", 16) == 4 and not page_size:
            raise ValueError(
                "kv_bits=4 (int4 KV) requires the paged cache — set "
                "page_size > 0")
        self.params = params
        self.cfg = cfg
        self.batch_slots = batch_slots
        self.max_seq = max_seq
        self.sampler = sampler or greedy()
        if eos_id is None:
            self._eos = frozenset()
        elif isinstance(eos_id, (list, tuple, set, frozenset)):
            self._eos = frozenset(int(e) for e in eos_id)
        else:
            self._eos = frozenset((int(eos_id),))
        self._eos_arr = (np.fromiter(self._eos, np.int64, len(self._eos))
                         if self._eos else None)
        self.chunk = chunk
        self.prefill_buckets = tuple(
            b for b in sorted(prefill_buckets) if b <= max_seq) or (max_seq,)
        # prefill_chunk > 0: prompts longer than this prefill in segments
        # between decode dispatches. The dense segment writes a fixed
        # C-wide window, so capacity must be a whole number of segments.
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk and max_seq % self.prefill_chunk:
            raise ValueError(f"max_seq {max_seq} must be a multiple of "
                             f"prefill_chunk {self.prefill_chunk}")
        self._chunked: dict[int, dict] = {}   # slot -> segment state
        self._chunked_order: collections.deque[int] = collections.deque()
        self.prefill_segments_run = 0  # chunked-prefill segments dispatched
        self.evictions = 0  # slots truncated because the page pool ran dry
        self.page_size = int(page_size)
        if self.page_size:
            for b in (*self.prefill_buckets, max_seq):
                # max_seq included: it is the prefill-bucket fallback, and
                # a non-multiple would silently drop trailing prompt rows
                if b % self.page_size:
                    raise ValueError(
                        f"prefill bucket/max_seq {b} not a multiple of "
                        f"page_size")
            self._p_max = -(-max_seq // self.page_size)
            self.n_pages = n_pages or (1 + batch_slots * self._p_max)
            self.cache = llama.init_paged_cache(
                cfg, batch_slots, self.n_pages, self.page_size,
                device=self.device)
            # page 0 is scratch; the free list is a stack of real pages
            self._free_pages = list(range(self.n_pages - 1, 0, -1))
            self._slot_pages: list[list[int]] = [[] for _ in
                                                 range(batch_slots)]
            self._table = np.zeros((batch_slots, self._p_max), np.int32)
            # the device copy of the host table, rewritten only when a
            # slot's pages change (never uploaded per step)
            self._table_dev: torch.Tensor | None = None
            self._table_dirty = True
            # shared-prefix bookkeeping: per-slot count of BORROWED pages
            # (never freed back by this slot) and the owning prefix id
            self._slot_shared = [0] * batch_slots
            self._slot_prefix: list[int | None] = [None] * batch_slots
            self._prefixes: dict[int, dict] = {}
            self._next_prefix = 1
            self._prefix_clock = 0   # LRU stamp for prefix eviction
            self.prefix_evictions = 0
            self.prefix_prefills = 0  # prefix KV builds paid
        else:
            self.cache = llama.init_cache(cfg, batch_slots, max_seq,
                                          device=self.device)
        self.slots = [_Slot() for _ in range(batch_slots)]
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self._tok_dev = torch.zeros((batch_slots,), dtype=torch.int32,
                                    device=self.device)
        self._inflight: collections.deque[_HostBlock] = collections.deque()
        self._pending_first: collections.deque[int] = collections.deque()
        self.steps = 0           # decode steps dispatched
        self.prefill_waves = 0   # batched prefill dispatches
        self._chunk_ladder = _chunk_ladder(self.chunk)
        # auto budget, as in JAX: twice the full batch's chunk, or one
        # chunk of it plus two segments when chunked prefill is on
        if token_budget is None:
            token_budget = max(2 * self.chunk * batch_slots,
                               self.chunk * batch_slots
                               + 2 * self.prefill_chunk)
        self.scheduler = (
            TokenBudgetScheduler(token_budget, self._chunk_ladder,
                                 self.prefill_chunk, slots=batch_slots)
            if token_budget > 0 else None)
        # admission-wave row buckets: 1 (the trickle) and the cap (bursts);
        # paged mode admits one request a wave
        self._admit_cap = 1 if self.page_size else min(8, batch_slots)

    # -- device programs -----------------------------------------------------
    def _decode_chunk(self, n_steps: int, n_cols: int | None = None
                      ) -> torch.Tensor:
        """``n_steps`` fused decode+sample steps from the device token row.
        Returns the [n_steps + 1, B] block, row 0 the input row. A paged
        step gathers ``n_cols`` table columns (default: what the live rows
        hold, ``_gather_cols``)."""
        tok = self._tok_dev
        rows = [tok]
        if self.page_size:
            table = self._table_device()
            n_cols = n_cols or self._gather_cols()
        for _ in range(n_steps):
            if self.page_size:
                logits, self.cache = llama.paged_decode_step(
                    self.params, tok, self.cache, table, self.cfg,
                    n_cols=n_cols)
            else:
                logits, self.cache = llama.decode_step(self.params, tok,
                                                       self.cache, self.cfg)
            tok = _sample_impl(logits, self._rng, self.sampler)
            rows.append(tok)
        self._tok_dev = tok
        return torch.stack(rows)

    def _post_prefill(self, logits, slots, valid) -> None:
        """Sample the wave's first tokens and park them in the device token
        row at their slots (padding rows write nothing)."""
        firsts = _sample_impl(logits, self._rng, self.sampler)
        rows = [i for i, ok in enumerate(valid) if ok]
        if not rows:
            return
        idx = torch.as_tensor([int(slots[i]) for i in rows],
                              dtype=torch.long).to(self.device)
        src = torch.as_tensor(rows, dtype=torch.long).to(self.device)
        self._tok_dev[idx] = firsts[src]

    def _segment(self, toks, lens, slot: int, start: int, new_len: int):
        """One chunked-prefill segment into ``slot`` at ``start``; ``len``
        becomes ``new_len``. Returns the last valid token's logits."""
        if self.page_size:
            logits, self.cache = llama.paged_suffix_prefill(
                self.params, toks, lens, self.cfg, self.cache,
                self._table[slot].copy(), start, self.page_size)
            self.cache["len"][slot] = new_len
        else:
            logits, self.cache = llama.prefill_segment_into(
                self.params, toks, lens, self.cfg, self.cache, slot, start,
                new_len)
        return logits

    def warmup(self) -> None:
        """Build the CUDA kernels and run every dispatch shape once before
        the first request: the decode chunk and the 1-step mini-chunk (a
        paged step over every table column), each prefill bucket as a
        single (paged: its page writes) and as a wave, and with paging the
        suffix prefill per bucket, and the segment with chunked prefill.
        All slots are dead and every page write lands in scratch page 0, so
        nothing reaches bookkeeping; admission overwrites what this
        writes."""
        if any(s.live for s in self.slots):
            raise RuntimeError("warmup needs an idle generator")
        for n in sorted({self.chunk, 1}):
            self._decode_chunk(n, self._p_max if self.page_size else None)
        ones = np.ones((1,), np.int32)
        for bucket in self.prefill_buckets:
            padded = np.zeros((1, bucket), np.int32)
            if self.page_size:
                scratch = np.zeros((self._p_max,), np.int32)
                logits, self.cache = llama.paged_prefill_into(
                    self.params, padded, ones, self.cfg, self.cache,
                    scratch[:bucket // self.page_size], 0, self.page_size)
                self._post_prefill(logits, [0], [False])
                logits, self.cache = llama.paged_suffix_prefill(
                    self.params, padded, ones, self.cfg, self.cache, scratch,
                    0, self.page_size)
                self._post_prefill(logits, [0], [False])
                continue
            for b in sorted({1, self._admit_cap}):
                logits, self.cache = llama.prefill_into_many(
                    self.params, np.zeros((b, bucket), np.int32),
                    np.ones((b,), np.int32), self.cfg, self.cache,
                    np.zeros((b,), np.int32), np.zeros((b,), bool))
                self._post_prefill(logits, [0] * b, [False] * b)
        if self.prefill_chunk:
            seg = np.zeros((1, self.prefill_chunk), np.int32)
            s_cap = (self._p_max * self.page_size if self.page_size
                     else self.cache["k"].shape[2])
            self._segment(seg, ones, 0, 0, s_cap)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- paged-pool bookkeeping (page_size > 0) ------------------------------
    def _pop_free_page(self) -> int | None:
        """One page off the free pool, or None when dry."""
        return self._free_pages.pop() if self._free_pages else None

    def _return_pages(self, pages) -> None:
        self._free_pages.extend(pages)

    def _n_free_pages(self) -> int:
        return len(self._free_pages)

    def _alloc_pages_to(self, slot: int, upto_len: int) -> bool:
        """Grow the slot's page list to cover ``upto_len`` virtual
        positions (in order — virtual offsets stay contiguous). False when
        the pool ran dry; the caller picks the policy."""
        need = min(-(-upto_len // self.page_size), self._p_max)
        pages = self._slot_pages[slot]
        while len(pages) < need:
            pg = self._pop_free_page()
            if pg is None:
                return False
            pages.append(pg)
            self._table[slot, len(pages) - 1] = pg
            self._table_dirty = True
        return True

    def _pages_ever_free(self) -> int:
        """Pool pages that could EVER be free: everything except the
        scratch page and pages held by borrowed prefixes. A request needing
        more than this can never admit — reject it instead of requeueing
        forever."""
        held = sum(len(i["pages"]) for i in self._prefixes.values()
                   if i["refs"] > 0)  # idle prefixes are reclaimable cache
        return (self.n_pages - 1) - held

    def _free_slot_pages(self, slot: int) -> None:
        shared = self._slot_shared[slot]
        self._return_pages(self._slot_pages[slot][shared:])
        if shared:
            pid = self._slot_prefix[slot]
            if pid in self._prefixes:
                self._prefixes[pid]["refs"] -= 1
            self._slot_shared[slot] = 0
            self._slot_prefix[slot] = None
        self._slot_pages[slot] = []
        self._table[slot, :] = 0
        self._table_dirty = True

    def _grow_pages(self) -> None:
        """Pre-allocate pages for the upcoming dispatch: host bookkeeping
        lags one chunk, so cover produced + a pipeline margin. A dry pool
        TRUNCATES the growing slot — it finishes early with the tokens it
        has (counted in ``evictions``) rather than corrupting neighbors."""
        margin = self.chunk * (len(self._inflight) + 2)
        for i, s in enumerate(self.slots):
            if not s.live:
                continue
            est = min(s.prompt_len + s.produced + margin,
                      s.prompt_len + s.max_new,  # never past its budget
                      self.max_seq)
            if not self._alloc_pages_to(i, est):
                # idle prefix pages are reclaimable cache — spend them
                # before truncating a live stream
                need = -(-est // self.page_size) - len(self._slot_pages[i])
                self._reclaim_prefix_pages(max(need, 1))
                if self._alloc_pages_to(i, est):
                    continue
                s.live = False
                s.evicted = True
                self.evictions += 1

    def _table_device(self) -> torch.Tensor:
        """The device copy of the page table for the next dispatch, made
        anew only when the host table changed since the last one."""
        if self._table_dirty or self._table_dev is None:
            self._table_dev = llama._int32(self._table, self.device)
            self._table_dirty = False
        return self._table_dev

    def _gather_cols(self) -> int:
        """Table columns a paged step gathers: enough for the live slot
        holding the most pages (its kv_len never runs past them: pages grow
        ahead of decode), rounded up to a power of two so the gather takes
        few shapes; rows past them are garbage rows whose tokens are
        dropped, and ``kv_len`` masks the rest."""
        most = max((len(self._slot_pages[i]) for i, s in enumerate(self.slots)
                    if s.live), default=1)
        return min(self._p_max, 1 << max(most - 1, 0).bit_length())

    @property
    def free_pages(self) -> int:
        return self._n_free_pages() if self.page_size else 0

    def pool_stats(self) -> dict:
        """KV/slot occupancy snapshot: the numbers an operator sizes
        ``batch_slots`` and ``n_pages`` by."""
        out = {
            "slots": self.batch_slots,
            "live": self.n_live,
            "decode_steps": self.steps,
            "evictions": self.evictions,
            "chunked_prefills": len(self._chunked),
            "prefill_segments": self.prefill_segments_run,
        }
        if self.page_size:
            arrays = [a for k, a in self.cache.items() if k != "len"]
            out.update(
                page_size=self.page_size,
                n_pages=self.n_pages,
                free_pages=self.free_pages,
                kv_bits=getattr(self.cfg, "kv_bits", 16),
                # bytes ONE pool page costs across every cache array
                page_bytes=sum(a.numel() * a.element_size()
                               for a in arrays) // self.n_pages,
                page_value_bytes=sum(
                    self.cache[k].numel() * self.cache[k].element_size()
                    for k in ("k", "v")) // self.n_pages,
                prefix_evictions=self.prefix_evictions,
                registered_prefixes=len(self._prefixes),
                pinned_prefixes=sum(1 for i in self._prefixes.values()
                                    if i.get("pinned")),
                prefix_prefills=self.prefix_prefills,
            )
        return out

    # -- shared-prefix prefill (paged mode) ----------------------------------
    def register_prefix(self, prefix_ids, pinned: bool = False) -> int:
        """Compute a shared prefix's KV pages ONCE; requests then admit
        with ``prefix=<id>`` and prefill only their SUFFIX while attending
        the shared pages read-only (decode never writes below a slot's own
        start, so no copy-on-write is needed). Only WHOLE pages are shared:
        the remainder (< page_size tokens) re-prefills with each suffix. A
        prefix longer than every bucket builds in largest-bucket segments
        when chunked prefill is on.

        ``pinned`` prefixes are evicted under pool pressure only as a LAST
        RESORT, after every unpinned idle one; borrowed prefixes never."""
        if not self.page_size:
            raise ValueError("prefix sharing requires page_size > 0")
        ids = np.asarray(prefix_ids, np.int32).reshape(-1)
        ps = self.page_size
        shared_len = (len(ids) // ps) * ps
        n_need = shared_len // ps
        if self._n_free_pages() < n_need:
            # drop idle prefixes LRU-first before giving up: a rotating set
            # of system prompts must not brick registration
            self._reclaim_prefix_pages(n_need)
        if self._n_free_pages() < n_need:
            raise PagePoolExhausted(
                f"prefix needs {n_need} pages, {self.free_pages} free")
        pages = [self._pop_free_page() for _ in range(n_need)]
        if shared_len:
            bucket = next((b for b in self.prefill_buckets
                           if shared_len <= b), None)
            if bucket is None and not self.prefill_chunk:
                self._return_pages(pages)
                raise ValueError(
                    f"prefix length {shared_len} exceeds the largest "
                    f"prefill bucket {self.prefill_buckets[-1]} (set "
                    f"prefill_chunk to register long prefixes in segments)")
            row = np.zeros((self._p_max,), np.int32)
            row[:n_need] = pages
            seg_cap = bucket if bucket is not None else self.prefill_buckets[-1]
            try:
                for off in range(0, shared_len, seg_cap):
                    seg = ids[off:min(off + seg_cap, shared_len)]
                    toks = np.zeros((1, seg_cap), np.int32)
                    toks[0, :len(seg)] = seg
                    _logits, self.cache = llama.paged_suffix_prefill(
                        self.params, toks, np.array([len(seg)], np.int32),
                        self.cfg, self.cache, row, off, ps)
            except Exception:
                self._return_pages(pages)
                raise
            self.prefix_prefills += 1
        pid = self._next_prefix
        self._next_prefix += 1
        self._prefix_clock += 1
        self._prefixes[pid] = {"pages": pages, "len": shared_len,
                               "tail": [int(t) for t in ids[shared_len:]],
                               "ids_full": [int(t) for t in ids],
                               "refs": 0, "last_use": self._prefix_clock,
                               "pinned": bool(pinned)}
        return pid

    def has_prefix(self, pid: int) -> bool:
        """False once a prefix has been dropped or LRU-evicted — callers
        holding suffix-only ids must re-register before admitting."""
        return pid in self._prefixes

    def _reclaim_prefix_pages(self, n_need: int) -> bool:
        """Evict idle (refs == 0) prefixes until at least ``n_need`` pages
        are free: UNPINNED ones first, least-recently-used; PINNED ones only
        as a last resort. Borrowed prefixes (refs > 0) are never
        candidates. False when that cannot free enough."""
        while self._n_free_pages() < n_need:
            idle = [(info.get("pinned", False), info["last_use"], pid)
                    for pid, info in self._prefixes.items()
                    if info["refs"] == 0]
            if not idle:
                return False
            _, _, pid = min(idle)
            info = self._prefixes.pop(pid)
            self._return_pages(info["pages"])
            self.prefix_evictions += 1
        return True

    def drop_prefix(self, pid: int) -> bool:
        """Return a prefix's pages to the pool (no live borrowers). Returns
        False: the pages are discarded (the host tier that could keep them
        is not ported)."""
        info = self._prefixes[pid]
        if info["refs"] > 0:
            raise RuntimeError(f"prefix {pid} still used by {info['refs']} "
                               f"slots")
        self._return_pages(info["pages"])
        del self._prefixes[pid]
        return False

    def _admit_prefixed(self, pid: int, ids: np.ndarray, max_new: int,
                        callback) -> int:
        """Admit one request on top of a registered prefix: borrow its
        pages, prefill only the tail + suffix at start = the shared
        length."""
        if pid not in self._prefixes:
            raise PrefixEvicted(f"prefix {pid} was evicted; re-register")
        info = self._prefixes[pid]
        self._prefix_clock += 1
        info["last_use"] = self._prefix_clock
        suffix = info["tail"] + [int(t) for t in ids]
        n_suf = len(suffix)
        start = info["len"]
        if n_suf == 0:
            raise ValueError("prompt adds no tokens beyond the prefix")
        if start + n_suf >= self.max_seq:
            raise ValueError(
                f"prefix {start} + suffix {n_suf} exceeds max_seq")
        self.drain()  # settle bookkeeping before reusing slots
        slot = self.free_slot()
        if slot is None:
            raise RuntimeError("no free generation slot")
        self.slots[slot].live = True  # reserve
        if self._slot_pages[slot]:
            # a reused dead slot still holds its previous pages
            self._free_slot_pages(slot)
        try:
            shared = info["pages"]
            self._slot_pages[slot] = list(shared)
            self._slot_shared[slot] = len(shared)
            self._slot_prefix[slot] = pid
            info["refs"] += 1  # the except path's _free_slot_pages unrefs
            self._table[slot, :len(shared)] = shared
            self._table_dirty = True
            upto = min(start + n_suf + 2 * self.chunk,
                       start + n_suf + max_new, self.max_seq)
            if not self._alloc_pages_to(slot, upto):
                # idle prefixes are reclaimable cache (this one is held:
                # refs was just incremented)
                missing = (-(-upto // self.page_size)
                           - len(self._slot_pages[slot]))
                self._reclaim_prefix_pages(max(missing, 1))
            if not self._alloc_pages_to(slot, upto):
                need_own = -(-upto // self.page_size) - len(shared)
                if need_own > self._pages_ever_free():
                    raise ValueError(
                        f"request needs {need_own} own pages but the pool "
                        f"can only ever free {self._pages_ever_free()}")
                raise PagePoolExhausted(
                    f"kv page pool exhausted ({self.free_pages} pages free)")
            bucket = next((b for b in self.prefill_buckets if n_suf <= b),
                          None)
            if bucket is None:
                raise ValueError(
                    f"suffix length {n_suf} exceeds the largest "
                    f"prefill bucket {self.prefill_buckets[-1]}")
            toks = np.zeros((1, bucket), np.int32)
            toks[0, :n_suf] = suffix
            logits, self.cache = llama.paged_suffix_prefill(
                self.params, toks, np.array([n_suf], np.int32), self.cfg,
                self.cache, self._table[slot].copy(), start, self.page_size)
            self.cache["len"][slot] = start + n_suf
            self._post_prefill(logits, [slot], [True])
            self.prefill_waves += 1
        except Exception:
            self.slots[slot].live = False
            self._free_slot_pages(slot)
            raise
        self._pending_first.append(slot)
        s = _Slot()
        s.live = True
        s.max_new = max_new
        s.produced = 1  # the pending first token counts as sampled
        s.prompt_len = start + n_suf
        s.callback = callback
        self.slots[slot] = s
        return slot

    # -- request management ---------------------------------------------------
    def free_slot(self) -> int | None:
        for i, s in enumerate(self.slots):
            if not s.live:
                return i
        return None

    @property
    def n_live(self) -> int:
        return sum(s.live for s in self.slots)

    def _routes_chunked(self, n: int) -> bool:
        """Does a prompt of ``n`` tokens take the segmented prefill?"""
        return bool(self.prefill_chunk) and n > self.prefill_chunk

    def add_request(self, prompt_ids, max_new_tokens: int,
                    callback=None, prefix: int | None = None) -> int:
        """Prefill the prompt into a free slot; returns the slot index.
        ``callback(slot, tokens)`` receives each arriving BURST of sampled
        tokens (the slot's share of one processed chunk). ``prefix`` (paged
        mode) continues from a ``register_prefix`` result — only the suffix
        prefills."""
        return self.add_requests(
            [(prompt_ids, max_new_tokens, callback, prefix)])[0]

    def add_requests(self, requests) -> list[int]:
        """Admit a WAVE of requests — ``[(prompt_ids, max_new, callback)]``,
        or ``(..., prefix)`` with a ``register_prefix`` result or None —
        with as few prefill dispatches as possible; prompts longer than
        ``prefill_chunk`` queue for segmented prefill instead. A request on
        a prefix is admitted alone. All or nothing: when it raises, no slot
        of this call stays admitted. First tokens stay on the device and
        reach the host in row 0 of the next decode block."""
        requests = [(*r[:3], r[3] if len(r) > 3 else None) for r in requests]
        prefixed = [r for r in requests if r[3] is not None]
        if prefixed:
            if len(requests) != 1:
                raise ValueError("a request on a prefix is admitted alone")
            prompt_ids, max_new, callback, prefix = prefixed[0]
            ids = np.asarray(prompt_ids, np.int32).reshape(-1)
            return [self._admit_prefixed(prefix, ids, max_new, callback)]
        self.drain()  # settle bookkeeping before reusing slots
        prepped, chunked = [], []
        for prompt_ids, max_new, callback, _ in requests:
            ids = np.asarray(prompt_ids, np.int32).reshape(-1)
            n = len(ids)
            if n == 0 or n >= self.max_seq:
                raise ValueError(
                    f"prompt length {n} out of range (1..{self.max_seq - 1})")
            if ids.min() < 0 or ids.max() >= self.cfg.vocab_size:
                raise ValueError(
                    f"token ids must lie in [0, {self.cfg.vocab_size})")
            (chunked if self._routes_chunked(n) else prepped).append(
                (ids, n, int(max_new), callback))
        free = sum(1 for s in self.slots if not s.live)
        if len(prepped) + len(chunked) > free:
            raise RuntimeError(
                f"no free generation slot ({len(prepped) + len(chunked)} "
                f"requested, {free} free)")
        slots_c = self._admit_chunked_batch(chunked)
        out: list[int] = []
        try:
            self._admit_waves(prepped, out)
        except Exception:
            # the caller sees the whole batch fail: no slot of it may stay
            # admitted, or it would decode for a consumer told "error"
            self._rollback_chunked(slots_c)
            dead = set(out)
            for j in dead:
                self.slots[j].live = False
                if self.page_size:
                    self._free_slot_pages(j)
            self._pending_first = collections.deque(
                s for s in self._pending_first if s not in dead)
            raise
        # the caller's request order
        it_c, it_p = iter(slots_c), iter(out)
        return [next(it_c) if self._routes_chunked(
                    len(np.asarray(r[0]).reshape(-1))) else next(it_p)
                for r in requests]

    def _rollback_chunked(self, slots_c: list) -> None:
        """Unwind chunked admissions so a failed batch leaves nothing
        live."""
        for j in slots_c:
            self._chunked.pop(j, None)
            if j in self._chunked_order:
                self._chunked_order.remove(j)
            self.slots[j].live = False
            if self.page_size:
                self._free_slot_pages(j)

    def _admit_chunked_batch(self, chunked) -> list:
        slots_c: list = []
        try:
            for c in chunked:
                slots_c.append(self._admit_chunked(*c))
        except Exception:
            self._rollback_chunked(slots_c)
            raise
        return slots_c

    def _admit_chunked(self, ids, n: int, max_new: int, callback) -> int:
        """Reserve a slot and queue the prompt for SEGMENTED prefill:
        ``step`` advances segments between decode dispatches, so live
        streams keep producing while this prompt fills in. The slot joins
        decode (and gets its first token) after the final segment. Paged
        mode applies admission control here: the first segment's pages
        must allocate, and an impossible request rejects outright."""
        slot = self.free_slot()
        if slot is None:
            raise RuntimeError("no free generation slot")
        if self.page_size:
            upto_total = min(n + 2 * self.chunk, n + max_new, self.max_seq)
            need = -(-upto_total // self.page_size)
            if need > self._pages_ever_free():
                raise ValueError(
                    f"request needs {need} pages but the pool can only "
                    f"ever free {self._pages_ever_free()}")
            self.slots[slot].live = True  # reserve for the alloc below
            if self._slot_pages[slot]:
                self._free_slot_pages(slot)
            first_upto = min(self.prefill_chunk, n)
            if not self._alloc_pages_to(slot, first_upto):
                self._reclaim_prefix_pages(-(-first_upto // self.page_size))
            if not self._alloc_pages_to(slot, first_upto):
                self.slots[slot].live = False
                self._free_slot_pages(slot)
                raise PagePoolExhausted(
                    f"kv page pool exhausted ({self.free_pages} pages free)")
        s = _Slot()
        s.live = True
        s.max_new = max_new
        s.prompt_len = n
        s.callback = callback
        self.slots[slot] = s
        self._chunked[slot] = {"ids": ids, "done": 0}
        self._chunked_order.append(slot)
        return slot

    def _decodable(self) -> bool:
        """Any slot actually producing tokens (live and not mid-prefill)?"""
        return bool(self._pending_first) or any(
            s.live and i not in self._chunked
            for i, s in enumerate(self.slots))

    def _n_decodable(self) -> int:
        """Slots producing tokens this dispatch — the scheduler's live-work
        count (a slot mid-chunked-prefill decodes garbage, not tokens)."""
        return sum(1 for i, s in enumerate(self.slots)
                   if s.live and i not in self._chunked)

    def _advance_chunked(self, max_segments: int = 1) -> None:
        """Run up to ``max_segments`` prefill segments across the chunked
        slots (round-robin) before the next decode dispatch. While nothing
        is decodable the segments run back-to-back regardless; a final
        segment's pending first token ends the run so the mini-chunk
        surfaces it at once."""
        done = 0
        while self._chunked_order:
            slot = self._chunked_order[0]
            st = self._chunked.get(slot)
            if st is None:
                # released elsewhere: drop ONLY the order entry — the slot
                # may already host an unrelated new request
                self._chunked_order.popleft()
                continue
            if not self.slots[slot].live:
                # cancelled mid-prefill: drop the bookkeeping
                self._chunked.pop(slot, None)
                self._chunked_order.popleft()
                continue
            C = self.prefill_chunk
            start = st["done"]
            seg = st["ids"][start:start + C]
            toks = np.zeros((1, C), np.int32)
            toks[0, :len(seg)] = seg
            lens = np.array([len(seg)], np.int32)
            final = start + len(seg) == len(st["ids"])
            if self.page_size:
                # cover this segment's positions; a dry pool reclaims idle
                # prefixes, then truncates honestly like a decode eviction
                if not self._alloc_pages_to(slot, start + len(seg)):
                    self._reclaim_prefix_pages(1)
                if not self._alloc_pages_to(slot, start + len(seg)):
                    self.drain()
                    self._chunked.pop(slot)
                    self._chunked_order.popleft()
                    self.slots[slot].live = False
                    self.slots[slot].evicted = True
                    self.evictions += 1
                    continue
                s_cap = self._p_max * self.page_size
            else:
                s_cap = self.cache["k"].shape[2]
            # capacity len parks the row: interleaved decode steps drop (or
            # send to scratch) their writes instead of corrupting
            # prefilled positions
            logits = self._segment(toks, lens, slot, start,
                                   len(st["ids"]) if final else s_cap)
            st["done"] += len(seg)
            self.prefill_segments_run += 1
            if final:
                # flush decode blocks dispatched while this slot was
                # mid-prefill FIRST: their garbage rows for it must be
                # dropped while the _chunked guard still holds
                self.drain()
                self._chunked.pop(slot)
                self._chunked_order.popleft()
                self._pending_first.append(slot)
                self.slots[slot].produced = 1  # the pending first token
                self._post_prefill(logits, [slot], [True])
            else:
                self._chunked_order.append(self._chunked_order.popleft())
            done += 1
            if self._decodable() and (done >= max_segments
                                      or self._pending_first):
                return

    def _admit_waves(self, prepped, out: list[int]) -> list[int]:
        for start in range(0, len(prepped), self._admit_cap):
            wave = prepped[start:start + self._admit_cap]
            slots = []
            for _ in wave:
                i = self.free_slot()
                slots.append(i)
                self.slots[i].live = True  # reserve within this wave
            b = 1 if len(wave) == 1 else self._admit_cap
            s_bucket = next((s for s in self.prefill_buckets
                             if all(n <= s for _, n, _, _ in wave)),
                            self.max_seq)
            tokens = np.zeros((b, s_bucket), np.int32)
            lens = np.ones((b,), np.int32)
            valid = np.zeros((b,), bool)
            slot_arr = np.full((b,), slots[0], np.int32)
            for row, (ids, n, _, _) in enumerate(wave):
                tokens[row, :n] = ids
                lens[row] = n
                valid[row] = True
                slot_arr[row] = slots[row]
            try:
                if self.page_size:
                    self._prefill_paged(tokens, lens, slots[0], wave[0][2],
                                        s_bucket)
                else:
                    logits, self.cache = llama.prefill_into_many(
                        self.params, tokens, lens, self.cfg, self.cache,
                        slot_arr, valid)
                    self._post_prefill(logits, slot_arr, valid)
                self.prefill_waves += 1
            except Exception:
                for j in slots:  # unwind this wave's reservations
                    self.slots[j].live = False
                    if self.page_size:
                        self._free_slot_pages(j)
                raise
            for slot, (_ids, n, max_new, callback) in zip(slots, wave,
                                                           strict=True):
                self._pending_first.append(slot)
                s = _Slot()
                s.live = True
                s.max_new = max_new
                s.produced = 1  # the pending first token counts as sampled
                s.prompt_len = n
                s.callback = callback
                self.slots[slot] = s
            out.extend(slots)
        return out

    def _prefill_paged(self, tokens, lens, slot: int, max_new: int,
                       s_bucket: int) -> None:
        """One prompt into ``slot``'s own pages. Admission control: no
        pages, no slot — ``PagePoolExhausted`` (the caller requeues) rather
        than a silent eviction mid-generation; the estimate never exceeds
        the request's own budget."""
        if self._slot_shared[slot]:
            # the previous occupant borrowed prefix pages: reusing its list
            # would write INTO the shared prefix
            self._free_slot_pages(slot)
        n = int(lens[0])
        upto = min(n + 2 * self.chunk, n + max_new, self.max_seq)
        if not self._alloc_pages_to(slot, upto):
            missing = -(-upto // self.page_size) - len(self._slot_pages[slot])
            self._reclaim_prefix_pages(max(missing, 1))
        if not self._alloc_pages_to(slot, upto):
            need = -(-upto // self.page_size)
            if need > self._pages_ever_free():
                raise ValueError(
                    f"request needs {need} pages but the pool can only "
                    f"ever free {self._pages_ever_free()}")
            raise PagePoolExhausted(
                f"kv page pool exhausted ({self.free_pages} pages free)")
        row = np.zeros((s_bucket // self.page_size,), np.int32)
        pages = self._slot_pages[slot]
        row[:min(len(pages), len(row))] = pages[:len(row)]
        logits, self.cache = llama.paged_prefill_into(
            self.params, tokens, lens, self.cfg, self.cache, row, slot,
            self.page_size)
        self._post_prefill(logits, [slot], [True])

    def _resolve_first(self, tok_in_row: np.ndarray) -> None:
        """Fold newly-admitted slots' first tokens (row 0 of an arriving
        block) into slot state, before the block's own samples."""
        while self._pending_first:
            slot = self._pending_first.popleft()
            s = self.slots[slot]
            t = int(tok_in_row[slot])
            if not s.live:
                continue
            s.tokens.append(t)
            if t in self._eos:
                s.eos_hit = True
            if s.callback is not None:
                s.callback(slot, [t])
            self._maybe_finish(slot)

    def _maybe_finish(self, i: int) -> None:
        s = self.slots[i]
        if s.live and (s.produced >= s.max_new or s.eos_hit
                       or s.prompt_len + s.produced >= self.max_seq):
            s.live = False

    # -- decode ---------------------------------------------------------------
    def step(self) -> None:
        """Dispatch one chunk of decode steps, then process the PREVIOUS
        chunk's tokens (host bookkeeping lags one dispatch). With the
        token-budget scheduler, segmented prefill takes its planned share
        first (several segments when decode is light), then decode
        dispatches the ladder entry that fills the rest. While first tokens
        are pending the dispatch is the 1-step mini-chunk, read back at
        once (TTFT)."""
        if self.n_live == 0:
            self.drain()
            return
        sched = self.scheduler
        n_steps, n_segments = self.chunk, 1
        if sched is not None:
            n_steps, n_segments = sched.plan(self._n_decodable(),
                                             bool(self._chunked))
        if self._chunked:
            self._advance_chunked(max(n_segments, 1))
            if not self._decodable():
                return  # everything live is still mid-prefill
        mini = bool(self._pending_first)
        if mini:
            n_steps = 1
            if sched is not None:
                sched.mini_dispatches += 1
        elif sched is not None:
            sched.note_dispatch(n_steps)
        if self.page_size:
            self._grow_pages()
        block = self._decode_chunk(n_steps)
        self.steps += n_steps
        self._inflight.append(_HostBlock(block))
        if mini:
            self.drain()
        else:
            while len(self._inflight) > 1:
                self._pop_process()

    def drain(self) -> None:
        """Flush pending token blocks into host bookkeeping."""
        while self._inflight:
            self._pop_process()

    def _pop_process(self) -> None:
        self._process(self._inflight.popleft().numpy())

    def _apply_burst(self, i: int, s: _Slot, col: np.ndarray,
                     bursts: dict) -> None:
        """Fold one slot's token COLUMN (step order) into slot state: cap at
        the slot's remaining budget, truncate at the first eos."""
        cap = min(len(col), s.max_new - s.produced,
                  self.max_seq - s.prompt_len - s.produced)
        if cap <= 0:
            self._maybe_finish(i)
            return
        col = col[:cap]
        if self._eos_arr is not None:
            hits = np.nonzero(np.isin(col, self._eos_arr))[0]
            if hits.size:
                col = col[:int(hits[0]) + 1]
                s.eos_hit = True
        burst = col.tolist()
        s.tokens.extend(burst)
        s.produced += len(burst)
        if s.callback is not None:
            bursts.setdefault(i, []).extend(burst)
        self._maybe_finish(i)

    def _process(self, toks: np.ndarray) -> None:
        """Apply one [1 input + chunk sampled, B] block to slot state;
        callbacks fire once per slot per block with the slot's burst."""
        self._resolve_first(toks[0])
        body = toks[1:]
        bursts: dict[int, list[int]] = {}
        for i, s in enumerate(self.slots):
            if not s.live or i in self._chunked:
                continue  # mid-prefill rows decode garbage; drop it
            self._apply_burst(i, s, body[:, i], bursts)
        for i, burst in bursts.items():
            cb = self.slots[i].callback
            if cb is not None:
                cb(i, burst)

    def release(self, i: int) -> None:
        """Return a finished slot (and its own pages) to the free pool."""
        if self.slots[i].live:
            raise RuntimeError(f"slot {i} still decoding")
        self._chunked.pop(i, None)
        if i in self._chunked_order:  # a stale entry would later hand the
            self._chunked_order.remove(i)  # slot's NEW occupant a kill
        if self.page_size:
            self._free_slot_pages(i)
        self.slots[i] = _Slot()

    def generate(self, prompt_ids, max_new_tokens: int = 32) -> list[int]:
        """Blocking single-request convenience: returns generated ids."""
        i = self.add_request(prompt_ids, max_new_tokens)
        while self.slots[i].live:
            self.step()
        self.drain()
        out = self.slots[i].tokens[:max_new_tokens]
        self.release(i)
        return out
