"""Continuous-batching token generation — counterpart of the dense-cache path
of ``gofr_tpu/ml/generate.py``.

``Generator`` holds a fixed batch of slots over one dense KV cache
[L, B, S_max, KV, D]; every decode dispatch runs the whole batch (free slots
decode garbage that is ignored). As in the JAX package:

- requests admit in WAVES: one batched prefill (``prefill_into_many``) per
  wave, shape-bucketed in rows (1 or the admission cap, padding rows masked)
  and in prompt length (the prefill buckets);
- a dispatch runs ``chunk`` decode+sample steps (the ladder entry the
  token-budget scheduler picks) and returns a token block [chunk + 1, B]
  whose row 0 is the INPUT token row — that is how the first tokens sampled
  at admission reach the host; while first tokens are pending the dispatch
  is the 1-step mini-chunk (TTFT);
- host bookkeeping lags one dispatch behind the device (the lag-one
  pipeline): a block is copied to a pinned host buffer with
  ``non_blocking=True`` behind a CUDA event, and read only when the next
  dispatch is on its way.

What differs: PyTorch runs eagerly, so a dispatch is a Python loop of
``decode_step`` calls and there is nothing to compile (``warmup`` builds the
CUDA kernels and runs each shape once). Sampling draws from one
``torch.Generator`` stream instead of ``fold_in(key, step)``: greedy output
matches the JAX package token for token, sampled output by distribution.

Paged caches, chunked prefill, speculation, fused windows, the dispatch
pipeline at depth 2, sequence parallelism and the host KV tier raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import collections
from typing import Any

import numpy as np
import torch

from .. import resolve_device
from ..models import llama
from .scheduler import TokenBudgetScheduler

__all__ = ["Sampler", "greedy", "Generator"]

NEG_INF = -1e30


def _chunk_ladder(chunk: int) -> tuple[int, ...]:
    """Power-of-two dispatch sizes up to ``chunk`` (always including 1 and
    ``chunk`` itself). 16 -> (1, 2, 4, 8, 16); 3 -> (1, 2, 3)."""
    ladder = [1]
    while ladder[-1] * 2 < chunk:
        ladder.append(ladder[-1] * 2)
    if chunk > 1:
        ladder.append(chunk)
    return tuple(ladder)


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
                 "eos_hit", "callback")

    def __init__(self) -> None:
        self.live = False
        self.tokens: list[int] = []
        self.max_new = 0
        self.produced = 0
        self.prompt_len = 0
        self.eos_hit = False
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
    """Continuous-batching decode loop over a fixed slot batch (dense KV
    cache). Synchronous: ``LLMServer`` drives it from its serving thread.

        gen = Generator(params, cfg, batch_slots=8, max_seq=2048)
        out = gen.generate(prompt_ids, max_new_tokens=64)   # one request
        # or: slot = gen.add_request(ids, n, cb); gen.step() in a loop

    ``device`` defaults to the first CUDA card and raises when there is none;
    pass ``device="cpu"`` to run the plain PyTorch path on the host.
    ``params`` must already live on that device.
    """

    def __init__(self, params: Any, cfg, *, batch_slots: int = 8,
                 max_seq: int = 2048, sampler: Sampler | None = None,
                 eos_id: int | None = None, prefill_buckets=(128, 512, 2048),
                 seed: int = 0, chunk: int = 1, token_budget: int | None = None,
                 page_size: int = 0, prefill_chunk: int = 0, spec_k: int = 0,
                 decode_window: int = 0, pipeline: int = 0, sp: Any = None,
                 host_kv: Any = None, device=None) -> None:
        for value, what, item in (
                (page_size, "paged KV (page_size)", "A.8"),
                (prefill_chunk, "chunked prefill (prefill_chunk)", "A.7"),
                (spec_k, "speculative decoding (spec_k)", "A.10"),
                (decode_window, "fused decode windows", "A.9"),
                (pipeline, "the depth-2 dispatch pipeline", "A.9"),
                (sp, "sequence-parallel serving (sp)", "A.11"),
                (host_kv, "the host KV tier (host_kv)", "A.8")):
            if value:
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP {item})")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the generator on {self.device}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
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
        # auto budget: twice the full batch's chunk, so plan() picks `chunk`
        # at any occupancy (the JAX auto rule without chunked prefill)
        if token_budget is None:
            token_budget = 2 * self.chunk * batch_slots
        self.scheduler = (TokenBudgetScheduler(token_budget,
                                               self._chunk_ladder)
                          if token_budget > 0 else None)
        # admission-wave row buckets: 1 (the trickle) and the cap (bursts)
        self._admit_cap = min(8, batch_slots)

    # -- device programs -----------------------------------------------------
    def _decode_chunk(self, n_steps: int) -> torch.Tensor:
        """``n_steps`` fused decode+sample steps from the device token row.
        Returns the [n_steps + 1, B] block, row 0 the input row."""
        tok = self._tok_dev
        rows = [tok]
        for _ in range(n_steps):
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
        idx = torch.as_tensor([int(slots[i]) for i in rows],
                              dtype=torch.long).to(self.device)
        src = torch.as_tensor(rows, dtype=torch.long).to(self.device)
        self._tok_dev[idx] = firsts[src]

    def warmup(self) -> None:
        """Build the CUDA kernels and run every dispatch shape once — the
        decode chunk, the 1-step mini-chunk, each prefill bucket as a single
        and as a wave — before the first request. All slots are dead, so
        nothing reaches bookkeeping; admission overwrites what this writes."""
        if any(s.live for s in self.slots):
            raise RuntimeError("warmup needs an idle generator")
        for n in sorted({self.chunk, 1}):
            self._decode_chunk(n)
        for bucket in self.prefill_buckets:
            for b in sorted({1, self._admit_cap}):
                logits, self.cache = llama.prefill_into_many(
                    self.params, np.zeros((b, bucket), np.int32),
                    np.ones((b,), np.int32), self.cfg, self.cache,
                    np.zeros((b,), np.int32), np.zeros((b,), bool))
                self._post_prefill(logits, [0] * b, [False] * b)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- request management ---------------------------------------------------
    def free_slot(self) -> int | None:
        for i, s in enumerate(self.slots):
            if not s.live:
                return i
        return None

    @property
    def n_live(self) -> int:
        return sum(s.live for s in self.slots)

    def add_request(self, prompt_ids, max_new_tokens: int,
                    callback=None) -> int:
        """Prefill the prompt into a free slot; returns the slot index.
        ``callback(slot, tokens)`` receives each arriving BURST of sampled
        tokens (the slot's share of one processed chunk)."""
        return self.add_requests([(prompt_ids, max_new_tokens, callback)])[0]

    def add_requests(self, requests) -> list[int]:
        """Admit a WAVE of requests — ``[(prompt_ids, max_new, callback)]`` —
        with as few prefill dispatches as possible. All or nothing: when it
        raises, no slot of this call stays admitted. First tokens stay on
        the device and reach the host in row 0 of the next decode block."""
        self.drain()  # settle bookkeeping before reusing slots
        prepped = []
        for prompt_ids, max_new, callback in requests:
            ids = np.asarray(prompt_ids, np.int32).reshape(-1)
            n = len(ids)
            if n == 0 or n >= self.max_seq:
                raise ValueError(
                    f"prompt length {n} out of range (1..{self.max_seq - 1})")
            if ids.min() < 0 or ids.max() >= self.cfg.vocab_size:
                raise ValueError(
                    f"token ids must lie in [0, {self.cfg.vocab_size})")
            prepped.append((ids, n, int(max_new), callback))
        free = sum(1 for s in self.slots if not s.live)
        if len(prepped) > free:
            raise RuntimeError(f"no free generation slot ({len(prepped)} "
                               f"requested, {free} free)")
        out: list[int] = []
        try:
            return self._admit_waves(prepped, out)
        except Exception:
            dead = set(out)
            for j in dead:
                self.slots[j].live = False
            self._pending_first = collections.deque(
                s for s in self._pending_first if s not in dead)
            raise

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
                logits, self.cache = llama.prefill_into_many(
                    self.params, tokens, lens, self.cfg, self.cache,
                    slot_arr, valid)
                self._post_prefill(logits, slot_arr, valid)
                self.prefill_waves += 1
            except Exception:
                for j in slots:  # unwind this wave's reservations
                    self.slots[j].live = False
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
        chunk's tokens (host bookkeeping lags one dispatch). While first
        tokens are pending the dispatch is the 1-step mini-chunk, read back
        at once (TTFT)."""
        if self.n_live == 0:
            self.drain()
            return
        sched = self.scheduler
        mini = bool(self._pending_first)
        if mini:
            n_steps = 1
            if sched is not None:
                sched.mini_dispatches += 1
        elif sched is not None:
            n_steps = sched.plan(self.n_live)
        else:
            n_steps = self.chunk
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
            if s.live:
                self._apply_burst(i, s, body[:, i], bursts)
        for i, burst in bursts.items():
            cb = self.slots[i].callback
            if cb is not None:
                cb(i, burst)

    def release(self, i: int) -> None:
        """Return a finished slot to the free pool."""
        if self.slots[i].live:
            raise RuntimeError(f"slot {i} still decoding")
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
