"""Continuous-batching token generation — counterpart of
``gofr_tpu/ml/generate.py``.

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
- fused decode windows (``decode_window`` / ``GOFR_ML_DECODE_WINDOW``,
  paged only): a dispatch is a window of up to K steps whose per-row
  early-exit masks (EOS, the row's remaining budget, its deadline) freeze
  finished rows on the device; the ladder entries become window sizes;
- host bookkeeping lags one dispatch behind the device (the lag-one
  pipeline), or two with ``pipeline`` / ``GOFR_ML_PIPELINE``: a block is
  copied to a pinned host buffer with ``non_blocking=True`` behind a CUDA
  event, and read only when the next dispatch is on its way;
- the page pool: page 0 is scratch, a slot's pages grow ahead of decode
  (``_grow_pages``), a dry pool truncates the growing slot (``evictions``)
  instead of corrupting another, and admission without pages raises
  ``PagePoolExhausted`` (transient: the server requeues);
- shared prefixes: ``register_prefix`` computes a prefix's whole pages
  once; ``add_request(prefix=)`` borrows them and prefills only the
  partial-page tail plus the suffix; idle prefixes are a cache that pool
  pressure evicts (unpinned first, least recently used), into the host KV
  tier when one is on (``host_kv`` / ``GOFR_ML_KV_HOST_BUDGET_MB``,
  ``kv_offload.py``), from which ``restore_prefix`` brings them back;
- chunked prefill: with ``prefill_chunk`` a longer prompt prefills in
  segments between decode dispatches, as many a dispatch as the
  scheduler's budget leaves, so live streams keep their cadence.

What differs: on a card every decode dispatch shape (a ladder entry, and
with paging the gather width) is captured once as a CUDA graph
(``graphs.py``; at ``warmup`` or at first use) and each dispatch is one
replay: the counterpart of JAX's compiled chunk and window programs.
Prefill stays eager (its shapes vary). A graph has no branch, so a window
runs all its K steps and counts on the device the steps in which any row
was active (``realized``), where JAX skips the sweep once every row is
frozen; the tokens are the same. On the CPU the same bodies run eagerly.
The page table's device copy is one persistent buffer, rewritten in place
only when a slot's pages change, and a paged step gathers only the table
columns its live rows use (rounded up to a power of two of pages, so the
shapes stay few). Sampling draws from one ``torch.Generator`` stream
instead of ``fold_in(key, step)``: greedy output matches the JAX package
token for token, sampled output by distribution.

The serving watchdog's half lives here as in JAX: ``recover`` resets
decode state after a crash (in place: the graphs keep their pointers),
the ``fault`` hook fires at the ``step``, ``prefill``, ``spill`` and
``restore`` points, and the ``recorder`` (flight recorder), ``goodput``
(ledger handle) and ``programs`` (inventory) record what the dispatches
do; the server installs all but the last.

Speculative decoding (``spec_k`` / ``GOFR_ML_SPEC_K``, greedy only) runs
inside the dispatch, as in JAX: each of a dispatch's windows drafts K
tokens a row (prompt lookup over the row's device-resident history
[B, max_seq + K + 2] with masked compares, or a draft model's K greedy
steps over its own dense cache), verifies them in one K+1-position pass
(``llama.decode_window`` / ``paged_decode_window``, the decode kernels'
window launch), accepts the longest matching prefix, emits it and the
verifier's next token, advances ``len`` by 1 + accepted and appends the
tokens to the history row, all on the device: one CUDA graph a (ladder
entry, gather width), the ladder entries counting verify windows. Per
slot, a rolling accept rate under ``spec_min_accept`` /
``GOFR_ML_SPEC_MIN_ACCEPT`` disables speculation for ``spec_cooldown`` /
``GOFR_ML_SPEC_COOLDOWN`` windows (lossless: a disabled row emits its
verified token); with every decodable slot disabled in lookup mode the
whole dispatch takes the plain ladder, and the history rows are reseeded
from a host mirror before speculation re-probes. Fused windows and the
pipeline compose with it.

Sequence-parallel serving (``sp`` / ``GOFR_ML_SP``, planned by
``sp_serving.resolve`` over ``mesh`` or the visible cards): a prompt of at
least ``GOFR_ML_SP_MIN_TOKENS`` that fits a prefill bucket prefills whole
through ring or Ulysses attention across the mesh's sp shards, a shorter
one through the single-device prefill (the dual path); the dense cache
splits its sequence axis over the shards and decodes through
``sp_decode_attention``, a paged one stripes its pool (one free stack a
shard, pages handed out round-robin) and decodes through
``llama.sp_paged_decode_step``. Each shard's state is one tensor on its
device (``parallel.ShardedTensor``); weights and activations stay on the
generator's device, the mesh's first. A fault in an SP prefill
(``sp_prefill`` / ``sp_gather``) falls back to the single-device prefill
of the same rows or pages, bit for bit. The decode dispatches of an SP
generator run eagerly, on a card too (no CUDA graphs: their bodies move
data between the shards' devices). A bare sequence-parallel ``cfg``
(``attn_impl``) with a ``mesh`` runs JAX's all-or-nothing switch: every
prefill sequence-parallel, the dense cache split.

Tensor-parallel serving: params split by ``llama.SHARDING_RULES``
(``parallel.shard_params`` over a mesh with tp > 1; a replica over a
device subset and a mesh rank over several devices do it) make the
Generator build its cache, dense or paged, split by KV head over the
params' shards (``mesh`` defaults to a tp mesh of them; ``shard_cache``
is accepted as in JAX and needs a mesh); prefill, segments, windows,
prefix hits and the host tier run through the model's tensor-parallel
path, and decode runs eagerly (no CUDA graphs: a graph cannot span
cards). Speculation over split weights verifies its windows through the
same path, each shard's window launch over its KV-head block; a draft
model over split weights (the ``self`` draft) gets a draft cache split
the same way. Sequence parallelism over split weights (a mesh with sp
and tp > 1, the dense cache) runs each tp shard's heads through ring or
Ulysses over its own row of the mesh, its cache block split by sequence
over that row, and the decode combine a shard at a time; the striped
pool refuses a mesh with tp > 1, as JAX's plan does.
"""

from __future__ import annotations

import collections
import logging
import os
import time
from typing import Any

import numpy as np
import torch

from .. import parallel as par
from .. import resolve_device
from ..models import llama
from .graphs import DecodeGraphs
from .kv_offload import HostKVStore
from .programs import ProgramLog, model_cost
from .scheduler import TokenBudgetScheduler

__all__ = ["Sampler", "greedy", "Generator", "PagePoolExhausted",
           "PrefixEvicted", "DecodeWindowUnsupported",
           "decode_window_from_env", "pipeline_from_env", "spec_k_from_env"]

NEG_INF = -1e30

_log = logging.getLogger(__name__)


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


def _env_int(name: str, default: int, *, minimum: int = 0) -> int:
    """Loudly-validated integer env knob: a malformed value or one below
    ``minimum`` raises ValueError naming the knob."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}") from None
    if value < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {value}")
    return value


def _env_fraction(name: str, default: float) -> float:
    """Loudly-validated [0, 1] float env knob: a malformed value, a
    negative one, one over 1 or NaN raises ValueError naming the knob."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = float(raw)
    except ValueError:
        raise ValueError(
            f"{name} must be a number in [0, 1], got {raw!r}") from None
    if not 0.0 <= value <= 1.0:  # NaN fails both compares
        raise ValueError(f"{name} must be in [0, 1], got {raw!r}")
    return value


def spec_k_from_env(default: int = 0) -> int:
    """``GOFR_ML_SPEC_K`` with loud validation (the JAX package's parse)."""
    return _env_int("GOFR_ML_SPEC_K", default)


# the K "auto" resolves to: big enough that a window amortizes the host's
# round trip per launch, small enough that early-exit waste past a short
# answer stays a fraction of the window
_WINDOW_AUTO = 32


def decode_window_from_env(default: int = 0) -> int:
    """``GOFR_ML_DECODE_WINDOW`` — the fused-decode-window size K (one
    dispatch runs up to K sampling steps). Accepts ``0``/``off`` (the
    single-step dispatch, the default), ``auto`` (``_WINDOW_AUTO``), or a
    power-of-two K; anything else raises ValueError naming the knob."""
    raw = os.environ.get("GOFR_ML_DECODE_WINDOW", "").strip().lower()
    if not raw:
        return default
    if raw in ("0", "off"):
        return 0
    if raw == "auto":
        return _WINDOW_AUTO
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(
            f"GOFR_ML_DECODE_WINDOW must be an integer, 'auto', or "
            f"'off', got {raw!r}") from None
    if value < 1 or value & (value - 1):
        raise ValueError(
            f"GOFR_ML_DECODE_WINDOW must be a power of two >= 1 "
            f"(or 0/off/auto), got {value}")
    return value


def pipeline_from_env(default: int = 0) -> int:
    """``GOFR_ML_PIPELINE`` — double-buffered dispatch: ``1``/``on`` keeps
    TWO decode dispatches in flight (dispatch N+1 is enqueued before the
    host reads N), ``0``/``off``/unset the lag-one pipeline. Anything else
    raises ValueError naming the knob."""
    raw = os.environ.get("GOFR_ML_PIPELINE", "").strip().lower()
    if not raw:
        return default
    if raw in ("0", "off"):
        return 0
    if raw in ("1", "on"):
        return 1
    raise ValueError(
        f"GOFR_ML_PIPELINE must be 0/off or 1/on, got {raw!r}")


class DecodeWindowUnsupported(ValueError):
    """Fused decode windows require the paged KV cache: the early-exit
    loop freezes a finished row by holding its ``len`` in place, which the
    JAX package allows only for the page pool."""


def _upload(dst: torch.Tensor, src: np.ndarray) -> None:
    """Host array -> the persistent device tensor ``dst``, in place. To a
    card the copy goes through fresh pinned memory without blocking (the
    pinned block is not reused before the copy ran)."""
    t = torch.from_numpy(np.ascontiguousarray(src))
    if dst.device.type == "cuda":
        t = t.pin_memory()
    dst.copy_(t, non_blocking=True)


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
                 "eos_hit", "evicted", "callback", "deadline_at",
                 "spec_windows", "spec_emitted", "spec_disabled",
                 "spec_cooldown_left", "spec_recent_w", "spec_recent_e",
                 "hist", "sp_shards")

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
        # the request's deadline (``time.perf_counter`` seconds, set by the
        # server): fused windows bound a row's device steps by it
        self.deadline_at: float | None = None
        # speculation: verify windows seen and tokens they emitted (the
        # server exports the stream's accept rate), and the adaptive
        # disable: the flag, the cooldown left and the judging window
        self.spec_windows = 0
        self.spec_emitted = 0
        self.spec_disabled = False
        self.spec_cooldown_left = 0
        self.spec_recent_w = 0
        self.spec_recent_e = 0
        # the host mirror of the full history (prompt + emitted), kept only
        # when the plain-ladder fallback is armed: it reseeds the device
        # history rows when speculation re-probes
        self.hist: list[int] = []
        # the shard count that prefilled this slot sequence-parallel (0:
        # the single-device path); journey marks and the sp block read it
        self.sp_shards = 0


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
    segments. ``decode_window``, ``pipeline``, ``spec_k`` and
    ``token_budget`` left at None read ``GOFR_ML_DECODE_WINDOW``,
    ``GOFR_ML_PIPELINE``, ``GOFR_ML_SPEC_K`` and ``GOFR_ML_TOKEN_BUDGET``,
    and ``host_kv`` left at None reads ``GOFR_ML_KV_HOST_BUDGET_MB``, as
    the JAX Generator does. ``device`` defaults to the first CUDA card and
    raises when there is none; pass ``device="cpu"`` to run the plain
    PyTorch path on the host. ``params`` must already live on that
    device.
    """

    def __init__(self, params: Any, cfg, *, batch_slots: int = 8,
                 max_seq: int = 2048, sampler: Sampler | None = None,
                 eos_id: int | None = None, prefill_buckets=(128, 512, 2048),
                 seed: int = 0, chunk: int = 1, token_budget: int | None = None,
                 page_size: int = 0, n_pages: int | None = None,
                 prefill_chunk: int = 0, spec_k: int | None = None,
                 spec_ngram: int = 3, spec_min_accept: float | None = None,
                 spec_cooldown: int | None = None, draft_params: Any = None,
                 draft_cfg: Any = None, decode_window: int | None = None,
                 pipeline: int | None = None, sp: Any = None,
                 host_kv: Any = None, mesh=None, shard_cache: bool = False,
                 device=None) -> None:
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.chunk = chunk
        # -- fused decode windows: None -> GOFR_ML_DECODE_WINDOW (0 = off).
        # Window mode re-points ``chunk`` at K, so the ladder entries become
        # window sizes and the scheduler and page growth follow unchanged.
        if decode_window is None:
            decode_window = decode_window_from_env(0)
        self.decode_window = int(decode_window)
        if self.decode_window < 0 or (
                self.decode_window and
                self.decode_window & (self.decode_window - 1)):
            raise ValueError(
                f"decode_window must be 0 or a power of two, got "
                f"{self.decode_window}")
        if self.decode_window:
            if not page_size:
                raise DecodeWindowUnsupported(
                    "fused decode windows (GOFR_ML_DECODE_WINDOW="
                    f"{self.decode_window}) require the paged KV cache — "
                    "set page_size > 0")
            self.chunk = self.decode_window
            # window-mode-only state: none of it exists with the knob off
            self.windows = 0                  # windows processed
            self.window_steps_planned = 0     # sum of dispatched K
            self.window_steps_realized = 0    # steps in which a row was active
            self.window_overshoot = 0         # tokens computed past a row's
            #                                   end (budget, EOS, death)
            self._step_ema: float | None = None  # s per planned step
            self._last_dispatch: tuple | None = None
        # -- double-buffered dispatch: None -> GOFR_ML_PIPELINE (0 = off)
        if pipeline is None:
            pipeline = pipeline_from_env()
        self.pipeline = 1 if pipeline else 0
        if self.pipeline:
            # pipeline-only state: none of it exists with the knob off
            self.pipeline_windows = 0    # passes that ended double-buffered
            self.pipeline_overshoot = 0  # tokens computed for slots already
            #                              dead when their block settled
        # -- speculation: None -> GOFR_ML_SPEC_K (0 = off)
        if spec_k is None:
            spec_k = spec_k_from_env(0)
        self.spec_k = int(spec_k)
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {self.spec_k}")
        # below this rolling accept rate a slot stops speculating (0: never)
        # and re-probes after spec_cooldown windows
        self.spec_min_accept = (
            _env_fraction("GOFR_ML_SPEC_MIN_ACCEPT", 0.0)
            if spec_min_accept is None else float(spec_min_accept))
        if not 0.0 <= self.spec_min_accept <= 1.0:
            raise ValueError(
                f"spec_min_accept must be in [0, 1], got "
                f"{self.spec_min_accept}")
        self.spec_cooldown = (_env_int("GOFR_ML_SPEC_COOLDOWN", 32,
                                       minimum=1)
                              if spec_cooldown is None
                              else int(spec_cooldown))
        if self.spec_cooldown < 1:
            raise ValueError(
                f"spec_cooldown must be >= 1, got {self.spec_cooldown}")
        self._spec_probe_min = 8  # windows judged before a disable verdict
        self.spec_disables = 0    # slots auto-disabled (lifetime)
        self.spec_reprobes = 0    # cooldown expiries re-arming a slot
        self._plain_armed = False  # set in _init_spec (lookup mode only)
        self._spec_rows_stale = False  # device history lags the mirror
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the generator on {self.device}")
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
        # EOS membership on the device: the window's early exit and the
        # host's truncation (``_apply_burst``) agree exactly
        self._eos_dev = (torch.as_tensor(sorted(self._eos), dtype=torch.int32,
                                         device=self.device)
                         if self._eos else None)
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
        self.host_kv = None
        # -- the sequence-parallel serving plan (sp_serving.py): sp=None
        # reads GOFR_ML_SP, and unset or off builds no SP machinery; every
        # bad combination raises here, before any dispatch
        from .sp_serving import resolve as _resolve_sp

        self._sp = _resolve_sp(
            sp, cfg=cfg, mesh=mesh, prefill_buckets=self.prefill_buckets,
            max_seq=max_seq, page_size=self.page_size, spec_k=self.spec_k,
            shard_cache=shard_cache,
            devices=(par.visible_devices() if self.device.type == "cuda"
                     else [self.device]))
        if self._sp is not None:
            mesh = self._sp.mesh
            self.sp_prefills = 0    # prompts prefilled sequence-parallel
            self.sp_fallbacks = 0   # SP failures served single-device
            self.sp_tokens = 0      # prompt tokens through the SP path
        # -- tensor parallelism: params split by llama.SHARDING_RULES run
        # every block a shard at a time, over a cache split by KV head
        tp_devs = llama.tp_devices(params)
        self._tp = tp_devs is not None
        if shard_cache and mesh is None and not self._tp:
            raise ValueError("shard_cache requires a mesh")
        if self._tp:
            if mesh is None:
                mesh = par.make_mesh(par.MeshConfig(tp=len(tp_devs)),
                                     devices=tp_devs)
            elif mesh.shape.get("tp", 1) != len(tp_devs):
                raise ValueError(
                    f"params split {len(tp_devs)} ways over a mesh with "
                    f"tp={mesh.shape.get('tp', 1)}")
            local = cfg.n_heads // len(tp_devs)
            if (self._sp is not None and self._sp.mode == "ulysses"
                    and local % self._sp.shards):
                raise ValueError(
                    f"sp={self._sp.shards} must divide the local "
                    f"(per-tp-shard) head count {local}")
        elif (mesh is not None and mesh.shape.get("tp", 1) > 1
              and self._sp is None and not cfg.sequence_parallel):
            raise ValueError(
                "a mesh with tp > 1 needs params split over it: "
                "parallel.shard_params(params, llama.sharding_specs(params), "
                "mesh)")
        if mesh is not None and mesh.first != self.device:
            raise ValueError(
                f"the mesh's first device is {mesh.first}, the generator's "
                f"{self.device}: weights and activations live there")
        self.mesh = mesh
        # the dense cache splits its sequence axis over the mesh under a
        # plan or a bare sequence-parallel cfg; decode then attends with
        # the plan's cfg clone (or that cfg) through sp_decode_attention
        self._sp_dense = (not self.page_size and mesh is not None
                          and (self._sp is not None
                               or cfg.sequence_parallel))
        self._decode_cfg = (self._sp.sp_cfg
                            if self._sp is not None and not self.page_size
                            else cfg)
        if self.page_size:
            if shard_cache or (self._sp is None and mesh is not None
                               and cfg.sequence_parallel):
                raise ValueError(
                    "page_size composes with sequence parallelism only "
                    "through the serving plan (GOFR_ML_SP / sp=) — not "
                    "shard_cache or a bare cfg.attn_impl mesh")
            for b in (*self.prefill_buckets, max_seq):
                # max_seq included: it is the prefill-bucket fallback, and
                # a non-multiple would silently drop trailing prompt rows
                if b % self.page_size:
                    raise ValueError(
                        f"prefill bucket/max_seq {b} not a multiple of "
                        f"page_size")
            self._p_max = -(-max_seq // self.page_size)
            self.n_pages = n_pages or (1 + batch_slots * self._p_max)
            if self._sp is not None and self.n_pages % self._sp.shards:
                # striped pool: each shard owns n_pages / shards pages;
                # round UP so the capacity asked for stays a floor
                self.n_pages += self._sp.shards - (
                    self.n_pages % self._sp.shards)
            self.cache = llama.init_paged_cache(
                cfg, batch_slots, self.n_pages, self.page_size,
                device=self.device,
                mesh=self.mesh if self._sp is not None or self._tp else None)
            # page 0 is scratch; the free pool is ONE STACK A SHARD of real
            # pages (one stack unstriped), and the allocator round-robins
            # across them (_pop_free_page), so a slot's consecutive
            # virtual pages land on different shards
            n_stacks = self._sp.shards if self._sp is not None else 1
            self._free_dev: list[list[int]] = [[] for _ in range(n_stacks)]
            for pg in range(self.n_pages - 1, 0, -1):
                self._free_dev[self._page_stack(pg)].append(pg)
            self._stripe_rr = 0
            self._slot_pages: list[list[int]] = [[] for _ in
                                                 range(batch_slots)]
            self._table = np.zeros((batch_slots, self._p_max), np.int32)
            # the page table's device copy: ONE buffer for the generator's
            # life (the decode graphs read it), rewritten in place only when
            # a slot's pages change (never uploaded per step)
            self._table_dev = torch.zeros((batch_slots, self._p_max),
                                          dtype=torch.int32,
                                          device=self.device)
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
            # the host spill tier: None -> GOFR_ML_KV_HOST_BUDGET_MB (0 or
            # unset: off, evicted prefixes are discarded); False turns it
            # off; a HostKVStore is used as it is (an empty one is falsy)
            if host_kv is None:
                host_kv = HostKVStore.from_env()
            self.host_kv = host_kv if host_kv is not False else None
            self.kv_spills = 0             # prefixes copied card -> host
            self.kv_restores = 0           # prefixes copied host -> card
            self.kv_restore_fallbacks = 0  # restores lost to pool pressure
        else:
            self.cache = llama.init_cache(
                cfg, batch_slots, max_seq, device=self.device,
                mesh=self.mesh if self._sp_dense or self._tp else None,
                tp_heads=self._tp)
        self.slots = [_Slot() for _ in range(batch_slots)]
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        # the token row: decode reads and writes it in place (a graph input)
        self._tok_dev = torch.zeros((batch_slots,), dtype=torch.int32,
                                    device=self.device)
        if self.decode_window:
            # a window's per-row masks, written in place before each dispatch
            self._win_active = torch.zeros((batch_slots,), dtype=torch.bool,
                                           device=self.device)
            self._win_cap = torch.zeros((batch_slots,), dtype=torch.int32,
                                        device=self.device)
        # logits of the first step of the last decode dispatch (f32 [B, V]):
        # on a card the graph's own output, overwritten by its next replay
        self.dispatch_logits: torch.Tensor | None = None
        # an SP or a TP generator's dispatches run eagerly (module
        # docstring)
        self._graphs = (DecodeGraphs(self.device, self._rng, cfg.dtype)
                        if self.device.type == "cuda" and self._sp is None
                        and not self._sp_dense and not self._tp else None)
        self._inflight: collections.deque = collections.deque()
        self._pending_first: collections.deque[int] = collections.deque()
        self.steps = 0           # decode steps dispatched
        self.prefill_waves = 0   # batched prefill dispatches
        self._chunk_ladder = _chunk_ladder(self.chunk)
        # Token budget: None -> GOFR_ML_TOKEN_BUDGET ("auto"/unset: twice
        # the full batch's chunk, or one chunk of it plus two segments when
        # chunked prefill is on; "0" or negative: fixed-chunk dispatch).
        # A verify window costs K+1 positions a row (plan's unit_tokens),
        # so the auto budget scales by K+1 under speculation
        per_step = (self.spec_k + 1) if self.spec_k else 1
        if token_budget is None:
            raw = os.environ.get("GOFR_ML_TOKEN_BUDGET", "auto")
            token_budget = (max(2 * self.chunk * batch_slots * per_step,
                                self.chunk * batch_slots * per_step
                                + 2 * self.prefill_chunk)
                            if raw.strip().lower() in ("", "auto")
                            else int(raw))
        self.scheduler = (
            TokenBudgetScheduler(token_budget, self._chunk_ladder,
                                 self.prefill_chunk, slots=batch_slots)
            if token_budget > 0 else None)
        if self.scheduler is not None and self.decode_window:
            self.scheduler.window_mode = True  # entries are window sizes
        # admission-wave row buckets: 1 (the trickle) and the cap (bursts);
        # paged mode admits one request a wave, and so does SP mode (the
        # dual-path threshold is per prompt)
        self._admit_cap = (1 if self.page_size or self._sp is not None
                           else min(8, batch_slots))
        # -- serving instrumentation, installed by the LLMServer (None =
        # off, one attribute test a site): the fault hook (GOFR_ML_FAULT,
        # testutil/faults.py), the flight recorder's DispatchRecorder and
        # the goodput ledger's handle for this model
        self.fault = None
        self.recorder = None
        self.goodput = None
        self.restarts = 0  # successful crash recoveries (``recover``)
        # tokens the dispatches computed for admitted requests: each first
        # token, each token a live row applied, and every token a window's
        # active row emitted on the card — what the goodput ledger's
        # classes sum to once every slot is released
        self.tokens_computed = 0
        # the program inventory (programs.py): decode graphs and prefill
        # buckets with their capture or first-use seconds
        self.programs = ProgramLog()
        # -- speculative decoding (spec_k parsed above)
        self.spec_ngram = int(spec_ngram)
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError("draft_params and draft_cfg come together")
        if draft_params is not None and not self.spec_k:
            raise ValueError("a draft model requires spec_k > 0")
        if draft_cfg is not None and draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError("draft and target must share the vocabulary")
        if draft_cfg is not None and getattr(draft_cfg, "kv_quant", False):
            raise ValueError("the draft model uses the fp cache")
        if (draft_params is not None
                and draft_params["embed"].device != self.device):
            raise ValueError(f"draft params live on "
                             f"{draft_params['embed'].device}, the generator "
                             f"on {self.device}")
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        # lifetime windows and emitted tokens (emitted / windows - 1 is the
        # mean of accepted drafts a window)
        self.spec_windows = 0
        self.spec_emitted = 0
        if self.spec_k > 0:
            self._init_spec()

    def _init_spec(self) -> None:
        """The device state of speculation: the history rows [B, hist_cap
        + 1] (the last column takes the writes JAX drops), the per-row
        enable mask and, with a draft model, its dense fp cache sized past
        ``max_seq`` so the K+1 draft steps of the last window never clip.
        All are written in place: the spec graphs keep their pointers."""
        if self.sampler.temperature > 0:
            raise ValueError("speculative decode is greedy-only")
        K = self.spec_k
        self._hist_cap = self.max_seq + K + 2
        B = self.batch_slots
        self._tokens_dev = torch.zeros((B, self._hist_cap + 1),
                                       dtype=torch.int32, device=self.device)
        self._spec_on = torch.zeros((B,), dtype=torch.bool, device=self.device)
        if self.draft_params is not None:
            # a split draft (the target's own split weights) keeps its
            # cache split by KV head over the same devices
            d_tp = llama.tp_devices(self.draft_params)
            self._draft_cache = llama.init_cache(
                self.draft_cfg, B, self.max_seq + K + 2, device=self.device,
                mesh=None if d_tp is None else par.make_mesh(
                    par.MeshConfig(tp=len(d_tp)), devices=d_tp))
        # the plain fallback needs drafting state that survives plain
        # dispatches (the history mirror does, a draft cache does not) and
        # an auto-disable floor actually set
        self._plain_armed = (self.spec_min_accept > 0
                             and self.draft_params is None)

    # -- device programs -----------------------------------------------------
    def _run(self, key, body):
        """Run one decode dispatch: on a card the CUDA graph of ``key``
        (captured from ``body`` on first use) replayed once, on the CPU
        ``body`` itself. Returns ``body``'s outputs."""
        if self._graphs is None:
            name = self._program_name(key)
            if name in self.programs:
                return body()
            t0 = time.perf_counter()
            out = body()
            self._record_program(key, time.perf_counter() - t0, "eager")
            return out
        if key not in self._graphs:
            self._capture(key, body)
        return self._graphs.replay(key)

    @staticmethod
    def _program_name(key) -> str:
        """A dispatch's inventory name: ``decode/chunk<n>`` or
        ``decode/window<n>``, and ``spec/window<n>`` for a ladder entry of
        ``n`` verify windows (JAX's names), with the gather width."""
        kind, n, n_cols = key
        fam = "spec/window" if kind in ("spec", "specwin") else f"decode/{kind}"
        return f"{fam}{n}" + (f"/cols{n_cols}" if n_cols else "")

    def _capture(self, key, body) -> None:
        """Capture the graph of ``key`` and record its program row."""
        t0 = time.perf_counter()
        reserved0 = self._graphs.pool_reserved_bytes
        self._graphs.capture(key, body)
        self._record_program(key, time.perf_counter() - t0, "graph",
                             pool_bytes=self._graphs.pool_reserved_bytes
                             - reserved0)

    def _record_program(self, key, wall_s: float, kind: str, **extra) -> None:
        what, n, n_cols = key
        keys = (n_cols * self.page_size if n_cols else self.max_seq)
        # a verify window sweeps K+1 positions a row
        positions = n * (self.spec_k + 1) if what in ("spec", "specwin") else n
        self.programs.record(
            self._program_name(key), wall_s=wall_s, kind=kind,
            shapes={"rows": self.batch_slots, "steps": n,
                    "cols": n_cols, "dispatch": what},
            cost=model_cost(self.cfg, self.batch_slots, positions, keys),
            **extra)

    def _model_step(self, tok: torch.Tensor, n_cols: int | None):
        """One decode step of the model over the whole batch; the cache is
        updated in place. Returns the f32 logits [B, V]. A striped pool
        decodes through ``sp_paged_decode_step``; a split dense cache
        through ``decode_step``'s sequence-parallel combine."""
        if self.page_size and self._sp is not None:
            logits, _ = llama.sp_paged_decode_step(
                self.params, tok, self.cache, self._table_dev, self.cfg,
                self.mesh, n_cols=n_cols)
        elif self.page_size:
            logits, _ = llama.paged_decode_step(
                self.params, tok, self.cache, self._table_dev, self.cfg,
                n_cols=n_cols)
        else:
            logits, _ = llama.decode_step(self.params, tok, self.cache,
                                          self._decode_cfg, mesh=self.mesh)
        return logits

    def _chunk_body(self, n_steps: int, n_cols: int | None):
        """``n_steps`` fused decode+sample steps from the token row: the
        [n_steps + 1, B] block (row 0 the input row) and the first step's
        logits. The row ends holding the last samples."""
        tok = self._tok_dev
        rows, first = [tok], None
        for _ in range(n_steps):
            logits = self._model_step(tok, n_cols)
            first = logits if first is None else first
            tok = _sample_impl(logits, self._rng, self.sampler)
            rows.append(tok)
        block = torch.stack(rows)  # copies row 0 before the row moves on
        self._tok_dev.copy_(tok)
        return block, first

    def _is_eos(self, t: torch.Tensor) -> torch.Tensor:
        if self._eos_dev is None:
            return torch.zeros_like(t, dtype=torch.bool)
        return (t[:, None] == self._eos_dev).any(-1)

    def _window_body(self, n_win: int, n_cols: int):
        """One FUSED window of ``n_win`` steps (``make_window_fn`` in the
        JAX package). ``_win_active`` [B] names the rows that may decode,
        ``_win_cap`` [B] the tokens each may still emit; a row freezes on
        the device at EOS or its cap — its token and ``len`` stop moving —
        and the step it then computes writes past its ``len``, where
        nothing reads. Returns ([n_win + 3, B] int32: the block with row 0
        the input row, then ``n_out`` [B], then ``realized`` — the steps in
        which any row was active — in every column; the first step's
        logits)."""
        tok = self._tok_dev
        length = self.cache["len"]
        active = (self._win_active & ~self._is_eos(tok)
                  & (self._win_cap > 0))
        n_out = torch.zeros_like(tok)
        realized = torch.zeros_like(tok[:1])
        rows, first = [tok], None
        for _ in range(n_win):
            realized = realized + active.any().to(torch.int32)
            len0 = length.clone()
            logits = self._model_step(tok, n_cols)
            first = logits if first is None else first
            nxt = torch.where(active,
                              _sample_impl(logits, self._rng, self.sampler),
                              tok)
            length.copy_(torch.where(active, length, len0))
            n_out = n_out + active.to(torch.int32)
            active = active & ~self._is_eos(nxt) & (n_out < self._win_cap)
            tok = nxt
            rows.append(nxt)
        out = torch.cat([torch.stack(rows), n_out[None],
                         realized.expand(tok.shape[0])[None]])
        self._tok_dev.copy_(tok)
        return out, first

    def _decode_chunk(self, n_steps: int, n_cols: int | None = None
                      ) -> torch.Tensor:
        """Dispatch ``n_steps`` decode+sample steps; returns the
        [n_steps + 1, B] block. A paged step gathers ``n_cols`` table
        columns (default: what the live rows hold, ``_gather_cols``)."""
        if self.page_size:
            self._table_device()
            n_cols = n_cols or self._gather_cols()
        block, self.dispatch_logits = self._run(
            ("chunk", n_steps, n_cols),
            lambda: self._chunk_body(n_steps, n_cols))
        return block

    def _decode_window(self, n_win: int, active0: np.ndarray,
                       step_cap: np.ndarray, n_cols: int | None = None
                       ) -> torch.Tensor:
        """Dispatch one fused window under the masks ``active0`` and
        ``step_cap`` (``_plan_window``); returns ``_window_body``'s packed
        [n_win + 3, B] block."""
        self._table_device()
        n_cols = n_cols or self._gather_cols()
        _upload(self._win_active, active0)
        _upload(self._win_cap, step_cap)
        out, self.dispatch_logits = self._run(
            ("window", n_win, n_cols),
            lambda: self._window_body(n_win, n_cols))
        return out

    # -- speculation on the device ------------------------------------------
    def _draft_lookup(self, h: torch.Tensor) -> torch.Tensor:
        """Prompt-lookup drafts [B, K] from the history rows (JAX's
        ``draft_row`` over every row at once): for n from ``spec_ngram``
        down to 1, the most recent earlier occurrence of each row's
        trailing n-gram (history length ``h`` [B]) by masked compares over
        [B, hist_cap]; the longest n with a match wins and its K following
        tokens are the draft; no match drafts from the last token. No host
        sync, so it captures into the graph."""
        hc, K = self._hist_cap, self.spec_k
        hist = self._tokens_dev[:, :hc]
        b = hist.shape[0]
        dev = hist.device
        h = h.long()
        idx = torch.arange(hc, device=dev)[None, :]
        start = torch.full((b,), -1, dtype=torch.long, device=dev)
        npick = torch.zeros((b,), dtype=torch.long, device=dev)
        for n in range(max(1, self.spec_ngram), 0, -1):
            at = (torch.clamp(h - n, min=0)[:, None]
                  + torch.arange(n, device=dev)[None, :])
            pat = hist.gather(1, at)
            # the follow token must exist INSIDE the history, which also
            # keeps the trailing pattern from matching itself
            m = (idx + n) <= (h[:, None] - 1)
            for i in range(n):
                shifted = torch.cat([hist[:, i:], hist[:, -1:].expand(b, i)],
                                    dim=1)  # hist[min(idx + i, hc - 1)]
                m = m & (shifted == pat[:, i:i + 1])
            j = torch.where(m, idx, -1).amax(dim=1)
            take = (start < 0) & (j >= 0)
            start = torch.where(take, j, start)
            npick = torch.where(take, n, npick)
        src = torch.where(start >= 0, start + npick, h - 1)
        src = torch.clamp(src, 0, hc - K)
        return hist.gather(1, src[:, None]
                           + torch.arange(K, device=dev)[None, :])

    def _run_draft_model(self, tok: torch.Tensor) -> torch.Tensor:
        """K greedy draft steps from the window's input token, plus one
        step that writes the last draft's K/V row (a fully accepted window
        needs it in place): the drafts [B, K]. The draft cache is updated
        in place."""
        drafts = []
        t = tok
        for _ in range(self.spec_k):
            dlogits, _ = llama.decode_step(self.draft_params, t,
                                           self._draft_cache, self.draft_cfg)
            t = torch.argmax(dlogits, dim=-1).to(torch.int32)
            drafts.append(t)
        llama.decode_step(self.draft_params, t, self._draft_cache,
                          self.draft_cfg)
        return torch.stack(drafts, dim=1)

    def _spec_body(self, n_win: int, n_cols: int | None, windowed: bool):
        """``n_win`` draft -> verify -> accept rounds (JAX's
        ``spec_chunk_fn``, or with ``windowed`` its ``spec_window_fn``).
        Each round drafts K tokens a row, verifies [token, drafts] in one
        window, accepts the longest prefix of drafts equal to the
        verifier's argmax (none for a row off in ``_spec_on``), emits it
        and the verifier's next token, advances ``len`` by the emitted
        count and appends the tokens to the history row. Windowed, the
        rows of ``_win_active`` freeze on the device at EOS or their
        ``_win_cap``, a frozen row emitting nothing. Returns ([rows, B]
        int32: the input row, the counts [W, B], the emitted tokens [W *
        (K+1), B] (window-major, then position), and windowed the rounds in
        which any row was active; the first round's position-0 logits)."""
        K, hc = self.spec_k, self._hist_cap
        tok = self._tok_dev
        tok_in = tok.clone()
        length = self.cache["len"]
        td = self._tokens_dev
        b = tok.shape[0]
        dev = tok.device
        ar = torch.arange(K + 1, device=dev)[None, :]
        s_max = (self._p_max * self.page_size if self.page_size
                 else self.cache["k"].shape[2])
        spec_on = self._spec_on
        if windowed:
            active = (self._win_active & ~self._is_eos(tok)
                      & (self._win_cap > 0))
            n_out = torch.zeros_like(tok)
            realized = torch.zeros_like(tok[:1])
        emits, counts, first = [], [], None
        for _ in range(n_win):
            h = length + 1  # history length
            draft = (self._run_draft_model(tok) if self.draft_params is not None
                     else self._draft_lookup(h))
            window = torch.cat([tok[:, None], draft], dim=1)
            if self.page_size:
                logits, _ = llama.paged_decode_window(
                    self.params, window, self.cache, self._table_dev,
                    self.cfg, n_cols=n_cols)
            else:
                logits, _ = llama.decode_window(self.params, window,
                                                self.cache, self.cfg)
            first = logits[:, 0] if first is None else first
            greedy_t = torch.argmax(logits, dim=-1).to(torch.int32)
            match = (draft == greedy_t[:, :K]).to(torch.int32)
            n_acc = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
            on = (spec_on & active) if windowed else spec_on
            n_acc = torch.where(on, n_acc, 0)
            g_last = greedy_t.gather(1, n_acc[:, None].long())
            draft_pad = torch.cat([draft, torch.zeros_like(draft[:, :1])],
                                  dim=1)
            emit = torch.where(ar < n_acc[:, None], draft_pad,
                               torch.where(ar == n_acc[:, None], g_last, 0))
            if windowed:
                # frozen rows emit nothing; active ones at most their
                # remaining budget (>= 1: the verified token always lands)
                n_emit = torch.where(
                    active, torch.minimum(
                        n_acc + 1, torch.clamp(self._win_cap - n_out, min=0)),
                    0)
                emit = torch.where(ar < n_emit[:, None], emit, 0)
            else:
                n_emit = n_acc + 1
            new_len = torch.clamp(length + n_emit, max=s_max)
            length.copy_(new_len)
            if self.draft_params is not None:
                # the draft fed tok, d1..dK itself: its rows for every
                # accepted token exist, so its len follows the target's
                d_len = self._draft_cache["len"]
                d_len.copy_(torch.clamp(new_len,
                                        max=self._draft_cache["k"].shape[2]))
            # append the emitted tokens to the history; the rest go to the
            # dump column
            widx = torch.where(ar < n_emit[:, None], h[:, None] + ar, hc)
            td.scatter_(1, widx.long(), emit)
            if windowed:
                # the carry token is the LAST token this row emitted; a
                # frozen row keeps its own
                last = emit.gather(
                    1, torch.clamp(n_emit - 1, min=0)[:, None].long())[:, 0]
                realized = realized + active.any().to(torch.int32)
                tok = torch.where(n_emit > 0, last, tok)
                n_out = n_out + n_emit
                hit = ((ar < n_emit[:, None]) & self._is_eos(emit)).any(dim=1)
                active = active & ~hit & (n_out < self._win_cap)
            else:
                tok = g_last[:, 0]
            emits.append(emit)
            counts.append(n_emit)
        rows = [tok_in[None], torch.stack(counts),
                torch.stack(emits).permute(0, 2, 1).reshape(-1, b)]
        if windowed:
            rows.append(realized.expand(b)[None])
        out = torch.cat(rows)
        self._tok_dev.copy_(tok)
        return out, first

    def _decode_spec(self, n_win: int, spec_mask: np.ndarray,
                     active0: np.ndarray | None = None,
                     step_cap: np.ndarray | None = None,
                     n_cols: int | None = None) -> torch.Tensor:
        """Dispatch ``n_win`` verify windows (fused-window masks with
        ``decode_window``); returns ``_spec_body``'s packed block."""
        windowed = bool(self.decode_window)
        if self.page_size:
            self._table_device()
            n_cols = n_cols or self._gather_cols()
        _upload(self._spec_on, spec_mask)
        if windowed:
            _upload(self._win_active, active0)
            _upload(self._win_cap, step_cap)
        kind = "specwin" if windowed else "spec"
        out, self.dispatch_logits = self._run(
            (kind, n_win, n_cols),
            lambda: self._spec_body(n_win, n_cols, windowed))
        return out

    def _unpack_spec(self, toks: np.ndarray, n_win: int):
        """``_spec_body``'s block -> (input row [B], emitted [W, B, K+1],
        counts [W, B], realized windows or None)."""
        K1 = self.spec_k + 1
        b = toks.shape[1]
        counts = toks[1:1 + n_win]
        emits = toks[1 + n_win:1 + n_win + n_win * K1].reshape(
            n_win, K1, b).transpose(0, 2, 1)
        realized = (int(toks[1 + n_win + n_win * K1, 0])
                    if len(toks) > 1 + n_win + n_win * K1 else None)
        return toks[0], emits, counts, realized

    def _graph_keys(self) -> list:
        """Every decode dispatch shape: each ladder entry, and with paging
        at each gather width ``_gather_cols`` can pick. Under speculation
        the ladder dispatches verify windows, and the plain ladder too when
        its fallback is armed."""
        plain = "window" if self.decode_window else "chunk"
        kinds = [plain]
        if self.spec_k:
            kinds = ["specwin" if self.decode_window else "spec"]
            if self._plain_armed:
                kinds.append(plain)
        widths = ([None] if not self.page_size else
                  sorted({min(self._p_max, 1 << k)
                          for k in range(self._p_max.bit_length() + 1)}))
        return [(kind, n, w) for kind in kinds for n in self._chunk_ladder
                for w in widths]

    def graph_stats(self) -> dict | None:
        """Captured decode graphs (None on the CPU): how many, the wall
        seconds capture took and the reserved memory it added."""
        return None if self._graphs is None else self._graphs.stats()

    def _after_prefill(self, logits, tokens, lens, slots, valid) -> None:
        """Route a prefill's logits into first-token state: the sampled
        first tokens (``_post_prefill``), or under speculation the greedy
        ones plus the prompts and firsts in the history rows, and the
        draft model's own prefill of the same prompts."""
        if not self.spec_k:
            self._post_prefill(logits, slots, valid)
            return
        self._spec_post_prefill(logits, tokens, lens, slots, valid)
        if self.draft_params is not None and any(valid):
            _, self._draft_cache = llama.prefill_into_many(
                self.draft_params, tokens, lens, self.draft_cfg,
                self._draft_cache, slots, valid)

    def _spec_post_prefill(self, logits, tokens, lens, slots, valid) -> None:
        """JAX's ``spec_post_prefill(_many)``: each valid row's greedy first
        token into the token row, and its prompt (the first ``lens``
        positions of the bucket; the rest of the row keeps what it held)
        and first token at position ``lens`` into its history row."""
        firsts = torch.argmax(logits, dim=-1).to(torch.int32)
        toks = llama._int32(np.asarray(tokens), self.device)
        for i, ok in enumerate(valid):
            if not ok:
                continue
            slot, n = int(slots[i]), int(np.asarray(lens).reshape(-1)[i])
            self._tok_dev[slot] = firsts[i]
            self._tokens_dev[slot, :n] = toks[i, :n]
            self._tokens_dev[slot, n] = firsts[i]

    def _seed_spec_history(self, slot: int, hist: list, logits) -> None:
        """Write a slot's FULL history (prefix + suffix, or every segment of
        a chunked prompt) into its history row, zeros after it, plus the
        greedy first token at its end, and prefill the draft model's cache
        with the whole history (JAX's ``spec_prefix_post`` and its draft
        ingest)."""
        if self.draft_params is not None:
            bucket = next((b for b in self.prefill_buckets
                           if len(hist) <= b), None)
            if bucket is None:
                raise ValueError(
                    f"history length {len(hist)} exceeds the largest "
                    f"prefill bucket {self.prefill_buckets[-1]} (the "
                    f"draft model must ingest the full history)")
            toks = np.zeros((1, bucket), np.int32)
            toks[0, :len(hist)] = hist
            _, self._draft_cache = llama.prefill_into(
                self.draft_params, toks, np.array([len(hist)], np.int32),
                self.draft_cfg, self._draft_cache, slot)
        row = np.zeros((self._hist_cap,), np.int32)
        row[:len(hist)] = hist
        first = torch.argmax(logits[0]).to(torch.int32)
        self._tok_dev[slot] = first
        self._tokens_dev[slot, :self._hist_cap] = llama._int32(row,
                                                               self.device)
        self._tokens_dev[slot, len(hist)] = first

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
        the first request: the decode chunk (or window) and the 1-step
        mini-chunk eagerly (a paged step over every table column), each
        prefill bucket as a single (paged: its page writes) and as a wave,
        and with paging the suffix prefill per bucket, and the segment with
        chunked prefill; then on a card capture the CUDA graph of every
        decode dispatch shape (``_graph_keys``). All slots are dead and
        every page write lands in scratch page 0, so nothing reaches
        bookkeeping; admission overwrites what this writes."""
        if any(s.live for s in self.slots):
            raise RuntimeError("warmup needs an idle generator")
        if self.page_size:
            self._table_device()
        if self.spec_k:
            self._warm_spec()
        else:
            for n in sorted({self.chunk, 1}):
                if self.decode_window:
                    self._window_body(n, self._p_max)
                else:
                    self._chunk_body(n, self._p_max if self.page_size
                                     else None)
        ones = np.ones((1,), np.int32)
        if self.prefill_chunk:
            seg = np.zeros((1, self.prefill_chunk), np.int32)
            s_cap = (self._p_max * self.page_size if self.page_size
                     else self.cache["k"].shape[2])
            t0 = time.perf_counter()
            self._segment(seg, ones, 0, 0, s_cap)
            self.programs.record(
                f"prefill/segment{self.prefill_chunk}",
                wall_s=time.perf_counter() - t0, kind="prefill",
                shapes={"rows": 1, "segment": self.prefill_chunk},
                cost=model_cost(self.cfg, 1, self.prefill_chunk, s_cap,
                                prefill=True))
        # speculation seeds slot 0's history row from the warm prefill, as
        # the JAX warmup does (a dead row's history is the drafts' context
        # past a later occupant's own tokens)
        spec = bool(self.spec_k)
        for bucket in self.prefill_buckets:
            padded = np.zeros((1, bucket), np.int32)
            t_bucket = time.perf_counter()
            if self.page_size:
                scratch = np.zeros((self._p_max,), np.int32)
                logits, self.cache = llama.paged_prefill_into(
                    self.params, padded, ones, self.cfg, self.cache,
                    scratch[:bucket // self.page_size], 0, self.page_size)
                self._after_prefill(logits, padded, ones, [0], [spec])
                logits, self.cache = llama.paged_suffix_prefill(
                    self.params, padded, ones, self.cfg, self.cache, scratch,
                    0, self.page_size)
                self._post_prefill(logits, [0], [False])
                self._record_prefill(bucket, time.perf_counter() - t_bucket)
                continue
            for b in sorted({1, self._admit_cap}):
                valid = np.zeros((b,), bool)
                valid[0] = spec and b == 1
                toks = np.zeros((b, bucket), np.int32)
                lens = np.ones((b,), np.int32)
                logits, self.cache = llama.prefill_into_many(
                    self.params, toks, lens, self.cfg, self.cache,
                    np.zeros((b,), np.int32), valid, self.mesh)
                self._after_prefill(logits, toks, lens, [0] * b, valid)
            self._record_prefill(bucket, time.perf_counter() - t_bucket)
        if self._sp is not None:
            self._warm_sp()
        if self._graphs is not None:
            for kind, n, n_cols in self._graph_keys():
                if (kind, n, n_cols) in self._graphs:
                    continue
                self._capture((kind, n, n_cols),
                              self._dispatch_body(kind, n, n_cols))
            torch.cuda.synchronize(self.device)

    def _dispatch_body(self, kind: str, n: int, n_cols: int | None):
        """The body of decode dispatch ``kind`` (``_graph_keys``)."""
        if kind in ("spec", "specwin"):
            return lambda: self._spec_body(n, n_cols, kind == "specwin")
        if kind == "window":
            return lambda: self._window_body(n, n_cols)
        return lambda: self._chunk_body(n, n_cols)

    def _warm_spec(self) -> None:
        """The warm dispatches of a speculative generator, as the JAX
        warmup runs them: the verify-window ladder (every entry, largest
        first, when the scheduler can pick any; else the full chunk and
        the 1-window mini), then the plain ladder when its fallback is
        armed, over a dead batch with every row's speculation off (fused
        windows: every row frozen). On the CPU each is recorded as a
        program row."""
        per_step = self.spec_k + 1
        full = self.scheduler is not None and (
            self.prefill_chunk or self.scheduler.budget
            < self.chunk * self.batch_slots * per_step)
        sizes = (list(reversed(self._chunk_ladder)) if full
                 else list(dict.fromkeys((self.chunk, 1))))
        n_cols = self._p_max if self.page_size else None
        spec_kind = "specwin" if self.decode_window else "spec"
        plain = "window" if self.decode_window else "chunk"
        self._spec_on.zero_()
        if self.decode_window:
            self._win_active.zero_()
            self._win_cap.zero_()
        runs = [(spec_kind, n) for n in sizes]
        if self._plain_armed:
            runs += [(plain, n) for n in sizes]
        for kind, n in runs:
            body = self._dispatch_body(kind, n, n_cols)
            if self._graphs is None:
                self._run((kind, n, n_cols), body)
            else:
                body()

    def _warm_sp(self) -> None:
        """The sequence-parallel prefill of every bucket the dual path can
        route to, once, each a program row (``sp_prefill/b<bucket>``): a
        dense wave with no valid row (nothing written), a paged one into
        scratch page 0."""
        sp = self._sp
        ones = np.ones((1,), np.int32)
        for bucket in self.prefill_buckets:
            if bucket < sp.min_tokens:
                continue
            padded = np.zeros((1, bucket), np.int32)
            t0 = time.perf_counter()
            if self.page_size:
                logits, self.cache = llama.paged_prefill_into(
                    self.params, padded, ones, sp.sp_cfg, self.cache,
                    np.zeros((bucket // self.page_size,), np.int32), 0,
                    self.page_size, mesh=sp.mesh, set_len=False)
            else:
                logits, self.cache = llama.prefill_into_many(
                    self.params, padded, ones, sp.sp_cfg, self.cache, [0],
                    [False], sp.mesh)
            self._post_prefill(logits, [0], [False])
            self.programs.record(
                f"sp_prefill/b{bucket}", wall_s=time.perf_counter() - t0,
                kind="prefill",
                shapes={"tokens": [1, bucket], "shards": sp.shards},
                cost=model_cost(self.cfg, 1, bucket, bucket, prefill=True))

    def _record_prefill(self, bucket: int, wall_s: float) -> None:
        """A prefill bucket's program row: the seconds of its first runs
        at ``warmup`` (eager on the card too, the kernels' first launches
        included)."""
        self.programs.record(
            f"prefill/b{bucket}", wall_s=wall_s, kind="prefill",
            shapes={"rows": self._admit_cap, "bucket": bucket},
            cost=model_cost(self.cfg, self._admit_cap, bucket, bucket,
                            prefill=True))

    # -- paged-pool bookkeeping (page_size > 0) ------------------------------
    def _page_stack(self, pg: int) -> int:
        """The free stack of page ``pg``: its owner in a pool striped over
        the SP shards, else the one stack (a head-split pool's pages span
        every shard)."""
        return par.owner(self.cache["k"], pg) if self._sp is not None else 0

    def _pop_free_page(self) -> int | None:
        """One page off the free pool, or None when dry. The allocator
        round-robins across the per-shard stacks, so a striped slot's
        consecutive virtual pages land on different shards."""
        n = len(self._free_dev)
        for i in range(n):
            d = (self._stripe_rr + i) % n
            if self._free_dev[d]:
                self._stripe_rr = (d + 1) % n
                return self._free_dev[d].pop()
        return None

    def _return_pages(self, pages) -> None:
        """Give pages back to the pool, each to the stack of the shard that
        owns it (fixed by its id)."""
        for pg in pages:
            self._free_dev[self._page_stack(pg)].append(pg)

    def _n_free_pages(self) -> int:
        return sum(len(stack) for stack in self._free_dev)

    @property
    def _free_pages(self) -> list[int]:
        """Every free page, stack after stack (a read-only copy)."""
        return [pg for stack in self._free_dev for pg in stack]

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
        forever. The front's handlers call it from the event loop while
        the serving thread registers prefixes: the values are copied in
        one step first."""
        held = sum(len(i["pages"]) for i in list(self._prefixes.values())
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
        per_dispatch = (self.spec_k + 1) if self.spec_k else 1
        margin = self.chunk * (len(self._inflight) + 2) * per_dispatch
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
        """The device copy of the page table for the next dispatch,
        rewritten in place only when the host table changed since the last
        one."""
        if self._table_dirty:
            _upload(self._table_dev, self._table)
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
            "restarts": self.restarts,
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
                # list(): one atomic copy, safe from a reader thread
                pinned_prefixes=sum(1 for i in list(self._prefixes.values())
                                    if i.get("pinned")),
                kv_spills=self.kv_spills,
                kv_restores=self.kv_restores,
                kv_restore_fallbacks=self.kv_restore_fallbacks,
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
                sp_built = False
                if (self._sp is not None and bucket is not None
                        and shared_len >= self._sp.min_tokens):
                    # the whole prefix in ONE wave across the mesh: what
                    # makes a disaggregated prefill replica an SP prefill
                    # worker; a failure falls through to the segments
                    # below, which rewrite every position
                    toks = np.zeros((1, bucket), np.int32)
                    toks[0, :shared_len] = ids[:shared_len]
                    sp_built = self._run_sp_prefill(
                        toks, np.array([shared_len], np.int32),
                        row[:bucket // ps], 0, prefix=True) is not None
                for off in (() if sp_built
                            else range(0, shared_len, seg_cap)):
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
        candidates, so a prefix a slot still reads is never mid-spill. An
        evicted prefix spills to the host tier when one is on. False when
        that cannot free enough."""
        while self._n_free_pages() < n_need:
            idle = [(info.get("pinned", False), info["last_use"], pid)
                    for pid, info in self._prefixes.items()
                    if info["refs"] == 0]
            if not idle:
                return False
            _, _, pid = min(idle)
            info = self._prefixes.pop(pid)
            # the spill's gather is enqueued before anything can write the
            # freed pages (one stream), so returning them at once is safe
            self._spill_prefix(info)
            self._return_pages(info["pages"])
            self.prefix_evictions += 1
        return True

    def _page_index(self, pages) -> torch.Tensor:
        return llama._int32(np.asarray(pages, np.int32), self.device).long()

    def _spill_prefix(self, info: dict) -> bool:
        """Copy an evicted idle prefix's whole pages into the host tier:
        one gather per cache array into a fresh device buffer, then a
        copy to pinned host memory that does not block, settled by the
        store on first read. False when the tier is off, the entry exceeds
        its budget, or the prefix shares no whole page — the pages are then
        discarded, as without the tier."""
        if self.host_kv is None or not info["pages"] or not info["len"]:
            return False
        if self.fault is not None:
            self.fault("spill")
        t0 = time.perf_counter()
        idx = self._page_index(info["pages"])
        cuda = self.device.type == "cuda"
        arrays = {}
        for name, arr in self.cache.items():
            if name == "len":
                continue
            slab = arr.index_select(1, idx)
            if cuda:
                host = torch.empty(slab.shape, dtype=slab.dtype,
                                   pin_memory=True)
                host.copy_(slab, non_blocking=True)
                slab = host
            arrays[name] = slab
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        if "paged/gather" not in self.programs:
            # the first spill's gather is a program row (eager index ops)
            self.programs.record("paged/gather",
                                 wall_s=time.perf_counter() - t0,
                                 kind="eager",
                                 shapes={"pages": len(info["pages"])})
        ok = self.host_kv.put(tuple(info["ids_full"]), arrays, {
            "len": info["len"], "tail": list(info["tail"]),
            "ids_full": list(info["ids_full"]),
            "pinned": bool(info.get("pinned", False)),
        }, event)
        if ok:
            self.kv_spills += 1
        return ok

    def has_offloaded(self, prefix_ids) -> bool:
        """True when the host tier holds this exact prefix — the radix
        cache marks a generator-evicted registration restorable by it."""
        if self.host_kv is None:
            return False
        return tuple(int(t) for t in prefix_ids) in self.host_kv

    def restore_prefix(self, prefix_ids) -> int:
        """Bring an offloaded prefix back into pool pages: allocate, copy
        the host slabs to the card without blocking, write them into the
        pool pages in place (index assignment: the decode graphs keep the
        pool's storage), and re-register under a fresh prefix id. The
        restored tokens are charged to the token-budget scheduler.

        Raises ``KeyError`` when the tier does not hold the prefix and
        ``PagePoolExhausted`` when pool pressure wins (the entry stays in
        the tier; the caller falls back to a full prefill). Restored pages
        are bit-identical to the spilled ones, so decode after
        spill→restore matches the never-evicted path exactly."""
        if not self.page_size:
            raise ValueError("kv offload requires page_size > 0")
        if self.host_kv is None:
            raise KeyError("host kv tier is disabled")
        if self.fault is not None:
            self.fault("restore")
        key = tuple(int(t) for t in prefix_ids)
        popped = self.host_kv.pop(key)  # first: a reclaim below may spill
        if popped is None:              # others and LRU-evict this entry
            raise KeyError(f"prefix {key[:8]}... not in the host tier")
        arrays, meta = popped
        n_need = meta["len"] // self.page_size
        if self._n_free_pages() < n_need:
            self._reclaim_prefix_pages(n_need)
        if self._n_free_pages() < n_need:
            self.host_kv.put_back(key, arrays, meta)
            self.kv_restore_fallbacks += 1
            # goodput: the caller charges the restore_fallback, knowing how
            # much of the lost reuse a shallower registered match covers
            raise PagePoolExhausted(
                f"restore needs {n_need} pages, {self.free_pages} free")
        pages = [self._pop_free_page() for _ in range(n_need)]
        if n_need:
            t0 = time.perf_counter()
            idx = self._page_index(pages)
            for name, slab in arrays.items():
                self.cache[name].index_copy_(
                    1, idx, slab.to(self.device, non_blocking=True))
            if "paged/scatter" not in self.programs:
                self.programs.record("paged/scatter",
                                     wall_s=time.perf_counter() - t0,
                                     kind="eager", shapes={"pages": n_need})
        pid = self._next_prefix
        self._next_prefix += 1
        self._prefix_clock += 1
        self._prefixes[pid] = {"pages": pages, "len": meta["len"],
                               "tail": list(meta["tail"]),
                               "ids_full": list(meta["ids_full"]),
                               "refs": 0, "last_use": self._prefix_clock,
                               "pinned": bool(meta.get("pinned", False))}
        self.kv_restores += 1
        if self.scheduler is not None:
            self.scheduler.charge_restore(meta["len"])
        return pid

    def drop_prefix(self, pid: int, spill: bool = False) -> bool:
        """Return a prefix's pages to the pool (no live borrowers).
        ``spill=True`` (capacity evictions, e.g. the radix cache's cap on
        registered prefixes) copies the pages to the host tier first;
        returns whether they were stored. A plain drop discards."""
        info = self._prefixes[pid]
        if info["refs"] > 0:
            raise RuntimeError(f"prefix {pid} still used by {info['refs']} "
                               f"slots")
        spilled = self._spill_prefix(info) if spill else False
        self._return_pages(info["pages"])
        del self._prefixes[pid]
        return spilled

    def _admit_prefixed(self, pid: int, ids: np.ndarray, max_new: int,
                        callback) -> int:
        """Admit one request on top of a registered prefix: borrow its
        pages, prefill only the tail + suffix at start = the shared
        length."""
        if pid not in self._prefixes:
            raise PrefixEvicted(f"prefix {pid} was evicted; re-register")
        if self.fault is not None:
            self.fault("prefill")
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
            if self.spec_k:
                # the history row holds the whole prefix + suffix (the
                # suffix carries the partial page's tail)
                self._seed_spec_history(
                    slot, info["ids_full"][:info["len"]] + suffix, logits)
            else:
                self._post_prefill(logits, [slot], [True])
            self.prefill_waves += 1
        except Exception:
            self.slots[slot].live = False
            self._free_slot_pages(slot)
            raise
        self._pending_first.append(slot)
        self.tokens_computed += 1
        s = _Slot()
        s.live = True
        s.max_new = max_new
        s.produced = 1  # the pending first token counts as sampled
        s.prompt_len = start + n_suf
        s.callback = callback
        if self._plain_armed:
            s.hist = [int(t) for t in info["ids_full"][:info["len"]]] + suffix
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
        """Does a prompt of ``n`` tokens take the segmented prefill? An
        SP-eligible one prefills whole instead: one sequence-parallel wave
        beats ``prefill_chunk``-sized single-device segments."""
        if not self.prefill_chunk or n <= self.prefill_chunk:
            return False
        return not self._sp_eligible(n)

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
            # their first tokens never reach a consumer or a ledger class
            self.tokens_computed -= len(dead)
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
        if (self.spec_k and self.draft_params is not None
                and n > self.prefill_buckets[-1]):
            # refused at admission: the final segment could not seed it
            raise ValueError(
                f"prompt length {n} exceeds the largest prefill bucket "
                f"{self.prefill_buckets[-1]} (the draft model must ingest "
                f"the full history)")
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
            if self.fault is not None:
                self.fault("prefill")
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
                self.tokens_computed += 1
                self.slots[slot].produced = 1  # the pending first token
                if self._plain_armed:
                    self.slots[slot].hist = [int(t) for t in st["ids"]]
                if self.spec_k:
                    # the whole prompt, not this segment's tokens
                    self._seed_spec_history(
                        slot, [int(t) for t in st["ids"]], logits)
                else:
                    self._post_prefill(logits, [slot], [True])
            else:
                self._chunked_order.append(self._chunked_order.popleft())
            done += 1
            if self._decodable() and (done >= max_segments
                                      or self._pending_first):
                return

    def _admit_waves(self, prepped, out: list[int]) -> list[int]:
        if self.fault is not None and prepped:
            self.fault("prefill")
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
            sp_used = False  # this wave prefilled sequence-parallel
            try:
                if self.page_size:
                    sp_used = self._prefill_paged(tokens, lens, slots[0],
                                                  wave[0][2], s_bucket)
                else:
                    logits = None
                    if b == 1 and self._sp_eligible(int(lens[0])):
                        logits = self._run_sp_prefill(tokens, lens, None,
                                                      slots[0])
                        sp_used = logits is not None
                    if logits is None:
                        logits, self.cache = llama.prefill_into_many(
                            self.params, tokens, lens, self.cfg, self.cache,
                            slot_arr, valid, self.mesh)
                    self._after_prefill(logits, tokens, lens, slot_arr, valid)
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
                self.tokens_computed += 1
                s = _Slot()
                s.live = True
                s.max_new = max_new
                s.produced = 1  # the pending first token counts as sampled
                s.prompt_len = n
                s.callback = callback
                if sp_used:
                    s.sp_shards = self._sp.shards
                if self._plain_armed:
                    s.hist = [int(t) for t in _ids]
                self.slots[slot] = s
            out.extend(slots)
        return out

    def _prefill_paged(self, tokens, lens, slot: int, max_new: int,
                       s_bucket: int) -> bool:
        """One prompt into ``slot``'s own pages, sequence-parallel when it
        is eligible; returns whether it was. Admission control: no pages,
        no slot — ``PagePoolExhausted`` (the caller requeues) rather than a
        silent eviction mid-generation; the estimate never exceeds the
        request's own budget."""
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
        logits = None
        if self._sp_eligible(n):
            logits = self._run_sp_prefill(tokens, lens, row, slot)
        sp_used = logits is not None
        if logits is None:
            logits, self.cache = llama.paged_prefill_into(
                self.params, tokens, lens, self.cfg, self.cache, row, slot,
                self.page_size)
        self._after_prefill(logits, tokens, lens, [slot], [True])
        return sp_used

    # -- sequence-parallel prefill (the sp_serving.py plan) ------------------
    def _sp_eligible(self, n: int) -> bool:
        """Does a prompt of ``n`` tokens take the sequence-parallel
        prefill? The dual-path threshold: below ``min_tokens`` (or past the
        largest bucket) the single-device prefill runs."""
        return (self._sp is not None and n >= self._sp.min_tokens
                and n <= self.prefill_buckets[-1])

    def _run_sp_prefill(self, tokens, lens, row, slot: int, *,
                        prefix: bool = False):
        """One sequence-parallel prefill wave: a slot's admission, or with
        ``prefix`` a ``register_prefix`` page build (pages fill, no slot
        admits). The forward attends across the mesh (ring or Ulysses) and
        the K/V land split: on the striped pool's owners, or on the dense
        row's sequence shards. Returns the last-token logits, or None after
        a failure (the ``sp_prefill`` / ``sp_gather`` fault points
        included): the caller then runs the single-device prefill over the
        same rows or pages, which rewrites them whole, so the fallback is
        bit-identical to never having tried. Charged to the scheduler at
        tokens over shards: each shard swept its slice."""
        sp = self._sp
        t0 = time.perf_counter()
        try:
            if self.fault is not None:
                self.fault("sp_prefill")
            if self.page_size:
                logits, self.cache = llama.paged_prefill_into(
                    self.params, tokens, lens, sp.sp_cfg, self.cache, row,
                    slot, self.page_size, mesh=sp.mesh, set_len=not prefix)
            else:
                logits, self.cache = llama.prefill_into(
                    self.params, tokens, lens, sp.sp_cfg, self.cache, slot,
                    mesh=sp.mesh)
            if self.fault is not None:
                self.fault("sp_gather")
        except Exception as exc:  # the single-device prefill takes over
            self.sp_fallbacks += 1
            _log.warning("sp prefill fell back to single-device (%s: %s)",
                         type(exc).__name__, exc)
            return None
        self.sp_prefills += 1
        self.sp_tokens += int(lens[0])
        if self.scheduler is not None:
            self.scheduler.charge_sp(-(-int(lens[0]) // sp.shards))
        if self.recorder is not None:
            self.recorder.note("sp_prefill", time.perf_counter() - t0)
        return logits

    def sp_stats(self) -> dict | None:
        """The sequence-parallel block of ``/debug/serving`` (None when SP
        is off: no SP machinery exists then)."""
        if self._sp is None:
            return None
        return {
            **self._sp.snapshot(),
            "striped_pages": bool(self.page_size),
            "prefills": self.sp_prefills,
            "fallbacks": self.sp_fallbacks,
            "tokens": self.sp_tokens,
        }

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
            if self._plain_armed:
                s.hist.append(t)
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
    def _plan_window(self, n_steps: int, use_spec: bool = False
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Per-row masks for the next fused window: ``active0`` (decodable
        rows) and ``step_cap`` (tokens each row may still emit on the
        device). The cap folds the remaining ``max_new``, the remaining
        sequence capacity and the deadline bound (time to the slot's
        deadline over the observed seconds a step), MINUS the steps of
        windows already in flight: host ``produced`` lags the pipeline, and
        without the subtraction a row could be granted the same budget
        twice (a speculative window in flight may emit K+1 tokens a verify
        window). Under-granting is safe (the next window continues);
        ``_apply_burst`` truncates on the host either way."""
        active0 = np.array([s.live and i not in self._chunked
                            for i, s in enumerate(self.slots)], bool)
        pending = 0
        for kind, _block, meta, _ in self._inflight:
            if kind == "window":
                pending += meta[0]
            elif kind == "specwin":
                pending += meta[0] * (self.spec_k + 1)
        step_cap = np.zeros((self.batch_slots,), np.int32)
        now = time.perf_counter()  # slot.deadline_at's clock (llm.py)
        for i, s in enumerate(self.slots):
            if not active0[i]:
                continue
            cap = min(s.max_new - s.produced,
                      self.max_seq - s.prompt_len - s.produced) - pending
            if s.deadline_at is not None and self._step_ema:
                cap = min(cap, int(max(s.deadline_at - now, 0.0)
                                   / self._step_ema))
            step_cap[i] = max(cap, 0)
        # dispatch cadence EMA in seconds a planned step: the deadline
        # bound's clock (advisory: the server's reaper stays authoritative)
        t = time.perf_counter()
        if self._last_dispatch is not None:
            t_prev, n_prev = self._last_dispatch
            per = (t - t_prev) / max(n_prev, 1)
            self._step_ema = (per if self._step_ema is None
                              else 0.8 * self._step_ema + 0.2 * per)
        unit = (self.spec_k + 1) if use_spec else 1
        self._last_dispatch = (t, n_steps * unit)
        return active0, step_cap

    def step(self) -> None:
        """Dispatch one chunk (or fused window) of decode steps, then
        process the blocks that fell behind the pipeline's depth (host
        bookkeeping lags one dispatch, two with ``pipeline``). With the
        token-budget scheduler, segmented prefill takes its planned share
        first (several segments when decode is light), then decode
        dispatches the ladder entry that fills the rest. While first tokens
        are pending the dispatch is the 1-step mini-chunk, read back at
        once (TTFT). Under speculation a ladder entry counts verify
        windows; with every decodable slot's speculation off (lookup mode,
        the fallback armed) the dispatch takes the plain ladder."""
        if self.n_live == 0:
            self.drain()
            return
        if self.fault is not None:
            self.fault("step")
        rec = self.recorder
        sched = self.scheduler
        # adaptive speculation: the slots that still speculate, snapshotted
        # here; it travels with the dispatch so its accounting matches what
        # the device ran
        spec_mask = None
        use_spec = False
        if self.spec_k:
            spec_mask = np.array(
                [s.live and i not in self._chunked and not s.spec_disabled
                 for i, s in enumerate(self.slots)], bool)
            use_spec = bool(spec_mask.any()) or not self._plain_armed
        unit = (self.spec_k + 1) if use_spec else 1
        n_steps, n_segments = self.chunk, 1
        if sched is not None:
            t0 = time.perf_counter() if rec is not None else 0.0
            n_steps, n_segments = sched.plan(self._n_decodable(),
                                             bool(self._chunked), unit)
            if rec is not None:
                rec.note("decide", time.perf_counter() - t0)
        if self._chunked:
            # segments ride the same stream as the decode dispatch: their
            # launches are launch time of this pass
            t0 = time.perf_counter() if rec is not None else 0.0
            self._advance_chunked(max(n_segments, 1))
            if rec is not None:
                rec.note("launch", time.perf_counter() - t0)
            if not self._decodable():
                return  # everything live is still mid-prefill
        mini = bool(self._pending_first)
        if mini:
            n_steps = 1
            if sched is not None:
                sched.mini_dispatches += 1
        elif sched is not None:
            sched.note_dispatch(n_steps)
        if self.spec_k and use_spec and self._spec_rows_stale:
            # back from plain dispatches: settle the host mirror, then
            # rewrite the device history rows from it
            self.drain()
            self._reseed_spec_rows()
        if self.decode_window:
            active0, step_cap = self._plan_window(n_steps, use_spec)
            if not mini and not bool((active0 & (step_cap > 0)).any()):
                # no row can emit anything this window: settle the pipeline
                # instead of dispatching an all-frozen window (the mini
                # path always dispatches: pending firsts ride its input row)
                self.drain()
                return
        if self.page_size:
            # page growth and the page table's upload are batch assembly,
            # not launch
            t0 = time.perf_counter() if rec is not None else 0.0
            self._grow_pages()
            self._table_device()
            if rec is not None:
                rec.note("assemble", time.perf_counter() - t0)
        t_launch = time.perf_counter() if rec is not None else 0.0
        if use_spec:
            if self.decode_window:
                block = self._decode_spec(n_steps, spec_mask, active0,
                                          step_cap)
                kind, meta = "specwin", (n_steps, active0, spec_mask)
            else:
                block = self._decode_spec(n_steps, spec_mask)
                kind, meta = "spec", (n_steps, spec_mask)
        elif self.decode_window:
            block = self._decode_window(n_steps, active0, step_cap)
            kind, meta = "window", (n_steps, active0)
        else:
            block = self._decode_chunk(n_steps)
            kind, meta = "chunk", None
        self.steps += n_steps
        if self.spec_k and not use_spec:
            # a plain dispatch leaves the history rows behind the mirror
            self._spec_rows_stale = True
        t_d2h = time.perf_counter() if rec is not None else 0.0
        if rec is not None:
            rec.note("launch", t_d2h - t_launch)
        # the block's copy to the host is enqueued now, before any later
        # replay can overwrite the graph's output. The launch stamp (when,
        # on top of how many dispatches in flight, how many steps) feeds
        # the recorder's device-idle estimate when the block settles.
        stamp = ((t_d2h, len(self._inflight), n_steps * unit)
                 if rec is not None else None)
        self._inflight.append((kind, _HostBlock(block), meta, stamp))
        if rec is not None:
            rec.note("d2h_issue", time.perf_counter() - t_d2h)
            rec.note_overlap(len(self._inflight) - 1)
        if mini:
            self.drain()
        else:
            depth = 2 if self.pipeline else 1
            while len(self._inflight) > depth:
                self._pop_process()
            if self.pipeline and len(self._inflight) >= 2:
                self.pipeline_windows += 1

    def drain(self) -> None:
        """Flush pending token blocks into host bookkeeping."""
        while self._inflight:
            self._pop_process()

    def _pop_process(self) -> None:
        kind, block, meta, stamp = self._inflight.popleft()
        rec = self.recorder
        t0 = time.perf_counter() if rec is not None else 0.0
        toks = block.numpy()
        if rec is not None:
            # the blocking read is device_wait; the launch stamp gives the
            # launch-to-settle span the device-idle estimate credits
            now = time.perf_counter()
            rec.note("device_wait", now - t0)
            if stamp is not None:
                t_launch, depth0, steps = stamp
                rec.note_settle(now - t_launch, depth0, steps, now - t0)
        if kind == "chunk":
            self._process(toks)
        elif kind == "window":
            n_win = meta[0]
            self._process_window(toks[:n_win + 1], toks[n_win + 1],
                                 int(toks[n_win + 2, 0]), meta)
        elif kind == "spec":
            row0, emits, counts, _ = self._unpack_spec(toks, meta[0])
            self._process_spec(row0, emits, counts, meta[1])
        else:  # "specwin"
            planned, active0, mask = meta
            row0, emits, counts, realized = self._unpack_spec(toks, planned)
            self._process_spec(row0, emits, counts, mask, planned=planned,
                               active0=active0, realized_w=realized)

    def _apply_burst(self, i: int, s: _Slot, col: np.ndarray,
                     bursts: dict) -> int:
        """Fold one slot's token COLUMN (step order) into slot state: cap at
        the slot's remaining budget, truncate at the first eos. Returns the
        tokens applied."""
        cap = min(len(col), s.max_new - s.produced,
                  self.max_seq - s.prompt_len - s.produced)
        if cap <= 0:
            self._maybe_finish(i)
            return 0
        col = col[:cap]
        if self._eos_arr is not None:
            hits = np.nonzero(np.isin(col, self._eos_arr))[0]
            if hits.size:
                col = col[:int(hits[0]) + 1]
                s.eos_hit = True
        burst = col.tolist()
        s.tokens.extend(burst)
        s.produced += len(burst)
        self.tokens_computed += len(burst)
        if self._plain_armed:
            s.hist.extend(burst)
        if s.callback is not None:
            bursts.setdefault(i, []).extend(burst)
        self._maybe_finish(i)
        return len(burst)

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
            if self.spec_k and s.spec_disabled:
                # plain dispatches run the cooldown clock too (a step is a
                # window of cadence), or an all-disabled batch could never
                # re-probe
                self._eval_spec_slot(s, False, len(body))
        self._fire_bursts(bursts)

    def _process_window(self, block: np.ndarray, n_out: np.ndarray,
                        realized: int, meta) -> None:
        """Apply one fused window — the block [K+1, B] with row 0 the input
        row, the per-row emit counts ``n_out`` [B] and the ``realized``
        step count — to slot state. Each active row applies only its own
        ``n_out`` tokens. Tokens a row computed past its end (its budget,
        EOS, a death since dispatch) count as ``window_overshoot``; with
        the pipeline, those of rows already dead when the window settled
        count as ``pipeline_overshoot``: computed, never delivered, and
        charged to the goodput ledger as such."""
        planned, active0 = meta
        self.windows += 1
        self.window_steps_planned += planned
        self.window_steps_realized += realized
        if self.recorder is not None:
            # stamped from the processing pass: the committed record
            # describes the window whose tokens this pass drained
            self.recorder.note_window(planned, realized)
        self._resolve_first(block[0])
        body = block[1:]
        bursts: dict[int, list[int]] = {}
        overshoot = lagged = 0
        for i, s in enumerate(self.slots):
            if not active0[i] or i in self._chunked:
                continue  # frozen at dispatch, or mid-prefill garbage
            n = int(n_out[i])
            was_live = s.live
            applied = (self._apply_burst(i, s, body[:n, i], bursts)
                       if was_live else 0)
            if was_live or not self.pipeline:
                overshoot += max(n - applied, 0)
            else:
                lagged += max(n - applied, 0)
        # the applied tokens counted themselves in _apply_burst
        self.tokens_computed += overshoot + lagged
        if overshoot:
            self.window_overshoot += overshoot
            if self.goodput is not None:
                self.goodput.note("window_overshoot", overshoot)
        if lagged:
            self.pipeline_overshoot += lagged
            if self.goodput is not None:
                self.goodput.note("pipeline_overshoot", lagged)
        self._fire_bursts(bursts)

    def _process_spec(self, row0: np.ndarray, emits: np.ndarray,
                      counts: np.ndarray, mask, planned: int | None = None,
                      active0=None, realized_w: int | None = None) -> None:
        """Apply one speculative dispatch: the input row [B] (resolves
        pending firsts), the emitted tokens [W, B, K+1], the counts [W, B]
        and the per-slot enable mask it ran with. Each window gives a live
        slot 1..K+1 tokens (a disabled slot's exactly 1). The device
        computed K+1 positions for each enabled row's window: those that
        did not survive verification are charged ``spec_rejected``. With
        fused windows (``realized_w`` not None) only ``realized_w`` of the
        ``planned`` windows ran, a frozen row's share of a running window
        and tokens past a row's end are ``window_overshoot`` (or
        ``pipeline_overshoot`` for a row that died before the dispatch
        settled), as in JAX."""
        self._resolve_first(row0)
        windowed = realized_w is not None
        if windowed:
            self.windows += 1
            self.window_steps_planned += planned
            self.window_steps_realized += realized_w
            if self.recorder is not None:
                self.recorder.note_window(planned, realized_w)
        bursts: dict[int, list[int]] = {}
        n_windows = emits.shape[0]
        rejected = overshoot = lagged = 0
        for i, s in enumerate(self.slots):
            if windowed:
                if not active0[i] or i in self._chunked:
                    continue
            elif not s.live or i in self._chunked:
                continue  # mid-prefill rows decode garbage; drop it
            enabled = mask is None or bool(mask[i])
            was_live = s.live
            seen = over_row = 0
            for w in range(n_windows):
                if windowed:
                    if w >= realized_w:
                        break  # the whole batch froze before this window
                elif not s.live:
                    break
                n = int(counts[w, i])
                if windowed and n == 0:
                    # frozen while the batch ran: its positions bought
                    # nothing (a disabled row's one)
                    over_row += (self.spec_k + 1) if enabled else 1
                    continue
                seen += 1
                self.spec_windows += 1
                s.spec_windows += 1
                s.spec_emitted += n
                if enabled:
                    s.spec_recent_w += 1
                    s.spec_recent_e += n
                    rejected += self.spec_k + 1 - n
                applied = (self._apply_burst(i, s, emits[w, i, :n], bursts)
                           if s.live else 0)
                self.spec_emitted += applied
                if windowed:
                    over_row += n - applied
            if was_live or not self.pipeline:
                overshoot += over_row
            else:
                lagged += over_row
            if not windowed or was_live:
                self._eval_spec_slot(s, enabled, seen)
        # the applied tokens counted themselves in _apply_burst
        self.tokens_computed += rejected + overshoot + lagged
        if rejected and self.goodput is not None:
            self.goodput.note("spec_rejected", rejected)
        if overshoot:
            self.window_overshoot += overshoot
            if self.goodput is not None:
                self.goodput.note("window_overshoot", overshoot)
        if lagged:
            self.pipeline_overshoot += lagged
            if self.goodput is not None:
                self.goodput.note("pipeline_overshoot", lagged)
        self._fire_bursts(bursts)

    def _eval_spec_slot(self, s: _Slot, enabled: bool, windows: int) -> None:
        """Adaptive speculation, once a processed dispatch: an enabled slot
        whose accept rate over at least ``_spec_probe_min`` windows falls
        below ``spec_min_accept`` is disabled; a disabled one counts its
        cooldown down and re-probes when it expires. Lossless either way."""
        if not windows:
            return
        if not enabled:
            if not s.spec_disabled:
                return  # re-enabled since that dispatch was planned
            s.spec_cooldown_left -= windows
            if s.spec_cooldown_left <= 0:
                s.spec_disabled = False
                s.spec_recent_w = s.spec_recent_e = 0
                self.spec_reprobes += 1
            return
        if s.spec_disabled:
            # dispatched enabled just before the verdict landed: no second
            # verdict, no restarted cooldown
            return
        if self.spec_min_accept <= 0 or not self.spec_k:
            return
        if s.spec_recent_w < self._spec_probe_min:
            return
        rate = max(0.0, (s.spec_recent_e - s.spec_recent_w)
                   / (s.spec_recent_w * self.spec_k))
        if rate < self.spec_min_accept:
            s.spec_disabled = True
            s.spec_cooldown_left = self.spec_cooldown
            self.spec_disables += 1
        s.spec_recent_w = s.spec_recent_e = 0

    def _reseed_spec_rows(self) -> None:
        """Rewrite the history rows from the host mirror (plain dispatches
        advance the cache but not the rows): one upload for the batch, in
        place. Rows of dead or mid-prefill slots are zeroed (a chunked
        slot's row is seeded whole at its final segment). Callers drain
        first, so the mirror is complete."""
        rows = np.zeros((self.batch_slots, self._hist_cap), np.int32)
        for i, s in enumerate(self.slots):
            if not s.live or i in self._chunked:
                continue
            hist = s.hist[-self._hist_cap:]
            rows[i, :len(hist)] = hist
        _upload(self._tokens_dev[:, :self._hist_cap], rows)
        self._spec_rows_stale = False

    def spec_stats(self) -> dict | None:
        """The ``speculation`` block of ``/debug/serving`` (None when off):
        K, the draft mode, lifetime windows and emitted tokens, the accept
        rate, and the adaptive disable / re-probe state."""
        if not self.spec_k:
            return None
        accept = (max(0.0, (self.spec_emitted - self.spec_windows)
                      / (self.spec_windows * self.spec_k))
                  if self.spec_windows else None)
        return {
            "spec_k": self.spec_k,
            "mode": "draft" if self.draft_params is not None else "lookup",
            "min_accept": self.spec_min_accept,
            "cooldown_windows": self.spec_cooldown,
            "windows": self.spec_windows,
            "emitted": self.spec_emitted,
            "accept_rate": (round(accept, 4) if accept is not None
                            else None),
            "disabled_slots": sum(1 for s in self.slots
                                  if s.live and s.spec_disabled),
            "disables_total": self.spec_disables,
            "reprobes_total": self.spec_reprobes,
            "plain_fallback_armed": self._plain_armed,
        }

    def _fire_bursts(self, bursts: dict[int, list[int]]) -> None:
        """Deliver each slot's burst to its callback: the ``emit`` phase of
        the dispatch record."""
        rec = self.recorder
        t0 = time.perf_counter() if rec is not None and bursts else 0.0
        for i, burst in bursts.items():
            cb = self.slots[i].callback
            if cb is not None:
                cb(i, burst)
        if rec is not None and bursts:
            rec.note("emit", time.perf_counter() - t0)

    def window_stats(self) -> dict | None:
        """Fused-window counters (None when window mode is off): K, the
        windows processed, planned and realized steps, the overshoot and
        the step EMA the deadline bound reads."""
        if not self.decode_window:
            return None
        planned = self.window_steps_planned
        return {
            "window": self.decode_window,
            "windows": self.windows,
            "steps_planned": planned,
            "steps_realized": self.window_steps_realized,
            "realized_share": (round(self.window_steps_realized / planned, 4)
                               if planned else None),
            "overshoot_tokens": self.window_overshoot,
            "step_ema_s": (round(self._step_ema, 6)
                           if self._step_ema is not None else None),
        }

    def pipeline_stats(self) -> dict | None:
        """Double-buffer counters (None when the pipeline is off): the
        depth, the passes that ended with two dispatches in flight, the
        tokens computed for rows already dead at settle, and the flight
        recorder's device-idle estimate (None with the recorder off)."""
        if not self.pipeline:
            return None
        rec = self.recorder
        return {
            "depth": 2,
            "windows_overlapped": self.pipeline_windows,
            "overshoot_tokens": self.pipeline_overshoot,
            "device_idle_share": (None if rec is None else
                                  rec.snapshot().get("device_idle_share")),
        }

    def quarantine_borrowed(self) -> list[int]:
        """Invalidate the prefix registrations BORROWED by live slots and
        return their ids: the host-only slice of ``recover`` the watchdog
        runs before it fails the crashed slots' consumers, so a woken
        consumer never sees a suspect registration as live. ``recover``
        re-discovers nothing afterwards."""
        if not self.page_size:
            return []
        invalidated: list[int] = []
        for pid in [p for p, info in self._prefixes.items()
                    if info["refs"] > 0]:
            info = self._prefixes.pop(pid)
            self._return_pages(info["pages"])
            invalidated.append(pid)
        return invalidated

    def recover(self) -> list[int]:
        """Crash recovery for the serving watchdog (``llm.py``): drop what
        the crashed dispatch may have left behind and reset decode state
        so the waiting queue can admit again. Returns the invalidated
        prefix ids, for the radix cache.

        First the stream is synchronised, so no copy still queued (a token
        block's, a spill's or a restore's) lands in pages or buffers a new
        request will own; a sticky device error raises right here. Then
        every slot's state, the blocks in flight, pending first tokens and
        chunked-prefill progress are dropped; borrowed prefix registrations
        are invalidated (a crashed slot attended their pages) and the
        others stay registered; the host KV tier is left untouched, so
        offloaded entries stay restorable. The decode graphs replay fixed
        pointers, so the state they read is reset IN PLACE (the cache's
        ``len``, the token row, the window masks, the speculative history
        rows and the draft cache; the page table through its persistent
        buffer): nothing is rebound and nothing recaptured.
        Last, one 1-step dispatch of the mini graph is read back and the
        card synchronised: recovery proves the decode path runs or raises
        (the watchdog then declares the server dead)."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        self._inflight.clear()
        self._pending_first.clear()
        self._chunked.clear()
        self._chunked_order.clear()
        invalidated: list[int] = []
        if self.page_size:
            borrowed = [pid for pid, info in self._prefixes.items()
                        if info["refs"] > 0]
            for i in range(self.batch_slots):
                self.slots[i].live = False
                self._free_slot_pages(i)
            for pid in borrowed:
                info = self._prefixes.pop(pid, None)
                if info is not None:
                    self._return_pages(info["pages"])
                    invalidated.append(pid)
        for i in range(self.batch_slots):
            self.slots[i] = _Slot()
        self.cache["len"].zero_()
        self._tok_dev.zero_()
        if self.decode_window:
            self._win_active.zero_()
            self._win_cap.zero_()
        if self.spec_k:
            self._spec_rows_stale = False  # fresh rows, no live slots
            self._tokens_dev.zero_()
            self._spec_on.zero_()
            if self.draft_params is not None:
                for arr in self._draft_cache.values():
                    arr.zero_()
        self.restarts += 1
        dead = np.zeros((self.batch_slots,), np.int32)
        if self.spec_k:
            block = self._decode_spec(1, dead.astype(bool), dead.astype(bool),
                                      dead)
        elif self.decode_window:
            block = self._decode_window(1, dead.astype(bool), dead)
        else:
            block = self._decode_chunk(1)
        _HostBlock(block).numpy()
        if cuda:
            torch.cuda.synchronize(self.device)
        return invalidated

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
