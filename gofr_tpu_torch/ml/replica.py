"""Replica pool: cache-aware routing, crash failover, fleet-wide admission —
counterpart of ``gofr_tpu/ml/replica.py``.

One ``LLMServer`` / ``Generator`` pair, however resilient (the watchdog,
deadlines, shedding), is still a single point of failure: a generator
going ``dead`` is a full outage, and every admission decision sees one
instance's load. ``ReplicaPool`` puts N per-replica serving cores (each a
full ``LLMServer``: its own dispatch loop, token-budget scheduler,
watchdog and radix prefix cache) behind ONE routing/admission front.

The front owns the request plane, fleet-wide:

- **Admission and shedding.** One ``AgingPriorityQueue`` holds every
  waiting request; the priority classes, the queue bounds
  (``GOFR_ML_MAX_QUEUE`` / ``GOFR_ML_MAX_QUEUED_TOKENS``),
  lowest-priority-first shedding and request deadlines apply to the
  FLEET, with a Retry-After from the aggregate drain rate. The cores run
  with their own bounds off.
- **Cache-aware routing.** At dispatch the router longest-matches the
  prompt against every live replica's radix trie
  (``RadixPrefixCache.peek``, read-only) and routes to the deepest
  reusable prefix; on an affinity miss the least-loaded replica wins. A
  request leaves the front only when its replica has capacity.
- **Failure semantics.** A replica mid-recovery reports ``recovering``
  and is skipped. A replica going ``dead`` is a drain-and-reroute event:
  its in-flight slots fail with the typed ``GeneratorCrashed``, while a
  request that has not yet yielded a token — queued at the front or
  staged in the dead core — re-admits to a survivor with its priority
  and deadline. ``health()`` reads ``degraded`` while ANY replica is down
  and ``dead`` only when ALL are. On one card a sticky CUDA error takes
  every replica of the process down with it (the replicas share the
  card's context): failover covers the faults the watchdog sees on the
  host.

``GOFR_ML_REPLICAS=1`` (the default) constructs no pool: ``register_llm``
returns a plain ``LLMServer`` (``GOFR_ML_ELASTIC=1`` and
``GOFR_ML_CANARY`` mount the front even at size 1).

**Disaggregated prefill/decode** (``GOFR_ML_DISAGG=1``, >= 2 paged
replicas): replicas ``[0, n_prefill)`` are prefill-biased. A prompt of at
least a page and a token first routes to a prefill replica, which
computes its whole-page prefix KV and ships it through the host tier to
the least-loaded decode replica (``ml/kv_transport.py``); the request
then routes there by affinity, restores the pages at admission and
prefills only its suffix. Any transport failure falls back to a full
prefill. The scheduler's SLO controller, lifted to the front, steers the
role ratio (``_RoleSteer``).

**Elastic fleet**: ``scale_to(n)`` / ``add_replica()`` /
``remove_replica(idx)`` change the membership at runtime. A scale-up
builds a core (the ``spawn=`` factory: build, warmup, CUDA-graph capture),
backfills every pool-pinned prefix and only then becomes routable; a
scale-down leaves the routable set, **migrates its hot radix subtrees to
survivors through the KV transport**, then drains like a graceful close.
``GOFR_ML_ELASTIC=1`` arms the autoscale loop (``_FleetSteer``) within
``GOFR_ML_REPLICAS_MIN`` / ``GOFR_ML_REPLICAS_MAX``.

**Shadow canary** (``GOFR_ML_CANARY=<profile>``): a core built under a
candidate tuned profile's knobs shadows every Nth request; one digest
mismatch rolls it back, a full window within the latency slack promotes
it into the fleet.

Placement (``split_devices``, ``build_replica_generators``): one card per
replica while cards last, round-robin past the card count, so on one
H100 every replica shares ``cuda:0`` — and then the replicas share the
weight tensors (no copy), each owning its cache, page pool, host tier,
decode graphs and serving thread. With sequence-parallel serving armed
(``sp=`` or ``GOFR_ML_SP``), a replica that owns several devices gets an
sp mesh over them (``devices=[cuda:0] * 4`` gives one replica four shards
on one card); a replica over several devices without it is
tensor-parallel over them, as in JAX: a tp mesh, the weights split by
``llama.SHARDING_RULES`` (views of the shared ones on a repeated device)
and a cache split by KV head. The cross-host fleet
sits above and beside the pool: ``ml/federation.py`` fronts a pool or a
server on each host, ``ml/multihost.py`` runs a mesh of Generators over
``torch.distributed``.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import functools
import inspect
import os
import threading
import time
from typing import Any, AsyncIterator

from ..testutil.faults import FaultInjector, fault_snapshot
from ..tracing import current_context
from .errors import (DeadlineExceeded, GeneratorCrashed, Overloaded,
                     ServerClosed)
from ..flight_recorder import event_log
from .generate import PrefixEvicted
from .goodput import goodput_ledger
from .capture import sampler_snapshot, token_digest, traffic_capture
from .journey import Journey, journey_log, next_rid
from .journey import seal as seal_journey
from .kv_offload import HostKVStore, OffloadConfig
from .llm import LLMServer, _abort_reason, drain_s_from_env
from .scheduler import (PRIORITIES, AgingPriorityQueue, SLOController,
                        normalize_priority, retry_after_s)

__all__ = ["ReplicaPool", "split_devices", "spawn_devices",
           "build_replica_generators", "replicas_from_env", "disagg_from_env",
           "elastic_from_env", "canary_from_env"]

# health-state ordinal for the app_llm_replica_state gauge (alert on >= 2)
_STATE_VALUE = {"serving": 0, "degraded": 1, "recovering": 2, "dead": 3}

# _route's verdict for a prefill-stage request when NO live prefill-role
# replica exists: stage 1 is skipped outright (the request full-prefills
# on a decode replica) instead of parking behind replicas that will
# never come back
_SKIP_PREFILL = object()

# host-tier budget armed per replica when disaggregated mode is on but
# the operator left GOFR_ML_KV_HOST_BUDGET_MB unset: the transport moves
# pages THROUGH the host tier, so a store must exist
_DISAGG_DEFAULT_HOST_MB = 256.0


def _ensure_host_store(gen) -> None:
    """Arm a generator's host KV tier at the serviceable default when
    the operator left ``GOFR_ML_KV_HOST_BUDGET_MB`` unset — the ONE
    arming expression behind disagg construction, runtime scale-up, and
    migration (the transports move pages THROUGH the host tier)."""
    if getattr(gen, "host_kv", None) is None:
        gen.host_kv = HostKVStore.from_env() or HostKVStore(
            OffloadConfig(budget_mb=_DISAGG_DEFAULT_HOST_MB))


def disagg_from_env() -> bool:
    """``GOFR_ML_DISAGG`` as the disaggregated prefill/decode switch.
    Unset/0 = off (the pool code path is byte-identical to the
    non-disaggregated behavior); malformed values fail loudly at
    startup, like ``GOFR_ML_REPLICAS``."""
    raw = os.environ.get("GOFR_ML_DISAGG", "").strip()
    if not raw or raw == "0":
        return False
    if raw == "1":
        return True
    raise ValueError(f"GOFR_ML_DISAGG must be 0 or 1, got {raw!r}")


def _disagg_prefill_from_env(default: int) -> int:
    """``GOFR_ML_DISAGG_PREFILL``: the INITIAL prefill-biased replica
    count (the SLO controller steers it live from there). Defaults to
    half the fleet, floor 1."""
    raw = os.environ.get("GOFR_ML_DISAGG_PREFILL", "").strip()
    if not raw:
        return default
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"GOFR_ML_DISAGG_PREFILL must be an integer, got {raw!r}"
        ) from None
    if n < 1:
        raise ValueError(f"GOFR_ML_DISAGG_PREFILL must be >= 1, got {n}")
    return n


def elastic_from_env() -> bool:
    """``GOFR_ML_ELASTIC`` as the autoscale switch. Unset/0 = off (the
    pool path is byte-identical to the static-fleet behavior); malformed
    values fail loudly at startup, like ``GOFR_ML_REPLICAS``."""
    raw = os.environ.get("GOFR_ML_ELASTIC", "").strip()
    if not raw or raw == "0":
        return False
    if raw == "1":
        return True
    raise ValueError(f"GOFR_ML_ELASTIC must be 0 or 1, got {raw!r}")


def canary_from_env() -> str | None:
    """``GOFR_ML_CANARY=<path>``: a candidate tuned profile (ml/tune.py)
    to boot as a shadow canary. Unset/empty constructs nothing — the
    pool front is not even mounted for it."""
    raw = os.environ.get("GOFR_ML_CANARY", "").strip()
    return raw or None


class _Canary:
    """One shadow-canary campaign: the candidate core plus the judging
    state. All mutable fields are guarded by the pool's ``_canary_lock``
    (the core itself has its own serving thread and needs none).

    Lifecycle: ``shadowing`` — the front mirrors every Nth admitted
    request to the candidate core (mirrored tokens bill to the
    ``canary`` waste reason; the output is compared, never delivered) —
    until the verdict window fills or a disqualifier lands. Any digest
    mismatch or candidate-core error rolls back IMMEDIATELY; a full
    window of identity-true results whose median TTFT/TPOT stay within
    ``slo_slack`` of the primaries' promotes the core into the fleet.
    """

    __slots__ = ("profile", "core", "sample_every", "window", "slo_slack",
                 "seen", "mirrored", "errors", "decided", "decide_reason",
                 "state", "pending", "results")

    def __init__(self, profile: dict, core, *, sample_every: int,
                 window: int, slo_slack: float = 2.0) -> None:
        self.profile = profile
        self.core = core
        self.sample_every = max(1, int(sample_every))
        self.window = max(1, int(window))
        self.slo_slack = float(slo_slack)
        self.seen = 0        # front admissions observed while shadowing
        self.mirrored = 0    # ...of which were mirrored to the candidate
        self.errors = 0      # candidate-core failures (each is fatal)
        self.decided = False
        self.decide_reason: str | None = None
        self.state = "shadowing"  # shadowing | promoted | rolled_back
        # rid -> {"canary": result, "primary": result} halves; a pair
        # judges when both land, a failed primary tombstones its rid
        self.pending: dict[str, dict] = {}
        self.results: collections.deque[dict] = collections.deque(
            maxlen=self.window)


def _fleet_bound_from_env(name: str, default: int, floor: int) -> int:
    """``GOFR_ML_REPLICAS_MIN``/``GOFR_ML_REPLICAS_MAX`` parsed loudly
    (0 on MAX = unbounded)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"{name} must be an integer, got {raw!r}") from None
    if n < floor:
        raise ValueError(f"{name} must be >= {floor}, got {n}")
    return n


class _FleetSteer:
    """Fleet-SIZE controller: ``_RoleSteer`` generalized from "what ratio
    of a fixed fleet prefills" to "how many replicas the fleet has".

    One ``decide()`` pass per controller interval
    (``GOFR_ML_ELASTIC_INTERVAL_S``), fed signals the stack already
    produces: fleet queue depth vs free capacity, the observed
    Retry-After drain-rate estimate, and — under disaggregation — the
    lifted SLO controller's last TTFT window. **Pressure** (backlog past
    what the fleet can stage, a drain estimate that says waiters will
    sit multiple intervals, or TTFT over target) votes up; **idle**
    (empty queue AND the in-flight load fitting comfortably in one fewer
    replica) votes down. Hysteresis: ``up_after`` consecutive pressure
    votes grow the fleet by ONE, ``down_after`` consecutive idle votes
    shrink it by one — scale-down is deliberately the slower direction
    (a wrongly-shed replica costs a rebuild; a wrongly-kept one only
    costs idle devices) — and any mixed signal resets both counters.
    Bounds: the verdict never leaves [n_min, n_max]."""

    def __init__(self, n_min: int, n_max: int, *,
                 interval_s: float | None = None, up_after: int = 2,
                 down_after: int = 6) -> None:
        self.n_min = max(1, int(n_min))
        self.n_max = max(self.n_min, int(n_max))
        if interval_s is None:
            raw = os.environ.get("GOFR_ML_ELASTIC_INTERVAL_S", "").strip()
            try:
                interval_s = float(raw) if raw else 2.0
            except ValueError:
                raise ValueError(
                    f"GOFR_ML_ELASTIC_INTERVAL_S must be seconds, "
                    f"got {raw!r}") from None
        if not 0.0 < float(interval_s) < float("inf"):
            raise ValueError(
                f"elastic interval must be finite and > 0, got {interval_s}")
        self.interval_s = float(interval_s)
        self.up_after = max(1, int(up_after))
        self.down_after = max(1, int(down_after))
        self._last = 0.0
        self._up_ticks = 0
        self._down_ticks = 0
        self.decisions = 0
        self.verdicts = {"up": 0, "down": 0}
        self.last_signal: dict = {}

    def decide(self, *, queued: int, free: int, outstanding: int,
               capacity: int, n_live: int, retry_after_s: float,
               slo_over: bool = False,
               now: float | None = None) -> int | None:
        """A target fleet size, or ``None`` (stay put). Interval-gated
        internally, like ``SLOController.maybe_update``."""
        now = time.monotonic() if now is None else now
        if now - self._last < self.interval_s:
            return None
        self._last = now
        self.decisions += 1
        pressure = (queued > max(0, free)
                    and (retry_after_s > self.interval_s or slo_over
                         or queued >= n_live))
        per_replica = capacity // max(1, n_live)
        idle = (queued == 0 and n_live > 1
                and outstanding * 2 <= max(0, capacity - per_replica))
        self.last_signal = {"queued": queued, "free": free,
                            "outstanding": outstanding,
                            "retry_after_s": round(retry_after_s, 3),
                            "slo_over": slo_over,
                            "pressure": pressure, "idle": idle}
        if pressure and n_live < self.n_max:
            self._down_ticks = 0
            self._up_ticks += 1
            if self._up_ticks >= self.up_after:
                self._up_ticks = 0
                self.verdicts["up"] += 1
                return min(self.n_max, n_live + 1)
        elif idle and n_live > self.n_min:
            self._up_ticks = 0
            self._down_ticks += 1
            if self._down_ticks >= self.down_after:
                self._down_ticks = 0
                self.verdicts["down"] += 1
                return max(self.n_min, n_live - 1)
        else:
            self._up_ticks = 0
            self._down_ticks = 0
        return None

    def snapshot(self) -> dict:
        return {
            "interval_s": self.interval_s,
            "bounds": {"min": self.n_min, "max": self.n_max},
            "hysteresis": {"up_after": self.up_after,
                           "down_after": self.down_after,
                           "up_ticks": self._up_ticks,
                           "down_ticks": self._down_ticks},
            "decisions": self.decisions,
            "verdicts": dict(self.verdicts),
            "last_signal": dict(self.last_signal),
        }


class _RoleSteer:
    """Prefill/decode role assignment, steered by the scheduler's SLO controller.

    Duck-types the ``TokenBudgetScheduler`` share contract
    (``prefill_share`` / ``set_share``) so ``scheduler.SLOController``
    drives the fleet ROLE RATIO with the exact AIMD policy it applies to
    a single core's budget split: fleet TPOT over target sheds a prefill
    replica (multiplicative backoff — decode capacity recovers first),
    fleet TTFT over target adds one (additive increase), both-in-target
    drifts back toward the configured split. Roles are positional —
    replicas ``[0, n_prefill)`` are prefill-biased — so a ratio change
    re-roles one replica at a time, and in-flight ships still land (a
    destination's host tier and radix trie don't care about its role).
    Bounds: always >= 1 prefill and >= 1 decode replica."""

    def __init__(self, n: int, n_prefill: int) -> None:
        self.n = int(n)
        self.n_prefill = min(max(1, int(n_prefill)), self.n - 1)
        self.initial = self.n_prefill
        self.changes = 0  # realized role-ratio transitions

    def role(self, idx: int) -> str:
        return "prefill" if idx < self.n_prefill else "decode"

    @property
    def prefill_share(self) -> float:
        return self.n_prefill / self.n

    def set_share(self, share: float) -> float:
        want = min(self.n - 1, max(1, round(float(share) * self.n)))
        if want != self.n_prefill:
            self.n_prefill = want
            self.changes += 1
        return self.prefill_share


def replicas_from_env(default: int = 1) -> int:
    """``GOFR_ML_REPLICAS`` as a replica count (>= 1). Malformed values
    fail loudly at startup, like a malformed fault spec."""
    raw = os.environ.get("GOFR_ML_REPLICAS", "").strip()
    if not raw:
        return max(1, int(default))
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"GOFR_ML_REPLICAS must be an integer, got {raw!r}") from None
    if n < 1:
        raise ValueError(f"GOFR_ML_REPLICAS must be >= 1, got {n}")
    return n


def split_devices(n: int, devices=None) -> list[list]:
    """Partition the cards into ``n`` contiguous subsets, one per replica.
    ``devices`` defaults to every visible CUDA card (none raises: a pool
    never quietly serves on the CPU; pass ``[torch.device("cpu")]`` for
    that). With fewer devices than replicas the replicas share them
    round-robin — on one card every replica gets ``cuda:0``; leftover
    devices that do not divide evenly go unused."""
    import torch

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass devices=[torch.device('cpu')] (or "
                "device='cpu' to register_llm) to run replicas on the host")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
        # "cuda" names the current card: index it, so replicas compare
        # the weights' device to theirs exactly
        devs = [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d for d in devs]
    if n < 1:
        raise ValueError(f"need at least one replica, got {n}")
    if not devs:
        raise ValueError("no devices to place replicas on")
    if len(devs) < n:
        return [[devs[i % len(devs)]] for i in range(n)]
    per = len(devs) // n
    return [devs[i * per:(i + 1) * per] for i in range(n)]


def spawn_devices(idx: int, devices=None, n_boot: int | None = None
                  ) -> list:
    """The device subset a replica added at pool index ``idx`` lands on,
    as JAX's default spawn picks it: with ``n_boot`` (the boot's replica
    count) the idx-th slice of ``len(devices) // n_boot`` devices (spares
    first: a tensor-parallel replica like the boot's) while one fits,
    else one device of ``devices`` (default every card) round-robin, as
    ``split_devices`` places replicas past the device count."""
    devs = [d for subset in split_devices(1, devices) for d in subset]
    if n_boot:
        per = max(1, len(devs) // n_boot)
        lo = idx * per
        if lo + per <= len(devs):
            return devs[lo:lo + per]
    return [devs[idx % len(devs)]]


def _params_on(params, device):
    """``params`` on ``device``: the SAME tree when every tensor already
    lives there (replicas sharing a card share the weights, as JAX's
    ``device_put`` onto an array's own device copies nothing), else a
    copy of the tree moved there."""
    import torch

    def on(tree) -> bool:
        if isinstance(tree, dict):
            return all(on(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return all(on(v) for v in tree)
        return not isinstance(tree, torch.Tensor) or tree.device == device

    def move(tree):
        if isinstance(tree, dict):
            return {k: move(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(move(v) for v in tree)
        return tree.to(device) if isinstance(tree, torch.Tensor) else tree

    return params if on(params) else move(params)


def build_replica_generators(params, cfg, n: int, *, warmup: bool = True,
                             devices=None, **gen_kwargs) -> list:
    """Build N Generators, one per device subset of ``split_devices``.
    Replicas on the same card share ``params`` (no copy); each owns its
    KV cache, page pool, host tier, decode graphs and (once served) its
    serving thread. A replica whose build or warmup fails fails the
    call.

    With sequence-parallel serving armed (``GOFR_ML_SP`` or an ``sp=``
    kwarg), a subset of several devices gets an sp mesh over them (the
    weights on its first): the replica prefills long prompts across them,
    which makes a disaggregated prefill-biased replica a sequence-parallel
    prefill worker. A one-device subset cannot shard: an explicit ``sp=``
    raises, an env-armed one stays off for it, as in JAX. A subset of
    several devices without SP is a tensor-parallel replica, as in JAX: a
    tp mesh over the subset, the weights split by ``llama.SHARDING_RULES``
    (``parallel.shard_params``: blocks on the weights' own device are
    views, so replicas on one card still share them) and a cache split by
    KV head."""
    from .. import parallel as par
    from ..models import llama
    from .generate import Generator
    from .sp_serving import SPConfig

    # an explicit sp=None means the same as absent (the Generator reads
    # the env): neither spelling lets a one-device replica build a mesh
    sp_req = gen_kwargs.get("sp")
    if sp_req is None:
        sp_req = SPConfig.from_env()
    gens = []
    for subset in split_devices(n, devices):
        kw = dict(gen_kwargs)
        dev = subset[0]
        mesh = None
        if len(subset) == 1:
            if gen_kwargs.get("sp"):
                raise ValueError(
                    f"sp= requested but replica {len(gens)} owns a "
                    f"single device ({dev}) — sequence parallelism needs "
                    f">= 2 devices per replica (fewer replicas, or more "
                    f"devices)")
            if sp_req is not None:
                kw["sp"] = False
        elif sp_req:
            mesh = par.make_mesh(par.MeshConfig(sp=len(subset)),
                                 devices=subset)
        else:
            mesh = par.make_mesh(
                par.mesh_shape_for(len(subset), tp=len(subset)),
                devices=subset)
        rep_params = _params_on(params, dev)
        if mesh is not None and mesh.shape["tp"] > 1:
            rep_params = par.shard_params(
                rep_params, llama.sharding_specs(rep_params), mesh)
        gen = Generator(rep_params, cfg, device=dev, mesh=mesh, **kw)
        if warmup:
            gen.warmup()
        gens.append(gen)
    return gens


class _CanaryProbe:
    """Primary-side shadow of one mirrored request: the client stream
    feeds it per burst (two attribute writes + an extend — no hashing
    until the request completes) so the judge can compare digests and
    latency against the canary's run of the same prompt."""

    __slots__ = ("out", "submit", "first", "last")

    def __init__(self) -> None:
        self.out: list[int] = []
        self.submit = time.perf_counter()
        self.first: float | None = None
        self.last: float | None = None

    def feed(self, burst) -> None:
        now = time.perf_counter()
        if self.first is None:
            self.first = now
        self.last = now
        self.out.extend(burst)

    def result(self) -> dict:
        n = len(self.out)
        return {
            "digest": token_digest(self.out) if self.out else None,
            "ttft_s": (self.first - self.submit
                       if self.first is not None else None),
            "tpot_s": ((self.last - self.first) / (n - 1)
                       if self.first is not None and n > 1 else None),
        }


class _FrontRequest:
    """One request parked at (or transiting) the fleet front."""

    __slots__ = ("prompt", "max_new", "priority", "enqueued_at",
                 "deadline_at", "n_tokens", "future", "loop", "prefix",
                 "attempts", "cancelled", "streamed", "routed_idx",
                 "last_replica", "want_role", "kv_holder", "rid", "journey",
                 "admits_charged")

    def __init__(self, prompt, max_new: int, priority: int,
                 deadline_s: float, prefix: int | None) -> None:
        # materialized: the prompt is replayed verbatim on failover (and
        # longest-matched against every replica trie), so a one-shot
        # iterable must be pinned down at admission
        self.prompt = list(prompt)
        self.max_new = max_new
        self.priority = priority
        self.enqueued_at = time.perf_counter()
        self.deadline_at = (self.enqueued_at + deadline_s
                            if deadline_s > 0 else None)
        self.n_tokens = len(self.prompt)
        self.future: asyncio.Future | None = None  # resolves to replica idx
        self.loop: asyncio.AbstractEventLoop | None = None  # owns future
        self.prefix = prefix          # FRONT pid (pool-level registration)
        self.attempts = 0             # completed failover reroutes
        self.admits_charged = 0       # admit marks the goodput ledger
        # already billed as failover_recompute (multi-hop reroutes must
        # not re-charge a hop that only ever queued the request)
        self.cancelled = False        # consumer went away while queued
        self.streamed = False         # a token reached the consumer
        self.routed_idx: int | None = None  # replica slot reserved for us
        self.last_replica: int | None = None  # avoid on reroute
        # disaggregated mode (GOFR_ML_DISAGG): which routing stage this
        # request is in ("prefill" while its KV computes on a prefill
        # replica; None/"decode" otherwise) and which decode replica the
        # transport landed its prefix pages on (route-affinity target)
        self.want_role: str | None = None
        self.kv_holder: int | None = None
        self.rid: str | None = None   # process-unique journey key
        self.journey = None           # the ONE fleet-spanning timeline


class ReplicaPool:
    """N per-replica serving cores behind one routing/admission front.

    Drop-in for ``LLMServer`` everywhere the datasource plane touches it:
    same async API (``generate``/``stream``/``stream_chunks`` with
    ``priority=``/``deadline_s=``/``prefix=``/``info=``), same sync prefix
    pinning API, same health/snapshot contract. Construction takes ready
    Generators (one per replica) — ``build_replica_generators`` builds
    them over distinct device subsets.
    """

    def __init__(self, generators, *, name: str = "llm", logger=None,
                 metrics=None, tracer=None, max_queue: int | None = None,
                 max_queued_tokens: int | None = None,
                 default_deadline_s: float | None = None,
                 depth_per_replica: int | None = None,
                 affinity_min_tokens: int | None = None,
                 fault: Any = None, disagg: Any = None,
                 spawn: Any = None, elastic: Any = None,
                 replicas_min: int | None = None,
                 replicas_max: int | None = None,
                 canary: Any = None,
                 profile_knobs: dict | None = None,
                 **server_kwargs) -> None:
        generators = list(generators)
        if not generators:
            raise ValueError("a replica pool needs at least one generator")
        self.name = name
        # -- disaggregated prefill/decode (ml/kv_transport.py) ---------------
        # GOFR_ML_DISAGG=1 (or disagg=True) splits the fleet into
        # prefill-biased and decode replicas over a KV transport; OFF is
        # the default and constructs NOTHING — the pool code path stays
        # byte-identical to the non-disaggregated behavior.
        self._disagg = disagg_from_env() if disagg is None else bool(disagg)
        self._transport = None
        self._roles = None
        self._role_ctl = None
        self._ship_min = 0
        if self._disagg:
            if len(generators) < 2:
                raise ValueError(
                    "disaggregated prefill/decode needs >= 2 replicas "
                    "(one prefill-biased + one decode)")
            for idx, gen in enumerate(generators):
                if not getattr(gen, "page_size", 0):
                    raise ValueError(
                        "disaggregated prefill/decode requires paged "
                        f"generators (page_size > 0); replica {idx} is "
                        "dense")
                # every replica needs a store even when the operator
                # left plain offload off (GOFR_ML_KV_HOST_BUDGET_MB
                # unset/0) — armed at a serviceable default budget
                _ensure_host_store(gen)
        self._logger = logger
        self._metrics = metrics
        self._tracer = tracer   # ml.route spans (one per routing attempt)
        self._events = event_log()  # fleet event log (flight_recorder.py)
        # goodput ledger (ml/goodput.py): the pool classifies the fleet-
        # level waste — failover re-prefills and migration cold starts —
        # under the POOL name; its cores classify their own device-token
        # fates under "name/idx". GOFR_ML_GOODPUT=0 disables both.
        self._goodput = goodput_ledger()
        # request journeys (journey.py): the FRONT owns one timeline per
        # request; replica cores mark into it, so a rerouted or disagg
        # two-stage request stays ONE record. GOFR_ML_JOURNEY=0 disables.
        self._journeys = journey_log()
        # traffic capture (ml/capture.py): the FRONT owns one capture
        # record per fleet request (cores skip — they see rid=); the
        # bundle's fleet block names this pool's shape. GOFR_ML_CAPTURE
        # unset/0 constructs nothing.
        self._capture = traffic_capture()
        self._cap_sampler = None
        if self._capture is not None:
            self._cap_sampler = sampler_snapshot(generators[0])
            self._capture.note_model(
                name, kind="pool", replicas=len(generators),
                slots=sum(g.batch_slots for g in generators))
        # routing-decision wall time: the pool's contribution to the
        # dispatch-phase breakdown (phase="route" of
        # app_llm_dispatch_phase_seconds) and the routing debug block
        self._route_decisions = 0
        self._route_time_s = 0.0
        # fleet-wide admission policy (env defaults mirror LLMServer's)
        self._max_queue = (int(os.environ.get("GOFR_ML_MAX_QUEUE", "0"))
                           if max_queue is None else int(max_queue))
        self._max_queued_tokens = (
            int(os.environ.get("GOFR_ML_MAX_QUEUED_TOKENS", "0"))
            if max_queued_tokens is None else int(max_queued_tokens))
        self._default_deadline = (
            float(os.environ.get("GOFR_ML_DEFAULT_DEADLINE_S", "0"))
            if default_deadline_s is None else float(default_deadline_s))
        # per-replica pipeline depth: how many requests may be in flight
        # toward one replica (its slots + a small staged margin so the
        # core can overlap prefill with decode). Routing freshness argues
        # small; slot utilization argues >= 1 extra wave.
        depth = (int(os.environ.get("GOFR_ML_REPLICA_DEPTH", "2"))
                 if depth_per_replica is None else int(depth_per_replica))
        depth = max(1, depth)
        # minimum trie match (tokens) that counts as cache affinity; below
        # it the router prefers balancing load over locality
        self._affinity_min = (
            int(os.environ.get("GOFR_ML_AFFINITY_MIN_TOKENS", "1"))
            if affinity_min_tokens is None else int(affinity_min_tokens))
        # the front's own chaos point ("route" + the elastic
        # scale_up/scale_down points); replica-independent
        self._fault = (FaultInjector.from_env() if fault is None
                       else (fault or None))
        # -- elastic fleet (runtime scale-up/down) ---------------------------
        # ``scale_to``/``add_replica``/``remove_replica`` work on ANY pool;
        # GOFR_ML_ELASTIC=1 (or elastic=True) additionally arms the
        # autoscale control loop. OFF plus no scale calls keeps the pool
        # path byte-identical to the static-fleet behavior: the only new
        # work on the hot path is one empty-set membership test.
        self._spawn = spawn          # builds a Generator for a new replica
        # the boot profile's knob map (register_llm applied it around THIS
        # construction): scale-ups re-apply it around every spawn call so
        # an elastic fleet never mixes tuned and untuned cores
        self._profile_knobs = dict(profile_knobs) if profile_knobs else None
        self._elastic = (elastic_from_env() if elastic is None
                         else bool(elastic))
        self._n_min = (_fleet_bound_from_env("GOFR_ML_REPLICAS_MIN", 1, 1)
                       if replicas_min is None else max(1, int(replicas_min)))
        self._n_max = (_fleet_bound_from_env("GOFR_ML_REPLICAS_MAX", 0, 0)
                       if replicas_max is None else max(0, int(replicas_max)))
        if self._n_max and self._n_max < self._n_min:
            raise ValueError(
                f"GOFR_ML_REPLICAS_MAX ({self._n_max}) < "
                f"GOFR_ML_REPLICAS_MIN ({self._n_min})")
        if self._disagg:
            # a disaggregated fleet can never drop below 2 (one prefill-
            # biased + one decode): floor the scale plane there so the
            # autoscaler can't loop on down-verdicts remove_replica must
            # reject, and scale_to(1) clamps instead of raising
            self._n_min = max(self._n_min, 2)
        # retired membership slots: indices are STABLE for the pool's
        # lifetime (every accounting list is positional), so a removed
        # replica keeps its index and joins this set instead of shifting
        # everyone behind it
        self._retired: set[int] = set()
        # serializes scale events; close() acquires it to SETTLE an
        # in-flight event before touching the membership list
        self._scale_lock = threading.Lock()
        self._scale_history: collections.deque[dict] = collections.deque(
            maxlen=32)
        self._scale_thread: threading.Thread | None = None
        self._steer = (_FleetSteer(self._n_min, self._n_max or 1_000_000)
                       if self._elastic else None)
        self._depth = depth
        self._server_kwargs = dict(server_kwargs)
        self._fault_arg = fault
        # per-replica cores: bounds/deadline/shedding DISABLED — the front
        # is the one place those policies run. The fault spec — env OR the
        # programmatic ``fault=`` injector — arms each core through the
        # same per-replica derivation (GOFR_ML_FAULT_REPLICA narrowing,
        # independent seed per replica) whether the replica exists from
        # construction or joins at runtime (seed offset = POOL index).
        self.replicas: list[LLMServer] = []
        for idx, gen in enumerate(generators):
            self.replicas.append(self._build_core(gen, idx))
        self._capacity = [max(1, g.batch_slots) * depth for g in generators]
        self._outstanding = [0] * len(generators)
        if self._disagg:
            from .kv_transport import KVTransport

            self._transport = KVTransport(name=name, metrics=metrics,
                                          tracer=tracer)
            self._roles = _RoleSteer(
                len(generators),
                _disagg_prefill_from_env(max(1, len(generators) // 2)))
            # the scheduler's SLO controller, LIFTED to the pool front: the same
            # AIMD loop that steers a single core's prefill share now
            # steers the fleet's prefill/decode ROLE RATIO from observed
            # fleet TTFT/TPOT (same GOFR_ML_TTFT_TARGET_MS /
            # GOFR_ML_TPOT_TARGET_MS targets)
            self._role_ctl = SLOController(
                self._roles,
                ttft_target_s=float(
                    os.environ.get("GOFR_ML_TTFT_TARGET_MS", "200")) / 1e3,
                tpot_target_s=float(
                    os.environ.get("GOFR_ML_TPOT_TARGET_MS", "50")) / 1e3,
                neutral_share=self._roles.initial / len(generators))
            # shortest prompt worth a prefill-stage ship: one whole page
            # plus a non-empty decode-side suffix
            self._ship_min = generators[0].page_size + 1
            # the controller's sample windows are written by consumer
            # coroutines on ANY loop/thread (the pool contract) and
            # read/cleared by the dispatcher's maybe_update — serialize
            # them (SLOController itself is single-thread by design)
            self._role_obs_lock = threading.Lock()
        # fleet ready queue — priority classes + aging, exactly once
        self._queue = AgingPriorityQueue(
            aging_s=float(os.environ.get("GOFR_ML_PRIORITY_AGING_S", "2.0")))
        self._admit_times: collections.deque[float] = collections.deque(
            maxlen=64)
        self._shed_counts = dict.fromkeys(PRIORITIES, 0)
        self._deadline_expired = 0
        self._routed = [collections.Counter() for _ in generators]
        self._failovers = 0
        self._dead_seen = [False] * len(generators)
        self._last_states = ["serving"] * len(generators)
        self.served = 0
        self._closed = False
        # parse the drain budget NOW so a malformed GOFR_ML_DRAIN_S is a
        # loud startup error, not a silent drop-everything at SIGTERM
        self._drain_default = drain_s_from_env()
        # prefix map is touched from executor threads (sync pin API) and
        # the event loop (routing) — it keeps its own lock
        self._prefix_lock = threading.Lock()
        self._next_pid = 1
        self._prefixes: dict[int, dict] = {}
        # request-plane lock: the fleet queue, per-replica slot accounting,
        # and shed/failover counters are touched from EVERY loop that
        # drives the pool (LLMServer supports one pool shared across
        # threads each running its own loop — so must the front). All
        # guarded sections are deque/int ops; futures are still resolved
        # on their owning loop, never under a foreign one.
        self._lock = threading.Lock()
        # dispatcher: pinned to the first loop that submits; consumers on
        # other loops enqueue through the lock and are woken on their own
        # loop by _resolve
        self._loop: asyncio.AbstractEventLoop | None = None
        self._wake: asyncio.Event | None = None
        self._dispatcher: asyncio.Task | None = None
        # -- shadow canary (GOFR_ML_CANARY / canary=) ------------------------
        # boot the candidate-profile core LAST: it rides the spawn=
        # factory and the settled pool state above. OFF constructs
        # nothing — the hot path's only new work is one is-not-None test.
        self._canary: _Canary | None = None
        self._canary_lock = threading.Lock()
        self._canary_last: dict | None = None  # the settled verdict block
        canary_req = canary if canary is not None else canary_from_env()
        if canary_req:
            try:
                self._boot_canary(canary_req)
            except BaseException:
                # a boot that fails leaves no serving thread behind
                self._closed = True
                for core in self.replicas:
                    core.close(0.0)
                raise

    # -- membership -----------------------------------------------------------
    def _build_core(self, gen, idx: int, name: str | None = None) -> LLMServer:
        """One serving core at pool index ``idx`` — the ONE construction
        path for replicas present at startup and replicas added at
        runtime, so the per-replica fault derivation (seed offset = pool
        index) and the disabled per-core bounds can never diverge."""
        ck = dict(self._server_kwargs)
        if self._fault_arg is None:
            core_fault = FaultInjector.from_env_for_replica(idx)
        elif self._fault is None:
            core_fault = None
        elif hasattr(self._fault, "for_replica"):
            core_fault = self._fault.for_replica(idx)
        else:
            # a bare callable hook (the LLMServer fault= contract):
            # no per-replica derivation to do — arm every core with it
            core_fault = self._fault
        ck.setdefault("fault", core_fault or False)
        core = LLMServer(
            gen, name=name or f"{self.name}/{idx}", logger=self._logger,
            metrics=self._metrics, tracer=self._tracer, max_queue=0,
            max_queued_tokens=0, default_deadline_s=0.0, **ck)
        # crash bundles on this core snapshot the CURRENT fleet shape —
        # in an elastic fleet "how many replicas" is a timestamped fact
        core.fleet_info = self._fleet_shape
        if core._capture is not None:
            # the capture bundle's fleet block names serving FRONTS; a
            # pool core never owns a capture record (it sees rid= from
            # this front), so its self-registration is withdrawn
            core._capture.forget_model(core.name)
        return core

    def _live_indices(self) -> list[int]:
        """Fleet membership: every index that has not been retired by a
        scale-down. (Set reads are GIL-atomic; callers that also need
        the accounting lists consistent hold ``self._lock``.)"""
        return [i for i in range(len(self.replicas))
                if i not in self._retired]

    def fleet_size(self) -> int:
        """Live (non-retired) replica count — the
        ``app_llm_fleet_size`` gauge."""
        return len(self._live_indices())

    def _fleet_shape(self) -> dict:
        """The membership snapshot crash bundles and scale events carry.
        Lock-free simple reads — this runs on core serving threads
        mid-crash and must never deadlock against the request plane."""
        retired = sorted(self._retired)
        return {
            "replicas": len(self.replicas) - len(retired),
            "states": {str(i): ("retired" if i in self._retired
                                else c.health())
                       for i, c in enumerate(self.replicas)},
            "retired": retired,
            "scale_events": len(self._scale_history),
        }

    # -- dispatcher -----------------------------------------------------------
    def _ensure_dispatcher(self) -> None:
        if self._closed:
            return  # close() already flushed; never spawn a new router
        loop = asyncio.get_running_loop()
        with self._lock:
            bound = self._loop
            if (self._dispatcher is not None and not self._dispatcher.done()
                    and bound is not None and not bound.is_closed()
                    and (bound is loop or bound.is_running())):
                return  # pinned dispatcher is alive — never rebind under it
            self._loop = loop
            self._wake = asyncio.Event()
            self._dispatcher = loop.create_task(
                self._dispatch_loop(), name=f"gofr-replica-router-{self.name}")

    def _kick(self) -> None:
        loop, wake = self._loop, self._wake
        if loop is None or wake is None:
            return
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is loop:
            wake.set()
        else:
            try:
                loop.call_soon_threadsafe(wake.set)
            except RuntimeError:
                pass  # dispatcher loop already shut down

    @staticmethod
    def _resolve(fr: _FrontRequest, *, result=None, exc=None,
                 cancel: bool = False) -> None:
        """Resolve a front request's future ON ITS OWNING LOOP — futures
        are not thread-safe, and with consumers on several loops the
        dispatcher must not touch a foreign loop's future directly."""
        fut, loop = fr.future, fr.loop
        if fut is None or loop is None:
            return

        def _do() -> None:
            if fut.done():
                return
            if cancel:
                fut.cancel()
            elif exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)

        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is loop:
            _do()
        else:
            try:
                loop.call_soon_threadsafe(_do)
            except RuntimeError:
                pass  # consumer loop is gone; its requests died with it

    async def _dispatch_loop(self) -> None:
        """The router: wake on submissions/completions, reap cancelled and
        expired queued requests, refresh replica states, and hand each
        admissible request to the replica the routing policy picks. Shared
        request-plane state is touched only under ``self._lock`` (consumers
        may live on other loops); futures resolve via ``_resolve``."""
        wake = self._wake
        if self._steer is not None:
            # elastic: an IDLE fleet keeps a slow heartbeat at the
            # controller interval — the down-scale half of the autoscaler
            # is precisely about fleets with no traffic, which would
            # otherwise never wake to shed a replica. A call_later chain
            # (not a task, not a wait_for) so loop teardown semantics
            # stay exactly the non-elastic ones: the dispatcher parks in
            # a plainly-cancellable wake.wait(), and the chain dies with
            # the pool (or a dispatcher re-home: the wake identity check).
            hb_loop = asyncio.get_running_loop()

            def _heartbeat() -> None:
                if self._closed or self._wake is not wake:
                    return
                wake.set()
                hb_loop.call_later(self._steer.interval_s, _heartbeat)

            hb_loop.call_later(self._steer.interval_s, _heartbeat)
        while not self._closed:
            if len(self._queue):
                # saturated: poll at 50 Hz so deadlines, recoveries, and
                # replica deaths are noticed even with no request events
                try:
                    await asyncio.wait_for(wake.wait(), 0.02)
                except asyncio.TimeoutError:
                    pass
            else:
                await wake.wait()
            wake.clear()
            if self._closed:
                return
            self._reap_queued()
            self._refresh_replicas()
            if self._role_ctl is not None:
                # disagg: re-steer the prefill/decode role ratio from the
                # fleet TTFT/TPOT windows (interval-gated internally)
                with self._role_obs_lock:
                    self._role_ctl.maybe_update()
            if self._steer is not None:
                # elastic: one fleet-size controller pass (interval-gated
                # internally); realized scale events run on a worker
                # thread, never on this loop
                self._maybe_autoscale()
            self._pump()

    def _reap_queued(self) -> None:
        """Front-queue hygiene: drop abandoned consumers, expire deadlines
        at the gate (never dispatched — the server's contract, fleet-wide)."""
        now = time.perf_counter()
        with self._lock:
            reaped = self._queue.prune(
                lambda fr: fr.cancelled or (fr.deadline_at is not None
                                            and now >= fr.deadline_at))
            self._deadline_expired += sum(
                1 for fr in reaped if not fr.cancelled)
        for fr in reaped:
            if fr.cancelled:
                self._resolve(fr, cancel=True)
                continue
            self._events.emit("deadline", model=self.name,
                              where="while queued (fleet)", rid=fr.rid,
                              priority=PRIORITIES[fr.priority])
            self._count("app_llm_deadline_exceeded_total", 1,
                        model=self.name)
            self._resolve(fr, exc=DeadlineExceeded(
                "request deadline exceeded while queued (fleet)"))

    def _refresh_replicas(self) -> None:
        """Observe per-replica health; a replica newly seen ``dead`` is a
        drain-and-reroute event (logged once) — its flushed requests come
        back through the failover path; the router just stops picking it.
        Runs on every dispatcher wake (up to 50 Hz with a backlog), so
        the state gauge is only written on a TRANSITION — the sampler
        pass (export_gauges) keeps it fresh between transitions."""
        for idx, core in enumerate(self.replicas):
            if idx in self._retired:
                continue  # scale-down already accounted for it
            state = core.health()
            if state == self._last_states[idx]:
                continue
            self._last_states[idx] = state
            if state == "dead" and not self._dead_seen[idx]:
                self._dead_seen[idx] = True
                if self._logger is not None:
                    try:
                        self._logger.error(
                            "llm replica dead; draining and rerouting",
                            model=self.name, replica=idx,
                            survivors=sum(
                                1 for c in self.replicas
                                if c.health() != "dead") )
                    except Exception:
                        pass
            if self._metrics is not None:
                try:
                    self._metrics.set_gauge(
                        "app_llm_replica_state",
                        float(_STATE_VALUE.get(state, 3)),
                        model=self.name, replica=str(idx))
                except Exception:
                    pass

    def _routable(self, idx: int) -> bool:
        if idx in self._retired or idx >= len(self.replicas):
            # retired by a scale-down, or a scale-up whose backfill has
            # touched the pin maps but whose core is not yet a member
            return False
        core = self.replicas[idx]
        return (not core._closed and not core._draining
                and core.health() in ("serving", "degraded"))

    def _load(self, idx: int) -> tuple[int, int]:
        # in-flight toward the replica plus anything it has internally
        # queued; the index breaks exact ties deterministically
        return (self._outstanding[idx] + self.replicas[idx].queue_depth(),
                idx)

    def _pump(self) -> None:
        parked: list[_FrontRequest] = []
        try:
            self._pump_inner(parked)
        finally:
            if parked:
                # skipped-this-round requests (pin holder at capacity) go
                # back to the FRONT of their class, original order kept;
                # the dispatcher's 50 Hz backlog poll retries them
                with self._lock:
                    for fr in reversed(parked):
                        self._queue.push_front(fr)

    def _pump_inner(self, parked: list[_FrontRequest]) -> None:
        while True:
            flushed: list[_FrontRequest] | None = None
            fr = None
            with self._lock:
                if not len(self._queue):
                    return
                candidates = [i for i in range(len(self.replicas))
                              if self._routable(i)
                              and self._outstanding[i] < self._capacity[i]]
                if not candidates:
                    live = self._live_indices()
                    if live and all(self.replicas[i].health() == "dead"
                                    for i in live):
                        # total fleet loss: nothing will ever route — flush
                        # the queue typed instead of parking consumers
                        flushed = self._queue.drain()
                else:
                    fr = self._queue.pop()
            if flushed is not None:
                err = self._dead_error()
                for dead_fr in flushed:
                    self._resolve(dead_fr, exc=err)
                return
            if fr is None:
                return  # capacity will free (or a recovery will finish)
            t_route = time.perf_counter()
            try:
                if self._fault is not None:
                    self._fault("route")  # chaos point: a poisoned router
                picked = self._route(fr, candidates)
            except Exception as exc:
                self._resolve(fr, exc=GeneratorCrashed(
                    f"routing dispatch failed "
                    f"({type(exc).__name__}: {exc})"))
                continue
            finally:
                self._note_route_time(time.perf_counter() - t_route)
            if picked is None:
                # holder busy: skip THIS request for the round but keep
                # pumping the rest of the queue (deadline reaping still
                # applies while it waits)
                parked.append(fr)
                continue
            if picked is _SKIP_PREFILL:
                # disagg stage 1 with no live prefill replica: tell the
                # consumer to skip the stage (full prefill on a decode
                # replica) — no slot reserved, no route accounting
                self._resolve(fr, result=(None, "no_prefill"))
                continue
            idx, reason = picked
            with self._lock:
                if (fr.cancelled or fr.future is None or fr.future.done()):
                    continue  # consumer raced away after the pop
                fr.routed_idx = idx
                self._outstanding[idx] += 1
                self._routed[idx][reason] += 1
                self._admit_times.append(time.perf_counter())
                if fr.attempts:
                    self._failovers += 1
            trace = (fr.journey.trace_id
                     if fr.journey is not None else None)
            extra = {"trace": trace} if trace is not None else {}
            self._events.emit("route", model=self.name, replica=idx,
                              reason=reason, attempt=fr.attempts,
                              rid=fr.rid, **extra)
            if fr.attempts:
                self._events.emit("failover", model=self.name, replica=idx,
                                  from_replica=fr.last_replica,
                                  attempt=fr.attempts, rid=fr.rid, **extra)
                self._count("app_llm_replica_failovers_total", 1,
                            model=self.name)
            self._count("app_llm_replica_routed_total", 1, model=self.name,
                        replica=str(idx), reason=reason)
            self._resolve(fr, result=(idx, reason))

    def _note_route_time(self, seconds: float) -> None:
        """One routing decision's wall time: the pool-side phase of the
        dispatch breakdown (LLMServer's recorder owns the rest)."""
        with self._lock:
            self._route_decisions += 1
            self._route_time_s += seconds
        if self._metrics is not None:
            try:
                self._metrics.record_histogram(
                    "app_llm_dispatch_phase_seconds", seconds,
                    model=self.name, phase="route")
            except Exception:
                pass

    def _route(self, fr: _FrontRequest,
               candidates: list[int]) -> tuple[int, str] | None:
        """Pick a replica for one request, or ``None`` to keep it parked.
        Explicit prefix pins route to a live holder; otherwise the
        deepest radix-trie match (>= the affinity floor) wins — that
        replica already holds the prompt's KV prefix — and ties/misses go
        least-loaded. A rerouted request avoids the replica that just
        failed it when any peer exists."""
        if fr.prefix is not None:
            with self._prefix_lock:
                info = self._prefixes.get(fr.prefix)
            by_replica = dict(info["by_replica"]) if info is not None else {}
            live = [i for i in by_replica
                    if self._routable(i)
                    and self.replicas[i].has_prefix(by_replica[i])]
            holders = [i for i in live if i in candidates]
            if holders:
                return min(holders, key=self._load), "affinity"
            if live:
                # a live holder exists but is at capacity: wait for its
                # slot instead of dispatching to a non-holder, which
                # could only answer with a spurious PrefixEvicted
                return None
            # no live holder anywhere: least-loaded replica raises the
            # PrefixEvicted contract at admission — the caller owns
            # re-registration
            return min(candidates, key=self._load), "least_loaded"
        if self._disagg:
            want = fr.want_role or "decode"
            rolewise = [i for i in candidates
                        if self._role_of(i) == want]
            if want == "prefill":
                # stage 1: the prompt's KV computes on a prefill-biased
                # replica. Busy prefill replicas park the request (their
                # capacity frees within a prefill); a fleet with NO live
                # prefill replica skips the stage outright.
                if rolewise:
                    return min(rolewise, key=self._load), "prefill"
                if any(self._routable(i)
                       and self._role_of(i) == "prefill"
                       for i in range(len(self.replicas))):
                    return None
                return _SKIP_PREFILL
            if (fr.kv_holder is not None
                    and fr.kv_holder != fr.last_replica):
                # stage 2 with shipped pages: the decode replica holding
                # them wins (restore beats re-prefill); if it is merely
                # at capacity, wait for its slot — any other replica
                # could only full-prefill
                if fr.kv_holder in candidates:
                    return fr.kv_holder, "affinity"
                if self._routable(fr.kv_holder):
                    return None
                fr.kv_holder = None  # holder died: the pages died with it
            if rolewise:
                candidates = rolewise
            elif any(self._routable(i)
                     and self._role_of(i) == "decode"
                     for i in range(len(self.replicas))):
                # decode replicas merely at capacity: wait for one
                # instead of re-mixing decode work onto a prefill
                # replica — which would reintroduce exactly the
                # prefill/decode interference disagg exists to remove
                return None
            # else: no decode replica alive — roles are a bias, not a
            # cage, so any routable replica serves (a degraded fleet
            # keeps completing requests)
        best, best_len = None, 0
        for i in candidates:
            cache = self.replicas[i].prefix_cache
            if cache is None:
                continue
            pid, reg_len = cache.peek(fr.prompt)
            if pid is not None and reg_len > best_len:
                best, best_len = i, reg_len
        if (best is not None and best_len >= self._affinity_min
                and (best != fr.last_replica or len(candidates) == 1)):
            return best, "affinity"
        pool = [i for i in candidates if i != fr.last_replica] or candidates
        return (min(pool, key=self._load),
                "failover" if fr.attempts else "least_loaded")

    def _sync_roles(self) -> None:
        """Re-fit the disagg role steer to the CURRENT live membership
        after a scale event (roles are positional over live ranks)."""
        if self._roles is None:
            return
        n = max(2, self.fleet_size())
        self._roles.n = n
        self._roles.n_prefill = min(max(1, self._roles.n_prefill), n - 1)

    def _role_of(self, idx: int) -> str:
        """A replica's disagg role, computed over its LIVE rank — roles
        are positional over the non-retired membership, so a scale event
        re-roles deterministically instead of leaving a hole in the
        prefill range."""
        if self._roles is None:
            return "decode"
        live = self._live_indices()
        try:
            rank = live.index(idx)
        except ValueError:
            return "decode"  # retired: never prefill-biased
        return self._roles.role(rank)

    # -- disaggregated prefill stage (GOFR_ML_DISAGG) -------------------------
    def _ship_ids(self, prompt: list) -> list:
        """The prefix actually shipped: the whole prompt, shaved one
        token when page-aligned — the decode-side admission always needs
        a non-empty suffix to prefill (mirrors the radix cache's
        ``_reg_len_for`` rule)."""
        ps = self.replicas[0].gen.page_size
        return prompt[:-1] if ps > 1 and len(prompt) % ps == 0 else prompt

    def _already_resident(self, prompt: list) -> bool:
        """True when some live replica's radix trie already covers the
        prefix a ship would compute — re-prefilling and re-shipping it
        would pay two serving threads and a handoff to overwrite the
        same key; stage 2's affinity routing finds the holder anyway.
        (A just-shipped-but-not-yet-restored prefix is invisible to
        ``peek`` and may re-ship once in that window — wasteful, never
        wrong.)"""
        want = len(self._ship_ids(prompt))
        for i, core in enumerate(self.replicas):
            cache = core.prefix_cache
            if (cache is not None and self._routable(i)
                    and cache.peek(prompt)[1] >= want):
                return True
        return False

    def _pick_decode_dst(self, src_idx: int) -> int | None:
        """The decode replica a ship targets: least-loaded live
        decode-role replica (any live replica when none is decode-role —
        a degraded fleet still lands pages somewhere useful)."""
        with self._lock:
            live = [i for i in range(len(self.replicas))
                    if i != src_idx and self._routable(i)
                    and self._role_of(i) == "decode"]
            if not live:
                live = [i for i in range(len(self.replicas))
                        if i != src_idx and self._routable(i)]
            return min(live, key=self._load) if live else None

    async def _disagg_prefill(self, fr: _FrontRequest,
                              parent=None) -> None:
        """Disaggregated stage 1: route the request to a prefill-biased
        replica, compute its prompt's whole-page prefix KV there, and
        ship the pages to the decode replica stage 2 will admit on
        (``fr.kv_holder``). EVERY failure — no live prefill replica, a
        ``ship``/``land`` fault, a replica dying under the export, an
        over-budget entry — leaves ``kv_holder`` unset and the request
        simply full-prefills on a decode replica: the transport may lose
        pages, never requests. Deadline/cancel semantics while queued for
        this stage are the fleet queue's own (reaped typed, never
        dispatched)."""
        fr.want_role = "prefill"
        try:
            fr.future = fr.loop.create_future()
            with self._lock:
                if self._closed:
                    raise self._closed_error()
                fr.routed_idx = None
                self._queue.push(fr)
            self._kick()
            idx, _reason = await self._await_routing(fr)
            if idx is None:
                return  # no live prefill replica: skip the stage
            if fr.journey is not None:
                fr.journey.mark("route", replica=idx, reason="prefill",
                                attempt=fr.attempts)
            try:
                dst = self._pick_decode_dst(idx)
                if dst is not None:
                    # a sequence-parallel prefill worker's pages left its
                    # devices as sp-striped shards: stamp the count on
                    # the ship's journey mark and fleet event
                    src_sp = getattr(self.replicas[idx].gen, "sp_stats",
                                     lambda: None)()
                    key = await asyncio.to_thread(
                        functools.partial(
                            self._transport.ship, self.replicas[idx],
                            self.replicas[dst], self._ship_ids(fr.prompt),
                            journey=fr.journey, rid=fr.rid, parent=parent,
                            shards=(src_sp or {}).get("shards", 0)))
                    if key is not None:
                        fr.kv_holder = dst
            finally:
                with self._lock:
                    self._outstanding[idx] -= 1
                    fr.routed_idx = None
                self._kick()
        finally:
            fr.want_role = "decode"

    # -- fleet admission bounds / shedding ------------------------------------
    def _admit(self, fr: _FrontRequest) -> None:
        """Fleet-wide queue-boundary admission control: same policy as the
        single-instance server (backlog-not-staging credit, lowest-priority
        -first shedding with preemption) but measured against the WHOLE
        fleet's queue and free capacity. Raises ``Overloaded`` when the
        arrival itself is the victim."""
        with self._lock:
            w = self._queue
            n_free = sum(
                max(0, self._capacity[i] - self._outstanding[i])
                for i in range(len(self.replicas)) if self._routable(i))
            over = ((self._max_queue > 0
                     and len(w) - n_free >= self._max_queue)
                    or (self._max_queued_tokens > 0 and len(w) > n_free
                        and w.tokens + fr.n_tokens > self._max_queued_tokens))
            if not over:
                return
            victim = w.shed_lowest(worse_than=fr.priority)
            self._note_shed(fr if victim is None else victim)
        if victim is None:
            raise self._overloaded()
        self._resolve(victim, exc=self._overloaded())

    def _note_shed(self, fr: _FrontRequest) -> None:
        prio = PRIORITIES[fr.priority]
        self._shed_counts[prio] += 1
        self._events.emit("shed", model=self.name, priority=prio,
                          rid=fr.rid,
                          queued=len(self._queue),
                          queued_tokens=self._queue.tokens)
        self._count("app_llm_shed_total", 1, model=self.name, priority=prio)

    def _finish_journey(self, fr: _FrontRequest, reason: str,
                        error: str | None = None) -> None:
        """Seal a front request's journey into retention (journey.seal —
        idempotent; a core may have sealed it first on natural
        completion)."""
        seal_journey(fr.journey, reason, error,
                     log=self._journeys, metrics=self._metrics)

    def _overloaded(self) -> Overloaded:
        retry_after = self._retry_after_s()
        return Overloaded(
            f"fleet overloaded ({len(self._queue)} queued, "
            f"{self._queue.tokens} queued tokens across "
            f"{len(self.replicas)} replicas); "
            f"retry in ~{retry_after:.1f}s", retry_after=retry_after)

    def _retry_after_s(self) -> float:
        """Retry-After from the AGGREGATE drain rate: the front's window
        holds dispatches across every replica, so scheduler.retry_after_s
        over it prices the fleet backlog, not one instance's."""
        return retry_after_s(self._admit_times, len(self._queue))

    def _flush_queue(self, exc: Exception) -> None:
        """Drain every parked request and fail it typed — each future on
        its own loop. Safe from any thread; used by close() and by
        waiters that outlive the dispatcher."""
        with self._lock:
            flushed = self._queue.drain()
        for fr in flushed:
            self._resolve(fr, exc=exc)

    # -- errors ---------------------------------------------------------------
    def _dead_error(self) -> GeneratorCrashed:
        return GeneratorCrashed(
            f"replica pool is dead: all {len(self._live_indices())} live "
            f"replicas exhausted their restart budgets")

    def _closed_error(self) -> Exception:
        live = self._live_indices()
        if not self._closed and live and all(
                self.replicas[i].health() == "dead" for i in live):
            return self._dead_error()
        return ServerClosed()

    # -- async API ------------------------------------------------------------
    async def stream_chunks(self, prompt_ids, max_new_tokens: int = 64,
                            prefix: int | None = None,
                            info: dict | None = None,
                            priority: int | str | None = None,
                            deadline_s: float | None = None,
                            mode: str = "chunks",
                            front: bool = False,
                            ) -> AsyncIterator[list[int]]:
        """Yield BURSTS of tokens, like ``LLMServer.stream_chunks``, with
        fleet semantics: the request parks in the fleet queue, routes to
        the best replica when one has capacity, and — if that replica
        crashes or dies before the first token reaches the consumer —
        transparently re-admits to a survivor with priority and deadline
        preserved (greedy reroutes are bit-identical). Once a token has
        been yielded a crash surfaces as the typed ``GeneratorCrashed``:
        the stream cannot be resumed mid-generation.

        ``front=True`` admits at the head of the request's priority class
        instead of the tail — the federation layer (``ml/federation.py``)
        re-admits a dead peer's queued work this way, so a host loss
        doesn't also cost those requests their queue position."""
        if self._closed:
            raise self._closed_error()
        prio = normalize_priority(priority)
        ttl = self._default_deadline if deadline_s is None else deadline_s
        if not ttl >= 0:  # rejects NaN too
            raise ValueError(f"deadline_s must be >= 0, got {ttl}")
        self._ensure_dispatcher()
        fr = _FrontRequest(prompt_ids, max_new_tokens, prio, ttl, prefix)
        fr.loop = asyncio.get_running_loop()
        fr.rid = next_rid()
        # the caller's request span, captured BEFORE any executor hop: the
        # per-attempt ml.route spans (and, through the core, ml.queue/
        # ml.decode) all parent here — so a rerouted request stays ONE
        # trace end-to-end, with the failover visible as a span event
        ctx = current_context()
        if self._journeys is not None:
            fr.journey = self._journeys.start(Journey(
                fr.rid, model=self.name,
                trace_id=ctx.trace_id if ctx is not None else None))
        cap_rec = None
        probe = None  # canary mirror: the primary-side digest/latency
        eff_info = info
        if self._capture is not None:
            # one capture record per FLEET request (the core skips: it
            # sees rid=); the private info dict recovers the real finish
            # reason when the caller passed none
            cap_rec = self._capture.admit(
                fr.rid, model=self.name, tokens=prompt_ids,
                max_new=max_new_tokens, priority=prio, deadline_s=ttl,
                mode=mode, sampler=self._cap_sampler,
                prefix=prefix is not None)
            if eff_info is None:
                eff_info = {}
        try:
            self._admit(fr)  # fleet shedding; may raise Overloaded
            if self._canary is not None:
                # shadow mirror: every Nth admitted request also replays
                # on the candidate core, fire-and-forget — its output is
                # judged against this stream's, never delivered
                probe = self._canary_pick(fr)
            if (self._disagg and fr.prefix is None
                    and fr.n_tokens >= self._ship_min
                    and not self._already_resident(fr.prompt)):
                # disagg stage 1: compute the prompt's prefix KV on a
                # prefill replica and ship it to the decode replica the
                # loop below will route to (full-prefill fallback on any
                # transport failure). Explicitly-pinned prefixes and
                # prompts whose prefix a live trie already holds skip
                # the stage: their pages exist — affinity routes there.
                await self._disagg_prefill(fr, ctx)
            last_burst = None
            while True:
                fr.future = fr.loop.create_future()
                route_span = None
                if self._tracer is not None:
                    route_span = self._tracer.start_span(
                        "ml.route", parent=ctx, activate=False,
                        attributes={"ml.model": self.name})
                    if fr.attempts:
                        # re-admission after a replica loss: the same
                        # trace carries the hop onto the survivor
                        route_span.add_event("ml.failover", {
                            "from_replica": fr.last_replica,
                            "attempt": fr.attempts})
                try:
                    with self._lock:
                        if self._closed:
                            # close() won the race to the flag: its flush
                            # has (or will have) drained the queue —
                            # joining it now would park this request
                            # forever
                            raise self._closed_error()
                        fr.routed_idx = None
                        if fr.attempts or front:
                            # rerouted work keeps its place at the head of
                            # its class (enqueued_at preserved, so aging
                            # continues); front=True gets the same slot on
                            # first admission (federated re-admits)
                            self._queue.push_front(fr)
                        else:
                            self._queue.push(fr)
                    self._kick()
                    idx, reason = await self._await_routing(fr)
                    if route_span is not None:
                        route_span.set_attributes({
                            "ml.replica": idx, "ml.route_reason": reason})
                    if fr.journey is not None:
                        # closes the fleet-queue-wait segment; the core's
                        # own marks (admit/prefill/decode) follow in the
                        # SAME timeline
                        fr.journey.mark("route", replica=idx,
                                        reason=reason, attempt=fr.attempts)
                    core = self.replicas[idx]
                    agen = None
                    try:
                        agen = core.stream_chunks(
                            fr.prompt, fr.max_new,
                            prefix=self._core_pid(fr.prefix, idx),
                            info=eff_info, priority=fr.priority,
                            deadline_s=self._remaining(fr),
                            rid=fr.rid, journey=fr.journey)
                        async for burst in agen:
                            if cap_rec is not None:
                                cap_rec.add_tokens(burst)
                            if probe is not None:
                                probe.feed(burst)
                            if self._role_ctl is not None and burst:
                                # fleet latency samples for the role
                                # controller: TTFT on the first burst,
                                # per-token cadence after it
                                now = time.perf_counter()
                                with self._role_obs_lock:
                                    if not fr.streamed:
                                        self._role_ctl.observe_ttft(
                                            now - fr.enqueued_at)
                                    elif last_burst is not None:
                                        self._role_ctl.observe_tpot(
                                            (now - last_burst)
                                            / len(burst))
                                last_burst = now
                            fr.streamed = True
                            yield burst
                        if cap_rec is not None:
                            digest = cap_rec.finish(
                                eff_info.get("finish_reason") or "stop")
                            if fr.journey is not None and digest is not None:
                                fr.journey.note(output_digest=digest)
                        if probe is not None:
                            # the pair judges once the canary half lands
                            self._canary_result(fr.rid, "primary",
                                                probe.result())
                            probe = None
                        with self._lock:
                            self.served += 1
                        return
                    except (GeneratorCrashed, ServerClosed) as exc:
                        if fr.streamed or self._closed:
                            raise
                        # survivors = live (non-retired) peers: a replica
                        # retired by scale-down rejects exactly like a
                        # dead one, and its flushed work re-admits here —
                        # same path, same ONE journey record
                        live = self._live_indices()
                        others = [i for i in live
                                  if i != idx
                                  and self.replicas[i].health() != "dead"]
                        if (not others
                                or fr.attempts >= 2 * len(self.replicas)):
                            if live and all(
                                    self.replicas[i].health() == "dead"
                                    for i in live):
                                raise self._dead_error() from exc
                            raise
                        fr.attempts += 1
                        fr.last_replica = idx
                        if self._goodput is not None:
                            # the survivor re-prefills the whole prompt —
                            # charged only when THIS hop's replica
                            # actually ADMITTED it (its prefill is real
                            # lost device work; a hop that merely queued
                            # the request cost nothing — tracked by
                            # comparing the journey's admit marks against
                            # what was already billed). With journeys off
                            # the admission evidence is gone: charge
                            # every hop, the conservative
                            # over-approximation.
                            if fr.journey is not None:
                                admits = fr.journey.count_mark("admit")
                                charge = admits > fr.admits_charged
                                fr.admits_charged = max(
                                    fr.admits_charged, admits)
                            else:
                                charge = True
                            if charge:
                                self._goodput.note(self.name,
                                                   "failover_recompute",
                                                   fr.n_tokens)
                        if route_span is not None:
                            # this attempt's outcome: the request moved
                            # on (the next attempt's span carries the
                            # ml.failover event), it did not fail
                            route_span.set_attribute(
                                "ml.finish_reason", "rerouted")
                        if self._logger is not None:
                            try:
                                self._logger.warnf(
                                    "llm %s: rerouting request off "
                                    "replica %d (%s); attempt %d",
                                    self.name, idx,
                                    type(exc).__name__, fr.attempts)
                            except Exception:
                                pass
                        continue
                    finally:
                        if agen is not None:
                            # close the core stream DETERMINISTICALLY so
                            # an abandoned consumer's slot is reclaimed
                            # now, not whenever async-generator GC
                            # finalization runs
                            await agen.aclose()
                        with self._lock:
                            self._outstanding[idx] -= 1
                            fr.routed_idx = None
                        self._kick()
                except Exception as exc:
                    if route_span is not None and route_span.end_time is None:
                        route_span.record_exception(exc)
                    raise
                finally:
                    if route_span is not None and route_span.end_time is None:
                        route_span.end()
        except Exception as exc:
            # the typed outcome seals the fleet journey (shed/deadline/
            # crashed/error) — natural completions were sealed by the
            # core at slot finish, so this never double-stamps
            if cap_rec is not None and not cap_rec.done:
                cap_rec.finish(_abort_reason(exc) or "error")
            if fr.journey is not None and not fr.journey.done:
                self._finish_journey(fr, _abort_reason(exc) or "error",
                                     str(exc))
            raise
        finally:
            if probe is not None:
                # the primary never completed (failed/abandoned): its
                # mirror pair can never judge — discard it
                self._canary_drop(fr.rid)
            with self._lock:
                fr.cancelled = True
                if fr.routed_idx is not None:
                    # the router reserved a slot but the consumer never
                    # resumed (cancelled between assignment and wakeup)
                    self._outstanding[fr.routed_idx] -= 1
                    fr.routed_idx = None
            self._kick()
            if cap_rec is not None and not cap_rec.done:
                cap_rec.finish("cancelled")
            if fr.journey is not None and not fr.journey.done:
                # consumer walked away mid-flight (GeneratorExit/aclose):
                # an abandonment, not a serving failure
                self._finish_journey(fr, "cancelled")

    async def _await_routing(self, fr: _FrontRequest) -> tuple[int, str]:
        """Wait for the router's verdict — ``(replica index, route
        reason)``. The dispatcher is pinned to the
        first loop that drove the pool; if that loop exits — or the
        dispatcher task dies — while requests from OTHER loops are still
        parked, the first waiter to notice re-homes the dispatcher onto
        its own loop, so nobody hangs on a dead router."""
        while True:
            try:
                return await asyncio.wait_for(asyncio.shield(fr.future), 0.25)
            except asyncio.TimeoutError:
                if self._closed:
                    # close() may have raced our push past its flush (or
                    # its flush never ran — dispatcher loop gone): flush
                    # here so every parked consumer resolves typed
                    self._flush_queue(ServerClosed())
                    continue  # our future now resolves on this very loop
                self._ensure_dispatcher()
                self._kick()

    async def stream(self, prompt_ids, max_new_tokens: int = 64,
                     prefix: int | None = None, info: dict | None = None,
                     priority: int | str | None = None,
                     deadline_s: float | None = None) -> AsyncIterator[int]:
        """Token-at-a-time view of ``stream_chunks``."""
        agen = self.stream_chunks(prompt_ids, max_new_tokens, prefix=prefix,
                                  info=info, priority=priority,
                                  deadline_s=deadline_s, mode="stream")
        try:
            async for burst in agen:
                for tok in burst:
                    yield tok
        finally:
            await agen.aclose()

    async def generate(self, prompt_ids, max_new_tokens: int = 64,
                       prefix: int | None = None, info: dict | None = None,
                       priority: int | str | None = None,
                       deadline_s: float | None = None) -> list[int]:
        """Collect the full completion."""
        out: list[int] = []
        async for burst in self.stream_chunks(prompt_ids, max_new_tokens,
                                              prefix=prefix, info=info,
                                              priority=priority,
                                              deadline_s=deadline_s,
                                              mode="generate"):
            out.extend(burst)
        return out

    def _remaining(self, fr: _FrontRequest) -> float:
        """The request's remaining deadline as the chosen core sees it
        (0 = none).
        Routing never dispatches an expired request, but the core enforces
        the mid-decode half of the contract with what's left."""
        if fr.deadline_at is None:
            return 0.0
        return max(fr.deadline_at - time.perf_counter(), 1e-3)

    # -- prefix pinning (sync API, mirrors LLMServer) -------------------------
    def _core_pid(self, front_pid: int | None, idx: int) -> int | None:
        if front_pid is None:
            return None
        with self._prefix_lock:
            info = self._prefixes.get(front_pid)
            core_pid = (info or {}).get("by_replica", {}).get(idx)
        if core_pid is None:
            raise PrefixEvicted(
                f"prefix {front_pid} has no live registration on replica "
                f"{idx} (its holder died); re-register and retry")
        return core_pid

    def register_prefix(self, prefix_ids, timeout_s: float = 120.0) -> int:
        """PIN a shared prefix on EVERY live replica (so affinity routing
        is free to pick any of them) and return one pool-level id. A
        replica that is dead — or fails the registration — is skipped; the
        pin succeeds if at least one replica holds it. The per-replica
        prefills fan out CONCURRENTLY (each core has its own serving
        thread), so the pin costs ~one prefill of wall time and one wedged
        replica cannot serialize the rest behind its timeout."""
        if self._closed:
            raise self._closed_error()
        ids = tuple(int(t) for t in prefix_ids)
        live = [(idx, self.replicas[idx]) for idx in self._live_indices()
                if self.replicas[idx].health() != "dead"]
        by_replica: dict[int, int] = {}
        last_exc: Exception | None = None
        if live:
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=len(live)) as pool:
                futs = {idx: pool.submit(core.register_prefix, ids, timeout_s)
                        for idx, core in live}
                for idx, fut in futs.items():
                    try:
                        by_replica[idx] = fut.result()
                    except Exception as exc:
                        last_exc = exc
        if not by_replica:
            raise last_exc if last_exc is not None else self._dead_error()
        with self._prefix_lock:
            pid = self._next_pid
            self._next_pid += 1
            self._prefixes[pid] = {
                "ids": ids,
                "by_replica": by_replica,
            }
        return pid

    def drop_prefix(self, pid: int, timeout_s: float = 30.0) -> None:
        """Release the pin on every replica that still holds it. The first
        per-replica failure is re-raised AFTER every replica was tried
        (a dead replica's pages are gone anyway)."""
        with self._prefix_lock:
            info = self._prefixes.pop(pid, None)
        if info is None:
            raise KeyError(f"unknown prefix id {pid}")
        first_exc: Exception | None = None
        for idx, core_pid in info["by_replica"].items():
            if idx >= len(self.replicas):
                continue  # backfilling scale-up not yet a member
            core = self.replicas[idx]
            if core.health() == "dead" or not core.has_prefix(core_pid):
                continue
            try:
                core.drop_prefix(core_pid, timeout_s)
            except Exception as exc:
                if first_exc is None:
                    first_exc = exc
        if first_exc is not None:
            raise first_exc

    def has_prefix(self, pid: int) -> bool:
        """True while at least one LIVE replica still holds the pin."""
        with self._prefix_lock:
            info = self._prefixes.get(pid)
            if info is None:
                return False
            by_replica = dict(info["by_replica"])
        return any(idx < len(self.replicas)
                   and self.replicas[idx].health() != "dead"
                   and self.replicas[idx].has_prefix(core_pid)
                   for idx, core_pid in by_replica.items())

    def check_admissible(self, prompt_ids, max_new_tokens: int = 1,
                         prefix: int | None = None) -> None:
        """Static shape admission check against one live replica (the
        replicas are homogeneous, so one answer covers the fleet). No
        replica able to answer is itself an admission failure — a dead
        fleet or a pin with no surviving holder must reject HERE, not
        deep inside the stream."""
        live = self._live_indices()
        for idx in live:
            core = self.replicas[idx]
            if core.health() == "dead":
                continue
            core_pid = None
            if prefix is not None:
                with self._prefix_lock:
                    info = self._prefixes.get(prefix)
                    core_pid = (info or {}).get("by_replica", {}).get(idx)
                if core_pid is None:
                    continue  # this replica lost the pin; try a holder
            core.check_admissible(prompt_ids, max_new_tokens,
                                  prefix=core_pid)
            return
        if live and all(self.replicas[i].health() == "dead" for i in live):
            raise self._dead_error()
        raise PrefixEvicted(
            f"prefix {prefix} has no live registration on any replica "
            f"(its holders died); re-register and retry")

    # -- elastic fleet: runtime scale-up/down + live KV migration -------------
    def _ensure_transport(self):
        """The KV transport, constructed on first need: disagg pools have
        one from construction; a plain elastic pool only builds it when a
        scale-down actually migrates. (The disagg request path gates on
        ``self._disagg``, never on transport existence, so arming the
        transport here cannot flip the pool into disaggregated
        routing.)"""
        if self._transport is None:
            from .kv_transport import KVTransport

            self._transport = KVTransport(name=self.name,
                                          metrics=self._metrics,
                                          tracer=self._tracer)
        return self._transport

    @staticmethod
    def _arm_host_tier(core: LLMServer) -> bool:
        """Migration moves pages THROUGH the host tier; arm a default
        store on a core whose operator left plain offload off (the disagg
        constructor's contract, applied lazily). False when the core
        cannot take one (dense cache)."""
        gen = core.gen
        if not getattr(gen, "page_size", 0):
            return False
        if getattr(gen, "host_kv", None) is None:
            _ensure_host_store(gen)
            gen.host_kv.model = core.name  # post-construction arming:
            # the LLMServer constructor's own stamp already ran
        return True

    def _call_spawn(self, idx: int, knobs: dict | None = None):
        """Build a Generator for pool index ``idx`` via the ``spawn=``
        factory (called with the index when its signature takes one, so
        a factory can place the replica on spare devices). ``knobs``
        overlays the environment around the call — default is the boot
        profile's map, so an elastic scale-up builds the same config the
        fleet booted with; pass ``{}`` to suppress (the canary boot
        applies its own candidate overlay instead)."""
        try:
            takes_idx = bool(inspect.signature(self._spawn).parameters)
        except (TypeError, ValueError):
            takes_idx = True
        if knobs is None:
            knobs = self._profile_knobs
        if knobs:
            from .tune import profile_overlay

            with profile_overlay(knobs):
                return self._spawn(idx) if takes_idx else self._spawn()
        return self._spawn(idx) if takes_idx else self._spawn()

    # -- shadow canary --------------------------------------------------------
    def _boot_canary(self, spec) -> None:
        """Construct the candidate core for one canary campaign: spawn a
        generator and build its ``LLMServer`` under the candidate
        profile's env overlay, bill everything it delivers to the
        ``canary`` waste reason, and start shadowing. The core is NOT a
        fleet member — no router ever picks it, no client ever reads
        it — until a promotion verdict appends it to the membership."""
        from .tune import load_profile, profile_overlay

        if self._spawn is None:
            raise ValueError(
                f"llm {self.name}: a shadow canary needs the spawn= "
                f"factory to build its candidate core — pass spawn=, or "
                f"register from (params, cfg), which wires a default")
        prof = load_profile(spec) if isinstance(spec, str) else dict(spec)
        knobs = prof.get("knobs")
        if not isinstance(knobs, dict) or not knobs:
            raise ValueError(
                f"llm {self.name}: canary profile has no 'knobs' map")
        knobs = {k: str(v) for k, v in knobs.items()}
        prof["knobs"] = knobs
        idx = len(self.replicas)  # the index a promotion would take
        with profile_overlay(knobs):
            gen = self._call_spawn(idx, knobs={})
            core = self._build_core(gen, idx, name=f"{self.name}/canary")
        # the ONE switch that keeps the goodput ledger balanced: every
        # token the candidate computes for a completed mirror bills as
        # ``canary`` waste (its output never reaches a client); crash/
        # deadline fates keep their own reasons
        core.delivery_reason = "canary"
        self._canary = _Canary(
            prof, core,
            sample_every=_fleet_bound_from_env("GOFR_ML_CANARY_SAMPLE",
                                               8, 1),
            window=_fleet_bound_from_env("GOFR_ML_CANARY_WINDOW", 16, 1))
        if self._logger is not None:
            try:
                self._logger.infof(
                    "llm %s: shadow canary armed (%s; mirror 1/%d, "
                    "window %d)", self.name, ",".join(sorted(knobs)),
                    self._canary.sample_every, self._canary.window)
            except Exception:
                pass

    def _canary_pick(self, fr: "_FrontRequest"):
        """Front-side sampling: every Nth admitted request is mirrored.
        Returns the primary-side probe (digest + latency accumulator)
        for a mirrored request, None otherwise. The mirror task is
        fire-and-forget on the caller's loop — nothing it does can
        surface on the client stream."""
        canary = self._canary
        if canary is None:
            return None
        with self._canary_lock:
            if self._canary is not canary or canary.decided:
                return None
            canary.seen += 1
            if canary.seen % canary.sample_every:
                return None
            canary.mirrored += 1
        if fr.journey is not None:
            # journey-tagged: the request's ONE fleet timeline records
            # that a shadow copy ran (the copy's own journey rides
            # "<rid>/canary")
            fr.journey.note(canary_mirrored=True)
        try:
            asyncio.get_running_loop().create_task(
                self._canary_run(canary, fr.rid, list(fr.prompt),
                                 fr.max_new, fr.priority,
                                 self._remaining(fr)))
        except RuntimeError:
            return None
        return _CanaryProbe()

    async def _canary_run(self, canary: "_Canary", rid: str, prompt,
                          max_new: int, prio: int, ttl: float) -> None:
        """Drive the candidate core through one mirrored request. The
        whole body is guarded: a canary-core crash is a ROLLBACK signal,
        never a client-visible failure."""
        out: list[int] = []
        first = last = None
        submit = time.perf_counter()
        try:
            # rid= makes the core skip capture (mirrors must not pollute
            # bundles) and tags the shadow journey
            agen = canary.core.stream_chunks(
                prompt, max_new, priority=prio, deadline_s=ttl,
                rid=f"{rid}/canary")
            try:
                async for burst in agen:
                    now = time.perf_counter()
                    if first is None:
                        first = now
                    last = now
                    out.extend(burst)
            finally:
                await agen.aclose()
        except Exception as exc:
            decide = None
            with self._canary_lock:
                if self._canary is canary and not canary.decided:
                    canary.errors += 1
                    canary.decided = True
                    canary.decide_reason = (
                        f"canary_error:{type(exc).__name__}")
                    decide = "rollback"
            if decide is not None:
                self._canary_settle(canary, decide)
            return
        n = len(out)
        self._canary_result(rid, "canary", {
            "digest": token_digest(out) if out else None,
            "ttft_s": (first - submit) if first is not None else None,
            "tpot_s": ((last - first) / (n - 1)
                       if first is not None and n > 1 else None),
        })

    def _canary_result(self, rid: str, side: str, data: dict) -> None:
        """Register one half of a mirrored pair; judge when both have
        landed. Identity is a per-request digest comparison — ONE
        mismatch disqualifies the candidate immediately."""
        canary = self._canary
        if canary is None:
            return
        decide = None
        with self._canary_lock:
            if self._canary is not canary or canary.decided:
                return
            pend = canary.pending.get(rid)
            if pend is not None and pend.get("dropped"):
                canary.pending.pop(rid, None)
                return
            if pend is None:
                pend = canary.pending[rid] = {}
            pend[side] = data
            if "canary" not in pend or "primary" not in pend:
                return
            canary.pending.pop(rid, None)
            canary.results.append({
                "identity": (pend["canary"]["digest"]
                             == pend["primary"]["digest"]),
                "ttft_s": pend["canary"]["ttft_s"],
                "tpot_s": pend["canary"]["tpot_s"],
                "primary_ttft_s": pend["primary"]["ttft_s"],
                "primary_tpot_s": pend["primary"]["tpot_s"],
            })
            decide = self._canary_decide_locked(canary)
        if decide is not None:
            self._canary_settle(canary, decide)

    def _canary_drop(self, rid: str) -> None:
        """The primary failed/was abandoned: its pair can never judge.
        Tombstone the rid so a late canary half is discarded too."""
        canary = self._canary
        if canary is None:
            return
        with self._canary_lock:
            pend = canary.pending.get(rid)
            if pend is not None and "canary" in pend:
                canary.pending.pop(rid, None)
            else:
                canary.pending[rid] = {"dropped": True}

    def _canary_decide_locked(self, canary: "_Canary") -> str | None:
        """The promotion verdict (holding ``_canary_lock``): any digest
        mismatch rolls back NOW; a full window of identity-true results
        promotes iff the candidate's median TTFT/TPOT stay within
        ``slo_slack`` of the primaries' over the same pairs."""
        if canary.decided:
            return None
        if any(not r["identity"] for r in canary.results):
            canary.decided = True
            canary.decide_reason = "identity"
            return "rollback"
        if len(canary.results) < canary.window:
            return None

        def _median(key: str) -> float | None:
            vals = sorted(r[key] for r in canary.results
                          if r.get(key) is not None)
            return vals[len(vals) // 2] if vals else None

        for ck, pk, label in (("ttft_s", "primary_ttft_s", "ttft"),
                              ("tpot_s", "primary_tpot_s", "tpot")):
            c, p = _median(ck), _median(pk)
            if c is not None and p is not None and p > 0 \
                    and c > canary.slo_slack * p:
                canary.decided = True
                canary.decide_reason = (
                    f"slo:{label} median {c * 1e3:.2f}ms > "
                    f"{canary.slo_slack:g}x primary {p * 1e3:.2f}ms")
                return "rollback"
        canary.decided = True
        canary.decide_reason = "verdict_ok"
        return "promote"

    def _canary_settle(self, canary: "_Canary", decide: str) -> None:
        """Realize a verdict OFF the request path: promotion takes the
        scale lock and rollback joins a serving thread — neither may
        block a consumer's stream loop."""
        threading.Thread(target=self._canary_apply, args=(canary, decide),
                         daemon=True,
                         name=f"gofr-canary-{self.name}").start()

    def _canary_apply(self, canary: "_Canary", decide: str) -> None:
        try:
            if decide == "promote":
                self._promote_canary(canary)
            else:
                self._rollback_canary(canary,
                                      canary.decide_reason or "rollback")
        except Exception as exc:
            if self._logger is not None:
                try:
                    self._logger.warnf(
                        "llm %s: canary %s failed (%s: %s)", self.name,
                        decide, type(exc).__name__, exc)
                except Exception:
                    pass

    def _promote_canary(self, canary: "_Canary") -> None:
        """The candidate earned fleet membership: append its (already
        warm, already serving) core to the membership lists under the
        scale lock — the same accounting order as ``add_replica`` — and
        flip its billing to ``delivered``. The core keeps its
        ``<pool>/canary`` name; the ledger's prefix rollup and the event
        log's model filter both already aggregate it."""
        with self._scale_lock:
            if self._closed or self._canary is not canary:
                return
            idx = len(self.replicas)
            core = canary.core
            if self._disagg:
                _ensure_host_store(core.gen)
            backfilled = self._backfill_pins(core, idx)
            if self._closed:
                with self._prefix_lock:
                    for info in self._prefixes.values():
                        info["by_replica"].pop(idx, None)
                return
            with self._canary_lock:
                self._canary = None
            canary.state = "promoted"
            # billing flips BEFORE the core becomes routable: a promoted
            # replica's answers are real deliveries
            core.delivery_reason = "delivered"
            with self._lock:
                self._capacity.append(
                    max(1, core.gen.batch_slots) * self._depth)
                self._outstanding.append(0)
                self._routed.append(collections.Counter())
                self._dead_seen.append(False)
                self._last_states.append("serving")
                self.replicas.append(core)
            self._sync_roles()
            self._canary_last = {
                "state": "promoted", "replica": idx,
                "knobs": dict(canary.profile["knobs"]),
                "mirrored": canary.mirrored,
                "results": len(canary.results),
                "at": round(time.time(), 3),
            }
            self._note_scale("scale_up", replica=idx, canary=True,
                             backfilled_pins=backfilled)
            self._events.emit("canary_promote", model=self.name,
                              replica=idx, mirrored=canary.mirrored,
                              window=len(canary.results),
                              knobs=dict(canary.profile["knobs"]))
            self._kick()

    def _rollback_canary(self, canary: "_Canary", reason: str) -> None:
        """The candidate is out: detach it (mirroring stops at the next
        is-None check) and close its core — no drain, nothing it holds
        was ever client-visible."""
        with self._canary_lock:
            if self._canary is not canary:
                return
            self._canary = None
        canary.state = "rolled_back"
        self._canary_last = {
            "state": "rolled_back", "reason": reason,
            "knobs": dict(canary.profile["knobs"]),
            "mirrored": canary.mirrored,
            "results": len(canary.results),
            "at": round(time.time(), 3),
        }
        self._events.emit("canary_rollback", model=self.name,
                          reason=reason, mirrored=canary.mirrored,
                          window=len(canary.results),
                          knobs=dict(canary.profile["knobs"]))
        if self._logger is not None:
            try:
                self._logger.warnf("llm %s: canary rolled back (%s)",
                                   self.name, reason)
            except Exception:
                pass
        try:
            canary.core.close(0.0)
        except Exception:
            pass

    def _canary_snapshot(self) -> dict | None:
        """The ``routing.canary`` debug block: live shadow state while a
        campaign runs, the settled verdict after it ends, None when the
        feature was never armed."""
        canary = self._canary
        if canary is None:
            return self._canary_last
        with self._canary_lock:
            return {
                "state": canary.state,
                "knobs": dict(canary.profile.get("knobs") or {}),
                "sample_every": canary.sample_every,
                "window": canary.window,
                "seen": canary.seen,
                "mirrored": canary.mirrored,
                "results": len(canary.results),
                "errors": canary.errors,
                "pending": len(canary.pending),
            }

    def _note_scale(self, kind: str, **data) -> None:
        """One realized scale event: history row, typed fleet event, and
        the ``app_llm_fleet_size`` gauge."""
        size = self.fleet_size()
        rec = {"kind": kind, "at": round(time.time(), 3),
               "fleet_size": size, **data}
        with self._lock:
            self._scale_history.append(rec)
        if self._capture is not None:
            # keep the capture bundle's fleet block a CURRENT fact: an
            # elastic fleet's replica count changes at runtime
            self._capture.note_model(
                self.name, kind="pool", replicas=size,
                slots=sum(self.replicas[i].gen.batch_slots
                          for i in self._live_indices()))
        # literal kinds: the event vocabulary is greppable (the doc-drift
        # guard reconciles .emit("…") literals against the doc table)
        if kind == "scale_up":
            self._events.emit("scale_up", model=self.name,
                              fleet_size=size, **data)
        else:
            self._events.emit("scale_down", model=self.name,
                              fleet_size=size, **data)
        if self._metrics is not None:
            try:
                self._metrics.set_gauge("app_llm_fleet_size", float(size),
                                        model=self.name)
            except Exception:
                pass
        if self._logger is not None:
            try:
                self._logger.infof("llm %s: %s -> fleet size %d",
                                   self.name, kind, size)
            except Exception:
                pass

    def add_replica(self, generator=None) -> int:
        """Grow the fleet by ONE replica and return its pool index. The
        new core is built from ``generator`` (or the ``spawn=`` factory —
        which builds, warms up and captures its decode graphs), every
        pool-pinned prefix is backfilled onto it, and only then does it
        become routable — a request can never route to a half-built
        replica. Serialized with other scale events and with close()
        (which aborts a half-built scale-up cleanly). Thread-safe, sync;
        call via ``asyncio.to_thread`` from async code."""
        with self._scale_lock:
            return self._add_replica_locked(generator)

    def _add_replica_locked(self, generator=None) -> int:
        if self._closed:
            raise self._closed_error()
        if self._n_max and self.fleet_size() >= self._n_max:
            raise ValueError(
                f"llm {self.name}: fleet already at its maximum of "
                f"{self._n_max} replicas (GOFR_ML_REPLICAS_MAX)")
        if self._fault is not None:
            self._fault("scale_up")  # chaos point: a poisoned scale-up
        t0 = time.perf_counter()
        idx = len(self.replicas)
        gen = generator
        if gen is None:
            if self._spawn is None:
                raise ValueError(
                    f"llm {self.name}: scale-up needs a generator — pass "
                    f"one to add_replica() or construct the pool with a "
                    f"spawn= factory")
            gen = self._call_spawn(idx)
        if self._disagg:
            if not getattr(gen, "page_size", 0):
                raise ValueError(
                    "disaggregated prefill/decode requires paged "
                    f"generators (page_size > 0); replica {idx} is dense")
            # armed BEFORE _build_core so the LLMServer constructor
            # stamps the store's model label, like a boot-time replica
            _ensure_host_store(gen)
        core = self._build_core(gen, idx)
        # backfill every pool-pinned prefix BEFORE the replica becomes
        # routable: affinity routing may hand it a prefix= request the
        # moment it joins, and _core_pid must find a live registration.
        backfilled = self._backfill_pins(core, idx)
        if self._closed:
            # close() raced the build and is waiting on the scale lock:
            # abort cleanly — the half-built core never becomes routable,
            # and its backfilled registrations leave the pin maps (they
            # die with the core)
            with self._prefix_lock:
                for info in self._prefixes.values():
                    info["by_replica"].pop(idx, None)
            core.close(0.0)
            raise self._closed_error()
        with self._lock:
            # accounting rows FIRST, the membership list LAST: any reader
            # that can see index ``idx`` finds its rows present
            self._capacity.append(
                max(1, gen.batch_slots) * self._depth)
            self._outstanding.append(0)
            self._routed.append(collections.Counter())
            self._dead_seen.append(False)
            self._last_states.append("serving")
            self.replicas.append(core)
        self._sync_roles()
        self._note_scale(
            "scale_up", replica=idx, backfilled_pins=backfilled,
            build_ms=round((time.perf_counter() - t0) * 1e3, 1))
        self._kick()
        return idx

    def _backfill_pins(self, core: LLMServer, idx: int) -> int:
        """Register every pool-pinned prefix on a core about to join the
        routable set at index ``idx``. A failed backfill skips THAT pin
        (existing holders still serve it; this core answers those
        requests through the holders-only router preference). Shared by
        scale-up and canary promotion — the two paths a warm core enters
        the fleet through."""
        with self._prefix_lock:
            pins = [(pid, info["ids"]) for pid, info in
                    self._prefixes.items()]
        backfilled = 0
        for pid, ids in pins:
            if self._closed:
                break
            try:
                core_pid = core.register_prefix(ids)
            except Exception:
                continue
            with self._prefix_lock:
                info = self._prefixes.get(pid)
                if info is not None:
                    info["by_replica"][idx] = core_pid
                    backfilled += 1
                    continue
            try:  # pin dropped while we backfilled: release the orphan
                core.drop_prefix(core_pid)
            except Exception:
                pass
        return backfilled

    def remove_replica(self, idx: int, *, migrate: bool = True,
                       drain_s: float | None = None) -> dict:
        """Shrink the fleet by retiring replica ``idx``: it leaves the
        routable set immediately, its hot radix subtrees MIGRATE to
        survivors through the KV transport (``migrate=False`` skips — the
        survivors cold-start those prefixes), and then the core drains
        exactly like the server's graceful close — in-flight decode finishes
        within ``drain_s``, staged work re-admits front-of-class on
        survivors with priority/deadline preserved and ONE journey record.
        Returns the migration tally. Refuses to remove the last live
        replica (and the second-to-last of a disaggregated fleet).
        Thread-safe, sync; call via ``asyncio.to_thread`` from async
        code."""
        with self._scale_lock:
            return self._remove_replica_locked(int(idx), migrate=migrate,
                                               drain_s=drain_s)

    def _remove_replica_locked(self, idx: int, *, migrate: bool = True,
                               drain_s: float | None = None) -> dict:
        if self._closed:
            raise self._closed_error()
        if not 0 <= idx < len(self.replicas) or idx in self._retired:
            raise ValueError(
                f"llm {self.name}: replica {idx} is not a live fleet "
                f"member")
        live = self._live_indices()
        if len(live) <= 1:
            raise ValueError(
                f"llm {self.name}: refusing to retire the last live "
                f"replica")
        if self._disagg and len(live) <= 2:
            raise ValueError(
                f"llm {self.name}: a disaggregated fleet needs >= 2 "
                f"replicas (one prefill-biased + one decode)")
        if self._fault is not None:
            self._fault("scale_down")  # chaos point: a poisoned scale-down
        t0 = time.perf_counter()
        core = self.replicas[idx]
        # 1) leave the routable set NOW: the router stops picking it, and
        # anything staged inside re-admits to survivors through the
        # failover path once the drain flushes it
        with self._lock:
            self._retired.add(idx)
            self._dead_seen[idx] = True   # a retire is not an incident:
            self._last_states[idx] = "retired"  # no dead-replica alarm
        self._sync_roles()
        self._kick()
        # 2) live KV migration: the scale event moves the cache instead
        # of discarding it. Every failure is ACCOUNTED (ledger) and
        # degrades to a cold start on the survivor — bit-identical, just
        # slower; a close() racing us cuts the loop short.
        tally = {"adopted": 0, "failed": 0, "skipped": 0}
        if migrate:
            tally = self._migrate_out(idx)
        # 3) the graceful drain: admission is already stopped pool-side;
        # in-flight decode finishes (bounded), queued work flushes typed
        # and re-routes
        if drain_s is None:
            drain_s = self._drain_default
        core.close(drain_s)
        with self._lock:
            self._capacity[idx] = 0
        with self._prefix_lock:
            # per-replica pin registrations died with the core
            for info in self._prefixes.values():
                info["by_replica"].pop(idx, None)
        self._note_scale(
            "scale_down", replica=idx, migrated=tally,
            drain_s=drain_s,
            wall_ms=round((time.perf_counter() - t0) * 1e3, 1))
        self._kick()
        return tally

    def _migrate_out(self, idx: int) -> dict:
        """Ship replica ``idx``'s hot radix subtrees (hit-count order) to
        the least-loaded survivors. Returns the per-outcome tally; the
        transport's ledger keeps the fleet-lifetime totals."""
        tally = {"adopted": 0, "failed": 0, "skipped": 0}
        src = self.replicas[idx]
        cache = src.prefix_cache
        if cache is None or not self._arm_host_tier(src):
            return tally  # nothing enumerable / no tier to move through
        transport = self._ensure_transport()
        for row in cache.hot_prefixes(limit=32):
            if self._closed:
                break  # close() is settling us: fall back, don't stall
            dst_idx = self._pick_migrate_dst(idx)
            if dst_idx is None:
                break  # no survivor can take pages: cold starts for all
            dst = self.replicas[dst_idx]
            if not self._arm_host_tier(dst):
                continue
            outcome = transport.migrate(src, dst, row["ids"], row["pid"],
                                        src_idx=idx, dst_idx=dst_idx)
            tally[outcome] += 1
            if outcome == "failed" and self._goodput is not None:
                # the pages left the draining replica and were lost on
                # the way: the prefix cold-starts (re-prefills) on the
                # survivor — already-paid device work, classified here
                self._goodput.note(self.name, "migration_cold",
                                   len(row["ids"]))
        return tally

    def _pick_migrate_dst(self, src_idx: int) -> int | None:
        """Least-loaded routable survivor with a paged cache (decode-role
        preferred under disagg — migrated pages serve decode-side
        restores)."""
        with self._lock:
            cands = [i for i in range(len(self.replicas))
                     if i != src_idx and self._routable(i)
                     and getattr(self.replicas[i].gen, "page_size", 0)]
            if self._disagg:
                decode = [i for i in cands if self._role_of(i) == "decode"]
                cands = decode or cands
            return min(cands, key=self._load) if cands else None

    def scale_to(self, n: int, *, migrate: bool = True,
                 drain_s: float | None = None) -> int:
        """Scale the fleet to ``n`` live replicas (clamped to the
        min/max bounds): repeated ``add_replica`` (needs ``spawn=``) or
        ``remove_replica`` of the least-loaded member, one at a time
        under the scale lock. Returns the realized size. Sync, like the
        other scale calls."""
        n = int(n)
        if n < 1:
            raise ValueError(f"llm {self.name}: cannot scale to {n}")
        n = max(n, self._n_min)
        if self._n_max:
            n = min(n, self._n_max)
        with self._scale_lock:
            while not self._closed and self.fleet_size() < n:
                self._add_replica_locked(None)
            while not self._closed and self.fleet_size() > n:
                idx = self._pick_retire_idx()
                if idx is None:
                    break
                self._remove_replica_locked(idx, migrate=migrate,
                                            drain_s=drain_s)
            return self.fleet_size()

    def _pick_retire_idx(self) -> int | None:
        """The scale-down victim: the least-loaded live replica, highest
        index on ties (LIFO — runtime-added replicas go first, keeping
        the construction-time fleet, and its device placement, stable)."""
        live = self._live_indices()
        if len(live) <= 1:
            return None
        with self._lock:
            return min(live,
                       key=lambda i: (self._outstanding[i]
                                      + self.replicas[i].queue_depth(),
                                      -i))

    def _maybe_autoscale(self) -> None:
        """One autoscale controller pass (dispatcher loop, elastic armed):
        read the fleet signals under the lock, ask the steer for a
        verdict, and realize it on a worker thread — scale events build
        cores and drain replicas, which must never block routing."""
        if self._scale_thread is not None and self._scale_thread.is_alive():
            return  # one scale event at a time; the next pass re-reads
        with self._lock:
            routable = [i for i in self._live_indices()
                        if self._routable(i)]
            n_live = len(routable) or self.fleet_size()
            free = sum(max(0, self._capacity[i] - self._outstanding[i])
                       for i in routable)
            outstanding = sum(self._outstanding[i] for i in routable)
            capacity = sum(self._capacity[i] for i in routable)
            queued = len(self._queue)
            retry = retry_after_s(self._admit_times, queued)
        slo_over = False
        if self._role_ctl is not None:
            # the lifted SLO controller's last verdict doubles as a
            # scale signal: TTFT persistently over target means role
            # re-balancing alone is not keeping up
            p95, target = (self._role_ctl.last_ttft_p95,
                           self._role_ctl.ttft_target_s)
            slo_over = p95 == p95 and p95 > target
        target_n = self._steer.decide(
            queued=queued, free=free, outstanding=outstanding,
            capacity=capacity, n_live=n_live, retry_after_s=retry,
            slo_over=slo_over)
        if target_n is None or target_n == n_live:
            return
        if target_n > n_live and self._spawn is None:
            return  # cannot build cores: scale-up needs the factory
        t = threading.Thread(target=self._autoscale_to, args=(target_n,),
                             daemon=True,
                             name=f"gofr-elastic-{self.name}")
        self._scale_thread = t
        t.start()

    def _autoscale_to(self, n: int) -> None:
        try:
            self.scale_to(n)
        except Exception as exc:
            if self._logger is not None:
                try:
                    self._logger.warnf(
                        "llm %s: autoscale to %d failed (%s: %s)",
                        self.name, n, type(exc).__name__, exc)
                except Exception:
                    pass

    # -- observability / datasource contract ----------------------------------
    def queue_depth(self) -> int:
        with self._lock:
            fleet = len(self._queue)
        return fleet + sum(c.queue_depth() for c in self.replicas)

    def pinned_prefix_tokens(self, limit: int = 32) -> list[list[int]]:
        """Token runs of the pool-level pinned prefixes — what a joining
        federated host backfills (federation's pin_sync), exactly
        like ``_backfill_pins`` warms a runtime-built replica."""
        with self._prefix_lock:
            rows = [list(map(int, meta["ids"]))
                    for meta in self._prefixes.values()]
        return rows[:limit]

    def hot_prefix_rows(self, limit: int = 16) -> list[dict]:
        """The pool's hottest cached prefixes — pins first, then each
        live replica's radix rows hit-descending, deduped by token run.
        Each row: ``{"ids": [tok, ...], "pinned": bool}``. This is the
        digest-summary source the federation layer gossips (peers match
        ``token_digest(prompt[:len])`` against it) and the migration
        worklist of a leaving host."""
        rows: list[dict] = []
        seen: set[tuple] = set()

        def _add(ids, pinned: bool) -> None:
            toks = [int(t) for t in ids]
            key = tuple(toks)
            if toks and key not in seen:
                seen.add(key)
                rows.append({"ids": toks, "pinned": pinned})

        for ids in self.pinned_prefix_tokens(limit):
            _add(ids, True)
        for i in self._live_indices():
            cache = getattr(self.replicas[i], "prefix_cache", None)
            if cache is None:
                continue
            for row in cache.hot_prefixes(limit):
                _add(row["ids"], False)
        return rows[:limit]

    def health(self) -> str:
        """``serving`` — every live replica healthy; ``degraded`` — ANY
        live replica dead, recovering, or degraded (capacity is reduced
        but requests still complete); ``dead`` — every live replica dead
        (or the pool is closed): nothing will complete. Replicas RETIRED
        by a scale-down are not fleet members and never count — a scaled-
        down fleet is healthy, not degraded."""
        states = [self.replicas[i].health() for i in self._live_indices()]
        if self._closed or not states or all(s == "dead" for s in states):
            return "dead"
        if any(s != "serving" for s in states):
            return "degraded"
        return "serving"

    def health_check(self) -> dict:
        state = self.health()
        status = {"serving": "UP", "degraded": "DEGRADED",
                  "dead": "DOWN"}[state]
        return {
            "status": status,
            "details": {
                "model": self.name,
                "state": state,
                "replicas": {str(i): ("retired" if i in self._retired
                                      else c.health())
                             for i, c in enumerate(self.replicas)},
                "fleet_size": self.fleet_size(),
                "queued": self.queue_depth(),
                "served": self.served,
                "failovers": self._failovers,
            },
        }

    def routing_snapshot(self) -> dict:
        """The ``routing`` block of ``/debug/serving``: fleet queue state,
        per-replica capacity/load/states, realized routing-reason mix,
        failover and shed counters, and the armed fault config. Reads
        simple attributes only — safe from any thread."""
        with self._prefix_lock:
            pinned = len(self._prefixes)
        fault_snap = fault_snapshot(self._fault)
        # taken BEFORE self._lock: the canary methods never nest the two
        # locks the other way, keeping the order acyclic
        canary_snap = self._canary_snapshot()
        with self._lock:
            return {
                "replicas": len(self.replicas),
                "states": {str(i): ("retired" if i in self._retired
                                    else c.health())
                           for i, c in enumerate(self.replicas)},
                "capacity": list(self._capacity),
                "outstanding": list(self._outstanding),
                "waiting": self._queue.snapshot(),
                "queued": len(self._queue),
                "queued_tokens": self._queue.tokens,
                "routed": {str(i): dict(counts)
                           for i, counts in enumerate(self._routed)},
                "failovers": self._failovers,
                "shed": dict(self._shed_counts),
                "deadline_expired": self._deadline_expired,
                "queue_bounds": {
                    "max_requests": self._max_queue or None,
                    "max_tokens": self._max_queued_tokens or None,
                },
                "route_stall": {
                    # the pool's phase of the dispatch breakdown (the
                    # per-core phases live in replicas.<idx>.stalls)
                    "decisions": self._route_decisions,
                    "total_s": round(self._route_time_s, 6),
                },
                "affinity_min_tokens": self._affinity_min,
                "pinned_prefixes": pinned,
                "default_deadline_s": self._default_deadline or None,
                "fault": fault_snap,
                "fault_replica": FaultInjector.armed_replica(),
                # disaggregated prefill/decode: roles + the transport
                # ledger (ships/lands/failures/bytes) + the lifted SLO
                # controller's state; None whenever GOFR_ML_DISAGG is off
                "disagg": (None if not self._disagg else {
                    "prefill_replicas": self._roles.n_prefill,
                    "roles": {str(i): self._role_of(i)
                              for i in range(len(self.replicas))},
                    "role_changes": self._roles.changes,
                    "ship_min_tokens": self._ship_min,
                    "controller": self._role_ctl.snapshot(),
                    **self._transport.snapshot(),
                }),
                # shadow canary: live campaign state while one shadows,
                # the settled promote/rollback verdict after, None when
                # GOFR_ML_CANARY was never armed
                "canary": canary_snap,
                # elastic fleet: membership bounds + autoscale controller
                # + the realized scale events and the migration ledger
                # (ships == adoptions + failures, the scale-event
                # acceptance contract)
                "elastic": {
                    "armed": self._elastic,
                    "size": len(self.replicas) - len(self._retired),
                    "min": self._n_min,
                    "max": self._n_max or None,
                    "retired": sorted(self._retired),
                    "spawn": self._spawn is not None,
                    "controller": (self._steer.snapshot()
                                   if self._steer is not None else None),
                    "events": list(self._scale_history),
                    "migrations": (
                        self._transport.snapshot()["migrations"]
                        if self._transport is not None else None),
                },
            }

    def export_gauges(self, metrics) -> None:
        """Per-replica gauges for the sampler pass (states are also kept
        fresh by the dispatcher between scrapes). ``app_llm_active_slots``
        keeps its single-server label (``model=<name>``, now the fleet
        total) so existing dashboards and alerts survive flipping
        replicas on; per-replica occupancy is the ``replica``-labelled
        series."""
        total_live = 0
        for idx, core in enumerate(self.replicas):
            if idx in self._retired:
                continue  # not a fleet member: no state/occupancy series
            try:
                total_live += core.gen.n_live
                metrics.set_gauge(
                    "app_llm_replica_state",
                    float(_STATE_VALUE.get(core.health(), 3)),
                    model=self.name, replica=str(idx))
                metrics.set_gauge(
                    "app_llm_replica_outstanding",
                    float(self._outstanding[idx]),
                    model=self.name, replica=str(idx))
            except Exception:
                pass
        try:
            metrics.set_gauge("app_llm_active_slots", float(total_live),
                              model=self.name)
            metrics.set_gauge("app_llm_fleet_size",
                              float(self.fleet_size()), model=self.name)
        except Exception:
            pass

    def _count(self, name: str, value: int, **labels) -> None:
        if self._metrics is None:
            return
        try:
            self._metrics.add_counter(name, value, **labels)
        except Exception:
            pass

    def close(self, drain_s: float | None = None) -> None:
        """Close the whole fleet. ``drain_s`` (default ``GOFR_ML_DRAIN_S``)
        drains the replicas gracefully — admission stops, in-flight decode
        finishes — before teardown; queued front requests flush with the
        typed closed error. The deadline is ONE shared budget: every
        replica decodes toward it concurrently (each has its own serving
        thread), and each close call gets only what remains, so SIGTERM
        teardown is bounded by ``drain_s``, not ``N * drain_s``."""
        if self._closed:
            return
        with self._lock:
            if self._closed:
                return
            self._closed = True
        # SETTLE any in-flight scale event before touching membership:
        # scale workers see the closed flag — a half-built scale-up
        # aborts cleanly (its core never becomes routable), a migrating
        # scale-down cuts its migration loop short and finishes its
        # drain — and only then does teardown proceed, so close() and a
        # scale event can never race the membership list. (Lock order is
        # consistent: _lock above was released before this acquire;
        # scale workers take _scale_lock first, _lock only briefly
        # inside.)
        self._scale_lock.acquire()
        self._scale_lock.release()
        # the shadow canary is not a fleet member: detach and close it
        # here, no drain — nothing it holds was ever client-visible. (A
        # promotion that won the scale lock above already moved its core
        # into self.replicas and cleared this slot.)
        with self._canary_lock:
            canary = self._canary
            self._canary = None
        if canary is not None:
            try:
                canary.core.close(0.0)
            except Exception:
                pass
        if drain_s is None:
            drain_s = self._drain_default
        if drain_s > 0:
            self._events.emit("drain", model=self.name, drain_s=drain_s,
                              queued=len(self._queue))
        drain_deadline = time.monotonic() + max(0.0, drain_s)
        loop, dispatcher = self._loop, self._dispatcher

        def _flush() -> None:
            self._kick()
            self._flush_queue(ServerClosed())
            if dispatcher is not None:
                dispatcher.cancel()

        scheduled = False
        if loop is not None and not loop.is_closed():
            try:
                running = asyncio.get_running_loop()
            except RuntimeError:
                running = None
            if running is loop:
                _flush()
                scheduled = True
            else:
                try:
                    loop.call_soon_threadsafe(_flush)
                    scheduled = True
                except RuntimeError:
                    pass  # loop shut down between the check and the call
        if not scheduled:
            # dispatcher loop gone (or never bound): flush inline so
            # consumers parked from OTHER loops still resolve typed
            self._flush_queue(ServerClosed())
        for core in self.replicas:
            core.close(max(0.0, drain_deadline - time.monotonic()))
