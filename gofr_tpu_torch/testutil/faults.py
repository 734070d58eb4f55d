"""Fault injection for the serving plane — counterpart of
``gofr_tpu/testutil/faults.py``.

``GOFR_ML_FAULT`` arms faults at named points of the dispatch path so the
watchdog, crash recovery and the typed errors are exercised. Spec grammar,
comma-separated::

    point:rate[:ExcName]

    GOFR_ML_FAULT=step:0.02:RuntimeError
    GOFR_ML_FAULT=step:0.05,restore:1:OSError

Every point of ``FAULT_POINTS`` parses, as in the JAX package. A single
server fires five of them, at the JAX package's places, on the host before
the dispatch each guards (never inside a CUDA-graph capture):

- ``step``     — a decode dispatch (``Generator.step``)
- ``prefill``  — a prompt, suffix or chunked-prefill segment prefill
- ``spill``    — a device-to-host KV offload (``Generator._spill_prefix``)
- ``restore``  — a host-to-device KV restore (``Generator.restore_prefix``)
- ``emit``     — the token-burst callback into the serving layer

A replica pool (``ml/replica.py``) fires the fleet's points: ``route``
(the routing decision), ``ship`` / ``land`` (the KV transport's export and
import on the cores' serving threads), ``scale_up`` / ``scale_down`` (a
scale event) and ``migrate`` (a scale-down's export). Each core gets its
own injector (``for_replica``: base seed + index), and
``GOFR_ML_FAULT_REPLICA=i`` narrows the spec to replica ``i``. The
cross-host points (``peer_*``, ``ml/multihost.py``'s framing) and the
sequence-parallel ones (``sp_prefill``, ``sp_gather``) parse here; the
latter fire in the Generator's sequence-parallel prefill.

The injector exists only when the knob is set (``from_env`` returns None
otherwise) and the call sites guard with ``is not None``. Draws come from a
dedicated ``random.Random`` seeded by ``GOFR_ML_FAULT_SEED`` (default
1234), so a fault sequence repeats run to run.
"""

from __future__ import annotations

import builtins
import os
import random

__all__ = ["FAULT_POINTS", "FaultInjector", "InjectedFault",
           "fault_snapshot"]

FAULT_POINTS = ("step", "prefill", "spill", "restore", "emit", "route",
                "ship", "land", "scale_up", "scale_down", "migrate",
                "sp_prefill", "sp_gather", "peer_send", "peer_recv",
                "peer_partition")


class InjectedFault(RuntimeError):
    """The default injected fault: a ``RuntimeError``, so whatever
    supervises real device failures supervises this too."""


def _resolve_exc(name: str) -> type[BaseException]:
    exc = getattr(builtins, name, None)
    if isinstance(exc, type) and issubclass(exc, BaseException):
        if not issubclass(exc, Exception):
            # KeyboardInterrupt/SystemExit would bypass the watchdog's
            # ``except Exception`` and kill the serving thread outright
            raise ValueError(f"refusing to inject {name}: not supervisable")
        return exc
    raise ValueError(f"unknown exception type {name!r} in fault spec")


class FaultInjector:
    """A parsed ``GOFR_ML_FAULT`` spec with per-point counters. Callable:
    ``injector(point)`` raises the configured exception with probability
    ``rate``, and otherwise only counts the attempt."""

    def __init__(self, points: dict[str, tuple[float, type[BaseException]]],
                 seed: int | None = None) -> None:
        for name in points:
            if name not in FAULT_POINTS:
                raise ValueError(
                    f"unknown fault point {name!r} (one of {FAULT_POINTS})")
        self.points = dict(points)
        self.seed = 1234 if seed is None else int(seed)
        self._rng = random.Random(self.seed)
        self.attempts: dict[str, int] = dict.fromkeys(FAULT_POINTS, 0)
        self.injected: dict[str, int] = dict.fromkeys(FAULT_POINTS, 0)

    @classmethod
    def parse(cls, spec: str, seed: int | None = None) -> "FaultInjector":
        """Parse a spec string; a malformed entry raises ValueError, so a
        mistyped chaos config fails the boot instead of never firing."""
        points: dict[str, tuple[float, type[BaseException]]] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            if len(fields) not in (2, 3):
                raise ValueError(
                    f"bad fault entry {part!r} (want point:rate[:ExcName])")
            point = fields[0].strip().lower()
            try:
                rate = float(fields[1])
            except ValueError:
                raise ValueError(
                    f"bad fault rate {fields[1]!r} in {part!r}") from None
            if not 0.0 < rate <= 1.0:
                raise ValueError(
                    f"fault rate {rate} out of range (0, 1] in {part!r}")
            exc = (_resolve_exc(fields[2].strip())
                   if len(fields) == 3 else InjectedFault)
            points[point] = (rate, exc)
        if not points:
            raise ValueError(f"empty fault spec {spec!r}")
        return cls(points, seed=seed)

    @classmethod
    def from_env(cls) -> "FaultInjector | None":
        """Built from ``GOFR_ML_FAULT`` (and ``GOFR_ML_FAULT_SEED``); None
        when unset or empty."""
        spec = os.environ.get("GOFR_ML_FAULT", "").strip()
        if not spec:
            return None
        seed_raw = os.environ.get("GOFR_ML_FAULT_SEED", "").strip()
        return cls.parse(spec, seed=int(seed_raw) if seed_raw else None)

    @classmethod
    def armed_replica(cls) -> int | None:
        """``GOFR_ML_FAULT_REPLICA`` as an index, or None (all replicas).
        A malformed value fails loudly like a malformed spec."""
        raw = os.environ.get("GOFR_ML_FAULT_REPLICA", "").strip()
        if not raw:
            return None
        try:
            return int(raw)
        except ValueError:
            raise ValueError(
                f"GOFR_ML_FAULT_REPLICA must be a replica index, "
                f"got {raw!r}") from None

    @classmethod
    def from_env_for_replica(cls, idx: int) -> "FaultInjector | None":
        """Per-replica arming for the pool: the env spec applies to
        replica ``idx`` only when ``GOFR_ML_FAULT_REPLICA`` is unset or
        names it; each armed replica gets its own injector (seed + idx)."""
        armed = cls.armed_replica()
        if armed is not None and armed != idx:
            return None
        inj = cls.from_env()
        if inj is None:
            return None
        return inj.for_replica(idx)

    def for_replica(self, idx: int) -> "FaultInjector | None":
        """This injector for replica ``idx``: the same
        ``GOFR_ML_FAULT_REPLICA`` narrowing and per-replica seeding as
        ``from_env_for_replica``, for an injector passed as ``fault=``."""
        armed = self.armed_replica()
        if armed is not None and armed != idx:
            return None
        return type(self)(self.points, seed=self.seed + idx)

    def fire(self, point: str) -> None:
        armed = self.points.get(point)
        if armed is None:
            return
        self.attempts[point] += 1
        rate, exc = armed
        if rate >= 1.0 or self._rng.random() < rate:
            self.injected[point] += 1
            raise exc(f"injected fault at {point!r} "
                      f"(#{self.injected[point]}, GOFR_ML_FAULT)")

    __call__ = fire

    def snapshot(self) -> dict:
        """The chaos config and realized fire counts (``/debug/serving``)."""
        return {
            "spec": {name: {"rate": rate, "raises": exc.__name__}
                     for name, (rate, exc) in self.points.items()},
            "seed": self.seed,
            "attempts": {k: v for k, v in self.attempts.items() if v},
            "injected": {k: v for k, v in self.injected.items() if v},
        }


def fault_snapshot(hook) -> dict | None:
    """An armed fault hook for ``/debug/serving``: an injector's own
    ``snapshot()``, a bare callable's name otherwise."""
    if hook is None:
        return None
    if hasattr(hook, "snapshot"):
        return hook.snapshot()
    return {"hook": getattr(hook, "__qualname__", repr(hook))}
