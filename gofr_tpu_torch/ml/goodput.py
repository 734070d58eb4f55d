"""Goodput ledger — counterpart of ``gofr_tpu/ml/goodput.py``: what did
the card's tokens buy?

Every token the card computes is classified where its fate is decided:
``delivered`` (it reached a consumer in a completed answer) or one of the
wasted reasons of ``WASTE_REASONS`` (the JAX package's taxonomy). The
single server of the port charges:

- ``deadline_cancelled`` — tokens of a slot its deadline reaped mid-decode;
- ``crashed`` — tokens of the slots a generator crash failed;
- ``disconnected`` — tokens of a consumer that went away, or of in-flight
  slots a force-close dropped;
- ``restore_fallback`` — prefix tokens prefilled again because a host-tier
  restore fell through (pool pressure, a dropped entry, an injected
  ``restore`` fault, or the registration evicted in the admission race);
- ``window_overshoot`` — tokens a fused decode window computed past a
  row's EOS or budget before the row froze on the card;
- ``pipeline_overshoot`` — tokens a double-buffered dispatch computed for
  a slot that had already finished when its block settled;
- ``spec_rejected`` — verify-window positions whose drafts the verifier
  rejected (K+1 computed a window, the emitted ones delivered).

A replica pool (``ml/replica.py``) charges the fleet's reasons under its
own name: ``failover_recompute`` (a rerouted request's re-prefill on a
survivor), ``migration_cold`` (a scale-down's migrated prefix lost on the
way), and its shadow canary core bills every token it delivers as
``canary`` (the output is judged, never delivered). A federated front
(``ml/federation.py``) charges ``federation_recompute``: a request
routed to a peer that died before its first token, prefilled again on
the local host.

The ledger balances by construction: each classification point adds to
exactly one reason, so ``delivered + wasted == computed``. Per model and
process-wide; served at ``GET /debug/goodput``, as the ``goodput`` block of
``/debug/serving``, and as ``app_llm_tokens_wasted_total{model,reason}``
and ``app_llm_goodput_fraction``. ``GOFR_ML_GOODPUT=0`` turns it off (the
call sites guard on ``is not None``). Stdlib only.
"""

from __future__ import annotations

import os
import threading
import time

__all__ = ["WASTE_REASONS", "GoodputLedger", "ModelGoodput",
           "goodput_ledger", "goodput_enabled"]

# the wasted-token taxonomy (the ``reason`` label values of
# app_llm_tokens_wasted_total); ``delivered`` is the ledger's other side
WASTE_REASONS = ("spec_rejected", "deadline_cancelled", "crashed",
                 "disconnected", "failover_recompute", "restore_fallback",
                 "migration_cold", "window_overshoot", "pipeline_overshoot",
                 "canary", "federation_recompute")


def goodput_enabled() -> bool:
    """``GOFR_ML_GOODPUT`` (default on): 0 disables the ledger — the
    instrumented sites see ``None`` and do zero extra work."""
    return os.environ.get("GOFR_ML_GOODPUT", "").strip() != "0"


class ModelGoodput:
    """A ledger handle bound to one model name — what the serving layer
    installs on a Generator / prefix cache / host-KV store (which don't
    know their model) so their classification points stay one-liners."""

    __slots__ = ("ledger", "model")

    def __init__(self, ledger: "GoodputLedger", model: str) -> None:
        self.ledger = ledger
        self.model = model

    def note(self, reason: str, tokens: int) -> None:
        self.ledger.note(self.model, reason, tokens)


class GoodputLedger:
    """Per-model token-fate counters with a process lifetime clock.

    ``note()`` is the one write API: one lock, two dict increments,
    called per slot finish, window or fallback, never per token.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # model -> {"delivered": int, "wasted": {reason: int}}
        self._models: dict[str, dict] = {}
        self.t0 = time.monotonic()

    def handle(self, model: str) -> ModelGoodput:
        return ModelGoodput(self, model)

    def note(self, model: str, reason: str, tokens: int) -> None:
        """Classify ``tokens`` device-computed tokens for ``model`` as
        ``reason`` (``"delivered"`` or one of ``WASTE_REASONS``)."""
        if tokens <= 0:
            return
        if reason != "delivered" and reason not in WASTE_REASONS:
            raise ValueError(
                f"unknown goodput reason {reason!r} "
                f"(one of delivered|{'|'.join(WASTE_REASONS)})")
        with self._lock:
            row = self._models.get(model)
            if row is None:
                row = self._models[model] = {"delivered": 0, "wasted": {}}
            if reason == "delivered":
                row["delivered"] += int(tokens)
            else:
                row["wasted"][reason] = (row["wasted"].get(reason, 0)
                                         + int(tokens))

    # -- read side -----------------------------------------------------------
    def wasted_totals(self) -> dict[tuple[str, str], int]:
        """Lifetime ``(model, reason) -> tokens`` for the metric pass
        (the sampler publishes deltas as Prometheus counters)."""
        with self._lock:
            return {(model, reason): n
                    for model, row in self._models.items()
                    for reason, n in row["wasted"].items()}

    def models(self) -> list[str]:
        with self._lock:
            return sorted(self._models)

    @staticmethod
    def _summarize(delivered: int, wasted: dict, elapsed: float) -> dict:
        wasted_total = sum(wasted.values())
        total = delivered + wasted_total
        return {
            "device_tokens": total,
            "delivered": delivered,
            "wasted": dict(sorted(wasted.items(), key=lambda kv: -kv[1])),
            "wasted_total": wasted_total,
            "goodput": round(delivered / total, 4) if total else None,
            "delivered_per_s": (round(delivered / elapsed, 2)
                                if elapsed > 0 else None),
        }

    def snapshot_model(self, model: str) -> dict:
        """One model's ledger — a pool name aggregates its replica cores
        (``chat`` rolls up ``chat/0``, ``chat/1``, … like the event
        log's model filter)."""
        elapsed = time.monotonic() - self.t0
        delivered = 0
        wasted: dict[str, int] = {}
        with self._lock:
            for name, row in self._models.items():
                if name == model or name.startswith(model + "/"):
                    delivered += row["delivered"]
                    for reason, n in row["wasted"].items():
                        wasted[reason] = wasted.get(reason, 0) + n
        return self._summarize(delivered, wasted, elapsed)

    def snapshot(self) -> dict:
        """The ``/debug/goodput`` body: the fleet-wide ledger plus one
        row per model (replica cores appear under their own names; the
        pool-level row is the per-LLM block's aggregation)."""
        elapsed = time.monotonic() - self.t0
        with self._lock:
            models = {name: (row["delivered"], dict(row["wasted"]))
                      for name, row in self._models.items()}
        fleet_delivered = sum(d for d, _ in models.values())
        fleet_wasted: dict[str, int] = {}
        for _, w in models.values():
            for reason, n in w.items():
                fleet_wasted[reason] = fleet_wasted.get(reason, 0) + n
        return {
            "since_s": round(elapsed, 3),
            "fleet": self._summarize(fleet_delivered, fleet_wasted, elapsed),
            "models": {name: self._summarize(d, w, elapsed)
                       for name, (d, w) in sorted(models.items())},
        }


# the process-global instance every serving component shares — ONE
# ledger per process, like the fleet event log. ``goodput_ledger()``
# answers None when GOFR_ML_GOODPUT=0, so call sites get the
# is-not-None guard free.
_LEDGER = GoodputLedger()


def goodput_ledger() -> GoodputLedger | None:
    return _LEDGER if goodput_enabled() else None
