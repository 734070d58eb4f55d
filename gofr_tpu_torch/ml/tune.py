"""Replay-driven config search, the self-tuning loop's offline half —
counterpart of ``gofr_tpu/ml/tune.py``.

Replay a captured traffic bundle (``ml/capture.py``, ``ml/replay.py``)
across a **config grid**, prune every arm whose greedy digest identity is
not exactly 1.0 (a fast wrong answer is not a candidate), rank the
survivors by goodput-weighted steady decode tok/s with a TTFT/TPOT SLO
penalty, and emit a **tuned profile**: a fingerprint-stamped JSON knob
map and the per-arm scoreboard that justifies it.

``GOFR_ML_PROFILE=<path>`` / ``register_llm(profile=)`` applies a profile
at boot (loud validation, drift warnings; unset constructs nothing).
``GOFR_ML_CANARY=<path>`` / ``register_llm(canary=)`` boots a profile as
a replica pool's shadow canary (``ml/replica.py``): every Nth request is
mirrored to a core built under the candidate's knobs, and the core is
promoted into the fleet or rolled back on digest identity and latency.

CLI::

    python -m gofr_tpu_torch.ml.tune BUNDLE [--json]
    python -m gofr_tpu_torch.ml.tune --selftest [--json] [--device cpu]

``BUNDLE`` is a ``/debug/capture`` download (binary or JSON) or a saved
crash bundle; the CLI prints its summary and the grid a search would run
(a bundle carries traffic, not a model: drive ``Tuner`` against your own
builder). JAX's ``--tiny`` rebuilds the reference model of the committed
``bench/`` bundle from JAX-PRNG weights, which the port cannot draw
without jax: here it raises, and a test replays that bundle on weights
bridged from JAX (``llama.params_from_jax``). ``--selftest`` captures a
window in-process on ``--device`` (default the first CUDA card), searches
a 7-arm grid with a **poisoned arm** (same config, other weights), and
exits non-zero unless the poisoned arm was pruned, the winner has
identity 1.0 and its steady tok/s is at least the default arm's.

Stdlib at module scope; ``torch`` is imported when a search runs.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import sys
import time

from .capture import fingerprint_drift, runtime_fingerprint
from .replay import ReplayHarness, load_bundle

__all__ = ["PROFILE_FORMAT", "TUNABLE_KNOBS", "Tuner", "default_grid",
           "load_profile", "profile_from_env", "profile_overlay",
           "profile_boot_warnings"]

PROFILE_FORMAT = "gofr-tuned-profile/1"

# the knobs a profile may set — exactly the serving-config surface the
# grid searches. Anything else in a profile's knob map is a loud load
# error: a tuned profile must never become a backdoor for arbitrary env
TUNABLE_KNOBS = frozenset({
    "GOFR_ML_DECODE_WINDOW",   # fused decode window K
    "GOFR_ML_PIPELINE",        # double-buffered dispatch
    "GOFR_ML_SPEC_K",          # speculative draft length
    "GOFR_ML_KV_BITS",         # KV-cache precision (cfg-build time!)
    "GOFR_ML_TOKEN_BUDGET",    # token-budget scheduler cap
    "GOFR_ML_TTFT_TARGET_MS",  # SLO steering: prefill-share target
    "GOFR_ML_TPOT_TARGET_MS",  # SLO steering: decode-share target
    "GOFR_ML_REPLICAS",        # data-parallel replica count
    "GOFR_ML_DISAGG",          # disaggregated prefill/decode roles
    "GOFR_ML_DISAGG_PREFILL",  # ...and the prefill-role share
    "GOFR_ML_SP",              # sequence-parallel prefill
    "GOFR_ML_SP_SHARDS",       # ...and its shard count
})


def load_profile(path: str) -> dict:
    """Load + validate a tuned profile. Every failure is a loud typed
    error naming the path — a half-applied knob map silently steering
    production is the one outcome this function exists to prevent."""
    try:
        with open(path, "rb") as f:
            obj = json.load(f)
    except OSError as exc:
        raise ValueError(f"tuned profile {path}: cannot read: {exc}") \
            from None
    except json.JSONDecodeError as exc:
        raise ValueError(f"tuned profile {path}: not JSON: {exc}") from None
    if not isinstance(obj, dict) or obj.get("format") != PROFILE_FORMAT:
        raise ValueError(
            f"tuned profile {path}: format="
            f"{obj.get('format') if isinstance(obj, dict) else type(obj)!r}"
            f" (want {PROFILE_FORMAT})")
    knobs = obj.get("knobs")
    if not isinstance(knobs, dict):
        # empty is legal — "the stock config won" is a valid tuning
        # outcome and applies as a no-op overlay
        raise ValueError(
            f"tuned profile {path}: missing 'knobs' map")
    clean: dict[str, str] = {}
    for name, value in sorted(knobs.items()):
        if name not in TUNABLE_KNOBS:
            raise ValueError(
                f"tuned profile {path}: unknown knob {name!r} (tunable: "
                f"{', '.join(sorted(TUNABLE_KNOBS))})")
        if isinstance(value, bool) or not isinstance(value,
                                                     (str, int, float)):
            raise ValueError(
                f"tuned profile {path}: knob {name} has non-scalar value "
                f"{value!r}")
        clean[name] = str(value)
    obj["knobs"] = clean
    obj["path"] = path
    return obj


def profile_from_env() -> dict | None:
    """``GOFR_ML_PROFILE=<path>`` resolved under the is-not-None
    contract: unset/empty loads nothing, set loads loudly."""
    path = os.environ.get("GOFR_ML_PROFILE", "").strip()
    return load_profile(path) if path else None


@contextlib.contextmanager
def profile_overlay(knobs: dict):
    """Apply a knob map to the environment for the duration of server
    *construction* only — Generator/LLMServer read their env defaults at
    init, so the overlay never has to stay armed while serving runs (and
    a tuner evaluating arm B can't inherit arm A's env)."""
    saved = {name: os.environ.get(name) for name in knobs}
    try:
        for name, value in knobs.items():
            os.environ[name] = str(value)
        yield
    finally:
        for name, prev in saved.items():
            if prev is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = prev


def profile_boot_warnings(profile: dict) -> list[str]:
    """The warn-lines a boot applying ``profile`` must surface: runtime
    fingerprint drift vs the tuning run (ignoring the profile's own
    knobs plus the flywheel's, which differ by design), and the
    cfg-build-time caveat for ``GOFR_ML_KV_BITS``."""
    ignore = set(profile.get("knobs") or ()) | {
        "GOFR_ML_PROFILE", "GOFR_ML_CANARY", "GOFR_ML_CANARY_SAMPLE",
        "GOFR_ML_CANARY_WINDOW"}
    lines = [f"tuned profile fingerprint drift: {line}"
             for line in fingerprint_drift(profile.get("runtime") or {},
                                           runtime_fingerprint(),
                                           ignore=ignore)]
    if "GOFR_ML_KV_BITS" in (profile.get("knobs") or {}):
        lines.append(
            "tuned profile sets GOFR_ML_KV_BITS, which is read at model-"
            "config build time — it applies only when the config is built "
            "under the profile (a prebuilt cfg= keeps its kv_bits)")
    return lines


def default_grid(bundle: dict | None = None) -> list[dict]:
    """The stock search space: the default boot plus the opt-in fast
    paths (fused windows, the pipeline), alone and composed, plus the
    token-budget scheduler. Arms that a given server shape cannot construct (e.g. a
    decode window on an unpaged generator) prune themselves with a
    recorded error — the grid does not pre-filter, the evaluation does.
    """
    return [
        {"name": "default", "knobs": {}},
        {"name": "window4", "knobs": {"GOFR_ML_DECODE_WINDOW": "4"}},
        {"name": "window8", "knobs": {"GOFR_ML_DECODE_WINDOW": "8"}},
        {"name": "window4+pipeline",
         "knobs": {"GOFR_ML_DECODE_WINDOW": "4", "GOFR_ML_PIPELINE": "1"}},
        {"name": "window8+pipeline",
         "knobs": {"GOFR_ML_DECODE_WINDOW": "8", "GOFR_ML_PIPELINE": "1"}},
        {"name": "budget-auto",
         "knobs": {"GOFR_ML_TOKEN_BUDGET": "auto"}},
        {"name": "window4+budget",
         "knobs": {"GOFR_ML_DECODE_WINDOW": "4",
                   "GOFR_ML_TOKEN_BUDGET": "auto"}},
    ]


class Tuner:
    """Search a config grid over one captured bundle.

    ``build(arm)`` constructs a fresh server for one arm — it is called
    *inside* that arm's ``profile_overlay``, so builders that read env
    defaults (the normal Generator path) pick the knobs up for free.
    ``run()`` replays the bundle on every arm, prunes identity
    violations and construction failures, ranks survivors by
    ``steady_tok_s × goodput × slo_factor`` (deterministic tie-break on
    arm name), and never recommends an arm slower than the default: if
    the default arm survived and the best survivor does not beat its
    steady tok/s, the default IS the winner — a tuned profile that
    regresses the boot it replaces is worse than no profile.

    By default each arm replays the bundle twice and only the second
    pass is scored: the warm-up pass absorbs jit compiles so arms are
    compared warm-vs-warm (``warmup=False`` restores single-pass).
    """

    def __init__(self, bundle: dict, build, grid: list[dict] | None = None,
                 *, speed: float | None = None, logger=None,
                 warmup: bool = True,
                 ttft_slo_ms: float | None = None,
                 tpot_slo_ms: float | None = None) -> None:
        self.bundle = bundle
        self.build = build
        self.grid = default_grid(bundle) if grid is None else list(grid)
        if not self.grid:
            raise ValueError("tuner needs a non-empty grid")
        names = [a.get("name") for a in self.grid]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate arm names in grid: {names}")
        self.speed = speed
        self.warmup = bool(warmup)
        self._logger = logger
        # SLO targets share the SLOController defaults so the tuner
        # penalizes exactly what the online steering would fight
        self._ttft_ms = (float(os.environ.get("GOFR_ML_TTFT_TARGET_MS",
                                              "200"))
                         if ttft_slo_ms is None else float(ttft_slo_ms))
        self._tpot_ms = (float(os.environ.get("GOFR_ML_TPOT_TARGET_MS",
                                              "50"))
                         if tpot_slo_ms is None else float(tpot_slo_ms))

    def _warn(self, msg: str) -> None:
        if self._logger is not None:
            try:
                self._logger.warnf("tune: %s", msg)
                return
            except Exception:
                pass
        print(f"WARNING: tune: {msg}", file=sys.stderr)

    async def _eval(self, arm: dict) -> dict:
        """One arm: build under the overlay, replay, score. Every
        failure mode lands in the row (pruned + error), never out of the
        grid loop — a broken arm must not cost the search."""
        row: dict = {"arm": arm["name"],
                     "knobs": {k: str(v) for k, v in arm["knobs"].items()},
                     "error": None, "pruned": False, "pruned_reason": None}
        server = None
        try:
            with profile_overlay(arm["knobs"]):
                server = self.build(arm)
            if self.warmup:
                # discarded warm-up pass: every arm pays its jit
                # compiles here, so the scored pass compares warm
                # steady-state against warm steady-state. Without it
                # the arm that happens to share program shapes with an
                # earlier arm (or the ambient process) wins on cache
                # luck, not on merit.
                await ReplayHarness(
                    server, self.bundle, speed=self.speed,
                    logger=self._logger).run()
            verdict = await ReplayHarness(
                server, self.bundle, speed=self.speed,
                logger=self._logger).run()
        except Exception as exc:
            row.update(error=f"{type(exc).__name__}: {exc}", pruned=True,
                       pruned_reason="error", score=0.0)
            self._warn(f"arm {arm['name']}: {row['error']}")
            return row
        finally:
            if server is not None:
                try:
                    server.close()
                except Exception:
                    pass
        thr = verdict.get("throughput") or {}
        ttft = (verdict.get("ttft") or {}).get("replayed") or {}
        tpot = (verdict.get("tpot") or {}).get("replayed") or {}
        good = (verdict.get("goodput") or {}).get("goodput")
        row.update({
            "identity": verdict["identity"]["rate"],
            "compared": verdict["identity"]["compared"],
            "replay_failed": verdict.get("replay_failed", 0),
            "steady_tok_s": thr.get("steady_tok_s"),
            "tok_s": thr.get("tok_s"),
            "goodput": good,
            "ttft_p99_ms": ttft.get("p99_ms"),
            "tpot_p99_ms": tpot.get("p99_ms"),
        })
        # the hard correctness gate: anything but a perfect greedy
        # identity rate on the compared set disqualifies the arm. No
        # comparisons at all (nothing delivered) is equally damning.
        if row["identity"] != 1.0:
            row.update(pruned=True, pruned_reason="identity", score=0.0)
            return row
        if row["replay_failed"]:
            row.update(pruned=True, pruned_reason="replay_failed",
                       score=0.0)
            return row
        row["slo_factor"] = round(self._slo_factor(ttft, tpot), 4)
        steady = row["steady_tok_s"] or 0.0
        weight = good if good is not None else 1.0
        row["score"] = round(steady * weight * row["slo_factor"], 4)
        return row

    def _slo_factor(self, ttft: dict, tpot: dict) -> float:
        """Multiplicative tail-latency penalty: an arm whose p99 blows
        past a target is discounted by target/observed — raw tok/s
        cannot buy back a broken SLO one-for-one."""
        factor = 1.0
        for block, target in ((ttft, self._ttft_ms), (tpot, self._tpot_ms)):
            p99 = block.get("p99_ms")
            if p99 is not None and target > 0 and p99 > target:
                factor *= target / p99
        return factor

    async def run(self) -> dict:
        rows = []
        for arm in self.grid:
            rows.append(await self._eval(arm))
        survivors = [r for r in rows if not r["pruned"]]
        # deterministic rank: score desc, then arm name — two equal arms
        # must produce the same scoreboard on every run
        survivors.sort(key=lambda r: (-r["score"], r["arm"]))
        pruned = [r for r in rows if r["pruned"]]
        pruned.sort(key=lambda r: r["arm"])
        default_row = next((r for r in rows if not r["knobs"]), None)
        winner = survivors[0] if survivors else None
        if (winner is not None and default_row is not None
                and not default_row["pruned"]
                and (winner["steady_tok_s"] or 0.0)
                < (default_row["steady_tok_s"] or 0.0)):
            self._warn(f"best survivor {winner['arm']} is slower than the "
                       f"default arm; recommending default")
            winner = default_row
        result: dict = {
            "arms": len(rows),
            "survivors": len(survivors),
            "pruned": len(pruned),
            "scoreboard": survivors + pruned,
            "winner": winner,
            "default": default_row,
        }
        if (winner is not None and default_row is not None
                and default_row.get("steady_tok_s")):
            result["speedup_vs_default"] = round(
                (winner["steady_tok_s"] or 0.0)
                / default_row["steady_tok_s"], 4)
        return result

    def profile(self, result: dict) -> dict:
        """The emitted artifact: winner knobs + the scoreboard that
        justifies them, stamped with the tuning runtime's fingerprint so
        a later boot can warn when the world has moved."""
        winner = result.get("winner")
        if winner is None:
            raise ValueError(
                "no arm survived the identity gate; nothing to emit")
        rows = self.bundle.get("requests", [])
        return {
            "format": PROFILE_FORMAT,
            "created_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "runtime": runtime_fingerprint(),
            "bundle": {
                "captured_at": self.bundle.get("captured_at"),
                "requests": len(rows),
                "models": sorted({r.get("model") for r in rows}),
            },
            "knobs": dict(winner["knobs"]),
            "winner": winner,
            "scoreboard": result["scoreboard"],
        }


# -- selftest -----------------------------------------------------------------

def _tiny_builder(poison: bool = False, device=None):
    """A tiny paged float32 server on ``device`` with weights from seed 0
    (``poison=True``: seed 1, the same config with another model, the
    identity violation the selftest must prune). float32 because the
    claim crosses program shapes, where bf16 rounding can flip a near-tie
    argmax."""
    import torch

    from .. import resolve_device
    from ..models import llama
    from .generate import Generator
    from .llm import LLMServer

    device = resolve_device(device)
    cfg = llama.tiny_llama(dtype=torch.float32)
    params = llama.params_from_config(cfg, seed=1 if poison else 0,
                                      device=device)

    def build(arm: dict):
        return LLMServer(
            Generator(params, cfg, batch_slots=2, max_seq=64,
                      prefill_buckets=(8, 16), page_size=8, device=device),
            name="tune-arm")

    return build


async def _selftest(device=None) -> dict:
    """Capture a fresh window in-process, search a 7-arm grid with one
    poisoned arm, and report what the gate must check: poisoned pruned,
    winner identity 1.0, winner steady ≥ default steady."""
    os.environ.setdefault("GOFR_ML_CAPTURE", "256")
    from .capture import traffic_capture

    cap = traffic_capture()
    assert cap is not None, "selftest requires GOFR_ML_CAPTURE armed"
    cap.clear()
    build = _tiny_builder(device=device)
    server = build({"name": "capture", "knobs": {}})
    try:
        prompts = [[3, 1, 4, 1], [2, 7, 1], [5, 9, 2, 6, 5], [3, 5, 8],
                   [1, 2, 3, 4, 5, 6], [9, 8, 7]]
        await asyncio.gather(*(
            server.generate(p, 8, priority=prio, deadline_s=30.0)
            for p, prio in zip(
                prompts, ("high", "normal", "low", "normal", "normal",
                          "high"), strict=True)))
    finally:
        server.close()
    bundle = cap.export()

    poisoned_build = _tiny_builder(poison=True, device=device)

    def build_arm(arm: dict):
        return (poisoned_build if arm["name"] == "poisoned" else build)(arm)

    grid = default_grid(bundle)[:6] + [
        # same knobs as a surviving arm, different weights: the identity
        # gate (not the error path) must kill it
        {"name": "poisoned", "knobs": {}},
    ]
    tuner = Tuner(bundle, build_arm, grid, speed=1000.0)
    result = await tuner.run()
    result["profile"] = tuner.profile(result)
    return result


def _selftest_ok(result: dict) -> list[str]:
    """The acceptance gate, as a list of violations (empty = pass)."""
    bad: list[str] = []
    if result["arms"] < 6:
        bad.append(f"only {result['arms']} arms evaluated (< 6)")
    poisoned = next((r for r in result["scoreboard"]
                     if r["arm"] == "poisoned"), None)
    if poisoned is None:
        bad.append("poisoned arm missing from scoreboard")
    elif not poisoned["pruned"] or poisoned["pruned_reason"] != "identity":
        bad.append(f"poisoned arm not identity-pruned: {poisoned}")
    winner, default = result.get("winner"), result.get("default")
    if winner is None:
        bad.append("no winner")
    else:
        if winner.get("identity") != 1.0:
            bad.append(f"winner identity {winner.get('identity')!r} != 1.0")
        if default is not None and (winner.get("steady_tok_s") or 0.0) < \
                (default.get("steady_tok_s") or 0.0):
            bad.append("winner slower than default arm")
    return bad


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m gofr_tpu_torch.ml.tune",
        description="Search a serving config grid over a captured "
                    "traffic bundle; emit a tuned profile.")
    parser.add_argument("bundle", nargs="?",
                        help="a /debug/capture download or saved crash "
                             "bundle")
    parser.add_argument("--tiny", action="store_true",
                        help="JAX's reference-model search; raises here "
                             "(its weights are JAX-PRNG draws)")
    parser.add_argument("--selftest", action="store_true",
                        help="capture+search in-process; exit non-zero "
                             "unless the poisoned arm is pruned and the "
                             "winner is identity-1.0 and not slower than "
                             "default")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable JSON only")
    parser.add_argument("--device", default=None,
                        help="the selftest's device (default the first "
                             "CUDA card; cpu for the plain path)")
    args = parser.parse_args(argv)
    if args.tiny:
        raise NotImplementedError(
            "--tiny rebuilds the committed bundle's reference model from "
            "JAX-PRNG weights, which the port cannot draw without jax; "
            "replay the bundle on weights bridged with "
            "llama.params_from_jax, or run --selftest")

    if args.selftest:
        result = asyncio.run(_selftest(args.device))
        bad = _selftest_ok(result)
        print(json.dumps(result if args.json else {"selftest": result},
                         indent=None if args.json else 2))
        for line in bad:
            print(f"SELFTEST FAILED: {line}", file=sys.stderr)
        return 1 if bad else 0

    if not args.bundle:
        parser.error("a bundle path is required (or --selftest)")
    bundle = load_bundle(args.bundle)
    # inspect: a bundle carries traffic, not a model — the summary and the
    # grid a programmatic search would run
    from .replay import _summarize
    out = {"bundle": _summarize(bundle), "grid": default_grid(bundle)}
    print(json.dumps(out, indent=None if args.json else 2))
    if not args.json:
        print("\n(a search needs a model: drive Tuner programmatically "
              "against your builder, or run --selftest)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
