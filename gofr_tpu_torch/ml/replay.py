"""Deterministic replay of captured serving traffic (the time machine) —
counterpart of ``gofr_tpu/ml/replay.py``.

The consumer half of ``ml/capture.py``: load a bundle, schedule its
requests against a live server at their recorded arrival offsets
(time-warped by ``--speed`` / ``GOFR_ML_REPLAY_SPEED``), and emit a
**verdict**:

- the per-request **output-digest identity rate**, over the records the
  capture delivered whole (a greedy same-config replay must score 1.0);
- **TTFT/TPOT p50/p99 deltas** against the percentiles in the bundle;
- the **goodput-ledger delta** over the replay window (balanced by
  construction; failed replays are classified, never dropped);
- the **fingerprint drift** between the bundle's runtime and the live
  one, warned before any identity claim (a bundle from the JAX package
  always drifts: its fields are JAX's).

CLI::

    python -m gofr_tpu_torch.ml.replay BUNDLE [--speed N] [--json]
    python -m gofr_tpu_torch.ml.replay --selftest [--speed N] [--device cpu]

``BUNDLE`` is a binary ``/debug/capture`` download or a saved JSON crash
bundle (``curl /debug/crash/<id>``). Without ``--selftest`` the CLI
inspects: the summary and the drift (a replay needs a model, which a
bundle does not carry; drive ``ReplayHarness`` against your server).
``--selftest`` builds a tiny in-process model server on ``--device``
(default the first CUDA card), captures a mixed window, replays it on an
identical server and on the fused-window and pipelined paths, and exits
non-zero unless every leg's digest identity rate is 1.0.

Stdlib at module scope; ``torch`` is imported when a selftest runs.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

from .capture import (BUNDLE_FORMAT, DELIVERY_REASONS, decode_bundle,
                      fingerprint_drift, runtime_fingerprint, token_digest)

__all__ = ["ReplayHarness", "load_bundle", "replay_speed_from_env"]


def replay_speed_from_env() -> float:
    """``GOFR_ML_REPLAY_SPEED`` as the time-warp factor (2 = replay the
    window twice as fast; default 1 = real time). Malformed values fail
    loudly — a silent 1.0 would mis-label every latency delta."""
    raw = os.environ.get("GOFR_ML_REPLAY_SPEED", "").strip()
    if not raw:
        return 1.0
    try:
        speed = float(raw)
    except ValueError:
        raise ValueError(
            f"GOFR_ML_REPLAY_SPEED must be a number, got {raw!r}") from None
    if not 0.0 < speed < float("inf"):  # NaN fails the compare too
        raise ValueError(
            f"GOFR_ML_REPLAY_SPEED must be finite and > 0, got {raw!r}")
    return speed


def load_bundle(path: str) -> dict:
    """Load a capture bundle from ``path`` — a binary ``/debug/capture``
    download, a JSON export, or a saved ``/debug/crash/<id>`` body (the
    embedded capture tail is dug out of the crash bundle)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:1] in (b"{", b" ", b"\n", b"\t"):
        obj = json.loads(raw)
        if "data" in obj and isinstance(obj["data"], dict):
            obj = obj["data"]  # a saved HTTP response envelope
        # a crash bundle: the capture tail rides state.capture
        state = obj.get("state")
        if isinstance(state, dict) and isinstance(state.get("capture"),
                                                  dict):
            obj = state["capture"]
        if obj.get("format") != BUNDLE_FORMAT:
            raise ValueError(
                f"{path}: not a capture bundle (format="
                f"{obj.get('format')!r}; want {BUNDLE_FORMAT})")
        return obj
    return decode_bundle(raw)


def _percentile(vals: list[float], q: float) -> float | None:
    if not vals:
        return None
    ordered = sorted(vals)
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


def _pcts_ms(vals: list[float]) -> dict | None:
    if not vals:
        return None
    return {"count": len(vals),
            "p50_ms": round(_percentile(vals, 0.5) * 1e3, 3),
            "p99_ms": round(_percentile(vals, 0.99) * 1e3, 3)}


def _delta_ms(recorded: dict | None, replayed: dict | None,
              key: str) -> float | None:
    if not recorded or not replayed:
        return None
    return round(replayed[key] - recorded[key], 3)


class ReplayHarness:
    """Drive one server (``LLMServer``, or anything with its async
    ``stream_chunks`` surface) through a captured window.

    ``run()`` schedules every replayable request at
    ``recorded offset / speed``, digests what comes back with the same
    hash the capture used, and returns the verdict dict. Records flagged
    ``prefix`` (explicitly-pinned prefix ids — server state a bundle
    cannot carry) are counted as ``skipped``, never silently dropped.
    """

    def __init__(self, server, bundle: dict, *, speed: float | None = None,
                 logger=None) -> None:
        self.server = server
        self.bundle = bundle
        self.speed = replay_speed_from_env() if speed is None else float(speed)
        if not self.speed > 0:
            raise ValueError(f"replay speed must be > 0, got {self.speed}")
        self._logger = logger
        self.drift = fingerprint_drift(bundle.get("runtime") or {},
                                       runtime_fingerprint())
        for line in self.drift:
            self._warn(f"fingerprint drift: {line}")

    def _warn(self, msg: str) -> None:
        """Loud by contract: drift warnings must reach a human even when
        no logger is wired (the CLI's stderr is the fallback)."""
        if self._logger is not None:
            try:
                self._logger.warnf("replay: %s", msg)
                return
            except Exception:
                pass
        print(f"WARNING: replay: {msg}", file=sys.stderr)

    async def run(self) -> dict:
        from .errors import (DeadlineExceeded, GeneratorCrashed, Overloaded,
                             ServerClosed)

        def _reason(exc: Exception) -> str:
            if isinstance(exc, DeadlineExceeded):
                return "deadline"
            if isinstance(exc, Overloaded):
                return "shed"
            if isinstance(exc, (GeneratorCrashed, ServerClosed)):
                return "crashed"
            return "error"

        rows = sorted(self.bundle.get("requests", []),
                      key=lambda r: r.get("t_offset_s", 0.0))
        playable = [r for r in rows if not r.get("prefix")]
        skipped = len(rows) - len(playable)
        if skipped:
            self._warn(f"{skipped} record(s) reference pinned prefixes a "
                       f"bundle cannot carry; skipped")
        ledger = self._ledger_snapshot()
        t0 = time.perf_counter()
        results: list[dict] = []

        async def one(row: dict) -> None:
            due = t0 + row.get("t_offset_s", 0.0) / self.speed
            delay = due - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
            submit = time.perf_counter()
            out: list[int] = []
            first = last = None
            info: dict = {}
            reason = "stop"
            try:
                async for burst in self.server.stream_chunks(
                        row["tokens"], row.get("max_new", 64), info=info,
                        priority=row.get("priority"),
                        deadline_s=row.get("deadline_s", 0.0)):
                    now = time.perf_counter()
                    if first is None:
                        first = now
                    last = now
                    out.extend(burst)
                reason = info.get("finish_reason") or "stop"
            except Exception as exc:  # classified, never crashes the run
                reason = _reason(exc)
            res = {
                "rid": row.get("rid"),
                "reason": reason,
                "n_out": len(out),
                "digest": token_digest(out) if out else None,
                "ttft_s": (first - submit) if first is not None else None,
                "tpot_s": ((last - first) / (len(out) - 1)
                           if first is not None and last is not None
                           and len(out) > 1 else None),
            }
            results.append(res)

        await asyncio.gather(*(one(r) for r in playable))
        wall = time.perf_counter() - t0
        return self._verdict(playable, results, skipped, ledger, wall)

    # -- verdict -------------------------------------------------------------
    def _ledger_snapshot(self) -> dict | None:
        from .goodput import goodput_ledger

        ledger = goodput_ledger()
        if ledger is None:
            return None
        return ledger.snapshot_model(getattr(self.server, "name", "llm"))

    def _verdict(self, rows: list[dict], results: list[dict], skipped: int,
                 ledger_before: dict | None, wall_s: float) -> dict:
        by_rid = {r["rid"]: r for r in results}
        compared = matched = 0
        recorded_failed = 0
        replay_failed = sum(1 for r in results
                            if r["reason"] not in DELIVERY_REASONS)
        for row in rows:
            if row.get("finish_reason") not in DELIVERY_REASONS \
                    or not row.get("digest"):
                recorded_failed += 1
                continue
            res = by_rid.get(row.get("rid"))
            if res is None:
                continue
            compared += 1
            if res["digest"] == row["digest"]:
                matched += 1
        rec_ttft = [r["ttft_s"] for r in rows
                    if r.get("ttft_s") is not None]
        rec_tpot = [r["tpot_s"] for r in rows
                    if r.get("tpot_s") is not None]
        rep_ttft = [r["ttft_s"] for r in results
                    if r["ttft_s"] is not None]
        rep_tpot = [r["tpot_s"] for r in results
                    if r["tpot_s"] is not None]
        ttft = {"recorded": _pcts_ms(rec_ttft), "replayed": _pcts_ms(rep_ttft)}
        tpot = {"recorded": _pcts_ms(rec_tpot), "replayed": _pcts_ms(rep_tpot)}
        for block in (ttft, tpot):
            block["delta_p50_ms"] = _delta_ms(block["recorded"],
                                              block["replayed"], "p50_ms")
            block["delta_p99_ms"] = _delta_ms(block["recorded"],
                                              block["replayed"], "p99_ms")
        # throughput: what the tuner ranks arms by. ``steady_tok_s`` is
        # the decode-regime rate — total post-first tokens over total
        # decode time (Σ tpot·(n−1) per request), immune to the replay's
        # arrival-schedule idle gaps that make raw tok/s lie about a
        # config's speed. ``tok_s`` keeps the wall-clock rate for
        # whole-window comparisons at equal speed factors.
        out_tokens = sum(r["n_out"] for r in results)
        decode_toks = sum(r["n_out"] - 1 for r in results
                          if r["tpot_s"] is not None and r["n_out"] > 1)
        decode_s = sum(r["tpot_s"] * (r["n_out"] - 1) for r in results
                       if r["tpot_s"] is not None and r["n_out"] > 1)
        throughput = {
            "out_tokens": out_tokens,
            "tok_s": round(out_tokens / wall_s, 3) if wall_s > 0 else None,
            "steady_tok_s": (round(decode_toks / decode_s, 3)
                             if decode_s > 0 else None),
        }
        verdict: dict = {
            "requests": len(rows) + skipped,
            "replayed": len(results),
            "skipped": skipped,
            "speed": self.speed,
            "wall_s": round(wall_s, 3),
            "identity": {
                "compared": compared,
                "matched": matched,
                "rate": round(matched / compared, 4) if compared else None,
            },
            "throughput": throughput,
            "recorded_failed": recorded_failed,
            "replay_failed": replay_failed,
            "ttft": ttft,
            "tpot": tpot,
            "fingerprint_drift": self.drift,
        }
        ledger_after = self._ledger_snapshot()
        if ledger_before is not None and ledger_after is not None:
            wasted = {
                r: ledger_after.get("wasted", {}).get(r, 0)
                - ledger_before.get("wasted", {}).get(r, 0)
                for r in (set(ledger_after.get("wasted", {}))
                          | set(ledger_before.get("wasted", {})))
            }
            wasted = {r: n for r, n in wasted.items() if n}
            delivered = (ledger_after.get("delivered", 0)
                         - ledger_before.get("delivered", 0))
            total = (ledger_after.get("device_tokens", 0)
                     - ledger_before.get("device_tokens", 0))
            verdict["goodput"] = {
                "device_tokens": total,
                "delivered": delivered,
                "wasted": wasted,
                "goodput": round(delivered / total, 4) if total else None,
                "balanced": delivered + sum(wasted.values()) == total,
            }
        return verdict


# -- CLI ----------------------------------------------------------------------

def _summarize(bundle: dict) -> dict:
    rows = bundle.get("requests", [])
    reasons: dict[str, int] = {}
    for r in rows:
        reasons[str(r.get("finish_reason"))] = \
            reasons.get(str(r.get("finish_reason")), 0) + 1
    return {
        "format": bundle.get("format"),
        "captured_at": bundle.get("captured_at"),
        "fleet": bundle.get("fleet"),
        "requests": len(rows),
        "models": sorted({r.get("model") for r in rows}),
        "finish_reasons": reasons,
        "window_s": round(max((r.get("t_offset_s", 0.0) for r in rows),
                              default=0.0), 3),
        "runtime": bundle.get("runtime"),
    }


async def _selftest_leg(speed: float, build_capture, build_replica) -> dict:
    """One capture→replay leg: serve a fixed mixed window on a fresh
    capture server, then replay the bundle on the replica the caller
    builds (identical by default; the window leg arms the fused path)."""
    from .capture import traffic_capture

    cap = traffic_capture()
    assert cap is not None, "selftest requires GOFR_ML_CAPTURE armed"
    cap.clear()
    server = build_capture()
    try:
        prompts = [[3, 1, 4, 1], [2, 7, 1], [5, 9, 2, 6, 5], [3, 5, 8]]
        await asyncio.gather(*(
            server.generate(p, 6, priority=prio, deadline_s=30.0)
            for p, prio in zip(prompts, ("high", "normal", "low", "normal"),
                               strict=True)))
    finally:
        server.close()
    bundle = cap.export()
    replica = build_replica()
    try:
        return await ReplayHarness(replica, bundle, speed=speed).run()
    finally:
        replica.close()


async def _selftest(speed: float, device=None) -> dict:
    """Capture a mixed window against a tiny in-process model, then replay
    it: greedy identity must be 1.0. Three legs, as in JAX: an identical
    server; a paged single-step capture replayed with fused windows
    (K = 4); and the same capture replayed with windows and the
    pipeline. The paged legs run in float32, where the claim crosses
    program shapes and bf16 rounding can flip a near-tie argmax. The
    verdict is the least identity of the legs."""
    os.environ.setdefault("GOFR_ML_CAPTURE", "256")
    import torch

    from .. import resolve_device
    from ..models import llama
    from .generate import Generator
    from .llm import LLMServer

    device = resolve_device(device)
    cfg = llama.tiny_llama()
    params = llama.params_from_config(cfg, device=device)

    def build() -> LLMServer:
        return LLMServer(
            Generator(params, cfg, batch_slots=2, max_seq=64,
                      prefill_buckets=(8, 16), device=device),
            name="replay-selftest")

    plain = await _selftest_leg(speed, build, build)

    cfg_w = llama.tiny_llama(dtype=torch.float32)
    params_w = llama.params_from_config(cfg_w, device=device)

    def build_paged(window: int, pipeline: int = 0) -> LLMServer:
        return LLMServer(
            Generator(params_w, cfg_w, batch_slots=2, max_seq=64,
                      prefill_buckets=(8, 16), page_size=8,
                      decode_window=window, pipeline=pipeline,
                      device=device),
            name="replay-selftest")

    window = await _selftest_leg(
        speed, lambda: build_paged(0), lambda: build_paged(4))
    pipelined = await _selftest_leg(
        speed, lambda: build_paged(0), lambda: build_paged(4, pipeline=1))
    rates = (plain["identity"]["rate"], window["identity"]["rate"],
             pipelined["identity"]["rate"])
    return {
        "identity": {"rate": min(rates)},
        "plain": plain,
        "window": window,
        "pipelined": pipelined,
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m gofr_tpu_torch.ml.replay",
        description="Inspect / replay a serving traffic-capture bundle.")
    parser.add_argument("bundle", nargs="?",
                        help="a /debug/capture download or a saved "
                             "/debug/crash/<id> JSON body")
    parser.add_argument("--speed", type=float, default=None,
                        help="time-warp factor (default "
                             "GOFR_ML_REPLAY_SPEED or 1)")
    parser.add_argument("--selftest", action="store_true",
                        help="capture+replay a tiny in-process model and "
                             "require 1.0 digest identity")
    parser.add_argument("--json", action="store_true",
                        help="print machine-readable JSON only")
    parser.add_argument("--device", default=None,
                        help="the selftest's device (default the first "
                             "CUDA card; cpu for the plain path)")
    args = parser.parse_args(argv)
    speed = (replay_speed_from_env() if args.speed is None
             else float(args.speed))
    if args.selftest:
        verdict = asyncio.run(_selftest(speed, args.device))
        print(json.dumps(verdict if args.json
                         else {"selftest": verdict}, indent=None
                         if args.json else 2))
        ok = verdict["identity"]["rate"] == 1.0
        if not ok:
            print("SELFTEST FAILED: digest identity rate "
                  f"{verdict['identity']['rate']!r} != 1.0", file=sys.stderr)
        return 0 if ok else 1
    if not args.bundle:
        parser.error("a bundle path is required (or --selftest)")
    bundle = load_bundle(args.bundle)
    drift = fingerprint_drift(bundle.get("runtime") or {},
                              runtime_fingerprint())
    for line in drift:
        print(f"WARNING: fingerprint drift: {line}", file=sys.stderr)
    summary = _summarize(bundle)
    summary["fingerprint_drift"] = drift
    if args.json:
        print(json.dumps(summary))
    else:
        print(json.dumps(summary, indent=2))
        print("\n(replay needs a model: drive ReplayHarness against your "
              "server, or run --selftest for the in-process proof)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
