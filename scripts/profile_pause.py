"""How long a ``GET /debug/profile`` holds serving back, on one NVIDIA GPU.

    python3 scripts/profile_pause.py [--order CACACC] [--json OUT]

Boots ``chip_smoke.oai_app`` (the port's OpenAI front over Llama-3-8B at
full width, bf16, weights drawn from seed 0, 8 slots, chunk 4) and runs
``chip_smoke.oai_profile_pause`` once for each letter of ``--order``: 8
SSE streams kept busy out of phase and a 2 s capture, read as the route's
answer time and the longest gap between two text frames of a stream
across the capture. The letters pick the capture:

- ``C``: the port's capture as it stands (slices started at admissions,
  the card's activity only);
- ``A``: the same with the host's operators recorded too (``use_cpu``),
  as the capture was before it kept the card's activity only;
- ``T``: the auto-profiler's capture (slices on the timer).

Every stop (``_disable_profiler``) is timed on the host. A reading over
the phase's limit is printed and kept, not fatal. Prints the card's name
and power limit first; one ``pause:`` line a reading; with ``--json`` the
readings also go to a file.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from gofr_tpu_torch import flight_recorder  # noqa: E402
from gofr_tpu_torch.models import llama  # noqa: E402
from gofr_tpu_torch.ops import _build  # noqa: E402


class _WithHostOps(torch.autograd.profiler.profile):
    """The profiler as the capture called it before: host operators too."""

    def __init__(self, *args, **kwargs):
        kwargs["use_cpu"] = True
        super().__init__(*args, **kwargs)


def _auto_capture(real):
    def capture(trace_dir, seconds):
        real(trace_dir, seconds, at_admissions=False)
    return capture


async def readings(app, order: str) -> list[dict]:
    from torch.autograd import profiler as autograd_profiler

    real_capture = flight_recorder._capture_profile_trace
    real_profile = autograd_profiler.profile
    real_disable = autograd_profiler._disable_profiler
    stops: list[float] = []

    def timed_disable():
        t0 = time.perf_counter()
        try:
            return real_disable()
        finally:
            stops.append(1e3 * (time.perf_counter() - t0))

    autograd_profiler._disable_profiler = timed_disable
    out = []
    try:
        for arm in order:
            if arm == "A":
                autograd_profiler.profile = _WithHostOps
            if arm == "T":
                flight_recorder._capture_profile_trace = \
                    _auto_capture(real_capture)
            stops.clear()
            try:
                res = await chip_smoke.oai_profile_pause(app)
                res["within_limit"] = True
            except SystemExit as e:  # a check of the phase failed
                res = {"within_limit": False, "failed": str(e)}
            finally:
                autograd_profiler.profile = real_profile
                flight_recorder._capture_profile_trace = real_capture
            res.update(arm=arm, stop_ms=list(stops))
            print("pause: " + json.dumps(res), flush=True)
            out.append(res)
            await asyncio.sleep(2.0)
    finally:
        autograd_profiler._disable_profiler = real_disable
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--order", default="CACACC")
    ap.add_argument("--json", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_pause: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    _build.build()
    dev = torch.device("cuda", 0)
    cfg = llama.llama3_8b()
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    app, _, _ = chip_smoke.oai_app(dev, params)

    async def run():
        await app.start()
        try:
            return await readings(app, args.order)
        finally:
            await app.shutdown()

    out = asyncio.run(run())
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "readings": out},
                                        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
