"""Serving A/B of two trees of the port on one card, in turns.

    python3 scripts/serving_ab.py --baseline DIR [--order PCNNCPPNC]
                                  [--json OUT]

``DIR`` is a checkout of an earlier commit (``git archive <commit> | tar
-x -C DIR``); the change is the tree this script sits in. Each letter of
``--order`` runs one process from a tree: ``P`` the baseline, ``C`` the
change, ``N`` the change with the SLO controller's targets out of reach
(``GOFR_ML_TTFT_TARGET_MS`` / ``GOFR_ML_TPOT_TARGET_MS`` at 10**6 ms, so
the prefill share stays at its neutral 0.5 as in a tree without the
controller). A process builds the kernels, draws the Llama-3-8B weights
from seed 0 and runs that tree's ``chip_smoke.main_path`` (8 requests
through ``LLMServer``) and twice its phase-5 paged bf16 arm
(``paged_arm``), printing served tok/s, decode steps, prefill segments and
the scheduler's final prefill share. Needs one CUDA card; prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

# runs inside one tree (cwd), with that tree's package and chip_smoke
SIDE = r"""
import json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from gofr_tpu_torch.models import llama
from gofr_tpu_torch.ops import _build

_build.build()
dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
path, params = cs.main_path(dev)
cfg = llama.llama3_8b()
paged = []
for _ in range(2):
    res, gen = cs.paged_arm(llama, params, cfg, dev, n_shared=16, n_long=2,
                            pin=True, seed=1, int8=False)
    paged.append({"tok_per_s": res["served_tok_per_s"],
                  "decode_steps": res["decode_steps"],
                  "segments": res["prefill_segments_run"],
                  "prefill_share": gen.scheduler.prefill_share})
    del gen
print("AB " + json.dumps({"main_tok_per_s": path["served_tok_per_s"],
                          "paged": paged}))
"""


def run_side(tree: pathlib.Path, neutral: bool) -> dict:
    env = dict(os.environ)
    if neutral:
        env.update(GOFR_ML_TTFT_TARGET_MS="1000000",
                   GOFR_ML_TPOT_TARGET_MS="1000000")
    out = subprocess.run([sys.executable, "-c", SIDE], cwd=tree, env=env,
                         capture_output=True, text=True, check=True)
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("AB ")][-1]
    return json.loads(line[3:])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", required=True, type=pathlib.Path)
    ap.add_argument("--order", default="PCNNCPPNC")
    ap.add_argument("--json", type=pathlib.Path)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for side in args.order:
        tree = args.baseline.resolve() if side == "P" else ROOT
        res = {"side": side, **run_side(tree, neutral=side == "N")}
        runs.append(res)
        print(json.dumps(res), flush=True)
    summary = {}
    for side in sorted(set(args.order)):
        mine = [r for r in runs if r["side"] == side]
        summary[side] = {
            "main_tok_per_s": sorted(r["main_tok_per_s"] for r in mine),
            "paged_tok_per_s_median": statistics.median(
                p["tok_per_s"] for r in mine for p in r["paged"]),
            "paged_tok_per_s": sorted(p["tok_per_s"] for r in mine
                                      for p in r["paged"]),
            "paged_steps_segments": sorted({(p["decode_steps"], p["segments"])
                                            for r in mine
                                            for p in r["paged"]})}
    print(json.dumps({"card": card, "summary": summary}))
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "runs": runs,
                                         "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
