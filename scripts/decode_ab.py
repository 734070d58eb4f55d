"""Time the port's GQA decode kernels against an earlier build of their
source, on one NVIDIA GPU, by chip_smoke.py's device-paced cold-L2 method.

    python3 scripts/decode_ab.py --baseline OLD/decode_attention.cu [--ptxas]

The baseline is an earlier ``gofr_tpu_torch/ops/csrc/decode_attention.cu``
with the split-and-combine C interface of the first port:
``gofr_gqa_decode_attention(q, k, v, kv_len, part_acc, part_ml, o, B, S,
KV, n_rep, D, layer, n_splits, stream)``, its int8 twin with the two scale
planes after ``v``, and ``gofr_decode_split_len()``. It is built with the
same ``nvcc`` flags into ``build/decode_ab/``.

For every decode case of ``chip_smoke.decode_cases`` (both kernels at the
serving shapes, 32-layer stacked caches from seed 0): the baseline and the
current kernel are held against the plain version, then swept over the
layers in turns baseline, current, current, baseline, beside the library
call (or, for int8, the yardstick) and the bound. With ``--ptxas`` the
current source is also compiled with ``-Xptxas -v`` and each kernel
instantiation's registers, shared memory and spills are printed. With
``--sweep-splits`` the current kernel is also timed at 1, 2, 4 and 8
splits a row (the plan ``split_plan`` picks is marked), to retune it. The
results go to standard output, and with ``--json PATH`` to a file.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from gofr_tpu_torch.ops import _build  # noqa: E402
from gofr_tpu_torch.ops import decode_attention as da  # noqa: E402


def build_baseline(src: Path) -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR.parent / "decode_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib_path = out_dir / f"baseline-{digest}.so"
    if not lib_path.exists():
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                        str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.gofr_gqa_decode_attention.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.gofr_gqa_decode_attention_int8.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.gofr_decode_split_len.restype = ctypes.c_int
    return lib


def baseline_launcher(lib, c):
    """The baseline kernel on case ``c`` at a layer (launch and combine)."""
    q, kc, vc, kv_len = c["q"], c["kc"], c["vc"], c["kv_len"]
    B, S, KV, D, H = c["B"], c["S"], c["KV"], c["D"], c["H"]
    n_rep = H // KV
    n_splits = -(-S // lib.gofr_decode_split_len())
    scales = [] if c["scales"] is None else [t.data_ptr() for t in c["scales"]]
    entry = (lib.gofr_gqa_decode_attention if c["scales"] is None
             else lib.gofr_gqa_decode_attention_int8)

    def launch(layer):
        part_acc = torch.empty((B, KV, n_splits, n_rep, D), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B, KV, n_splits, n_rep, 2), dtype=torch.float32,
                              device=q.device)
        out = torch.empty_like(q)
        err = entry(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), *scales,
                    kv_len.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
                    out.data_ptr(), B, S, KV, n_rep, D, layer, n_splits,
                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline launch failed: cudaError_t {err}")
        return out
    return launch


def ptxas_report() -> list[str]:
    """nvcc -Xptxas -v over the current decode source: one line per kernel
    instantiation (D, n_rep, int8) with its registers, smem and spills."""
    src = _build.CSRC / "decode_attention.cu"
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(_build.BUILD_DIR.parent / "decode_ab" / "ptxas.so"), str(src)],
        capture_output=True, text=True, check=True)
    lines, name = [], None
    for line in proc.stderr.splitlines():
        m = re.search(r"decode_kernelILi(\d+)ELi(\d+)ELb([01])E", line)
        if m and "Compiling entry function" in line:
            name = f"D={m[1]} n_rep={m[2]} {'int8' if m[3] == '1' else 'bf16'}"
        elif name and ("spill" in line or "Used" in line):
            lines.append(f"{name}: {line.split('info', 1)[-1].strip(' :')}")
    return lines


def sweep_splits(kernel, c) -> dict:
    """The current kernel's ms per launch at 1, 2, 4 and 8 splits a row."""
    plan = da.split_plan
    tiles = -(-c["S"] // da.TILE)
    n_sm = torch.cuda.get_device_properties(
        c["q"].device).multi_processor_count
    out = {"planned": plan(c["B"], c["KV"], c["S"], n_sm)[1]}
    try:
        for n in (1, 2, 4, 8):
            da.split_plan = lambda *_, n=n: (-(-tiles // n) * da.TILE, n)
            out[n] = chip_smoke.sweep_ms(kernel, c["L"])
    finally:
        da.split_plan = plan
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--sweep-splits", action="store_true")
    ap.add_argument("--json", type=Path, help="write the report here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    _build.build()
    lib = build_baseline(args.baseline)
    report = {"card": card, "cases": []}
    if args.ptxas:
        report["ptxas"] = ptxas_report()
        print("\n".join(report["ptxas"]))
    tol = 2e-2
    for name, c in chip_smoke.decode_cases(dev):
        kernel, plain, library, n_lib, lib_what = \
            chip_smoke.decode_launchers(c)
        base = baseline_launcher(lib, c)
        ref = plain(7).float()
        errs = {"current": (kernel(7).float() - ref).abs().max().item(),
                "baseline": (base(7).float() - ref).abs().max().item()}
        torch.cuda.synchronize()
        chip_smoke.check(max(errs.values()) <= tol,
                         f"{name} {c['label']}: max_abs_err {errs}")
        turns = [("baseline", base), ("current", kernel), ("current", kernel),
                 ("baseline", base)]
        ms = {"baseline": [], "current": []}
        for who, fn in turns:
            ms[who].append(chip_smoke.sweep_ms(fn, c["L"]))
        b_ms, b_by, nbytes = chip_smoke.decode_bound(
            c["kv_len"].tolist(), c["S"], c["KV"], c["D"], c["H"],
            c["scales"] is not None)
        row = {"kernel": name, "case": c["label"], "max_abs_err": errs,
               "ms": ms, "library_ms": chip_smoke.sweep_ms(library, n_lib),
               "library": lib_what, "bound_ms": b_ms, "bound_by": b_by,
               "bound_share": {k: [b_ms / t for t in v] for k, v in ms.items()},
               "tb_per_s": {k: [nbytes / (t * 1e-3) / 1e12 for t in v]
                            for k, v in ms.items()}}
        if args.sweep_splits:
            row["ms_by_splits"] = sweep_splits(kernel, c)
        report["cases"].append(row)
        print(json.dumps(row))
        del c, kernel, plain, library, base
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
