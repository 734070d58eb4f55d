"""Time the port's flash-prefill kernel against an earlier build of its
source, on one NVIDIA GPU, by chip_smoke.py's device-paced cold-L2 method.

    python3 scripts/flash_ab.py --baseline OLD/flash_attention.cu [--ptxas]
        [--diagnose] [--json PATH]

The baseline is any ``gofr_tpu_torch/ops/csrc/flash_attention.cu`` with
the C interface ``gofr_flash_attention(q, k, v, kv_len, o, B, Tq, Tk, H,
KV, D, causal, q_offset, stream)``, for example the first port's:

    git show e4f1eda:gofr_tpu_torch/ops/csrc/flash_attention.cu > OLD/...

It is built with the same ``nvcc`` flags, and ``-I`` on the port's
``csrc/`` for the headers it includes, into ``build/flash_ab/``.

For every flash case of ``chip_smoke.flash_cases`` (the 512-token wave of
2, one 2048-token prompt, a burst of 8 into the 2048 bucket; seed 0): the
baseline and the current kernel are held against the plain version, then
swept over the case's layers in turns baseline, current, current, baseline,
beside ``scaled_dot_product_attention`` (a yardstick the port never calls)
and the bound. With ``--ptxas`` the current source is also compiled with
``-Xptxas -v``: each head-dim instantiation's registers, shared memory and
spills, and every ptxas warning (a ``setmaxnreg`` the compiler ignored,
``wgmma`` serialized, among them), are printed. With ``--diagnose`` three copies of the current
source, each with one part cut out, are timed beside it the same way, to
show what holds the kernel back: ``no_v_loads`` (the producer loads no V
tiles: half the K/V bytes), ``no_math`` (the consumers wait for and
release every tile but compute nothing past each item's first tile: the
load pipeline alone), ``no_softmax`` (the products without the softmax
between them), ``resident_products`` (no softmax, and the producer loads
only each CTA's first ring of K/V tiles, then marks later tiles landed
without loading them: the products on tiles already in shared memory)
and ``resident_s_only`` (the same with S = Q K^T alone). Their outputs
are wrong by design and are not checked. The
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

OUT_DIR = _build.BUILD_DIR.parent / "flash_ab"


def build_source(src: Path, flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build a flash source (with extra nvcc ``flags``) into its own
    library under build/flash_ab/ and load it."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(_build.CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(flags).encode())
    lib_path = OUT_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *flags,
                        f"-I{_build.CSRC}", "-o", str(lib_path), str(src)],
                       check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.gofr_flash_attention.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.gofr_flash_attention.restype = ctypes.c_int
    return lib


def source_launcher(lib, c):
    """A built source's kernel on layer ``i`` of flash case ``c``."""
    qs, ks, vs, kv_len = c["q"], c["k"], c["v"], c["kv_len"]
    B, T, H, KV, D = c["B"], c["T"], c["H"], c["KV"], c["D"]

    def launch(i):
        out = torch.empty_like(qs[i])
        err = lib.gofr_flash_attention(
            qs[i].data_ptr(), ks[i].data_ptr(), vs[i].data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), B, T, T, H, KV, D, 1, 0,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash launch failed: error {err}")
        return out
    return launch


def ptxas_report(src: Path = _build.CSRC / "flash_attention.cu",
                 flags: tuple[str, ...] = ()) -> list[str]:
    """nvcc -Xptxas -v over a flash source (with extra nvcc ``flags``): one
    line per kernel instantiation (D) with its registers, shared memory and
    spills, and every warning line as it is."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v",
         f"-I{_build.CSRC}", "-o", str(OUT_DIR / "ptxas.so"), str(src)],
        capture_output=True, text=True, check=True)
    lines, name = [], None
    for line in proc.stderr.splitlines():
        m = re.search(r"flash_fwd_kernelILi(\d+)E", line)
        if m and "Compiling entry function" in line:
            name = f"D={m[1]}"
        elif ("warning" in line.lower() or "setmaxnreg" in line
              or "Performance Loss" in line):
            lines.append(f"WARNING {line.strip()}")
        elif name and ("spill" in line or "Used" in line):
            lines.append(f"{name}: {line.split('info', 1)[-1].strip(' :')}")
    return lines


# the parts --diagnose cuts out of the current source: (old text, new text)
_NO_SOFTMAX = (
    """          softmax(t);
          wgmma_wait<0>();""", "          wgmma_wait<0>();")
_RESIDENT = [(
    """          mbar_arrive_expect_tx(full_%s(s), L::KV_BYTES);
#pragma unroll
          for (int cb = 0; cb < L::NCB; ++cb)
            tma_load_4d(base + L::%s(s) + cb * BK * L::ROWB, &tm_%s, full_%s(s),
                        cb * L::BOXC, kvh, t * BK, it.b);""" % (x, x, x, x),
    """          if (kt >= STAGES) {
            mbar_arrive(full_%s(s));
          } else {
          mbar_arrive_expect_tx(full_%s(s), L::KV_BYTES);
#pragma unroll
          for (int cb = 0; cb < L::NCB; ++cb)
            tma_load_4d(base + L::%s(s) + cb * BK * L::ROWB, &tm_%s, full_%s(s),
                        cb * L::BOXC, kvh, t * BK, it.b);
          }""" % (x, x, x, x, x)) for x in ("k", "v")]
DIAGNOSE = {
    "no_v_loads": [(
        """          mbar_arrive_expect_tx(full_v(s), L::KV_BYTES);
#pragma unroll
          for (int cb = 0; cb < L::NCB; ++cb)
            tma_load_4d(base + L::v(s) + cb * BK * L::ROWB, &tm_v, full_v(s),
                        cb * L::BOXC, kvh, t * BK, it.b);""",
        "          mbar_arrive(full_v(s));")],
    "no_math": [(
        """          issue_s(qb, s);
          wgmma_commit();
          issue_pv(sp);
          wgmma_commit();
          wgmma_wait<1>();""", "          wgmma_wait<1>();"), (
        """          softmax(t);
          wgmma_wait<0>();""", "          wgmma_wait<0>();")],
    "no_softmax": [_NO_SOFTMAX],
    "resident_products": _RESIDENT + [_NO_SOFTMAX],
    "resident_s_only": _RESIDENT + [_NO_SOFTMAX, (
        """          issue_pv(sp);
          wgmma_commit();
          wgmma_wait<1>();""", """          wgmma_commit();
          wgmma_wait<1>();""")],
}


def diagnose_sources() -> dict[str, Path]:
    """The --diagnose copies of the current source, under build/flash_ab/."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    out = {}
    for name, cuts in DIAGNOSE.items():
        text = src
        for old, new in cuts:
            if text.count(old) != 1:
                raise SystemExit(f"flash_ab: --diagnose {name}: the source "
                                 "no longer holds the part to cut")
            text = text.replace(old, new)
        out[name] = OUT_DIR / f"diagnose_{name}.cu"
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        out[name].write_text(text)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--diagnose", action="store_true")
    ap.add_argument("--json", type=Path, help="write the report here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    _build.build()
    lib = build_source(args.baseline)
    cut = ({name: build_source(path) for name, path in
            diagnose_sources().items()} if args.diagnose else {})
    report = {"card": card, "cases": []}
    if args.ptxas:
        report["ptxas"] = ptxas_report()
        print("\n".join(report["ptxas"]))
    tol = 2e-2
    for c in chip_smoke.flash_cases(dev):
        kernel, plain, library = chip_smoke.flash_launchers(c)
        base = source_launcher(lib, c)
        ref = plain(0).float()
        errs = {"current": (kernel(0).float() - ref).abs().max().item(),
                "baseline": (base(0).float() - ref).abs().max().item()}
        torch.cuda.synchronize()
        del ref
        chip_smoke.check(max(errs.values()) <= tol,
                         f"flash {c['label']}: max_abs_err {errs}")
        ms = {"baseline": [], "current": []}
        for who, fn in [("baseline", base), ("current", kernel),
                        ("current", kernel), ("baseline", base)]:
            ms[who].append(chip_smoke.sweep_ms(fn, c["L"]))
        b_ms, b_by, nbytes = chip_smoke.flash_bound(c)
        row = {"case": c["label"], "max_abs_err": errs, "ms": ms,
               "library_ms": chip_smoke.sweep_ms(library, c["L"]),
               "library": "scaled_dot_product_attention (boolean mask, "
                          "enable_gqa)",
               "bound_ms": b_ms, "bound_by": b_by,
               "bound_share": {k: [b_ms / t for t in v] for k, v in ms.items()},
               "tb_per_s": {k: [nbytes / (t * 1e-3) / 1e12 for t in v]
                            for k, v in ms.items()}}
        if cut:
            row["diagnose_ms"] = {
                name: chip_smoke.sweep_ms(source_launcher(clib, c), c["L"])
                for name, clib in cut.items()}
        report["cases"].append(row)
        print(json.dumps(row))
        del c, kernel, plain, library, base
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
