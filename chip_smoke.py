"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100 for sm_90a).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it goes wrong:

1. device and build: print the card's name and power limit, build every
   CUDA kernel of the serving path from ``gofr_tpu_torch/ops/csrc`` (one
   ``nvcc`` per source, all started together);
2. kernels against their plain PyTorch versions on the card, at the shapes
   the Llama-3-8B serving paths give them: flash prefill for a wave of 2
   prompts in the 512 bucket, one 2048-token prompt and a burst of 8
   prompts into the 2048 bucket; GQA decode over the bf16 cache and over
   the int8 cache, each at its phase-2 shape, at the 8-slot decode step
   (len 2000 of 4096) and for one row of 4096. Each kernel, its plain
   version and a PyTorch library call (``scaled_dot_product_attention``, a
   yardstick the port never calls) are timed by ``sweep_ms``: one launch
   per layer over enough layers (32, or 8 at the 2048 flash shapes) that
   each finds its inputs cold in the L2 as on the main path, captured in a
   CUDA graph and replayed under CUDA events so the device, not the
   Python wrapper, sets the pace; printed beside the least time the card
   could take, the share of it reached and the TB/s;
3. the bf16 main path: Llama-3-8B at full width (32 layers, random weights
   from seed 0, bf16) -> ``Generator`` -> ``LLMServer`` answering 8
   concurrent requests, with the kernels' launch counts read around that
   run (and the model's flash calls tallied by shape); then the greedy
   repeat check, the kernel-vs-plain check of the model's prefill and
   decode logits, and the prefill / decode timings with flash's share of
   the prefill's device time; the decode step's profile must hold one
   decode kernel a layer;
4. the int8 main path: the same model with ``kv_quant=True, w8=True``
   (weights quantized on the card from the seed-0 bf16 draw) behind
   ``LLMServer`` with 8 slots x 4096 positions answering 16 concurrent
   requests, launch counts read around that run (the int8 decode kernel
   only, never the bf16 one; flash calls tallied by shape); the
   kernel-vs-plain check of one decode step's logits; prefill (with
   flash's share of its device time) and decode timings, and as
   measurements only,
   the decode step at the same shape with bf16 weights over the int8
   cache and fully in bf16, and the cost of quantize-on-write.

The line before the last is the card; the last is the JSON verdict.
Without a CUDA device the script exits non-zero and prints no verdict.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import json
import subprocess
import sys
import time

import torch

# H100 SXM published peaks (NVIDIA data sheet): dense bf16 tensor-core
# rate and HBM3 bandwidth; the card's power limit is printed beside them
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sweep_ms(launch, n_layers: int, reps: int = 10, graph: bool = True) -> float:
    """Device ms per launch of ``launch(layer)`` swept once over
    ``n_layers`` layers, so each launch finds its layer cold in the L2 as on
    the main path. The sweep is captured in a CUDA graph and replayed
    ``reps`` times under CUDA events, so the device, not the Python
    wrapper, sets the pace. If capture fails, the kernels' own device time
    under torch.profiler is used instead; ``graph=False`` times the sweep
    eagerly (for the plain versions, whose ms dwarf the host's pace)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if not graph:
        for layer in range(n_layers):
            launch(layer)
        torch.cuda.synchronize()
        start.record()
        for layer in range(n_layers):
            launch(layer)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n_layers
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm: per-stream state, allocations
        for layer in range(n_layers):
            launch(layer)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g, stream=stream):
            for layer in range(n_layers):
                launch(layer)
    except RuntimeError as exc:
        print(f"chip_smoke: graph capture failed ({exc}); timing with "
              "torch.profiler", file=sys.stderr)
        return profiled_ms(launch, n_layers, reps)
    g.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n_layers)


def profiled_ms(launch, n_layers: int, reps: int) -> float:
    """The device time of the kernels ``launch`` runs, per launch, under
    torch.profiler (the fallback of ``sweep_ms``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for layer in range(n_layers):
                launch(layer)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / (reps * n_layers)


def device_profile(fn, n: int) -> dict:
    """``n`` calls of ``fn`` under torch.profiler: host wall per call, the
    device's kernel time per call, their ratio (the busy share; the rest of
    the wall the card sat idle waiting for the host) and the kernels that
    took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    flash_us = sum(e.self_device_time_total for e in kernels
                   if "flash" in e.key)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": wall * 1e3 / n, "device_ms": busy_us / 1e3 / n,
            "busy_share": busy_us / 1e6 / wall,
            # the flash kernel's device time and its share of the device's
            "flash_device_ms": flash_us / 1e3 / n,
            "flash_share": flash_us / busy_us if busy_us else 0.0,
            "top_device_ms": {e.key[:80]: e.self_device_time_total / 1e3 / n
                              for e in top},
            # launches per call of every attention kernel of the port
            "attention_launches": {e.key[:80]: e.count / n for e in kernels
                                   if "decode" in e.key or "flash" in e.key}}


@contextlib.contextmanager
def flash_shapes(llama):
    """Tally the model's flash calls by shape inside the block, as
    {"B x Tq x Tk": calls}. It wraps the dispatcher the model calls; the
    kernel wrapper's own counter stays the proof that the kernel ran."""
    seen = collections.Counter()
    inner = llama.flash_attention

    def tally(q, k, v, **kw):
        seen[f"{q.shape[0]}x{q.shape[1]}x{k.shape[1]}"] += 1
        return inner(q, k, v, **kw)

    llama.flash_attention = tally
    try:
        yield seen
    finally:
        llama.flash_attention = inner


def check_one_decode_launch_per_layer(prof: dict, n_layers: int) -> None:
    """A decode step's profile holds one decode kernel per layer and
    nothing else of the decode attention (no combine pass). The count is
    rounded: the profiler can miss a kernel record at the edge of its
    window (31.8 a step over 5 steps has been seen on the H100)."""
    decode = {k: v for k, v in prof["attention_launches"].items()
              if "decode" in k}
    check(len(decode) == 1 and round(list(decode.values())[0]) == n_layers,
          f"decode step profile: expected one decode kernel launched "
          f"{n_layers} times a step, got {decode}")


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def counters() -> dict:
    """The launch counter of every kernel wrapper."""
    from gofr_tpu_torch.ops.decode_attention import (
        gqa_decode_attention_cuda, gqa_decode_attention_int8_cuda)
    from gofr_tpu_torch.ops.flash_attention import flash_attention_cuda

    return {"flash_attention_cuda": flash_attention_cuda,
            "gqa_decode_attention_cuda": gqa_decode_attention_cuda,
            "gqa_decode_attention_int8_cuda": gqa_decode_attention_int8_cuda}


def reset_launches() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def rnd_bf16(g, dev, *shape):
    return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)


def int8_cache(g, dev, L, B, S, KV, D):
    """A seeded stacked int8 cache as the serving path keeps it: values
    [L, B, S, KV*D] and seq-minor bf16 scales [L, B, KV, S], K and V,
    quantized one layer at a time."""
    from gofr_tpu_torch.ops import quantize_kv

    kc, vc = (torch.empty((L, B, S, KV * D), dtype=torch.int8, device=dev)
              for _ in range(2))
    ks, vs = (torch.empty((L, B, KV, S), dtype=torch.bfloat16, device=dev)
              for _ in range(2))
    for i in range(L):
        for values, scales in ((kc, ks), (vc, vs)):
            codes, scale = quantize_kv(rnd_bf16(g, dev, B, S, KV, D))
            values[i] = codes.reshape(B, S, KV * D)
            scales[i] = scale.transpose(1, 2)
    return kc, vc, ks, vs


def decode_bound(kv_len, S: int, KV: int, D: int, H: int, int8: bool):
    """(bound ms, bound_by, bytes): the live cache (int8: values and one
    bf16 scale per position and KV head), q and o once, kv_len."""
    live = sum(min(n, S) if n > 0 else S for n in kv_len)
    row = KV * (D + 2) if int8 else KV * D * 2
    nbytes = 2 * live * row + 2 * (2 * len(kv_len) * H * D) + 4 * len(kv_len)
    return (*bound(4 * D * H * live, nbytes), nbytes)


def decode_cases(dev):
    """The decode kernels' inputs at the serving shapes, made from seed 0:
    yields (kernel name, case label, stacked inputs). Each cache holds all
    32 layers of Llama-3-8B, so a sweep over the layers finds each cold."""
    g = torch.Generator(device=dev).manual_seed(0)
    L, KV, D, H = 32, 8, 128, 32

    def case(label, B, S, lens, kc, vc, scales=None):
        return {"label": label, "L": L, "B": B, "S": S, "KV": KV, "D": D,
                "H": H, "q": rnd_bf16(g, dev, B, 1, H, D), "kc": kc,
                "vc": vc, "scales": scales,
                "kv_len": torch.tensor(lens, dtype=torch.int32, device=dev)}

    # bf16: the phase-2 shape (4 slots x 1024, a row at capacity carries
    # S_max + 1), the 8-slot decode step at len 2000 (S_max 4096), one row
    kc, vc = rnd_bf16(g, dev, L, 4, 1024, KV, D), rnd_bf16(g, dev, L, 4, 1024, KV, D)
    yield "gqa_decode_attention_cuda", case(
        "4x1024 ragged", 4, 1024, [1, 1000, 1024, 1025], kc, vc)
    kc, vc = rnd_bf16(g, dev, L, 8, 4096, KV, D), rnd_bf16(g, dev, L, 8, 4096, KV, D)
    yield "gqa_decode_attention_cuda", case("8x2000", 8, 4096, [2000] * 8, kc, vc)
    del kc, vc
    kc, vc = rnd_bf16(g, dev, L, 1, 4096, KV, D), rnd_bf16(g, dev, L, 1, 4096, KV, D)
    yield "gqa_decode_attention_cuda", case("1x4096", 1, 4096, [4096], kc, vc)
    del kc, vc
    # int8: the phase-2 shape (8 slots x 4096, ragged 1 .. capacity), the
    # int8 path's decode step (8 x len 2000), one row of 4096
    kc, vc, ks, vs = int8_cache(g, dev, L, 8, 4096, KV, D)
    yield "gqa_decode_attention_int8_cuda", case(
        "8x4096 ragged", 8, 4096, [1, 129, 1000, 2048, 2049, 4000, 4096, 4097],
        kc, vc, (ks, vs))
    yield "gqa_decode_attention_int8_cuda", case(
        "8x2000", 8, 4096, [2000] * 8, kc, vc, (ks, vs))
    del kc, vc, ks, vs
    kc, vc, ks, vs = int8_cache(g, dev, L, 1, 4096, KV, D)
    yield "gqa_decode_attention_int8_cuda", case(
        "1x4096", 1, 4096, [4096], kc, vc, (ks, vs))


def decode_launchers(c):
    """(kernel(layer), plain(layer), library(layer), library layers, what
    the library call is) for one decode case."""
    import torch.nn.functional as F

    from gofr_tpu_torch.ops import dequantize_kv
    from gofr_tpu_torch.ops.decode_attention import (
        gqa_decode_attention_cuda, gqa_decode_attention_int8_cuda,
        gqa_decode_attention_int8_plain, gqa_decode_attention_plain)

    q, kc, vc, kv_len = c["q"], c["kc"], c["vc"], c["kv_len"]
    B, S, KV, D = c["B"], c["S"], c["KV"], c["D"]
    qt = q.transpose(1, 2)
    smask = (torch.arange(S, device=q.device)[None, :]
             < kv_len.clamp(max=S)[:, None])[:, None, None, :]
    if c["scales"] is None:
        def kernel(layer):
            return gqa_decode_attention_cuda(q, kc, vc, kv_len, layer=layer)

        def plain(layer):
            return gqa_decode_attention_plain(q, kc, vc, kv_len, layer=layer)

        def library(layer):
            return F.scaled_dot_product_attention(
                qt, kc[layer].transpose(1, 2), vc[layer].transpose(1, 2),
                attn_mask=smask, enable_gqa=True)
        return kernel, plain, library, c["L"], "scaled_dot_product_attention"
    ks, vs = c["scales"]
    sc = {"k_scale": ks, "v_scale": vs}

    def kernel(layer):
        return gqa_decode_attention_int8_cuda(q, kc, vc, kv_len, layer=layer,
                                              **sc)

    def plain(layer):
        return gqa_decode_attention_int8_plain(q, kc, vc, kv_len, layer=layer,
                                               **sc)

    # the yardstick reads dequantized bf16 layers: enough of them that a
    # sweep reads >= 4 x the 50 MB L2
    per_layer = 2 * B * S * KV * D * 2
    n_deq = min(c["L"], -(-4 * 50 * 2**20 // per_layer))
    deq = [tuple(dequantize_kv(values[i].view(B, S, KV, D),
                               scales[i].transpose(1, 2)).transpose(1, 2)
                 for values, scales in ((kc, ks), (vc, vs)))
           for i in range(n_deq)]

    def library(layer):
        kt, vt = deq[layer]
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=smask,
                                              enable_gqa=True)
    return (kernel, plain, library, n_deq,
            "yardstick: scaled_dot_product_attention over dequantized bf16 "
            "layers (twice the cache bytes of the int8 read)")


def measure_decode(c, tol: float) -> dict:
    """One decode case: the kernel against its plain version at the case's
    layer 7, then the kernel, the library call and the plain version timed
    by ``sweep_ms`` (the plain version eagerly, over 4 layers)."""
    kernel, plain, library, n_lib, lib_what = decode_launchers(c)
    out, ref = kernel(7), plain(7)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out.float()).all()),
          f"decode {c['label']}: output not finite")
    err = (out.float() - ref.float()).abs().max().item()
    check(err <= tol, f"decode {c['label']}: kernel vs plain max_abs_err "
          f"{err} > {tol}")
    lens = c["kv_len"].tolist()
    b_ms, b_by, nbytes = decode_bound(lens, c["S"], c["KV"], c["D"], c["H"],
                                      c["scales"] is not None)
    ms = sweep_ms(kernel, c["L"])
    lib_ms = sweep_ms(library, n_lib)
    int8 = c["scales"] is not None
    return {"case": c["label"],
            "shape": f"q[{c['B']},1,{c['H']},{c['D']}] cache L={c['L']} "
                     f"B={c['B']} S={c['S']} KV={c['KV']} "
                     f"{'int8' if int8 else 'bf16'} "
                     f"kv_len={lens}",
            "max_abs_err": err, "ms": ms,
            # no PyTorch call attends over an int8 cache: a yardstick there
            "library_ms": None if int8 else lib_ms,
            **({"yardstick": lib_what, "yardstick_ms": lib_ms} if int8
               else {}),
            "plain_ms": sweep_ms(plain, 4, graph=False),
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
            "tb_per_s": nbytes / (ms * 1e-3) / 1e12}


def flash_cases(dev):
    """The flash kernel's inputs at the serving paths' prefill shapes, made
    from seed 0: yields one dict a shape, with ``L`` layers' worth of
    q, k, v (enough that a sweep over them reads >= 4 x the 50 MB L2, so
    each launch finds its inputs cold)."""
    g = torch.Generator(device=dev).manual_seed(0)
    H, KV, D = 32, 8, 128
    for label, B, T, lens, L in (
            # a wave of 2 prompts in the 512 bucket (the bf16 path)
            ("512 wave of 2", 2, 512, [512, 301], 32),
            # one long prompt: the int8 path's timed 2048-bucket prefill
            ("2048 trickle", 1, 2048, [2000], 8),
            # a burst of 8 admissions into the 2048 bucket (generate.py's
            # waves of min(8, slots) rows)
            ("2048 burst of 8", 8, 2048,
             [2000, 1942, 1500, 1024, 777, 513, 129, 37], 8)):
        yield {"label": label, "B": B, "T": T, "H": H, "KV": KV, "D": D,
               "L": L, "kv_len": torch.tensor(lens, dtype=torch.int32,
                                              device=dev),
               "q": [rnd_bf16(g, dev, B, T, H, D) for _ in range(L)],
               "k": [rnd_bf16(g, dev, B, T, KV, D) for _ in range(L)],
               "v": [rnd_bf16(g, dev, B, T, KV, D) for _ in range(L)]}


def flash_bound(c) -> tuple[float, str, float]:
    """(bound ms, bound_by, bytes) of one causal flash call of case ``c``:
    4 * D FLOPs per (query, key) pair the causal and kv_len masks keep
    (padded query rows included: the kernel keeps their outputs); q and o
    once, the live K/V prefix once, kv_len."""
    lens = c["kv_len"].tolist()
    B, T, H, KV, D = c["B"], c["T"], c["H"], c["KV"], c["D"]
    pairs = sum(min(i + 1, n) for n in lens for i in range(T))
    nbytes = 2 * (2 * B * T * H * D + 2 * sum(lens) * KV * D) + 4 * B
    return (*bound(4 * D * H * pairs, nbytes), nbytes)


def flash_launchers(c):
    """(kernel(layer), plain(layer), library(layer)) for one flash case;
    the library call is scaled_dot_product_attention with the same causal
    and kv_len mask as a boolean mask, a yardstick the port never calls."""
    import torch.nn.functional as F

    from gofr_tpu_torch.ops.flash_attention import (flash_attention_cuda,
                                                    flash_attention_plain)

    qs, ks, vs, kv_len = c["q"], c["k"], c["v"], c["kv_len"]
    kpos = torch.arange(c["T"], device=kv_len.device)
    mask = ((kpos[None, :] <= kpos[:, None])[None]
            & (kpos[None, None, :] < kv_len[:, None, None]))[:, None]

    def kernel(i):
        return flash_attention_cuda(qs[i], ks[i], vs[i], kv_len, causal=True)

    def plain(i):
        return flash_attention_plain(qs[i], ks[i], vs[i], kv_len, causal=True)

    def library(i):
        return F.scaled_dot_product_attention(
            qs[i].transpose(1, 2), ks[i].transpose(1, 2),
            vs[i].transpose(1, 2), attn_mask=mask, enable_gqa=True)
    return kernel, plain, library


def measure_flash(c, tol: float) -> dict:
    """One flash case: the kernel against its plain version on layer 0,
    then the kernel and the library call timed by ``sweep_ms`` over the
    case's layers, the plain version eagerly over 4 layers (2 at the 2048
    shapes, whose f32 logits are up to 4.3 GB a call)."""
    kernel, plain, library = flash_launchers(c)
    out, ref = kernel(0), plain(0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out.float()).all()),
          f"flash {c['label']}: output not finite")
    err = (out.float() - ref.float()).abs().max().item()
    del out, ref
    check(err <= tol, f"flash {c['label']}: kernel vs plain max_abs_err "
          f"{err} > {tol}")
    b_ms, b_by, nbytes = flash_bound(c)
    ms = sweep_ms(kernel, c["L"])
    B, T, H, KV, D = c["B"], c["T"], c["H"], c["KV"], c["D"]
    return {"case": c["label"],
            "shape": f"q[{B},{T},{H},{D}] kv[{B},{T},{KV},{D}] causal "
                     f"kv_len={c['kv_len'].tolist()}",
            "max_abs_err": err, "ms": ms,
            "library_ms": sweep_ms(library, c["L"]),
            "plain_ms": sweep_ms(plain, 4 if T <= 512 else 2, graph=False),
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
            "tb_per_s": nbytes / (ms * 1e-3) / 1e12}


def kernel_phase(dev) -> list[dict]:
    """Each kernel against its plain version at the 8b serving shapes, and
    timed by ``sweep_ms``: cold L2, paced by the device."""
    from gofr_tpu_torch.ops.flash_attention import flash_attention_cuda

    rows = []
    # bf16 tolerance: outputs are O(1); one bf16 ulp there is 2**-7, and
    # the kernel rounds P to bf16 before P@V where the plain version
    # normalises first — 2e-2 absolute covers both
    tol = 2e-2

    # flash prefill at its three serving shapes; the row's headline is the
    # 512-token wave, every shape is under "by_shape"
    flash = {"name": "flash_attention_cuda", "route": "cuda",
             "source": "gofr_tpu_torch/ops/csrc/flash_attention.cu",
             "replaces": "gofr_tpu/ops/flash_attention.py:89", "tol": tol,
             "by_shape": []}
    for c in flash_cases(dev):
        n0 = flash_attention_cuda.launches
        res = measure_flash(c, tol)
        check(flash_attention_cuda.launches > n0, "flash counter did not move")
        if not flash["by_shape"]:
            flash.update({k: v for k, v in res.items() if k != "case"})
        flash["by_shape"].append(res)
        flash["max_abs_err"] = max(flash["max_abs_err"], res["max_abs_err"])
        del c
    rows.append(flash)

    # GQA decode, both kernels, each at its shapes; the row's headline is
    # its first (phase-2) shape, every shape is under "by_shape"
    decode = {
        "gqa_decode_attention_cuda": {
            "name": "gqa_decode_attention_cuda", "route": "cuda",
            "source": "gofr_tpu_torch/ops/csrc/decode_attention.cu",
            "replaces": "gofr_tpu/ops/decode_attention.py:42"},
        "gqa_decode_attention_int8_cuda": {
            "name": "gqa_decode_attention_int8_cuda", "route": "cuda",
            "source": "gofr_tpu_torch/ops/csrc/decode_attention.cu",
            "replaces": "gofr_tpu/ops/decode_attention.py:147"}}
    from gofr_tpu_torch.ops import decode_attention as da
    for name, c in decode_cases(dev):
        fn = getattr(da, name)
        n0 = fn.launches
        res = measure_decode(c, tol)
        check(fn.launches > n0, f"{name} counter did not move")
        row = decode[name]
        if "by_shape" not in row:
            row.update({k: v for k, v in res.items() if k != "case"},
                       tol=tol, by_shape=[])
        row["by_shape"].append(res)
        row["max_abs_err"] = max(row["max_abs_err"], res["max_abs_err"])
    return rows + list(decode.values())


def serve(gen, prompts, max_new: int, repeat) -> tuple[list, float, list]:
    """Every prompt through ``LLMServer`` at once (half ``generate``, half
    ``stream_chunks``), then ``repeat`` twice alone. Returns (outputs, wall
    seconds of the concurrent run, the two repeats)."""
    from gofr_tpu_torch.ml.llm import LLMServer

    async def run():
        server = LLMServer(gen, name="chat")

        async def chunks(p):
            out = []
            async for burst in server.stream_chunks(p, max_new):
                out.extend(burst)
            return out

        try:
            t = time.perf_counter()
            outs = await asyncio.gather(*(
                server.generate(p, max_new) if i % 2 else chunks(p)
                for i, p in enumerate(prompts)))
            wall = time.perf_counter() - t
            again = [await server.generate(repeat, max_new) for _ in range(2)]
            return outs, wall, again
        finally:
            server.close()

    return asyncio.run(run())


def check_served(cfg, prompts, outs, again, max_new: int) -> None:
    check(len(outs) == len(prompts), "not every request answered")
    check(all(len(o) == max_new and all(0 <= t < cfg.vocab_size for t in o)
              for o in outs + again),
          "every request returns max_new ids inside the vocabulary")
    check(again[0] == again[1], "one prompt served twice alone differs")


def decode_logit_err(llama, params, cfg, tok, cache, plain) -> float:
    """One decode step's logits on the prefilled ``cache``, through the
    decode kernel (on a copy) and through its plain version ``plain``:
    the largest difference over the logits' range."""
    with torch.no_grad():
        got, _ = llama.decode_step(params, tok,
                                   {k: v.clone() for k, v in cache.items()},
                                   cfg)
        kernel = llama.cached_decode_attention
        llama.cached_decode_attention = plain
        try:
            want, _ = llama.decode_step(params, tok, cache, cfg)
        finally:
            llama.cached_decode_attention = kernel
    return (got - want).abs().max().item() / want.abs().max().item()


def main_path(dev) -> tuple[dict, dict]:
    """Llama-3-8B bf16 at full width behind LLMServer: 8 concurrent
    requests. Returns (results, the seed-0 bf16 weights)."""
    import numpy as np

    from gofr_tpu_torch.ml.generate import Generator
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.ops.decode_attention import gqa_decode_attention_plain
    from gofr_tpu_torch.ops.flash_attention import flash_attention_plain

    cfg = llama.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    max_new = 32
    gen = Generator(params, cfg, batch_slots=4, max_seq=1024, chunk=4,
                    prefill_buckets=(128, 512), device=dev)
    t0 = time.perf_counter()
    gen.warmup()
    warm_s = time.perf_counter() - t0
    r = np.random.default_rng(0)
    prompts = [r.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 17, 60, 128, 200, 333, 480, 500)]

    torch.cuda.reset_peak_memory_stats()
    steps0, waves0 = gen.steps, gen.prefill_waves
    reset_launches()
    with flash_shapes(llama) as shapes:
        outs, wall, again = serve(gen, prompts, max_new, prompts[3])
        torch.cuda.synchronize()
    launches = read_launches()
    steps, waves = gen.steps - steps0, gen.prefill_waves - waves0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    check_served(cfg, prompts, outs, again, max_new)
    check(launches["flash_attention_cuda"] >= cfg.n_layers * waves > 0,
          f"flash launched {launches['flash_attention_cuda']} times for "
          f"{waves} prefill waves")
    check(launches["gqa_decode_attention_cuda"] >= cfg.n_layers * steps > 0,
          f"decode launched {launches['gqa_decode_attention_cuda']} times "
          f"for {steps} decode steps")
    check(launches["gqa_decode_attention_int8_cuda"] == 0,
          "the bf16 path launched the int8 decode kernel")

    # prefill logits through the kernels vs the plain path, on the card
    ids = np.asarray(prompts[6], np.int32)[None]
    tokens = np.zeros((1, 512), np.int32)
    tokens[0, :ids.shape[1]] = ids
    lens = np.array([ids.shape[1]], np.int32)
    cache = llama.init_cache(cfg, 1, 1024, device=dev)
    with torch.no_grad():
        got, _ = llama.prefill(params, tokens, lens, cfg, cache)
        kernel_flash = llama.flash_attention
        llama.flash_attention = (lambda q, k, v, *, causal=True, kv_len=None:
                                 flash_attention_plain(q, k, v, kv_len,
                                                       causal=causal))
        try:
            want, _ = llama.prefill(params, tokens, lens, cfg, cache)
        finally:
            llama.flash_attention = kernel_flash
    scale = want.abs().max().item()
    logit_err = (got - want).abs().max().item() / scale
    # 32 bf16 layers amplify the kernels' last-bit differences: held at 5%
    # of the logits' range, and both paths must pick the same token
    check(logit_err <= 5e-2, f"prefill logits kernel vs plain rel err "
          f"{logit_err} > 5e-2")
    check(int(got.argmax()) == int(want.argmax()),
          "prefill argmax differs between kernel and plain path")

    # decode logits of one step, kernel vs plain, on the same cache
    with torch.no_grad():
        _, cache = llama.prefill(params, tokens, lens, cfg, cache)
    dec_err = decode_logit_err(llama, params, cfg,
                               torch.tensor([int(got.argmax())], device=dev),
                               cache, gqa_decode_attention_plain)
    check(dec_err <= 5e-2, f"decode logits kernel vs plain rel err {dec_err}")

    # timings: one 512-bucket prefill wave of one prompt, and decode steps
    # of the full 4-slot batch
    def one_prefill():
        llama.prefill_into(params, tokens, lens, cfg, gen.cache, 0)

    prefill_ms = timed_ms(one_prefill, iters=5, warm=1)
    gen.cache["len"].fill_(500)
    step_tok = torch.zeros(4, dtype=torch.int32, device=dev)

    def one_step():
        llama.decode_step(params, step_tok, gen.cache, cfg)
        gen.cache["len"].fill_(500)

    step_ms = timed_ms(one_step, iters=10, warm=2)
    prefill_prof = device_profile(one_prefill, 3)
    step_prof = device_profile(one_step, 5)
    check_one_decode_launch_per_layer(step_prof, cfg.n_layers)
    served = sum(len(o) for o in outs)
    return {
        "launches": launches, "prefill_waves": waves, "decode_steps": steps,
        "flash_calls_by_shape": dict(shapes),
        "init_s": init_s, "warmup_s": warm_s,
        "served_tokens": served, "served_wall_s": wall,
        "served_tok_per_s": served / wall,
        "prefill_ms_b1_s512": prefill_ms, "decode_step_ms_b4": step_ms,
        "decode_tok_per_s_b4": 4 / (step_ms / 1e3),
        "peak_mem_gib": peak_gb,
        "prefill_logit_rel_err": logit_err, "decode_logit_rel_err": dec_err,
        "prefill_profile": prefill_prof, "decode_step_profile": step_prof,
    }, params


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def int8_path(dev, bf16_params) -> dict:
    """Llama-3-8B with the int8 cache and int8 weights at full width and
    depth behind LLMServer: 8 slots x 4096 positions, 16 concurrent
    requests with prompts of 5-2000 tokens."""
    import numpy as np

    from gofr_tpu_torch.ml.generate import Generator
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.ops.decode_attention import (
        gqa_decode_attention_int8_cuda, gqa_decode_attention_int8_plain)

    cfg = llama.llama3_8b(kv_quant=True, w8=True)
    t0 = time.perf_counter()
    params = llama.params_from_config(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    slots, max_seq, max_new, fill = 8, 4096, 32, 2000
    gen = Generator(params, cfg, batch_slots=slots, max_seq=max_seq, chunk=4,
                    prefill_buckets=(128, 512, 2048), device=dev)
    n0 = gqa_decode_attention_int8_cuda.launches
    t0 = time.perf_counter()
    gen.warmup()
    warm_s = time.perf_counter() - t0
    check(gqa_decode_attention_int8_cuda.launches > n0,
          "warmup did not launch the int8 decode kernel")
    r = np.random.default_rng(0)
    prompts = [r.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in r.integers(5, 2001, 16)]

    torch.cuda.reset_peak_memory_stats()
    steps0, waves0 = gen.steps, gen.prefill_waves
    reset_launches()
    with flash_shapes(llama) as shapes:
        outs, wall, again = serve(gen, prompts, max_new, prompts[0])
        torch.cuda.synchronize()
    launches = read_launches()
    steps, waves = gen.steps - steps0, gen.prefill_waves - waves0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    check_served(cfg, prompts, outs, again, max_new)
    check(launches["gqa_decode_attention_int8_cuda"]
          >= cfg.n_layers * steps > 0,
          f"int8 decode launched {launches['gqa_decode_attention_int8_cuda']}"
          f" times for {steps} decode steps")
    check(launches["flash_attention_cuda"] >= cfg.n_layers * waves > 0,
          f"flash launched {launches['flash_attention_cuda']} times for "
          f"{waves} prefill waves")
    check(launches["gqa_decode_attention_cuda"] == 0,
          "the int8 path launched the bf16 decode kernel")

    # one decode step's logits on a prefilled int8 cache, kernel vs plain;
    # and the int8 model's prefill logits beside the bf16 model's
    ids = np.asarray(max(prompts, key=len), np.int32)[None]
    tokens = np.zeros((1, 2048), np.int32)
    tokens[0, :ids.shape[1]] = ids
    lens = np.array([ids.shape[1]], np.int32)
    cfg16 = llama.llama3_8b()
    with torch.no_grad():
        logits, cache = llama.prefill(params, tokens, lens, cfg,
                                      llama.init_cache(cfg, 1, max_seq,
                                                       device=dev))
        ref16, _ = llama.prefill(bf16_params, tokens, lens, cfg16,
                                 llama.init_cache(cfg16, 1, 2048, device=dev))
    dec_err = decode_logit_err(llama, params, cfg,
                               torch.tensor([int(logits.argmax())],
                                            device=dev),
                               cache, gqa_decode_attention_int8_plain)
    del cache
    check(dec_err <= 5e-2,
          f"int8 decode logits kernel vs plain rel err {dec_err} > 5e-2")
    vs_bf16 = (logits - ref16).abs().max().item() / ref16.abs().max().item()

    # timings: one 2048-bucket prefill of one prompt; decode steps of the
    # full 8-slot batch at len 2000: int8 weights + int8 cache, bf16 weights
    # + int8 cache, all bf16 (measurements only), in turns A B C C B A
    def one_prefill():
        llama.prefill_into(params, tokens, lens, cfg, gen.cache, 0)

    prefill_ms = timed_ms(one_prefill, iters=5, warm=1)
    prefill_prof = device_profile(one_prefill, 3)
    step_tok = torch.zeros(slots, dtype=torch.int32, device=dev)
    cache16 = llama.init_cache(cfg16, slots, max_seq, device=dev)
    arms = {"w8_kv8": (params, cfg, gen.cache),
            "bf16_kv8": (bf16_params, llama.llama3_8b(kv_quant=True),
                         gen.cache),
            "bf16": (bf16_params, cfg16, cache16)}

    def stepper(name):
        p, c, cache = arms[name]

        def one_step():
            cache["len"].fill_(fill)
            llama.decode_step(p, step_tok, cache, c)
        return one_step

    step_ms = {name: [] for name in arms}
    for name in [*arms, *reversed(arms)]:
        step_ms[name].append(timed_ms(stepper(name), iters=10, warm=2))
    profiles = {name: device_profile(stepper(name), 5)
                for name in ("w8_kv8", "bf16")}
    for prof in profiles.values():
        check_one_decode_launch_per_layer(prof, cfg.n_layers)
    # quantize-on-write alone: one token's K/V of every slot into all 32
    # layers, int8 (quantize + 4 masked scatters a layer) vs bf16 (2)
    g = torch.Generator(device=dev).manual_seed(1)
    k_new, v_new = (torch.randn((slots, cfg.n_kv_heads, cfg.head_dim),
                                generator=g, device=dev).to(torch.bfloat16)
                    for _ in range(2))
    rows = torch.arange(slots, device=dev)
    pos = torch.full((slots,), fill, dtype=torch.long, device=dev)
    fits = torch.ones(slots, dtype=torch.bool, device=dev)

    def writes(c, cache):
        def run():
            for layer in range(c.n_layers):
                llama._write_token_kv(c, cache, layer, k_new, v_new, rows,
                                      pos, fits)
        return run

    write_prof = {"int8": device_profile(writes(cfg, gen.cache), 5),
                  "bf16": device_profile(writes(cfg16, cache16), 5)}
    served = sum(len(o) for o in outs)
    w8 = min(step_ms["w8_kv8"])
    return {
        "launches": launches, "prefill_waves": waves, "decode_steps": steps,
        "flash_calls_by_shape": dict(shapes),
        "init_and_quantize_s": init_s, "warmup_s": warm_s,
        "weight_gb": _nbytes(params) / 1e9,
        "prompt_lens": [len(p) for p in prompts],
        "served_tokens": served, "served_wall_s": wall,
        "served_tok_per_s": served / wall,
        "prefill_ms_b1_s2048": prefill_ms,
        "prefill_profile": prefill_prof,
        "decode_step_ms_b8_len2000": step_ms,
        "decode_tok_per_s_b8": slots / (w8 / 1e3),
        "peak_mem_gib": peak_gb,
        "decode_logit_rel_err": dec_err,
        "prefill_logit_rel_err_vs_bf16_model": vs_bf16,
        "prefill_argmax_equal_bf16_model":
            int(logits.argmax()) == int(ref16.argmax()),
        "decode_step_profile": profiles,
        "quantize_on_write_profile_32_layers": write_prof,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import gofr_tpu_torch
    from gofr_tpu_torch.ops import _build

    dev = gofr_tpu_torch.resolve_device()
    card = card_line()
    # f32 checks run in full f32 (the kernels under test are bf16)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    build_s = _build.build()
    print(f"kernels built from {_build.CSRC.relative_to(_build.CSRC.parents[2])}"
          f" in {build_s:.1f} s")
    rows = kernel_phase(dev)
    for row in rows:
        for r in row.get("by_shape", [row]):
            lib = r["library_ms"] if r["library_ms"] is not None else \
                r["yardstick_ms"]
            print(f"{row['name']} [{r.get('case', r['shape'])}]: max_abs_err "
                  f"{r['max_abs_err']:.3g} kernel {r['ms']:.4f} ms plain "
                  f"{r['plain_ms']:.4f} ms library/yardstick {lib:.4f} ms "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) = "
                  f"{100 * r['bound_share']:.1f} % of the bound, "
                  f"{r['tb_per_s']:.3f} TB/s")
    path, bf16_params = main_path(dev)
    print("main path (bf16): " + json.dumps(path))
    qpath = int8_path(dev, bf16_params)
    print("main path (int8 cache + int8 weights): " + json.dumps(qpath))
    for row in rows:
        by_path = {"bf16": path["launches"][row["name"]],
                   "int8": qpath["launches"][row["name"]]}
        own = "int8" if row["name"] == "gqa_decode_attention_int8_cuda" \
            else "bf16"
        row["launches"] = by_path[own]
        row["launches_by_path"] = by_path
        row["kernel_ms"] = row["ms"]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
