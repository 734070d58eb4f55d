"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100 for sm_90a).

    python3 chip_smoke.py [--out DIR]   # DIR/chip_smoke.json: every result

Phases, each of which fails the run (non-zero exit) when it goes wrong:

1. device and build: print the card's name and power limit, build every
   CUDA kernel of the serving path from ``gofr_tpu_torch/ops/csrc`` (one
   ``nvcc`` per source, all started together);
2. kernels against their plain PyTorch versions on the card, at the shapes
   the Llama-3-8B serving paths give them: flash prefill for a wave of 2
   prompts in the 512 bucket, one 2048-token prompt, a burst of 8
   prompts into the 2048 bucket and the paged path's suffix (512 queries
   at q_offset 1536 over 2048 keys); GQA decode over the bf16 cache and over
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
   cache and fully in bf16, and the cost of quantize-on-write;
5. the paged path (``PAGED``: 8 slots x 2048 from a pool of 513 pages of
   16, half the dense equivalent; buckets 128/512/2048, 512-token prefill
   segments, chunk 4) behind ``LLMServer`` with its prefix cache: bf16
   (16 requests on a 1536-token prefix pinned through the server, two
   unshared 1900-token prompts prefilled in segments while they decode),
   int8 pages on the w8 + kv8 weights and int4 pages on the bf16 weights
   (8 requests each, the prefix promoted by the cache), launch counts read
   around each arm. Checks: every request finished with its tokens,
   prefix hits and tokens saved, segments run, flash launched with
   ``q_offset`` > 0 for every such call, only the decode kernel the pages
   need; prefix-hit and chunked logits against one whole-prompt prefill;
   one paged decode step over real K/V (8 rows of 1500-2000 tokens,
   pages in a random order) through the kernel against the pool read
   apart by a plain reference, at each page precision; one decode kernel
   a layer, of the right kind, in a paged step's profile. Measured: TTFT cold and on a prefix hit, the longest decode
   gap while a 1900-token prompt prefills (in segments and whole), the
   paged step at 8 x len 2000 beside the dense one with the gather's
   device time, peak memory and pages in use at the end;
6. decode dispatches as CUDA graphs: a dense and a paged (bf16, int8 and
   int4 pages) dispatch of 8 steps at 8 x len 2000 (random K/V from seed
   0), from the same state once by graph replay and once eagerly through
   the same kernels: identical tokens (checked) and the first step's
   logits' largest difference; the graphed step's wall, device time and
   busy share;
7. fused windows and the pipeline: phase 5's paged bf16 serving arm with
   windows off, ``GOFR_ML_DECODE_WINDOW=auto``, ``GOFR_ML_PIPELINE=1``
   and both: served tok/s, the decode step in steady state (8 streams)
   under the profiler, ``window_stats``/``pipeline_stats``, the graphs
   (count, capture seconds, pool memory); with windows off and auto the
   longest decode gap and TTFT while a 1900-token prompt prefills, in
   segments and whole; the frozen tail of a window; the window arm's
   first-step logits held against the window-off arm's at 5 % of range
   (checked) and the share of identical streams;
8. the host KV tier at bf16 and int8 pages: a pinned 1536-token prefix
   spilled and restored, the same suffix served on it before and after
   (identical tokens and pages conserved, checked), the spill and
   restore ms and GB/s, TTFT of a restore hit against a resident hit and
   a cold prompt;
9. the front: the port's ``examples/llama_server`` app (``mount`` on
   phase 3's weights) served through real sockets, HTTP, WS and gRPC
   (``aiohttp`` and ``grpc.aio`` clients), in three arms with the
   example's knobs, 8 slots and chunk 4: dense (``max_seq`` 1024; 24
   gRPC streams, 4 ``POST /generate`` and 4 ``WS /stream`` at once,
   prompts of 64-512 ids, 64 new tokens each), paged (``LLM_PAGE_SIZE``
   16, ``LLM_PAGES`` 257, ``LLM_PREFILL_CHUNK`` 512; the same mix with
   prompts of 64-900 ids, half of them sharing their first 512) and shed
   (the dense arm with ``GOFR_ML_MAX_QUEUE=4``: a burst of 32 gRPC
   streams and 4 posts in equal thirds of high, normal and low
   priority). Checks: every admitted request returns 64 tokens; no 500,
   no INTERNAL; three prompts sent alone give the same tokens over gRPC
   (frames joined), ``/generate``, WS and ``LLMServer.generate`` in
   process (dense); flash and the bf16 decode kernel launch in every arm
   and the int8 one never, flash with ``q_offset`` > 0 and a prefix hit
   in the paged arm; ``/metrics``: ``app_llm_tokens_total`` equals the
   tokens every caller received, the TTFT count the admitted requests,
   ``app_llm_shed_total`` the shed calls (> 0 in the shed arm), each of
   which carries a retry-after; health 200 while serving and 503 once
   the server is closed; shutdown with 4 streams in flight lets them
   finish inside ``GOFR_ML_DRAIN_S``. Measured: served tok/s through the
   front against the same prompts through ``LLMServer`` in process,
   TTFT (first gRPC frame) and the gap between frames (p50, p99), the
   decode graphs and peak memory;
10. resilience and observability, through the same example app on phase
   3's weights (8 slots, chunk 4, the recorders on by default):
   (1) a scripted crash: 8 gRPC streams in flight and 8 queued, a
   ``step`` hook raises once; exactly the 8 in flight get UNAVAILABLE,
   the 8 queued finish with the tokens their prompts gave alone, health
   reads ``degraded``, ``/debug/crash/<id>`` holds the victims' rids and
   journeys, the graph count is unchanged; measured: the time from the
   raise to the end of ``Generator.recover`` (its synchronised 1-step
   replay of the mini graph); (5) under load: the ``stalls`` phases of
   ``/debug/serving`` sum to the wall within 1 %, the recorder's idle
   share beside a ``/debug/profile?seconds=2`` capture's busy share (its
   trace names the flash and decode kernels), a ``step`` sleep hook
   triggers exactly one auto-capture in the cooldown, ``/debug/programs``
   lists as many decode graphs as ``graph_stats()``; (6) the recorders'
   cost: served tok/s with the defaults against an app with
   ``GOFR_ML_FLIGHT_RECORDER=0 GOFR_ML_JOURNEY=0 GOFR_ML_GOODPUT=0
   GOFR_ML_AUTOPROF=0``, 16 requests × 64 tokens, alternating, 3 each;
   (2) chaos: ``GOFR_ML_FAULT=step:0.02,prefill:0.05,emit:0.01``, seed
   1234, 64 requests over gRPC, HTTP and WS: every call ends with 64
   tokens or a typed error, ``restarts`` equals the faults injected, the
   goodput ledger balances against the generator's computed tokens and
   ``app_llm_tokens_wasted_total{reason="crashed"}`` equals it; (3) int8
   pages with windows (K = 4), the pipeline and a host tier: a crash with
   two windows in flight, a spilled prefix restored after it with the
   resident hit's tokens, a ``restore`` fault charged
   ``restore_fallback`` and served by a cold prefix prefill with the same
   tokens, pages conserved, the int8 decode kernel only; (4) a sticky
   device error in a child process (the tiny model; an out-of-range write
   on the card inside a dispatch): the child's server goes ``dead`` with
   at most one restart attempt, health 503, every caller a typed error,
   the child done within ``STICKY_LIMIT_S``.

Measurements under ``torch.profiler`` hold the flight recorder's
``PROFILE_LOCK``, so an auto-profiler capture never overlaps one.
The line before the last is the card; the last is the JSON verdict.
Without a CUDA device, or without the package beside it, the script exits
non-zero and prints no verdict.
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

    # one profiler a process: wait for an auto-profiler capture to end
    with profile_lock(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for layer in range(n_layers):
                launch(layer)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / (reps * n_layers)


@contextlib.contextmanager
def profile_lock():
    """The process-wide profiler lock of the port's flight recorder, held
    for a measurement so an auto-profiler capture never overlaps it (the
    auto-profiler skips and counts a trigger while it is held)."""
    from gofr_tpu_torch.flight_recorder import PROFILE_LOCK

    with PROFILE_LOCK:
        yield


def device_profile(fn, n: int) -> dict:
    """``n`` calls of ``fn`` under torch.profiler: host wall per call, the
    device's kernel time per call, their ratio (the busy share; the rest of
    the wall the card sat idle waiting for the host) and the kernels that
    took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile_lock(), profile(activities=[ProfilerActivity.CPU,
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
    # torch's gather kernels: in a paged step, the index_select of each
    # row's pages into its virtual sequence (and the token embedding's
    # few-row lookup, a few microseconds)
    gather_us = sum(e.self_device_time_total for e in kernels
                    if "gather_kernel" in e.key or "indexSelect" in e.key)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": wall * 1e3 / n, "device_ms": busy_us / 1e3 / n,
            "busy_share": busy_us / 1e6 / wall,
            # the flash kernel's device time and its share of the device's
            "flash_device_ms": flash_us / 1e3 / n,
            "flash_share": flash_us / busy_us if busy_us else 0.0,
            "gather_device_ms": gather_us / 1e3 / n,
            "top_device_ms": {e.key[:80]: e.self_device_time_total / 1e3 / n
                              for e in top},
            # launches per call of every attention kernel of the port
            "attention_launches": {e.key[:80]: e.count / n for e in kernels
                                   if "decode" in e.key or "flash" in e.key}}


@contextlib.contextmanager
def flash_shapes(llama):
    """Tally the model's flash calls by shape inside the block, as
    {"B x Tq x Tk": calls}, with "+offset" on calls whose ``q_offset`` is
    above 0 (a suffix or a later segment). It wraps the dispatcher the
    model calls; the kernel wrapper's own counter stays the proof that the
    kernel ran."""
    seen = collections.Counter()
    inner = llama.flash_attention

    def tally(q, k, v, **kw):
        tag = "+offset" if kw.get("q_offset", 0) > 0 else ""
        seen[f"{q.shape[0]}x{q.shape[1]}x{k.shape[1]}{tag}"] += 1
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
    for label, B, T, Tk, q_offset, lens, L in (
            # a wave of 2 prompts in the 512 bucket (the bf16 path)
            ("512 wave of 2", 2, 512, 512, 0, [512, 301], 32),
            # one long prompt: the int8 path's timed 2048-bucket prefill
            ("2048 trickle", 1, 2048, 2048, 0, [2000], 8),
            # a burst of 8 admissions into the 2048 bucket (generate.py's
            # waves of min(8, slots) rows)
            ("2048 burst of 8", 8, 2048, 2048, 0,
             [2000, 1942, 1500, 1024, 777, 513, 129, 37], 8),
            # the paged path's suffix prefill: a 512-bucket suffix after a
            # 1536-token shared prefix, over the 128 gathered pages
            ("suffix 512 at 1536", 1, 512, 2048, 1536, None, 16)):
        yield {"label": label, "B": B, "T": T, "Tk": Tk, "q_offset": q_offset,
               "H": H, "KV": KV, "D": D, "L": L,
               "kv_len": (None if lens is None else
                          torch.tensor(lens, dtype=torch.int32, device=dev)),
               "q": [rnd_bf16(g, dev, B, T, H, D) for _ in range(L)],
               "k": [rnd_bf16(g, dev, B, Tk, KV, D) for _ in range(L)],
               "v": [rnd_bf16(g, dev, B, Tk, KV, D) for _ in range(L)]}


def flash_bound(c) -> tuple[float, str, float]:
    """(bound ms, bound_by, bytes) of one causal flash call of case ``c``:
    4 * D FLOPs per (query, key) pair the causal (from ``q_offset``) and
    kv_len masks keep (padded query rows included: the kernel keeps their
    outputs); q and o once, the live K/V prefix once, kv_len."""
    B, T, H, KV, D = c["B"], c["T"], c["H"], c["KV"], c["D"]
    Tk, off = c.get("Tk", T), c.get("q_offset", 0)
    lens = c["kv_len"].tolist() if c["kv_len"] is not None else [Tk] * B
    pairs = sum(min(off + i + 1, n) for n in lens for i in range(T))
    nbytes = (2 * (2 * B * T * H * D + 2 * sum(lens) * KV * D)
              + (4 * B if c["kv_len"] is not None else 0))
    return (*bound(4 * D * H * pairs, nbytes), nbytes)


def flash_launchers(c):
    """(kernel(layer), plain(layer), library(layer)) for one flash case;
    the library call is scaled_dot_product_attention with the same causal
    and kv_len mask as a boolean mask, a yardstick the port never calls."""
    import torch.nn.functional as F

    from gofr_tpu_torch.ops.flash_attention import (flash_attention_cuda,
                                                    flash_attention_plain)

    qs, ks, vs, kv_len, off = c["q"], c["k"], c["v"], c["kv_len"], \
        c["q_offset"]
    qpos = torch.arange(c["T"], device=qs[0].device) + off
    kpos = torch.arange(c["Tk"], device=qs[0].device)
    mask = (kpos[None, :] <= qpos[:, None])[None, None]
    if kv_len is not None:
        mask = mask & (kpos[None, None, :] < kv_len[:, None, None])[:, None]

    def kernel(i):
        return flash_attention_cuda(qs[i], ks[i], vs[i], kv_len, causal=True,
                                    q_offset=off)

    def plain(i):
        return flash_attention_plain(qs[i], ks[i], vs[i], kv_len, causal=True,
                                     q_offset=off)

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
    B, T, Tk, H, KV, D = c["B"], c["T"], c["Tk"], c["H"], c["KV"], c["D"]
    lens = c["kv_len"].tolist() if c["kv_len"] is not None else None
    return {"case": c["label"],
            "shape": f"q[{B},{T},{H},{D}] kv[{B},{Tk},{KV},{D}] causal "
                     f"q_offset={c['q_offset']} kv_len={lens}",
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
        "init_s": init_s, "warmup_s": warm_s, "graphs": gen.graph_stats(),
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


def int8_path(dev, bf16_params) -> tuple[dict, dict]:
    """Llama-3-8B with the int8 cache and int8 weights at full width and
    depth behind LLMServer: 8 slots x 4096 positions, 16 concurrent
    requests with prompts of 5-2000 tokens. Returns (results, the w8
    weights)."""
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
        "graphs": gen.graph_stats(),
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
    }, params


# the paged configuration: half the dense-equivalent pool (1 + 8 x 128 pages)
PAGED = dict(batch_slots=8, max_seq=2048, page_size=16, n_pages=513,
             prefill_buckets=(128, 512, 2048), prefill_chunk=512, chunk=4)
SHARED_LEN = 1536


def paged_prompts(vocab: int, n_shared: int, n_long: int, seed: int):
    """(shared prefix, [prefix + suffix of 16-200 tokens], [unshared
    1900-token prompts]) from ``seed``."""
    import numpy as np

    r = np.random.default_rng(seed)
    prefix = r.integers(0, vocab, SHARED_LEN).tolist()
    shared = [prefix + r.integers(0, vocab, int(n)).tolist()
              for n in r.integers(16, 201, n_shared)]
    longs = [r.integers(0, vocab, 1900).tolist() for _ in range(n_long)]
    return prefix, shared, longs


def serve_paged(gen, prefix, shared, longs, max_new: int, pin: bool):
    """Every shared-prefix prompt through ``LLMServer`` at once (half
    ``generate``, half ``stream_chunks``), and the long prompts as soon as
    the first stream has its first token, so they prefill in segments
    while the others decode. ``pin`` registers the prefix through the
    server first; without it the prefix cache promotes it on its second
    sighting. Returns (outputs in order, wall seconds, the cache's
    snapshot, finish reasons)."""
    from gofr_tpu_torch.ml.llm import LLMServer

    async def run():
        server = LLMServer(gen, name="chat")
        started = asyncio.Event()
        reasons = []

        async def one(ids, chunks):
            info, out = {}, []
            if chunks:
                async for burst in server.stream_chunks(ids, max_new,
                                                        info=info):
                    started.set()
                    out.extend(burst)
            else:
                out = await server.generate(ids, max_new, info=info)
                started.set()
            reasons.append(info.get("finish_reason"))
            return out

        async def late(ids):
            await started.wait()
            return await one(ids, True)

        try:
            if pin:
                await asyncio.to_thread(server.register_prefix, prefix)
            t = time.perf_counter()
            outs = await asyncio.gather(
                *(one(p, i % 2 == 0) for i, p in enumerate(shared)),
                *(late(p) for p in longs))
            wall = time.perf_counter() - t
            return outs, wall, server.prefix_cache.snapshot(), reasons
        finally:
            server.close()

    return asyncio.run(run())


def decode_kinds(int8: bool) -> tuple[str, str]:
    """(the decode kernel a page precision needs, the one it must not
    launch): int8 pages take the int8 kernel; bf16 and int4 pages (the
    latter dequantized) the bf16 one."""
    names = ("gqa_decode_attention_cuda", "gqa_decode_attention_int8_cuda")
    return names[::-1] if int8 else names


def paged_attention_reference(cfg, q, cache, layer: int, virt, kv_len):
    """``llama._paged_attention`` written apart from it, as the reference
    of the paged step's check: each row's pages (``virt`` [B * n], row by
    row in table order) indexed out of the pool, each page dequantized
    with its own [KV, ps] planes, and attended by the plain grouped
    attention. It shares no gather, transpose or kernel with the path."""
    from gofr_tpu_torch.ops import (dequantize_kv, dequantize_kv4,
                                    gqa_decode_attention)

    b, kv = q.shape[0], cfg.n_kv_heads
    idx = virt.view(b, -1).long()

    def rows(name):
        pages = cache[name][layer][idx]  # [B, n, ps, ...]
        if cfg.kv_quant:
            pages = pages.view(*pages.shape[:3], kv, -1)
            planes = {pl: cache[f"{name}_{pl}"][layer][idx].permute(0, 1, 3, 2)
                      for pl in ("scale", "zero") if f"{name}_{pl}" in cache}
            pages = (dequantize_kv4(pages, planes["scale"], planes["zero"],
                                    cfg.dtype) if cfg.kv_bits == 4 else
                     dequantize_kv(pages, planes["scale"], cfg.dtype))
        return pages.flatten(1, 2)  # [B, n * ps, KV, D]

    return gqa_decode_attention(q, rows("k"), rows("v"), kv_len)


def paged_step(llama, params, cfg, dev, what: str, fill: int = 2000) -> dict:
    """The paged decode step at 8 rows over a dense-equivalent pool (1 + 8
    x 128 pages of 16, each row 128 pages in a seeded random order, all 128
    table columns gathered). Each row is filled with real K/V by
    ``paged_prefill_into`` of a seeded prompt of 1500-2000 tokens; one step
    of the kernel path (the decode kernel the pages need) is held against
    the same step with the attention swapped for
    ``paged_attention_reference``, at 5 % of the logits' range, as the
    dense paths' decode check. Then, with every row at len ``fill``: the
    step's host-wall and device time under the profiler, and the launches
    of each decode kernel a step, one a layer and of the right kind."""
    import numpy as np

    from gofr_tpu_torch.ops.decode_attention import (
        gqa_decode_attention_cuda, gqa_decode_attention_int8_cuda)

    slots, ps, p_max = 8, 16, 128
    r = np.random.default_rng(5)
    table_np = r.permutation(np.arange(1, 1 + slots * p_max,
                                       dtype=np.int32)).reshape(slots, p_max)
    table = torch.as_tensor(table_np, device=dev)
    pool = llama.init_paged_cache(cfg, slots, 1 + slots * p_max, ps,
                                  device=dev)
    lens = [fill] + r.integers(1500, fill, slots - 1).tolist()
    for slot, n in enumerate(lens):
        t = np.zeros((1, p_max * ps), np.int32)
        t[0, :n] = r.integers(0, cfg.vocab_size, n)
        llama.paged_prefill_into(params, t, [n], cfg, pool, table_np[slot],
                                 slot, ps)
    tok = torch.as_tensor(r.integers(0, cfg.vocab_size, slots),
                          dtype=torch.int32, device=dev)
    len0 = pool["len"].clone()

    def checked_step():
        pool["len"] = len0.clone()
        return llama.paged_decode_step(params, tok, pool, table, cfg,
                                       n_cols=p_max)[0]

    got = checked_step()
    kernel = llama._paged_attention
    llama._paged_attention = paged_attention_reference
    try:
        want = checked_step()
    finally:
        llama._paged_attention = kernel
    err = (got - want).abs().max().item() / want.abs().max().item()
    check(err <= 5e-2, f"{what}: paged decode logits, kernel vs the pool "
          f"read apart: rel err {err} > 5e-2")

    def one_step():
        pool["len"].fill_(fill)
        llama.paged_decode_step(params, tok, pool, table, cfg, n_cols=p_max)

    ms = timed_ms(one_step, iters=10, warm=2)
    n0 = (gqa_decode_attention_cuda.launches,
          gqa_decode_attention_int8_cuda.launches)
    prof = device_profile(one_step, 5)
    n_calls = 6  # device_profile's warm call and its 5
    n = {"gqa_decode_attention_cuda":
         (gqa_decode_attention_cuda.launches - n0[0]) / n_calls,
         "gqa_decode_attention_int8_cuda":
         (gqa_decode_attention_int8_cuda.launches - n0[1]) / n_calls}
    check_one_decode_launch_per_layer(prof, cfg.n_layers)
    want_k, other = decode_kinds(cfg.kv_bits == 8)
    check(n[want_k] == cfg.n_layers and n[other] == 0,
          f"{what}: a paged step launched {n}, expected {cfg.n_layers} of "
          f"{want_k} and none of {other}")
    prof["decode_launches_per_step"] = n
    prof["step_ms_events"] = ms
    prof["decode_logit_rel_err"] = err
    prof["decode_argmax_equal"] = bool(
        (got.argmax(-1) == want.argmax(-1)).all())
    del pool
    return prof


def ttft_s(gen, admit) -> float:
    """Host seconds from admission (``admit(callback)`` returns the slot)
    to the first token on an idle generator; the slot is then released."""
    got = []
    t0 = time.perf_counter()
    slot = admit(lambda i, toks: got.append(time.perf_counter()))
    while not got:
        gen.step()
    while gen.slots[slot].live:
        gen.step()
    gen.drain()
    gen.release(slot)
    return got[0] - t0


def longest_gap_ms(gen, cfg, long_prompt, n_live: int = 4) -> dict:
    """``n_live`` streams decode; then a 1900-token prompt is admitted.
    Returns the longest host gap between two token bursts of a live stream,
    from its last burst before the admission to its first burst after the
    long prompt's first token, and how long that first token took."""
    import numpy as np

    stamps, first = [], []  # the bursts of the first live stream
    r = np.random.default_rng(7)
    slots = [gen.add_request(r.integers(0, cfg.vocab_size, 32).tolist(),
                             400, (lambda i, t: stamps.append(
                                 time.perf_counter())) if k == 0 else None)
             for k in range(n_live)]
    for _ in range(4):
        gen.step()
    gen.drain()  # the burst admission would flush anyway: before the clock
    t_admit = time.perf_counter()
    seg0 = gen.prefill_segments_run
    long_slot = gen.add_request(long_prompt, 1,
                                lambda i, t: first.append(time.perf_counter()))
    while not first:
        gen.step()
    t_first = first[0]
    while not stamps or stamps[-1] < t_first:
        gen.step()  # the live stream's first burst after that
    for i in slots:
        gen.slots[i].live = False
    gen.drain()
    for i in (*slots, long_slot):
        if not gen.slots[i].live:
            gen.release(i)
    before = [t for t in stamps if t < t_admit]
    after = [t for t in stamps if t >= t_first]
    window = [t for t in stamps
              if (before[-1] if before else t_admit) <= t <= after[0]]
    gaps = np.diff(window) * 1e3 if len(window) > 1 else np.array([0.0])
    return {"longest_gap_ms": float(gaps.max()),
            "median_gap_ms": float(np.median(gaps)),
            "bursts_during_prefill": len(window) - 1,
            "ttft_long_ms": (t_first - t_admit) * 1e3,
            "segments": gen.prefill_segments_run - seg0}


def paged_arm(llama, params, cfg, dev, *, n_shared: int, n_long: int,
              pin: bool, seed: int, int8: bool,
              keep_outputs: bool = False) -> tuple[dict, object]:
    """Serve one paged arm (``PAGED``) behind LLMServer with the kernels'
    launch counts read around it; check every request finished with its
    tokens, the prefix cache hit, the segments ran, flash ran with
    ``q_offset`` > 0 and only the decode kernel the pages need launched.
    Returns (results, with the served streams under ``outputs`` when
    ``keep_outputs``; the generator)."""
    from gofr_tpu_torch.ml.generate import Generator

    max_new = 32
    gen = Generator(params, cfg, device=dev, **PAGED)
    t0 = time.perf_counter()
    gen.warmup()
    warm_s = time.perf_counter() - t0
    prefix, shared, longs = paged_prompts(cfg.vocab_size, n_shared, n_long,
                                          seed)
    torch.cuda.reset_peak_memory_stats()
    steps0, seg0 = gen.steps, gen.prefill_segments_run
    reset_launches()
    with flash_shapes(llama) as shapes:
        outs, wall, snap, reasons = serve_paged(gen, prefix, shared, longs,
                                                max_new, pin)
        torch.cuda.synchronize()
    launches = read_launches()
    steps, segments = gen.steps - steps0, gen.prefill_segments_run - seg0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    stats = gen.pool_stats()
    what = f"paged {cfg.kv_bits}-bit arm"
    check(len(outs) == n_shared + n_long
          and all(len(o) == max_new and all(0 <= t < cfg.vocab_size
                                            for t in o) for o in outs)
          and all(r == "length" for r in reasons),
          f"{what}: not every request finished with {max_new} tokens "
          f"({[len(o) for o in outs]}, {reasons})")
    check(snap["hits"] > 0 and snap["prefill_tokens_saved"] > 0,
          f"{what}: no prefix hit ({snap})")
    offset_calls = sum(n for k, n in shapes.items() if k.endswith("+offset"))
    check(offset_calls > 0, f"{what}: no flash call with q_offset > 0")
    check(launches["flash_attention_cuda"] == sum(shapes.values()),
          f"{what}: {sum(shapes.values())} flash calls but "
          f"{launches['flash_attention_cuda']} kernel launches")
    want, other = decode_kinds(int8)
    check(launches[want] >= cfg.n_layers * steps > 0 and launches[other] == 0,
          f"{what}: decode launches {launches} for {steps} steps")
    if n_long:
        check(segments >= 6, f"{what}: {segments} prefill segments ran")
    served = sum(len(o) for o in outs)
    extra = {"outputs": outs} if keep_outputs else {}
    return {**extra, "launches": launches, "decode_steps": steps,
            "graphs": gen.graph_stats(),
            "prefill_segments_run": segments,
            "flash_calls_by_shape": dict(shapes),
            "flash_offset_calls": offset_calls, "warmup_s": warm_s,
            "served_tokens": served, "served_wall_s": wall,
            "served_tok_per_s": served / wall,
            "prefix_cache": {k: snap[k] for k in ("hits", "misses",
                                                 "evictions",
                                                 "prefill_tokens_saved")},
            "peak_mem_gib": peak_gb,
            "pages_in_use_at_end": stats["n_pages"] - 1 - stats["free_pages"],
            "pool": stats}, gen


def paged_path(dev, bf16_params, w8_params) -> dict:
    """Llama-3-8B at full width from a shared page pool (``PAGED``): the
    bf16 arm (16 requests on a 1536-token prefix pinned through the
    server, and two unshared 1900-token prompts that prefill in segments
    while they decode), then the int8-page arm on the w8 + kv8 weights and
    the int4-page arm on the bf16 weights (8 requests each, the prefix
    promoted by the cache). Then the logit checks (prefix hit against the
    whole prompt, segments against one prefill), TTFT cold and on a prefix
    hit, the longest decode gap while a long prompt prefills (chunked and
    not), and the paged decode step beside the dense one."""
    import numpy as np

    from gofr_tpu_torch.ml.generate import Generator
    from gofr_tpu_torch.models import llama

    cfg = llama.llama3_8b()
    out = {}
    out["bf16"], gen = paged_arm(llama, bf16_params, cfg, dev, n_shared=16,
                                 n_long=2, pin=True, seed=1, int8=False)
    prefix, _, longs = paged_prompts(cfg.vocab_size, 16, 2, 1)

    # prefix-hit first-token logits against the whole prompt's prefill;
    # TTFT cold (segments) and on the pinned prefix, turns C H H C
    r = np.random.default_rng(3)
    suffix = r.integers(0, cfg.vocab_size, 64).tolist()
    pid = next(p for p, i in gen._prefixes.items() if i["pinned"])
    pages = gen._prefixes[pid]["pages"]
    check(len(pages) * 16 == SHARED_LEN, "the pinned prefix holds 96 pages")
    row = np.zeros((gen._p_max,), np.int32)
    row[:len(pages)] = pages
    row[len(pages):len(pages) + 4] = gen._free_pages[-4:]
    toks = np.zeros((1, 128), np.int32)
    toks[0, :64] = suffix
    with torch.no_grad():
        hit, _ = llama.paged_suffix_prefill(bf16_params, toks, [64], cfg,
                                            gen.cache, row, SHARED_LEN, 16)
        full = np.zeros((1, 2048), np.int32)
        full[0, :SHARED_LEN + 64] = prefix + suffix
        whole, _ = llama.prefill(bf16_params, full, [SHARED_LEN + 64], cfg,
                                 llama.init_cache(cfg, 1, 2048, device=dev))
    hit_err = (hit - whole).abs().max().item() / whole.abs().max().item()
    check(hit_err <= 5e-2, f"prefix-hit logits vs the whole prompt: rel err "
          f"{hit_err} > 5e-2")
    ttft = {"cold": [], "prefix_hit": []}
    for kind in ("cold", "prefix_hit", "prefix_hit", "cold"):
        if kind == "cold":
            ttft[kind].append(ttft_s(gen, lambda cb: gen.add_request(
                prefix + suffix, 1, cb)))
        else:
            ttft[kind].append(ttft_s(gen, lambda cb: gen.add_request(
                suffix, 1, cb, prefix=pid)))

    # chunked (512-token segments through the suffix prefill) against one
    # prefill of the whole 1900-token prompt, last-token logits
    pool = llama.init_paged_cache(cfg, 1, 1 + 2 * 128, 16, device=dev)
    row_a = np.arange(1, 129, dtype=np.int32)
    row_b = np.arange(129, 257, dtype=np.int32)
    ids = longs[0]
    with torch.no_grad():
        for start in range(0, 1900, 512):
            seg = ids[start:start + 512]
            t = np.zeros((1, 512), np.int32)
            t[0, :len(seg)] = seg
            chunked, _ = llama.paged_suffix_prefill(
                bf16_params, t, [len(seg)], cfg, pool, row_a, start, 16)
        t = np.zeros((1, 2048), np.int32)
        t[0, :1900] = ids
        unchunked, _ = llama.paged_prefill_into(bf16_params, t, [1900], cfg,
                                                pool, row_b, 0, 16)
    del pool
    seg_diff = (chunked - unchunked).abs().max().item()
    seg_err = seg_diff / unchunked.abs().max().item()
    check(seg_err <= 5e-2, f"chunked vs unchunked logits: rel err {seg_err}")
    seg_argmax_equal = int(chunked.argmax()) == int(unchunked.argmax())

    # the longest decode gap while a 1900-token prompt prefills, with
    # 512-token segments and whole (prefill_chunk 0)
    gaps = {"prefill_chunk_512": longest_gap_ms(gen, cfg, longs[1])}
    gen0 = Generator(bf16_params, cfg, device=dev,
                     **{**PAGED, "prefill_chunk": 0})
    gen0.warmup()
    gaps["prefill_chunk_0"] = longest_gap_ms(gen0, cfg, longs[1])
    del gen0
    out["bf16"].update(
        prefix_hit_logit_rel_err=hit_err, chunked_logit_rel_err=seg_err,
        chunked_logit_max_abs_diff=seg_diff,
        chunked_argmax_equal=seg_argmax_equal,
        prefix_hit_argmax_equal=int(hit.argmax()) == int(whole.argmax()),
        ttft_ms={k: [x * 1e3 for x in v] for k, v in ttft.items()},
        decode_gap_while_long_prefill=gaps)
    del gen

    # the paged decode step at 8 slots x len 2000 beside the dense one
    paged_prof = paged_step(llama, bf16_params, cfg, dev, "paged bf16 step")
    dense = llama.init_cache(cfg, 8, 2048, device=dev)
    tok = torch.zeros(8, dtype=torch.int32, device=dev)

    def dense_step():
        dense["len"].fill_(2000)
        llama.decode_step(bf16_params, tok, dense, cfg)

    dense_ms = timed_ms(dense_step, iters=10, warm=2)
    dense_prof = device_profile(dense_step, 5)
    del dense
    out["bf16"]["step_8x2000"] = {"paged": paged_prof, "dense": dense_prof,
                                  "dense_step_ms_events": dense_ms}

    # the int8-page arm (w8 + kv8 weights) and the int4-page arm (bf16)
    cfg8 = llama.llama3_8b(kv_quant=True, w8=True)
    out["int8"], gen = paged_arm(llama, w8_params, cfg8, dev, n_shared=8,
                                 n_long=0, pin=False, seed=2, int8=True)
    del gen
    out["int8"]["step_8x2000"] = paged_step(llama, w8_params, cfg8, dev,
                                            "paged int8 step")
    cfg4 = llama.llama3_8b(kv_bits=4)
    out["int4"], gen = paged_arm(llama, bf16_params, cfg4, dev, n_shared=8,
                                 n_long=0, pin=False, seed=2, int8=False)
    del gen
    out["int4"]["step_8x2000"] = paged_step(llama, bf16_params, cfg4, dev,
                                            "paged int4 step")
    return out


# -- decode dispatches as CUDA graphs, fused windows, the pipeline ----------------

def _fill_pool(cache, g) -> None:
    """Seeded random K/V in every cache array but ``len``: bf16 values
    N(0, 1); int8 and packed int4 codes uniform; scales and zero points
    small and positive, as quantized K/V of O(1) values have them."""
    for name, t in cache.items():
        if name == "len":
            continue
        if t.dtype == torch.int8:
            t.random_(-127, 128, generator=g)
        elif t.dtype == torch.uint8:
            t.random_(0, 256, generator=g)
        elif name.endswith("_scale"):
            t.uniform_(0.005, 0.02, generator=g)
        elif name.endswith("_zero"):
            t.uniform_(-0.15, -0.05, generator=g)
        else:
            t.normal_(generator=g)


def graph_vs_eager(dev, what: str, params, cfg, paged: bool,
                   fill: int = 2000, steps: int = 8) -> dict:
    """One decode dispatch of ``steps`` steps at 8 rows x len ``fill``
    (random K/V from seed 0, the page table a seeded permutation), from
    the same state once by the generator's CUDA graph and once eagerly
    through the same kernels: the tokens must be identical; the first
    step's logits' largest difference is printed (0 expected). Then the
    graphed dispatch's host wall, device time and busy share under the
    profiler and by CUDA events."""
    import numpy as np

    from gofr_tpu_torch.ml.generate import Generator

    opts = dict(batch_slots=8, max_seq=2048, chunk=steps, token_budget=0,
                prefill_buckets=(128,))
    if paged:
        opts["page_size"] = 16
    gen = Generator(params, cfg, device=dev, **opts)
    g = torch.Generator(device=dev).manual_seed(0)
    _fill_pool(gen.cache, g)
    n_cols = None
    if paged:
        r = np.random.default_rng(0)
        pages = r.permutation(np.arange(1, gen.n_pages, dtype=np.int32))
        need = -(-(fill + steps) // 16)
        for slot in range(8):
            gen._slot_pages[slot] = pages[slot * need:(slot + 1) * need
                                          ].tolist()
            gen._table[slot, :need] = gen._slot_pages[slot]
        gen._table_dirty = True
        n_cols = min(gen._p_max, 1 << (need - 1).bit_length())
    gen.cache["len"].fill_(fill)
    gen._tok_dev.copy_(torch.randint(0, cfg.vocab_size, (8,), generator=g,
                                     device=dev, dtype=torch.int32))
    state = {k: v.clone() for k, v in gen.cache.items()}
    tok0 = gen._tok_dev.clone()
    t0 = time.perf_counter()
    block = gen._decode_chunk(steps, n_cols).clone()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0  # capture + one replay
    logits = gen.dispatch_logits.clone()
    for k, v in state.items():
        gen.cache[k].copy_(v)
    gen._tok_dev.copy_(tok0)
    with torch.no_grad():
        eager, eager_logits = gen._chunk_body(steps, n_cols)
    torch.cuda.synchronize()
    same = bool(torch.equal(block, eager))
    diff = (logits - eager_logits).abs().max().item()
    check(same, f"{what}: graph replay and eager dispatch sampled different "
          f"tokens")

    def replay():
        gen.cache["len"].fill_(fill)
        gen._decode_chunk(steps, n_cols)

    ev_ms = timed_ms(replay, iters=10, warm=2)
    prof = device_profile(replay, 5)
    del state, gen
    torch.cuda.empty_cache()
    return {"tokens_identical": same, "logits_max_abs_diff": diff,
            "steps": steps, "n_cols": n_cols,
            "capture_and_first_replay_s": first_s,
            "dispatch_ms_events": ev_ms,
            "step_ms_events": ev_ms / steps,
            "step_wall_ms": prof["wall_ms"] / steps,
            "step_device_ms": prof["device_ms"] / steps,
            "busy_share": prof["busy_share"],
            "top_device_ms": prof["top_device_ms"]}


def graph_phase(dev, bf16_params, w8_params) -> dict:
    """Graph against eager for the dense and the paged (bf16, int8 and
    int4 pages) decode dispatch of 8 steps at 8 x 2000."""
    from gofr_tpu_torch.models import llama

    arms = {"dense_bf16": (bf16_params, llama.llama3_8b(), False),
            "paged_bf16": (bf16_params, llama.llama3_8b(), True),
            "paged_int8": (w8_params, llama.llama3_8b(kv_quant=True, w8=True),
                           True),
            "paged_int4": (bf16_params, llama.llama3_8b(kv_bits=4), True)}
    return {name: graph_vs_eager(dev, f"graph vs eager, {name}", p, c, paged)
            for name, (p, c, paged) in arms.items()}


@contextlib.contextmanager
def knobs(**env):
    """The serving knobs (``GOFR_ML_*``) set inside the block only."""
    import os

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def steady_decode(gen, cfg, n_rows: int = 8, prompt: int = 500,
                  calls: int = 4) -> dict:
    """``n_rows`` streams of ``prompt`` tokens decoding; after their first
    tokens, ``calls`` calls of ``gen.step()`` under the profiler: host wall
    and device time per decode step (a call dispatches a chunk or a whole
    window), and the busy share."""
    import numpy as np

    r = np.random.default_rng(11)
    slots = [gen.add_request(r.integers(0, cfg.vocab_size, prompt).tolist(),
                             400) for _ in range(n_rows)]
    while gen._pending_first:
        gen.step()
    gen.step()
    steps0 = gen.steps
    prof = device_profile(gen.step, calls)
    n = (gen.steps - steps0) / (calls + 1)  # device_profile's warm call too
    for i in slots:
        gen.slots[i].live = False
    gen.drain()
    for i in slots:
        gen.release(i)
    return {"steps_per_call": n, "step_wall_ms": prof["wall_ms"] / n,
            "step_device_ms": prof["device_ms"] / n,
            "busy_share": prof["busy_share"],
            "top_device_ms": prof["top_device_ms"]}


def first_step_logits(gen, prompt) -> torch.Tensor:
    """The first decode step's logits of ``prompt`` admitted alone on an
    idle generator (the mini dispatch), as f32 [V]."""
    slot = gen.add_request(prompt, 2)
    gen.step()
    row = gen.dispatch_logits[slot].clone()
    while gen.slots[slot].live:
        gen.step()
    gen.drain()
    gen.release(slot)
    return row


def frozen_tail(gen, n_win: int = 32, fill: int = 1000) -> dict:
    """A K-step window replayed with every row active for K steps and with
    every row frozen after one step (``step_cap`` 1): the graph has no
    branch, so both cost K steps of device time."""
    import numpy as np

    active = np.ones((gen.batch_slots,), bool)
    out = {}
    for name, cap in (("all_active", n_win), ("frozen_after_1", 1)):
        caps = np.full((gen.batch_slots,), cap, np.int32)

        def replay():
            gen.cache["len"].fill_(fill)
            gen._decode_window(n_win, active, caps, n_cols=gen._p_max)

        out[f"{name}_ms"] = timed_ms(replay, iters=3, warm=1)
    out["window"] = n_win
    out["tail_ms"] = out["frozen_after_1_ms"] - out["all_active_ms"] / n_win
    return out


def window_pipeline_phase(dev, bf16_params) -> dict:
    """The paged bf16 serving arm four times: windows off,
    ``GOFR_ML_DECODE_WINDOW=auto``, ``GOFR_ML_PIPELINE=1`` and both.
    Each: served tok/s, the decode step in steady state (8 streams),
    ``window_stats``/``pipeline_stats``, the graphs. With windows off and
    auto: the longest decode gap and the TTFT of a 1900-token prompt
    prefilled in segments and whole. The window arm's first-step logits
    are held against the window-off arm's at 5 % of range; the share of
    identical streams between arms is printed."""
    import numpy as np

    from gofr_tpu_torch.ml.generate import Generator
    from gofr_tpu_torch.models import llama

    cfg = llama.llama3_8b()
    arms = {"off": {}, "window_auto": {"GOFR_ML_DECODE_WINDOW": "auto"},
            "pipeline": {"GOFR_ML_PIPELINE": "1"},
            "window_auto_pipeline": {"GOFR_ML_DECODE_WINDOW": "auto",
                                     "GOFR_ML_PIPELINE": "1"}}
    _, _, longs = paged_prompts(cfg.vocab_size, 16, 2, 1)
    probe = np.random.default_rng(13).integers(0, cfg.vocab_size,
                                               300).tolist()
    out, streams, firsts = {}, {}, {}
    for name, env in arms.items():
        with knobs(**env):
            res, gen = paged_arm(llama, bf16_params, cfg, dev, n_shared=16,
                                 n_long=2, pin=True, seed=1, int8=False,
                                 keep_outputs=True)
            streams[name] = res.pop("outputs")
            res["window_stats"] = gen.window_stats()
            res["pipeline_stats"] = gen.pipeline_stats()
            res["steady_decode"] = steady_decode(gen, cfg)
            if name in ("off", "window_auto"):
                firsts[name] = first_step_logits(gen, probe)
                gaps = {"prefill_chunk_512": longest_gap_ms(gen, cfg,
                                                            longs[1])}
                whole = Generator(bf16_params, cfg, device=dev,
                                  **{**PAGED, "prefill_chunk": 0})
                whole.warmup()
                gaps["prefill_chunk_0"] = longest_gap_ms(whole, cfg,
                                                         longs[1])
                del whole
                res["decode_gap_while_long_prefill"] = gaps
            if name == "window_auto":
                res["frozen_tail"] = frozen_tail(gen)
            out[name] = res
            del gen
            torch.cuda.empty_cache()
    err = ((firsts["window_auto"] - firsts["off"]).abs().max().item()
           / firsts["off"].abs().max().item())
    check(err <= 5e-2, f"window arm's first-step logits vs window off: rel "
          f"err {err} > 5e-2")
    out["window_first_step_logit_rel_err"] = err
    out["identical_stream_share_vs_off"] = {
        name: sum(a == b for a, b in zip(streams[name], streams["off"],
                                         strict=True)) / len(streams["off"])
        for name in arms if name != "off"}
    return out


def host_tier_arm(dev, params, cfg, what: str) -> dict:
    """A 1536-token prefix pinned on a paged generator with a host KV tier
    (2 GiB): the same 64-token suffix served on it resident and after
    three spill→restore cycles (tokens identical, pages conserved), each
    spill and restore timed (host wall to a synchronised card; the first
    spill also allocates the pinned host memory) with its GB/s; then TTFT
    of a restore hit against a resident hit and a cold prompt (two turns
    each)."""
    import numpy as np

    from gofr_tpu_torch.ml.generate import Generator
    from gofr_tpu_torch.ml.kv_offload import HostKVStore, OffloadConfig

    store = HostKVStore(OffloadConfig(budget_mb=2048))
    gen = Generator(params, cfg, device=dev, host_kv=store, **PAGED)
    gen.warmup()
    prefix, _, _ = paged_prompts(cfg.vocab_size, 1, 0, 1)
    suffix = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                               64).tolist()

    def held():
        return (gen.free_pages
                + sum(len(i["pages"]) for i in gen._prefixes.values())
                + sum(len(p) - s for p, s in zip(gen._slot_pages,
                                                 gen._slot_shared)))

    def serve_on(pid):
        slot = gen.add_request(suffix, 16, prefix=pid)
        while gen.slots[slot].live:
            gen.step()
        gen.drain()
        toks = list(gen.slots[slot].tokens)
        gen.release(slot)
        return toks

    def spill(pid):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(gen.drop_prefix(pid, spill=True), f"{what}: the spill was not "
              f"stored")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def restore():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pid = gen.restore_prefix(prefix)
        torch.cuda.synchronize()
        return pid, time.perf_counter() - t0

    reset_launches()
    pid = gen.register_prefix(prefix, pinned=True)
    ref = serve_on(pid)
    conserved = held()
    spill_s, restore_s = [], []
    for _ in range(3):  # the first spill allocates the pinned host memory
        spill_s.append(spill(pid))
        nbytes = store.bytes_used
        check(gen.has_offloaded(prefix) and held() == conserved,
              f"{what}: pages not conserved by the spill")
        pid, dt = restore()
        restore_s.append(dt)
        check(held() == conserved,
              f"{what}: pages not conserved by the restore")
    got = serve_on(pid)
    check(got == ref, f"{what}: tokens after spill and restore differ from "
          f"the never-evicted run ({got} vs {ref})")
    ttft = {"resident_hit": [], "restore_hit": [], "cold": []}
    for kind in ("resident_hit", "restore_hit", "cold", "cold",
                 "restore_hit", "resident_hit"):
        if kind == "resident_hit":
            ttft[kind].append(ttft_s(gen, lambda cb: gen.add_request(
                suffix, 1, cb, prefix=pid)))
        elif kind == "restore_hit":
            spill(pid)
            ttft[kind].append(ttft_s(gen, lambda cb: gen.add_request(
                suffix, 1, cb, prefix=gen.restore_prefix(prefix))))
            pid = max(gen._prefixes)
        else:
            ttft[kind].append(ttft_s(gen, lambda cb: gen.add_request(
                prefix + suffix, 1, cb)))
    launches = read_launches()
    stats = gen.pool_stats()
    check(held() == conserved, f"{what}: pages not conserved at the end")
    del gen
    torch.cuda.empty_cache()
    return {"prefix_tokens": len(prefix), "entry_bytes": nbytes,
            "spill_ms": [x * 1e3 for x in spill_s],
            "restore_ms": [x * 1e3 for x in restore_s],
            "spill_gb_per_s": [nbytes / x / 1e9 for x in spill_s],
            "restore_gb_per_s": [nbytes / x / 1e9 for x in restore_s],
            "tokens_identical": True,
            "ttft_ms": {k: [x * 1e3 for x in v] for k, v in ttft.items()},
            "kv_spills": stats["kv_spills"],
            "kv_restores": stats["kv_restores"],
            "tier": store.stats(), "launches": launches}


def host_tier_phase(dev, bf16_params, w8_params) -> dict:
    """The host KV tier at bf16 pages and at int8 pages (w8 + kv8)."""
    from gofr_tpu_torch.models import llama

    return {"bf16": host_tier_arm(dev, bf16_params, llama.llama3_8b(),
                                  "host tier, bf16 pages"),
            "int8": host_tier_arm(dev, w8_params,
                                  llama.llama3_8b(kv_quant=True, w8=True),
                                  "host tier, int8 pages")}


# -- phase 9: the serving front ---------------------------------------------------

FRONT_MAX_NEW = 64
FRONT_DRAIN_S = 20.0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pct(values, q: float) -> float | None:
    """The ``q`` quantile (nearest rank) of ``values``, None when empty."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


def scrape(text: str) -> dict:
    """{"name{labels}": value} of the ``app_llm_*`` lines of /metrics."""
    out = {}
    for line in text.splitlines():
        if line.startswith("app_llm_"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


class FrontClients:
    """The real clients of phase 9 against one booted app: ``aiohttp`` for
    ``POST /generate`` and ``WS /stream``, ``grpc.aio`` with JSON
    serializers for ``llm.Chat/Generate``. Every call returns a record:
    the tokens, the HTTP status or gRPC code, and for gRPC the first-frame
    time and the gaps between frames (host seconds)."""

    def __init__(self, app) -> None:
        self.app = app
        self.base = f"http://127.0.0.1:{app.http_port}"

    async def __aenter__(self):
        import aiohttp
        import grpc.aio

        self.session = aiohttp.ClientSession()
        self.channel = grpc.aio.insecure_channel(
            f"127.0.0.1:{self.app.grpc_port}")
        self.rpc = self.channel.unary_stream(
            "/llm.Chat/Generate",
            request_serializer=lambda o: json.dumps(o).encode(),
            response_deserializer=json.loads)
        return self

    async def __aexit__(self, *exc) -> None:
        await self.session.close()
        await self.channel.close()

    async def grpc(self, body: dict) -> dict:
        import grpc

        t0 = time.perf_counter()
        rec = {"via": "grpc", "tokens": [], "frames": 0, "gaps": [],
               "ttft_s": None, "status": "OK", "retry_after": None}
        last = None
        call = self.rpc(body, timeout=300)
        try:
            async for frame in call:
                now = time.perf_counter()
                if last is None:
                    rec["ttft_s"] = now - t0
                else:
                    rec["gaps"].append(now - last)
                last = now
                rec["frames"] += 1
                rec["tokens"].extend(frame["tokens"])
        except grpc.aio.AioRpcError as exc:
            rec["status"] = exc.code().name
            rec["details"] = exc.details()
            trailers = dict(tuple(kv) for kv in exc.trailing_metadata() or ())
            rec["retry_after"] = trailers.get("retry-after")
        return rec

    async def http(self, body: dict) -> dict:
        r = await self.session.post(self.base + "/generate", json=body)
        payload = await r.json()
        return {"via": "http", "status": r.status,
                "tokens": payload.get("data", {}).get("tokens", []),
                "retry_after": r.headers.get("Retry-After"),
                "error": payload.get("error")}

    async def ws(self, body: dict) -> dict:
        ws = await self.session.ws_connect(self.base + "/stream")
        await ws.send_json(body)
        toks = []
        while True:
            # a handler error sends no frame: a timeout, not a hang
            frame = await ws.receive_json(timeout=300)
            if "done" in frame:
                break
            toks.append(frame["token"])
        await ws.close()
        return {"via": "ws", "status": 200, "tokens": toks}

    async def get(self, url: str):
        r = await self.session.get(url)
        return r.status, await r.text()

    async def metrics(self) -> dict:
        _, text = await self.get(
            f"http://127.0.0.1:{self.app.metrics_port}/metrics")
        return scrape(text)

    async def health(self) -> int:
        return (await self.get(self.base + "/.well-known/health"))[0]


def front_prompts(vocab: int, n: int, lo: int, hi: int, seed: int,
                  shared: int = 0) -> list[list[int]]:
    """``n`` prompts of ``lo``-``hi`` random ids from ``seed``; with
    ``shared``, every other prompt is 576-900 ids whose first ``shared``
    are the same."""
    import numpy as np

    r = np.random.default_rng(seed)
    head = r.integers(0, vocab, shared).tolist() if shared else []
    out = []
    for i in range(n):
        if shared and i % 2:
            out.append(head + r.integers(
                0, vocab, int(r.integers(576, 901)) - shared).tolist())
        else:
            out.append(r.integers(0, vocab, int(r.integers(lo, hi + 1)))
                       .tolist())
    return out


async def front_mix(clients, prompts, priorities=None,
                    n_http: int = 4, n_ws: int = 4) -> tuple[list, float]:
    """Every prompt at once: the first ``n_http`` as ``POST /generate``,
    the next ``n_ws`` over ``WS /stream``, the rest as gRPC streams.
    Returns (records, wall seconds)."""
    calls = []
    for i, p in enumerate(prompts):
        body = {"prompt_ids": p, "max_new_tokens": FRONT_MAX_NEW}
        if priorities is not None:
            body["priority"] = priorities[i]
        via = (clients.http if i < n_http else
               clients.ws if i < n_http + n_ws else clients.grpc)
        calls.append(via(body))
    t = time.perf_counter()
    recs = await asyncio.gather(*calls)
    return list(recs), time.perf_counter() - t


def check_front_records(what: str, recs: list, vocab: int) -> int:
    """No 500 and no INTERNAL; every admitted request got
    ``FRONT_MAX_NEW`` ids inside the vocabulary, or fewer when a dry page
    pool truncated it (returns how many did; the caller holds that count
    to the generator's evictions); a shed call (429 /
    RESOURCE_EXHAUSTED) carries its retry-after."""
    short = 0
    for r in recs:
        shed = r["status"] in (429, "RESOURCE_EXHAUSTED")
        check(r["status"] in (200, 201, "OK") or shed,
              f"{what}: a {r['via']} call answered {r['status']} ({r})")
        if shed:
            check(r.get("retry_after") is not None and
                  float(r["retry_after"]) >= 1,
                  f"{what}: a shed {r['via']} call has no retry-after")
            continue
        check(len(r["tokens"]) <= FRONT_MAX_NEW
              and all(0 <= t < vocab for t in r["tokens"]),
              f"{what}: a {r['via']} call returned {len(r['tokens'])} ids")
        short += len(r["tokens"]) < FRONT_MAX_NEW
    return short


def front_stats(recs: list, wall: float) -> dict:
    grpc_ok = [r for r in recs if r["via"] == "grpc" and r["status"] == "OK"]
    gaps = [g for r in grpc_ok for g in r["gaps"]]
    ttft = [r["ttft_s"] for r in grpc_ok if r["ttft_s"] is not None]
    tokens = sum(len(r["tokens"]) for r in recs)
    return {"requests": len(recs), "tokens": tokens, "wall_s": wall,
            "tok_per_s": tokens / wall,
            "ttft_ms_p50": 1e3 * pct(ttft, 0.5) if ttft else None,
            "ttft_ms_p99": 1e3 * pct(ttft, 0.99) if ttft else None,
            "frame_gap_ms_p50": 1e3 * pct(gaps, 0.5) if gaps else None,
            "frame_gap_ms_p99": 1e3 * pct(gaps, 0.99) if gaps else None,
            "grpc_frames": sum(r["frames"] for r in grpc_ok)}


async def in_process(llm, prompts) -> tuple[list, float]:
    """The same prompts through ``LLMServer.generate`` at once, in
    process: (outputs, wall seconds)."""
    t = time.perf_counter()
    outs = await asyncio.gather(*(llm.generate(p, FRONT_MAX_NEW)
                                  for p in prompts))
    return list(outs), time.perf_counter() - t


async def drive_front(app, cfg, arm: str) -> dict:
    """One arm's traffic against the booted app (see ``front_phase``)."""
    llm = app.container.ml.llm("chat")
    gen = llm.gen
    vocab = cfg.vocab_size
    out: dict = {}
    admitted = 0  # requests that received a first token (TTFT samples)
    delivered = 0  # tokens every caller received
    evictions0 = gen.evictions
    async with FrontClients(app) as c:
        check(await c.health() == 200, f"front {arm}: health not 200")
        if arm == "dense":
            # three prompts sent alone: every transport and the server in
            # process give the same tokens
            alone = []
            for p in front_prompts(vocab, 3, 64, 512, seed=7):
                body = {"prompt_ids": p, "max_new_tokens": FRONT_MAX_NEW}
                got = [(await c.grpc(body))["tokens"],
                       (await c.http(body))["tokens"],
                       (await c.ws(body))["tokens"],
                       await llm.generate(p, FRONT_MAX_NEW)]
                check(len(got[0]) == FRONT_MAX_NEW
                      and all(g == got[0] for g in got),
                      f"front dense: transports disagree on a prompt of "
                      f"{len(p)} ids: {[g[:8] for g in got]}")
                alone.append(len(p))
                admitted += 4
                delivered += 4 * FRONT_MAX_NEW
            out["alone_prompt_lens"] = alone
        if arm == "shed":
            prompts = front_prompts(vocab, 36, 64, 512, seed=11)
            prios = ["high", "normal", "low"] * 12
            recs, wall = await front_mix(c, prompts, prios, n_http=4,
                                         n_ws=0)
        else:
            prompts = front_prompts(vocab, 32, 64,
                                    900 if arm == "paged" else 512,
                                    seed=0, shared=512 if arm == "paged"
                                    else 0)
            recs, wall = await front_mix(c, prompts)
        short = check_front_records(f"front {arm}", recs, vocab)
        out["front"] = front_stats(recs, wall)
        ok = [r for r in recs if r["status"] in (200, 201, "OK")]
        shed = [r for r in recs if r["status"] in (429, "RESOURCE_EXHAUSTED")]
        admitted += sum(1 for r in ok if r["tokens"])
        delivered += sum(len(r["tokens"]) for r in ok)
        out["shed_calls"] = len(shed)
        if arm == "shed":
            out["shed_by_priority"] = dict(collections.Counter(
                prios[i] for i, r in enumerate(recs)
                if r["status"] in (429, "RESOURCE_EXHAUSTED")))
        if arm == "shed":
            check(shed, "front shed: the burst shed nothing")
        else:
            # the paged arm's repeat uses fresh prompts of the same shape:
            # a prompt seen twice is promoted whole into the prefix cache,
            # and pages its live slots borrow count against what any
            # request can ever get (a 400 at the front, as in JAX)
            outs, wall_ip = await in_process(llm, prompts if arm == "dense"
                                             else front_prompts(
                                                 vocab, 32, 64, 900, seed=1,
                                                 shared=512))
            check(all(len(o) <= FRONT_MAX_NEW for o in outs),
                  f"front {arm}: an in-process request overran max_new")
            short += sum(len(o) < FRONT_MAX_NEW for o in outs)
            tokens = sum(len(o) for o in outs)
            admitted += sum(1 for o in outs if o)
            delivered += tokens
            out["in_process"] = {"tokens": tokens, "wall_s": wall_ip,
                                 "tok_per_s": tokens / wall_ip}
            out["front_over_in_process"] = (out["front"]["tok_per_s"]
                                            / (tokens / wall_ip))
        # a short answer is a stream a dry page pool truncated: each one
        # is an eviction the generator counted, none is lost silently
        out["truncated_by_dry_pool"] = short
        check(short == gen.evictions - evictions0,
              f"front {arm}: {short} short answers but "
              f"{gen.evictions - evictions0} evictions")
        check(arm == "paged" or short == 0,
              f"front {arm}: {short} answers short of {FRONT_MAX_NEW}")
        m = await c.metrics()
        key = '{model="chat"}'
        out["metrics"] = {k: v for k, v in m.items()
                          if k.startswith(("app_llm_tokens_total",
                                           "app_llm_ttft_seconds_count",
                                           "app_llm_shed_total",
                                           "app_llm_prefill_share",
                                           "app_llm_token_budget"))}
        check(m.get(f"app_llm_tokens_total{key}") == delivered,
              f"front {arm}: app_llm_tokens_total "
              f"{m.get(f'app_llm_tokens_total{key}')} != {delivered} "
              f"tokens received")
        check(m.get(f"app_llm_ttft_seconds_count{key}") == admitted,
              f"front {arm}: {m.get(f'app_llm_ttft_seconds_count{key}')} "
              f"TTFT samples for {admitted} admitted requests")
        shed_total = sum(v for k, v in m.items()
                         if k.startswith("app_llm_shed_total{"))
        check(shed_total == len(shed),
              f"front {arm}: app_llm_shed_total {shed_total} != "
              f"{len(shed)} shed calls")
        out["graphs"] = gen.graph_stats()
        if getattr(llm, "prefix_cache", None) is not None:
            snap = llm.prefix_cache.snapshot()
            out["prefix_cache"] = {k: snap[k] for k in (
                "hits", "misses", "prefill_tokens_saved")}
        if arm == "dense":
            # shutdown with 4 streams in flight: they finish inside the
            # gRPC grace, and the drain ends well inside GOFR_ML_DRAIN_S
            tail = [asyncio.create_task(c.grpc(
                {"prompt_ids": p, "max_new_tokens": FRONT_MAX_NEW}))
                for p in prompts[:4]]
            t = time.perf_counter()
            while gen.n_live < 4 and time.perf_counter() - t < 30:
                await asyncio.sleep(0.005)
            t = time.perf_counter()
            await app.shutdown()
            out["shutdown_s"] = time.perf_counter() - t
            done = await asyncio.gather(*tail)
            check(all(r["status"] == "OK"
                      and len(r["tokens"]) == FRONT_MAX_NEW for r in done),
                  f"front dense: streams in flight at shutdown were cut: "
                  f"{[(r['status'], len(r['tokens'])) for r in done]}")
            check(out["shutdown_s"] < FRONT_DRAIN_S,
                  f"front dense: shutdown took {out['shutdown_s']} s")
            check(llm.health() == "dead", "front dense: server not closed")
        elif arm == "shed":
            llm.close()
            check(await c.health() == 503,
                  "front shed: health not 503 after the server closed")
            out["health_after_close"] = 503
    return out


def front_arm(dev, params, arm: str, **env) -> dict:
    """Boot the port's example app (``mount`` on the phase-3 weights) with
    the arm's knobs on free ports, drive it, shut it down."""
    import gc

    from gofr_tpu_torch.app import new_app
    from gofr_tpu_torch.examples.llama_server import mount
    from gofr_tpu_torch.models import llama

    with knobs(LLAMA_PRESET="8b", LOG_LEVEL="ERROR", LLM_SLOTS="8",
               LLM_CHUNK="4", HTTP_PORT=str(free_port()),
               GRPC_PORT=str(free_port()), METRICS_PORT=str(free_port()),
               GOFR_ML_DRAIN_S=str(FRONT_DRAIN_S), **env):
        cfg = llama.config_from_env(tiny_vocab_size=257)
        app = new_app()
        t0 = time.perf_counter()
        mount(app, params, cfg, device=dev)
        warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()

    async def run():
        await app.start()
        try:
            return await drive_front(app, cfg, arm)
        finally:
            await app.shutdown()

    with flash_shapes(llama) as shapes:
        res = asyncio.run(run())
        torch.cuda.synchronize()
    launches = read_launches()
    check(launches["flash_attention_cuda"] > 0
          and launches["gqa_decode_attention_cuda"] > 0,
          f"front {arm}: kernels did not launch ({launches})")
    check(launches["gqa_decode_attention_int8_cuda"] == 0,
          f"front {arm}: the bf16 path launched the int8 decode kernel")
    offset_calls = sum(n for k, n in shapes.items() if k.endswith("+offset"))
    if arm == "paged":
        check(offset_calls > 0, "front paged: no flash call with q_offset > 0")
        check(res["prefix_cache"]["hits"] > 0,
              f"front paged: no prefix hit ({res['prefix_cache']})")
    res.update(launches=launches, flash_calls_by_shape=dict(shapes),
               flash_offset_calls=offset_calls, warmup_s=warm_s,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    del app
    gc.collect()
    torch.cuda.empty_cache()
    return res


def front_phase(dev, bf16_params) -> dict:
    """Phase 9: the port's ``examples/llama_server`` on Llama-3-8B at full
    width through real HTTP, WS and gRPC sockets, in three arms."""
    return {
        "dense": front_arm(dev, bf16_params, "dense"),
        "paged": front_arm(dev, bf16_params, "paged", LLM_PAGE_SIZE="16",
                           LLM_PAGES="257", LLM_PREFILL_CHUNK="512"),
        "shed": front_arm(dev, bf16_params, "shed", GOFR_ML_MAX_QUEUE="4"),
    }


# -- phase 10: resilience and observability ---------------------------------------

RES_MAX_NEW = 32
STICKY_LIMIT_S = 150.0


def res_app(dev, params, mount_kw=None, **env):
    """The port's example app mounted on ``params`` with 8 slots, chunk 4
    and the arm's knobs (read at boot) on free ports: (app, LLMServer,
    cfg). ``mount_kw`` go to ``register_llm``."""
    from gofr_tpu_torch.app import new_app
    from gofr_tpu_torch.examples.llama_server import mount
    from gofr_tpu_torch.models import llama

    with knobs(LLAMA_PRESET="8b", LOG_LEVEL="ERROR", LLM_SLOTS="8",
               LLM_CHUNK="4", HTTP_PORT=str(free_port()),
               GRPC_PORT=str(free_port()), METRICS_PORT=str(free_port()),
               **env):
        cfg = llama.config_from_env(tiny_vocab_size=257)
        app = mount(new_app(), params, cfg, device=dev, **(mount_kw or {}))
    return app, app.container.ml.llm("chat"), cfg


async def ws_or_error(clients, body: dict) -> dict:
    """``WS /stream`` that also ends on the port's error frame."""
    ws = await clients.session.ws_connect(clients.base + "/stream")
    await ws.send_json(body)
    rec = {"via": "ws", "status": 200, "tokens": []}
    while True:
        frame = await ws.receive_json(timeout=120)
        if "done" in frame:
            break
        if "error" in frame:
            rec["status"] = frame["error"]["status"]
            rec["details"] = frame["error"]["message"]
            break
        rec["tokens"].append(frame["token"])
    await ws.close()
    return rec


def ledger_row() -> dict:
    from gofr_tpu_torch.ml.goodput import goodput_ledger

    return goodput_ledger().snapshot_model("chat")


def ledger_delta(before: dict, after: dict) -> dict:
    wasted = {k: v - before["wasted"].get(k, 0)
              for k, v in after["wasted"].items()
              if v - before["wasted"].get(k, 0)}
    delivered = after["delivered"] - before["delivered"]
    computed = delivered + sum(wasted.values())
    return {"delivered": delivered, "wasted": wasted, "computed": computed,
            "goodput": delivered / computed if computed else None}


async def scripted_crash(app, llm, cfg) -> dict:
    """10.1: 8 gRPC streams in flight and 8 queued, a ``step`` that raises
    once: exactly the 8 in flight get UNAVAILABLE, the 8 queued finish
    with the tokens their prompts gave alone; the time from the raise to
    the end of ``recover`` (its synchronised mini-graph replay); health
    degraded; the crash bundle names the victims' rids and journeys; the
    graph count unchanged. The app is paged with the prefix cache off and
    the queued prompts are of one length, so a prompt alone and the 8
    admitted together run the same bf16 computation: paged admission
    prefills one request a wave (dense admission batches a wave of 8 into
    one prefill of another shape, whose bf16 rounding can flip a near-tie
    argmax), and equal lengths give every row the same gather width, so
    the decode kernel keeps its split plan; a repeated prompt would hit
    the radix cache, another computation again."""
    gen = llm.gen
    inflight = front_prompts(cfg.vocab_size, 8, 64, 512, seed=101)
    queued = front_prompts(cfg.vocab_size, 8, 300, 300, seed=102)
    out: dict = {}
    async with FrontClients(app) as c:
        alone = []
        for p in queued:
            r = await c.grpc({"prompt_ids": p, "max_new_tokens": RES_MAX_NEW})
            check(r["status"] == "OK" and len(r["tokens"]) == RES_MAX_NEW,
                  f"resilience: a prompt sent alone answered {r['status']}")
            alone.append(r["tokens"])
        graphs0 = gen.graph_stats()["graphs"]
        box: dict = {}

        def hook(point):
            if (point == "step" and "t_raise" not in box
                    and gen.n_live == 8 and llm.queue_depth() >= 8):
                box["t_raise"] = time.perf_counter()
                raise RuntimeError("scripted step fault")

        recover = gen.recover

        def timed_recover():
            res = recover()
            box["t_recovered"] = time.perf_counter()
            return res

        gen.recover = timed_recover
        gen.fault = hook
        reset_launches()
        first = [asyncio.ensure_future(c.grpc(
            {"prompt_ids": p, "max_new_tokens": 256})) for p in inflight]
        for _ in range(4000):
            if gen.n_live == 8:
                break
            await asyncio.sleep(0.005)
        check(gen.n_live == 8, "resilience: the first 8 never all admitted")
        second = [asyncio.ensure_future(c.grpc(
            {"prompt_ids": p, "max_new_tokens": RES_MAX_NEW}))
            for p in queued]
        victims = await asyncio.gather(*first)
        survivors = await asyncio.gather(*second)
        out["launches"] = read_launches()
        gen.fault = None
        del gen.recover
        check("t_recovered" in box, "resilience: the step fault never fired")
        check([r["status"] for r in victims] == ["UNAVAILABLE"] * 8,
              f"resilience: in-flight statuses "
              f"{[r['status'] for r in victims]}")
        check(all(r["status"] == "OK" for r in survivors),
              f"resilience: queued statuses "
              f"{[r['status'] for r in survivors]}")
        same = [r["tokens"] == a for r, a in zip(survivors, alone,
                                                 strict=True)]
        check(all(same), f"resilience: queued tokens differ from their "
              f"alone run for {same.count(False)} of 8")
        check(gen.graph_stats()["graphs"] == graphs0,
              f"resilience: graphs {graphs0} -> "
              f"{gen.graph_stats()['graphs']} across the recovery")
        status, body = await c.get(c.base + "/.well-known/health")
        state = json.loads(body)["data"]["ml"]["details"]["llms"]["chat"][
            "state"]
        check(status == 200 and state == "degraded",
              f"resilience: health {status} {state} after one recovery")
        _, body = await c.get(c.base + "/debug/crash")
        crashes = [x for x in json.loads(body)["data"]["crashes"]
                   if x["model"] == "chat"]
        check(bool(crashes), "resilience: no crash bundle")
        _, body = await c.get(c.base + f"/debug/crash/{crashes[-1]['id']}")
        bundle = json.loads(body)["data"]
        rids = sorted(s["rid"] for s in bundle["state"]["slots"])
        jrids = sorted(j["rid"] for j in bundle["state"].get("journeys", []))
        check(len(rids) == 8 and rids == jrids,
              f"resilience: bundle rids {rids} journeys {jrids}")
        snap = llm.resilience_snapshot()
    out.update(
        time_to_recover_ms=(box["t_recovered"] - box["t_raise"]) * 1e3,
        recover_call_ms=snap["restarts"]["recent"][-1]["recovery_ms"],
        victims=8, survivors_identical=8, graphs=graphs0, health=state,
        crash_id=crashes[-1]["id"], bundle_rids=rids)
    return out


async def chaos(app, llm, cfg) -> dict:
    """10.2: ``GOFR_ML_FAULT=step:0.02,prefill:0.05,emit:0.01`` (seed 1234)
    and a restart budget that keeps the server alive; 64 requests of 64
    tokens over gRPC (48), HTTP (8) and WS (8) at once. Every call ends
    with 64 tokens or a typed error (503 / UNAVAILABLE); ``restarts``
    equals the faults injected (every point's fault crashes a pass); the
    ledger balances against the generator's count of computed tokens;
    ``app_llm_tokens_wasted_total{reason="crashed"}`` equals the ledger."""
    gen = llm.gen
    prompts = front_prompts(cfg.vocab_size, 64, 64, 512, seed=103)
    before = ledger_row()
    reset_launches()
    async with FrontClients(app) as c:
        calls = []
        for i, p in enumerate(prompts):
            body = {"prompt_ids": p, "max_new_tokens": FRONT_MAX_NEW}
            calls.append(c.http(body) if i < 8 else ws_or_error(c, body)
                         if i < 16 else c.grpc(body))
        t0 = time.perf_counter()
        recs = await asyncio.wait_for(asyncio.gather(*calls), 300)
        wall = time.perf_counter() - t0
        launches = read_launches()
        ok = [r for r in recs if r["status"] in (200, 201, "OK")]
        typed = [r for r in recs if r["status"] in (503, "UNAVAILABLE")]
        check(len(ok) + len(typed) == len(recs),
              f"chaos: untyped outcomes "
              f"{[r['status'] for r in recs if r not in ok + typed]}")
        check(all(len(r["tokens"]) == FRONT_MAX_NEW for r in ok),
              "chaos: a completed call without 64 tokens")
        for _ in range(2000):  # a victim wakes before its recovery ends
            if llm.health() != "recovering":
                break
            await asyncio.sleep(0.005)
        snap = llm.resilience_snapshot()
        injected = snap["fault"]["injected"]
        check(snap["restarts"]["total"] == sum(injected.values()),
              f"chaos: restarts {snap['restarts']['total']} != injected "
              f"{injected}")
        check(llm.health() in ("serving", "degraded"),
              f"chaos: the server is {llm.health()}")
        delta = ledger_delta(before, ledger_row())
        check(delta["computed"] == gen.tokens_computed,
              f"chaos: ledger {delta} against the generator's "
              f"{gen.tokens_computed} computed tokens")
        metrics = await c.metrics()
        crashed_metric = metrics.get(
            'app_llm_tokens_wasted_total{model="chat",reason="crashed"}')
        crashed_ledger = ledger_row()["wasted"].get("crashed", 0)
        check(crashed_metric == crashed_ledger,
              f"chaos: wasted crashed metric {crashed_metric} != ledger "
              f"{crashed_ledger}")
    return {"requests": len(recs), "completed": len(ok),
            "typed_errors": len(typed),
            "by_transport": {v: [sum(1 for r in recs if r["via"] == v
                                     and r in ok),
                                 sum(1 for r in recs if r["via"] == v
                                     and r in typed)]
                             for v in ("grpc", "http", "ws")},
            "restarts": snap["restarts"]["total"], "injected": injected,
            "attempts": snap["fault"]["attempts"], "ledger": delta,
            "tokens_computed": gen.tokens_computed,
            "goodput_fraction": delta["goodput"], "wall_s": wall,
            "delivered_tok_per_s": delta["delivered"] / wall,
            "launches": launches}


async def paged_resilience(app, llm, cfg) -> dict:
    """10.3, int8 pages with windows (K = 4) and the pipeline, the host
    tier on: a 512-token prefix promoted by the radix cache and spilled;
    a crash with two windows in flight fails only the streams in flight
    and leaves none in flight; after it the spilled prefix restores with
    the tokens of the resident hit; a ``restore`` fault (``KeyError``:
    the tier's lost-entry path) is charged ``restore_fallback`` and the
    prefix prefills cold with the same tokens; pages conserved."""
    import numpy as np

    gen = llm.gen
    r = np.random.default_rng(104)
    prefix = r.integers(0, cfg.vocab_size, 512).tolist()
    suffix = r.integers(0, cfg.vocab_size, 40).tolist()
    others = front_prompts(cfg.vocab_size, 8, 64, 400, seed=105)

    def held():
        return (gen.free_pages
                + sum(len(i["pages"]) for i in list(gen._prefixes.values()))
                + sum(len(p) - s for p, s in zip(gen._slot_pages,
                                                 gen._slot_shared)))

    def spill_all():
        def work():
            n = 0
            for pid, info in list(gen._prefixes.items()):
                if info["refs"] == 0:
                    n += gen.drop_prefix(pid, spill=True)
            return n
        return llm._run_on_serving(work, 60, "spill")

    reset_launches()
    out: dict = {}
    async with FrontClients(app) as c:
        body = {"prompt_ids": prefix + suffix, "max_new_tokens": RES_MAX_NEW}

        async def one():
            rec = await c.grpc(body)
            check(rec["status"] == "OK", f"paged resilience: {rec}")
            return rec["tokens"]

        cold = await one()      # the first sight: a whole prefill
        hit = await one()       # promoted: the prefix registers, suffix runs
        check(gen.prefix_prefills >= 1, "paged resilience: no promotion")
        check(await asyncio.to_thread(spill_all) >= 1,
              "paged resilience: nothing spilled")
        box = {"fired": 0}

        def hook(point):
            if (point == "step" and not box["fired"]
                    and len(gen._inflight) >= 2):
                box["fired"] = 1
                box["inflight"] = len(gen._inflight)
                raise RuntimeError("crash with two windows in flight")

        gen.fault = hook
        recs = await asyncio.gather(*(c.grpc(
            {"prompt_ids": p, "max_new_tokens": 64}) for p in others))
        gen.fault = None
        check(box["fired"] == 1 and box["inflight"] == 2,
              f"paged resilience: the fault fired {box}")
        failed = sum(x["status"] == "UNAVAILABLE" for x in recs)
        check(failed >= 1 and all(x["status"] in ("OK", "UNAVAILABLE")
                                  for x in recs),
              f"paged resilience: statuses {[x['status'] for x in recs]}")
        for _ in range(1000):  # the idle pass drains the pipeline's tail
            if gen.n_live == 0 and not gen._inflight:
                break
            await asyncio.sleep(0.005)
        check(len(gen._inflight) == 0, "paged resilience: blocks in flight "
              "after the recovery")
        restores0 = gen.kv_restores
        restored = await one()
        check(gen.kv_restores == restores0 + 1,
              "paged resilience: the spilled prefix did not restore")
        check(restored == hit, "paged resilience: tokens after the restore "
              "differ from the resident hit")
        check(await asyncio.to_thread(spill_all) >= 1,
              "paged resilience: nothing spilled the second time")
        fb0 = ledger_row()["wasted"].get("restore_fallback", 0)
        prefills0 = gen.prefix_prefills
        fired = {"n": 0}

        def restore_fault(point):
            if point == "restore" and not fired["n"]:
                fired["n"] = 1
                raise KeyError("injected restore fault")

        gen.fault = restore_fault
        fallback = await one()
        gen.fault = None
        charged = ledger_row()["wasted"].get("restore_fallback", 0) - fb0
        check(fired["n"] == 1 and charged > 0,
              f"paged resilience: restore fault charged {charged}")
        check(gen.prefix_prefills == prefills0 + 1,
              "paged resilience: the fallback did not prefill the prefix")
        check(fallback == hit, "paged resilience: the cold fallback's "
              "tokens differ from the resident hit")
        check(held() == gen.n_pages - 1, f"paged resilience: pages "
              f"{held()} of {gen.n_pages - 1} accounted")
        out.update(cold_equals_hit=cold == hit, crash_inflight=2,
                   streams_failed=failed, restored_identical=True,
                   restore_fallback_tokens=charged,
                   fallback_identical=True, pages_conserved=True,
                   kv_spills=gen.kv_spills, kv_restores=gen.kv_restores,
                   restarts=llm.resilience_snapshot()["restarts"]["total"])
    launches = read_launches()
    check(launches["gqa_decode_attention_int8_cuda"] > 0
          and launches["flash_attention_cuda"] > 0
          and launches["gqa_decode_attention_cuda"] == 0,
          f"paged resilience: launches {launches}")
    out["launches"] = launches
    return out


def sticky_child() -> int:
    """10.4, run in a child process (``--sticky-child``): the example app
    with the tiny model on the card; a ``step`` hook writes out of range on
    the card (a device-side assert: a sticky error of the context). The
    server goes dead with at most one restart attempt, health answers 503,
    every caller gets a typed error. Prints one ``sticky:`` line and exits
    at once (the context is poisoned)."""
    import os

    import gofr_tpu_torch
    from gofr_tpu_torch.examples.llama_server import main as example
    from gofr_tpu_torch.ops import _build

    dev = gofr_tpu_torch.resolve_device()
    _build.build()
    with knobs(LLAMA_PRESET="tiny", LOG_LEVEL="ERROR", LLM_SLOTS="4",
               LLM_CHUNK="4", HTTP_PORT=str(free_port()),
               GRPC_PORT=str(free_port()), METRICS_PORT=str(free_port())):
        app = example(device=dev)
    llm = app.container.ml.llm("chat")
    armed = {"on": False}

    def hook(point):
        if point == "step" and armed["on"]:
            armed["on"] = False
            x = torch.zeros(4, device=dev)
            x[torch.tensor([1 << 30], device=dev)] = 1.0  # out of range

    llm.gen.fault = hook

    async def run():
        await app.start()
        async with FrontClients(app) as c:
            warm = await c.grpc({"prompt_ids": [1, 2, 3],
                                 "max_new_tokens": 8})
            armed["on"] = True
            recs = await asyncio.wait_for(asyncio.gather(
                *(c.grpc({"prompt_ids": [4, 5, i], "max_new_tokens": 64})
                  for i in range(4)),
                c.http({"prompt_ids": [7, 8], "max_new_tokens": 64})), 60)
            after = await c.grpc({"prompt_ids": [1, 2], "max_new_tokens": 4})
            health = await c.health()
        return warm, recs, after, health

    t0 = time.perf_counter()
    warm, recs, after, health = asyncio.run(run())
    snap = llm.resilience_snapshot()
    print("sticky: " + json.dumps({
        "warm": warm["status"], "statuses": [r["status"] for r in recs],
        "after": after["status"], "health": health, "state": llm.health(),
        "restarts": snap["restarts"]["total"],
        "attempts": len(snap["restarts"]["recent"]),
        "error": (snap["restarts"]["recent"] or [{}])[-1].get("error"),
        "seconds": time.perf_counter() - t0}), flush=True)
    sys.stdout.flush()
    os._exit(0)


def sticky_error() -> dict:
    """Run ``sticky_child`` in a child process within ``STICKY_LIMIT_S``."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, __file__, "--sticky-child"],
                          capture_output=True, text=True,
                          timeout=STICKY_LIMIT_S)
    wall = time.perf_counter() - t0
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("sticky: ")), None)
    check(proc.returncode == 0 and line is not None,
          f"sticky error: the child exited {proc.returncode} "
          f"({proc.stderr[-2000:]})")
    res = json.loads(line[len("sticky: "):])
    check(res["warm"] == "OK", f"sticky error: the warm call {res}")
    check(res["state"] == "dead" and res["restarts"] == 0
          and res["attempts"] <= 1,
          f"sticky error: the server is {res['state']} after "
          f"{res['attempts']} attempts")
    check(res["health"] == 503, f"sticky error: health {res['health']}")
    check(all(s in (503, "UNAVAILABLE") for s in res["statuses"])
          and res["after"] == "UNAVAILABLE",
          f"sticky error: callers got {res['statuses']}, {res['after']}")
    res.update(child_wall_s=wall, limit_s=STICKY_LIMIT_S)
    return res


async def observability(app, llm, cfg) -> dict:
    """10.5 under load (8 gRPC streams kept busy): the ``stalls`` phases of
    ``/debug/serving`` sum to its wall within 1 %; the recorder's idle share
    beside the busy share of a ``/debug/profile?seconds=2`` capture of the
    same steady state, whose trace names the flash and decode kernels; a
    ``step`` sleep hook under a fresh auto-profiler (the JAX defaults)
    triggers exactly one capture in its cooldown; ``/debug/programs`` lists
    as many decode graphs as ``graph_stats()`` counts."""
    import io
    import zipfile

    from gofr_tpu_torch.flight_recorder import (AutoProfiler, event_log,
                                                profile_vault)

    gen = llm.gen
    prompts = front_prompts(cfg.vocab_size, 64, 64, 512, seed=106)
    stop = {"on": False}
    out: dict = {}
    reset_launches()
    async with FrontClients(app) as c:
        async def worker(k):
            i = k
            while not stop["on"]:
                await c.grpc({"prompt_ids": prompts[i % len(prompts)],
                              "max_new_tokens": 96})
                i += 8

        workers = [asyncio.ensure_future(worker(k)) for k in range(8)]
        await asyncio.sleep(4.0)
        # the recorder's estimate over the steady state just before the
        # capture (the capture's processing stalls the serving thread)
        _, body = await c.get(c.base + "/debug/serving")
        steady = json.loads(body)["data"]["llms"]["chat"]["stalls"]
        out.update(recorder_device_idle_share=steady["device_idle_share"],
                   recorder_window_s=steady["window"]["wall_s"],
                   recorder_records=steady["window"]["records"],
                   steady_phase_shares={k: v["share"] for k, v in
                                        steady["window"]["phases"].items()})
        t0 = time.perf_counter()
        for _ in range(40):  # 409 while an auto-capture holds the profiler
            r = await c.session.get(c.base + "/debug/profile",
                                    params={"seconds": "2"})
            data = await r.read()
            if r.status != 409:
                break
            await asyncio.sleep(0.25)
        prof_wall = time.perf_counter() - t0
        check(r.status == 200 and r.content_type == "application/zip",
              f"observability: /debug/profile answered {r.status}")
        with zipfile.ZipFile(io.BytesIO(data)) as zf:
            trace = json.loads(zf.read(zf.namelist()[0]))
        kernels = [e for e in trace.get("traceEvents", [])
                   if e.get("cat") == "kernel" and "dur" in e]
        names = {e["name"] for e in kernels}
        check(any("flash" in n for n in names)
              and any("decode" in n for n in names),
              f"observability: the trace names no flash or decode kernel "
              f"({sorted(names)[:8]})")
        if kernels:
            t_lo = min(e["ts"] for e in kernels)
            t_hi = max(e["ts"] + e["dur"] for e in kernels)
            busy = sum(e["dur"] for e in kernels) / max(t_hi - t_lo, 1e-9)
        else:
            busy = None
        _, body = await c.get(c.base + "/debug/serving")
        entry = json.loads(body)["data"]["llms"]["chat"]
        stalls = entry["stalls"]
        wall = stalls["window"]["wall_s"]
        phase_sum = sum(p["s"] for p in stalls["window"]["phases"].values())
        check(wall > 0 and abs(phase_sum - wall) <= 0.01 * wall,
              f"observability: stalls phases {phase_sum} against wall {wall}")
        out.update(profile_zip_bytes=len(data), profile_wall_s=prof_wall,
                   profiler_busy_share=busy,
                   recorder_idle_share_after=stalls["device_idle_share"],
                   stalls_wall_s=wall, stalls_phase_sum_s=phase_sum,
                   top_stall=stalls["top_stall"],
                   attributed_share=stalls["attributed_share"],
                   kernels_in_trace=len(kernels))
        # the auto-profiler: a fresh one with the JAX defaults
        prof = AutoProfiler(model="chat")
        llm.autoprof = prof
        llm.recorder.observer = prof.observe
        cursor = event_log().cursor
        vault0 = len(profile_vault().list())
        for _ in range(3000):
            if prof.dispatches >= 96:
                break
            await asyncio.sleep(0.01)
        gen.fault = lambda p: time.sleep(0.1) if p == "step" else None
        for _ in range(3000):
            if prof.captures + prof.failures + prof.skipped_busy:
                break
            await asyncio.sleep(0.01)
        n0 = prof.dispatches
        for _ in range(3000):  # two more windows of regressed dispatches
            if prof.dispatches >= n0 + 32:
                break
            await asyncio.sleep(0.01)
        gen.fault = None
        for _ in range(1000):  # the capture thread lands the zip
            if len(profile_vault().list()) > vault0 or prof.failures:
                break
            await asyncio.sleep(0.01)
        events = event_log().query(since=cursor, model="chat",
                                   kind="profile")["events"]
        check(prof.captures == 1 and prof.failures == 0
              and len(events) == 1,
              f"observability: auto-profiler {prof.snapshot()}, "
              f"{len(events)} profile events")
        _, body = await c.get(c.base + "/debug/profile/auto")
        caps = json.loads(body)["data"]["captures"]
        check(len(caps) == vault0 + 1 and caps[-1]["bytes"] > 0,
              f"observability: /debug/profile/auto lists {caps}")
        out["autoprof"] = prof.snapshot()
        stop["on"] = True
        await asyncio.gather(*workers)
        out["launches"] = read_launches()
        _, body = await c.get(c.base + "/debug/programs")
        rows = json.loads(body)["data"]["models"]["chat"]["entries"]
        graph_rows = sum(1 for row in rows if row["kind"] == "graph")
        check(graph_rows == gen.graph_stats()["graphs"],
              f"observability: {graph_rows} graph rows against "
              f"{gen.graph_stats()['graphs']} graphs")
        out.update(program_rows=len(rows), graph_rows=graph_rows)
    return out


async def served_tok_s(app, prompts) -> float:
    """All ``prompts`` at once over gRPC, 64 tokens each: tokens a second
    through the front."""
    async with FrontClients(app) as c:
        t0 = time.perf_counter()
        recs = await asyncio.gather(*(c.grpc(
            {"prompt_ids": p, "max_new_tokens": FRONT_MAX_NEW})
            for p in prompts))
        wall = time.perf_counter() - t0
    check(all(r["status"] == "OK" for r in recs), "overhead: a call failed")
    return sum(len(r["tokens"]) for r in recs) / wall


def resilience_phase(dev, bf16_params) -> dict:
    """Phase 10: resilience and observability through the port's example
    app on the phase-3 weights (10.1-10.6, see the module docstring)."""
    import gc
    import statistics

    res: dict = {}
    off = dict(GOFR_ML_FLIGHT_RECORDER="0", GOFR_ML_JOURNEY="0",
               GOFR_ML_GOODPUT="0", GOFR_ML_AUTOPROF="0")
    t = time.perf_counter()
    app_p, llm_p, cfg = res_app(dev, bf16_params,
                                mount_kw={"prefix_cache": False},
                                LLM_PAGE_SIZE="16")

    async def on_p():
        await app_p.start()
        try:
            return await scripted_crash(app_p, llm_p, cfg)
        finally:
            await app_p.shutdown()

    res["crash"] = asyncio.run(on_p())
    res["crash"]["seconds"] = time.perf_counter() - t
    print("10.1 scripted crash: " + json.dumps(res["crash"]), flush=True)
    del app_p, llm_p
    gc.collect()
    app_a, llm_a, cfg = res_app(dev, bf16_params)
    app_b, _, _ = res_app(dev, bf16_params, **off)
    torch.cuda.synchronize()

    async def on_a_and_b():
        await app_a.start()
        await app_b.start()
        try:
            t = time.perf_counter()
            res["observe"] = await observability(app_a, llm_a, cfg)
            res["observe"]["seconds"] = time.perf_counter() - t
            print("10.5 observability: " + json.dumps(res["observe"]),
                  flush=True)
            prompts = front_prompts(cfg.vocab_size, 16, 64, 512, seed=107)
            await served_tok_s(app_b, prompts[:8])  # B's first traffic
            runs = {"on": [], "off": []}
            for arm in ("on", "off") * 3:
                runs[arm].append(await served_tok_s(
                    app_a if arm == "on" else app_b, prompts))
            res["overhead"] = {
                "tok_per_s": runs,
                "median_on": statistics.median(runs["on"]),
                "median_off": statistics.median(runs["off"]),
                "on_over_off": (statistics.median(runs["on"])
                                / statistics.median(runs["off"]))}
            print("10.6 overhead: " + json.dumps(res["overhead"]),
                  flush=True)
        finally:
            await app_a.shutdown()
            await app_b.shutdown()

    asyncio.run(on_a_and_b())
    del app_a, app_b, llm_a
    gc.collect()
    t = time.perf_counter()
    app_c, llm_c, cfg = res_app(
        dev, bf16_params, GOFR_ML_FAULT="step:0.02,prefill:0.05,emit:0.01",
        GOFR_ML_FAULT_SEED="1234", GOFR_ML_MAX_RESTARTS="1000")

    async def on_c():
        await app_c.start()
        try:
            return await chaos(app_c, llm_c, cfg)
        finally:
            await app_c.shutdown()

    res["chaos"] = asyncio.run(on_c())
    res["chaos"]["seconds"] = time.perf_counter() - t
    print("10.2 chaos: " + json.dumps(res["chaos"]), flush=True)
    del app_c, llm_c
    gc.collect()
    t = time.perf_counter()
    app_d, llm_d, cfg = res_app(
        dev, bf16_params, LLAMA_KV_QUANT="1", LLM_PAGE_SIZE="16",
        LLM_PAGES="513", LLM_PREFILL_CHUNK="512", GOFR_ML_PIPELINE="1",
        GOFR_ML_DECODE_WINDOW="4", GOFR_ML_KV_HOST_BUDGET_MB="2048")

    async def on_d():
        await app_d.start()
        try:
            return await paged_resilience(app_d, llm_d, cfg)
        finally:
            await app_d.shutdown()

    res["paged_int8"] = asyncio.run(on_d())
    res["paged_int8"]["seconds"] = time.perf_counter() - t
    print("10.3 paged int8: " + json.dumps(res["paged_int8"]), flush=True)
    del app_d, llm_d
    gc.collect()
    torch.cuda.empty_cache()
    res["sticky"] = sticky_error()
    print("10.4 sticky error: " + json.dumps(res["sticky"]), flush=True)
    return res


def main(argv: list[str]) -> int:
    import pathlib

    # --out DIR: also write every result to DIR/chip_smoke.json
    out_dir = (pathlib.Path(argv[argv.index("--out") + 1])
               if "--out" in argv else None)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import gofr_tpu_torch
    except ModuleNotFoundError:
        # the script alone, without the package beside it: no result
        print("chip_smoke: the gofr_tpu_torch package is not importable; "
              "run the script from the root of a checkout",
              file=sys.stderr)
        return 1
    if "--sticky-child" in argv:
        return sticky_child()
    import faulthandler

    from gofr_tpu_torch.ops import _build

    # a hung phase dumps every thread's stack and ends the run inside the
    # time limit instead of holding the card to it
    faulthandler.dump_traceback_later(1140, exit=True)
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
    t0 = time.perf_counter()

    def done(what: str, result) -> None:
        nonlocal t0
        print(f"{what} ({time.perf_counter() - t0:.1f} s): "
              + json.dumps(result))
        t0 = time.perf_counter()

    path, bf16_params = main_path(dev)
    done("main path (bf16)", path)
    qpath, w8_params = int8_path(dev, bf16_params)
    done("main path (int8 cache + int8 weights)", qpath)
    ppath = paged_path(dev, bf16_params, w8_params)
    done("paged path", ppath)
    graphs = graph_phase(dev, bf16_params, w8_params)
    done("graph vs eager", graphs)
    windows = window_pipeline_phase(dev, bf16_params)
    done("windows and pipeline", windows)
    tier = host_tier_phase(dev, bf16_params, w8_params)
    done("host KV tier", tier)
    front = front_phase(dev, bf16_params)
    done("the front", front)
    res = resilience_phase(dev, bf16_params)
    done("resilience and observability", res)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "chip_smoke.json").write_text(json.dumps(
            {"card": card, "kernels": rows, "bf16": path, "int8": qpath,
             "paged": ppath, "graphs": graphs, "windows": windows,
             "host_tier": tier, "front": front, "resilience": res},
            indent=1))
    for row in rows:
        by_path = {"bf16": path["launches"][row["name"]],
                   "int8": qpath["launches"][row["name"]],
                   **{f"paged_{arm}": ppath[arm]["launches"][row["name"]]
                      for arm in ("bf16", "int8", "int4")},
                   **{f"paged_bf16_{arm}": windows[arm]["launches"][
                       row["name"]] for arm in ("window_auto", "pipeline",
                                                "window_auto_pipeline")},
                   **{f"host_tier_{arm}": tier[arm]["launches"][row["name"]]
                      for arm in ("bf16", "int8")},
                   **{f"front_{arm}": front[arm]["launches"][row["name"]]
                      for arm in ("dense", "paged", "shed")},
                   **{f"resilience_{arm}": res[arm]["launches"][row["name"]]
                      for arm in ("crash", "observe", "chaos",
                                  "paged_int8")}}
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
    sys.exit(main(sys.argv[1:]))
