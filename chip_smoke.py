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
7. fused windows and the pipeline, at 16 of the 32 layers
   (``WINDOW_LAYERS``): phase 5's paged bf16 serving arm with
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
   the child done within ``STICKY_LIMIT_S``;
11. speculative decoding (K = 4) on phase 3's weights: (a) the verify
   window through the decode kernel, q [8, 5, 32, 128] over a 32-layer
   cache of 8 x 2048 at kv_len 2000, bf16 and int8, against its plain
   version within 2e-2, W = 1 bit for bit the decode kernel's own launch,
   timed by ``sweep_ms`` beside the plain version and masked
   ``scaled_dot_product_attention``; (b) 8 repetition-heavy prompts (a
   24-token phrase x 8) x 64 new tokens through ``LLMServer`` on the
   dense bf16 generator (8 slots x 1024, chunk 4), speculation off and
   prompt lookup on: served tok/s, accepted drafts a window,
   ``spec_rejected`` and the streams equal to spec off (recorded: bf16
   near-ties flip); (c) the same prompts on int8 pages with fused
   windows (auto) and the pipeline, by graph replay and eagerly from the
   same start: identical tokens (checked), the int8 window kernel only;
   (d) ``LLM_SPEC_K=4 LLM_DRAFT_PRESET=self`` through the example app over
   gRPC, 8 streams: accept >= 0.8 and the draft's decode launches
   (checked). Each number on its own ``spec:`` line;
12. the engine path (``register_model`` -> ``Engine`` -> ``DynamicBatcher``,
   no kernel of the port: the three attention kernels' launches are
   recorded, 0 expected) serving BASELINE configs #2, #3 and #5 through the
   port's examples at full width, random weights from seed 0: the MNIST
   MLP 784-512-512-10, BERT-base (12 x 768, vocab 30522, 128 tokens) and
   DiT-XL/2 (28 x 1152, 16 heads of 72, 256 patches of a 32 x 32 x 4
   latent, ``DIT_STEPS`` 30, guidance 5.0) on a BERT-base text encoder,
   ``ada_w`` and ``patch_out`` perturbed. (a) Before traffic, on each
   engine: every captured bucket's graph replay equals the eager apply on
   the same inputs bit for bit, and the bf16 module is within 2e-2 of
   range of the same module run eagerly in f32 (the DiT: its denoiser;
   the whole sampler's difference is recorded); the device ms of one
   replay (CUDA events), the eager wall, the busy share of a served
   execute (profiler), capture seconds and pool bytes per bucket. (b)
   Each example booted on free ports and driven over real sockets: 256
   ``POST /predict`` with 64 in flight (and a bad shape: 400); config #3's
   8 rounds of 32 concurrent gRPC ``ml.Embeddings/Embed`` calls of 16-128
   ids, then 8 of them alone (an embedding served in a batch within 2e-2
   of range of the same request alone) and one ``POST /embed``; 4
   concurrent ``GET /image`` (two prompts twice: the same prompt, the
   same PNG bytes; two prompts, two PNGs). Every call answers 200/201;
   ``app_ml_batch_size`` shows a batch of more than one row (MNIST, BERT).
   Printed on ``engine:`` lines: calls/s, p50/p99, realized batches, peak
   memory, and per bucket replay ms, eager ms, capture s and pool bytes;
13. the OpenAI-compatible front and the time machine on phase 3's weights
   (the port's ``examples/openai_server``, 8 slots, chunk 4, with
   ``examples/llama_server``'s ``POST /generate`` on the same server):
   (a) dense (``max_seq`` 1024): ``OPTIONS`` answers 200 with the CORS
   headers; three prompts alone give the same tokens over ``/generate``
   and the same text not streamed and streamed (SSE, with the CORS and
   correlation headers); then 32 calls at once (16 streamed chats with
   ``include_usage``, 8 chats not streamed, 8 streamed completions; chat
   prompts of 64-512 bytes rendered, 64 new tokens each): every stream
   opens with the role delta and ends in a ``length`` finish and ``data:
   [DONE]``, ``usage`` equals the tokens sent and ``app_llm_tokens_total``
   their sum, flash and the bf16 decode kernel launch and the int8 one
   never; measured: tok/s, TTFT (the first frame with text) and the gap
   between text frames (p50, p99); (b) paged (phase 9's ``LLM_PAGE_SIZE``
   16, ``LLM_PAGES`` 257, ``LLM_PREFILL_CHUNK`` 512): a window of 32
   requests 100 ms apart (streamed and not, priorities high, normal and
   low in turn, half on one 512-byte system prompt) through an app with
   ``GOFR_ML_CAPTURE=256``; ``/debug/capture`` decoded by ``load_bundle``
   and replayed at speed 1 on a fresh app of the same config: digest
   identity 1.0 over all 32, a balanced goodput delta, no drift
   (checked); capture on against off, 32 chats at once, 3 runs each in
   turns; a scripted ``step`` fault with capture armed: the
   ``/debug/crash/<id>`` body loads as a bundle holding the crashed
   request; (c) ``Tuner`` over that bundle with ``default_grid()`` at
   speed 1, every arm a fresh ``Generator`` of the paged config over the
   same weights, warmed up and replayed once: the scoreboard (identity, steady tok/s, TTFT/TPOT p99,
   pruning), a winner, and ``register_llm`` booted with the emitted
   profile through ``GOFR_ML_PROFILE`` shows it on ``/debug/serving``
   with the environment restored after (checked); (d) on a fresh dense
   app, 8 SSE streams kept busy out of phase and a ``GET
   /debug/profile?seconds=2`` (20 ms slices): the route's answer time and
   the longest gap between two text frames of one stream across the
   capture, at most ``OAI_PROFILE_GAP_S``, its trace naming the flash and
   decode kernels (checked);
14. the fleet (``ml/replica.py``, ``ml/kv_transport.py``) through the
   example app over gRPC, pages of 16, 513 pages a replica,
   ``prefill_chunk`` 512, ``max_seq`` 2048, every replica on phase 3's
   weights (their first ``FLEET_LAYERS``, 16, of 32 layers) without a
   copy; each arm counts the launches of its fleet
   traffic alone, its reference runs after the count is read: (a)
   ``GOFR_ML_REPLICAS=2``, 32 requests x 64 tokens at once: both
   replicas take work, the added peak memory stays below a second copy
   of the weights, and each stream equals that of one replica (a
   single-replica app with its prefix cache off, the same 32 requests
   at once) or differs on a near-tie (the two
   tokens' logits within ``FLEET_TIE`` of the range at the first
   divergent step, one plain forward); (b) a ``step`` fault on replica 0
   past a restart budget of 0: the request re-admits on replica 1 with
   the tokens of one replica alone, health DEGRADED with ``{"0":
   "dead", "1": "serving"}``; the time from the crash event to the
   client's first frame and the bytes the dead replica gives back; (c)
   ``GOFR_ML_DISAGG=1`` at bf16 pages and at int8 pages (w8): two
   1600-token prompts ship from replica 0 to replica 1 (ships == lands,
   no failure, the decode replica restores; tokens equal one replica
   computing the same prefix + tail split), the bytes a ship, the
   journey's ship / land / route / admit / prefill ms of the first ship
   and a later one, TTFT against a cold prompt on one replica; (d)
   ``GOFR_ML_ELASTIC=1`` from one replica under 16 concurrent requests:
   ``scale_to(2)`` (time to routable: build, warmup, graph capture,
   backfill) and, after a hot prefix on replica 1, ``scale_to(1)`` (the
   migration's bytes and ms, the ledger balanced): no request fails and a
   fixed prompt's tokens before, during and after agree (or differ on a
   near-tie). Each arm counts its flash and decode launches.
15. HF import, training, checkpoints and serving what was trained, on
   Llama-3-8B at its published width cut to ``TRAIN_LAYERS`` (8) of its 32
   layers (phase 3's first 8), last, with phases 3 and 4's weights still
   resident: (a) the 8 layers written by the script's own safetensors
   writer as an HF directory (two shards and an index, ``[out, in]``
   projections, ``config.json``, a small byte-level ``tokenizer.json``) and
   imported onto the card by ``ml.hf_import.import_hf_llama``: every leaf
   bit for bit, the import's seconds and GB/s, the host's peak RSS over its
   start (checked below half a model); (c) on one batch at the training
   shape (2 x 2048, ``remat``), the loss and every gradient leaf through the
   flash kernel under autograd (``ops._FlashDiff``) against the plain
   attention (loss within 1e-2 relative, every leaf's cosine >= 0.99), and
   the training-shape flash launch timed as phase 2 times the others, with
   the plain backward the Function runs; (b) ``Trainer(llama.loss_fn)``,
   ``adamw(3e-4, mu_dtype=f32)``, bf16 params, fed by ``DataLoader(
   jsonl_source(...), batch_size=2, prefetch=2)`` over a JSONL written from
   seed 0, 8 steps (the first 6 one batch): every loss finite, the loss
   over the repeated batch falls, 2 x 8 flash launches a step (forward
   and the remat recompute); step ms, tokens/s, the share of 989 TFLOP/s
   (6 N tokens + 3 (2 L H D) B S^2), peak allocated memory, and one more
   step split into forward + backward and the optimizer; the state
   (params, f32 mu, bf16 nu, step) saved by ``ml.checkpoint.Checkpointer``
   after step 3; (d) restored and resumed: step 4's loss within 1e-3 of
   the uninterrupted run's; then the port's ``examples/llama_server``
   serves the saved weights from ``LLAMA_CKPT=<checkpointer dir>``
   (bf16, and with ``LLAMA_W8=1``, which quantizes the restored weights)
   and the imported ones through ``main()`` from ``LLAMA_CKPT=<HF dir>``
   with ``TOKENIZER_JSON``: each boot's weights equal the saved / source
   ones, 3 gRPC calls and a text ``POST /generate`` answer, and the greedy
   tokens equal a ``Generator`` built in process on the served tensors.

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

import numpy as np
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
        gqa_decode_attention_cuda, gqa_decode_attention_int8_cuda,
        gqa_decode_window_cuda, gqa_decode_window_int8_cuda)
    from gofr_tpu_torch.ops.flash_attention import flash_attention_cuda

    return {"flash_attention_cuda": flash_attention_cuda,
            "gqa_decode_attention_cuda": gqa_decode_attention_cuda,
            "gqa_decode_attention_int8_cuda": gqa_decode_attention_int8_cuda,
            "gqa_decode_window_cuda": gqa_decode_window_cuda,
            "gqa_decode_window_int8_cuda": gqa_decode_window_int8_cuda}


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
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
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


# phase 7 runs at this depth (of 32 layers) to keep the script inside its
# time limit; its checks compare arms of the same depth
WINDOW_LAYERS = 16


def window_pipeline_phase(dev, bf16_params) -> dict:
    """The paged bf16 serving arm four times, at ``WINDOW_LAYERS`` of the
    model's 32 layers (the first ones of phase 3's weights): windows off,
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

    cfg = llama.llama3_8b(n_layers=WINDOW_LAYERS)
    bf16_params = {**bf16_params, "layers": {
        k: v[:WINDOW_LAYERS] for k, v in bf16_params["layers"].items()}}
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
    out["n_layers"] = WINDOW_LAYERS
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


def trace_slices(zip_bytes: bytes) -> list[list[dict]]:
    """The kernel events of each Chrome trace in a ``/debug/profile`` zip
    (one a slice)."""
    import io
    import zipfile

    out = []
    with zipfile.ZipFile(io.BytesIO(zip_bytes)) as zf:
        for name in sorted(zf.namelist()):
            trace = json.loads(zf.read(name))
            out.append([e for e in trace.get("traceEvents", [])
                        if e.get("cat") == "kernel" and "dur" in e])
    return out


async def observability(app, llm, cfg) -> dict:
    """10.5 under load (8 gRPC streams kept busy): the ``stalls`` phases of
    ``/debug/serving`` sum to its wall within 1 %; the recorder's idle share
    beside the busy share of a ``/debug/profile?seconds=2`` capture of the
    same steady state, whose trace names the flash and decode kernels; a
    ``step`` sleep hook under a fresh auto-profiler (the JAX defaults)
    triggers exactly one capture in its cooldown; ``/debug/programs`` lists
    as many decode graphs as ``graph_stats()`` counts."""
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
        slices = trace_slices(data)
        kernels = [e for sl in slices for e in sl]
        names = {e["name"] for e in kernels}
        check(any("flash" in n for n in names)
              and any("decode" in n for n in names),
              f"observability: the trace names no flash or decode kernel "
              f"({sorted(names)[:8]})")
        # kernel time over the spans the slices cover
        spans = sum(max(e["ts"] + e["dur"] for e in sl)
                    - min(e["ts"] for e in sl) for sl in slices if sl)
        busy = sum(e["dur"] for e in kernels) / spans if spans else None
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


# -- phase 11: speculative decoding ----------------------------------------------

SPEC_K = 4
SPEC_MAX_NEW = 64


def spec_prompts(vocab: int, n: int = 8, phrase: int = 24, reps: int = 8,
                 seed: int = 11) -> list[list[int]]:
    """``n`` repetition-heavy prompts: a random ``phrase``-token phrase
    repeated ``reps`` times each (bench/config8_speculative.py's shape)."""
    import numpy as np

    r = np.random.default_rng(seed)
    return [np.tile(r.integers(0, vocab, phrase), reps).tolist()
            for _ in range(n)]


def window_bound(kv_len, W: int, S: int, KV: int, D: int, H: int,
                 int8: bool):
    """(bound ms, bound_by, bytes) of one verify-window launch: each row's
    live prefix (its last position's ``kv_len + W - 1`` keys) read once,
    int8 with one bf16 scale a position and KV head; q and o once; 4*D
    FLOPs per (query head, key) pair the causal window keeps."""
    live = sum(min(n + W - 1, S) if n > 0 else S for n in kv_len)
    pairs = sum(min(max(n + t, 0), S) for n in kv_len for t in range(W))
    row = KV * (D + 2) if int8 else KV * D * 2
    nbytes = 2 * live * row + 2 * (2 * len(kv_len) * W * H * D) \
        + 4 * len(kv_len)
    return (*bound(4 * D * H * pairs, nbytes), nbytes)


def window_kernel_rows(dev, tol: float) -> list[dict]:
    """11(a): the verify window through the decode kernel (bf16 and int8
    caches) at Llama-3-8B's K = 4 window, q [8, 5, 32, 128] over a 32-layer
    cache of 8 x 2048 at kv_len 2000: against its plain version (JAX's
    ``attention`` with ``q_offset = kv_len - 1``) within ``tol``, W = 1 of
    the window entry bit for bit the decode kernel's own launch, and timed
    by ``sweep_ms`` beside the plain version and the library call (masked
    ``scaled_dot_product_attention``; over dequantized bf16 layers for the
    int8 cache, a yardstick)."""
    import torch.nn.functional as F

    from gofr_tpu_torch.ops import dequantize_kv
    from gofr_tpu_torch.ops import decode_attention as da

    L, B, S, KV, D, H, W = 32, 8, 2048, 8, 128, 32, SPEC_K + 1
    g = torch.Generator(device=dev).manual_seed(0)
    lens = [2000] * B
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = rnd_bf16(g, dev, B, W, H, D)
    qt = q.transpose(1, 2)
    ar = torch.arange(S, device=dev)
    mask = (ar[None, None, :] <= (kv_len - 1)[:, None, None]
            + torch.arange(W, device=dev)[None, :, None])[:, None]
    rows = []
    for int8 in (False, True):
        if int8:
            kc, vc, ks, vs = int8_cache(g, dev, L, B, S, KV, D)
            sc = {"k_scale": ks, "v_scale": vs}
            kernel, plain = (da.gqa_decode_window_int8_cuda,
                             da.gqa_decode_window_int8_plain)
            decode = da.gqa_decode_attention_int8_cuda
        else:
            kc, vc = (rnd_bf16(g, dev, L, B, S, KV, D) for _ in range(2))
            sc = {}
            kernel, plain = da.gqa_decode_window_cuda, da.gqa_decode_window_plain
            decode = da.gqa_decode_attention_cuda
        what = "int8" if int8 else "bf16"
        n0 = kernel.launches
        out = kernel(q, kc, vc, kv_len, layer=7, **sc)
        ref = plain(q, kc, vc, kv_len, layer=7, **sc)
        torch.cuda.synchronize()
        check(kernel.launches == n0 + 1, f"window {what}: one launch a call")
        check(bool(torch.isfinite(out.float()).all()),
              f"window {what}: output not finite")
        err = (out.float() - ref.float()).abs().max().item()
        check(err <= tol, f"window {what}: kernel vs plain max_abs_err "
              f"{err} > {tol}")
        q1 = q[:, :1].contiguous()
        one = kernel(q1, kc, vc, kv_len, layer=7, **sc)
        dec = decode(q1, kc, vc, kv_len, layer=7, **sc)
        torch.cuda.synchronize()
        same = bool(torch.equal(one, dec))
        check(same, f"window {what}: W = 1 differs from the decode launch")

        def launch(layer, kc=kc, vc=vc, sc=sc, kernel=kernel):
            return kernel(q, kc, vc, kv_len, layer=layer, **sc)

        def plain_launch(layer, kc=kc, vc=vc, sc=sc, plain=plain):
            return plain(q, kc, vc, kv_len, layer=layer, **sc)

        ms = sweep_ms(launch, L)
        plain_ms = sweep_ms(plain_launch, 4, graph=False)
        if int8:
            per_layer = 2 * B * S * KV * D * 2
            n_deq = min(L, -(-4 * 50 * 2**20 // per_layer))
            deq = [tuple(dequantize_kv(values[i].view(B, S, KV, D),
                                       scales[i].transpose(1, 2))
                         .transpose(1, 2)
                         for values, scales in ((kc, ks), (vc, vs)))
                   for i in range(n_deq)]

            def lib(layer, deq=deq):
                kt, vt = deq[layer]
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
            lib_ms = sweep_ms(lib, n_deq)
        else:
            def lib(layer, kc=kc, vc=vc):
                return F.scaled_dot_product_attention(
                    qt, kc[layer].transpose(1, 2), vc[layer].transpose(1, 2),
                    attn_mask=mask, enable_gqa=True)
            lib_ms = sweep_ms(lib, L)
        b_ms, b_by, nbytes = window_bound(lens, W, S, KV, D, H, int8)
        name = ("gqa_decode_window_int8_cuda" if int8
                else "gqa_decode_window_cuda")
        row = {"name": name, "route": "cuda",
               "source": "gofr_tpu_torch/ops/csrc/decode_attention.cu",
               # JAX's verify attention is plain XLA, no Pallas kernel
               "replaces": ("gofr_tpu/models/llama.py:1504" if not int8
                            else "gofr_tpu/models/llama.py:1504 (int8 cache)"),
               "replaces_note": "plain attention with q_offset in "
                                "decode_window (:1504) and "
                                "paged_decode_window (:1404); no TPU kernel",
               "tol": tol, "max_abs_err": err, "w1_equals_decode": same,
               "shape": f"q[{B},{W},{H},{D}] cache L={L} B={B} S={S} "
                        f"KV={KV} {what} kv_len={lens}",
               "ms": ms, "plain_ms": plain_ms,
               "library_ms": None if int8 else lib_ms,
               **({"yardstick": "scaled_dot_product_attention over "
                                "dequantized bf16 layers",
                   "yardstick_ms": lib_ms} if int8 else {}),
               "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
               "tb_per_s": nbytes / (ms * 1e-3) / 1e12}
        rows.append(row)
        del kc, vc, sc
        torch.cuda.empty_cache()
    return rows


def spec_served(gen, name: str, prompts, max_new: int) -> tuple:
    """Every prompt through ``LLMServer.generate`` at once: (outputs,
    wall seconds)."""
    from gofr_tpu_torch.ml.llm import LLMServer

    async def run():
        server = LLMServer(gen, name=name)
        try:
            t = time.perf_counter()
            outs = await asyncio.gather(*(server.generate(p, max_new)
                                          for p in prompts))
            return outs, time.perf_counter() - t
        finally:
            server.close()

    return asyncio.run(run())


def spec_lookup_arm(dev, params, prompts) -> dict:
    """11(b): the bf16 main path (8 slots x 1024, chunk 4, the decode
    graphs) with speculation off and with prompt-lookup K = 4: served tok/s
    of 8 repetition-heavy prompts x 64 new tokens through ``LLMServer``,
    the accepted drafts a window, ``spec_rejected`` and how many streams
    equal the spec-off ones (recorded, not gated: bf16 near-ties flip)."""
    import gc

    from gofr_tpu_torch.ml.generate import Generator
    from gofr_tpu_torch.ml.goodput import goodput_ledger
    from gofr_tpu_torch.models import llama

    cfg = llama.llama3_8b()
    res: dict = {}
    outs = {}
    for arm, k in (("off", 0), ("on", SPEC_K)):
        gen = Generator(params, cfg, batch_slots=8, max_seq=1024, chunk=4,
                        prefill_buckets=(128, 512), spec_k=k, device=dev)
        t0 = time.perf_counter()
        gen.warmup()
        warm_s = time.perf_counter() - t0
        reset_launches()
        steps0 = gen.steps
        outs[arm], wall = spec_served(gen, f"spec-{arm}", prompts,
                                      SPEC_MAX_NEW)
        torch.cuda.synchronize()
        launches = read_launches()
        steps = gen.steps - steps0  # verify windows (or steps) dispatched
        check(all(len(o) == SPEC_MAX_NEW
                  and all(0 <= t < cfg.vocab_size for t in o)
                  for o in outs[arm]),
              f"spec {arm}: every request returns {SPEC_MAX_NEW} ids")
        row = {"served_tok_per_s": len(prompts) * SPEC_MAX_NEW / wall,
               "wall_s": wall, "warmup_s": warm_s, "launches": launches,
               "dispatched": steps, "graphs": gen.graph_stats()}
        if k:
            stats = gen.spec_stats()
            check(stats["windows"] > 0, "spec on: no verify window ran")
            check(launches["gqa_decode_window_cuda"]
                  >= cfg.n_layers * steps > 0,
                  f"spec on: window kernel launched "
                  f"{launches['gqa_decode_window_cuda']} times for "
                  f"{steps} dispatched windows")
            check(launches["gqa_decode_window_int8_cuda"] == 0,
                  "spec on: the bf16 path launched the int8 window kernel")
            row.update(
                spec=stats,
                accepted_per_window=(stats["emitted"] - stats["windows"])
                / stats["windows"],
                spec_rejected=goodput_ledger().snapshot_model(
                    "spec-on")["wasted"].get("spec_rejected", 0))
        else:
            check(launches["gqa_decode_attention_cuda"] > 0,
                  "spec off: the decode kernel did not launch")
        res[arm] = row
        del gen
        gc.collect()
        torch.cuda.empty_cache()
    res["streams_identical_to_off"] = sum(
        a == b for a, b in zip(outs["off"], outs["on"], strict=True))
    res["tok_per_s_on_over_off"] = (res["on"]["served_tok_per_s"]
                                    / res["off"]["served_tok_per_s"])
    res["_outputs_off"] = outs["off"]
    return res


def spec_paged_arm(dev, params, prompts) -> dict:
    """11(c): int8 pages (pool of 513 pages of 16), K = 4 verify windows in
    fused windows (``decode_window`` auto) with the depth-2 pipeline, the
    same prompts driven through the Generator twice from the same start:
    once by CUDA-graph replays, once eagerly through the same kernels. The
    tokens must be identical."""
    import gc

    from gofr_tpu_torch.ml.generate import Generator
    from gofr_tpu_torch.models import llama

    cfg = llama.llama3_8b(kv_bits=8)
    res: dict = {}
    outs = {}
    for arm in ("graph", "eager"):
        with knobs(GOFR_ML_DECODE_WINDOW="auto", GOFR_ML_PIPELINE="1"):
            gen = Generator(params, cfg, batch_slots=8, max_seq=1024,
                            chunk=4, prefill_buckets=(128, 512),
                            page_size=16, n_pages=513, spec_k=SPEC_K,
                            device=dev)
        if arm == "eager":
            gen._graphs = None  # every dispatch runs its body eagerly
        got: dict[int, list[int]] = {}
        reset_launches()
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            gen.add_request(p, SPEC_MAX_NEW, callback=lambda _s, t, i=i:
                            got.setdefault(i, []).extend(int(x) for x in t))
        while gen.n_live:
            gen.step()
        gen.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        outs[arm] = [got[i] for i in range(len(prompts))]
        check(all(len(o) == SPEC_MAX_NEW for o in outs[arm]),
              f"spec paged {arm}: every stream returns {SPEC_MAX_NEW} ids")
        check(launches["gqa_decode_window_int8_cuda"] > 0
              and launches["gqa_decode_window_cuda"] == 0,
              f"spec paged {arm}: the int8 window kernel only ({launches})")
        res[arm] = {"wall_s": wall, "launches": launches,
                    "spec": gen.spec_stats(), "window": gen.window_stats(),
                    "pipeline": gen.pipeline_stats(),
                    "graphs": gen.graph_stats()}
        del gen
        gc.collect()
        torch.cuda.empty_cache()
    same = outs["graph"] == outs["eager"]
    check(same, "spec paged int8: graph replay and eager dispatch gave "
          "different tokens")
    res["tokens_identical"] = same
    return res


def spec_draft_arm(dev, params, prompts, outs_off) -> dict:
    """11(d): ``LLM_SPEC_K=4 LLM_DRAFT_PRESET=self`` through the port's
    ``examples/llama_server`` (8 slots, chunk 4) over gRPC, 8 streams. The
    target is its own draft, so only bf16 near-ties between the draft's
    decode step and the verify window can reject: accept >= 0.8 (checked);
    the draft's decode steps launch the bf16 decode kernel (checked)."""
    import gc

    app, server, cfg = res_app(dev, params, LLM_SPEC_K=str(SPEC_K),
                               LLM_DRAFT_PRESET="self")
    gen = server.gen
    check(gen.draft_params is not None and gen.spec_k == SPEC_K,
          "the example did not build a draft-model generator")
    reset_launches()

    async def run():
        await app.start()
        try:
            async with FrontClients(app) as clients:
                t = time.perf_counter()
                recs = await asyncio.gather(*(clients.grpc(
                    {"prompt_ids": p, "max_new_tokens": SPEC_MAX_NEW})
                    for p in prompts))
                return recs, time.perf_counter() - t
        finally:
            await app.shutdown()

    recs, wall = asyncio.run(run())
    torch.cuda.synchronize()
    launches = read_launches()
    check(all(r["status"] == "OK" and len(r["tokens"]) == SPEC_MAX_NEW
              for r in recs), "spec draft: a gRPC stream failed or was short")
    stats = gen.spec_stats()
    check(stats["mode"] == "draft" and stats["windows"] > 0,
          f"spec draft: no draft-model windows ({stats})")
    check(stats["accept_rate"] >= 0.8,
          f"spec draft: the self draft accepted {stats['accept_rate']} < 0.8")
    check(launches["gqa_decode_attention_cuda"] > 0
          and launches["gqa_decode_window_cuda"] > 0,
          f"spec draft: the draft's decode kernel and the window kernel "
          f"must both launch ({launches})")
    res = {"served_tok_per_s": len(prompts) * SPEC_MAX_NEW / wall,
           "wall_s": wall, "launches": launches, "spec": stats,
           "accept_rate": stats["accept_rate"],
           "streams_identical_to_off": sum(
               r["tokens"] == o for r, o in zip(recs, outs_off, strict=True)),
           "graphs": gen.graph_stats()}
    del app, server, gen
    gc.collect()
    torch.cuda.empty_cache()
    return res


def speculation_phase(dev, bf16_params, tol: float = 2e-2) -> dict:
    """Phase 11: the window kernel, then speculation served on the phase-3
    weights: prompt lookup dense, int8 pages with windows and the
    pipeline (graph against eager), a self draft over gRPC. Each number
    is printed on its own line."""
    kernels = window_kernel_rows(dev, tol)
    prompts = spec_prompts(bf16_params["embed"].shape[0])
    lookup = spec_lookup_arm(dev, bf16_params, prompts)
    outs_off = lookup.pop("_outputs_off")
    paged = spec_paged_arm(dev, bf16_params, prompts)
    draft = spec_draft_arm(dev, bf16_params, prompts, outs_off)
    for row in kernels:
        for key in ("max_abs_err", "w1_equals_decode", "ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_share"):
            print(f"spec: {row['name']} {key} {row[key]}")
    for arm in ("off", "on"):
        print(f"spec: lookup {arm} served_tok_per_s "
              f"{lookup[arm]['served_tok_per_s']}")
    for key in ("accepted_per_window", "spec_rejected"):
        print(f"spec: lookup {key} {lookup['on'][key]}")
    print(f"spec: lookup accept_rate {lookup['on']['spec']['accept_rate']}")
    print(f"spec: lookup streams_identical_to_off "
          f"{lookup['streams_identical_to_off']} of {len(prompts)}")
    print(f"spec: paged int8 graph/eager tokens_identical "
          f"{paged['tokens_identical']}")
    print(f"spec: paged int8 accept_rate "
          f"{paged['graph']['spec']['accept_rate']}")
    print(f"spec: draft self accept_rate {draft['accept_rate']}")
    print(f"spec: draft self served_tok_per_s {draft['served_tok_per_s']}")
    print(f"spec: draft self streams_identical_to_off "
          f"{draft['streams_identical_to_off']} of {len(prompts)}")
    return {"kernels": kernels, "lookup": lookup, "paged_int8": paged,
            "draft_self": draft}


# -- phase 12: the engine path ----------------------------------------------------

ENGINE_TOL = 2e-2
DIT_STEPS = 30      # bench/config5_sdxl.py's step count for the base preset
MNIST_CALLS, MNIST_IN_FLIGHT = 256, 64
BERT_ROUNDS, BERT_AT_ONCE = 8, 32


def range_err(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| over the range of ``want``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    span = float(want.max() - want.min()) or 1.0
    return float(np.abs(got - want).max()) / span


def host(out) -> np.ndarray:
    """A model output as the engine hands it back (bf16 widened to f32)."""
    if out.dtype == torch.bfloat16:
        out = out.float()
    return out.cpu().numpy()


def as_f32(tree):
    """Every floating tensor of ``tree`` in f32 (the reference module)."""
    from gofr_tpu_torch.ml.engine import tree_map

    return tree_map(lambda t: t.float() if t.is_floating_point() else t, tree)


def perturb_dit(dit, dev, seed: int = 1) -> None:
    """``ada_w`` and ``patch_out`` drawn from seeded noise (x 0.02): zero
    as initialised, they would make the DiT predict eps = 0 whatever its
    trunk computes (JAX's ``test_conditioning_changes_output`` does the
    same)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    p = dit.params
    for tree, key in ((p, "patch_out"), (p["layers"], "ada_w")):
        w = tree[key]
        w.copy_(torch.randn(w.shape, generator=g, device=dev) * 0.02)


def engine_models(dev) -> dict:
    """The four engines' models at full width, random weights from seed 0:
    the MNIST MLP 784-512-512-10, BERT-base (config #3's encoder, and
    config #5's text encoder), DiT-XL/2 with a BERT-base context, perturbed."""
    from gofr_tpu_torch.models import bert, diffusion, mlp

    dit = diffusion.DiT(diffusion.dit_xl(), device=dev)
    perturb_dit(dit, dev)
    return {"mnist": mlp.mnist_mlp(device=dev),
            "bert": bert.Bert(bert.bert_base(), device=dev),
            "text_encoder": bert.Bert(bert.bert_base(), seed=1, device=dev),
            "dit": dit}


def engine_inputs(name: str, key: tuple, rng) -> list[np.ndarray]:
    """Seeded inputs of one engine's graph shape: images, token rows with
    valid lengths (16-128 for BERT), a context of the encoder's width."""
    shapes = [k[0] for k in key]
    b = shapes[0][0] if shapes[0] else 1
    if name == "mnist":
        return [rng.random(shapes[0], dtype=np.float32)]
    if name in ("bert", "text_encoder"):
        s = shapes[0][1]
        return [rng.integers(1, 30522, shapes[0]).astype(np.int32),
                rng.integers(min(16, s), s + 1, b).astype(np.int32)]
    return [rng.standard_normal(shapes[0]).astype(np.float32)]


def f32_config(cfg):
    """A copy of a model config at f32."""
    import copy

    cfg32 = copy.copy(cfg)
    cfg32.dtype = torch.float32
    return cfg32


def reference_f32(name: str, model, engine, inputs: list, dev):
    """The same module run eagerly in f32 on the card, on f32 copies of the
    weights: the MLP, BERT's embedding (config #3) or hidden states (the
    text encoder), and for the DiT its denoiser at the sampler's guidance
    batch (cond + zero uncond, the first step's t). Returns (the bf16
    module's output, the f32 one)."""
    from gofr_tpu_torch.models import bert, diffusion

    xs = [torch.from_numpy(x).to(dev) for x in inputs]
    if name == "mnist":
        return (host(engine.apply_fn(engine.params, *xs)),
                host(model.apply(as_f32(model.params), *xs)))
    if name in ("bert", "text_encoder"):
        what = "mean" if name == "bert" else "hidden"
        outs = [bert.forward(p, xs[0], c, seq_lens=xs[1])[what] for p, c in
                ((model.params, model.cfg),
                 (as_f32(model.params), f32_config(model.cfg)))]
        return host(outs[0]), host(outs[1])
    cfg = model.cfg
    g = torch.Generator(device=dev).manual_seed(2)
    lat = torch.randn((2, cfg.latent_size, cfg.latent_size,
                       cfg.latent_channels), generator=g, device=dev)
    ctx = torch.cat([xs[0], torch.zeros_like(xs[0])])
    t = torch.full((2,), diffusion.ddim_timesteps(DIT_STEPS)[0],
                   dtype=torch.int32, device=dev)
    return (host(diffusion.forward(model.params, lat, t, ctx, cfg)),
            host(diffusion.forward(as_f32(model.params), lat, t, ctx,
                                   f32_config(cfg))))


def engine_checks(name: str, model, engine, dev, card: str) -> dict:
    """(a) on one engine: each captured bucket's replay against the eager
    run of the same apply on the same inputs (bit for bit), the bf16 module
    against f32 within ``ENGINE_TOL`` of range, the device ms of one
    replay (CUDA events), the busy share of a served execute (profiler),
    capture seconds and pool bytes per bucket."""
    rng = np.random.default_rng(12)
    rows = {r["name"]: r for r in engine.programs.snapshot()}
    buckets = {}
    for key in sorted(engine.graphs, key=lambda k: k[0][0]):
        b = key[0][0][0]
        inputs = engine_inputs(name, key, rng)
        graph_out = engine.predict_sync(*inputs)
        xs = [torch.from_numpy(x).to(dev) for x in inputs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = host(engine.apply_fn(engine.params, *xs))
        eager_ms = (time.perf_counter() - t0) * 1e3
        check(np.array_equal(graph_out, eager),
              f"engine {name} b{b}: graph replay differs from eager "
              f"(max {np.abs(graph_out - eager).max()})")
        graph = engine.graphs[key][1]
        reps = 3 if name == "dit" else 20
        row = rows[f"apply/b{b}"]
        buckets[b] = {"replay_ms": timed_ms(graph.replay, iters=reps, warm=1),
                      "eager_ms": eager_ms, "capture_s": row["wall_s"],
                      "pool_bytes": row.get("pool_bytes"),
                      "graph_equals_eager": True}
    # the served bucket: bf16 against f32, and the busy share of an execute
    served_b = {"mnist": 64, "bert": 32}.get(name, 1)
    key = next(k for k in engine.graphs if k[0][0][0] == served_b)
    inputs = engine_inputs(name, key, rng)
    bf16_out, f32_out = reference_f32(name, model, engine, inputs, dev)
    err = range_err(bf16_out, f32_out)
    check(err <= ENGINE_TOL,
          f"engine {name}: bf16 {err:.4f} of range from f32 (> {ENGINE_TOL})")
    prof = device_profile(lambda: engine.predict_sync(*inputs),
                          3 if name == "dit" else 10)
    res = {"buckets": buckets, "served_bucket": served_b,
           "weights_gib": _nbytes(engine.params) / 2**30,
           "bf16_vs_f32_err": err, "busy_share": prof["busy_share"],
           "execute_wall_ms": prof["wall_ms"],
           "execute_device_ms": prof["device_ms"],
           "top_device_ms": prof["top_device_ms"]}
    if name == "dit":
        # the whole sampler at bf16 against f32 from the same noise:
        # recorded (30 guided steps compound the bf16 rounding)
        from gofr_tpu_torch.models import diffusion

        ctx = torch.from_numpy(inputs[0]).to(dev)
        g = torch.Generator(device=dev).manual_seed(0)
        noise = torch.randn((1, 32, 32, 4), generator=g, device=dev)
        s16 = diffusion.ddim_sample(model.params, ctx, model.cfg, noise,
                                    steps=DIT_STEPS)
        s32 = diffusion.ddim_sample(as_f32(model.params), ctx,
                                    f32_config(model.cfg), noise,
                                    steps=DIT_STEPS)
        res["sampler_bf16_vs_f32_err"] = range_err(host(s16), host(s32))
        res["step_ms"] = buckets[1]["replay_ms"] / DIT_STEPS
    print(f"engine: {name} buckets {sorted(buckets)} graph=eager; bf16 vs "
          f"f32 {err:.5f} of range; busy {prof['busy_share']:.3f} at "
          f"b{served_b}; weights {res['weights_gib']:.3f} GiB; {card}")
    for b, r in buckets.items():
        print(f"engine: {name} b{b} replay {r['replay_ms']:.4f} ms, eager "
              f"{r['eager_ms']:.2f} ms (host wall), capture "
              f"{r['capture_s']:.3f} s, pool {r['pool_bytes']} B; {card}")
    return res


def batch_sizes(text: str, model: str) -> dict:
    """The ``app_ml_batch_size`` histogram of ``model`` from /metrics:
    {"le": cumulative count}, the count and the sum."""
    out: dict = {"buckets": {}}
    tag = f'model="{model}"'
    for line in text.splitlines():
        if not line.startswith("app_ml_batch_size") or tag not in line:
            continue
        key, _, value = line.rpartition(" ")
        if key.startswith("app_ml_batch_size_bucket"):
            le = key.split('le="')[1].split('"')[0]
            out["buckets"][le] = float(value)
        elif key.startswith("app_ml_batch_size_count"):
            out["count"] = float(value)
        elif key.startswith("app_ml_batch_size_sum"):
            out["sum"] = float(value)
    return out


def served_stats(lat: list, wall: float) -> dict:
    return {"calls": len(lat), "per_s": len(lat) / wall, "wall_s": wall,
            "p50_ms": pct(lat, 0.5) * 1e3, "p99_ms": pct(lat, 0.99) * 1e3}


async def drive_mnist(app, rng) -> dict:
    import aiohttp

    base = f"http://127.0.0.1:{app.http_port}"
    gate = asyncio.Semaphore(MNIST_IN_FLIGHT)
    images = rng.random((MNIST_CALLS, 784), dtype=np.float32)
    lat, codes = [], []

    async with aiohttp.ClientSession() as s:
        async def one(img):
            async with gate:
                t0 = time.perf_counter()
                r = await s.post(base + "/predict", json={"image": img.tolist()})
                body = await r.json()
                lat.append(time.perf_counter() - t0)
                codes.append(r.status)
                return body

        t0 = time.perf_counter()
        bodies = await asyncio.gather(*(one(x) for x in images))
        wall = time.perf_counter() - t0
        r = await s.post(base + "/predict", json={"image": [1, 2]})
        bad = r.status
        metrics = await (await s.get(
            f"http://127.0.0.1:{app.metrics_port}/metrics")).text()
    check(all(c == 201 for c in codes), f"mnist: statuses {set(codes)}")
    check(all(0 <= b["data"]["digit"] <= 9 and len(b["data"]["probs"]) == 10
              for b in bodies), "mnist: a malformed answer")
    check(bad == 400, f"mnist: a bad shape answered {bad}")
    return {**served_stats(lat, wall), "bad_shape_status": bad,
            "batch_size": batch_sizes(metrics, "mnist")}


async def drive_bert(app, rng) -> dict:
    import aiohttp
    import grpc.aio

    channel = grpc.aio.insecure_channel(f"127.0.0.1:{app.grpc_port}")
    rpc = channel.unary_unary(
        "/ml.Embeddings/Embed",
        request_serializer=lambda o: json.dumps(o).encode(),
        response_deserializer=json.loads)
    rounds = [[rng.integers(1, 30522, int(n)).tolist()
               for n in rng.integers(16, 129, BERT_AT_ONCE)]
              for _ in range(BERT_ROUNDS)]
    lat: list = []

    async def one(ids):
        t0 = time.perf_counter()
        out = await rpc({"token_ids": ids}, timeout=120)
        lat.append(time.perf_counter() - t0)
        return np.asarray(out["embedding"], np.float32)

    try:
        t0 = time.perf_counter()
        batched = []
        for ids in rounds:
            batched.append(await asyncio.gather(*(one(x) for x in ids)))
        wall = time.perf_counter() - t0
        served = served_stats(lat, wall)
        # the first round's first 8 requests again, each alone (batch 1)
        alone = [await one(ids) for ids in rounds[0][:8]]
    finally:
        await channel.close()
    pad_err = max(range_err(a, b) for a, b in zip(alone, batched[0][:8]))
    check(pad_err <= ENGINE_TOL,
          f"bert: an embedding served in a batch is {pad_err:.4f} of range "
          f"from the same request alone")
    async with aiohttp.ClientSession() as s:
        base = f"http://127.0.0.1:{app.http_port}"
        r = await s.post(base + "/embed", json={"token_ids": rounds[0][0]})
        http_status = r.status
        vec = np.asarray((await r.json())["data"]["embedding"], np.float32)
        metrics = await (await s.get(
            f"http://127.0.0.1:{app.metrics_port}/metrics")).text()
    check(http_status == 201, f"bert: POST /embed answered {http_status}")
    check(vec.shape == batched[0][0].shape and np.isfinite(vec).all()
          and range_err(vec, batched[0][0]) <= ENGINE_TOL,
          "bert: POST /embed gave another embedding than gRPC")
    return {**served, "batched_vs_alone_err": pad_err,
            "batch_size": batch_sizes(metrics, "bert")}


async def drive_sdxl(app) -> dict:
    import aiohttp

    base = f"http://127.0.0.1:{app.http_port}"
    prompts = ["a red fox in the snow", "a lighthouse at dusk"] * 2
    lat: list = []
    async with aiohttp.ClientSession() as s:
        async def one(prompt):
            t0 = time.perf_counter()
            r = await s.get(base + "/image", params={"prompt": prompt})
            body = await r.read()
            lat.append(time.perf_counter() - t0)
            return r.status, r.headers.get("Content-Type"), body

        t0 = time.perf_counter()
        outs = await asyncio.gather(*(one(p) for p in prompts))
        wall = time.perf_counter() - t0
    check(all(st == 200 and ct == "image/png" and b[:8] == b"\x89PNG\r\n\x1a\n"
              for st, ct, b in outs), "sdxl: not every call answered a PNG")
    pngs = [b for _, _, b in outs]
    check(pngs[0] == pngs[2] and pngs[1] == pngs[3],
          "sdxl: the same prompt gave different PNG bytes")
    check(pngs[0] != pngs[1], "sdxl: two prompts gave the same PNG")
    return {**served_stats(lat, wall), "png_bytes": [len(b) for b in pngs]}


def engine_app(mount, *models, **env):
    """An app on free ports with ``mount`` on ``models`` (every engine's
    buckets captured at registration) and the seconds it took."""
    from gofr_tpu_torch.app import new_app

    with knobs(LOG_LEVEL="ERROR", HTTP_PORT=str(free_port()),
               GRPC_PORT=str(free_port()), METRICS_PORT=str(free_port()),
               **env):
        app = new_app()
        t0 = time.perf_counter()
        mount(app, *models)
        return app, time.perf_counter() - t0


def engine_phase(dev, card: str) -> dict:
    """Phase 12: the engine path (``register_model`` -> ``Engine`` ->
    ``DynamicBatcher``) serving BASELINE configs #2, #3 and #5 through the
    port's examples at full width, each booted on free ports and driven
    over real sockets; (a) each engine's graphs against eager and its bf16
    module against f32 before the traffic."""
    import gc

    from gofr_tpu_torch.examples import bert_server, mnist_server, sdxl_server

    rng = np.random.default_rng(1212)
    models = engine_models(dev)
    arms = (("mnist", mnist_server.mount, ("mnist",), drive_mnist),
            ("bert", bert_server.mount, ("bert",), drive_bert),
            ("sdxl", lambda app, enc, dit: sdxl_server.mount(
                app, enc, dit, steps=DIT_STEPS), ("text_encoder", "dit"),
             lambda app, _rng: drive_sdxl(app)))
    out: dict = {}
    for arm, mount, names, drive in arms:
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        app, boot_s = engine_app(mount, *(models[n] for n in names))
        ml = app.container.ml
        res = {"boot_s": boot_s, "models": {
            n: engine_checks(n, models[n], ml.engine(n), dev, card)
            for n in names}}

        async def run(app=app, drive=drive):
            await app.start()
            try:
                return await drive(app, rng)
            finally:
                await app.shutdown()

        # the serving peak, above what was resident before the arm (the
        # earlier phases' tensors and all four engine models' weights);
        # the graphs' own pools are reserved memory, reported per bucket
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res["served"] = asyncio.run(run())
        res["resident_before_gib"] = resident / 2**30
        res["peak_mem_gib"] = (torch.cuda.max_memory_allocated()
                               - resident) / 2**30
        res["graph_pools_gib"] = sum(
            r["pool_bytes"] for m in res["models"].values()
            for r in m["buckets"].values()) / 2**30
        if arm != "sdxl":
            sizes = res["served"]["batch_size"]
            check(sizes["buckets"].get("1", 0) < sizes.get("count", 0),
                  f"{arm}: no realized batch had more than one row "
                  f"({sizes})")
        sv = res["served"]
        print(f"engine: {arm} served {sv['calls']} calls {sv['per_s']:.2f}/s "
              f"p50 {sv['p50_ms']:.2f} ms p99 {sv['p99_ms']:.2f} ms; "
              f"batches {sv.get('batch_size', {}).get('buckets')}; peak "
              f"+{res['peak_mem_gib']:.2f} GiB over "
              f"{res['resident_before_gib']:.2f} resident, graph pools "
              f"{res['graph_pools_gib']:.3f} GiB; boot "
              f"{boot_s:.1f} s; {card}")
        out[arm] = res
        del app, ml
        gc.collect()
        torch.cuda.empty_cache()
    return out


# -- phase 13: the OpenAI front, traffic capture and replay, the tuner -----------

OAI_MAX_NEW = 64
OAI_PAGED = dict(LLM_PAGE_SIZE="16", LLM_PAGES="257", LLM_PREFILL_CHUNK="512")
# (b): the window's arrivals, 100 ms apart (an open-loop ~10 requests/s)
OAI_SPACING_S = 0.1
OAI_PROFILE_GAP_S = 1.0


def oai_texts(n: int, lo: int, hi: int, seed: int) -> list[str]:
    """``n`` prompt texts of ``lo``-``hi`` printable ASCII characters (one
    byte-level token each) from ``seed``."""
    r = np.random.default_rng(seed)
    return ["".join(map(chr, r.integers(32, 127, int(r.integers(lo,
                                                                hi + 1)))))
            for _ in range(n)]


def oai_chat_texts(n: int, seed: int) -> list[str]:
    """``n`` chat contents whose rendered one-message prompt (the role
    tags and the assistant cue around it) is 64-512 bytes: the dense
    app's largest prefill bucket."""
    from gofr_tpu_torch.examples.openai_server import _render_chat

    tags = len(_render_chat([{"role": "user", "content": ""}]))
    return oai_texts(n, 64 - tags, 512 - tags, seed)


def oai_app(dev, params, **env):
    """The port's ``examples/openai_server`` mounted on ``params`` (8
    slots, chunk 4, the arm's knobs read at boot) on free ports, with the
    existing ``POST /generate`` of ``examples/llama_server`` on the same
    server (registered as ``chat`` too): (app, LLMServer, cfg)."""
    from gofr_tpu_torch.app import new_app
    from gofr_tpu_torch.examples import llama_server, openai_server
    from gofr_tpu_torch.models import llama

    with knobs(LLAMA_PRESET="8b", LOG_LEVEL="ERROR", LLM_SLOTS="8",
               LLM_CHUNK="4", HTTP_PORT=str(free_port()),
               GRPC_PORT=str(free_port()), METRICS_PORT=str(free_port()),
               **env):
        cfg = llama.config_from_env(tiny_vocab_size=257)
        app = openai_server.mount(new_app(), params, cfg, device=dev)
    llm = app.container.ml.llm(openai_server.MODEL_ID)
    app.container.ml._llms["chat"] = llm
    app.post("/generate", llama_server.generate)
    return app, llm, cfg


async def oai_call(session, base: str, path: str, body: dict,
                   headers: dict | None = None,
                   live: list | None = None) -> dict:
    """One OpenAI call: a stream's record holds every ``data:`` payload and
    its arrival (host seconds, ``time.perf_counter``), any other call its
    JSON body. ``live`` gets the record as soon as the headers arrive, so
    a stream's frames can be read while it runs."""
    t0 = time.perf_counter()
    async with session.post(base + path, json=body,
                            headers=headers or {}) as r:
        rec = {"status": r.status, "headers": dict(r.headers), "t0": t0,
               "stream": bool(body.get("stream"))}
        if live is not None:
            live.append(rec)
        if rec["stream"] and r.status == 200:
            rec["frames"], rec["at"] = [], []
            async for line in r.content:
                if line.startswith(b"data: "):
                    rec["at"].append(time.perf_counter())
                    raw = line[6:].strip().decode()
                    rec["frames"].append(raw if raw == "[DONE]"
                                         else json.loads(raw))
        else:
            rec["body"] = await r.json()
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def oai_text(rec: dict) -> str:
    """The generated text of a call, streamed or not."""
    if "frames" not in rec:
        choice = rec["body"]["choices"][0]
        return choice["message"]["content"] if "message" in choice \
            else choice["text"]
    return "".join(c.get("delta", {}).get("content") or c.get("text") or ""
                   for f in rec["frames"][:-1] for c in f["choices"])


def oai_content_at(rec: dict) -> list[float]:
    """Arrivals of a stream's frames that carry generated text."""
    return [t for f, t in zip(rec["frames"], rec["at"])
            if f != "[DONE]" and any(c.get("delta", {}).get("content")
                                     or c.get("text") for c in f["choices"])]


def check_oai_stream(what: str, rec: dict, chat: bool) -> None:
    """A stream answered 200, started with the role delta (chat) and ended
    in a ``length`` finish and ``data: [DONE]``."""
    check(rec["status"] == 200 and rec["frames"]
          and rec["frames"][-1] == "[DONE]",
          f"{what}: a stream answered {rec['status']} or did not end in "
          f"[DONE]")
    if chat:
        check(rec["frames"][0]["choices"][0]["delta"]
              == {"role": "assistant", "content": ""},
              f"{what}: a chat stream did not open with the role delta")
    finishes = [c["finish_reason"] for f in rec["frames"][:-1]
                for c in f["choices"] if c["finish_reason"]]
    check(finishes == ["length"], f"{what}: finish reasons {finishes}")


def oai_stream_stats(recs: list, wall: float, tokens: int) -> dict:
    """tok/s over the wall, TTFT (the first frame with text) and the gap
    between text frames of a stream (p50, p99), in ms."""
    streams = [r for r in recs if "frames" in r]
    ttft = [oai_content_at(r)[0] - r["t0"] for r in streams]
    gaps = [b - a for r in streams
            for a, b in zip(oai_content_at(r), oai_content_at(r)[1:])]
    return {"requests": len(recs), "tokens": tokens, "wall_s": wall,
            "tok_per_s": tokens / wall,
            "ttft_ms_p50": 1e3 * pct(ttft, 0.5),
            "ttft_ms_p99": 1e3 * pct(ttft, 0.99),
            "chunk_gap_ms_p50": 1e3 * pct(gaps, 0.5),
            "chunk_gap_ms_p99": 1e3 * pct(gaps, 0.99),
            "streams": len(streams)}


async def oai_dense(app) -> dict:
    """13(a): three prompts alone (the same tokens over ``/generate``, the
    same text not streamed and streamed), CORS, then 32 calls at once: 16
    streamed chats with usage, 8 chats not streamed, 8 streamed
    completions, 64 new tokens each."""
    import aiohttp

    from gofr_tpu_torch.examples import openai_server as oai

    base = f"http://127.0.0.1:{app.http_port}"
    metrics_url = f"http://127.0.0.1:{app.metrics_port}/metrics"
    key = f'app_llm_tokens_total{{model="{oai.MODEL_ID}"}}'
    out: dict = {}
    async with aiohttp.ClientSession() as s:
        r = await s.options(base + "/v1/chat/completions")
        cors = {k: v for k, v in r.headers.items()
                if k.startswith("Access-Control-")}
        check(r.status == 200 and cors.get("Access-Control-Allow-Origin")
              == "*" and "POST" in cors.get("Access-Control-Allow-Methods",
                                            ""),
              f"openai: OPTIONS answered {r.status} with {cors}")
        out["options_cors"] = cors
        for text in oai_chat_texts(3, seed=22):
            messages = [{"role": "user", "content": text}]
            ids = oai.TOKENIZER.encode(oai._render_chat(messages))
            r = await s.post(base + "/generate", json={
                "prompt_ids": ids, "max_new_tokens": OAI_MAX_NEW})
            toks = (await r.json())["data"]["tokens"]
            body = {"messages": messages, "max_tokens": OAI_MAX_NEW}
            plain = await oai_call(s, base, "/v1/chat/completions", body)
            streamed = await oai_call(s, base, "/v1/chat/completions",
                                      {**body, "stream": True})
            dec = oai._StreamDecoder()
            want = "".join(dec.push(t) for t in toks) + dec.flush()
            check(len(toks) == OAI_MAX_NEW
                  and oai_text(plain) == oai._decode(toks)
                  and oai_text(streamed) == want,
                  f"openai: a prompt of {len(ids)} ids alone gives other "
                  f"text over /generate, not streamed and streamed")
        check(streamed["headers"].get("Access-Control-Allow-Origin") == "*"
              and streamed["headers"].get("X-Correlation-ID"),
              "openai: an SSE response lacks the CORS or correlation header")
        texts = oai_chat_texts(32, seed=21)
        calls = []
        for i, text in enumerate(texts):
            if i < 24:
                body = {"messages": [{"role": "user", "content": text}],
                        "max_tokens": OAI_MAX_NEW}
                if i < 16:
                    body.update(stream=True,
                                stream_options={"include_usage": True})
                calls.append(("/v1/chat/completions", body))
            else:
                calls.append(("/v1/completions", {
                    "prompt": text, "max_tokens": OAI_MAX_NEW,
                    "stream": True}))
        before = scrape(await (await s.get(metrics_url)).text()).get(key, 0)
        reset_launches()
        t = time.perf_counter()
        recs = await asyncio.gather(*(oai_call(s, base, path, body)
                                      for path, body in calls))
        wall = time.perf_counter() - t
        out["launches"] = read_launches()
        after = scrape(await (await s.get(metrics_url)).text()).get(key, 0)
    for i, (rec, (path, body)) in enumerate(zip(recs, calls)):
        chat = "chat" in path
        ids = oai.TOKENIZER.encode(oai._render_chat(body["messages"])
                                   if chat else body["prompt"])
        if body.get("stream"):
            check_oai_stream(f"openai call {i}", rec, chat)
        else:
            check(rec["status"] == 200
                  and rec["body"]["choices"][0]["finish_reason"] == "length",
                  f"openai call {i}: {rec['status']} {rec.get('body')}")
        usage = (rec["frames"][-2].get("usage") if "frames" in rec
                 else rec["body"]["usage"])
        if usage is not None:
            check(usage == {"prompt_tokens": len(ids),
                            "completion_tokens": OAI_MAX_NEW,
                            "total_tokens": len(ids) + OAI_MAX_NEW},
                  f"openai call {i}: usage {usage} for {len(ids)} ids")
    check(after - before == len(calls) * OAI_MAX_NEW,
          f"openai: app_llm_tokens_total moved {after - before} for "
          f"{len(calls)} calls of {OAI_MAX_NEW} tokens")
    out["front"] = oai_stream_stats(recs, wall, len(calls) * OAI_MAX_NEW)
    return out


async def oai_window(app, plan: list) -> list:
    """13(b): the capture window, each request sent at its offset."""
    import aiohttp

    base = f"http://127.0.0.1:{app.http_port}"
    async with aiohttp.ClientSession() as s:
        t0 = time.perf_counter()

        async def one(i, path, body, headers):
            await asyncio.sleep(max(0.0, t0 + i * OAI_SPACING_S
                                    - time.perf_counter()))
            return await oai_call(s, base, path, body, headers)

        return await asyncio.gather(*(one(i, *p) for i, p in
                                      enumerate(plan)))


def oai_plan(seed: int = 31) -> list:
    """The mixed window: 32 requests, streamed and not, priorities high,
    normal and low in turn; the even ones chats on one 512-byte system
    prompt, the odd ones chats and completions of their own."""
    system = oai_texts(1, 512, 512, seed)[0]
    users = oai_texts(32, 64, 400, seed + 1)
    plan = []
    for i, text in enumerate(users):
        stream = (i // 2) % 2 == 0
        headers = {"X-Request-Priority": ("high", "normal", "low")[i % 3]}
        if i % 2 == 0:
            path, body = "/v1/chat/completions", {"messages": [
                {"role": "system", "content": system},
                {"role": "user", "content": text[:256]}]}
        elif i % 4 == 1:
            path, body = "/v1/chat/completions", {
                "messages": [{"role": "user", "content": text}]}
        else:
            path, body = "/v1/completions", {"prompt": text}
        body.update(max_tokens=OAI_MAX_NEW, stream=stream)
        plan.append((path, body, headers))
    return plan


async def oai_burst_tok_s(app, texts) -> float:
    """All ``texts`` at once as chats not streamed: tokens a second."""
    import aiohttp

    base = f"http://127.0.0.1:{app.http_port}"
    async with aiohttp.ClientSession() as s:
        t = time.perf_counter()
        recs = await asyncio.gather(*(oai_call(
            s, base, "/v1/chat/completions",
            {"messages": [{"role": "user", "content": x}],
             "max_tokens": OAI_MAX_NEW}) for x in texts))
        wall = time.perf_counter() - t
    check(all(r["status"] == 200 for r in recs), "overhead: a call failed")
    return sum(r["body"]["usage"]["completion_tokens"] for r in recs) / wall


class ReplayTap:
    """A server proxy that keeps each replayed request's output, so a
    mismatch names its request."""

    def __init__(self, server) -> None:
        self.server = server
        self.name = server.name
        self.out: dict = {}

    async def stream_chunks(self, tokens, max_new, **kw):
        toks: list = []
        async for burst in self.server.stream_chunks(tokens, max_new, **kw):
            toks.extend(burst)
            yield burst
        self.out[tuple(tokens)] = toks


def gen_shape(gen) -> dict:
    """The arguments that rebuild ``gen``'s generator shape."""
    return {k: getattr(gen, k) for k in (
        "batch_slots", "max_seq", "chunk", "prefill_buckets", "page_size",
        "n_pages", "prefill_chunk")}


async def oai_capture_replay(cap_app, cap_llm, rep_app, rep_llm) -> tuple:
    """13(b) on two booted apps of the paged config: the capture app
    (``GOFR_ML_CAPTURE=256``) serves the window, ``/debug/capture`` is
    decoded with ``load_bundle`` and replayed at speed 1 on the other;
    then capture on against off, and a scripted crash with capture
    armed. Returns (results, bundle)."""
    import os
    import tempfile

    import aiohttp

    from gofr_tpu_torch.ml.capture import token_digest
    from gofr_tpu_torch.ml.replay import ReplayHarness, load_bundle

    out: dict = {}
    base = f"http://127.0.0.1:{cap_app.http_port}"
    plan = oai_plan()
    reset_launches()
    recs = await oai_window(cap_app, plan)
    out["capture_launches"] = read_launches()
    for i, rec in enumerate(recs):
        if rec["stream"]:
            check_oai_stream(f"capture call {i}", rec,
                             "chat" in plan[i][0])
        else:
            check(rec["status"] == 200, f"capture call {i}: {rec}")
    tmp = tempfile.mkdtemp(prefix="gofr-capture-")
    async with aiohttp.ClientSession() as s:
        r = await s.get(base + "/debug/capture")
        check(r.status == 200 and r.content_type
              == "application/octet-stream",
              f"capture: /debug/capture answered {r.status}")
        raw = await r.read()
    path = os.path.join(tmp, "window.gfrb")
    with open(path, "wb") as f:
        f.write(raw)
    bundle = load_bundle(path)
    rows = bundle["requests"]
    reasons = collections.Counter(r["finish_reason"] for r in rows)
    check(len(rows) == len(plan) and reasons == {"length": len(plan)},
          f"capture: {len(rows)} records, finish reasons {dict(reasons)}")
    out["bundle"] = {"bytes": len(raw), "requests": len(rows),
                     "modes": dict(collections.Counter(r["mode"]
                                                       for r in rows)),
                     "priorities": dict(collections.Counter(
                         r["priority"] for r in rows)),
                     "fleet": bundle["fleet"]}
    if cap_llm.prefix_cache is not None:
        snap = cap_llm.prefix_cache.snapshot()
        out["capture_prefix_cache"] = {k: snap[k] for k in (
            "hits", "misses", "prefill_tokens_saved")}
    tap = ReplayTap(rep_llm)
    reset_launches()
    verdict = await ReplayHarness(tap, bundle, speed=1.0).run()
    out["replay_launches"] = read_launches()
    bad = [{"prompt_ids": len(r["tokens"]), "mode": r["mode"],
            "priority": r["priority"]}
           for r in rows if token_digest(tap.out.get(tuple(r["tokens"]), []))
           != r["digest"]]
    out["replay"] = {k: verdict[k] for k in (
        "identity", "throughput", "ttft", "tpot", "goodput",
        "fingerprint_drift", "replay_failed", "wall_s")}
    out["replay"]["mismatched"] = bad
    print("13b replay: " + json.dumps(out["replay"]), flush=True)
    check(verdict["identity"]["rate"] == 1.0
          and verdict["identity"]["compared"] == len(rows),
          f"replay: digest identity {verdict['identity']} at bf16; "
          f"mismatched {bad}")
    check(verdict["goodput"]["balanced"], "replay: goodput delta unbalanced")
    check(verdict["fingerprint_drift"] == [],
          f"replay: drift {verdict['fingerprint_drift']}")
    texts = oai_texts(32, 64, 400, seed=33)
    await oai_burst_tok_s(rep_app, texts[:8])  # first traffic off
    runs: dict = {"on": [], "off": []}
    for arm in ("on", "off") * 3:
        runs[arm].append(await oai_burst_tok_s(
            cap_app if arm == "on" else rep_app, texts))
    import statistics

    out["capture_overhead"] = {
        "tok_per_s": runs, "median_on": statistics.median(runs["on"]),
        "median_off": statistics.median(runs["off"]),
        "on_over_off": (statistics.median(runs["on"])
                        / statistics.median(runs["off"]))}
    # a scripted step fault with capture armed: the crash bundle carries
    # the capture tail, and a saved body loads as a bundle
    fired = {"n": 0}

    def hook(point):
        if point == "step" and fired["n"] == 0:
            fired["n"] += 1
            raise RuntimeError("scripted step fault")

    cap_llm.gen.fault = hook
    async with aiohttp.ClientSession() as s:
        rec = await oai_call(s, base, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": texts[0]}],
            "max_tokens": OAI_MAX_NEW})
        cap_llm.gen.fault = None
        check(fired["n"] == 1 and rec["status"] == 503,
              f"crash: the fault fired {fired['n']} times, the call "
              f"answered {rec['status']}")
        r = await s.get(base + "/debug/crash")
        crashes = (await r.json())["data"]["crashes"]
        r = await s.get(base + f"/debug/crash/{crashes[-1]['id']}")
        body = await r.read()
    path = os.path.join(tmp, "crash.json")
    with open(path, "wb") as f:
        f.write(body)
    tail = load_bundle(path)
    from gofr_tpu_torch.examples import openai_server as oai

    crashed = oai.TOKENIZER.encode(oai._render_chat(
        [{"role": "user", "content": texts[0]}]))
    check(any(r["tokens"] == crashed for r in tail["requests"]),
          "crash: state.capture does not hold the crashed request")
    out["crash"] = {"id": crashes[-1]["id"],
                    "capture_tail": len(tail["requests"])}
    return out, bundle


def oai_tune(dev, params, cfg, bundle, shape: dict) -> dict:
    """13(c): ``Tuner`` over the window's bundle with ``default_grid()``,
    each arm a fresh ``Generator`` of the paged config (``shape``: the
    replay app's generator arguments) over the same parameter tensors,
    warmed up and replayed once at speed 1; then ``register_llm`` boots
    the emitted profile through ``GOFR_ML_PROFILE``."""
    import gc
    import os
    import tempfile

    from gofr_tpu_torch.ml.generate import Generator, Sampler
    from gofr_tpu_torch.ml.llm import LLMServer
    from gofr_tpu_torch.ml.tune import Tuner, default_grid

    def build(arm):
        gc.collect()
        torch.cuda.empty_cache()
        gen = Generator(params, cfg, device=dev, sampler=Sampler(), **shape)
        gen.warmup()  # every decode graph captured, as register_llm does
        return LLMServer(gen, name="tune-arm")

    # one scored pass an arm on its fresh server: a warm-up replay would
    # leave the prefix cache holding the window's system prompt, and the
    # scored pass would then prefill its first request another way than
    # the capture did (bf16: other bits)
    t = time.perf_counter()
    tuner = Tuner(bundle, build, default_grid(bundle), speed=1.0,
                  warmup=False)
    result = asyncio.run(tuner.run())
    out: dict = {"seconds": time.perf_counter() - t}
    out["scoreboard"] = [{k: row.get(k) for k in (
        "arm", "identity", "steady_tok_s", "tok_s", "ttft_p99_ms",
        "tpot_p99_ms", "goodput", "pruned_reason", "error", "score")}
        for row in result["scoreboard"]]
    print("13c scoreboard: " + json.dumps(out["scoreboard"]), flush=True)
    check(result["winner"] is not None,
          "tune: no arm survived the identity gate")
    profile = tuner.profile(result)
    out.update(winner=result["winner"]["arm"], knobs=profile["knobs"],
               speedup_vs_default=result.get("speedup_vs_default"))
    path = os.path.join(tempfile.mkdtemp(prefix="gofr-profile-"),
                        "tuned.json")
    with open(path, "w") as f:
        json.dump(profile, f)
    env0 = {k: os.environ.get(k) for k in profile["knobs"]}
    with knobs(GOFR_ML_PROFILE=path):
        app, llm, _ = oai_app(dev, params, **OAI_PAGED)

    async def serving():
        await app.start()
        try:
            import aiohttp

            async with aiohttp.ClientSession() as s:
                r = await s.get(f"http://127.0.0.1:{app.http_port}"
                                "/debug/serving")
                return (await r.json())["data"]["llms"]["gofr-llama"]
        finally:
            await app.shutdown()

    entry = asyncio.run(serving())
    check(entry.get("profile", {}).get("knobs") == profile["knobs"]
          and entry["profile"]["path"] == path,
          f"tune: /debug/serving shows {entry.get('profile')}")
    check({k: os.environ.get(k) for k in profile["knobs"]} == env0,
          "tune: the profile's knobs stayed in the environment")
    out["booted_profile"] = entry["profile"]
    del app, llm
    gc.collect()
    torch.cuda.empty_cache()
    return out


async def oai_profile_pause(app) -> dict:
    """13(d): 8 streams kept busy (SSE chats of 64-120 tokens, out of
    phase) and a ``GET /debug/profile?seconds=2``: the route's answer time
    and the longest gap between two frames of one stream that overlaps the
    capture, which must stay within ``OAI_PROFILE_GAP_S``; the trace must
    name the flash and decode kernels. For reference, the longest gap of
    the 4 s of serving just before the capture."""
    import aiohttp

    base = f"http://127.0.0.1:{app.http_port}"
    texts = oai_chat_texts(64, seed=41)
    streams: list = []
    stop = {"on": False}
    async with aiohttp.ClientSession() as s:
        async def worker(k):
            # staggered starts and lengths keep the 8 streams out of
            # phase: in lockstep, a stall that falls between two rounds
            # lands in every stream's wait for its first token, which no
            # frame gap sees
            await asyncio.sleep(0.15 * k)
            i = k
            while not stop["on"]:
                await oai_call(
                    s, base, "/v1/chat/completions",
                    {"messages": [{"role": "user",
                                   "content": texts[i % len(texts)]}],
                     "max_tokens": 64 + 8 * k, "stream": True},
                    live=streams)
                i += 8

        workers = [asyncio.ensure_future(worker(k)) for k in range(8)]
        await asyncio.sleep(1.5)  # every stream started
        b0 = time.perf_counter()
        await asyncio.sleep(4.0)  # serving with no capture, for reference
        b1 = t0 = time.perf_counter()
        r = await s.get(base + "/debug/profile", params={"seconds": "2"})
        data = await r.read()
        t1 = time.perf_counter()
        check(r.status == 200, f"profile: answered {r.status}")
        await asyncio.sleep(3.0)  # frames in flight across t1 land
        stop["on"] = True
        await asyncio.gather(*workers)
    def gaps_across(lo: float, hi: float) -> list:
        # between text frames of a stream: a live stream's cadence (the
        # role frame's wait for the first token is its TTFT)
        return [b - a for rec in streams
                for a, b in zip(oai_content_at(rec), oai_content_at(rec)[1:])
                if b > lo and a < hi]

    gaps = gaps_across(t0, t1)
    slices = trace_slices(data)
    names = {e["name"] for sl in slices for e in sl}
    out = {"answer_s": t1 - t0, "longest_gap_ms": 1e3 * max(gaps),
           "longest_gap_ms_no_capture": 1e3 * max(gaps_across(b0, b1)),
           "gaps": len(gaps), "zip_bytes": len(data),
           "slices": len(slices),
           "kernels": sum(len(sl) for sl in slices),
           "kernel_names": len(names),
           "flash_and_decode_named": (any("flash" in n for n in names)
                                      and any("decode" in n for n in names))}
    print("13d profile: " + json.dumps(out), flush=True)
    check(out["longest_gap_ms"] <= 1e3 * OAI_PROFILE_GAP_S,
          f"profile: a stream stalled {out['longest_gap_ms']} ms across a "
          f"capture")
    check(out["flash_and_decode_named"],
          "profile: the trace names no flash or decode kernel")
    return out


def openai_phase(dev, bf16_params) -> dict:
    """Phase 13: the OpenAI-compatible front, traffic capture and replay,
    the tuner and ``/debug/profile`` under serving on Llama-3-8B at full
    width (see the module docstring)."""
    import gc
    import os

    res: dict = {}
    t = time.perf_counter()
    app, llm, _ = oai_app(dev, bf16_params)

    async def dense():
        await app.start()
        try:
            res["dense"] = await oai_dense(app)
        finally:
            await app.shutdown()

    asyncio.run(dense())
    launches = res["dense"]["launches"]
    check(launches["flash_attention_cuda"] > 0
          and launches["gqa_decode_attention_cuda"] > 0
          and launches["gqa_decode_attention_int8_cuda"] == 0,
          f"openai: kernel launches {launches}")
    res["dense"]["seconds"] = time.perf_counter() - t
    print("13a openai dense: " + json.dumps(res["dense"]), flush=True)
    del app, llm
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    with knobs(GOFR_ML_CAPTURE="256"):
        cap_app, cap_llm, cfg = oai_app(dev, bf16_params, **OAI_PAGED)
        os.environ.pop("GOFR_ML_CAPTURE")
        rep_app, rep_llm, _ = oai_app(dev, bf16_params, **OAI_PAGED)
        os.environ["GOFR_ML_CAPTURE"] = "256"

        async def both():
            await cap_app.start()
            await rep_app.start()
            try:
                return await oai_capture_replay(cap_app, cap_llm, rep_app,
                                                rep_llm)
            finally:
                await cap_app.shutdown()
                await rep_app.shutdown()

        res["capture"], bundle = asyncio.run(both())
    res["capture"]["seconds"] = time.perf_counter() - t
    print("13b capture and replay: " + json.dumps(res["capture"]),
          flush=True)
    shape = gen_shape(rep_llm.gen)
    del cap_app, cap_llm, rep_app, rep_llm
    gc.collect()
    torch.cuda.empty_cache()
    res["tune"] = oai_tune(dev, bf16_params, cfg, bundle, shape)
    print("13c tune: " + json.dumps(res["tune"]), flush=True)
    t = time.perf_counter()
    app, llm, _ = oai_app(dev, bf16_params)

    async def profile():
        await app.start()
        try:
            return await oai_profile_pause(app)
        finally:
            await app.shutdown()

    res["profile"] = asyncio.run(profile())
    res["profile"]["seconds"] = time.perf_counter() - t
    del app, llm
    gc.collect()
    torch.cuda.empty_cache()
    return res


# -- phase 14: the fleet -----------------------------------------------------------

FLEET_MAX_NEW = 64
FLEET_PAGED = dict(LLM_PAGE_SIZE="16", LLM_PAGES="513", LLM_PREFILL_CHUNK="512")
FLEET_MAX_SEQ = 2048
# a stream that differs between two serving paths must differ on a bf16
# near-tie: the two tokens' logits at the first divergent step within
# this fraction of the logits' range (ROADMAP C)
FLEET_TIE = 5e-2


def fleet_app(dev, params, preset: str = "8b", mount_kw=None, **env):
    """Boot the port's example app (``mount`` on weights the caller holds:
    every replica shares them) with the fleet's knobs ``env``, pages of 16
    and ``prefill_chunk`` 512 (phase 9's paged arm), on free ports;
    ``mount_kw`` goes to ``register_llm``. Returns (app, cfg, boot
    seconds)."""
    from gofr_tpu_torch.app import new_app
    from gofr_tpu_torch.examples.llama_server import mount
    from gofr_tpu_torch.models import llama

    with knobs(LLAMA_PRESET=preset, LOG_LEVEL="ERROR", LLM_SLOTS="8",
               LLM_CHUNK="4", HTTP_PORT=str(free_port()),
               GRPC_PORT=str(free_port()), METRICS_PORT=str(free_port()),
               **FLEET_PAGED, **env):
        cfg = llama.config_from_env(tiny_vocab_size=257)
        cfg.n_layers = n_layers(params)  # the depth of the weights given
        app = new_app()
        t0 = time.perf_counter()
        mount(app, params, cfg, device=dev, max_seq=FLEET_MAX_SEQ,
              **(mount_kw or {}))
        boot_s = time.perf_counter() - t0
    return app, cfg, boot_s


async def counted(traffic):
    """Await the fleet traffic ``traffic`` with the launch counts set to 0
    just before and read just after, so that no reference run counts.
    Returns (result, launches)."""
    reset_launches()
    res = await traffic
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return res, read_launches()


def fleet_run(app, drive):
    """Start ``app``, run ``drive(clients, pool)``, shut the app down and
    free its memory. Returns what ``drive`` returns."""
    import gc

    async def run():
        await app.start()
        try:
            async with FrontClients(app) as c:
                check(await c.health() == 200, "fleet: health not 200")
                return await drive(c, app.container.ml.llm("chat"))
        finally:
            await app.shutdown()

    try:
        return asyncio.run(run())
    finally:
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def check_fleet_launches(what: str, launches: dict, dev, int8: bool) -> None:
    if dev.type != "cuda":
        return  # the plain path: no kernel on the CPU
    want, other = decode_kinds(int8)
    check(launches["flash_attention_cuda"] > 0 and launches[want] > 0,
          f"fleet {what}: kernels did not launch ({launches})")
    check(launches[other] == 0,
          f"fleet {what}: the other decode kernel launched ({launches})")


def near_tie(params, cfg, prompt, a: list, b: list) -> dict | None:
    """Where two greedy streams of ``prompt`` first differ: the step, and
    the two tokens' logit gap over the logits' range there (one plain
    ``llama.forward`` of the prompt and the common tokens). None when
    they are equal."""
    from gofr_tpu_torch.models import llama

    d = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if d is None:
        return None
    with torch.no_grad():
        row = llama.forward(params, [list(prompt) + list(a[:d])],
                            cfg)[0, len(prompt) + d - 1]
    gap = (row[a[d]] - row[b[d]]).abs().item()
    return {"step": d, "gap_over_range": gap / (row.max() - row.min()).item()}


def stream_agreement(what: str, params, cfg, prompts, got, want) -> dict:
    """The share of streams equal to the reference's; every difference
    must sit on a near-tie (``FLEET_TIE``)."""
    ties = []
    for p, a, b in zip(prompts, got, want, strict=True):
        tie = near_tie(params, cfg, p, a, b)
        if tie is not None:
            ties.append(tie)
            check(tie["gap_over_range"] <= FLEET_TIE,
                  f"fleet {what}: a stream differs at step {tie['step']} "
                  f"by {tie['gap_over_range']:.4f} of the logits' range")
    return {"equal_share": 1 - len(ties) / len(prompts),
            "differing": ties}


def single_replica_streams(dev, params, preset: str, prompts) -> tuple:
    """The reference of (a) and (b): a fresh single-replica app over the
    same weights with its prefix cache off (every prompt cold, as in the
    pool), ``prompts[0]`` alone and then all of ``prompts`` at once over
    gRPC. Returns (streams, the alone stream)."""
    app, _, _ = fleet_app(dev, params, preset,
                          mount_kw={"prefix_cache": False})
    body = {"max_new_tokens": FLEET_MAX_NEW}

    async def drive(c, llm):
        alone = await c.grpc({**body, "prompt_ids": prompts[0]})
        recs = await asyncio.gather(*(c.grpc({**body, "prompt_ids": p})
                                      for p in prompts))
        for r in (alone, *recs):
            check(r["status"] == "OK" and len(r["tokens"]) == FLEET_MAX_NEW,
                  f"fleet reference: a call answered {r['status']}")
        return [r["tokens"] for r in recs], alone["tokens"]

    streams = fleet_run(app, drive)
    del app
    return streams


def fleet_pool(dev, params, preset: str) -> dict:
    """(a) ``GOFR_ML_REPLICAS=2``: 32 requests x 64 tokens at once over
    gRPC into two 8-slot replicas on one card, against one replica on the
    same prompts (``single_replica_streams``); the replicas share the
    weights."""
    base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    app, cfg, boot_s = fleet_app(dev, params, preset, GOFR_ML_REPLICAS="2")
    prompts = front_prompts(cfg.vocab_size, 32, 64, 512, seed=0)

    async def drive(c, pool):
        check(len(pool.replicas) == 2
              and pool.replicas[0].gen.params is pool.replicas[1].gen.params
              is params, "fleet pool: the replicas do not share the weights")
        body = {"max_new_tokens": FLEET_MAX_NEW}
        t = time.perf_counter()
        recs, launches = await counted(asyncio.gather(
            *(c.grpc({**body, "prompt_ids": p}) for p in prompts)))
        wall = time.perf_counter() - t
        for r in recs:
            check(r["status"] == "OK" and len(r["tokens"]) == FLEET_MAX_NEW,
                  f"fleet pool: a call answered {r['status']} with "
                  f"{len(r['tokens'])} tokens")
        routed = pool.routing_snapshot()["routed"]
        check(all(sum(v.values()) > 0 for v in routed.values()),
              f"fleet pool: a replica took no request ({routed})")
        gens = [r.gen for r in pool.replicas]
        return {"recs": recs, "wall": wall, "routed": routed,
                "launches": launches,
                "page_pool_bytes": [_nbytes(g.cache) for g in gens],
                "graphs": [g.graph_stats() for g in gens]}

    res = fleet_run(app, drive)
    del app
    launches = res["launches"]
    check_fleet_launches("pool", launches, dev, False)
    tokens = sum(len(r["tokens"]) for r in res["recs"])
    out = {"boot_s": boot_s, "requests": len(prompts), "tokens": tokens,
           "wall_s": res["wall"], "tok_per_s": tokens / res["wall"],
           "tok_per_s_note": "two replicas share one card; not a "
                             "throughput figure",
           "routed": res["routed"], "launches": launches,
           "graphs": res["graphs"], "page_pool_bytes": res["page_pool_bytes"]}
    if dev.type == "cuda":
        weights = _nbytes(params)
        graph_pools = sum((g or {}).get("pool_reserved_bytes", 0)
                          for g in res["graphs"])
        added = torch.cuda.max_memory_allocated() - base
        predicted = sum(res["page_pool_bytes"]) + graph_pools
        out.update(weights_bytes=weights, added_peak_bytes=added,
                   predicted_added_bytes=predicted,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        # one copy of the weights (phase 3's, already resident): what the
        # pool adds is its two page pools, graph pools and activations,
        # far below a second copy of the weights
        check(added < weights, f"fleet pool: the pool added {added} bytes, "
              f"a second copy of the weights ({weights})")
    single, alone = single_replica_streams(dev, params, preset, prompts)
    out["vs_single_replica"] = stream_agreement(
        "pool", params, cfg, prompts, [r["tokens"] for r in res["recs"]],
        single)
    return out, alone, prompts[0]


def fleet_failover(dev, params, preset: str, prompt, alone) -> dict:
    """(b) a ``step`` fault on replica 0 past a restart budget of 0: the
    request re-admits on replica 1 with the tokens of one replica alone;
    health reads DEGRADED with replica 0 dead."""
    from gofr_tpu_torch.flight_recorder import event_log

    app, cfg, boot_s = fleet_app(
        dev, params, preset, GOFR_ML_REPLICAS="2", GOFR_ML_FAULT="step:1",
        GOFR_ML_FAULT_REPLICA="0", GOFR_ML_MAX_RESTARTS="0")

    async def drive(c, pool):
        mem0 = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        cursor = event_log().cursor
        t_send = time.time()
        rec, launches = await counted(c.grpc({
            "prompt_ids": prompt, "max_new_tokens": FLEET_MAX_NEW}))
        crash = event_log().query(since=cursor, model="chat",
                                  kind="crash")["events"]
        check(rec["status"] == "OK" and rec["tokens"] == alone,
              f"fleet failover: {rec['status']}, tokens equal to one "
              f"replica alone: {rec['tokens'] == alone}")
        check(crash and crash[0]["model"] == "chat/0",
              f"fleet failover: no crash on replica 0 ({crash})")
        status, text = await c.get(c.base + "/.well-known/health")
        body = json.loads(text)["data"]["ml"]
        replicas = body["details"]["llms"]["chat"]["replicas"]
        check(status == 200 and body["status"] == "DEGRADED"
              and replicas == {"0": "dead", "1": "serving"},
              f"fleet failover: health {status} {body['status']} "
              f"{replicas}")
        snap = pool.routing_snapshot()
        mem1 = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        return {"failover_ms": (t_send + rec["ttft_s"] - crash[0]["ts"])
                * 1e3,
                "client_ttft_ms": rec["ttft_s"] * 1e3,
                "health": {"status": body["status"], "replicas": replicas},
                "failovers": snap["failovers"], "routed": snap["routed"],
                "launches": launches,
                "memory_allocated_before": mem0,
                "memory_allocated_after": mem1,
                "bytes_given_back": mem0 - mem1}

    res = fleet_run(app, drive)
    del app
    check_fleet_launches("failover", res["launches"], dev, False)
    return {"boot_s": boot_s, "tokens_equal_no_fault": True, **res}


def fleet_disagg(dev, params, preset: str, int8: bool) -> dict:
    """(c) ``GOFR_ML_DISAGG=1``: two 1600-token prompts (a 1536-token
    prefix and a 64-token suffix) each prefill on replica 0 and ship to
    replica 1, which restores the pages and prefills only the tail; the
    first ship and a later one timed apart, TTFT against a cold prompt of
    the same length on one replica, tokens against one replica computing
    the same split."""
    from gofr_tpu_torch.ml.journey import journey_log

    env = {"GOFR_ML_REPLICAS": "2", "GOFR_ML_DISAGG": "1"}
    if int8:
        env.update(LLAMA_KV_QUANT="1", LLAMA_W8="1")
    app, cfg, boot_s = fleet_app(dev, params, preset, **env)
    r = np.random.default_rng(41)
    first, later, cold = (r.integers(0, cfg.vocab_size, SHARED_LEN + 64)
                          .tolist() for _ in range(3))

    async def ttft_on(core, prompt):
        t = time.perf_counter()
        agen = core.stream_chunks(prompt, FLEET_MAX_NEW)
        toks = list(await agen.__anext__())
        ttft = time.perf_counter() - t
        async for burst in agen:
            toks.extend(burst)
        return toks, ttft

    async def drive(c, pool):
        body = {"max_new_tokens": FLEET_MAX_NEW}

        async def ship_two():
            return [await c.grpc({**body, "prompt_ids": p})
                    for p in (first, later)]

        recs, launches = await counted(ship_two())
        for rec in recs:
            check(rec["status"] == "OK"
                  and len(rec["tokens"]) == FLEET_MAX_NEW,
                  f"fleet disagg: a call answered {rec['status']}")
        snap = pool.routing_snapshot()["disagg"]
        ships = pool._events.query(model="chat",
                                   kind="kv_ship")["events"][-2:]
        marks = []
        for ev in ships:
            j = journey_log().get(ev["rid"]).snapshot()
            marks.append({m["mark"]: round(m["dur_s"] * 1e3, 3)
                          for m in j["marks"]
                          if m["mark"] in ("ship", "land", "route", "admit",
                                           "prefill")})
        recorders = {name: core.recorder.snapshot()["totals_s"].get(name)
                     for name, core in (("ship", pool.replicas[0]),
                                        ("land", pool.replicas[1]))}
        restores = pool.replicas[1].gen.kv_restores
        # one replica computing the split the pool shipped: the prompt
        # less its last token (1600 is page-aligned) registered, the rest
        # prefilled over it
        core = pool.replicas[0]
        ship_ids = pool._ship_ids(first)
        pid = await asyncio.to_thread(core.register_prefix, ship_ids)
        ref = await core.generate(first[len(ship_ids):], FLEET_MAX_NEW,
                                  prefix=pid)
        _, cold_ttft = await ttft_on(pool.replicas[1], cold)
        return {"snap": snap, "marks": marks, "recs": recs, "ref": ref,
                "recorders_s": recorders, "cold_ttft": cold_ttft,
                "restores": restores, "launches": launches}

    res = fleet_run(app, drive)
    del app
    launches = res["launches"]
    what = "disagg int8" if int8 else "disagg bf16"
    check_fleet_launches(what, launches, dev, int8)
    snap = res["snap"]
    check(snap["ships"] == snap["lands"] == 2 and snap["failures"] == 0,
          f"fleet {what}: ships {snap['ships']} lands {snap['lands']} "
          f"failures {snap['failures']}")
    check(res["restores"] >= 2, f"fleet {what}: the decode replica restored "
          f"{res['restores']} prefixes")
    check(res["recs"][0]["tokens"] == res["ref"],
          f"fleet {what}: tokens differ from one replica on the same split")
    return {"boot_s": boot_s, "prompt_tokens": len(first),
            "ships": snap["ships"], "lands": snap["lands"],
            "failures": snap["failures"],
            "bytes_per_ship": snap["bytes_moved"] / snap["ships"],
            "mib_per_ship": snap["bytes_moved"] / snap["ships"] / 2**20,
            "journey_ms": {"first": res["marks"][0],
                           "later": res["marks"][1]},
            "recorder_s": res["recorders_s"],
            "ttft_ms": {"first": res["recs"][0]["ttft_s"] * 1e3,
                        "later": res["recs"][1]["ttft_s"] * 1e3,
                        "cold_one_replica": res["cold_ttft"] * 1e3},
            "tokens_equal_one_replica_split": True, "launches": launches}


def fleet_elastic(dev, params, preset: str) -> dict:
    """(d) ``GOFR_ML_ELASTIC=1`` from one replica under load (16 gRPC
    requests at a time): ``scale_to(2)`` (build, warmup, graph capture
    beside the serving replica's replays, pin backfill), a hot prefix on
    each replica, then ``scale_to(1)`` (migration and drain). No request
    fails; a fixed prompt's tokens before, during and after agree."""
    app, cfg, boot_s = fleet_app(dev, params, preset, GOFR_ML_ELASTIC="1",
                                 GOFR_ML_REPLICAS_MAX="2",
                                 GOFR_ML_ELASTIC_INTERVAL_S="3600")
    r = np.random.default_rng(43)
    fixed = r.integers(0, cfg.vocab_size, 300).tolist()
    hot = r.integers(0, cfg.vocab_size, 200).tolist()

    async def scale_events(c, pool):
        body = {"max_new_tokens": FLEET_MAX_NEW}
        check(pool.fleet_size() == 1, "fleet elastic: not at size 1")
        before = (await c.grpc({**body, "prompt_ids": fixed}))["tokens"]
        stop = asyncio.Event()
        recs: list = []

        async def traffic():
            seed = 5
            while not stop.is_set():  # fresh prompts: nothing promotes
                recs.extend(await asyncio.gather(*(
                    c.grpc({**body, "prompt_ids": p}) for p in
                    front_prompts(cfg.vocab_size, 16, 64, 512, seed=seed))))
                seed += 1

        loader = asyncio.create_task(traffic())
        await asyncio.sleep(0.5)
        migrate_ms: list = []
        migrate = pool._migrate_out

        def timed_migrate(idx):
            t = time.perf_counter()
            try:
                return migrate(idx)
            finally:
                migrate_ms.append((time.perf_counter() - t) * 1e3)

        pool._migrate_out = timed_migrate
        up = asyncio.create_task(asyncio.to_thread(pool.scale_to, 2))
        during = []
        while not up.done():
            during.append((await c.grpc({**body,
                                         "prompt_ids": fixed}))["tokens"])
        check(await up == 2, "fleet elastic: scale_to(2) did not reach 2")
        for _ in range(2):  # promoted on the replica scale_to(1) retires
            await pool.replicas[1].generate(hot, 8)
        during.append((await c.grpc({**body, "prompt_ids": fixed}))["tokens"])
        stop.set()
        await loader
        down = await asyncio.to_thread(pool.scale_to, 1)
        after = (await c.grpc({**body, "prompt_ids": fixed}))["tokens"]
        routing = pool.routing_snapshot()
        return {"before": before, "during": during, "after": after,
                "recs": recs, "down": down, "migrate_ms": migrate_ms,
                "events": routing["elastic"]["events"],
                "migrations": routing["elastic"]["migrations"],
                "routed": routing["routed"]}

    async def drive(c, pool):
        # every request and scale event here is the fleet's traffic
        res, launches = await counted(scale_events(c, pool))
        return {**res, "launches": launches}

    res = fleet_run(app, drive)
    del app
    launches = res["launches"]
    check_fleet_launches("elastic", launches, dev, False)
    failed = [r for r in res["recs"] if r["status"] != "OK"
              or len(r["tokens"]) != FLEET_MAX_NEW]
    check(not failed and res["recs"],
          f"fleet elastic: {len(failed)} of {len(res['recs'])} requests "
          f"failed")
    check(res["down"] == 1, "fleet elastic: scale_to(1) did not reach 1")
    led = res["migrations"] or {}
    check(led.get("ships", 0) == led.get("adoptions", 0)
          + led.get("failures", 0) and led.get("adoptions", 0) >= 1,
          f"fleet elastic: migration ledger {led}")
    ups = [e for e in res["events"] if e["kind"] == "scale_up"]
    downs = [e for e in res["events"] if e["kind"] == "scale_down"]
    check(ups and downs, f"fleet elastic: events {res['events']}")
    runs = [res["before"], *res["during"], res["after"]]
    agree = stream_agreement("elastic", params, cfg, [fixed] * len(runs),
                             runs, [res["before"]] * len(runs))
    return {"boot_s": boot_s, "requests_under_load": len(res["recs"]),
            "failed_requests": 0,
            "scale_up": {"time_to_routable_ms": ups[-1]["build_ms"],
                         "backfilled_pins": ups[-1]["backfilled_pins"]},
            "scale_down": {"wall_ms": downs[-1]["wall_ms"],
                           "migrated": downs[-1]["migrated"],
                           "migration_ms": res["migrate_ms"]},
            "migration_ledger": led,
            "migration_mib": led.get("bytes", 0) / 2**20,
            "fixed_prompt_runs": len(runs), "fixed_prompt_agreement": agree,
            "routed": res["routed"], "launches": launches}


def n_layers(params) -> int:
    w = params["layers"]["wq"]
    return (w["q"] if isinstance(w, dict) else w).shape[0]


def first_layers(params, n: int) -> dict:
    """``params`` (bf16 or w8) cut to its first ``n`` layers, as views."""
    return {**params, "layers": {
        k: ({q: t[:n] for q, t in v.items()} if isinstance(v, dict)
            else v[:n]) for k, v in params["layers"].items()}}


# phase 14 runs at this depth (of 32 layers), as phase 7 does, to keep the
# script inside its time limit once phase 15 joined it
FLEET_LAYERS = 16


def fleet_phase(dev, bf16_params, w8_params, preset: str = "8b") -> dict:
    """Phase 14: the replica pool, failover, disaggregated prefill/decode
    (bf16 and int8 pages) and the elastic fleet on Llama-3-8B at its
    published width and ``FLEET_LAYERS`` of its 32 layers (the first ones
    of phases 3 and 4's weights), through the port's example app over
    gRPC, two replicas sharing those weights on one card."""
    bf16_params = first_layers(bf16_params, FLEET_LAYERS)
    w8_params = first_layers(w8_params, FLEET_LAYERS)
    pool, alone, prompt = fleet_pool(dev, bf16_params, preset)
    return {
        "pool": pool,
        "failover": fleet_failover(dev, bf16_params, preset, prompt, alone),
        "disagg_bf16": fleet_disagg(dev, bf16_params, preset, int8=False),
        "disagg_int8": fleet_disagg(dev, w8_params, preset, int8=True),
        "elastic": fleet_elastic(dev, bf16_params, preset),
    }


# -- phase 15: HF import, training, checkpoints, serving what was trained ----------

# the training model: Llama-3-8B at its published width, cut to this many of
# its 32 layers (the first ones of phase 3's weights): params, grads, the
# f32 first moment and the bf16 second moment of all 32 layers alone would
# take ~80 GB
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_STEPS, TRAIN_REPEAT = 8, 6   # the first TRAIN_REPEAT steps: one batch
TRAIN_SAVE_AT = 3
TRAIN_MAX_NEW = 24


def _gpt2_chars() -> dict[int, str]:
    """byte -> the printable character byte-level BPE files write for it
    (GPT-2's table: printable bytes keep their codepoint, the rest map to
    256 + n)."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    out, n = {}, 0
    for b in range(256):
        if b in keep:
            out[b] = chr(b)
        else:
            out[b] = chr(256 + n)
            n += 1
    return out


def write_st(path: str, entries: list) -> int:
    """A plain safetensors writer (the format of the ``safetensors``
    package, which the card's machine does not have): ``entries`` are
    (name, dtype, shape, make) with ``make()`` giving the tensor, called
    one at a time while its bytes are written. Returns the bytes written."""
    import struct

    names = {torch.bfloat16: "BF16", torch.float32: "F32"}
    header, off = {}, 0
    for name, dtype, shape, _ in entries:
        n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        header[name] = {"dtype": names[dtype], "shape": list(shape),
                        "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name, dtype, shape, make in entries:
            t = make().contiguous()
            check(t.dtype == dtype and list(t.shape) == list(shape),
                  f"hf writer: {name} is {t.dtype} {tuple(t.shape)}")
            f.write(memoryview(t.cpu().reshape(-1).view(torch.uint8)
                               .numpy()))
    return 8 + len(head) + off


def write_hf_dir(path: str, params: dict, cfg) -> dict:
    """``params`` (the port's layout, of the shape of ``cfg``) as an HF
    Llama directory: ``config.json`` (Meta-Llama-3-8B's fields), two
    safetensors shards of ``[out, in]`` projections and per-layer names
    with ``model.safetensors.index.json``, and a small byte-level
    ``tokenizer.json`` (256 bytes, a few merges, Llama-3's two specials)."""
    import os

    os.makedirs(path)
    V, D = params["embed"].shape
    lay = params["layers"]
    norms = {"input_layernorm": "attn_norm",
             "post_attention_layernorm": "mlp_norm"}
    projs = {"self_attn.q_proj": "wq", "self_attn.k_proj": "wk",
             "self_attn.v_proj": "wv", "self_attn.o_proj": "wo",
             "mlp.gate_proj": "w_gate", "mlp.up_proj": "w_up",
             "mlp.down_proj": "w_down"}

    def layer_entries(i):
        out = []
        for hf, ours in norms.items():
            t = lay[ours]
            out.append((f"model.layers.{i}.{hf}.weight", t.dtype,
                        (t.shape[1],), lambda t=t: t[i]))
        for hf, ours in projs.items():
            t = lay[ours]
            out.append((f"model.layers.{i}.{hf}.weight", t.dtype,
                        (t.shape[2], t.shape[1]), lambda t=t: t[i].T))
        return out

    n_layers = cfg.n_layers
    half = n_layers // 2
    shards = [
        [("model.embed_tokens.weight", params["embed"].dtype, (V, D),
          lambda: params["embed"])]
        + [e for i in range(half) for e in layer_entries(i)],
        [e for i in range(half, n_layers) for e in layer_entries(i)]
        + [("model.norm.weight", params["final_norm"].dtype, (D,),
            lambda: params["final_norm"]),
           ("lm_head.weight", params["lm_head"].dtype, (V, D),
            lambda: params["lm_head"].T)]]
    weight_map, total = {}, 0
    for s, entries in enumerate(shards):
        fn = f"model-{s + 1:05d}-of-{len(shards):05d}.safetensors"
        total += write_st(os.path.join(path, fn), entries)
        weight_map.update({e[0]: fn for e in entries})
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    ffn = lay["w_gate"].shape[2]
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"architectures": ["LlamaForCausalLM"],
                   "model_type": "llama", "vocab_size": V, "hidden_size": D,
                   "intermediate_size": ffn, "num_hidden_layers": n_layers,
                   "num_attention_heads": cfg.n_heads,
                   "num_key_value_heads": cfg.n_kv_heads,
                   "max_position_embeddings": cfg.max_seq_len,
                   "rope_theta": cfg.rope_theta,
                   "rms_norm_eps": cfg.norm_eps, "bos_token_id": 128000,
                   "eos_token_id": 128001, "tie_word_embeddings": False,
                   "torch_dtype": "bfloat16"}, f)
    ch = _gpt2_chars()
    vocab = {ch[b]: b for b in range(256)}
    merges = []
    for pair in (b"he", b"ll", b"th", b"in", b" t", b"er", b"the"):
        left, right = ((pair[:1], pair[1:]) if len(pair) == 2
                       else (pair[:2], pair[2:]))
        enc = ["".join(ch[b] for b in part) for part in (left, right)]
        vocab[enc[0] + enc[1]] = len(vocab)
        merges.append(f"{enc[0]} {enc[1]}")
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        json.dump({"model": {"type": "BPE", "vocab": vocab,
                             "merges": merges},
                   "added_tokens": [
                       {"id": 128000, "content": "<|begin_of_text|>"},
                       {"id": 128001, "content": "<|end_of_text|>"}]}, f)
    return {"bytes": total, "shards": len(shards)}


class RssPeak:
    """The process's peak resident set (``VmRSS``) inside the block, sampled
    every 2 ms on a thread, over its value at the start."""

    def __enter__(self):
        import threading

        self.base = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    def _watch(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, self._rss())


def _leaves_equal(a: dict, b: dict) -> list[str]:
    """Paths of the leaves of two param trees that differ (moved to ``a``'s
    device one leaf at a time)."""
    bad = []
    for k in ("embed", "final_norm", "lm_head"):
        if not torch.equal(a[k], b[k].to(a[k].device)):
            bad.append(k)
    for k, v in a["layers"].items():
        if not torch.equal(v, b["layers"][k].to(v.device)):
            bad.append(f"layers/{k}")
    return bad


def train_import(dev, src: dict, cfg, work: str) -> tuple:
    """(a) ``src`` written as an HF directory, then ``import_hf_llama`` onto
    the card: every leaf bit for bit, seconds, GB/s and the host's peak
    RSS over its start. Returns (result, params, cfg, hf_dir)."""
    import os

    from gofr_tpu_torch.ml.hf_import import import_hf_llama

    hf_dir = os.path.join(work, "hf")
    t0 = time.perf_counter()
    wrote = write_hf_dir(hf_dir, src, cfg)
    write_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    with RssPeak() as rss:
        t0 = time.perf_counter()
        cfg, params = import_hf_llama(hf_dir, device=dev)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
    bad = _leaves_equal(params, src)
    check(not bad, f"hf import: leaves differ from the source: {bad}")
    model_bytes = _nbytes(params)
    rss_gb = (rss.peak - rss.base) / 1e9
    # one mapped tensor at a time: the embedding (1.05 GB) is the largest
    check(rss.peak - rss.base < 0.5 * model_bytes,
          f"hf import: host RSS rose {rss_gb:.2f} GB for a "
          f"{model_bytes / 1e9:.2f} GB model")
    return {"n_layers": cfg.n_layers, "dir_bytes": wrote["bytes"],
            "shards": wrote["shards"], "write_s": write_s,
            "import_s": import_s,
            "import_gb_per_s": model_bytes / import_s / 1e9,
            "model_gb": model_bytes / 1e9,
            "host_rss_peak_over_base_gb": rss_gb,
            "host_rss_base_gb": rss.base / 1e9,
            "leaves_bit_equal": True}, params, cfg, hf_dir


def train_batch(cfg, seed: int = 0):
    """The records of the training JSONL: ids drawn from ``seed``, one
    batch repeated ``TRAIN_REPEAT`` times, then fresh ones."""
    r = np.random.default_rng(seed)
    fresh = TRAIN_BATCH * (TRAIN_STEPS - TRAIN_REPEAT)
    rows = [r.integers(0, cfg.vocab_size, TRAIN_SEQ + 1).tolist()
            for _ in range(TRAIN_BATCH + fresh)]
    return rows[:TRAIN_BATCH] * TRAIN_REPEAT + rows[TRAIN_BATCH:]


def _example(rec: dict) -> dict:
    ids = np.asarray(rec["ids"], np.int32)
    return {"tokens": ids[:-1], "targets": ids[1:],
            "mask": np.ones(TRAIN_SEQ, np.int32)}


def _batch_tensors(rows, dev) -> tuple:
    ex = [_example({"ids": r}) for r in rows]
    return tuple(torch.from_numpy(np.stack([e[k] for e in ex])).to(dev)
                 for k in ("tokens", "targets", "mask"))


def train_grad_check(dev, params, cfg, tol: float) -> dict:
    """(c) One batch at the training shape: the loss and every gradient
    leaf through the flash kernel (``_FlashDiff``) against the plain
    attention; then the training-shape flash launch timed (``sweep_ms``)
    beside its plain version, the SDPA yardstick and its bound, and the
    plain backward the kernel's Function runs."""
    import functools

    import torch.nn.functional as F

    from gofr_tpu_torch.ml.train import _value_and_grad
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.ops.flash_attention import flash_attention_plain

    from gofr_tpu_torch.ml.tree import tree_map

    batch = _batch_tensors(train_batch(cfg)[:TRAIN_BATCH], dev)
    loss_fn = functools.partial(llama.loss_fn, cfg=cfg)
    k_loss, k_grads = _value_and_grad(loss_fn, params, *batch)
    # the kernel's gradients wait on the host while the plain ones are taken
    k_grads = tree_map(lambda t: t.to("cpu", copy=True), k_grads)
    kernel = llama.flash_attention
    llama.flash_attention = (lambda q, k, v, *, causal=True, kv_len=None:
                             flash_attention_plain(q, k, v, kv_len,
                                                   causal=causal))
    try:
        p_loss, p_grads = _value_and_grad(loss_fn, params, *batch)
    finally:
        llama.flash_attention = kernel
    cos = {}

    def cosine(path, a, b, chunk=1 << 26):
        """f64 sums over f32 chunks of the two flattened leaves."""
        a, b = a.reshape(-1), b.reshape(-1)
        dot = na = nb = 0.0
        for i in range(0, a.numel(), chunk):
            x = a[i:i + chunk].to(dev).double()
            y = b[i:i + chunk].double()
            dot += (x * y).sum().item()
            na += (x * x).sum().item()
            nb += (y * y).sum().item()
        cos[path] = dot / max((na * nb) ** 0.5, 1e-300)

    for k in ("embed", "final_norm", "lm_head"):
        cosine(k, k_grads[k], p_grads[k])
    for k, v in k_grads["layers"].items():
        cosine(f"layers/{k}", v, p_grads["layers"][k])
    del k_grads, p_grads
    loss_rel = abs(k_loss.item() - p_loss.item()) / abs(p_loss.item())
    check(loss_rel <= 1e-2, f"train grads: loss through the kernel "
          f"{k_loss.item()} vs plain {p_loss.item()}")
    check(min(cos.values()) >= 0.99,
          f"train grads: a gradient's cosine below 0.99: {cos}")

    # the training shape's flash launch, as the kernel table times it
    g = torch.Generator(device=dev).manual_seed(0)
    H, KV, D, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 8
    case = {"label": "train 2 x 2048", "B": TRAIN_BATCH, "T": TRAIN_SEQ,
            "Tk": TRAIN_SEQ, "q_offset": 0, "H": H, "KV": KV, "D": D,
            "L": L, "kv_len": None,
            "q": [rnd_bf16(g, dev, TRAIN_BATCH, TRAIN_SEQ, H, D)
                  for _ in range(L)],
            "k": [rnd_bf16(g, dev, TRAIN_BATCH, TRAIN_SEQ, KV, D)
                  for _ in range(L)],
            "v": [rnd_bf16(g, dev, TRAIN_BATCH, TRAIN_SEQ, KV, D)
                  for _ in range(L)]}
    row = measure_flash(case, tol)
    # the backward the Function runs (the plain attention's vjp) and SDPA's
    # forward + backward beside it, one layer's inputs, CUDA events
    q, k, v = (t[0].clone().requires_grad_(True)
               for t in (case["q"], case["k"], case["v"]))
    up = rnd_bf16(g, dev, TRAIN_BATCH, TRAIN_SEQ, H, D)

    def plain_bwd():
        out = flash_attention_plain(q, k, v, None, causal=True)
        torch.autograd.grad(out, (q, k, v), up)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)
        torch.autograd.grad(out, (q, k, v), up.transpose(1, 2))

    row["plain_fwd_bwd_ms"] = timed_ms(plain_bwd, iters=3, warm=1)
    row["library_fwd_bwd_ms"] = timed_ms(sdpa_fwd_bwd, iters=5, warm=2)
    del case, q, k, v, up
    torch.cuda.empty_cache()
    return {"loss_kernel": k_loss.item(), "loss_plain": p_loss.item(),
            "loss_rel_diff": loss_rel, "grad_cosine_min": min(cos.values()),
            "grad_cosine": cos, "flash_row": row}


def train_run(dev, params, cfg, work: str) -> dict:
    """(b) ``Trainer(llama.loss_fn)`` with ``adamw(3e-4, mu_dtype=f32)``
    over ``DataLoader(jsonl_source(...), batch_size=2, prefetch=2)``,
    ``TRAIN_STEPS`` steps, the launch counts set to 0 just before and read
    just after; the state saved with ``Checkpointer`` after step
    ``TRAIN_SAVE_AT``; then one more step split into forward + backward and
    the optimizer, under CUDA events. Returns the results plus what the
    resume and serving checks need."""
    import os

    from gofr_tpu_torch.ml.checkpoint import Checkpointer
    from gofr_tpu_torch.ml.data import DataLoader, jsonl_source
    from gofr_tpu_torch.ml.train import Trainer, _value_and_grad
    from gofr_tpu_torch.ml.tree import tree_map
    from gofr_tpu_torch.models import llama

    rows = train_batch(cfg)
    jsonl = os.path.join(work, "train.jsonl")
    with open(jsonl, "w") as f:
        for r in rows:
            f.write(json.dumps({"ids": r}) + "\n")
    loader = DataLoader(jsonl_source(jsonl), batch_size=TRAIN_BATCH,
                        prefetch=2, transform=_example, device=dev)

    def loss_fn(p, t, y, m):
        return llama.loss_fn(p, t, y, m, cfg)

    trainer = Trainer(loss_fn, params)
    ckpt_dir = os.path.join(work, "ckpt")
    ckpt = Checkpointer(ckpt_dir, max_to_keep=2)
    losses, step_s, per_step, saved = [], [], [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for b in loader:
        before = read_launches()
        t0 = time.perf_counter()
        losses.append(trainer.step(b["tokens"], b["targets"], b["mask"]))
        step_s.append(time.perf_counter() - t0)
        after = read_launches()
        per_step.append({k: after[k] - before[k] for k in after})
        if trainer.step_count == TRAIN_SAVE_AT:
            saved["host"] = tree_map(
                lambda t: t.detach().to("cpu", copy=True), trainer.params)
            state = {"params": trainer.params, "opt": trainer.opt_state,
                     "step": trainer.step_count}
            t0 = time.perf_counter()
            ckpt.save(TRAIN_SAVE_AT, state)
            saved["save_s"] = time.perf_counter() - t0
            saved["like"] = tree_map(
                lambda t: torch.empty_like(t, device="meta")
                if isinstance(t, torch.Tensor) else t, state)
            del state
    torch.cuda.synchronize()
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ckpt.close()
    check(len(losses) == TRAIN_STEPS, f"train: {len(losses)} steps")
    check(all(np.isfinite(losses)), f"train: a loss is not finite {losses}")
    check(losses[TRAIN_REPEAT - 1] < losses[0],
          f"train: the loss over the repeated batch did not fall {losses}")
    flash_per_step = [s["flash_attention_cuda"] for s in per_step]
    check(dev.type != "cuda" or all(n == 2 * cfg.n_layers
                                    for n in flash_per_step),
          f"train: flash launches a step {flash_per_step}, expected "
          f"{2 * cfg.n_layers} (forward and remat recompute a layer)")

    # one more step on the repeated batch, split under CUDA events into
    # the two calls the trainer's step makes (``make_train_step``)
    batch = _batch_tensors(rows[:TRAIN_BATCH], dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    _, grads = _value_and_grad(loss_fn, trainer.params, *batch)
    ev[1].record()
    trainer.opt_state = trainer.optimizer.apply(grads, trainer.opt_state,
                                                trainer.params)
    del grads
    ev[2].record()
    torch.cuda.synchronize()
    fwd_bwd_ms, opt_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])

    n_params = sum(t.numel() for t in (
        trainer.params["embed"], trainer.params["final_norm"],
        trainer.params["lm_head"], *trainer.params["layers"].values()))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = (6 * n_params * tokens + 3 * (2 * cfg.n_layers * cfg.n_heads
                                          * cfg.head_dim)
             * TRAIN_BATCH * TRAIN_SEQ ** 2)
    steady = sorted(step_s[1:])
    step_ms = 1e3 * steady[len(steady) // 2]
    ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt_dir, str(TRAIN_SAVE_AT),
                                                  f))
                     for f in os.listdir(os.path.join(ckpt_dir,
                                                      str(TRAIN_SAVE_AT))))
    del trainer, loader
    return {"result": {
        "n_layers": cfg.n_layers, "n_params": n_params, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "losses": losses,
        "step_ms": [1e3 * s for s in step_s], "step_ms_median": step_ms,
        "tokens_per_s": tokens / (step_ms / 1e3),
        "flops_per_step": flops,
        "tflops_per_s": flops / (step_ms / 1e3) / 1e12,
        "share_of_peak": flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
        "fwd_bwd_ms": fwd_bwd_ms, "optimizer_ms": opt_ms,
        "optimizer_share": opt_ms / (fwd_bwd_ms + opt_ms),
        "peak_allocated_gb": peak_gb, "launches": launches,
        "launches_per_step": per_step[-1],
        "checkpoint_bytes": ckpt_bytes, "save_s": saved["save_s"],
        "save_gb_per_s": ckpt_bytes / saved["save_s"] / 1e9},
        "ckpt_dir": ckpt_dir, "saved_host": saved["host"],
        "like": saved["like"], "batch_rows": rows[:TRAIN_BATCH]}


def train_resume(dev, cfg, run: dict) -> dict:
    """(d) The saved state restored (``like`` the training state, on the
    card) and one step resumed on step ``TRAIN_SAVE_AT + 1``'s batch: its
    loss against the uninterrupted run's, within 1e-3 relative (the
    embedding's backward accumulates with atomics on the card)."""
    from gofr_tpu_torch.ml.checkpoint import Checkpointer
    from gofr_tpu_torch.ml.train import Trainer
    from gofr_tpu_torch.models import llama

    ckpt = Checkpointer(run["ckpt_dir"])
    check(ckpt.latest_step() == TRAIN_SAVE_AT,
          f"resume: latest step {ckpt.latest_step()}")
    t0 = time.perf_counter()
    state = ckpt.restore(like=run["like"], device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(state["step"] == TRAIN_SAVE_AT, "resume: the step counter")
    bad = _leaves_equal(state["params"], run["saved_host"])
    check(not bad, f"resume: restored params differ from the saved: {bad}")
    trainer = Trainer(lambda p, t, y, m: llama.loss_fn(p, t, y, m, cfg),
                      state["params"])
    trainer.opt_state = state["opt"]
    del state
    resumed = trainer.step(*_batch_tensors(run["batch_rows"], dev))
    want = run["result"]["losses"][TRAIN_SAVE_AT]
    rel = abs(resumed - want) / abs(want)
    check(rel <= 1e-3, f"resume: step {TRAIN_SAVE_AT + 1}'s loss {resumed} "
          f"vs the uninterrupted run's {want}")
    del trainer
    return {"restore_s": restore_s,
            "restore_gb_per_s": run["result"]["checkpoint_bytes"]
            / restore_s / 1e9,
            "loss_uninterrupted": want, "loss_resumed": resumed,
            "rel_diff": rel, "exact": resumed == want}


def train_serve_arm(dev, what: str, cfg, saved: dict, **env) -> dict:
    """Boot the port's ``examples/llama_server`` on the trained or imported
    weights (``env``: ``LLAMA_CKPT`` and friends; ``cfg`` None boots
    ``main()``, which takes the architecture from the HF directory, else
    ``mount`` on ``params_from_config(cfg)`` restoring ``LLAMA_CKPT``), on
    free ports; 3 gRPC ``llm.Chat/Generate`` calls and one text
    ``POST /generate``, one at a time, with the launch counts read around
    them. Checks: the served weights equal ``saved`` (or quantize to what
    ``saved`` quantizes to under w8), and the greedy tokens equal a
    ``Generator`` built in process on the served tensors."""
    from gofr_tpu_torch.app import new_app
    from gofr_tpu_torch.examples import llama_server
    from gofr_tpu_torch.ml.generate import Generator
    from gofr_tpu_torch.models import llama

    with knobs(LOG_LEVEL="ERROR", LLM_SLOTS="4", LLM_CHUNK="4",
               HTTP_PORT=str(free_port()), GRPC_PORT=str(free_port()),
               METRICS_PORT=str(free_port()), **env):
        t0 = time.perf_counter()
        if cfg is None:
            app = llama_server.main(device=dev)
        else:
            app = llama_server.mount(
                new_app(), llama.params_from_config(cfg, device=dev), cfg,
                device=dev)
        boot_s = time.perf_counter() - t0
    gen = app.container.ml.llm("chat").gen
    served, scfg = gen.params, gen.cfg
    if scfg.w8:
        want = llama.quantize_weights(tree_to(saved, dev))
        bad = [k for k in ("wq", "w_down")
               if not torch.equal(served["layers"][k]["q"],
                                  want["layers"][k]["q"])]
        if not torch.equal(served["lm_head"]["q"], want["lm_head"]["q"]):
            bad.append("lm_head")
        del want
    else:
        bad = _leaves_equal(served, saved)
    check(not bad, f"serve {what}: served weights differ: {bad}")
    r = np.random.default_rng(5)
    room = min(scfg.max_seq_len, 1024) - TRAIN_MAX_NEW - 1
    prompts = [r.integers(0, min(scfg.vocab_size, 128000),
                          min(n, room)).tolist() for n in (17, 100, 300)]
    text = "the weather in the hills is fine"

    async def drive(c, llm):
        recs = []
        reset_launches()
        for p in prompts:
            recs.append(await c.grpc({"prompt_ids": p,
                                      "max_new_tokens": TRAIN_MAX_NEW}))
        resp = await c.session.post(c.base + "/generate", json={
            "prompt": text, "max_new_tokens": TRAIN_MAX_NEW})
        body = await resp.json()
        torch.cuda.synchronize()
        return recs, resp.status, body, read_launches()

    recs, status, body, launches = fleet_run(app, drive)
    check(all(r["status"] == "OK" and r["tokens"] for r in recs),
          f"serve {what}: a gRPC call failed {[r['status'] for r in recs]}")
    check(status == 201 and isinstance(body.get("data", {}).get("text"), str),
          f"serve {what}: POST /generate answered {status} {body}")
    check(dev.type != "cuda" or (launches["flash_attention_cuda"] > 0 and
                                 launches[decode_kinds(scfg.kv_quant)[0]]
                                 > 0),
          f"serve {what}: kernels did not launch ({launches})")
    ref = Generator(served, scfg, batch_slots=4,
                    max_seq=min(scfg.max_seq_len, 1024), chunk=4,
                    eos_id=getattr(scfg, "eos_id", None), device=dev)
    want_toks = [ref.generate(p, TRAIN_MAX_NEW) for p in prompts]
    check([r["tokens"] for r in recs] == want_toks,
          f"serve {what}: served tokens differ from an in-process "
          "Generator's on the same tensors")
    del ref, gen, served, app
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return {"boot_s": boot_s, "w8": scfg.w8,
            "eos_id": getattr(scfg, "eos_id", None),
            "tokens": [len(r["tokens"]) for r in recs],
            "text_tokens": len(body["data"]["tokens"]),
            "launches": launches}


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def leftovers() -> dict:
    """Before phase 15: what the earlier phases leave on the card. Every
    app they booted is shut down, and a shut-down app must not stay
    reachable with its models: none of their ``MLDatasource`` or
    ``Generator`` objects may be alive. The memory allocated then."""
    import gc

    from gofr_tpu_torch.ml import MLDatasource
    from gofr_tpu_torch.ml.generate import Generator

    gc.collect()
    torch.cuda.empty_cache()
    alive = {"datasources": 0, "generators": 0}
    for o in gc.get_objects():
        if isinstance(o, MLDatasource):
            alive["datasources"] += 1
        elif isinstance(o, Generator):
            alive["generators"] += 1
    del o
    check(not any(alive.values()),
          f"shut-down apps are still alive with their models: {alive}")
    return {"alive": alive,
            "allocated_gb": torch.cuda.memory_allocated() / 1e9}


def training_phase(dev, bf16_params, base=None, tol: float = 2e-2) -> dict:
    """Phase 15: HF import, training, checkpoints and serving what was
    trained (see the module docstring), on Llama-3-8B at its published
    width (``base``, default ``llama3_8b()``, the config of
    ``bf16_params``) cut to ``TRAIN_LAYERS`` layers of phase 3's weights."""
    import gc
    import os
    import shutil
    import tempfile

    from gofr_tpu_torch.ml.hf_import import hf_config
    from gofr_tpu_torch.models import llama

    def cut(**kw):
        b = base or llama.llama3_8b()
        return llama.LlamaConfig(
            vocab_size=b.vocab_size, dim=b.dim, n_layers=TRAIN_LAYERS,
            n_heads=b.n_heads, n_kv_heads=b.n_kv_heads, ffn_dim=b.ffn_dim,
            max_seq_len=b.max_seq_len, rope_theta=b.rope_theta,
            norm_eps=b.norm_eps, **kw)

    src = {**bf16_params, "layers": {
        k: v[:TRAIN_LAYERS] for k, v in bf16_params["layers"].items()}}
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    out = {}
    try:
        t0 = time.perf_counter()
        out["import"], params, cfg, hf_dir = train_import(dev, src, cut(),
                                                          work)
        cfg = hf_config(hf_dir, remat=True)
        out["grad_check"] = train_grad_check(dev, params, cfg, tol)
        run = train_run(dev, params, cfg, work)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out["train"] = run["result"]
        out["resume"] = train_resume(dev, cfg, run)
        saved = run.pop("saved_host")
        del run
        gc.collect()
        torch.cuda.empty_cache()
        out["serve"] = {
            "checkpointer": train_serve_arm(
                dev, "checkpointer", cut(), saved,
                LLAMA_CKPT=os.path.join(work, "ckpt")),
            "checkpointer_w8": train_serve_arm(
                dev, "checkpointer w8", cut(w8=True), saved,
                LLAMA_CKPT=os.path.join(work, "ckpt")),
            "hf": train_serve_arm(
                dev, "hf", None, src, LLAMA_CKPT=hf_dir,
                TOKENIZER_JSON=os.path.join(hf_dir, "tokenizer.json")),
        }
        out["phase_s"] = time.perf_counter() - t0
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)



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
        took = time.perf_counter() - t0
        print(f"{what} ({took:.1f} s): " + json.dumps(result))
        if out_dir is not None:  # each phase's seconds, as it ends
            out_dir.mkdir(parents=True, exist_ok=True)
            with open(out_dir / "phases.txt", "a") as f:
                f.write(f"{what}\t{took:.1f}\n")
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
    spec = speculation_phase(dev, bf16_params)
    done("speculation", spec)
    reset_launches()
    engine = engine_phase(dev, card)
    engine["launches"] = read_launches()
    done("the engine path", engine)
    oai = openai_phase(dev, bf16_params)
    done("the OpenAI front, capture, replay and the tuner", oai)
    fleet = fleet_phase(dev, bf16_params, w8_params)
    done("the fleet", fleet)
    # phase 15 reckons its memory on top of phases 3 and 4's weights: what
    # the earlier phases leave is listed first; past 5 GB of it the w8
    # weights go too
    held = leftovers()
    resident = (_nbytes(bf16_params) + _nbytes(w8_params["layers"])
                + _nbytes(w8_params["lm_head"]))
    held["leftover_gb"] = held["allocated_gb"] - resident / 1e9
    held["w8_params_freed"] = held["leftover_gb"] > 5
    if held["w8_params_freed"]:
        del w8_params
        import gc

        gc.collect()
        torch.cuda.empty_cache()
        held["allocated_without_w8_gb"] = torch.cuda.memory_allocated() / 1e9
    done("memory before phase 15", held)
    train = training_phase(dev, bf16_params)
    train["memory_before"] = held
    done("HF import, training, checkpoints, serving the trained weights",
         train)
    # the training shape's flash launch joins the kernel's timed shapes
    rows[0]["by_shape"].append(train["grad_check"]["flash_row"])
    rows += spec["kernels"]
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
                                  "paged_int8")},
                   "spec_lookup_off": spec["lookup"]["off"]["launches"][
                       row["name"]],
                   "spec_lookup": spec["lookup"]["on"]["launches"][
                       row["name"]],
                   "spec_paged_int8": spec["paged_int8"]["graph"][
                       "launches"][row["name"]],
                   "spec_draft_self": spec["draft_self"]["launches"][
                       row["name"]],
                   "engine": engine["launches"][row["name"]],
                   "openai_dense": oai["dense"]["launches"][row["name"]],
                   "openai_capture": oai["capture"]["capture_launches"][
                       row["name"]],
                   "openai_replay": oai["capture"]["replay_launches"][
                       row["name"]],
                   **{f"fleet_{arm}": fleet[arm]["launches"][row["name"]]
                      for arm in ("pool", "failover", "disagg_bf16",
                                  "disagg_int8", "elastic")},
                   "train": train["train"]["launches"][row["name"]],
                   **{f"train_serve_{arm}": train["serve"][arm]["launches"][
                       row["name"]] for arm in ("checkpointer",
                                                "checkpointer_w8", "hf")}}
        own = {"gqa_decode_attention_int8_cuda": "int8",
               "gqa_decode_window_cuda": "spec_lookup",
               "gqa_decode_window_int8_cuda": "spec_paged_int8"}.get(
                   row["name"], "bf16")
        row["launches"] = by_path[own]
        row["launches_by_path"] = by_path
        row["kernel_ms"] = row["ms"]
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "chip_smoke.json").write_text(json.dumps(
            {"card": card, "kernels": rows, "bf16": path, "int8": qpath,
             "paged": ppath, "graphs": graphs, "windows": windows,
             "host_tier": tier, "front": front, "resilience": res,
             "speculation": spec, "engine": engine, "openai": oai,
             "fleet": fleet, "training": train},
            indent=1))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
