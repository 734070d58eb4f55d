"""PyTorch port, the depth-2 dispatch pipeline (``GOFR_ML_PIPELINE``),
held against the JAX package's pipelined Generator on the tiny config at
f32, the twin of ``tests/test_pipeline.py``'s knob, environment, unset and
identity tests.

The contracts: the knob validates as JAX's does; with it unset nothing of
the pipeline is built and output is byte-identical; with two dispatches
in flight the greedy tokens equal the JAX pipelined Generator's and the
lag-one loop's — plain chunks, fused windows, the token-budget scheduler
and int4 pages — and the overlap and overshoot counters equal JAX's;
behind ``LLMServer`` the tokens are a plain server's and a deadline reaped
mid-overlap fails only its own request. The twins of the resilience and
observability tests: overshoot of rows dead at settle is charged to the
goodput ledger as JAX charges it; a crash with two windows in flight
fails only the slots in flight and leaves nothing in flight; ``recover``
drops both windows; journey marks carry the in-flight depth; dispatch
records carry the overlap dim and the device-idle estimate; the serving
snapshot has the pipeline block only when armed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.ml.generate import pipeline_from_env as jpipeline
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch.ml.generate import Generator, pipeline_from_env
from gofr_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.timeout(300)

PROMPTS = ([3, 1, 4, 1], [2, 7, 1, 8])
KW = dict(batch_slots=2, max_seq=64, prefill_buckets=(8, 16), page_size=8)


def _pair(kv_bits=16):
    kw = {} if kv_bits == 16 else {"kv_bits": kv_bits}
    jcfg = jllama.tiny_llama(dtype=jnp.float32, use_flash=False, **kw)
    tcfg = tllama.tiny_llama(dtype=torch.float32, **kw)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _both(pair, scenario, **kw):
    """``scenario(gen)`` on the JAX Generator and on the port's, built with
    the same options; returns (JAX result, port result, port generator)."""
    jcfg, jparams, tcfg, tparams = pair
    want = scenario(JGenerator(jparams, jcfg, **{**KW, **kw}))
    gen = Generator(tparams, tcfg, device="cpu", **{**KW, **kw})
    return want, scenario(gen), gen


def _tgen(pair, **kw):
    _, _, tcfg, tparams = pair
    return Generator(tparams, tcfg, device="cpu", **{**KW, **kw})


def _serve(gen, prompts=PROMPTS, max_new=(10, 7)):
    outs: dict[int, list[int]] = {}

    def cb(slot):
        def f(_s, toks):
            outs.setdefault(slot, []).extend(int(t) for t in toks)
        return f

    for i, (p, n) in enumerate(zip(prompts, max_new, strict=True)):
        gen.add_request(list(p), n, callback=cb(i))
    for _ in range(200):
        if gen.n_live == 0:
            break
        gen.step()
    gen.drain()
    return outs


def _counted(gen):
    """The served tokens with the pipeline's and window's counters."""
    out = _serve(gen)
    pipe = gen.pipeline_stats()
    win = gen.window_stats()
    return (out, pipe and {k: pipe[k] for k in ("depth", "windows_overlapped",
                                                "overshoot_tokens")},
            win and {k: win[k] for k in ("windows", "steps_planned",
                                         "steps_realized",
                                         "overshoot_tokens")})


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for name in ("GOFR_ML_DECODE_WINDOW", "GOFR_ML_PIPELINE",
                 "GOFR_ML_SPEC_K", "GOFR_ML_TOKEN_BUDGET",
                 "GOFR_ML_KV_HOST_BUDGET_MB"):
        monkeypatch.delenv(name, raising=False)


# -- the knob -------------------------------------------------------------------

@pytest.mark.parametrize("raw", ["", "0", "off", "1", "on", " ON ", "2",
                                 "banana", "true"])
def test_pipeline_knob_validation(monkeypatch, raw):
    """Each value parses as JAX parses it, or raises the same message."""
    monkeypatch.setenv("GOFR_ML_PIPELINE", raw)
    try:
        want = jpipeline()
    except ValueError as exc:
        with pytest.raises(ValueError, match="GOFR_ML_PIPELINE") as got:
            pipeline_from_env()
        assert str(got.value) == str(exc)
        return
    assert pipeline_from_env() == want


def test_pipeline_env_pickup(pair, monkeypatch):
    monkeypatch.setenv("GOFR_ML_PIPELINE", "1")
    assert _tgen(pair).pipeline == 1
    # an explicit constructor argument beats the environment
    assert _tgen(pair, pipeline=0).pipeline == 0


def test_pipeline_unset_constructs_nothing(pair):
    """Knob unset: no pipeline state (the is-not-None contract) and the
    output is byte-identical to an explicit pipeline=0 generator."""
    gen = _tgen(pair, decode_window=4)
    assert gen.pipeline == 0
    assert gen.pipeline_stats() is None
    assert not hasattr(gen, "pipeline_windows")
    assert not hasattr(gen, "pipeline_overshoot")
    assert _serve(gen) == _serve(_tgen(pair, decode_window=4, pipeline=0))


# -- greedy identity against JAX and against the lag-one loop --------------------

def test_pipelined_chunk_greedy_identity(pair):
    """Plain chunks (no windows): double-buffering changes no token."""
    exp = _serve(_tgen(pair))
    want, got, gen = _both(pair, _counted, pipeline=1)
    assert got == want and got[0] == exp
    assert got[1]["depth"] == 2 and got[1]["windows_overlapped"] >= 1


def test_pipelined_window_greedy_identity(pair):
    exp = _serve(_tgen(pair, decode_window=0))
    want, got, gen = _both(pair, _counted, decode_window=4, pipeline=1)
    assert got == want and got[0] == exp
    assert gen.pipeline_stats()["windows_overlapped"] >= 1
    assert gen.window_stats()["windows"] >= 1


def test_pipelined_window_identity_with_budget_scheduler(pair):
    """The scheduler plans window N+1 from N's planned state: the grant
    subtraction of windows in flight keeps the budget honest at depth 2."""
    exp = _serve(_tgen(pair, decode_window=0, token_budget=64))
    want, got, gen = _both(pair, _counted, decode_window=4, token_budget=64,
                           pipeline=1)
    assert got == want and got[0] == exp
    assert gen.scheduler.window_mode is True


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_pipelined_quantized_kv_identity(kv_bits):
    p = _pair(kv_bits)
    exp = _serve(_tgen(p, decode_window=4))
    want, got, _ = _both(p, _counted, decode_window=4, pipeline=1)
    assert got == want and got[0] == exp


def test_pipeline_overshoot_counted_like_jax(pair):
    """A slot that dies while a window sits in flight behind another: its
    tokens are the double buffer's overshoot, as many as JAX counts."""
    def scenario(gen):
        slot = gen.add_request([3, 1, 4, 1], 30)
        gen.step()  # the mini dispatch
        gen.step()
        gen.step()  # two windows in flight
        gen.slots[slot].live = False
        gen.drain()
        return gen.pipeline_overshoot, gen.window_overshoot

    want, got, _ = _both(pair, scenario, decode_window=4, pipeline=1)
    assert got == want and sum(got) > 0


# -- behind the server ----------------------------------------------------------

def test_server_with_windows_and_pipeline_matches_plain(pair, run):
    """Concurrent callers through LLMServer over a windowed, pipelined
    generator get the tokens of a plain one; the server's snapshot shows
    both blocks."""
    import asyncio

    from gofr_tpu_torch.ml.llm import LLMServer

    prompts = [[3, 1, 4, 1, 5], [2, 7], [9, 9, 2, 6], [8, 1, 8, 2, 8, 4]]

    async def scenario(**kw):
        server = LLMServer(_tgen(pair, **kw), prefix_cache=False)
        try:
            outs = await asyncio.gather(*(
                server.generate(p, 9, deadline_s=60.0) for p in prompts))
            return outs, server.snapshot()
        finally:
            server.close()

    plain, _ = run(scenario())
    got, snap = run(scenario(decode_window=4, pipeline=1))
    assert got == plain
    assert snap["window"]["windows"] >= 1 and snap["pipeline"]["depth"] == 2
    assert snap["scheduler"]["plans"] == "windows"


def test_deadline_reap_mid_overlap(pair, run, monkeypatch):
    """The reaper cancels a slot while its next window is already in
    flight: the caller gets DeadlineExceeded, the in-flight tokens are
    never delivered, and the server goes on serving."""
    import asyncio
    import time

    from gofr_tpu_torch.ml.errors import DeadlineExceeded
    from gofr_tpu_torch.ml.llm import LLMServer

    gen = _tgen(pair, decode_window=4, pipeline=1)
    slow = gen._decode_window

    def slowed(*args, **kw):
        time.sleep(0.05)
        return slow(*args, **kw)

    monkeypatch.setattr(gen, "_decode_window", slowed)
    server = LLMServer(gen, prefix_cache=False)

    async def scenario():
        got = []
        with pytest.raises(DeadlineExceeded):
            async for burst in server.stream_chunks([3, 1, 4], 50,
                                                    deadline_s=0.3):
                got.extend(burst)
        after = await server.generate([2, 7, 1, 8], 5)
        return got, after

    try:
        got, after = run(scenario())
    finally:
        server.close()
    assert len(got) < 50 and len(after) == 5
    assert server.deadline_expired == 1
    assert gen.windows >= 2 and server.health() == "dead"  # closed


# -- resilience and observability (the JAX twins) ---------------------------------

def test_pipeline_overshoot_charged_to_goodput(pair):
    """Twin of test_pipeline.py::test_pipeline_overshoot_charged_to_goodput:
    a slot reaped with TWO windows in flight has everything they computed
    for it charged as pipeline_overshoot, equal to JAX's charge."""
    from gofr_tpu.ml.goodput import GoodputLedger as JLedger
    from gofr_tpu_torch.ml.goodput import WASTE_REASONS, GoodputLedger

    assert "pipeline_overshoot" in WASTE_REASONS

    def scenario(gen, ledger):
        gen.goodput = ledger.handle("pp-over")
        slot = gen.add_request([3, 1, 4, 1], 16, callback=lambda s, t: None)
        gen.step()  # mini dispatch (first token), drains synchronously
        gen.step()  # window A in flight
        gen.step()  # window B from A's planned state: depth 2
        assert len(gen._inflight) == 2
        gen.slots[slot].live = False  # the serving reaper's cancel
        gen.drain()
        return (ledger.snapshot_model("pp-over"), gen.pipeline_overshoot,
                gen.window_overshoot)

    want, _, _ = _both(pair, lambda g: scenario(g, JLedger()),
                       decode_window=4, pipeline=1)
    got, over, win_over = scenario(_tgen(pair, decode_window=4, pipeline=1),
                                   GoodputLedger())
    assert over > 0 and win_over == 0
    assert got["wasted"] == want[0]["wasted"] == {"pipeline_overshoot": over}
    assert got["delivered"] == 0
    assert got["device_tokens"] == got["delivered"] + got["wasted_total"]


def _chaos_with_two_in_flight(server, run):
    box = {"fired": 0}

    def hook(point):
        if (point == "step" and box["fired"] == 0
                and len(server.gen._inflight) >= 2):
            box["fired"] += 1
            raise RuntimeError("chaos with two windows in flight")

    server.gen.fault = hook

    async def scenario():
        async def one(p):
            try:
                return await server.generate(p, 8, deadline_s=30.0)
            except Exception as exc:
                return type(exc).__name__
        return await asyncio.gather(*(one(p) for p in (
            [3, 1, 4], [2, 7, 1, 8], [5, 9, 2], [6, 2, 6])))

    import asyncio

    try:
        outs = run(scenario())
    finally:
        server.close()
    return box["fired"], outs


def test_crash_with_two_windows_in_flight(pair, run):
    """Twin of test_pipeline.py::test_crash_with_two_windows_in_flight:
    the watchdog fails only the slots in flight, the queued requests
    survive with JAX's tokens, nothing stays in flight, the ledger
    balances; the victims and outputs equal the JAX server's."""
    from gofr_tpu.ml.llm import LLMServer as JServer
    from gofr_tpu_torch.ml.goodput import goodput_ledger
    from gofr_tpu_torch.ml.llm import LLMServer

    jcfg, jparams, _, _ = pair
    jserver = JServer(JGenerator(jparams, jcfg, **KW, decode_window=4,
                                 pipeline=1), name="pp-chaos-j",
                      max_restarts=3)
    jfired, want = _chaos_with_two_in_flight(jserver, run)
    server = LLMServer(_tgen(pair, decode_window=4, pipeline=1),
                       name="pp-chaos", max_restarts=3)
    fired, got = _chaos_with_two_in_flight(server, run)
    assert fired == jfired == 1
    assert got == want
    assert sum(isinstance(o, list) for o in got) >= 2
    assert "GeneratorCrashed" in got
    assert len(server.gen._inflight) == 0
    snap = goodput_ledger().snapshot_model("pp-chaos")
    assert snap["wasted"].get("crashed", 0) >= 1
    assert (snap["delivered"] + sum(snap["wasted"].values())
            == snap["device_tokens"] == server.gen.tokens_computed)


def test_recover_drops_both_inflight_windows(pair):
    """Twin of test_pipeline.py::test_recover_drops_both_inflight_windows,
    plus the in-place contract: recovery rebinds no tensor a graph reads."""
    gen = _tgen(pair, decode_window=4, pipeline=1)
    gen.add_request([3, 1, 4, 1], 16, callback=lambda s, t: None)
    gen.step()
    gen.step()
    gen.step()
    assert len(gen._inflight) == 2
    ptrs = {k: v.data_ptr() for k, v in gen.cache.items()}
    ptrs.update(tok=gen._tok_dev.data_ptr(), table=gen._table_dev.data_ptr(),
                active=gen._win_active.data_ptr(),
                cap=gen._win_cap.data_ptr())
    free0 = gen.free_pages
    gen.recover()
    assert len(gen._inflight) == 0 and gen.restarts == 1
    assert gen.free_pages > free0  # the slot's pages went back
    after = {k: v.data_ptr() for k, v in gen.cache.items()}
    after.update(tok=gen._tok_dev.data_ptr(), table=gen._table_dev.data_ptr(),
                 active=gen._win_active.data_ptr(),
                 cap=gen._win_cap.data_ptr())
    assert after == ptrs
    outs = _serve(gen, prompts=([2, 7, 1, 8],), max_new=(6,))
    fresh = _serve(_tgen(pair, decode_window=4, pipeline=1),
                   prompts=([2, 7, 1, 8],), max_new=(6,))
    assert outs == fresh and len(outs[0]) == 6


def test_journey_decode_marks_carry_inflight_depth(pair, run):
    """Twin of test_pipeline.py::test_journey_decode_marks_carry_inflight_depth."""
    from gofr_tpu_torch.ml.journey import journey_log
    from gofr_tpu_torch.ml.llm import LLMServer

    server = LLMServer(_tgen(pair, decode_window=4, pipeline=1),
                       name="pp-journey")

    async def scenario():
        return await server.generate([3, 1, 4, 1], 12)

    try:
        out = run(scenario())
    finally:
        server.close()
    assert len(out) == 12
    rid = journey_log().snapshot()["recent_rids"][-1]
    waterfall = journey_log().get(rid).snapshot()
    depths = [m["inflight"] for m in waterfall["marks"]
              if m["mark"] in ("prefill", "decode")]
    assert depths and all(0 <= d <= 2 for d in depths)
    assert any(d == 2 for d in depths)


def test_recorder_overlap_dim_and_idle_share(pair):
    """Twin of test_pipeline.py::test_recorder_overlap_dim_and_idle_share:
    double-buffered passes stamp the overlap dim and busy seconds, and
    ``pipeline_stats`` surfaces the recorder's idle estimate (no longer
    None)."""
    from gofr_tpu_torch.flight_recorder import DispatchRecorder

    gen = _tgen(pair, decode_window=4, pipeline=1)
    rec = DispatchRecorder(model="pp-rec", ring=64)
    gen.recorder = rec
    gen.add_request([3, 1, 4, 1], 12, callback=lambda s, t: None)
    for _ in range(50):
        if gen.n_live == 0:
            break
        gen.step()
        rec.commit()
    gen.drain()
    rec.commit()
    tail = rec.tail(64)
    assert any(r.get("overlap", 0) >= 2 for r in tail)
    assert any(r.get("busy_s", 0.0) > 0.0 for r in tail)
    snap = rec.snapshot()
    assert snap["overlapped_dispatches"] >= 1
    idle = snap["device_idle_share"]
    assert idle is not None and 0.0 <= idle <= 1.0
    stats = gen.pipeline_stats()
    assert set(stats) == {"depth", "windows_overlapped",
                          "overshoot_tokens", "device_idle_share"}
    assert stats["device_idle_share"] == idle


def test_serving_snapshot_pipeline_block(pair, run):
    """Twin of test_pipeline.py::test_serving_snapshot_pipeline_block."""
    from gofr_tpu_torch.ml import MLDatasource

    async def scenario():
        ml = MLDatasource()
        server = ml.register_llm("pp-chat", None, None,
                                 generator=_tgen(pair, decode_window=4,
                                                 pipeline=1))
        plain = ml.register_llm("pp-plain", None, None,
                                generator=_tgen(pair))
        try:
            await server.generate([3, 1, 4, 1], 14)
            llms = ml.serving_snapshot()["llms"]
            return llms["pp-chat"], llms["pp-plain"]
        finally:
            server.close()
            plain.close()

    armed, plain = run(scenario())
    assert armed["pipeline"]["depth"] == 2
    assert armed["pipeline"]["windows_overlapped"] >= 1
    assert "pipeline" not in plain
