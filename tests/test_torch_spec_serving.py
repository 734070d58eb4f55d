"""PyTorch port, speculation through the serving stack, held against the
JAX package on the CPU (tiny config at f32, the JAX weights carried across
with ``params_from_jax``).

Twins of ``tests/test_spec_serving.py`` (the knobs, the budget's K+1
unit, spec on/off identity through ``LLMServer``, adaptive disable and
re-probe with the plain-ladder fallback and its observability), of the
speculation cases of ``test_decode_window.py``, ``test_pipeline.py``,
``test_llm_serving.py``, ``test_goodput.py`` and ``test_journey.py``:
each runs the same scenario through the JAX Generator or server and the
port's and checks the same tokens and the same ``spec_windows`` /
``spec_emitted`` / ``spec_disables``. Then what only the port has: the
speculative state keeps its storage (the graphs replay fixed pointers) and
the example server boots with ``LLM_SPEC_K`` and ``LLM_DRAFT_PRESET``.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ml import goodput as jgp
from gofr_tpu.ml import journey as jjourney
from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.ml.llm import LLMServer as JLLMServer
from gofr_tpu.ml.scheduler import TokenBudgetScheduler as JScheduler
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch.ml import goodput as tgp
from gofr_tpu_torch.ml import journey as tjourney
from gofr_tpu_torch.ml.generate import Generator
from gofr_tpu_torch.ml.llm import LLMServer
from gofr_tpu_torch.ml.scheduler import TokenBudgetScheduler
from gofr_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.timeout(300)

KNOBS = ("GOFR_ML_SPEC_K", "GOFR_ML_SPEC_MIN_ACCEPT", "GOFR_ML_SPEC_COOLDOWN",
         "GOFR_ML_DECODE_WINDOW", "GOFR_ML_PIPELINE", "GOFR_ML_TOKEN_BUDGET",
         "GOFR_ML_KV_HOST_BUDGET_MB", "GOFR_ML_FAULT", "GOFR_ML_GOODPUT",
         "GOFR_ML_JOURNEY", "LLM_SPEC_K", "LLM_DRAFT_PRESET",
         "LLM_DRAFT_CKPT")
PROMPT = [5, 9, 2, 7, 1]
PROMPTS = ([3, 1, 4, 1], [2, 7, 1, 8])


@pytest.fixture(scope="module")
def pair():
    jcfg = jllama.tiny_llama(dtype=jnp.float32, use_flash=False)
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)


def _gens(pair, **kw):
    jcfg, jparams, tcfg, tparams = pair
    return (JGenerator(jparams, jcfg, **kw),
            Generator(tparams, tcfg, device="cpu", **kw))


def _counters(gen) -> tuple:
    return (gen.spec_windows, gen.spec_emitted, gen.spec_disables,
            gen.spec_reprobes)


def _run_gen(gen, prompt, n):
    slot = gen.add_request(prompt, n)
    while gen.slots[slot].live:
        gen.step()
    gen.drain()
    out = list(gen.slots[slot].tokens)
    gen.release(slot)
    return out


def _serve(gen, prompts=PROMPTS, max_new=(10, 7)):
    """The window/pipeline tests' scenario: both prompts admitted at
    once, stepped to the end; each one's streamed tokens."""
    outs: dict[int, list[int]] = {}
    for i, (p, n) in enumerate(zip(prompts, max_new, strict=True)):
        gen.add_request(list(p), n, callback=lambda _s, t, i=i: outs.setdefault(
            i, []).extend(int(x) for x in t))
    for _ in range(200):
        if gen.n_live == 0:
            break
        gen.step()
    gen.drain()
    return outs


# -- twins of tests/test_spec_serving.py ----------------------------------------

def test_env_knob_validation(pair, monkeypatch):
    """GOFR_ML_SPEC_K / _MIN_ACCEPT / _COOLDOWN: the same values build, the
    same malformed ones raise JAX's message."""
    jcfg, jparams, tcfg, tparams = pair
    kw = dict(batch_slots=1, max_seq=32, prefill_buckets=(8,))
    cases = [("GOFR_ML_SPEC_K", v) for v in ("nope", "-1", "1.5")]
    cases += [("GOFR_ML_SPEC_MIN_ACCEPT", v)
              for v in ("x", "-0.1", "1.5", "nan")]
    cases += [("GOFR_ML_SPEC_COOLDOWN", v) for v in ("0", "-3", "soon")]
    for name, bad in cases:
        with monkeypatch.context() as m:
            m.setenv(name, bad)
            with pytest.raises(ValueError, match=name) as want:
                JGenerator(jparams, jcfg, **kw)
            with pytest.raises(ValueError, match=name) as got:
                Generator(tparams, tcfg, device="cpu", **kw)
            assert str(got.value) == str(want.value)
    for name, good, attr in (("GOFR_ML_SPEC_K", "2", "spec_k"),
                             ("GOFR_ML_SPEC_MIN_ACCEPT", "0.25",
                              "spec_min_accept"),
                             ("GOFR_ML_SPEC_COOLDOWN", "5", "spec_cooldown")):
        with monkeypatch.context() as m:
            m.setenv(name, good)
            want = getattr(JGenerator(jparams, jcfg, **kw), attr)
            assert getattr(Generator(tparams, tcfg, device="cpu", **kw),
                           attr) == want


def test_plan_charges_spec_windows_as_k_plus_1():
    """A verify window costs K+1 positions a decodable row: the port's
    plan picks JAX's sizes and segments and records the unit."""
    for budget, prefill, calls in ((64, 0, [(8, False, 1), (8, False, 4)]),
                                   (256, 16, [(8, True, 1), (8, True, 4),
                                              (1, True, 4)])):
        j = JScheduler(budget, (1, 2, 4, 8, 16), prefill, slots=8)
        t = TokenBudgetScheduler(budget, (1, 2, 4, 8, 16), prefill, slots=8)
        for n, pending, unit in calls:
            assert t.plan(n, pending, unit) == j.plan(n, pending, unit)
            assert t.last_unit == j.last_unit == unit
            assert t.snapshot()["last_unit"] == unit
    assert t.plan(8, False) == j.plan(8, False) and t.last_unit == 1


def test_auto_budget_scales_with_spec_k(pair):
    jcfg, jparams, tcfg, tparams = pair
    kw = dict(batch_slots=2, max_seq=32, prefill_buckets=(8,), chunk=4)
    plain = Generator(tparams, tcfg, device="cpu", **kw)
    jspec, spec = _gens(pair, spec_k=3, **kw)
    assert spec.scheduler.budget == plain.scheduler.budget * 4 \
        == jspec.scheduler.budget


def test_spec_on_off_identity_through_server(pair, run):
    """Speculation on and off give the same tokens through the port's
    server, which are JAX's, with JAX's verify-window counters and
    ``spec_stats``."""
    jcfg, jparams, tcfg, tparams = pair
    prompts = [PROMPT, [3, 3, 4], [8, 1, 1, 2]]

    async def scenario(server):
        try:
            return await asyncio.gather(
                *[server.generate(p, 10) for p in prompts])
        finally:
            server.close()

    kw = dict(batch_slots=2, max_seq=64, prefill_buckets=(8,), chunk=2)
    plain = run(scenario(LLMServer(Generator(
        tparams, tcfg, device="cpu", **kw), name="tspec-0")))
    jgen, tgen = _gens(pair, spec_k=3, **kw)
    want = run(scenario(JLLMServer(jgen, name="tspec-j3")))
    got = run(scenario(LLMServer(tgen, name="tspec-3")))
    assert got == want == plain
    assert _counters(tgen) == _counters(jgen) and tgen.spec_windows > 0
    assert tgen.spec_stats() == jgen.spec_stats()
    assert tgen.spec_stats()["mode"] == "lookup"


def test_auto_disable_reprobe_and_observability(pair, run):
    """An unreachable floor disables the slot (plain fallback), the
    cooldown re-probes it, the counter reaches the metrics manager, and
    ``/debug/serving`` has the speculation block — with JAX's tokens,
    disables and re-probes, and the plain boot's tokens."""
    from gofr_tpu.ml import MLDatasource as JMLDatasource
    from gofr_tpu_torch.ml import MLDatasource

    jcfg, jparams, tcfg, tparams = pair
    counts: dict = {"jax": {}, "torch": {}}

    class _Metrics:
        def __init__(self, side):
            self.side = side

        def add_counter(self, name, delta, **labels):
            c = counts[self.side]
            c[name] = c.get(name, 0) + delta

        def set_gauge(self, name, value, **labels):
            pass

        def record_histogram(self, name, value, **labels):
            pass

        def register_sampler(self, fn):
            pass

    kw = dict(batch_slots=2, max_seq=160, prefill_buckets=(8,), chunk=2,
              spec_k=3, spec_min_accept=1.0, spec_cooldown=4)

    async def scenario(ml, gen):
        server = ml.register_llm("adapt", None, None, generator=gen)
        try:
            out = await server.generate(PROMPT, 120)
            return out, ml.serving_snapshot()["llms"]["adapt"]
        finally:
            server.close()

    jgen, tgen = _gens(pair, **kw)
    want, jsnap = run(scenario(JMLDatasource(metrics=_Metrics("jax")), jgen))
    got, snap = run(scenario(MLDatasource(metrics=_Metrics("torch")), tgen))
    assert got == want
    assert _counters(tgen) == _counters(jgen)
    assert tgen.spec_disables >= 1 and tgen.spec_reprobes >= 1
    assert counts["torch"].get("app_llm_spec_disabled_total", 0) \
        == tgen.spec_disables
    assert snap["speculation"] == jsnap["speculation"]
    assert snap["speculation"]["plain_fallback_armed"] is True
    plain = Generator(tparams, tcfg, device="cpu", batch_slots=2, max_seq=160,
                      prefill_buckets=(8,), chunk=2)
    assert got == _run_gen(plain, PROMPT, 120)


# -- twins of the speculation cases of the window, pipeline, serving,
#    goodput and journey tests ---------------------------------------------------

def test_fused_window_spec_identity(pair):
    kw = dict(batch_slots=2, max_seq=64, prefill_buckets=(8, 16),
              page_size=8, spec_k=2)
    exp = _serve(Generator(pair[3], pair[2], device="cpu", decode_window=0,
                           **kw))
    jgen, gen = _gens(pair, decode_window=4, **kw)
    assert _serve(gen) == _serve(jgen) == exp
    assert _counters(gen) == _counters(jgen)
    # the step EMA is a host clock
    assert ({k: v for k, v in gen.window_stats().items() if k != "step_ema_s"}
            == {k: v for k, v in jgen.window_stats().items()
                if k != "step_ema_s"})
    assert gen.window_stats()["windows"] >= 1
    assert gen.spec_stats()["windows"] >= 1


def test_pipelined_spec_window_identity(pair):
    new = (20, 18)
    kw = dict(batch_slots=2, max_seq=64, prefill_buckets=(8, 16),
              page_size=8, spec_k=2)
    exp = _serve(Generator(pair[3], pair[2], device="cpu", decode_window=0,
                           **kw), max_new=new)
    jgen, gen = _gens(pair, decode_window=4, pipeline=1, **kw)
    assert _serve(gen, max_new=new) == _serve(jgen, max_new=new) == exp
    assert _counters(gen) == _counters(jgen)
    assert gen.spec_stats()["windows"] >= 1
    assert gen.pipeline_stats()["windows_overlapped"] == \
        jgen.pipeline_stats()["windows_overlapped"] >= 1
    assert gen.pipeline_overshoot == jgen.pipeline_overshoot


def test_chunked_prefill_paged_and_speculative(pair, run):
    """A long prompt segments, and under speculation its final segment
    seeds the whole history row: the dense whole-prompt tokens, JAX's
    counters."""
    jcfg, jparams, tcfg, tparams = pair
    long_prompt = list((np.arange(40) % 200 + 3).astype(int))
    ref = Generator(tparams, tcfg, device="cpu", batch_slots=1, max_seq=64,
                    prefill_buckets=(64,)).generate(long_prompt, 8)

    async def scenario(server):
        try:
            return await server.generate(long_prompt, 8)
        finally:
            server.close()

    jgen, tgen = _gens(pair, batch_slots=2, max_seq=64,
                       prefill_buckets=(8, 64), chunk=2, spec_k=2,
                       prefill_chunk=16)
    want = run(scenario(JLLMServer(jgen)))
    got = run(scenario(LLMServer(tgen)))
    assert got == want == ref
    assert _counters(tgen) == _counters(jgen) and tgen.spec_windows > 0


def _ledger(mod, name):
    return mod.goodput_ledger().snapshot_model(name)


def test_spec_rejected_balances(pair, run):
    """Lookup drafts on a random tiny model are mostly rejected: the port
    charges JAX's ``spec_rejected``, delivers JAX's tokens, and its ledger
    balances against the generator's own count of computed tokens."""
    async def scenario(server):
        try:
            out = await server.generate([3, 1, 4, 1, 5], 10)
            assert len(out) == 10
        finally:
            server.close()

    jgen, tgen = _gens(pair, batch_slots=2, max_seq=64,
                       prefill_buckets=(8, 16), spec_k=2, chunk=2)
    run(scenario(JLLMServer(jgen, name="tgp-spec")))
    run(scenario(LLMServer(tgen, name="tgp-spec")))
    want, got = _ledger(jgp, "tgp-spec"), _ledger(tgp, "tgp-spec")
    assert got["delivered"] == want["delivered"] == 10
    assert got["wasted"] == want["wasted"]
    assert got["wasted"].get("spec_rejected", 0) > 0
    assert got["delivered"] + sum(got["wasted"].values()) \
        == got["device_tokens"] == tgen.tokens_computed
    computed = tgen.spec_windows * (tgen.spec_k + 1)
    assert got["wasted"]["spec_rejected"] == computed - tgen.spec_emitted


def test_programs_spec_ladder_named(pair):
    jgen, gen = _gens(pair, batch_slots=2, max_seq=64,
                      prefill_buckets=(8, 16), spec_k=2, chunk=2)
    jgen.warmup()
    gen.warmup()
    names = {r["name"] for r in gen.programs.snapshot()}
    jnames = {r["name"] for r in jgen.programs.snapshot()}
    assert any(n.startswith("spec/window") for n in names)
    assert {n for n in names if n.startswith("spec/")} == \
        {n for n in jnames if n.startswith("spec/")}


def test_sum_to_wall_under_chunked_prefill_and_speculation(pair, run):
    """The speculation half of the JAX journey test: a chunked prompt
    decoded with speculation gives a waterfall whose marks sum to the
    wall, with the spec counts attached — JAX's counts."""
    async def scenario(server):
        try:
            out = await server.generate(list(range(1, 21)), 8)
            assert len(out) == 8
            return out
        finally:
            server.close()

    jgen, tgen = _gens(pair, batch_slots=1, max_seq=64,
                       prefill_buckets=(8, 16), page_size=4, chunk=2,
                       prefill_chunk=8, spec_k=2, n_pages=32)
    want = run(scenario(JLLMServer(jgen, name="tjr-prop")))
    got = run(scenario(LLMServer(tgen, name="tjr-prop")))
    assert got == want
    reqs = []
    for mod in (jjourney, tjourney):
        log = mod.journey_log()
        waterfall = log.get(log.snapshot()["recent_rids"][-1]).snapshot()
        assert waterfall["model"] == "tjr-prop"
        marks = waterfall["marks"]
        assert waterfall["done"] and all(m["dur_s"] >= 0.0 for m in marks)
        assert sum(m["dur_s"] for m in marks) == pytest.approx(
            waterfall["wall_s"], abs=1e-5)
        names = [m["mark"] for m in marks]
        assert "admit" in names and "prefill" in names and "decode" in names
        reqs.append(waterfall["request"])
    assert reqs[1]["tokens"] == 8 and reqs[1].get("spec_windows", 0) >= 1
    assert {k: reqs[1].get(k) for k in ("spec_windows", "spec_emitted")} \
        == {k: reqs[0].get(k) for k in ("spec_windows", "spec_emitted")}


# -- the port's own: storage under the graphs, the example server ---------------

def _ptrs(gen) -> dict:
    out = {f"cache[{k}]": v.data_ptr() for k, v in gen.cache.items()}
    for name in ("_tok_dev", "_tokens_dev", "_spec_on", "_table_dev",
                 "_win_active", "_win_cap"):
        if hasattr(gen, name):
            out[name] = getattr(gen, name).data_ptr()
    for k, v in getattr(gen, "_draft_cache", {}).items():
        out[f"draft[{k}]"] = v.data_ptr()
    return out


@pytest.mark.parametrize("kv_bits,window,draft", [
    (None, 0, False), (None, 0, True), (16, 4, False), (8, 0, False)],
    ids=["dense", "dense-draft", "bf16-pages-window", "int8-pages"])
def test_spec_storage_keeps_its_pointers(kv_bits, window, draft):
    """Every tensor a spec graph reads or writes — the cache and ``len``,
    the history rows, the enable mask, the window masks, the draft cache —
    keeps its storage across warmup, chunked segments, prefill, verify
    windows, a plain-fallback reseed and a recovery. (With fused windows
    a disabled slot never re-probes, in JAX as here: plain windows do not
    run its cooldown clock.)"""
    kw = {} if kv_bits in (16, None) else {"kv_bits": kv_bits}
    tcfg = tllama.tiny_llama(dtype=torch.float32, **kw)
    tparams = tllama.params_from_config(tcfg, seed=0, device="cpu")
    opts = dict(batch_slots=2, max_seq=64, prefill_buckets=(8, 16, 64),
                chunk=2, prefill_chunk=16, decode_window=window, spec_k=2,
                spec_min_accept=0.0 if draft else 1.0, spec_cooldown=2)
    if draft:
        opts.update(draft_params=tparams, draft_cfg=tcfg)
    if kv_bits is not None:
        opts.update(page_size=4, n_pages=40)
    gen = Generator(tparams, tcfg, device="cpu", **opts)
    ptrs = _ptrs(gen)
    gen.warmup()
    assert _ptrs(gen) == ptrs
    slot = gen.add_request(list(range(3, 40)), 6)  # 37 tokens: segments
    while gen.slots[slot].live:
        gen.step()
    gen.drain()
    gen.release(slot)
    assert _ptrs(gen) == ptrs
    out = gen.generate([5, 6, 7], 40)
    assert _ptrs(gen) == ptrs
    assert gen.spec_windows > 0
    if not draft:
        assert gen.spec_disables >= 1
        assert gen.spec_reprobes >= (0 if window else 1)
    gen.recover()
    assert _ptrs(gen) == ptrs
    assert gen.generate([5, 6, 7], 40) == out


def test_example_server_speculates_with_a_draft(pair, monkeypatch, run):
    """``LLM_SPEC_K=2`` with ``LLM_DRAFT_PRESET=self`` boots the port's
    example app with a speculating generator whose draft is the target
    itself, and ``/generate`` answers the plain server's tokens."""
    from aiohttp.test_utils import TestClient, TestServer

    from gofr_tpu_torch.examples import llama_server

    async def generate(app):
        client = TestClient(TestServer(app._build_http_app()))
        await client.start_server()
        try:
            r = await client.post("/generate", json={
                "prompt_ids": [5, 3, 2, 6, 5, 3], "max_new_tokens": 8})
            assert r.status == 201
            return (await r.json())["data"]["tokens"]
        finally:
            await client.close()
            app.container.ml.llm("chat").close()

    monkeypatch.setenv("LLAMA_PRESET", "tiny")
    monkeypatch.setenv("LLAMA_DTYPE", "f32")
    plain = run(generate(llama_server.main(device="cpu")))
    monkeypatch.setenv("LLM_SPEC_K", "2")
    monkeypatch.setenv("LLM_DRAFT_PRESET", "self")
    app = llama_server.main(device="cpu")
    gen = app.container.ml.llm("chat").gen
    assert gen.spec_k == 2 and gen.draft_params is not None
    assert gen.draft_params["embed"] is gen.params["embed"]
    assert run(generate(app)) == plain
    assert gen.spec_windows > 0 and gen.spec_stats()["mode"] == "draft"
