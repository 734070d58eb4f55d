"""PyTorch port, serving: the port's Generator against the JAX Generator
(greedy tokens identical on the tiny config at f32, same weights, the same
staggered admission schedule; with the fp cache and with the int8 cache and
int8 weights), the port's LLMServer answering concurrent
callers, the device rule of the entry points, and the port's independence
from JAX.
"""

import ast
import asyncio
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch.ml.errors import DeadlineExceeded, GeneratorCrashed, ServerClosed
from gofr_tpu_torch.ml.generate import Generator, Sampler, _chunk_ladder, _sample_impl
from gofr_tpu_torch.ml.llm import LLMServer
from gofr_tpu_torch.ml.scheduler import (AgingPriorityQueue, TokenBudgetScheduler,
                                         normalize_priority)
from gofr_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.timeout(240)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GEN_KW = dict(batch_slots=3, max_seq=64, prefill_buckets=(8, 16), chunk=4)


@pytest.fixture(scope="module")
def pair():
    jcfg = jllama.tiny_llama(dtype=jnp.float32, use_flash=False)
    tcfg = tllama.tiny_llama(dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def q_pair():
    """The tiny config at f32 with the int8 cache and int8 weights, the
    JAX-quantized tree carried across."""
    jcfg = jllama.tiny_llama(dtype=jnp.float32, use_flash=False,
                             kv_quant=True, w8=True)
    tcfg = tllama.tiny_llama(dtype=torch.float32, kv_quant=True, w8=True)
    jparams = jllama.quantize_weights(
        jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(seed, lengths, vocab):
    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, n).astype(np.int32).tolist() for n in lengths]


def _staggered(gen, prompts, max_new):
    """One request alone, two more as a wave after two dispatches, the last
    after the first finishes (slot reuse); returns each request's tokens."""
    got = {i: [] for i in range(len(prompts))}

    def cb(i):
        return lambda _slot, toks: got[i].extend(toks)

    gen.add_request(prompts[0], max_new[0], cb(0))
    gen.step()
    gen.step()
    gen.add_requests([(prompts[i], max_new[i], cb(i)) for i in (1, 2)])
    while sum(s.live for s in gen.slots) == 3:
        gen.step()
    gen.drain()
    for i, s in enumerate(gen.slots):
        if not s.live and s.max_new:
            gen.release(i)
    gen.add_request(prompts[3], max_new[3], cb(3))
    while gen.n_live:
        gen.step()
    gen.drain()
    return [got[i] for i in range(len(prompts))]


def test_staggered_greedy_tokens_match_jax_generator(pair):
    jcfg, jparams, tcfg, tparams = pair
    prompts = _prompts(0, (5, 12, 3, 16), jcfg.vocab_size)
    max_new = (9, 6, 11, 7)
    want = _staggered(JGenerator(jparams, jcfg, **GEN_KW), prompts, max_new)
    got = _staggered(Generator(tparams, tcfg, device="cpu", **GEN_KW),
                     prompts, max_new)
    assert [len(t) for t in got] == list(max_new)
    assert got == want


def test_int8_staggered_greedy_tokens_match_jax_generator(q_pair):
    """kv_quant + w8 at f32: the same staggered schedule gives the JAX
    Generator's greedy tokens, token for token."""
    jcfg, jparams, tcfg, tparams = q_pair
    prompts = _prompts(3, (6, 14, 2, 11), jcfg.vocab_size)
    max_new = (10, 5, 12, 8)
    want = _staggered(JGenerator(jparams, jcfg, **GEN_KW), prompts, max_new)
    gen = Generator(tparams, tcfg, device="cpu", **GEN_KW)
    assert gen.cache["k"].dtype == torch.int8 and "k_scale" in gen.cache
    got = _staggered(gen, prompts, max_new)
    assert [len(t) for t in got] == list(max_new)
    assert got == want


def test_int8_warmup_reaches_the_int8_decode_path(q_pair, monkeypatch):
    """Warmup over the int8 cache runs decode through the int8 dispatch
    (its plain version on the CPU), never the fp one, and leaves greedy
    output unchanged; the Generator itself needs nothing new."""
    from gofr_tpu_torch import ops as tops

    _, _, tcfg, tparams = q_pair
    calls = {"int8": 0, "fp": 0}

    def counting(fn, key):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tops, "gqa_decode_attention_int8_plain", counting(
        tops.gqa_decode_attention_int8_plain, "int8"))
    monkeypatch.setattr(tops, "gqa_decode_attention_plain", counting(
        tops.gqa_decode_attention_plain, "fp"))
    cold = Generator(tparams, tcfg, device="cpu", **GEN_KW)
    warm = Generator(tparams, tcfg, device="cpu", **GEN_KW)
    warm.warmup()
    assert calls == {"int8": tcfg.n_layers * (GEN_KW["chunk"] + 1), "fp": 0}
    assert warm.generate([4, 5, 6], 8) == cold.generate([4, 5, 6], 8)


def test_eos_and_capacity_finish_like_jax(pair):
    """A multi-id EOS truncates at the first hit, and a prompt near
    max_seq stops at capacity — the same tokens as the JAX Generator."""
    jcfg, jparams, tcfg, tparams = pair
    kw = dict(batch_slots=2, max_seq=24, prefill_buckets=(8, 16), chunk=4)
    prompt = _prompts(1, (20,), jcfg.vocab_size)[0]
    want = JGenerator(jparams, jcfg, **kw).generate(prompt, 10)
    got = Generator(tparams, tcfg, device="cpu", **kw).generate(prompt, 10)
    assert got == want and len(got) == 4  # 20 prompt + 4 tokens = max_seq
    free = JGenerator(jparams, jcfg, **kw).generate([1, 2, 3], 12)
    eos = (free[5], free[8])
    want = JGenerator(jparams, jcfg, eos_id=eos, **kw).generate([1, 2, 3], 12)
    got = Generator(tparams, tcfg, device="cpu", eos_id=eos,
                    **kw).generate([1, 2, 3], 12)
    first = min(i for i, t in enumerate(free) if t in eos)
    assert got == want == free[:first + 1]


def test_warmup_leaves_greedy_output_unchanged(pair):
    _, _, tcfg, tparams = pair
    cold = Generator(tparams, tcfg, device="cpu", **GEN_KW)
    warm = Generator(tparams, tcfg, device="cpu", **GEN_KW)
    warm.warmup()
    assert warm.generate([4, 5, 6], 8) == cold.generate([4, 5, 6], 8)


def test_sampling_follows_the_distribution():
    """Sampled decoding cannot match JAX's threefry draws; it is held by
    distribution: temperature sampling of fixed logits reproduces softmax
    frequencies, top-k never leaves the k best, greedy takes the first of
    tied maxima as jnp.argmax does."""
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]])).repeat(4000, 1)
    g = torch.Generator().manual_seed(0)
    toks = _sample_impl(logits, g, Sampler(temperature=1.0)).numpy()
    freq = np.bincount(toks, minlength=4) / len(toks)
    np.testing.assert_allclose(freq, [0.5, 0.3, 0.15, 0.05], atol=0.03)
    toks = _sample_impl(logits, g, Sampler(temperature=1.0, top_k=2)).numpy()
    assert set(toks.tolist()) <= {0, 1}
    toks = _sample_impl(logits, g, Sampler(temperature=1.0, top_p=0.7)).numpy()
    assert set(toks.tolist()) <= {0, 1}
    tied = np.array([[1.0, 3.0, 3.0, 0.0]], np.float32)
    assert int(_sample_impl(torch.from_numpy(tied), None, Sampler())[0]) == \
        int(jnp.argmax(jnp.asarray(tied), axis=-1)[0])


def test_server_answers_concurrent_callers(pair, run):
    """Concurrent generate and stream_chunks callers, more than there are
    slots, each get the tokens the Generator gives the prompt alone."""
    _, _, tcfg, tparams = pair
    prompts = _prompts(2, (3, 9, 14, 5, 7), tcfg.vocab_size)
    alone = [Generator(tparams, tcfg, device="cpu", **GEN_KW).generate(p, 6)
             for p in prompts]

    async def scenario():
        server = LLMServer(Generator(tparams, tcfg, device="cpu", **GEN_KW))

        async def chunks(p):
            out, info = [], {}
            async for burst in server.stream_chunks(p, 6, info=info,
                                                    priority="high"):
                out.extend(burst)
            assert info["finish_reason"] == "length"
            return out

        try:
            calls = [server.generate(p, 6) if i % 2 else chunks(p)
                     for i, p in enumerate(prompts)]
            calls.append(_collect(server.stream(prompts[0], 6)))
            return await asyncio.gather(*calls), server
        finally:
            server.close()

    outs, server = run(scenario())
    assert outs[:-1] == alone
    assert outs[-1] == alone[0]
    assert server.served == len(prompts) + 1
    assert server.health() == "dead"  # closed


async def _collect(agen):
    return [t async for t in agen]


def test_server_rejects_bad_requests_and_keeps_serving(pair, run):
    _, _, tcfg, tparams = pair

    async def scenario():
        server = LLMServer(Generator(tparams, tcfg, device="cpu", **GEN_KW))
        try:
            with pytest.raises(ValueError, match="priority"):
                await server.generate([1, 2], 3, priority="urgent")
            with pytest.raises(ValueError, match="out of range"):
                await server.generate(list(range(64)), 3)
            with pytest.raises(ValueError, match="token ids"):
                await server.generate([1, tcfg.vocab_size], 3)
            with pytest.raises(ValueError):
                server.check_admissible([], 1)
            return await server.generate([1, 2], 3)
        finally:
            server.close()

    assert len(run(scenario())) == 3


def test_server_deadline_and_close(pair, run):
    _, _, tcfg, tparams = pair

    async def scenario():
        server = LLMServer(Generator(tparams, tcfg, device="cpu", **GEN_KW))
        with pytest.raises(DeadlineExceeded):
            await server.generate([1, 2, 3], 60, deadline_s=1e-9)
        assert server.deadline_expired == 1
        server.close(drain_s=1.0)
        with pytest.raises(ServerClosed):
            await server.generate([1, 2], 3)

    run(scenario())


def test_serving_thread_crash_fails_callers_typed(pair, run):
    """An exception on the serving thread is not swallowed: the caller gets
    GeneratorCrashed; with no restart budget the server reports dead and
    its restart history keeps the error."""
    _, _, tcfg, tparams = pair
    gen = Generator(tparams, tcfg, device="cpu", **GEN_KW)

    def boom():
        raise RuntimeError("device fault")

    gen.step = boom

    async def scenario():
        server = LLMServer(gen, max_restarts=0)
        with pytest.raises(GeneratorCrashed, match="device fault"):
            await server.generate([1, 2, 3], 5)
        return server

    server = run(scenario())
    server._thread.join(timeout=10)
    assert server.health() == "dead"
    recent = server.resilience_snapshot()["restarts"]["recent"]
    assert recent[-1]["error"] == "RuntimeError: device fault"
    assert recent[-1]["recovered"] is False


def test_entry_points_take_the_card_unless_told_cpu(pair):
    _, _, tcfg, tparams = pair
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="params live on"):
            Generator(tparams, tcfg)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Generator(tparams, tcfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tllama.init_cache(tcfg, 1, 8)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tllama.init_params(tcfg, torch.Generator(), device="cuda")


def test_unported_generator_options_raise(pair, monkeypatch):
    """What stays unported raises, naming its ROADMAP item: sequence
    parallelism (A.11). Speculation (``spec_k``, or a positive
    ``GOFR_ML_SPEC_K``), paging, chunked prefill, fused windows, the
    depth-2 pipeline and the host KV tier (asked for by ``host_kv`` or by
    a positive ``GOFR_ML_KV_HOST_BUDGET_MB``) are ported and construct."""
    from gofr_tpu_torch.ml.kv_offload import HostKVStore, OffloadConfig

    _, _, tcfg, tparams = pair
    with pytest.raises(NotImplementedError, match="ROADMAP A.11"):
        Generator(tparams, tcfg, device="cpu", sp="ring")
    assert Generator(tparams, tcfg, device="cpu", spec_k=2).spec_k == 2
    monkeypatch.setenv("GOFR_ML_SPEC_K", "2")
    assert Generator(tparams, tcfg, device="cpu").spec_k == 2
    monkeypatch.delenv("GOFR_ML_SPEC_K")
    store = HostKVStore(OffloadConfig(budget_mb=1))
    gen = Generator(tparams, tcfg, device="cpu", page_size=8, host_kv=store,
                    decode_window=4, pipeline=1, **GEN_KW)
    assert (gen.host_kv is store and gen.decode_window == 4
            and gen.pipeline == 1)
    for budget in ("64", "0.5"):
        monkeypatch.setenv("GOFR_ML_KV_HOST_BUDGET_MB", budget)
        gen = Generator(tparams, tcfg, device="cpu", page_size=8)
        assert gen.host_kv.budget_bytes == int(float(budget) * 2**20)
        assert Generator(tparams, tcfg, device="cpu").host_kv is None
    for budget in ("0", ""):
        monkeypatch.setenv("GOFR_ML_KV_HOST_BUDGET_MB", budget)
        assert Generator(tparams, tcfg, device="cpu",
                         page_size=8).host_kv is None
    gen = Generator(tparams, tcfg, device="cpu", page_size=8,
                    prefill_chunk=16, host_kv=False, **GEN_KW)
    assert gen.page_size == 8 and gen.prefill_chunk == 16
    assert gen.host_kv is None


def test_scheduler_pieces():
    assert _chunk_ladder(16) == (1, 2, 4, 8, 16)
    assert _chunk_ladder(3) == (1, 2, 3)
    sched = TokenBudgetScheduler(32, _chunk_ladder(8))
    assert sched.plan(4) == (8, 0)
    assert sched.plan(8) == (4, 0)  # budget 32 / 8 rows
    assert sched.plan(64) == (1, 0)  # never below the ladder's first entry
    for size in (8, 4, 1):
        sched.note_dispatch(size)
    assert dict(sched.dispatches) == {8: 1, 4: 1, 1: 1}
    assert normalize_priority(None) == 1
    assert normalize_priority("HIGH") == 0
    for bad in (True, 1.0, 3, "urgent"):
        with pytest.raises(ValueError):
            normalize_priority(bad)

    class Item:
        def __init__(self, priority, t):
            self.priority, self.enqueued_at = priority, t

    q = AgingPriorityQueue(aging_s=1.0)
    low, high, later = Item(2, 0.0), Item(0, 0.0), Item(0, 2.9)
    q.push(low)
    q.push(high)
    assert q.pop(now=0.5) is high      # fresh: the better class first
    q.push(later)
    assert q.pop(now=3.0) is low       # aged three classes: outranks 'high'
    assert q.prune(lambda it: True) == [later] and len(q) == 0
    assert q.pop() is None


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted((ROOT / "gofr_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    scanned = {str(p.relative_to(ROOT)) for p in files}
    for new in ("http/sse.py", "examples/openai_server.py", "ml/capture.py",
                "ml/replay.py", "ml/tune.py", "ml/replica.py",
                "ml/kv_transport.py", "ml/multihost.py", "ml/train.py",
                "ml/optim.py", "ml/checkpoint.py", "ml/data.py",
                "ml/hf_import.py"):
        assert f"gofr_tpu_torch/{new}" in scanned
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "gofr_tpu", "flax", "optax",
                               "orbax", "safetensors", "ml_dtypes"), \
                f"{path.relative_to(ROOT)} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, gofr_tpu_torch.ml.llm, gofr_tpu_torch.ml.generate, "
            "gofr_tpu_torch.app, gofr_tpu_torch.examples.llama_server, "
            "gofr_tpu_torch.debug, gofr_tpu_torch.flight_recorder, "
            "gofr_tpu_torch.ml.goodput, gofr_tpu_torch.ml.journey, "
            "gofr_tpu_torch.ml.programs, gofr_tpu_torch.testutil.faults, "
            "gofr_tpu_torch.ml.engine, gofr_tpu_torch.ml.batching, "
            "gofr_tpu_torch.models.mlp, gofr_tpu_torch.models.bert, "
            "gofr_tpu_torch.models.diffusion, "
            "gofr_tpu_torch.examples.mnist_server, "
            "gofr_tpu_torch.examples.bert_server, "
            "gofr_tpu_torch.examples.sdxl_server, "
            "gofr_tpu_torch.http.sse, gofr_tpu_torch.examples.openai_server, "
            "gofr_tpu_torch.ml.capture, gofr_tpu_torch.ml.replay, "
            "gofr_tpu_torch.ml.tune, gofr_tpu_torch.ml.replica, "
            "gofr_tpu_torch.ml.kv_transport, gofr_tpu_torch.ml.multihost, "
            "gofr_tpu_torch.ml.train, gofr_tpu_torch.ml.optim, "
            "gofr_tpu_torch.ml.checkpoint, gofr_tpu_torch.ml.data, "
            "gofr_tpu_torch.ml.hf_import; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gofr_tpu', 'optax', 'orbax', 'safetensors', "
            "'ml_dtypes')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
