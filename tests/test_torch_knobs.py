"""PyTorch port: the serving knobs and the storage the decode graphs need,
on the CPU.

- Knobs: under the same environment (``GOFR_ML_DECODE_WINDOW``,
  ``GOFR_ML_PIPELINE``, ``GOFR_ML_SPEC_K``, ``GOFR_ML_TOKEN_BUDGET``) the
  port builds the JAX Generator's serving loop — the same chunk or window
  size, ladder, pipeline depth and token budget, the same dispatches and
  greedy tokens on a served scenario (tiny config, f32), the same verify
  windows under ``GOFR_ML_SPEC_K``.
- Storage: a CUDA graph replays fixed pointers, so every tensor a decode
  dispatch reads or writes — the cache arrays and ``len``, the page
  table's device buffer, the token row, the window masks — must keep its
  storage across prefill, segments, prefixed admission, decode, spill and
  restore. Checked here by ``data_ptr``, where no card is needed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch.ml.generate import Generator
from gofr_tpu_torch.ml.kv_offload import HostKVStore, OffloadConfig
from gofr_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.timeout(300)

KNOBS = ("GOFR_ML_DECODE_WINDOW", "GOFR_ML_PIPELINE", "GOFR_ML_SPEC_K",
         "GOFR_ML_TOKEN_BUDGET", "GOFR_ML_KV_HOST_BUDGET_MB")
KW = dict(batch_slots=2, max_seq=64, prefill_buckets=(8, 16), page_size=8,
          chunk=4)


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


def _serve(gen):
    outs: dict[int, list[int]] = {}
    for i, (p, n) in enumerate((([3, 1, 4, 1], 10), ([2, 7, 1, 8], 7))):
        gen.add_request(p, n, lambda _s, t, i=i: outs.setdefault(
            i, []).extend(int(x) for x in t))
    for _ in range(200):
        if gen.n_live == 0:
            break
        gen.step()
    gen.drain()
    return outs


def _loop(gen) -> dict:
    """The serving loop a generator built: what its dispatches are."""
    sched = gen.scheduler
    return {"chunk": gen.chunk, "decode_window": gen.decode_window,
            "pipeline": gen.pipeline, "ladder": tuple(gen._chunk_ladder),
            "budget": None if sched is None else sched.budget,
            "window_mode": None if sched is None else sched.window_mode}


@pytest.mark.parametrize("env", [
    {}, {"GOFR_ML_DECODE_WINDOW": "4"}, {"GOFR_ML_DECODE_WINDOW": "auto"},
    {"GOFR_ML_DECODE_WINDOW": "off"}, {"GOFR_ML_PIPELINE": "1"},
    {"GOFR_ML_PIPELINE": "1", "GOFR_ML_DECODE_WINDOW": "2"},
    {"GOFR_ML_TOKEN_BUDGET": "0"}, {"GOFR_ML_TOKEN_BUDGET": "16"},
    {"GOFR_ML_TOKEN_BUDGET": "auto"}, {"GOFR_ML_SPEC_K": "0"},
], ids=lambda env: ",".join(f"{k[8:]}={v}" for k, v in env.items())
    or "unset")
def test_knobs_build_the_jax_serving_loop(pair, monkeypatch, env):
    """The same environment gives the same serving loop: chunk (or
    window) size, ladder, pipeline depth, budget (none at "0"), the same
    scheduler dispatches and the same greedy tokens."""
    jcfg, jparams, tcfg, tparams = pair
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    jgen = JGenerator(jparams, jcfg, **KW)
    gen = Generator(tparams, tcfg, device="cpu", **KW)
    assert _loop(gen) == _loop(jgen)
    assert _serve(gen) == _serve(jgen)
    if gen.scheduler is not None:
        assert (dict(gen.scheduler.dispatches)
                == dict(jgen.scheduler.dispatches))
        assert (gen.scheduler.mini_dispatches
                == jgen.scheduler.mini_dispatches)
    assert gen.steps == jgen.steps


@pytest.mark.parametrize("name,raw", [
    ("GOFR_ML_SPEC_K", "-1"), ("GOFR_ML_SPEC_K", "two"),
    ("GOFR_ML_DECODE_WINDOW", "6"), ("GOFR_ML_PIPELINE", "2"),
    ("GOFR_ML_TOKEN_BUDGET", "lots")])
def test_malformed_knobs_raise_like_jax(pair, monkeypatch, name, raw):
    jcfg, jparams, tcfg, tparams = pair
    monkeypatch.setenv(name, raw)
    with pytest.raises(ValueError) as want:
        JGenerator(jparams, jcfg, **KW)
    with pytest.raises(ValueError) as got:
        Generator(tparams, tcfg, device="cpu", **KW)
    assert str(got.value) == str(want.value)


def test_positive_spec_k_raises_naming_a10(pair, monkeypatch):
    """Under GOFR_ML_SPEC_K=2 the port speculates as JAX does (it raised
    naming ROADMAP A.10 before speculation was ported): the same K, the
    same serving loop (the budget scaled by K+1), the same greedy tokens
    and verify windows on a served scenario; an explicit spec_k beats the
    environment, 0 included."""
    jcfg, jparams, tcfg, tparams = pair
    monkeypatch.setenv("GOFR_ML_SPEC_K", "2")
    jgen = JGenerator(jparams, jcfg, **KW)
    gen = Generator(tparams, tcfg, device="cpu", **KW)
    assert gen.spec_k == jgen.spec_k == 2
    assert _loop(gen) == _loop(jgen)
    assert _serve(gen) == _serve(jgen)
    assert (gen.spec_windows, gen.spec_emitted) == \
        (jgen.spec_windows, jgen.spec_emitted)
    assert gen.spec_windows > 0
    assert Generator(tparams, tcfg, device="cpu", spec_k=4, **KW).spec_k == 4
    # an explicit 0 beats the environment, as in JAX
    assert Generator(tparams, tcfg, device="cpu", spec_k=0, **KW).spec_k == 0


# -- storage ------------------------------------------------------------------

def _ptrs(gen) -> dict:
    out = {f"cache[{k}]": v.data_ptr() for k, v in gen.cache.items()}
    out["tok"] = gen._tok_dev.data_ptr()
    for name in ("_table_dev", "_win_active", "_win_cap"):
        if hasattr(gen, name):
            out[name] = getattr(gen, name).data_ptr()
    return out


@pytest.mark.parametrize("kv_bits,window", [
    (16, 0), (16, 4), (8, 0), (4, 4), (None, 0)],
    ids=["bf16-pages", "bf16-pages-window", "int8-pages",
         "int4-pages-window", "dense"])
def test_decode_storage_keeps_its_pointers(kv_bits, window):
    """Every tensor a decode graph reads or writes keeps its storage across
    prefill, chunked segments, a prefixed admission, decode steps, a spill
    and a restore."""
    kw = {} if kv_bits in (16, None) else {"kv_bits": kv_bits}
    tcfg = tllama.tiny_llama(dtype=torch.float32, **kw)
    tparams = tllama.params_from_config(tcfg, seed=0, device="cpu")
    opts = dict(batch_slots=2, max_seq=64, prefill_buckets=(8, 16),
                chunk=2, prefill_chunk=16, decode_window=window)
    if kv_bits is not None:
        opts.update(page_size=4, n_pages=40,
                    host_kv=HostKVStore(OffloadConfig(budget_mb=8)))
    gen = Generator(tparams, tcfg, device="cpu", **opts)
    ptrs = _ptrs(gen)
    seen = []

    def phase(name):
        assert _ptrs(gen) == ptrs, name
        seen.append(name)

    gen.warmup()
    phase("warmup")
    slot = gen.add_request(list(range(3, 40)), 6)  # 37 tokens: 3 segments
    while gen.slots[slot].live:
        gen.step()
    phase("segments and decode")
    gen.drain()
    gen.release(slot)
    gen.generate([5, 6, 7], 5)
    phase("prefill wave and decode")
    if kv_bits is not None:
        prefix = list(range(50, 61))
        pid = gen.register_prefix(prefix)
        slot = gen.add_request([9, 8], 4, prefix=pid)
        while gen.slots[slot].live:
            gen.step()
        gen.drain()
        gen.release(slot)
        phase("prefixed admission")
        assert gen._reclaim_prefix_pages(gen.free_pages + 1)
        assert gen.has_offloaded(prefix)
        phase("spill")
        gen.restore_prefix(prefix)
        phase("restore")
    assert len(seen) == (6 if kv_bits is not None else 3)
