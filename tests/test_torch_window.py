"""PyTorch port, fused decode windows (``GOFR_ML_DECODE_WINDOW``), held
against the JAX package's windowed Generator on the tiny config at f32
(same weights; the JAX side with ``use_flash=False``), the twin of
``tests/test_decode_window.py``.

The contracts: the knob validates as JAX's does (0/off, auto, a power of
two); a dense generator refuses windows; with the knob unset nothing of
the window machinery is built and output is byte-identical; the greedy
tokens of a windowed port generator equal the JAX windowed Generator's
and the port's own window-off tokens, with and without the token-budget
scheduler, at int8 and int4 pages and with EOS; and the ``window_stats``
counters (windows, planned and realized steps, overshoot) equal JAX's.
The JAX twins that need goodput or the flight recorder wait for ROADMAP
A.6. f32, because the claims compare 1-step and K-step dispatches and
bf16 rounding can flip a near-tie argmax between them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.ml.generate import decode_window_from_env as jdecode_window
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch.ml.generate import (DecodeWindowUnsupported, Generator,
                                        decode_window_from_env)
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


def _jgen(pair, **kw):
    jcfg, jparams, _, _ = pair
    return JGenerator(jparams, jcfg, **{**KW, **kw})


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


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for name in ("GOFR_ML_DECODE_WINDOW", "GOFR_ML_PIPELINE",
                 "GOFR_ML_SPEC_K", "GOFR_ML_TOKEN_BUDGET",
                 "GOFR_ML_KV_HOST_BUDGET_MB"):
        monkeypatch.delenv(name, raising=False)


# -- the knob -------------------------------------------------------------------

@pytest.mark.parametrize("raw", ["", "0", "off", "OFF", "auto", "4", "1",
                                 "banana", "3", "-2", "1.5"])
def test_window_knob_validation(monkeypatch, raw):
    """Each value parses as JAX parses it, or raises the same message."""
    monkeypatch.setenv("GOFR_ML_DECODE_WINDOW", raw)
    try:
        want = jdecode_window()
    except ValueError as exc:
        with pytest.raises(ValueError, match="GOFR_ML_DECODE_WINDOW") as got:
            decode_window_from_env()
        assert str(got.value) == str(exc)
        return
    assert decode_window_from_env() == want
    assert want == {"": 0, "0": 0, "off": 0, "OFF": 0, "auto": 32, "4": 4,
                    "1": 1}[raw]


def test_dense_generator_rejects_window_mode(pair):
    with pytest.raises(DecodeWindowUnsupported, match="paged"):
        _tgen(pair, page_size=0, decode_window=4)


def test_constructor_rejects_non_power_of_two(pair):
    with pytest.raises(ValueError, match="power of two"):
        _tgen(pair, decode_window=3)


def test_env_arms_paged_generator(pair, monkeypatch):
    monkeypatch.setenv("GOFR_ML_DECODE_WINDOW", "4")
    gen = _tgen(pair)
    assert gen.decode_window == 4 and gen.chunk == 4
    assert gen.scheduler.window_mode is True
    # an explicit argument beats the environment
    assert _tgen(pair, decode_window=0).decode_window == 0


def test_window_unset_constructs_nothing(pair):
    """Knob unset: no window state anywhere (decode_window 0, no stats
    block, the scheduler plans chunks) and the output is byte-identical to
    an explicit decode_window=0 generator."""
    gen = _tgen(pair, token_budget=64)
    assert gen.decode_window == 0
    assert gen.window_stats() is None
    assert gen.scheduler.window_mode is False
    assert gen.scheduler.snapshot()["plans"] == "chunks"
    for name in ("windows", "window_overshoot", "_win_active", "_win_cap"):
        assert not hasattr(gen, name), name
    assert _serve(gen) == _serve(_tgen(pair, decode_window=0))


# -- greedy identity against JAX and against the window-off path -----------------

def test_fused_window_greedy_identity(pair):
    exp = _serve(_tgen(pair, decode_window=0))
    want = _serve(_jgen(pair, decode_window=4))
    gen = _tgen(pair, decode_window=4)
    assert _serve(gen) == want == exp
    stats = gen.window_stats()
    assert stats["window"] == 4 and stats["windows"] >= 1
    assert stats["steps_realized"] <= stats["steps_planned"]


def test_fused_window_greedy_identity_with_budget_scheduler(pair):
    exp = _serve(_tgen(pair, decode_window=0, token_budget=64))
    jgen = _jgen(pair, decode_window=4, token_budget=64)
    want = _serve(jgen)
    gen = _tgen(pair, decode_window=4, token_budget=64)
    assert _serve(gen) == want == exp
    assert gen.scheduler.snapshot()["plans"] == "windows"
    assert dict(gen.scheduler.dispatches) == dict(jgen.scheduler.dispatches)


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_fused_window_quantized_kv_identity(kv_bits):
    p = _pair(kv_bits)
    exp = _serve(_tgen(p, decode_window=0))
    want = _serve(_jgen(p, decode_window=4))
    assert _serve(_tgen(p, decode_window=4)) == want == exp


def test_fused_window_stops_at_eos_like_jax(pair):
    """An EOS id that the streams sample: the device freezes the row at it
    and the host truncates there, as in JAX."""
    free = _serve(_tgen(pair), max_new=(12, 12))
    eos = free[0][3]  # a token stream 0 samples mid-way
    want = _serve(_jgen(pair, decode_window=4, eos_id=eos), max_new=(12, 12))
    got = _serve(_tgen(pair, decode_window=4, eos_id=eos), max_new=(12, 12))
    assert got == want
    assert got[0][-1] == eos and len(got[0]) == 4


def test_window_stats_block_matches_jax(pair):
    """The counters of one served scenario equal JAX's: the same windows,
    planned and realized steps and overshoot (the step EMA is a clock)."""
    jgen, gen = _jgen(pair, decode_window=4), _tgen(pair, decode_window=4)
    assert _serve(gen) == _serve(jgen)
    got, want = gen.window_stats(), jgen.window_stats()
    assert set(got) == set(want) == {
        "window", "windows", "steps_planned", "steps_realized",
        "realized_share", "overshoot_tokens", "step_ema_s"}
    for key in ("window", "windows", "steps_planned", "steps_realized",
                "realized_share", "overshoot_tokens"):
        assert got[key] == want[key], key
    assert got["realized_share"] is None or got["realized_share"] <= 1.0


def test_window_overshoot_counted_like_jax(pair):
    """A slot the server's reaper kills while its window is in flight:
    the tokens the device computed for it are overshoot, never
    delivered — as many as JAX counts."""
    counts = []
    for gen in (_jgen(pair, decode_window=4), _tgen(pair, decode_window=4)):
        delivered = []
        slot = gen.add_request([3, 1, 4, 1], 16,
                               callback=lambda s, t: delivered.extend(t))
        gen.step()  # the mini dispatch (first token), drained at once
        gen.step()  # a full window, now in flight
        gen.slots[slot].live = False
        gen.drain()
        assert gen.window_overshoot > 0
        counts.append((gen.window_overshoot, delivered))
    assert counts[0] == counts[1]


def test_deadline_bounds_window_steps(pair):
    """A row whose deadline has passed is granted no device steps once the
    step EMA exists: the window freezes it at once (step_cap 0)."""
    import time

    gen = _tgen(pair, decode_window=4)
    slot = gen.add_request([3, 1, 4, 1], 30)
    gen.step()
    gen.step()
    gen.slots[slot].deadline_at = time.perf_counter() - 1.0
    active0, step_cap = gen._plan_window(4)
    assert active0[slot] and gen._step_ema is not None
    assert step_cap[slot] == 0
