"""PyTorch port, replay-driven config search and tuned profiles
(``ml/tune.py``) on the CPU, the tiny paged model at f32 with the JAX
weights carried across (``params_from_jax``).

Twins of the tests of ``tests/test_tune.py`` that need neither the shadow
canary (a replica pool's, ROADMAP A.14a) nor the committed bundle's
digests: profile validation and the env overlay, drift warnings, the
grid, the scoreboard's ranking and its never-slower rule on stubbed
replays, a real search that prunes a poisoned arm and emits a profile
that round-trips, and ``GOFR_ML_PROFILE`` unset constructing nothing
while a set one steers ``register_llm`` and comes off after. Then the
committed ``bench/tune_window.bundle``: its JAX test is red, so its
recorded digests are not ground truth; replayed on JAX's tiny builder
and on the port with the same weights bridged, the two replays' outputs
are held equal, request by request.
"""

import asyncio
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ml import replay as jreplay
from gofr_tpu.ml import tune as jtune
from gofr_tpu.ml.capture import token_digest as jtoken_digest
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch.app import App
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.ml import tune as tune_mod
from gofr_tpu_torch.ml.capture import (runtime_fingerprint, token_digest,
                                       traffic_capture)
from gofr_tpu_torch.ml.generate import Generator
from gofr_tpu_torch.ml.llm import LLMServer
from gofr_tpu_torch.ml.replay import ReplayHarness, load_bundle
from gofr_tpu_torch.ml.tune import (PROFILE_FORMAT, TUNABLE_KNOBS, Tuner,
                                    default_grid, load_profile,
                                    profile_boot_warnings, profile_from_env,
                                    profile_overlay)
from gofr_tpu_torch.models import llama

pytestmark = pytest.mark.timeout(300)

BENCH_BUNDLE = (pathlib.Path(__file__).resolve().parent.parent
                / "bench" / "tune_window.bundle")
KNOBS = ("GOFR_ML_CAPTURE", "GOFR_ML_PROFILE", "GOFR_ML_CANARY",
         "GOFR_ML_DECODE_WINDOW", "GOFR_ML_PIPELINE", "GOFR_ML_TOKEN_BUDGET",
         "GOFR_ML_REPLAY_SPEED", "GOFR_ML_REPLICAS")


def _bridged(seed: int):
    jcfg = jllama.tiny_llama(use_flash=False, dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    cfg = llama.tiny_llama(dtype=torch.float32)
    return cfg, llama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      device="cpu")


@pytest.fixture(scope="module")
def model():
    return _bridged(0)


@pytest.fixture(scope="module")
def poisoned_model():
    # same config, other weights: the canonical identity violation
    return _bridged(1)


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)


def _gen(model, **kw):
    cfg, params = model
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("prefill_buckets", (8, 16))
    kw.setdefault("page_size", 8)
    return Generator(params, cfg, device="cpu", **kw)


# -- unit level --------------------------------------------------------------------

def test_profile_load_validation(tmp_path):
    path = tmp_path / "prof.json"
    with pytest.raises(ValueError, match="cannot read"):
        load_profile(str(tmp_path / "missing.json"))
    path.write_text("{nope")
    with pytest.raises(ValueError, match="not JSON"):
        load_profile(str(path))
    path.write_text(json.dumps({"format": "other/9", "knobs": {}}))
    with pytest.raises(ValueError, match="format"):
        load_profile(str(path))
    path.write_text(json.dumps({"format": PROFILE_FORMAT}))
    with pytest.raises(ValueError, match="knobs"):
        load_profile(str(path))
    path.write_text(json.dumps({"format": PROFILE_FORMAT, "knobs": {}}))
    assert load_profile(str(path))["knobs"] == {}
    path.write_text(json.dumps({"format": PROFILE_FORMAT,
                                "knobs": {"GOFR_ML_EVIL": "1"}}))
    with pytest.raises(ValueError, match="unknown knob"):
        load_profile(str(path))
    path.write_text(json.dumps({"format": PROFILE_FORMAT,
                                "knobs": {"GOFR_ML_PIPELINE": [1]}}))
    with pytest.raises(ValueError, match="non-scalar"):
        load_profile(str(path))
    path.write_text(json.dumps({
        "format": PROFILE_FORMAT,
        "knobs": {"GOFR_ML_DECODE_WINDOW": 4, "GOFR_ML_PIPELINE": "1"}}))
    prof = load_profile(str(path))
    assert prof["knobs"] == {"GOFR_ML_DECODE_WINDOW": "4",
                             "GOFR_ML_PIPELINE": "1"}
    assert prof["path"] == str(path)
    # the same file loads to the same dict in both packages
    assert jtune.load_profile(str(path)) == prof
    assert TUNABLE_KNOBS == jtune.TUNABLE_KNOBS


def test_profile_overlay_sets_and_restores_env(monkeypatch):
    monkeypatch.setenv("GOFR_ML_DECODE_WINDOW", "2")
    with profile_overlay({"GOFR_ML_DECODE_WINDOW": "8",
                          "GOFR_ML_PIPELINE": "1"}):
        assert os.environ["GOFR_ML_DECODE_WINDOW"] == "8"
        assert os.environ["GOFR_ML_PIPELINE"] == "1"
    assert os.environ["GOFR_ML_DECODE_WINDOW"] == "2"
    assert "GOFR_ML_PIPELINE" not in os.environ
    with pytest.raises(RuntimeError):
        with profile_overlay({"GOFR_ML_PIPELINE": "1"}):
            raise RuntimeError("boom")
    assert "GOFR_ML_PIPELINE" not in os.environ


def test_profile_boot_warnings_drift_and_kv_bits():
    prof = {"format": PROFILE_FORMAT, "runtime": runtime_fingerprint(),
            "knobs": {"GOFR_ML_DECODE_WINDOW": "4"}}
    assert profile_boot_warnings(prof) == []
    stale = json.loads(json.dumps(prof))
    stale["runtime"]["torch"] = "99.0"
    stale["runtime"]["knobs"]["GOFR_ML_DECODE_WINDOW"] = "4"
    lines = profile_boot_warnings(stale)
    assert any("torch" in line for line in lines)
    assert not any("GOFR_ML_DECODE_WINDOW" in line for line in lines)
    kv = {"format": PROFILE_FORMAT, "runtime": runtime_fingerprint(),
          "knobs": {"GOFR_ML_KV_BITS": "8"}}
    assert any("GOFR_ML_KV_BITS" in line for line in
               profile_boot_warnings(kv))


def test_default_grid_knobs_are_tunable():
    arms = default_grid()
    names = [a["name"] for a in arms]
    assert len(names) == len(set(names)) and "default" in names
    for arm in arms:
        assert set(arm["knobs"]) <= TUNABLE_KNOBS
    assert arms == jtune.default_grid()


# -- ranking (stubbed replay) ------------------------------------------------------

def _fake_verdict(steady, *, rate=1.0, compared=3, failed=0, good=1.0,
                  ttft_p99=50.0, tpot_p99=10.0):
    return {
        "identity": {"rate": rate, "compared": compared},
        "replay_failed": failed,
        "throughput": {"steady_tok_s": steady, "tok_s": steady * 0.9},
        "ttft": {"replayed": {"p99_ms": ttft_p99}},
        "tpot": {"replayed": {"p99_ms": tpot_p99}},
        "goodput": {"goodput": good},
    }


def _stub_harness(monkeypatch, mod, verdicts: dict):
    class _Server:
        def __init__(self, arm):
            self.arm = arm

        def close(self):
            pass

    class _Harness:
        def __init__(self, server, bundle, speed=None, logger=None):
            self.server = server

        async def run(self):
            return verdicts[self.server.arm]

    monkeypatch.setattr(mod, "ReplayHarness", _Harness)
    return lambda arm: _Server(arm["name"])


@pytest.mark.parametrize("mod", [tune_mod, jtune], ids=["port", "jax"])
def test_tuner_scoreboard_ranking_is_deterministic(run, monkeypatch, mod):
    """The same stubbed verdicts give the same scoreboard in both
    packages, run after run."""
    verdicts = {
        "default": _fake_verdict(100.0),
        "turbo": _fake_verdict(150.0),
        "tie-b": _fake_verdict(120.0),
        "tie-a": _fake_verdict(120.0),
        "laggy": _fake_verdict(90.0),
        "poisoned": _fake_verdict(200.0, rate=0.5),
        "flaky": _fake_verdict(180.0, failed=1),
    }
    grid = [{"name": n, "knobs": {}} if n == "default"
            else {"name": n, "knobs": {"GOFR_ML_DECODE_WINDOW": "4"}}
            for n in verdicts]
    grid.append({"name": "broken", "knobs": {"GOFR_ML_PIPELINE": "1"}})
    builder = _stub_harness(monkeypatch, mod, verdicts)

    def build(arm):
        if arm["name"] == "broken":
            raise RuntimeError("no such config")
        return builder(arm)

    boards = []
    for _ in range(2):
        tuner = mod.Tuner({"requests": []}, build, grid,
                          ttft_slo_ms=200.0, tpot_slo_ms=50.0)
        result = run(tuner.run())
        boards.append(result["scoreboard"])
    assert boards[0] == boards[1]
    order = [r["arm"] for r in boards[0]]
    assert order == ["turbo", "tie-a", "tie-b", "default", "laggy",
                     "broken", "flaky", "poisoned"]
    rows = {r["arm"]: r for r in boards[0]}
    assert rows["poisoned"]["pruned_reason"] == "identity"
    assert rows["flaky"]["pruned_reason"] == "replay_failed"
    assert rows["broken"]["pruned_reason"] == "error"
    assert "RuntimeError" in rows["broken"]["error"]
    assert result["winner"]["arm"] == "turbo"
    assert result["speedup_vs_default"] == 1.5


def test_tuner_never_recommends_slower_than_default(run, monkeypatch):
    verdicts = {
        "default": _fake_verdict(100.0, ttft_p99=400.0),
        "eco": _fake_verdict(80.0),
    }
    build = _stub_harness(monkeypatch, tune_mod, verdicts)
    tuner = Tuner({"requests": []}, build,
                  [{"name": "default", "knobs": {}},
                   {"name": "eco",
                    "knobs": {"GOFR_ML_TOKEN_BUDGET": "auto"}}],
                  ttft_slo_ms=200.0, tpot_slo_ms=50.0)
    result = run(tuner.run())
    assert result["scoreboard"][0]["arm"] == "eco"
    assert result["winner"]["arm"] == "default"
    assert result["speedup_vs_default"] == 1.0


# -- real search, real replay ------------------------------------------------------

def test_tuner_prunes_poisoned_arm_and_emits_profile(
        model, poisoned_model, run, monkeypatch, tmp_path):
    monkeypatch.setenv("GOFR_ML_CAPTURE", "64")
    cap = traffic_capture()
    cap.clear()
    server = LLMServer(_gen(model), name="tune-cap")

    async def window():
        await asyncio.gather(*(
            server.generate(p, 6, deadline_s=30.0)
            for p in ([3, 1, 4, 1], [2, 7, 1], [5, 9, 2, 6, 5])))

    try:
        run(window())
    finally:
        server.close()
    bundle = cap.export()
    assert len(bundle["requests"]) == 3

    def build(arm):
        src = poisoned_model if arm["name"] == "poisoned" else model
        return LLMServer(_gen(src), name="tune-arm")

    grid = [{"name": "default", "knobs": {}},
            {"name": "window4", "knobs": {"GOFR_ML_DECODE_WINDOW": "4"}},
            {"name": "poisoned", "knobs": {}}]
    with pytest.raises(ValueError, match="duplicate arm"):
        Tuner(bundle, build, grid + [{"name": "default", "knobs": {}}])
    tuner = Tuner(bundle, build, grid, speed=1000.0)
    result = run(tuner.run())
    rows = {r["arm"]: r for r in result["scoreboard"]}
    assert rows["poisoned"]["pruned"] is True
    assert rows["poisoned"]["pruned_reason"] == "identity"
    assert rows["poisoned"]["identity"] < 1.0
    winner, default = result["winner"], result["default"]
    assert winner["identity"] == 1.0 and not winner["pruned"]
    assert winner["steady_tok_s"] >= default["steady_tok_s"]
    assert result["speedup_vs_default"] >= 1.0
    profile = tuner.profile(result)
    path = tmp_path / "tuned.json"
    path.write_text(json.dumps(profile))
    loaded = load_profile(str(path))
    assert loaded["knobs"] == winner["knobs"]
    assert loaded["bundle"]["requests"] == 3
    assert profile_boot_warnings(loaded) == []


# -- boot-time application ---------------------------------------------------------

def test_profile_unset_constructs_nothing(model, run):
    assert profile_from_env() is None
    exp = _gen(model).generate([3, 1, 4], 6)
    ml = App(config=MapConfig({"APP_NAME": "tune-app"}))._ensure_ml()
    server = ml.register_llm("tune-plain", None, None,
                             generator=_gen(model))
    try:
        assert isinstance(server, LLMServer)
        assert not hasattr(server, "tuned_profile")
        assert "profile" not in ml.serving_snapshot()["llms"]["tune-plain"]

        async def scenario():
            return await server.generate([3, 1, 4], 6)

        assert run(scenario()) == exp
    finally:
        server.close()


def test_register_llm_applies_profile_and_restores_env(
        model, monkeypatch, tmp_path):
    cfg, params = model
    stale_runtime = runtime_fingerprint()
    stale_runtime["torch"] = "0.0.1"
    profile = {"format": PROFILE_FORMAT, "created_at": "2026-01-01T00:00:00Z",
               "runtime": stale_runtime,
               "knobs": {"GOFR_ML_DECODE_WINDOW": "4"}}
    path = tmp_path / "tuned.json"
    path.write_text(json.dumps(profile))
    monkeypatch.setenv("GOFR_ML_PROFILE", str(path))
    ml = App(config=MapConfig({"APP_NAME": "tune-app2"}))._ensure_ml()
    server = ml.register_llm("tune-boot", params, cfg, warmup=False,
                             device="cpu", batch_slots=2, max_seq=64,
                             prefill_buckets=(8, 16), page_size=8)
    try:
        assert server.gen.decode_window == 4
        assert "GOFR_ML_DECODE_WINDOW" not in os.environ
        assert server.tuned_profile["path"] == str(path)
        assert server.tuned_profile["knobs"] == {
            "GOFR_ML_DECODE_WINDOW": "4"}
        assert any("torch" in w for w in server.tuned_profile["warnings"])
        snap = ml.serving_snapshot()["llms"]["tune-boot"]
        assert snap["profile"] == server.tuned_profile
    finally:
        server.close()
    monkeypatch.delenv("GOFR_ML_PROFILE")
    with pytest.raises(ValueError, match="non-tunable"):
        ml.register_llm("tune-bad", params, cfg, warmup=False, device="cpu",
                        profile={"knobs": {"GOFR_ML_EVIL": "1"}})
    # the fleet's knobs (ROADMAP A.14a) act under a profile as in JAX: a
    # pool of two replicas; disaggregation on one replica gives JAX's
    # error. The sequence-parallel knobs reach the build: a malformed
    # GOFR_ML_SP raises naming it, and a well-formed one stays off on a
    # one-device replica (JAX's rule: it needs a replica of >= 2 devices).
    from gofr_tpu_torch.ml.replica import ReplicaPool

    pool = ml.register_llm("tune-pool", params, cfg, warmup=False,
                           device="cpu", max_seq=64, prefill_buckets=(8,),
                           profile={"knobs": {"GOFR_ML_REPLICAS": "2"}})
    try:
        assert isinstance(pool, ReplicaPool) and pool.fleet_size() == 2
        assert pool._profile_knobs == {"GOFR_ML_REPLICAS": "2"}
    finally:
        pool.close()
    assert "GOFR_ML_REPLICAS" not in os.environ
    with pytest.raises(ValueError, match="requires replicas >= 2"):
        ml.register_llm("tune-disagg", params, cfg, warmup=False,
                        device="cpu", max_seq=64, prefill_buckets=(8,),
                        profile={"knobs": {"GOFR_ML_DISAGG": "1"}})
    assert "GOFR_ML_DISAGG" not in os.environ
    with pytest.raises(ValueError, match="GOFR_ML_SP must be one of"):
        ml.register_llm("tune-unported", params, cfg, warmup=False,
                        device="cpu", max_seq=64, prefill_buckets=(8,),
                        profile={"knobs": {"GOFR_ML_SP": "1",
                                           "GOFR_ML_SP_SHARDS": "2"}})
    server = ml.register_llm("tune-sp", params, cfg, warmup=False,
                             device="cpu", max_seq=64, prefill_buckets=(8,),
                             profile={"knobs": {"GOFR_ML_SP": "ring",
                                                "GOFR_ML_SP_SHARDS": "2"}})
    try:
        assert server.gen.sp_stats() is None
    finally:
        server.close()
    assert "GOFR_ML_SP" not in os.environ
    assert "GOFR_ML_REPLICAS" not in os.environ


# -- the committed bundle ----------------------------------------------------------

class _Recorder:
    """A server proxy that keeps each replayed request's output digest."""

    def __init__(self, server, digest) -> None:
        self.server = server
        self.name = server.name
        self._digest = digest
        self.out: dict = {}

    async def stream_chunks(self, tokens, max_new, **kw):
        toks: list = []
        async for burst in self.server.stream_chunks(tokens, max_new, **kw):
            toks.extend(burst)
            yield burst
        self.out[tuple(tokens)] = self._digest(toks)


def test_committed_bundle_replays_the_same_on_both_packages(run):
    """The bundle under ``bench/`` replayed on JAX's tiny reference
    builder and on the port with the same weights gives the same output,
    request by request."""
    bundle = load_bundle(str(BENCH_BUNDLE))
    assert bundle == jreplay.load_bundle(str(BENCH_BUNDLE))
    assert len(bundle["requests"]) >= 6
    jserver = jtune._tiny_builder()({"name": "default", "knobs": {}})
    jrec = _Recorder(jserver, jtoken_digest)
    try:
        jverdict = run(jreplay.ReplayHarness(jrec, bundle,
                                             speed=1000.0).run())
        jparams = jserver.gen.params
    finally:
        jserver.close()
    cfg = llama.tiny_llama(dtype=torch.float32)
    params = llama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    server = LLMServer(
        Generator(params, cfg, batch_slots=2, max_seq=64,
                  prefill_buckets=(8, 16), page_size=8, device="cpu"),
        name="tune-arm")
    rec = _Recorder(server, token_digest)
    try:
        verdict = run(ReplayHarness(rec, bundle, speed=1000.0).run())
    finally:
        server.close()
    assert len(rec.out) == len(bundle["requests"])
    assert rec.out == jrec.out
    assert verdict["replay_failed"] == jverdict["replay_failed"] == 0
    assert verdict["identity"] == jverdict["identity"]
    assert verdict["throughput"]["out_tokens"] == \
        jverdict["throughput"]["out_tokens"]
    assert verdict["goodput"]["balanced"]


# -- the shadow canary (a replica pool's; twins of tests/test_tune.py) ------------

_JAX_OUT: dict = {}


def _jax_expected(prompts, n=6, seed=0):
    """The JAX package's single-replica greedy outputs on the weights
    ``_bridged(seed)`` bridges (one JAX Generator, memoized)."""
    from gofr_tpu.ml.generate import Generator as JGenerator

    if seed not in _JAX_OUT:
        jcfg = jllama.tiny_llama(use_flash=False, dtype=jnp.float32)
        _JAX_OUT[seed] = JGenerator(
            jllama.init_params(jcfg, jax.random.PRNGKey(seed)), jcfg,
            batch_slots=2, max_seq=64, prefill_buckets=(8, 16), page_size=8)
    return [_JAX_OUT[seed].generate(list(p), n) for p in prompts]


def _canary_pool(model, spawn_model=None, *, knobs=None, **kw):
    from gofr_tpu_torch.ml.replica import ReplicaPool

    src = spawn_model if spawn_model is not None else model
    return ReplicaPool(
        [_gen(model)], name=kw.pop("name"), spawn=lambda idx: _gen(src),
        canary={"knobs": knobs or {"GOFR_ML_DECODE_WINDOW": "4"}}, **kw)


async def _drive(pool, prompts, n=6):
    outs = []
    for p in prompts:  # sequential: each mirror settles before the next
        outs.append(await pool.generate(p, n, deadline_s=30.0))
    return outs


async def _await_decided(pool, timeout=30.0):
    import time

    t0 = time.monotonic()
    while pool._canary is not None:
        assert time.monotonic() - t0 < timeout, "canary never decided"
        await asyncio.sleep(0.05)


def _wait(cond, timeout=15.0):
    import time

    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, "condition never held"
        time.sleep(0.05)


def test_canary_mirror_bills_canary_waste_then_promotes(model, run,
                                                         monkeypatch):
    """Every admitted request is mirrored (1/1), the mirrors' tokens bill
    as ``canary`` waste while clients get the primary's tokens (the JAX
    package's), and a full window of identity-true pairs promotes the
    candidate into the fleet with a ``canary_promote`` event and a
    ``scale_up`` marked ``canary``."""
    from gofr_tpu_torch.flight_recorder import event_log
    from gofr_tpu_torch.ml.goodput import goodput_ledger

    monkeypatch.setenv("GOFR_ML_CANARY_SAMPLE", "1")
    monkeypatch.setenv("GOFR_ML_CANARY_WINDOW", "3")
    prompts = [[3, 1, 4, 1], [2, 7, 1], [5, 9, 2, 6, 5]]
    exp = _jax_expected(prompts)
    since = event_log().cursor
    pool = _canary_pool(model, name="cn-pool")
    pool._canary.slo_slack = float("inf")
    led = goodput_ledger()
    base = led.snapshot_model("cn-pool")

    async def scenario():
        outs = await _drive(pool, prompts)
        await _await_decided(pool)
        return outs

    try:
        outs = run(scenario())
        assert outs == exp
        _wait(lambda: pool.fleet_size() == 2)
        snap = pool.routing_snapshot()["canary"]
        assert snap["state"] == "promoted" and snap["replica"] == 1
        assert snap["knobs"] == {"GOFR_ML_DECODE_WINDOW": "4"}
        assert snap["mirrored"] == 3
        after = led.snapshot_model("cn-pool")
        assert after["delivered"] - base["delivered"] == sum(
            len(o) for o in outs)
        assert (after["wasted"].get("canary", 0)
                - base["wasted"].get("canary", 0)) == 3 * 6
        evs = event_log().query(since, model="cn-pool",
                                kind="canary_promote")["events"]
        assert len(evs) == 1 and evs[0]["replica"] == 1
        scale = event_log().query(since, model="cn-pool",
                                  kind="scale_up")["events"]
        assert scale and scale[-1]["canary"] is True

        async def after_promo():
            return await pool.generate(prompts[0], 6, deadline_s=30.0)

        assert run(after_promo()) == exp[0]
    finally:
        pool.close()


@pytest.mark.parametrize("how", ["slo", "identity", "crash"])
def test_canary_rolls_back(model, poisoned_model, run, monkeypatch, how):
    """A candidate whose latency medians breach the slack (``slo``), whose
    tokens differ from the primary's (``identity``: other weights, one
    mismatch is enough) or whose core fails (``crash``) rolls back and
    never joins; clients keep getting the JAX package's tokens."""
    from gofr_tpu_torch.flight_recorder import event_log

    monkeypatch.setenv("GOFR_ML_CANARY_SAMPLE", "1")
    monkeypatch.setenv("GOFR_ML_CANARY_WINDOW",
                       {"slo": "2", "identity": "8", "crash": "4"}[how])
    prompts = ([[3, 1, 4, 1], [2, 7, 1], [5, 9, 2, 6, 5]] if how == "slo"
               else [[3, 1, 4, 1], [2, 7, 1]])
    exp = _jax_expected(prompts)
    since = event_log().cursor
    name = f"cn-{how}"
    pool = _canary_pool(model, poisoned_model if how == "identity" else None,
                        name=name)
    if how == "slo":
        pool._canary.slo_slack = 0.0
    elif how == "crash":
        def boom(*args, **kwargs):
            raise RuntimeError("canary boom")

        pool._canary.core.stream_chunks = boom

    async def scenario():
        outs = await _drive(pool, prompts)
        await _await_decided(pool)
        return outs

    try:
        assert run(scenario()) == exp
        _wait(lambda: pool._canary_last is not None)
        assert pool.fleet_size() == 1
        snap = pool.routing_snapshot()["canary"]
        assert snap["state"] == "rolled_back"
        want = {"slo": "slo:", "identity": "identity",
                "crash": "canary_error:RuntimeError"}[how]
        assert snap["reason"].startswith(want)
        evs = event_log().query(since, model=name,
                                kind="canary_rollback")["events"]
        assert len(evs) == 1 and evs[0]["reason"].startswith(want)
        assert not event_log().query(since, model=name,
                                     kind="canary_promote")["events"]
    finally:
        pool.close()


def test_canary_boot_validation(model, monkeypatch):
    from gofr_tpu_torch.ml.replica import ReplicaPool

    gen = _gen(model)
    with pytest.raises(ValueError, match="spawn"):
        ReplicaPool([gen], name="cn-bad",
                    canary={"knobs": {"GOFR_ML_PIPELINE": "1"}})
    with pytest.raises(ValueError, match="knobs"):
        ReplicaPool([gen], name="cn-bad2", spawn=lambda i: _gen(model),
                    canary={"knobs": {}})
    monkeypatch.setenv("GOFR_ML_CANARY_SAMPLE", "banana")
    with pytest.raises(ValueError, match="GOFR_ML_CANARY_SAMPLE"):
        ReplicaPool([gen], name="cn-bad3", spawn=lambda i: _gen(model),
                    canary={"knobs": {"GOFR_ML_PIPELINE": "1"}})
    monkeypatch.delenv("GOFR_ML_CANARY_SAMPLE", raising=False)
    pool = ReplicaPool([gen], name="cn-off")
    try:
        assert pool._canary is None
        assert pool.routing_snapshot()["canary"] is None
    finally:
        pool.close()
