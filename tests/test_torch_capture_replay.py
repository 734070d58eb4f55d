"""PyTorch port, the serving time machine: traffic capture
(``ml/capture.py``) and deterministic replay (``ml/replay.py``) on the CPU,
the tiny model at f32 with the JAX weights carried across
(``params_from_jax``).

Twins of the tests of ``tests/test_capture_replay.py`` that need no
replica pool (``test_mixed_pool_window_replays_bit_identical`` waits for
ROADMAP A.14a): ``GOFR_ML_CAPTURE`` unset constructs nothing and leaves
the tokens as they are; a captured window replays at digest identity 1.0
on the same config, on fused windows and on the pipeline; the codec round
trips; chaos is classified; crash bundles carry the capture tail; and
``/debug/capture`` answers over HTTP. Then the cross-package twins: the
same records encode to the same bytes in both packages and each decodes
the other's, and a window captured on the JAX server replays on the port
at identity 1.0.
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from gofr_tpu.ml import capture as jcap
from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.ml.llm import LLMServer as JLLMServer
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch.app import App
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.ml.capture import (BUNDLE_FORMAT, decode_bundle,
                                       encode_bundle, fingerprint_drift,
                                       runtime_fingerprint, token_digest,
                                       traffic_capture)
from gofr_tpu_torch.ml.generate import Generator
from gofr_tpu_torch.ml.llm import LLMServer
from gofr_tpu_torch.ml.replay import ReplayHarness, load_bundle
from gofr_tpu_torch.models import llama

pytestmark = pytest.mark.timeout(300)

KNOBS = ("GOFR_ML_CAPTURE", "GOFR_ML_REPLAY_SPEED", "GOFR_ML_DECODE_WINDOW",
         "GOFR_ML_PIPELINE", "GOFR_ML_FAULT", "GOFR_ML_MAX_RESTARTS",
         "GOFR_ML_TOKEN_BUDGET", "GOFR_ML_JOURNEY", "GOFR_ML_GOODPUT")


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.tiny_llama(dtype=jnp.float32, use_flash=False)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = llama.tiny_llama(dtype=torch.float32)
    params = llama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return cfg, params, jcfg, jparams


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)


def _gen(model, **kw):
    cfg, params = model[:2]
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("prefill_buckets", (8, 16))
    return Generator(params, cfg, device="cpu", **kw)


def _jgen(model, **kw):
    jcfg, jparams = model[2:]
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("prefill_buckets", (8, 16))
    return JGenerator(jparams, jcfg, **kw)


def _arm(monkeypatch, ring: int = 64):
    monkeypatch.setenv("GOFR_ML_CAPTURE", str(ring))
    cap = traffic_capture()
    cap.clear()
    return cap


def _bundle(runtime) -> dict:
    return {
        "format": BUNDLE_FORMAT,
        "captured_at": 123.0,
        "runtime": runtime,
        "fleet": {"chat": {"kind": "server", "slots": 2, "page_size": 0}},
        "counts": {"exported": 2},
        "requests": [
            {"rid": "r1", "model": "chat", "t_offset_s": 0.0,
             "tokens": [3, 1, 4, 1, 5], "max_new": 8, "priority": 0,
             "deadline_s": 0.0, "mode": "chunks", "prefix": False,
             "done": True, "finish_reason": "stop", "n_out": 3,
             "digest": token_digest([9, 2, 6]), "ttft_s": 0.01,
             "tpot_s": 0.002},
            {"rid": "r2", "model": "chat", "t_offset_s": 0.25,
             "tokens": [], "max_new": 4, "priority": 2,
             "deadline_s": 1.5, "mode": "generate", "prefix": True,
             "done": True, "finish_reason": "deadline", "n_out": 0,
             "digest": None, "ttft_s": None, "tpot_s": None},
        ],
    }


# -- unit level --------------------------------------------------------------------

def test_bundle_codec_round_trip():
    bundle = _bundle(runtime_fingerprint())
    raw = encode_bundle(bundle)
    back = decode_bundle(raw)
    assert back["requests"][0]["tokens"] == [3, 1, 4, 1, 5]
    assert back["requests"][1]["tokens"] == []
    strip = [{k: v for k, v in r.items() if k != "tokens"}
             for r in bundle["requests"]]
    assert [{k: v for k, v in r.items() if k != "tokens"}
            for r in back["requests"]] == strip
    with pytest.raises(ValueError, match="format"):
        decode_bundle(encode_bundle({**bundle, "format": "other/9"}))
    with pytest.raises(ValueError, match="truncated"):
        decode_bundle(raw[:-3])


def test_fingerprint_drift_lines():
    rec = runtime_fingerprint()
    assert fingerprint_drift(rec, runtime_fingerprint()) == []
    other = json.loads(json.dumps(rec))
    other["torch"] = "99.0"
    other["devices"]["count"] = 1024
    other["knobs"]["GOFR_ML_SPEC_K"] = "4"
    other["knobs"]["GOFR_ML_CAPTURE"] = "512"
    other["knobs"]["GOFR_ML_REPLAY_SPEED"] = "4"
    drift = fingerprint_drift(rec, other)
    assert any("torch" in line for line in drift)
    assert any("count" in line for line in drift)
    assert any("GOFR_ML_SPEC_K" in line for line in drift)
    assert not any("GOFR_ML_CAPTURE" in line for line in drift)
    assert not any("GOFR_ML_REPLAY_SPEED" in line for line in drift)
    # a JAX bundle's fingerprint drifts on the port's fields, loudly
    jdrift = fingerprint_drift(jcap.runtime_fingerprint(), rec)
    assert any(line.startswith("torch: recorded None") for line in jdrift)


def test_capture_knob_validation(monkeypatch):
    from gofr_tpu_torch.ml.capture import capture_enabled

    assert not capture_enabled() and traffic_capture() is None
    monkeypatch.setenv("GOFR_ML_CAPTURE", "0")
    assert not capture_enabled()
    for bad in ("banana", "-2"):
        monkeypatch.setenv("GOFR_ML_CAPTURE", bad)
        with pytest.raises(ValueError, match="GOFR_ML_CAPTURE") as got:
            capture_enabled()
        with pytest.raises(ValueError) as want:
            jcap.capture_enabled()
        assert str(got.value) == str(want.value)


def test_replay_speed_validation(monkeypatch):
    from gofr_tpu_torch.ml.replay import replay_speed_from_env

    assert replay_speed_from_env() == 1.0
    monkeypatch.setenv("GOFR_ML_REPLAY_SPEED", "4")
    assert replay_speed_from_env() == 4.0
    for bad in ("0", "-1", "nan", "inf", "fast"):
        monkeypatch.setenv("GOFR_ML_REPLAY_SPEED", bad)
        with pytest.raises(ValueError, match="GOFR_ML_REPLAY_SPEED"):
            replay_speed_from_env()


def test_capture_ring_bounds_and_offset_normalization(monkeypatch):
    cap = _arm(monkeypatch, ring=16)
    for i in range(40):
        rec = cap.admit(f"cr{i}", model="m", tokens=[1, i], max_new=4,
                        priority=1, deadline_s=0.0, mode="chunks")
        rec.add_tokens([7, 8])
        rec.finish("stop")
    stats = cap.stats()
    assert stats["retained"] == 16 and stats["dropped"] == 24
    out = cap.export()
    assert out["counts"]["exported"] == 16
    assert out["requests"][0]["t_offset_s"] == 0.0
    assert out["requests"][0]["digest"] == token_digest([7, 8])
    one = cap.export(rid="cr39")
    assert (one["counts"]["exported"] == 1
            and one["requests"][0]["rid"] == "cr39")
    from gofr_tpu_torch.ml.capture import TrafficCapture

    tiny = TrafficCapture(capacity=4)
    for i in range(9):
        tiny.admit(f"t{i}", model="m", tokens=[i], max_new=1,
                   priority=1, deadline_s=0.0, mode="chunks")
    assert tiny.stats()["capacity"] == 4
    assert tiny.stats()["retained"] == 4 and tiny.stats()["dropped"] == 5


def test_rearming_with_new_ring_size_starts_fresh(monkeypatch):
    cap = _arm(monkeypatch, ring=24)
    assert cap.stats()["capacity"] == 24
    cap.admit("old1", model="m", tokens=[1], max_new=1, priority=1,
              deadline_s=0.0, mode="chunks").finish("stop")
    monkeypatch.setenv("GOFR_ML_CAPTURE", "48")
    fresh = traffic_capture()
    assert fresh is not cap and fresh.stats()["capacity"] == 48
    assert fresh.export()["requests"] == []
    assert traffic_capture() is fresh


# -- zero overhead ----------------------------------------------------------------

def test_capture_unset_constructs_nothing(model, run):
    """Unset: no capture machinery anywhere, and the greedy tokens equal
    the plain generator's and the JAX server's."""
    exp = _gen(model).generate([3, 1, 4], 6)
    assert exp == _jgen(model).generate([3, 1, 4], 6)
    server = LLMServer(_gen(model), name="cap-off")

    async def scenario():
        assert server._capture is None and server._cap_sampler is None
        return await server.generate([3, 1, 4], 6)

    try:
        assert run(scenario()) == exp
    finally:
        server.close()


# -- round-trip fidelity -----------------------------------------------------------

def _window_replay(model, run, monkeypatch, name, max_new, **env):
    """Capture three prompts on a paged single-step server, then replay
    them on a server that reads ``env`` (the fused path) from the
    environment, as production does."""
    cap = _arm(monkeypatch)

    def build(**kw):
        return LLMServer(_gen(model, page_size=8, **kw), name=name)

    server = build(decode_window=0, pipeline=0)

    async def window(srv):
        return await asyncio.gather(*(
            srv.generate(p, max_new, deadline_s=30.0)
            for p in ([3, 1, 4, 1], [2, 7, 1], [5, 9, 2, 6, 5])))

    try:
        outs = run(window(server))
    finally:
        server.close()
    bundle = cap.export()
    assert len(bundle["requests"]) == 3
    rows = {tuple(r["tokens"]): r for r in bundle["requests"]}
    for p, out in zip(([3, 1, 4, 1], [2, 7, 1], [5, 9, 2, 6, 5]), outs):
        assert rows[tuple(p)]["digest"] == token_digest(out)
        assert rows[tuple(p)]["mode"] == "generate"
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    replica = build()
    try:
        verdict = run(ReplayHarness(replica, bundle, speed=8.0).run())
        return verdict, replica.gen
    finally:
        replica.close()


def test_window_replay_on_fused_path_is_identical(model, run, monkeypatch):
    verdict, gen = _window_replay(model, run, monkeypatch, "cap-window", 6,
                                  GOFR_ML_DECODE_WINDOW="4")
    assert gen.decode_window == 4
    assert verdict["identity"]["compared"] == 3
    assert verdict["identity"]["rate"] == 1.0
    assert verdict["replay_failed"] == 0 and verdict["skipped"] == 0
    assert gen.window_stats()["windows"] >= 1


def test_pipelined_replay_on_double_buffered_path_is_identical(
        model, run, monkeypatch):
    verdict, gen = _window_replay(model, run, monkeypatch, "cap-pipe", 14,
                                  GOFR_ML_DECODE_WINDOW="4",
                                  GOFR_ML_PIPELINE="1")
    assert gen.decode_window == 4 and gen.pipeline == 1
    assert verdict["identity"]["compared"] == 3
    assert verdict["identity"]["rate"] == 1.0
    assert verdict["replay_failed"] == 0 and verdict["skipped"] == 0
    assert gen.pipeline_stats()["windows_overlapped"] >= 1


def test_journey_carries_output_digest(model, run, monkeypatch):
    from gofr_tpu_torch.ml.journey import journey_log

    cap = _arm(monkeypatch)
    server = LLMServer(_gen(model), name="cap-xlink")

    async def scenario():
        return await server.generate([3, 1, 4], 5)

    try:
        out = run(scenario())
    finally:
        server.close()
    row = cap.export()["requests"][-1]
    assert row["digest"] == token_digest(out)
    waterfall = journey_log().get(row["rid"]).snapshot()
    assert waterfall["request"]["output_digest"] == row["digest"]


# -- replay under chaos ------------------------------------------------------------

def _crash_once(point: str = "step"):
    fired = {"n": 0}

    def hook(p):
        if p == point and fired["n"] == 0:
            fired["n"] += 1
            raise RuntimeError("chaos step")

    return hook, fired


def _no_ledger(monkeypatch) -> None:
    """Crashes here charge no waste to the process-wide goodput ledger:
    the ``/debug/goodput`` parity test in ``test_torch_flight_recorder.py``
    compares the port's waste reasons with JAX's in the same process."""
    monkeypatch.setenv("GOFR_ML_GOODPUT", "0")


def test_chaos_window_replays_clean_with_failures_classified(
        model, run, monkeypatch):
    _no_ledger(monkeypatch)
    cap = _arm(monkeypatch)
    hook, fired = _crash_once()
    server = LLMServer(_gen(model), name="cap-chaos", fault=hook,
                       max_restarts=3)

    async def window():
        async def one(p):
            try:
                return await server.generate(p, 6, deadline_s=30.0)
            except Exception:
                return None
        return await asyncio.gather(*(one(p) for p in
                                      ([3, 1, 4], [2, 7, 1, 8],
                                       [5, 9, 2], [6, 2, 6])))

    try:
        outs = run(window())
    finally:
        server.close()
    assert fired["n"] == 1
    ok = [o for o in outs if o is not None]
    assert ok, "some requests must survive the chaos window"
    bundle = cap.export()
    assert "crashed" in {r["finish_reason"] for r in bundle["requests"]}
    clean = LLMServer(_gen(model), name="cap-chaos")
    try:
        verdict = run(ReplayHarness(clean, bundle, speed=8.0).run())
    finally:
        clean.close()
    assert verdict["recorded_failed"] >= 1
    assert verdict["identity"]["compared"] == len(ok)
    assert verdict["identity"]["rate"] == 1.0
    assert verdict["replay_failed"] == 0


# -- crash forensics ---------------------------------------------------------------

def _crash(model, run, name: str, prompt: list) -> dict:
    from gofr_tpu_torch.flight_recorder import crash_vault

    hook, _ = _crash_once()
    server = LLMServer(_gen(model), name=name, fault=hook, max_restarts=3)

    async def scenario():
        try:
            await server.generate(prompt, 8)
        except Exception:
            pass

    try:
        run(scenario())
    finally:
        server.close()
    crashes = [c for c in crash_vault().list() if c["id"].startswith(name)]
    assert crashes
    return crash_vault().get(crashes[-1]["id"])


def test_crash_bundle_embeds_capture_tail(model, run, monkeypatch, tmp_path):
    _no_ledger(monkeypatch)
    _arm(monkeypatch)
    bundle = _crash(model, run, "cap-crash", [3, 1, 4, 1, 5])
    tail = bundle["state"]["capture"]
    assert tail["format"] == BUNDLE_FORMAT
    assert any(r["tokens"] == [3, 1, 4, 1, 5] for r in tail["requests"])
    path = tmp_path / "crash.json"
    path.write_text(json.dumps({"data": bundle}))
    loaded = load_bundle(str(path))
    assert loaded["format"] == BUNDLE_FORMAT
    assert loaded["requests"] == tail["requests"]


def test_crash_bundle_has_no_capture_key_when_off(model, run, monkeypatch):
    _no_ledger(monkeypatch)
    bundle = _crash(model, run, "cap-nocap", [3, 1, 4])
    assert "capture" not in bundle["state"]


# -- HTTP surface -------------------------------------------------------------------

def test_debug_capture_endpoint_and_runtime_block(model, run, monkeypatch):
    cap = _arm(monkeypatch)

    async def scenario():
        app = App(config=MapConfig({"APP_NAME": "cap-app"}))
        ml = app._ensure_ml()
        server = LLMServer(_gen(model), name="cap-http")
        ml._llms["cap-http"] = server
        client = TestClient(TestServer(app._build_http_app()))
        await client.start_server()
        try:
            out = await server.generate([3, 1, 4], 5)
            r = await client.get("/debug/capture")
            assert r.status == 200
            assert r.content_type == "application/octet-stream"
            bundle = decode_bundle(await r.read())
            assert bundle["runtime"]["devices"]["kind"] == "cpu"
            row = bundle["requests"][-1]
            assert row["digest"] == token_digest(out)
            r = await client.get("/debug/capture",
                                 params={"rid": row["rid"]})
            one = decode_bundle(await r.read())
            assert [x["rid"] for x in one["requests"]] == [row["rid"]]
            r = await client.get("/debug/capture",
                                 params={"rid": "no-such-rid"})
            assert r.status == 404
            r = await client.get("/debug/serving")
            runtime = (await r.json())["data"]["runtime"]
            assert runtime["torch"] == bundle["runtime"]["torch"]
            assert runtime["devices"] == bundle["runtime"]["devices"]
            assert runtime["knobs"].get("GOFR_ML_CAPTURE") == "64"
            monkeypatch.delenv("GOFR_ML_CAPTURE", raising=False)
            r = await client.get("/debug/capture")
            assert (await r.json())["data"] == {
                "enabled": False, "reason": "GOFR_ML_CAPTURE unset or 0"}
        finally:
            await client.close()
            server.close()

    run(scenario())
    assert cap.stats()["captured"] >= 1


# -- across the two packages -------------------------------------------------------

def test_codec_bytes_match_the_jax_package(model, run, monkeypatch):
    """The same records encode to the same bytes in both packages, each
    decodes the other's, and a live export from the port decodes in
    JAX."""
    bundle = _bundle(jcap.runtime_fingerprint())
    raw = encode_bundle(bundle)
    assert raw == jcap.encode_bundle(bundle)
    assert decode_bundle(jcap.encode_bundle(bundle)) == \
        jcap.decode_bundle(raw)
    assert token_digest([9, 2, 6, -1]) == jcap.token_digest([9, 2, 6, -1])
    cap = _arm(monkeypatch)
    server = LLMServer(_gen(model), name="cap-codec")

    async def scenario():
        return await server.generate([3, 1, 4], 5, priority="high")

    try:
        out = run(scenario())
    finally:
        server.close()
    back = jcap.decode_bundle(cap.encode())
    row = back["requests"][-1]
    assert row["tokens"] == [3, 1, 4] and row["priority"] == 0
    assert row["digest"] == jcap.token_digest(out)
    assert row["sampler"] == {"temperature": 0.0, "top_k": 0, "top_p": 1.0}


def test_jax_window_replays_on_the_port_at_identity_one(model, run,
                                                        monkeypatch):
    """A window captured on the JAX server, through JAX's codec, replays
    on the port's server with the same weights at digest identity 1.0;
    the runtime drift is warned, not hidden."""
    monkeypatch.setenv("GOFR_ML_CAPTURE", "64")
    jc = jcap.traffic_capture()
    jc.clear()
    jserver = JLLMServer(_jgen(model), name="cap-cross")
    prompts = ([3, 1, 4, 1], [2, 7, 1], [5, 9, 2, 6, 5], [8, 8, 1])

    async def window():
        return await asyncio.gather(*(
            jserver.generate(p, 6, priority=prio, deadline_s=30.0)
            for p, prio in zip(prompts, ("high", "normal", "low", "normal"))))

    try:
        run(window())
    finally:
        jserver.close()
    bundle = decode_bundle(jc.encode())
    assert len(bundle["requests"]) == len(prompts)
    server = LLMServer(_gen(model), name="cap-cross")
    try:
        verdict = run(ReplayHarness(server, bundle, speed=8.0).run())
    finally:
        server.close()
    assert verdict["identity"]["compared"] == len(prompts)
    assert verdict["identity"]["rate"] == 1.0
    assert verdict["replay_failed"] == 0
    assert any(line.startswith("torch:")
               for line in verdict["fingerprint_drift"])
    assert verdict["goodput"]["balanced"]


def test_mixed_pool_window_replays_bit_identical(model, run, monkeypatch):
    """A greedy mixed-load window (priorities, deadlines, a 2-replica
    pool) captured at the pool front, then replayed on the same config:
    identity 1.0, the fleet block names the pool (never its cores), and
    every digest equals the JAX package's single replica on the prompt."""
    from gofr_tpu_torch.ml.replica import ReplicaPool

    cap = _arm(monkeypatch)
    prompts = [[3, 1, 4, 1], [2, 7, 1], [5, 9, 2, 6, 5],
               [3, 5, 8, 9], [7, 9, 3], [2, 3, 8, 4, 6]]
    prios = ["high", "normal", "low", "normal", "high", "low"]

    def build():
        return ReplicaPool([_gen(model), _gen(model)], name="cap-pool")

    async def window(server):
        return await asyncio.gather(*(
            server.generate(prompts[i], 6, priority=prios[i],
                            deadline_s=30.0) for i in range(len(prompts))))

    pool = build()
    try:
        outs = run(window(pool))
    finally:
        pool.close()
    jgen = _jgen(model, batch_slots=1)
    assert outs == [jgen.generate(p, 6) for p in prompts]
    bundle = cap.export()
    assert len(bundle["requests"]) == len(prompts)
    assert bundle["fleet"]["cap-pool"]["replicas"] == 2
    assert all("/" not in name for name in bundle["fleet"])
    rows = {tuple(r["tokens"]): r for r in bundle["requests"]}
    for p, out in zip(prompts, outs, strict=True):
        row = rows[tuple(p)]
        assert row["finish_reason"] == "length"
        assert row["digest"] == token_digest(out) == jcap.token_digest(out)
        assert row["deadline_s"] == 30.0 and row["mode"] == "generate"
    bundle = decode_bundle(encode_bundle(bundle))
    replay_pool = build()
    try:
        verdict = run(ReplayHarness(replay_pool, bundle, speed=8.0).run())
    finally:
        replay_pool.close()
    assert verdict["identity"]["compared"] == len(prompts)
    assert verdict["identity"]["rate"] == 1.0
    assert verdict["replay_failed"] == 0 and verdict["skipped"] == 0
