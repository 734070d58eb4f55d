"""PyTorch port, the serving front: the port's ``examples/llama_server``
app against the JAX example app, both booted on free local ports on the
CPU (tiny preset, ``LLAMA_DTYPE=f32``, the JAX weights carried across with
``params_from_jax``), and driven with the same requests over real HTTP,
WebSocket and gRPC sockets, dense and paged (``LLM_PAGE_SIZE=8``).

Held: byte-identical ``/generate`` bodies, WS token sequences and gRPC
frame sequences (prompt text and ``prompt_ids``); the same status and
message for each error case; the same ``app_llm_*`` series and counter
values on ``/metrics`` after the same traffic; the same health payload
shape while serving and after the server is closed. Then the port's twins
of ``tests/test_llm_serving.py::test_health_reports_slots``,
``::test_http_and_ws_transports`` and
``tests/test_examples.py::test_llama_server_example``.
"""

import asyncio
import contextlib
import json
import os
import re
import time

import jax
import numpy as np
import pytest
import torch

from gofr_tpu.testutil import get_free_port

pytestmark = pytest.mark.timeout(300)

MAX_NEW = 8
VOCAB = 257  # the byte-level tokenizer: 256 bytes + <eos>
_r = np.random.default_rng(0)
PROMPT_IDS = [_r.integers(0, VOCAB, n).tolist() for n in (5, 11, 17)]
# sent three times, so the paged arm's prefix cache promotes and hits it
REPEATED = _r.integers(0, VOCAB, 40).tolist()
TEXTS = ["hello", "gofr on a card"]
# the serving metrics of the front with JAX's names and labels
SERVING_METRICS = (
    "app_llm_ttft_seconds", "app_llm_tpot_seconds", "app_llm_tokens_total",
    "app_llm_queue_seconds", "app_llm_priority_queue_seconds",
    "app_llm_shed_total", "app_llm_deadline_exceeded_total",
    "app_llm_active_slots", "app_llm_free_pages", "app_llm_evictions",
    "app_llm_prefix_evictions", "app_llm_token_budget",
    "app_llm_prefill_share", "app_llm_chunk_tokens")
# series whose values the same traffic fixes, scraped once the serving
# thread is idle (``_idle_metrics``); ``app_llm_prefill_share`` follows the
# host's pace: its series is compared, not its value
STEADY = ("app_llm_tokens_total", "app_llm_shed_total",
          "app_llm_deadline_exceeded_total", "app_llm_ttft_seconds_count",
          "app_llm_tpot_seconds_count", "app_llm_queue_seconds_count",
          "app_llm_priority_queue_seconds_count", "app_llm_active_slots",
          "app_llm_evictions", "app_llm_prefix_evictions",
          "app_llm_token_budget", "app_llm_free_pages")
ERRORS = ("missing", "overlong", "bad_priority", "bad_deadline",
          "deadline_mid_decode", "closed")
ARMS = {"dense": {}, "paged": {"LLM_PAGE_SIZE": "8"}}


@contextlib.contextmanager
def _env(**extra):
    """Free ports, the tiny f32 model and quiet logs in os.environ; the
    previous environment comes back afterwards."""
    env = {"HTTP_PORT": str(get_free_port()), "GRPC_PORT": str(get_free_port()),
           "METRICS_PORT": str(get_free_port()), "LOG_LEVEL": "ERROR",
           "LLAMA_PRESET": "tiny", "LLAMA_DTYPE": "f32", "LLM_SLOTS": "2",
           "LLM_CHUNK": "2", **extra}
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


def _metrics(text: str) -> dict:
    """{(name, labels): value} of the serving series on /metrics."""
    out = {}
    for line in text.splitlines():
        m = re.match(r"^([a-z_]+)(\{[^}]*\})? (\S+)$", line)
        if m and m.group(1).startswith(SERVING_METRICS):
            out[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return out


async def _idle_metrics(s, app, llm) -> dict:
    """The serving series once the serving thread is idle: no live slot,
    nothing queued, and the pool gauges written after the last release
    (a pass exports them before it releases its finished slots; the next,
    idle pass exports them again). Polled against a 10 s deadline."""
    url = f"http://127.0.0.1:{app.metrics_port}/metrics"
    key = ("app_llm_free_pages", '{model="chat"}')
    deadline = time.monotonic() + 10.0
    while True:
        got = _metrics(await (await s.get(url)).text())
        idle = not llm._active and llm.queue_depth() == 0
        if idle and (key not in got or
                     got[key] == float(llm.gen.free_pages)):
            return got
        assert time.monotonic() < deadline, "the server never went idle"
        await asyncio.sleep(0.02)


def _slow_steps(llm, seconds: float):
    """Slow the server's decode cadence by ``seconds`` a dispatch: an
    instance attribute over ``Generator.step``, the same on both sides."""
    inner = type(llm.gen).step.__get__(llm.gen)

    def step():
        time.sleep(seconds)
        inner()

    llm.gen.step = step
    return lambda: llm.gen.__dict__.pop("step", None)


async def _drive(app, llm) -> dict:
    """The same request sequence against one booted app."""
    import aiohttp
    import grpc
    import grpc.aio

    base = f"http://127.0.0.1:{app.http_port}"
    res: dict = {"generate": [], "ws": [], "grpc": [], "errors": {}}
    channel = grpc.aio.insecure_channel(f"127.0.0.1:{app.grpc_port}")
    rpc = channel.unary_stream(
        "/llm.Chat/Generate",
        request_serializer=lambda o: json.dumps(o).encode(),
        response_deserializer=json.loads)

    async def grpc_call(body):
        frames = []
        try:
            async for frame in rpc(body):
                frames.append(frame)
            return frames
        except grpc.aio.AioRpcError as exc:
            return [exc.code().name, exc.details()]

    async def http(s, body):
        r = await s.post(base + "/generate", json=body)
        return r.status, await r.text()

    async def ws_tokens(s, body):
        ws = await s.ws_connect(base + "/stream")
        await ws.send_json(body)
        toks = []
        while True:
            frame = await ws.receive_json()
            if "done" in frame:
                break
            toks.append(frame["token"])
        await ws.close()
        return toks

    async with aiohttp.ClientSession() as s:
        for ids in [*PROMPT_IDS, REPEATED, REPEATED, REPEATED]:
            body = {"prompt_ids": ids, "max_new_tokens": MAX_NEW}
            res["generate"].append(await http(s, body))
            res["ws"].append(await ws_tokens(s, body))
            res["grpc"].append(await grpc_call(body))
        for text in TEXTS:
            body = {"prompt": text, "max_new_tokens": MAX_NEW}
            res["generate"].append(await http(s, body))
            res["ws"].append(await ws_tokens(s, body))
        cache = getattr(llm, "prefix_cache", None)
        res["prefix_hits"] = None if cache is None else cache.hits
        res["metrics"] = await _idle_metrics(s, app, llm)
        r = await s.get(base + "/.well-known/health")
        res["health"] = (r.status, await r.json())

        ok = {"prompt_ids": PROMPT_IDS[0], "max_new_tokens": MAX_NEW}
        cases = {"missing": {"max_new_tokens": MAX_NEW},
                 "overlong": {"prompt_ids": list(range(1, 201)),
                              "max_new_tokens": MAX_NEW},
                 "bad_priority": {**ok, "priority": "urgent"},
                 "bad_deadline": {**ok, "deadline_s": -1}}
        for case, body in cases.items():
            res["errors"][case] = (await http(s, body),
                                   await grpc_call(body))
        # a deadline that passes mid-decode: 8 tokens stream in before it
        undo = _slow_steps(llm, 0.03)
        try:
            body = {**ok, "max_new_tokens": 100, "deadline_s": 0.3}
            res["errors"]["deadline_mid_decode"] = (await http(s, body),
                                                    await grpc_call(body))
        finally:
            undo()
        res["metrics_after_deadline"] = await _idle_metrics(s, app, llm)
        llm.close()
        res["errors"]["closed"] = (await http(s, ok), await grpc_call(ok))
        r = await s.get(base + "/.well-known/health")
        res["health_closed"] = (r.status, await r.json())
    await channel.close()
    return res


def _boot_jax():
    from examples.llama_server.main import main

    app = main()
    return app, app.container.ml.llm("chat")


def _boot_port(jparams):
    from gofr_tpu_torch.app import new_app
    from gofr_tpu_torch.examples.llama_server import mount
    from gofr_tpu_torch.models import llama

    cfg = llama.config_from_env(tiny_vocab_size=VOCAB)
    params = llama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    app = mount(new_app(), params, cfg, device="cpu")
    return app, app.container.ml.llm("chat")


@pytest.fixture(scope="module", params=list(ARMS))
def served(request):
    """(JAX results, port results) of one arm."""
    async def scenario():
        out = []
        with _env(**ARMS[request.param]):
            japp, jllm = _boot_jax()
            jparams = jllm.gen.params
        with _env(**ARMS[request.param]):
            tapp, tllm = _boot_port(jparams)
        for app, llm in ((japp, jllm), (tapp, tllm)):
            await app.start()
            try:
                out.append(await _drive(app, llm))
            finally:
                await app.shutdown()
        return out

    jres, tres = asyncio.run(scenario())
    return request.param, jres, tres


def test_generate_bodies_byte_identical(served):
    arm, jres, tres = served
    assert all(status == 201 for status, _ in jres["generate"]), jres
    assert tres["generate"] == jres["generate"]
    # the text round trip through the tokenizer, and 8 tokens each
    for status, body in tres["generate"]:
        data = json.loads(body)["data"]
        assert len(data["tokens"]) == MAX_NEW
    assert all("text" in json.loads(b)["data"]
               for _, b in tres["generate"][-len(TEXTS):])


def test_ws_token_sequences_identical(served):
    _, jres, tres = served
    assert tres["ws"] == jres["ws"]
    assert [len(t) for t in tres["ws"]] == [MAX_NEW] * len(tres["ws"])
    # WS tokens equal the /generate tokens of the same request
    assert tres["ws"] == [json.loads(b)["data"]["tokens"]
                          for _, b in tres["generate"]]


def test_grpc_frame_sequences_identical(served):
    _, jres, tres = served
    assert tres["grpc"] == jres["grpc"]
    for frames, (_, body) in zip(tres["grpc"], tres["generate"]):
        assert len(frames) > 1  # one frame a decode burst, not one in all
        assert [t for f in frames for t in f["tokens"]] == \
            json.loads(body)["data"]["tokens"]


@pytest.mark.parametrize("case", ERRORS)
@pytest.mark.parametrize("transport", ["http", "grpc"])
def test_error_status_and_message_match(served, case, transport):
    _, jres, tres = served
    i = 0 if transport == "http" else 1
    want, got = jres["errors"][case][i], tres["errors"][case][i]
    if transport == "http":
        assert got == want
        status, message = got[0], json.loads(got[1])["error"]["message"]
    else:
        # frames streamed before a mid-decode deadline are not compared:
        # their count depends on the host's pace; the status and message are
        assert got[-2:] == want[-2:]
        status, message = got[-2:]
    expect = {"missing": (400, "INTERNAL", "missing parameter"),
              "overlong": (400, "INVALID_ARGUMENT", "out of range"),
              "bad_priority": (400, "INVALID_ARGUMENT", "unknown priority"),
              "bad_deadline": (400, "INVALID_ARGUMENT", "deadline_s"),
              "deadline_mid_decode": (504, "DEADLINE_EXCEEDED",
                                      "deadline exceeded mid-generation"),
              "closed": (503, "UNAVAILABLE", "llm server is closed")}[case]
    assert status == expect[0 if transport == "http" else 1], got
    if transport == "http" or case != "missing":
        assert expect[2] in message, got
    else:  # the gRPC handler reads request["prompt_ids"]: a KeyError,
        assert message == "internal error"  # sanitized as INTERNAL


def test_paged_arm_hits_the_prefix_cache(served):
    arm, jres, tres = served
    if arm == "dense":
        assert tres["prefix_hits"] is None
    else:
        assert tres["prefix_hits"] >= 1


def test_metrics_series_and_counters_match(served):
    _, jres, tres = served
    jm, tm = jres["metrics"], tres["metrics"]
    assert set(tm) == set(jm)
    steady = {k: v for k, v in jm.items() if k[0] in STEADY}
    assert {k: tm[k] for k in steady} == steady
    assert tm[("app_llm_tokens_total", '{model="chat"}')] == \
        MAX_NEW * (len(PROMPT_IDS) * 3 + 9 + 2 * len(TEXTS))
    assert tm[("app_llm_ttft_seconds_count", '{model="chat"}')] == \
        len(PROMPT_IDS) * 3 + 9 + 2 * len(TEXTS)
    key = ("app_llm_deadline_exceeded_total", '{model="chat"}')
    assert tres["metrics_after_deadline"][key] == \
        jres["metrics_after_deadline"][key] == 2


def test_health_payload_shape_matches(served):
    _, jres, tres = served

    def shape(obj):
        if isinstance(obj, dict):
            return {k: shape(v) for k, v in obj.items()}
        return type(obj).__name__

    assert tres["health"][0] == jres["health"][0] == 200
    assert shape(tres["health"][1]) == shape(jres["health"][1])
    chat = tres["health"][1]["data"]["ml"]["details"]["llms"]["chat"]
    jchat = jres["health"][1]["data"]["ml"]["details"]["llms"]["chat"]
    assert chat == jchat  # slots, served, decode steps, state: equal too
    assert tres["health_closed"][0] == jres["health_closed"][0] == 503
    assert shape(tres["health_closed"][1]) == shape(jres["health_closed"][1])
    assert tres["health_closed"][1]["error"]["ml"]["status"] == "DOWN"


# -- the port's twins of the JAX serving tests ----------------------------------

@pytest.fixture(scope="module")
def model():
    from gofr_tpu_torch.models import llama

    cfg = llama.tiny_llama(dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    return cfg, params


def test_health_reports_slots(model, run):
    from gofr_tpu_torch.ml.generate import Generator
    from gofr_tpu_torch.ml.llm import LLMServer

    cfg, params = model

    async def scenario():
        server = LLMServer(Generator(params, cfg, batch_slots=3, max_seq=64,
                                     prefill_buckets=(8,), device="cpu"))
        try:
            await server.generate([1, 2], 2)
            return server.health_check()
        finally:
            server.close()

    h = run(scenario())
    assert h["status"] == "UP"
    assert h["details"]["slots"] == 3
    assert h["details"]["served"] == 1


def test_http_and_ws_transports(model, run):
    """``register_llm`` with handlers of its own: POST /generate answers
    201 and the WS frames carry the same tokens as a lone Generator."""
    from aiohttp.test_utils import TestClient, TestServer

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.ml.generate import Generator

    cfg, params = model
    expect = Generator(params, cfg, batch_slots=1, max_seq=64,
                       prefill_buckets=(8,), device="cpu").generate([2, 7, 1], 5)

    async def scenario():
        app = App(config=MapConfig({"APP_NAME": "llm-test"}))
        app.register_llm("chat", params, cfg, batch_slots=2, max_seq=64,
                         prefill_buckets=(8,), device="cpu")

        async def generate(ctx):
            body = await ctx.bind()
            toks = await ctx.ml.llm("chat").generate(
                body["prompt_ids"], int(body.get("max_new_tokens", 8)))
            return {"tokens": toks}

        async def stream_ws(ctx):
            body = await ctx.bind()
            async for tok in ctx.ml.llm("chat").stream(
                    body["prompt_ids"], int(body.get("max_new_tokens", 8))):
                await ctx.write_message_to_socket({"token": tok})
            return {"done": True}

        app.post("/generate", generate)
        app.websocket("/stream", stream_ws)
        client = TestClient(TestServer(app._build_http_app()))
        await client.start_server()
        try:
            r = await client.post("/generate", json={
                "prompt_ids": [2, 7, 1], "max_new_tokens": 5})
            assert r.status == 201  # POST with data -> 201
            body = await r.json()
            ws = await client.ws_connect("/stream")
            await ws.send_json({"prompt_ids": [2, 7, 1], "max_new_tokens": 5})
            ws_tokens = []
            while len(ws_tokens) < 5:
                frame = await ws.receive_json()
                if "token" in frame:
                    ws_tokens.append(frame["token"])
            await ws.close()
            return body["data"]["tokens"], ws_tokens
        finally:
            await client.close()
            await app.container.close()

    http_tokens, ws_tokens = run(scenario())
    assert http_tokens == expect
    assert ws_tokens == expect


def test_llama_server_example(run):
    """The port's example booted by ``main`` on the CPU: text in, text
    out; a missing and an overlong prompt answer 400, not 500."""
    async def scenario():
        import aiohttp

        from gofr_tpu_torch.examples.llama_server import main

        with _env():
            app = main(device="cpu")
        await app.start()
        base = f"http://127.0.0.1:{app.http_port}"
        try:
            async with aiohttp.ClientSession() as s:
                r = await s.post(base + "/generate",
                                 json={"prompt": "hi", "max_new_tokens": 4})
                assert r.status == 201, await r.text()
                data = (await r.json())["data"]
                assert len(data["tokens"]) == 4
                assert isinstance(data["text"], str)
                r = await s.post(base + "/generate", json={})
                assert r.status == 400
                r = await s.post(base + "/generate", json={
                    "prompt_ids": list(range(1, 400)), "max_new_tokens": 4})
                assert r.status == 400  # overlong: clean reject, not 500
                r = await s.get(f"http://127.0.0.1:{app.metrics_port}"
                                "/metrics")
                assert 'app_llm_tokens_total{model="chat"} 4' in await r.text()
        finally:
            await app.shutdown()

    run(scenario())


def test_shut_down_app_releases_its_model(run):
    """After ``App.shutdown()`` nothing keeps the app, or the ``Generator``
    it served over HTTP and gRPC, alive: a process that boots app after
    app gets each one's memory back."""
    import gc
    import weakref

    async def scenario():
        import aiohttp
        import grpc.aio

        from gofr_tpu_torch.examples.llama_server import main

        with _env():
            app = main(device="cpu")
        await app.start()
        try:
            async with aiohttp.ClientSession() as s:
                r = await s.post(f"http://127.0.0.1:{app.http_port}/generate",
                                 json={"prompt": "hi", "max_new_tokens": 2})
                assert r.status == 201, await r.text()
                r = await s.get(f"http://127.0.0.1:{app.metrics_port}"
                                "/metrics")
                assert r.status == 200
            async with grpc.aio.insecure_channel(
                    f"127.0.0.1:{app.grpc_port}") as channel:
                rpc = channel.unary_stream(
                    "/llm.Chat/Generate",
                    request_serializer=lambda o: json.dumps(o).encode(),
                    response_deserializer=json.loads)
                frames = [f async for f in rpc({"prompt_ids": [1, 2, 3],
                                                "max_new_tokens": 2})]
                assert frames
        finally:
            await app.shutdown()
        return weakref.ref(app), weakref.ref(app.container.ml.llm("chat").gen)

    app_ref, gen_ref = run(scenario())
    gc.collect()
    assert app_ref() is None, "a shut-down app is still reachable"
    assert gen_ref() is None, "a shut-down app's Generator is still alive"


def test_example_entry_point_needs_a_card_or_cpu():
    """``main()`` resolves its device like every entry point: without a
    card and without ``device="cpu"`` it raises instead of running on the
    host."""
    from gofr_tpu_torch.examples.llama_server import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: main() would serve on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main()


def test_sigterm_drains_and_exits():
    """``python -m``-style boot of the example on the CPU, one request,
    then SIGTERM: the app drains, logs "server shutdown complete" and the
    process exits 0."""
    import signal
    import subprocess
    import sys
    import urllib.request

    ports = {k: str(get_free_port())
             for k in ("HTTP_PORT", "GRPC_PORT", "METRICS_PORT")}
    env = {**os.environ, **ports, "LLAMA_PRESET": "tiny", "LLAMA_DTYPE": "f32",
           "LLM_SLOTS": "2", "LOG_LEVEL": "INFO", "GOFR_ML_DRAIN_S": "5"}
    code = ("from gofr_tpu_torch.examples.llama_server import main; "
            "main(device='cpu').run()")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=root, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    base = f"http://127.0.0.1:{ports['HTTP_PORT']}"
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(base + "/.well-known/alive",
                                            timeout=2) as r:
                    assert r.status == 200
                    break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.2)
        req = urllib.request.Request(
            base + "/generate", method="POST",
            data=json.dumps({"prompt_ids": [1, 2, 3],
                             "max_new_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 201
            assert len(json.loads(r.read())["data"]["tokens"]) == 4
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "shutdown signal received; draining" in out
    assert "server shutdown complete" in out
