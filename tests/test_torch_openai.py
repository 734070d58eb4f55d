"""PyTorch port, the OpenAI-compatible front: the port's
``examples/openai_server`` against the JAX example, both booted on free
local ports on the CPU (tiny preset, ``LLAMA_DTYPE=f32``, the JAX weights
carried across with ``params_from_jax``) and sent the same bodies over real
HTTP, dense and paged (``LLM_PAGE_SIZE=8``).

Held: every JSON body equal after ``id`` and ``created`` are normalised,
SSE streams equal frame by frame, the same status and message for each
error, the same prefix-cache counters, and the same ``OPTIONS`` status and
``Access-Control-*`` headers on a GET, a POST, a 404 and an SSE stream,
with the CORS keys at their defaults (paged arm) and set (dense arm). The
port's twins of the five tests of ``tests/test_openai_api.py`` close the
file.
"""

import asyncio
import contextlib
import json
import os

import jax
import numpy as np
import pytest

from gofr_tpu.testutil import get_free_port

pytestmark = pytest.mark.timeout(300)

VOCAB = 257  # the byte-level tokenizer: 256 bytes + <eos>
CORS_SET = {"ACCESS_CONTROL_ALLOW_ORIGIN": "https://app.example",
            "ACCESS_CONTROL_ALLOW_METHODS": "GET, POST",
            "ACCESS_CONTROL_MAX_AGE": "600"}
ARMS = {"dense": CORS_SET,
        "paged": {"LLM_PAGE_SIZE": "8", "LLM_PAGES": "24"}}
SYSTEM_CHAT = {"messages": [
    {"role": "system", "content": "be terse and helpful ok"},
    {"role": "user", "content": "hi"}], "max_tokens": 6}
BLOB = "word " * 400  # far past the tiny preset's max_seq


@contextlib.contextmanager
def _env(**extra):
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


def _norm(obj):
    """A completion body or chunk with its per-call ``id`` and ``created``
    fixed (other bodies as they are)."""
    if isinstance(obj, dict) and "created" in obj and "choices" in obj:
        return {**obj, "id": "ID", "created": 0}
    return obj


def _frames(text: str) -> list:
    """The ``data:`` payloads of an SSE body, JSON ones normalised."""
    out = []
    for block in text.strip().split("\n\n"):
        for line in block.splitlines():
            if line.startswith("data: "):
                raw = line[len("data: "):]
                out.append(raw if raw == "[DONE]" else _norm(json.loads(raw)))
    return out


def _cors(headers) -> dict:
    return {k: v for k, v in headers.items()
            if k.lower().startswith("access-control-")}


async def _drive(app, llm) -> dict:
    import aiohttp

    base = f"http://127.0.0.1:{app.http_port}"
    res: dict = {}

    async def call(s, method, path, body=None, headers=None):
        r = await s.request(method, base + path, json=body, headers=headers)
        text = await r.text()
        ctype = r.headers.get("Content-Type", "")
        if ctype.startswith("text/event-stream"):
            payload = _frames(text)
        elif ctype.startswith("application/json"):
            payload = _norm(json.loads(text))
        else:
            payload = text
        return {"status": r.status, "body": payload, "cors": _cors(r.headers),
                "ctype": ctype.split(";")[0],
                "correlation": bool(r.headers.get("X-Correlation-ID"))}

    async with aiohttp.ClientSession() as s:
        chat = {"messages": [{"role": "user", "content": "hi"}],
                "max_tokens": 6}
        res["models"] = await call(s, "GET", "/v1/models")
        res["chat"] = await call(s, "POST", "/v1/chat/completions", chat)
        res["chat_missing"] = await call(s, "POST", "/v1/chat/completions", {})
        res["chat_stream"] = await call(s, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "stream"}],
            "max_tokens": 5, "stream": True})
        res["chat_stream_usage"] = await call(
            s, "POST", "/v1/chat/completions",
            {**chat, "stream": True, "stream_options": {"include_usage": True}})
        res["completion"] = await call(s, "POST", "/v1/completions", {
            "prompt": ["once upon"], "max_tokens": 4})
        res["completion_stream"] = await call(s, "POST", "/v1/completions", {
            "prompt": "once upon", "max_tokens": 4, "stream": True})
        res["completion_missing"] = await call(s, "POST", "/v1/completions",
                                               {"max_tokens": 4})
        res["completion_batch"] = await call(s, "POST", "/v1/completions", {
            "prompt": ["a", "b"], "max_tokens": 4})
        res["priority"] = await call(s, "POST", "/v1/chat/completions", chat,
                                     headers={"X-Request-Priority": "high"})
        res["bad_priority"] = await call(
            s, "POST", "/v1/chat/completions", chat,
            headers={"X-Request-Priority": "urgent"})
        res["bad_deadline"] = await call(
            s, "POST", "/v1/chat/completions", chat,
            headers={"X-Request-Deadline-S": "-1"})
        res["cache_before"] = _cache(llm)
        res["system"] = [await call(s, "POST", "/v1/chat/completions",
                                    SYSTEM_CHAT) for _ in range(2)]
        res["cache_after"] = _cache(llm)
        res["overlong"] = [
            await call(s, "POST", "/v1/chat/completions", {
                "messages": [{"role": "system", "content": "be terse"},
                             {"role": "user", "content": BLOB}],
                "max_tokens": 4}),
            await call(s, "POST", "/v1/completions",
                       {"prompt": BLOB, "max_tokens": 4}),
            await call(s, "POST", "/v1/chat/completions", {
                "messages": [{"role": "user", "content": BLOB}],
                "max_tokens": 4, "stream": True}),
            await call(s, "POST", "/v1/completions",
                       {"prompt": BLOB, "max_tokens": 4, "stream": True}),
            await call(s, "POST", "/v1/chat/completions", {
                "messages": [{"role": "user", "content": "hi"}],
                "max_tokens": 4})]
        res["options"] = await call(s, "OPTIONS", "/v1/chat/completions")
        res["not_found"] = await call(s, "GET", "/v1/nope")
    res["prefix_cache"] = _cache(llm)
    return res


def _cache(llm) -> dict | None:
    """The prefix cache's counters (None: no cache, the dense arm)."""
    if llm.prefix_cache is None:
        return None
    snap = llm.prefix_cache.snapshot()
    return {"hits": snap["hits"], "misses": snap["misses"],
            "prefill_tokens_saved": snap["prefill_tokens_saved"],
            "prefixes": len(snap["prefixes"])}


def _boot_jax():
    from examples.openai_server.main import main

    app = main()
    return app, app.container.ml.llm("gofr-llama")


def _boot_port(jparams):
    from gofr_tpu_torch.app import new_app
    from gofr_tpu_torch.examples.openai_server import mount
    from gofr_tpu_torch.models import llama

    cfg = llama.config_from_env(tiny_vocab_size=VOCAB)
    params = llama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    app = mount(new_app(), params, cfg, device="cpu")
    return app, app.container.ml.llm("gofr-llama")


@pytest.fixture(scope="module", params=list(ARMS))
def served(request):
    """(arm, JAX results, port results)."""
    async def scenario():
        out = []
        jparams = None
        for boot in (_boot_jax, _boot_port):
            # CORS reads its keys when the server starts: inside the env
            with _env(**ARMS[request.param]):
                app, llm = boot() if jparams is None else boot(jparams)
                jparams = llm.gen.params if jparams is None else jparams
                await app.start()
                try:
                    out.append(await _drive(app, llm))
                finally:
                    await app.shutdown()
        return out

    jres, tres = asyncio.run(scenario())
    return request.param, jres, tres


def test_bodies_match_after_normalising_ids(served):
    _, jres, tres = served
    for key in ("models", "chat", "chat_missing", "completion",
                "completion_missing", "completion_batch", "priority",
                "bad_priority", "bad_deadline"):
        assert tres[key]["status"] == jres[key]["status"], key
        assert tres[key]["body"] == jres[key]["body"], key
        assert tres[key]["ctype"] == jres[key]["ctype"], key


def test_sse_streams_match_frame_by_frame(served):
    _, jres, tres = served
    for key in ("chat_stream", "chat_stream_usage", "completion_stream"):
        assert tres[key]["ctype"] == jres[key]["ctype"] == "text/event-stream"
        assert tres[key]["body"] == jres[key]["body"], key
        assert len(tres[key]["body"]) > 3  # frames a burst, not one in all


def test_cors_headers_and_options_match(served):
    arm, jres, tres = served
    for key in ("options", "models", "chat", "not_found", "chat_stream"):
        assert tres[key]["cors"] == jres[key]["cors"], key
        assert tres[key]["status"] == jres[key]["status"], key
    assert tres["options"]["status"] == 200
    assert tres["not_found"]["status"] == 404
    want = "https://app.example" if arm == "dense" else "*"
    assert tres["chat_stream"]["cors"]["Access-Control-Allow-Origin"] == want
    if arm == "dense":
        assert tres["options"]["cors"]["Access-Control-Max-Age"] == "600"
        assert tres["options"]["cors"][
            "Access-Control-Allow-Methods"] == "GET, POST"
    else:
        assert tres["options"]["cors"][
            "Access-Control-Allow-Methods"] == "GET, POST, OPTIONS"
        assert "Access-Control-Max-Age" not in tres["options"]["cors"]


def test_errors_and_overlong_match(served):
    _, jres, tres = served
    assert [r["status"] for r in tres["overlong"]] == \
        [r["status"] for r in jres["overlong"]] == [400, 400, 400, 400, 200]
    assert [r["body"] for r in tres["overlong"]] == \
        [r["body"] for r in jres["overlong"]]
    for key in ("chat_missing", "completion_missing", "completion_batch",
                "bad_priority", "bad_deadline"):
        assert tres[key]["status"] == 400, (key, tres[key])


def test_system_prompt_and_prefix_cache_match(served):
    arm, jres, tres = served
    assert [r["body"] for r in tres["system"]] == \
        [r["body"] for r in jres["system"]]
    for key in ("prefix_cache", "cache_before", "cache_after"):
        assert tres[key] == jres[key], key
    if arm == "paged":
        assert tres["prefix_cache"]["hits"] >= 1


# -- the port's twins of tests/test_openai_api.py --------------------------------

def test_models_and_chat_completion(served):
    _, _, tres = served
    assert tres["models"]["status"] == 200
    assert tres["models"]["body"]["object"] == "list"
    assert tres["models"]["body"]["data"][0]["id"] == "gofr-llama"
    body = tres["chat"]["body"]
    assert tres["chat"]["status"] < 300
    assert body["object"] == "chat.completion"
    choice = body["choices"][0]
    assert choice["message"]["role"] == "assistant"
    assert isinstance(choice["message"]["content"], str)
    assert body["usage"]["completion_tokens"] <= 6
    assert tres["chat_missing"]["status"] == 400


def test_streaming_response_carries_cors_and_correlation_headers(served):
    arm, _, tres = served
    stream = tres["chat_stream"]
    assert stream["status"] == 200
    assert stream["correlation"]
    if arm == "dense":
        assert stream["cors"]["Access-Control-Allow-Origin"] == \
            "https://app.example"


def test_streaming_chat_and_completions(served):
    _, _, tres = served
    frames = tres["chat_stream"]["body"]
    assert frames[-1] == "[DONE]"
    chunks = frames[:-1]
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    assert 1 <= len(chunks[1:-1]) <= 5
    usage = tres["chat_stream_usage"]["body"][-2]["usage"]
    assert usage["completion_tokens"] == 6
    frames = tres["completion_stream"]["body"]
    assert frames[-1] == "[DONE]"
    assert all(c["object"] == "text_completion" for c in frames[:-1])
    assert frames[-2]["choices"][0]["finish_reason"] == "length"


def test_chat_system_prompt_prefix_caching(served):
    """Over pages the second identical chat hits the server's radix cache
    and equals the first (and the dense arm's) byte for byte."""
    arm, jres, tres = served
    outs = [r["body"]["choices"][0]["message"]["content"]
            for r in tres["system"]]
    assert outs[0] == outs[1]
    if arm == "paged":
        before, after = tres["cache_before"], tres["cache_after"]
        assert after["misses"] - before["misses"] == 1  # the first inserts
        assert after["hits"] - before["hits"] == 1  # the second reuses
        assert after["prefill_tokens_saved"] > before["prefill_tokens_saved"]
        assert after["prefixes"] == before["prefixes"] + 1
    else:
        assert tres["prefix_cache"] is None


def test_overlong_prompt_gets_400_not_500(served):
    _, _, tres = served
    for r in tres["overlong"][:4]:
        assert r["status"] == 400, r
        assert "out of range" in r["body"]["error"]["message"]
    assert tres["overlong"][4]["status"] == 200


@pytest.mark.parametrize("env,item", [
    pytest.param({"LLAMA_CKPT": "/nonexistent"}, "A.12", id="env0-A.12"),
    pytest.param({"TOKENIZER_JSON": "/nonexistent"}, "A.12",
                 id="env1-A.12"),
    pytest.param({"LLM_DISAGG": "1"}, "A.14a", id="env2-A.14"),
])
def test_example_knobs_of_later_items_raise(env, item):
    """A checkpoint or tokenizer file (ROADMAP A.12, ported) that does not
    exist raises FileNotFoundError at boot, as in the JAX example; the
    loading itself is held in ``tests/test_torch_hf_import.py`` and
    ``tests/test_torch_checkpoint.py``. Disaggregation (A.14a, ported)
    gives JAX's "requires replicas >= 2" on one replica and boots a
    disaggregated pool with ``GOFR_ML_REPLICAS=2`` over paged
    generators."""
    from gofr_tpu_torch.examples import openai_server

    if item == "A.14a":
        from gofr_tpu_torch.ml.replica import ReplicaPool

        with _env(**env):
            with pytest.raises(ValueError, match="requires replicas >= 2"):
                openai_server.main(device="cpu")
        with _env(GOFR_ML_REPLICAS="2",
                  LLM_PAGE_SIZE="8", **env):
            app = openai_server.main(device="cpu")
        pool = app._ensure_ml().llm(openai_server.MODEL_ID)
        try:
            assert isinstance(pool, ReplicaPool)
            assert pool.routing_snapshot()["disagg"]["ships"] == 0
        finally:
            pool.close()
        return
    with _env(**env):
        with pytest.raises(FileNotFoundError, match="nonexistent"):
            openai_server.main(device="cpu")
