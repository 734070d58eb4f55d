"""The port's serving mesh against the JAX package's, on the CPU.

Twins of ``tests/test_multihost.py``'s serving and client tests: the
ranks are subprocesses joined over ``torch.distributed``'s ``gloo`` on
127.0.0.1 with ``device="cpu"``; they load the JAX tiny model's weights
(``PRNGKey(0)``, f32), bridged into a ``Checkpointer`` directory that
``LLAMA_CKPT`` names, and every stream must equal JAX's single-process
greedy decode (``_reference_greedy``) token for token. The client twins
drive the port's ``MultiHostLLMClient`` against an in-process stand-in
for the model port. Two more tests: JAX's client streams from the port's
mesh (one wire), and a follower killed mid-stream ends every stream in a
typed error and takes rank 0 down.
"""

import asyncio
import json
import os
import struct
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jllama
from gofr_tpu.testutil import get_free_port
from gofr_tpu_torch.ml.checkpoint import Checkpointer
from gofr_tpu_torch.ml.errors import GeneratorCrashed, ServerClosed
from gofr_tpu_torch.models import llama as tllama
from gofr_tpu_torch.tracing import Tracer

pytestmark = pytest.mark.timeout(120)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SERVE_WORKER = r"""
import sys
import torch
torch.set_num_threads(1)

from gofr_tpu_torch.ml.multihost import MultiHostWorker
from gofr_tpu_torch.models import llama

pid, n, coord, port = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                       int(sys.argv[4]))
cfg = llama.tiny_llama(dtype=torch.float32)
w = MultiHostWorker(pid, n, coord, port=port if pid == 0 else 0, cfg=cfg,
                    prompt_bucket=16, heartbeat_s=1.0,
                    **{"device": "cpu", **KW})
w.run()
print(f"OK proc={pid} spec_windows={w.gen.spec_windows}", flush=True)
"""


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The JAX tiny model's PRNGKey(0) weights at f32, bridged and saved
    where ``LLAMA_CKPT`` will name them."""
    jcfg = jllama.tiny_llama(use_flash=False, dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    params = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    path = str(tmp_path_factory.mktemp("mesh") / "ckpt")
    ck = Checkpointer(path)
    ck.save(1, params)
    ck.close()
    return path


_REF: dict = {}


def _reference_greedy(prompt, max_new):
    """JAX's single-process greedy decode with the same seed (the JAX
    test's reference, memoized)."""
    key = (tuple(prompt), max_new)
    if key in _REF:
        return _REF[key]
    cfg = jllama.tiny_llama(use_flash=False, dtype=jnp.float32)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    toks = np.zeros((1, 16), np.int32)
    toks[0, :len(prompt)] = prompt
    lens = np.array([len(prompt)], np.int32)
    prefill = jax.jit(lambda p, t, l, c: jllama.prefill(p, t, l, cfg, c))
    decode = jax.jit(lambda p, t, c: jllama.decode_step(p, t, c, cfg))
    logits, cache = prefill(params, toks, lens, jllama.init_cache(cfg, 1))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    out = [int(tok[0])]
    for _ in range(max_new - 1):
        logits, cache = decode(params, tok, cache)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(int(tok[0]))
    _REF[key] = out
    return out


def _spawn(tmp_path, ckpt, n: int = 2, **kw):
    """Start an n-rank mesh on the CPU; returns (procs, logs, model port)."""
    coord = f"127.0.0.1:{get_free_port()}"
    model_port = get_free_port()
    worker = tmp_path / "serve_worker.py"
    worker.write_text(_SERVE_WORKER.replace("**KW", f"**{kw!r}"))
    env = dict(os.environ, LLAMA_CKPT=ckpt, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    logs = [open(tmp_path / f"w{i}.log", "w+") for i in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), str(n), coord, str(model_port)],
        stdout=logs[i], stderr=subprocess.STDOUT, env=env, cwd=REPO)
        for i in range(n)]
    return procs, logs, model_port


def _log(logs, i: int) -> str:
    logs[i].seek(0)
    return logs[i].read()


async def _wait_model_port(llm, procs, logs, deadline_s: float = 60.0):
    deadline = asyncio.get_running_loop().time() + deadline_s
    while True:
        try:
            await llm._ensure()
            return
        except OSError:
            dead = [i for i, p in enumerate(procs) if p.poll() is not None]
            if dead:
                raise AssertionError(
                    f"worker {dead[0]} died during startup:\n"
                    f"{_log(logs, dead[0])[-3000:]}")
            if asyncio.get_running_loop().time() > deadline:
                raise AssertionError("rank 0 never opened the model port")
            await asyncio.sleep(0.2)


def _teardown(procs, logs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=10)
    for f in logs:
        f.close()


def _expect_clean_exit(procs, logs) -> list[str]:
    outs = []
    for i, p in enumerate(procs):
        rc = p.wait(timeout=30)
        out = _log(logs, i)
        assert rc == 0, f"worker {i} exited {rc}:\n{out[-3000:]}"
        assert f"OK proc={i}" in out
        outs.append(out)
    return outs


# --------------------------------------------------- serving topology
def test_multihost_serving_topology(tmp_path, run, ckpt):
    """A front-end app streams SSE from a 2-rank gloo mesh: tokens arrive
    across the process boundary equal to JAX's single-process greedy
    decode; a rejected frame leaves the mesh serving; three concurrent
    distinct prompts each match their own decode."""
    procs, logs, model_port = _spawn(tmp_path, ckpt)
    prompt, max_new = [5, 9, 2, 7], 8

    async def scenario():
        from aiohttp.test_utils import TestClient, TestServer

        from gofr_tpu_torch.app import App
        from gofr_tpu_torch.config import MapConfig
        from gofr_tpu_torch.http.sse import EventStream
        from gofr_tpu_torch.ml.multihost import MultiHostLLMClient

        llm = MultiHostLLMClient("127.0.0.1", model_port)
        await _wait_model_port(llm, procs, logs)
        app = App(config=MapConfig({"APP_NAME": "frontend"}))

        async def gen(ctx):
            ids = [int(x) for x in ctx.param("ids").split(",")]
            n = int(ctx.param("n") or "8")
            async with EventStream(ctx) as stream:
                async for tok in llm.stream(ids, n):
                    await stream.send({"token": tok})
                await stream.done()
            return stream.response

        app.get("/generate", gen)
        client = TestClient(TestServer(app._build_http_app()))
        await client.start_server()
        try:
            ids = ",".join(map(str, prompt))
            events = []
            async with client.get(f"/generate?ids={ids}&n={max_new}") as r:
                assert r.status == 200
                assert r.headers["Content-Type"].startswith(
                    "text/event-stream")
                async for line in r.content:
                    line = line.decode().strip()
                    if line.startswith("data:") and \
                            line[5:].strip() != "[DONE]":
                        events.append(json.loads(line[5:]))
            tokens = [e["token"] for e in events if "token" in e]
            assert tokens == _reference_greedy(prompt, max_new)

            toks2 = await llm.generate([3, 1], 4)
            assert toks2 == _reference_greedy([3, 1], 4)
            # an out-of-vocab prompt is a client error frame; the mesh
            # keeps serving
            with pytest.raises(ValueError, match="token ids"):
                await llm.generate([10**7], 4)
            assert await llm.generate([3, 1], 4) == toks2

            prompts = [[5, 9, 2, 7], [3, 1], [8, 6, 4]]
            outs = await asyncio.gather(
                *(llm.generate(p, 6) for p in prompts))
            for p, o in zip(prompts, outs):
                assert o == _reference_greedy(p, 6)
            await llm.shutdown_workers()
        finally:
            await llm.close()
            await client.close()

    try:
        run(scenario())
        _expect_clean_exit(procs, logs)
    finally:
        _teardown(procs, logs)


def test_multihost_serving_with_speculation(tmp_path, run, ckpt):
    """spec_k on the mesh: every rank drafts and verifies its own slots in
    lock-step; the output equals the plain greedy decode and windows
    really ran."""
    procs, logs, model_port = _spawn(tmp_path, ckpt, spec_k=2)
    prompt = [5, 9, 2, 5, 9, 2, 5, 9]  # repetitive: drafts should land

    async def scenario():
        from gofr_tpu_torch.ml.multihost import MultiHostLLMClient

        llm = MultiHostLLMClient("127.0.0.1", model_port)
        await _wait_model_port(llm, procs, logs)
        try:
            assert await llm.generate(prompt, 8) == \
                _reference_greedy(prompt, 8)
            await llm.shutdown_workers()
        finally:
            await llm.close()

    try:
        run(scenario())
        outs = _expect_clean_exit(procs, logs)
        # the request was placed on rank 0: its windows ran there
        windows = int(outs[0].rsplit("spec_windows=", 1)[1].split()[0])
        assert windows > 0
    finally:
        _teardown(procs, logs)


def test_tp_rank_serving_with_speculation(tmp_path, run, ckpt):
    """``MultiHostWorker(spec_k=)`` over a tp rank (``device=["cpu",
    "cpu"]``: its Generator over split weights) drafts and verifies
    through each shard's window: the output equals JAX's greedy decode
    and windows ran, as JAX's multi-host Generator keeps ``spec_k`` over
    ``SHARDING_RULES`` params."""
    procs, logs, model_port = _spawn(tmp_path, ckpt, n=1, spec_k=2,
                                     device=["cpu", "cpu"])
    prompt = [5, 9, 2, 5, 9, 2, 5, 9]

    async def scenario():
        from gofr_tpu_torch.ml.multihost import MultiHostLLMClient

        llm = MultiHostLLMClient("127.0.0.1", model_port)
        await _wait_model_port(llm, procs, logs)
        try:
            assert await llm.generate(prompt, 8) == \
                _reference_greedy(prompt, 8)
            await llm.shutdown_workers()
        finally:
            await llm.close()

    try:
        run(scenario())
        outs = _expect_clean_exit(procs, logs)
        windows = int(outs[0].rsplit("spec_windows=", 1)[1].split()[0])
        assert windows > 0
    finally:
        _teardown(procs, logs)


def test_four_rank_serving_and_rank_kill(tmp_path, run, ckpt):
    """Four ranks, concurrent distinct prompts equal to their decodes, a
    prompt past ``prefill_chunk`` segmented in lock-step; then rank 0
    killed mid-stream: every stream ends in a typed error, none reports
    a false completion, the followers exit."""
    procs, logs, model_port = _spawn(tmp_path, ckpt, n=4, prefill_chunk=8)

    async def scenario():
        from gofr_tpu_torch.ml.multihost import MultiHostLLMClient

        llm = MultiHostLLMClient("127.0.0.1", model_port)
        await _wait_model_port(llm, procs, logs, deadline_s=90.0)
        try:
            prompts = [[5, 9, 2, 7], [3, 1], [8, 6, 4], [2, 2, 9, 1]]
            outs = await asyncio.wait_for(
                asyncio.gather(*(llm.generate(p, 6) for p in prompts)), 60)
            for p, o in zip(prompts, outs):
                assert o == _reference_greedy(p, 6)
            long_p = [(i % 9) + 1 for i in range(14)]
            assert await asyncio.wait_for(llm.generate(long_p, 6), 60) == \
                _reference_greedy(long_p, 6)

            started = asyncio.get_running_loop().create_future()

            async def doomed(p):
                got = []
                try:
                    async for burst in llm.stream_chunks(p, 500):
                        got.append(burst)
                        if not started.done():
                            started.set_result(None)
                except (GeneratorCrashed, ServerClosed) as exc:
                    return got, str(exc)
                return got, None

            tasks = [asyncio.create_task(doomed(p)) for p in prompts[:3]]
            await asyncio.wait_for(started, 60)
            procs[0].kill()
            results = await asyncio.wait_for(asyncio.gather(*tasks), 60)
            assert [err for _, err in results if err is not None], results
            for got, err in results:
                assert sum(len(b) for b in got) < 500
                if err is not None:
                    assert "connection" in err or "stopped" in err, err
        finally:
            await llm.close()

    try:
        run(scenario())
        # a dead rank 0 breaks the followers' collective: they exit
        for p in procs[1:]:
            assert p.wait(timeout=60) != 0
    finally:
        _teardown(procs, logs)


def test_follower_kill_errors_every_stream_and_stops_rank0(tmp_path, run,
                                                           ckpt):
    """JAX's client streams from the port's mesh (the same wire, the same
    frames), then a follower killed mid-stream: rank 0 answers every
    stream with the typed error frame within the gather's failure, no
    stream reports a false completion, and rank 0 exits."""
    procs, logs, model_port = _spawn(tmp_path, ckpt)

    async def scenario():
        from gofr_tpu.ml.errors import GeneratorCrashed as JCrashed
        from gofr_tpu.ml.errors import ServerClosed as JClosed
        from gofr_tpu.ml.multihost import MultiHostLLMClient as JClient
        from gofr_tpu_torch.ml.multihost import MultiHostLLMClient

        jllm = JClient("127.0.0.1", model_port)
        await _wait_model_port(jllm, procs, logs)
        llm = MultiHostLLMClient("127.0.0.1", model_port)
        try:
            prompts = [[5, 9, 2, 7], [3, 1], [8, 6, 4]]
            outs = await asyncio.gather(
                *(jllm.generate(p, 6) for p in prompts))
            for p, o in zip(prompts, outs):
                assert o == _reference_greedy(p, 6)
            started = asyncio.get_running_loop().create_future()

            async def doomed(client, p, typed):
                got = []
                try:
                    async for burst in client.stream_chunks(p, 500):
                        got.append(burst)
                        if not started.done():
                            started.set_result(None)
                except typed as exc:
                    return got, str(exc)
                return got, None

            tasks = [asyncio.create_task(doomed(llm, p, (GeneratorCrashed,
                                                          ServerClosed)))
                     for p in prompts[:2]]
            tasks.append(asyncio.create_task(
                doomed(jllm, prompts[2], (JCrashed, JClosed))))
            await asyncio.wait_for(started, 60)
            t0 = time.monotonic()
            procs[1].kill()
            results = await asyncio.wait_for(asyncio.gather(*tasks), 30)
            assert time.monotonic() - t0 < 20
            for got, err in results:
                assert err is not None, results
                assert sum(len(b) for b in got) < 500
                assert "connection" in err, err
        finally:
            await llm.close()
            await jllm.close()

    try:
        run(scenario())
        assert procs[0].wait(timeout=60) != 0  # rank 0 exits, failed
        assert "MODEL_PORT" in _log(logs, 0)
    finally:
        _teardown(procs, logs)


# ----------------------------------------------- client against a fake port
class _FakeModelPort:
    """An in-process stand-in for rank 0's model port: one scripted
    behaviour per accepted connection."""

    def __init__(self, behaviors):
        self._behaviors = list(behaviors)
        self.requests = []
        self._server = None
        self.port = None

    async def __aenter__(self):
        self._server = await asyncio.start_server(
            self._handle, "127.0.0.1", 0)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def __aexit__(self, *exc):
        self._server.close()
        await self._server.wait_closed()

    @staticmethod
    async def _read_frame(reader):
        header = await reader.readexactly(4)
        (size,) = struct.unpack(">I", header)
        return json.loads(await reader.readexactly(size))

    @staticmethod
    def send(writer, obj):
        raw = json.dumps(obj).encode()
        writer.write(struct.pack(">I", len(raw)) + raw)

    async def _handle(self, reader, writer):
        behavior = self._behaviors.pop(0) if self._behaviors else None
        try:
            frame = await self._read_frame(reader)
            if frame.get("op") == "generate":
                self.requests.append(frame)
            if behavior is not None:
                await behavior(self, frame, reader, writer)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            writer.close()


async def _drop_conn(port, frame, reader, writer):
    """Connection dies before any token frame."""


def _serve(bursts, *, then_drop=False):
    async def _behavior(port, frame, reader, writer):
        rid = frame["id"]
        for burst in bursts:
            port.send(writer, {"id": rid, "tokens": burst})
        if not then_drop:
            port.send(writer, {"id": rid, "done": True})
        await writer.drain()

    return _behavior


def test_client_reconnects_and_resends_before_first_token(run):
    async def scenario():
        from gofr_tpu_torch.ml.multihost import MultiHostLLMClient

        async with _FakeModelPort(
                [_drop_conn, _serve([[1, 2], [3]])]) as port:
            llm = MultiHostLLMClient("127.0.0.1", port.port)
            try:
                assert await llm.generate([5, 9], 8) == [1, 2, 3]
            finally:
                await llm.close()
            assert [r["tokens"] for r in port.requests] == [[5, 9], [5, 9]]
            assert [r["max_new"] for r in port.requests] == [8, 8]

    run(scenario())


def test_client_no_retry_once_tokens_yielded(run):
    async def scenario():
        from gofr_tpu_torch.ml.multihost import MultiHostLLMClient

        async with _FakeModelPort(
                [_serve([[7]], then_drop=True)]) as port:
            llm = MultiHostLLMClient("127.0.0.1", port.port)
            got = []
            try:
                with pytest.raises(GeneratorCrashed) as ei:
                    async for burst in llm.stream_chunks([4, 4], 16):
                        got.append(burst)
                assert got == [[7]]
                assert "mid-stream" in str(ei.value)
                assert len(port.requests) == 1
            finally:
                await llm.close()

    run(scenario())


def test_client_close_does_not_resurrect_connection(run):
    async def scenario():
        from gofr_tpu_torch.ml.multihost import MultiHostLLMClient

        async def _hang(port, frame, reader, writer):
            await asyncio.sleep(3)

        async with _FakeModelPort([_hang]) as port:
            llm = MultiHostLLMClient("127.0.0.1", port.port)
            task = asyncio.create_task(llm.generate([5, 9], 8))
            await asyncio.sleep(0.1)
            await llm.close()
            with pytest.raises(ServerClosed):
                await asyncio.wait_for(task, 10)
            assert len(port.requests) == 1
            assert llm._writer is None

    run(scenario())


def test_client_retry_budget_is_one(run):
    async def scenario():
        from gofr_tpu_torch.ml.multihost import MultiHostLLMClient

        async with _FakeModelPort([_drop_conn, _drop_conn]) as port:
            llm = MultiHostLLMClient("127.0.0.1", port.port)
            try:
                with pytest.raises(GeneratorCrashed):
                    await llm.generate([5], 4)
                assert len(port.requests) == 2
            finally:
                await llm.close()

    run(scenario())


@pytest.mark.timeout(60)
def test_client_heartbeat_gap_detects_silent_dead_port(run):
    async def scenario():
        from gofr_tpu_torch.ml.multihost import MultiHostLLMClient

        async def _silent(port, frame, reader, writer):
            await asyncio.sleep(3)

        async with _FakeModelPort([_silent, _silent]) as port:
            llm = MultiHostLLMClient("127.0.0.1", port.port,
                                     heartbeat_gap_s=0.3)
            t0 = time.monotonic()
            try:
                with pytest.raises(GeneratorCrashed):
                    await asyncio.wait_for(llm.generate([5, 9], 8), 15)
                assert time.monotonic() - t0 < 5
                assert len(port.requests) == 2
            finally:
                await llm.close()

    run(scenario())


@pytest.mark.timeout(60)
def test_client_idle_heartbeat_gap_is_not_fatal(run):
    async def scenario():
        from gofr_tpu_torch.ml.multihost import MultiHostLLMClient

        async def _serve_with_noop(port, frame, reader, writer):
            rid = frame["id"]
            port.send(writer, {"noop": True})
            port.send(writer, {"id": rid, "tokens": [1, 2]})
            port.send(writer, {"id": rid, "done": True})
            await writer.drain()

        async with _FakeModelPort([_serve_with_noop]) as port:
            llm = MultiHostLLMClient("127.0.0.1", port.port,
                                     heartbeat_gap_s=0.2)
            try:
                await llm._ensure()
                await asyncio.sleep(0.7)
                assert await llm.generate([4], 4) == [1, 2]
                assert len(port.requests) == 1
            finally:
                await llm.close()

    run(scenario())


def test_client_heartbeat_gap_validated():
    from gofr_tpu_torch.ml.multihost import MultiHostLLMClient

    with pytest.raises(ValueError, match="heartbeat_gap_s"):
        MultiHostLLMClient("127.0.0.1", 1, heartbeat_gap_s=0.0)


class _RecordingTracer(Tracer):
    def __init__(self) -> None:
        super().__init__("test", None, 1.0)


def test_client_frames_carry_traceparent(run):
    async def scenario():
        from gofr_tpu_torch.ml.multihost import MultiHostLLMClient

        tracer = _RecordingTracer()
        async with _FakeModelPort([_serve([[1]]), _serve([[2]])]) as port:
            llm = MultiHostLLMClient("127.0.0.1", port.port)
            try:
                with tracer.start_span("request") as root:
                    await llm.generate([5], 4)
            finally:
                await llm.close()
            assert port.requests[0]["traceparent"] == (
                f"00-{root.trace_id}-{root.span_id}-01")
            llm2 = MultiHostLLMClient("127.0.0.1", port.port)
            try:
                await llm2.generate([5], 4)
            finally:
                await llm2.close()
            assert "traceparent" not in port.requests[1]

    run(scenario())


# The name is kept from when a rank over several devices raised: besides
# the no-card check, this is now a parity test of a tp rank against JAX.
def test_worker_without_a_card_raises(tmp_path, run, ckpt):
    """No fallback hides the card: a rank with no CUDA device raises
    unless the caller asked for the CPU. A rank over several devices is
    tensor-parallel over them (JAX's tp over a host's chips): one rank
    with ``device=["cpu", "cpu"]`` serves streams equal to JAX's
    single-process greedy decode."""
    from gofr_tpu_torch.ml.multihost import MultiHostLLMClient, MultiHostWorker

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MultiHostWorker(0, 1, "127.0.0.1:1")._resolve_device()
    assert MultiHostWorker(0, 1, "127.0.0.1:1",
                           device="cpu")._resolve_device().type == "cpu"
    assert [d.type for d in MultiHostWorker(
        0, 1, "127.0.0.1:1", device=["cpu", "cpu"])._resolve_devices()] \
        == ["cpu", "cpu"]
    procs, logs, model_port = _spawn(tmp_path, ckpt, n=1,
                                     device=["cpu", "cpu"])

    async def scenario():
        llm = MultiHostLLMClient("127.0.0.1", model_port)
        await _wait_model_port(llm, procs, logs)
        try:
            prompts = [[5, 9, 2, 7], [3, 1]]
            outs = await asyncio.gather(
                *(llm.generate(p, 6) for p in prompts))
            for p, o in zip(prompts, outs):
                assert o == _reference_greedy(p, 6)
            await llm.shutdown_workers()
        finally:
            await llm.close()

    try:
        run(scenario())
        _expect_clean_exit(procs, logs)
    finally:
        _teardown(procs, logs)
