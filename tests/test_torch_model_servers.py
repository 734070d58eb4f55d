"""PyTorch port, the three model-serving examples: the port's
``gofr_tpu_torch.examples.{mnist,bert,sdxl}_server`` booted on the CPU
beside the JAX package's ``examples/{mnist,bert,sdxl}_server``, each on
free local ports, and driven with the same requests over real sockets.

The MNIST and BERT apps mount the JAX examples' own weights (seed 0,
carried across with ``params_from_jax``). Held: MNIST probabilities
within 1e-3 (the answer rounds them to 5 decimals) and the same digit
wherever the top two are more than 1e-3 apart; BERT embeddings over HTTP
and gRPC within 2e-2 of their range (bf16); the text-to-image PNG valid
(signature, CRCs, IDAT size) with JAX's dimensions and deterministic (a
prompt twice, the same bytes; the port draws its own noise, so its image
is not JAX's); the same status and message for each error case; the same
engine-path series (``app_tpu_step_seconds``, ``app_tpu_hbm_bytes_*``,
``app_ml_batch_size``, ``app_ml_queue_seconds``, ``app_ml_queue_depth``)
on ``/metrics``. Then the port's twins of
``tests/test_examples.py::test_mnist_server_example``,
``::test_bert_server_example`` and ``::test_sdxl_server_example``.
"""

import asyncio
import contextlib
import json
import os
import re
import struct
import zlib

import jax
import numpy as np
import pytest

from gofr_tpu.testutil import get_free_port

pytestmark = pytest.mark.timeout(300)


@contextlib.contextmanager
def _env(**extra):
    """Free ports and quiet logs in os.environ for one boot; the previous
    environment comes back afterwards."""
    env = {"HTTP_PORT": str(get_free_port()), "GRPC_PORT": str(get_free_port()),
           "METRICS_PORT": str(get_free_port()), "LOG_LEVEL": "ERROR",
           **extra}
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


def _range_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(want.max() - want.min())


# the engine path's series (JAX's names, kept by the port)
ENGINE_SERIES = ("app_tpu_step_seconds", "app_tpu_hbm_bytes_in_use",
                 "app_tpu_hbm_bytes_limit", "app_ml_batch_size",
                 "app_ml_queue_seconds", "app_ml_queue_depth")


def _series(text: str) -> set:
    """The (name, label names) of the engine path's series on /metrics."""
    out = set()
    for line in text.splitlines():
        m = re.match(r"^([a-z_]+)(\{[^}]*\})? ", line)
        if m and m.group(1).startswith(ENGINE_SERIES):
            labels = tuple(sorted(re.findall(r'(\w+)="', m.group(2) or "")))
            out.add((m.group(1), labels))
    return out


def _png_size(body: bytes) -> tuple[int, int]:
    """(width, height) of an 8-bit RGB PNG, after checking its signature,
    every chunk's CRC and the inflated IDAT's size."""
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(body):
        (n,) = struct.unpack(">I", body[pos:pos + 4])
        tag, data = body[pos + 4:pos + 8], body[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", body[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + data) & 0xFFFFFFFF
        chunks[tag] = data
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, color) == (8, 2) and b"IEND" in chunks
    assert len(zlib.decompress(chunks[b"IDAT"])) == h * (1 + 3 * w)
    return w, h


async def _serve(app, drive):
    await app.start()
    try:
        return await drive(app)
    finally:
        await app.shutdown()


def _both(run, boot_jax, boot_port, drive, **env):
    """The same ``drive`` against the JAX example and the port's."""
    out = []
    for boot in (boot_jax, boot_port):
        with _env(**env):
            app = boot()
        out.append(run(_serve(app, drive)))
    return out


async def _metrics(session, app) -> str:
    r = await session.get(f"http://127.0.0.1:{app.metrics_port}/metrics")
    return await r.text()


# -- config #2: MNIST ------------------------------------------------------------

def _mnist_port():
    from gofr_tpu.models.mlp import mnist_mlp as jmnist_mlp
    from gofr_tpu_torch.app import new_app
    from gofr_tpu_torch.examples.mnist_server import mount
    from gofr_tpu_torch.models import mlp

    tree = jax.tree.map(np.asarray, jmnist_mlp().params)
    return mount(new_app(), mlp.mnist_mlp(
        params=mlp.params_from_jax(tree, "cpu")))


def _mnist_jax():
    from examples.mnist_server.main import main

    return main()


IMAGES = np.random.default_rng(0).random((12, 784), dtype=np.float32)
MNIST_ERRORS = {"short": {"image": [1, 2]}, "missing": {},
                "square": {"image": np.zeros((27, 29)).tolist()}}


async def _drive_mnist(app) -> dict:
    import aiohttp

    base = f"http://127.0.0.1:{app.http_port}"
    async with aiohttp.ClientSession() as s:
        async def post(body):
            r = await s.post(base + "/predict", json=body)
            return r.status, await r.json()

        answers = await asyncio.gather(*(
            post({"image": (x.reshape(28, 28) if i % 2 else x).tolist()})
            for i, x in enumerate(IMAGES)))
        errors = {k: await post(v) for k, v in MNIST_ERRORS.items()}
        return {"answers": answers, "errors": errors,
                "metrics": await _metrics(s, app)}


def test_mnist_server_matches_jax(run):
    want, got = _both(run, _mnist_jax, _mnist_port, _drive_mnist)
    for (jst, jbody), (st, body), x in zip(want["answers"], got["answers"],
                                           IMAGES):
        assert st == jst == 201
        jp, p = np.array(jbody["data"]["probs"]), np.array(body["data"]["probs"])
        assert np.abs(p - jp).max() <= 1e-3
        top2 = np.sort(jp)[-2:]
        if top2[1] - top2[0] > 1e-3:
            assert body["data"]["digit"] == jbody["data"]["digit"]
    assert got["errors"] == want["errors"]
    assert all(st == 400 for st, _ in got["errors"].values())
    assert _series(got["metrics"]) == _series(want["metrics"])


# -- config #3: BERT -------------------------------------------------------------

def _bert_port():
    from gofr_tpu.models import bert as jbert
    from gofr_tpu_torch.app import new_app
    from gofr_tpu_torch.examples.bert_server import mount
    from gofr_tpu_torch.models import bert

    cfg = bert.tiny_bert()
    tree = jax.tree.map(np.asarray, jbert.init_params(jbert.tiny_bert(),
                                                      jax.random.PRNGKey(0)))
    return mount(new_app(), bert.Bert(
        cfg, params=bert.params_from_jax(tree, "cpu")))


def _bert_jax():
    from examples.bert_server.main import main

    return main()


_r = np.random.default_rng(1)
TOKEN_IDS = [_r.integers(0, 256, n).tolist() for n in (3, 9, 17, 40, 150)]


async def _drive_bert(app) -> dict:
    import aiohttp
    import grpc
    import grpc.aio

    base = f"http://127.0.0.1:{app.http_port}"
    channel = grpc.aio.insecure_channel(f"127.0.0.1:{app.grpc_port}")
    rpc = channel.unary_unary(
        "/ml.Embeddings/Embed",
        request_serializer=lambda o: json.dumps(o).encode(),
        response_deserializer=json.loads)

    async def grpc_call(body):
        try:
            return (await rpc(body))["embedding"]
        except grpc.aio.AioRpcError as exc:
            return exc.code().name

    try:
        async with aiohttp.ClientSession() as s:
            async def post(body):
                r = await s.post(base + "/embed", json=body)
                return r.status, await r.json()

            http = await asyncio.gather(*(post({"token_ids": ids})
                                          for ids in TOKEN_IDS))
            rpcs = await asyncio.gather(*(grpc_call({"token_ids": ids})
                                          for ids in TOKEN_IDS))
            errors = {"http_missing": await post({}),
                      "http_empty": await post({"token_ids": []}),
                      "grpc_missing": await grpc_call({})}
            return {"http": http, "grpc": rpcs, "errors": errors,
                    "metrics": await _metrics(s, app)}
    finally:
        await channel.close()


def test_bert_server_matches_jax(run):
    want, got = _both(run, _bert_jax, _bert_port, _drive_bert,
                      BERT_PRESET="tiny")
    for (jst, jbody), (st, body) in zip(want["http"], got["http"]):
        assert st == jst == 201
        assert _range_err(body["data"]["embedding"],
                          jbody["data"]["embedding"]) <= 2e-2
    for jvec, vec in zip(want["grpc"], got["grpc"]):
        assert len(vec) == len(jvec) == 64
        assert _range_err(vec, jvec) <= 2e-2
    assert got["errors"] == want["errors"]
    assert got["errors"]["http_missing"][0] == 400
    assert _series(got["metrics"]) == _series(want["metrics"])


# -- config #5: text to image ------------------------------------------------------

def _sdxl_port():
    from gofr_tpu_torch.examples.sdxl_server import main

    return main(device="cpu")


def _sdxl_jax():
    from examples.sdxl_server.main import main

    return main()


async def _drive_sdxl(app) -> dict:
    import aiohttp

    base = f"http://127.0.0.1:{app.http_port}"
    async with aiohttp.ClientSession() as s:
        async def get(path, **params):
            r = await s.get(base + path, params=params)
            return r.status, r.headers.get("Content-Type"), await r.read()

        return {"a": await get("/image", prompt="a tiny test"),
                "a_again": await get("/image", prompt="a tiny test"),
                "default": await get("/image"),
                "post": (await s.post(base + "/image")).status,
                "metrics": await _metrics(s, app)}


def test_sdxl_server_matches_jax(run):
    want, got = _both(run, _sdxl_jax, _sdxl_port, _drive_sdxl,
                      DIT_PRESET="tiny", DIT_STEPS="2")
    for key in ("a", "a_again", "default"):
        st, ctype, body = got[key]
        assert (st, ctype) == (want[key][0], want[key][1]) == \
            (200, "image/png")
        assert _png_size(body) == _png_size(want[key][2]) == (8, 8)
    assert got["a"][2] == got["a_again"][2]  # a prompt, the same bytes
    assert got["post"] == want["post"] == 405
    assert _series(got["metrics"]) == _series(want["metrics"])


# -- twins of tests/test_examples.py -------------------------------------------------

def test_port_examples_boot_and_answer(run):
    """Each port example's ``main(device="cpu")`` boots with its own seeded
    weights and its documented endpoints answer."""
    import aiohttp

    from gofr_tpu_torch.examples import bert_server, mnist_server

    async def mnist(app):
        base = f"http://127.0.0.1:{app.http_port}"
        async with aiohttp.ClientSession() as s:
            r = await s.post(base + "/predict",
                             json={"image": np.zeros(784).tolist()})
            assert r.status == 201, await r.text()
            data = (await r.json())["data"]
            assert 0 <= data["digit"] <= 9 and len(data["probs"]) == 10
            r = await s.post(base + "/predict", json={"image": [1, 2]})
            assert r.status == 400

    async def bert(app):
        base = f"http://127.0.0.1:{app.http_port}"
        async with aiohttp.ClientSession() as s:
            r = await s.post(base + "/embed",
                             json={"token_ids": [3, 1, 4, 1, 5]})
            assert r.status == 201, await r.text()
            assert len((await r.json())["data"]["embedding"]) > 0
            r = await s.post(base + "/embed", json={})
            assert r.status == 400

    for mod, drive, env in ((mnist_server, mnist, {}),
                            (bert_server, bert, {"BERT_PRESET": "tiny"})):
        with _env(**env):
            app = mod.main(device="cpu")
        run(_serve(app, drive))
