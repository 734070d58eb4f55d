"""PyTorch port, the framework's examples: each JAX example of
``examples/`` and its counterpart in ``gofr_tpu_torch/examples/`` booted
with the same environment on free local ports and sent the requests of
``tests/test_examples.py``'s matching test (``http_server`` with the
request list of the verify recipe, ``using_add_rest_handlers``,
``using_migrations``, ``using_cron_jobs``, ``using_http_service``,
``using_file_bind``, ``using_custom_metrics``): the same status and body
each time. Then the port's ``http_server`` run as a process and drained
by SIGTERM, and one service at tiny Llama f32 in both packages
(``examples/chat_store.py`` and its twin built here with ``gofr_tpu``):
API-key ``PUT /chat/{id}`` generates through ``ctx.ml.llm`` and stores
the reply through CRUD, with the JAX weights carried across by
``params_from_jax``; the stored tokens are equal.
"""

import asyncio
import contextlib
import dataclasses
import importlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request
import zipfile

import aiohttp
import jax
import numpy as np
import pytest
from aiohttp import web

from gofr_tpu.testutil import get_free_port

pytestmark = pytest.mark.timeout(240)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
PKGS = ("gofr_tpu", "gofr_tpu_torch")


def example(pkg: str, name: str):
    if pkg == "gofr_tpu":
        return importlib.import_module(f"examples.{name}.main")
    return importlib.import_module(f"gofr_tpu_torch.examples.{name}")


@contextlib.contextmanager
def example_env(**extra):
    """Free ports and quiet logs in ``os.environ`` for one boot."""
    env = {"HTTP_PORT": str(get_free_port()), "GRPC_PORT": str(get_free_port()),
           "METRICS_PORT": str(get_free_port()), "LOG_LEVEL": "ERROR",
           **{k: str(v) for k, v in extra.items()}}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield env
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def zip_bytes() -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("a.txt", "alpha")
        zf.writestr("b/c.txt", "beta")
    return buf.getvalue()


def upload_form(meta: bool) -> aiohttp.FormData:
    form = aiohttp.FormData()
    if not meta:
        form.add_field("name", "bundle")
    form.add_field("hello", zip_bytes(), filename="hello.zip",
                   content_type="application/zip")
    return form


def metrics_lines(text: str, prefixes: tuple) -> list[str]:
    return [line for line in text.splitlines() if line.startswith(prefixes)]


# name -> (extra env, [(method, path, kwargs)], the metrics lines to keep)
SCRIPTS = {
    "http_server": ({"DB_DIALECT": "sqlite", "DB_NAME": "{db}"}, [
        ("GET", "/greet", {}), ("GET", "/hello", {"params": {"name": "gofr"}}),
        ("GET", "/hello", {}), ("GET", "/raw", {}),
        ("POST", "/employee", {"json": {"name": "Ada", "role": "eng"}}),
        ("POST", "/employee", {"json": {"name": "ada", "role": "eng"}}),
        ("GET", "/employee", {}), ("GET", "/employee/2", {}),
        ("PUT", "/employee/2", {"json": {"name": "Ada L", "role": "cto"}}),
        ("DELETE", "/employee/1", {}), ("GET", "/missing/42", {}),
        ("GET", "/.well-known/alive", {}), ("GET", "/.well-known/health", {}),
        ("POST", "/greet", {}), ("GET", "/nope", {})],
        ("app_http_response_count", "# TYPE app_http_response",
         "app_sql_stats_count")),
    "using_add_rest_handlers": ({"DB_DIALECT": "sqlite", "DB_NAME": "{db}"}, [
        ("POST", "/user", {"json": {"name": "Ada", "age": 36,
                                    "is_employed": True}}),
        ("POST", "/user", {"json": {"name": "Bob", "age": 40,
                                    "is_employed": False}}),
        ("GET", "/user", {}), ("GET", "/user/2", {}),
        ("PUT", "/user/2", {"json": {"name": "Bob", "age": 41,
                                     "is_employed": True}}),
        ("GET", "/user", {}), ("DELETE", "/user/1", {}),
        ("GET", "/user/1", {})], ()),
    "using_migrations": ({"DB_DIALECT": "sqlite", "DB_NAME": "{db}"}, [
        ("POST", "/employee", {"json": {"id": 1, "name": "Grace",
                                        "email": "g@x.io"}}),
        ("GET", "/employee", {"params": {"name": "Grace"}}),
        ("GET", "/employee", {"params": {"name": "Nobody"}})], ()),
    "using_file_bind": ({}, [
        ("POST", "/upload", {"form": False}),
        ("POST", "/upload-meta", {"form": True}),
        ("POST", "/upload-meta", {"data": {"other": "x"}})], ()),
    "using_custom_metrics": ({}, [
        ("POST", "/transaction", {"json": {"amount": 100, "stock_left": 9}}),
        ("POST", "/return", {"json": {"amount": 40}})],
        ("transaction_success", "total_credit_day_sale", "product_stock",
         "transaction_time_count")),
    "using_http_service": ({"FACT_SERVICE_URL": "{facts}"}, [
        ("GET", "/fact/7", {}), ("GET", "/fact/404", {}),
        ("GET", "/.well-known/health", {})], ()),
}


async def facts_service() -> tuple[web.AppRunner, str]:
    """The downstream of ``using_http_service``."""
    async def fact(request):
        n = int(request.match_info["n"])
        if n == 404:
            return web.json_response({"error": "no fact"}, status=404)
        return web.json_response({"number": n, "fact": "interesting"})

    async def alive(_):
        return web.json_response({"data": {"status": "UP"}})

    app = web.Application()
    app.router.add_get("/fact/{n}", fact)
    app.router.add_get("/.well-known/alive", alive)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return runner, f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"


async def boot_and_drive(pkg: str, name: str, tmp_path, facts: str) -> list:
    env, calls, keep = SCRIPTS[name]
    db = tmp_path / f"{name}.db"  # one path (health names it), fresh a boot
    db.unlink(missing_ok=True)
    env = {k: v.format(db=db, facts=facts) for k, v in env.items()}
    with example_env(**env):
        app = example(pkg, name).main()
    await app.start()
    base = f"http://127.0.0.1:{app.http_port}"
    out = []
    try:
        async with aiohttp.ClientSession() as s:
            for method, path, kw in calls:
                kw = dict(kw)
                if "form" in kw:
                    kw["data"] = upload_form(kw.pop("form"))
                r = await s.request(method, base + path, **kw)
                out.append((method, path, r.status, await r.text()))
            if keep:
                r = await s.get(f"http://127.0.0.1:{app.metrics_port}"
                                "/metrics")
                out.append(metrics_lines(await r.text(), keep))
    finally:
        await app.shutdown()
    return out


@pytest.fixture(scope="module")
def examples_served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")

    async def scenario():
        runner, facts = await facts_service()
        try:
            return {(pkg, name): await boot_and_drive(pkg, name, tmp, facts)
                    for name in SCRIPTS for pkg in PKGS}
        finally:
            await runner.cleanup()

    return asyncio.run(scenario())


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_example_answers_match(examples_served, name):
    jax_out = examples_served[("gofr_tpu", name)]
    port = examples_served[("gofr_tpu_torch", name)]
    assert port == jax_out


def test_examples_answer_as_their_tests_expect(examples_served):
    got = {name: examples_served[("gofr_tpu_torch", name)]
           for name in SCRIPTS}
    http = got["http_server"]
    assert http[0][2:] == (200, '{"data": "Hello World!"}')
    assert json.loads(http[1][3])["data"] == "Hello gofr!"
    assert http[4][2] == 201  # the verify recipe's CRUD POST
    assert any(e["name"] == "Ada" for e in json.loads(http[6][3])["data"])
    assert [c[2] for c in http[10:15]] == [404, 200, 200, 405, 404]
    assert any('app_http_response_count{method="GET",path="/greet"' in line
               for line in http[-1])
    rest = got["using_add_rest_handlers"]
    assert [u["name"] for u in json.loads(rest[2][3])["data"]] == ["Ada"]
    assert json.loads(rest[3][3])["data"]["name"] == "Bob"
    assert [c[2] for c in rest[4:8]] == [200, 200, 204, 404]
    mig = got["using_migrations"]
    assert json.loads(mig[1][3])["data"][0]["email"] == "g@x.io"
    assert mig[2][2] == 404
    bind = got["using_file_bind"]
    assert json.loads(bind[0][3])["data"]["zip_entries"] == ["a.txt",
                                                             "b/c.txt"]
    assert json.loads(bind[1][3])["data"]["size"] == len(zip_bytes())
    assert bind[2][2] == 400
    assert "product_stock 9" in got["using_custom_metrics"][-1]
    svc = got["using_http_service"]
    assert json.loads(svc[0][3]) == {"number": 7, "fact": "interesting"}
    assert svc[1][2] == 404
    health = json.loads(svc[2][3])["data"]
    assert health["fact-service-service"]["status"] == "UP"


def test_migrations_example_records_both_versions(tmp_path):
    for pkg in PKGS:
        with example_env(DB_DIALECT="sqlite",
                         DB_NAME=str(tmp_path / f"{pkg}.db")):
            app = example(pkg, "using_migrations").main()
        rows = app.container.sql.query(
            "SELECT version FROM gofr_migrations ORDER BY version")
        assert [r["version"] for r in rows] == [20240226153000,
                                                20240226153001]
        asyncio.run(app.container.close())


def test_cron_example_ticks_in_both(run):
    async def scenario():
        apps, mods = [], []
        for pkg in PKGS:
            mod = example(pkg, "using_cron_jobs")
            mod._state["ticks"] = 0
            with example_env():
                app = mod.main()
            await app.start()
            apps.append(app)
            mods.append(mod)
        try:
            await asyncio.sleep(2.3)
            out = []
            async with aiohttp.ClientSession() as s:
                for app in apps:
                    r = await s.get(f"http://127.0.0.1:{app.http_port}/ticks")
                    out.append((r.status, (await r.json())["data"]["ticks"]))
            return out
        finally:
            for app in apps:
                await app.shutdown()

    (js, jt), (ts, tt) = run(scenario())
    assert js == ts == 200
    assert jt >= 1 and tt >= 1 and abs(jt - tt) <= 1


def test_http_server_process_drains_on_sigterm(tmp_path):
    """The verify recipe against the port's example as a process: greet,
    health, the metrics text, a CRUD POST answering 201, then SIGTERM:
    "draining" and "shutdown complete" in its log and exit 0."""
    ports = {k: str(get_free_port()) for k in ("HTTP_PORT", "METRICS_PORT")}
    env = {**os.environ, **ports, "DB_DIALECT": "sqlite", "LOG_LEVEL": "INFO",
           "DB_NAME": str(tmp_path / "demo.db"), "APP_NAME": "demo"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "gofr_tpu_torch.examples.http_server"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    base = f"http://127.0.0.1:{ports['HTTP_PORT']}"

    def get(url, data=None):
        req = urllib.request.Request(
            url, data=data, method="POST" if data else "GET",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read().decode()

    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                get(base + "/.well-known/alive")
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.1)
        assert get(base + "/greet") == (200, '{"data": "Hello World!"}')
        status, health = get(base + "/.well-known/health")
        assert json.loads(health)["data"]["sql"]["status"] == "UP"
        status, text = get(f"http://127.0.0.1:{ports['METRICS_PORT']}"
                           "/metrics")
        assert re.search(r'app_http_response_count\{method="GET",'
                         r'path="/greet",status="200"\} 1', text)
        status, body = get(base + "/employee",
                           json.dumps({"name": "ada", "role": "eng"}).encode())
        assert status == 201 and json.loads(body)["data"]["id"] == 1
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "shutdown signal received; draining" in out
    assert "server shutdown complete" in out


# -- one ML service at tiny Llama f32 -------------------------------------------

KEY = "k-123"
GEN_KW = dict(batch_slots=2, max_seq=64, prefill_buckets=(8, 16))
_r = np.random.default_rng(19)
PROMPTS = [_r.integers(0, 512, n).tolist() for n in (3, 7, 12)]
MAX_NEW = 6


def jax_chat_app(jparams, jcfg, db: str):
    """The JAX twin of ``gofr_tpu_torch/examples/chat_store.py``, built
    with ``gofr_tpu``'s API."""
    from gofr_tpu.app import App
    from gofr_tpu.config import MapConfig
    from gofr_tpu.crud import insert_query, scan_entity, update_query
    from gofr_tpu.http.errors import InvalidParam, MissingParam
    from gofr_tpu.migration import Migrate

    def create(ds):
        ds.sql.exec("CREATE TABLE IF NOT EXISTS chat (id INTEGER PRIMARY KEY,"
                    " prompt TEXT NOT NULL, tokens TEXT NOT NULL)")

    async def gen(ctx):
        body = await ctx.bind()
        ids = body.get("prompt_ids") if isinstance(body, dict) else None
        if not ids:
            raise MissingParam("prompt_ids")
        return ids, await ctx.ml.llm("chat").generate(
            ids, int(body.get("max_new_tokens", 32)))

    @dataclasses.dataclass
    class Chat:
        id: int = 0
        prompt: str = dataclasses.field(default="",
                                        metadata={"sql": "not_null"})
        tokens: str = dataclasses.field(default="",
                                        metadata={"sql": "not_null"})

        async def update(self, ctx):
            try:
                chat_id = int(ctx.path_param("id"))
            except ValueError:
                raise InvalidParam("id") from None
            ids, tokens = await gen(ctx)
            meta, dialect = scan_entity(Chat), ctx.sql.dialect

            def store():
                with ctx.sql.begin() as tx:
                    if tx.exec(update_query(meta, ["prompt", "tokens"],
                                            dialect),
                               json.dumps(ids), json.dumps(tokens),
                               chat_id) == 0:
                        tx.exec(insert_query(meta, meta.fields, dialect),
                                chat_id, json.dumps(ids), json.dumps(tokens))

            await asyncio.to_thread(store)
            return {"id": chat_id, "tokens": tokens}

    async def generate(ctx):
        return {"tokens": (await gen(ctx))[1]}

    app = App(config=MapConfig({"LOG_LEVEL": "ERROR", "DB_DIALECT": "sqlite",
                                "DB_NAME": db}))
    app.enable_api_key_auth(KEY)
    app.migrate({1: Migrate(up=create)})
    app.register_llm("chat", jparams, jcfg, **GEN_KW)
    app.add_rest_handlers(Chat)
    app.post("/generate", generate)
    return app


def port_chat_app(jparams, db: str):
    import torch

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.examples.chat_store import mount
    from gofr_tpu_torch.models import llama

    cfg = llama.tiny_llama(dtype=torch.float32)
    params = llama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    app = App(config=MapConfig({"LOG_LEVEL": "ERROR", "DB_DIALECT": "sqlite",
                                "DB_NAME": db}))
    return mount(app, params, cfg, api_keys=[KEY], device="cpu", **GEN_KW)


async def drive_chat(app) -> list:
    from aiohttp.test_utils import TestClient, TestServer

    client = TestClient(TestServer(app._build_http_app()))
    await client.start_server()
    auth = {"X-Api-Key": KEY}
    out = []
    try:
        calls = [("PUT", f"/chat/{i + 1}", {"prompt_ids": p,
                                             "max_new_tokens": MAX_NEW}, auth)
                 for i, p in enumerate(PROMPTS)]
        calls += [("PUT", "/chat/1", {"prompt_ids": PROMPTS[2],
                                      "max_new_tokens": 3}, auth),
                  ("GET", "/chat/1", None, auth), ("GET", "/chat/2", None, auth),
                  ("GET", "/chat", None, auth),
                  ("PUT", "/chat/4", {"prompt_ids": PROMPTS[0]}, {}),
                  ("PUT", "/chat/4", {"prompt_ids": PROMPTS[0]},
                   {"X-Api-Key": "wrong"}),
                  ("PUT", "/chat/x", {"prompt_ids": PROMPTS[0]}, auth),
                  ("PUT", "/chat/5", {}, auth),
                  ("POST", "/generate", {"prompt_ids": PROMPTS[1],
                                         "max_new_tokens": MAX_NEW}, auth),
                  ("DELETE", "/chat/3", None, auth),
                  ("GET", "/chat/3", None, auth),
                  ("GET", "/.well-known/alive", None, {})]
        for method, path, body, headers in calls:
            kw = {"json": body} if body is not None else {}
            r = await client.request(method, path, headers=headers, **kw)
            out.append((method, path, r.status, await r.text()))
    finally:
        await client.close()
        await app.shutdown()
    return out


@pytest.fixture(scope="module")
def chat_served(tmp_path_factory):
    import jax.numpy as jnp

    from gofr_tpu.models import llama as jllama

    tmp = tmp_path_factory.mktemp("chat")
    jcfg = jllama.tiny_llama(dtype=jnp.float32, use_flash=False)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    jax_app = jax_chat_app(jparams, jcfg, str(tmp / "jax.db"))
    port_app = port_chat_app(jparams, str(tmp / "port.db"))
    return {"gofr_tpu": asyncio.run(drive_chat(jax_app)),
            "gofr_tpu_torch": asyncio.run(drive_chat(port_app)),
            "dbs": {pkg: str(tmp / f"{n}.db") for pkg, n in
                    zip(PKGS, ("jax", "port"))}}


def test_chat_service_stores_the_same_tokens(chat_served):
    jax_out, port = chat_served["gofr_tpu"], chat_served["gofr_tpu_torch"]
    assert port == jax_out
    statuses = [c[2] for c in port]
    assert statuses == [200, 200, 200, 200, 200, 200, 200, 401, 401, 400,
                        400, 201, 204, 404, 200]
    for (_, _, _, body), p in zip(port[:3], PROMPTS):
        assert len(json.loads(body)["data"]["tokens"]) == MAX_NEW
    row = json.loads(port[4][3])["data"]
    assert json.loads(row["prompt"]) == PROMPTS[2]
    assert len(json.loads(row["tokens"])) == 3  # the PUT replaced it


def test_chat_service_rows_alike_on_disk(chat_served):
    import sqlite3

    rows = []
    for pkg in PKGS:
        with sqlite3.connect(chat_served["dbs"][pkg]) as conn:
            rows.append((conn.execute("SELECT * FROM chat ORDER BY id"
                                      ).fetchall(),
                         conn.execute("SELECT version, method FROM "
                                      "gofr_migrations").fetchall()))
    assert rows[1] == rows[0]
    assert rows[1][1] == [(1, "UP")] and len(rows[1][0]) == 2


def test_chip_smoke_app_phase_on_the_cpu():
    """``chip_smoke.app_phase`` (the card's phase 21) at the tiny size on
    the CPU: its checks pass there (launches are the card's; flash calls
    are counted through the model), every PUT's tokens come back from
    SQL, the breaker opens and closes, and the generator is freed."""
    import torch

    import chip_smoke
    from gofr_tpu_torch.models import llama

    cfg = llama.tiny_llama(n_layers=4)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    res = chip_smoke.app_phase(torch.device("cpu"), params, preset="tiny")
    assert res["stored_tokens"] == res["put_tokens"]
    assert res["no_key_status"] == 401 and res["cron_runs"] >= 2
    assert res["breaker"]["states"] == ["closed", "open", "closed"]
    assert sum(res["flash_calls_by_shape"].values()) \
        == res["layers"] * res["prefill_waves"]
    assert res["shutdown"] == ["on_shutdown", "container"]
