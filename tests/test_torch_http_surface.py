"""PyTorch port, the HTTP surface of the framework: the same app built in
``gofr_tpu`` and in ``gofr_tpu_torch`` (every verb, static files, the
response types, typed errors, 405, panic recovery, the request timeout,
multipart binding to a dataclass, a bad zip, path traversal, the
request's params and websocket frames), each served on a local socket
and driven with the same requests. Held equal: the status, the body and
the headers that matter (content type, ``Location``, a handler's own
header, CORS). The port's twins of ``tests/test_http_app.py``.
"""

import asyncio
import dataclasses
import importlib
import io
import json
import os
import types
import zipfile

import aiohttp
import pytest

pytestmark = pytest.mark.timeout(120)

PKGS = ("gofr_tpu", "gofr_tpu_torch")
HEADERS = ("Content-Type", "Location", "X-Custom", "Allow",
           "Access-Control-Allow-Origin", "Access-Control-Allow-Methods")


def api(pkg: str) -> types.SimpleNamespace:
    """The names a handler of either package reaches."""
    mod = importlib.import_module
    resp = mod(f"{pkg}.http.response")
    req = mod(f"{pkg}.http.request")
    return types.SimpleNamespace(
        App=mod(f"{pkg}.app").App, MapConfig=mod(f"{pkg}.config").MapConfig,
        errors=mod(f"{pkg}.http.errors"), Raw=resp.Raw,
        Redirect=resp.Redirect, Response=resp.Response,
        Template=resp.Template, File=resp.File,
        UploadedFile=req.UploadedFile, Zip=mod(f"{pkg}.fileutil").Zip)


def zip_bytes(entries: dict) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for name, data in entries.items():
            zf.writestr(name, data)
    return buf.getvalue()


def build(pkg: str, root: str):
    """The app under test, built with ``pkg``'s API."""
    a = api(pkg)
    app = a.App(config=a.MapConfig({
        "APP_NAME": "surface", "REQUEST_TIMEOUT": "0.3", "LOG_LEVEL": "FATAL",
        "ACCESS_CONTROL_ALLOW_ORIGIN": "https://ui.example.com"}))

    @dataclasses.dataclass
    class Typed:
        name: str = ""
        count: int = 0
        archive: a.Zip | None = dataclasses.field(
            default=None, metadata={"file": "bundle"})
        doc: a.UploadedFile | None = None
        raw: bytes = b""
        text: str = ""

    @dataclasses.dataclass
    class WantsZip:
        archive: a.Zip | None = None

    async def echo(ctx):
        return {"method": ctx.request.method, "id": ctx.path_param("id"),
                "q": ctx.params("q"), "host": ctx.host_name().split(":")[0],
                "body": await ctx.bind() if ctx.request.method in (
                    "POST", "PUT", "PATCH") else None}

    async def head(ctx):
        return None

    async def none(ctx):
        return None

    async def typed(ctx):
        d = await ctx.bind(Typed)
        return {"name": d.name, "count": d.count,
                "archive": d.archive.files if d.archive else None,
                "doc": [d.doc.filename, d.doc.content_type, d.doc.size,
                        d.doc.content.decode()],
                "raw": list(d.raw), "text": d.text}

    async def untyped(ctx):
        data = await ctx.bind()
        return {k: (list(v) if isinstance(v, bytes) else v)
                for k, v in data.items()}

    async def wants_zip(ctx):
        await ctx.bind(WantsZip)
        return "ok"

    async def extract(ctx):
        archive = (await ctx.bind(WantsZip)).archive
        dest = os.path.join(root, "extract", pkg)
        try:
            written = archive.create_local_copies(dest)
        except ValueError as exc:
            raise a.errors.InvalidInput(str(exc).replace(dest, "<dest>"))
        return sorted(os.path.relpath(p, dest) for p in written)

    async def slow(ctx):
        await asyncio.sleep(2)

    async def boom(ctx):
        raise RuntimeError("internal secret detail")

    def sync_handler(ctx):
        return {"sync": ctx.param("x")}

    errs = {
        "not_found": lambda: a.errors.EntityNotFound("id", "42"),
        "exists": lambda: a.errors.EntityAlreadyExists(),
        "unauthorized": lambda: a.errors.Unauthorized(),
        "forbidden": lambda: a.errors.Forbidden("no entry"),
        "invalid_param": lambda: a.errors.InvalidParam("a", "b"),
        "missing_param": lambda: a.errors.MissingParam("c"),
        "unavailable": lambda: a.errors.ServiceUnavailable(),
    }

    async def error(ctx):
        raise errs[ctx.path_param("kind")]()

    with open(os.path.join(root, "page.html"), "w") as fh:
        fh.write("<b>{who}</b> in {where}")
    with open(os.path.join(root, "blob.json"), "w") as fh:
        fh.write('{"k": 1}')
    results = {
        "raw": lambda: a.Raw([1, 2, 3]),
        "redirect": lambda: a.Redirect("https://example.com/next"),
        "redirect301": lambda: a.Redirect("/moved", 301),
        "response": lambda: a.Response({"k": "v"}, headers={"X-Custom": "yes"},
                                       meta={"page": 2}),
        "template": lambda: a.Template("page.html", {"who": "ada",
                                                     "where": "the lab"},
                                       directory=root),
        "file": lambda: a.File(b"\x00\x01binary", "application/x-thing"),
        "file_path": lambda: a.File.from_path(os.path.join(root,
                                                           "blob.json")),
        "tuple_set": lambda: {"t": (1, 2), "s": {3, 1}},
    }

    async def result(ctx):
        return results[ctx.path_param("kind")]()

    for verb in ("get", "post", "put", "patch", "delete"):
        getattr(app, verb)("/things/{id}", echo)
    app.head("/things/{id}", head)
    app.options("/opts", none)
    app.get("/things", echo)
    app.post("/typed", typed)
    app.post("/untyped", untyped)
    app.post("/zip", wants_zip)
    app.post("/extract", extract)
    app.get("/slow", slow)
    app.get("/boom", boom)
    app.get("/sync", sync_handler)
    app.get("/error/{kind}", error)
    app.get("/result/{kind}", result)
    app.add_route("post", "/lower", echo)
    static = os.path.join(root, "static")
    os.makedirs(static, exist_ok=True)
    with open(os.path.join(static, "hello.txt"), "w") as fh:
        fh.write("static hello")
    with open(os.path.join(static, "openapi.json"), "w") as fh:
        fh.write("{}")
    with open(os.path.join(root, "secret.txt"), "w") as fh:
        fh.write("outside the static dir")
    app.add_static_files("/public", static)

    async def ws_echo(ctx):
        return {"echo": await ctx.bind()}

    app.websocket("/ws", ws_echo)
    return app


def form(fields: list) -> aiohttp.FormData:
    f = aiohttp.FormData()
    for name, value, extra in fields:
        f.add_field(name, value, **extra)
    return f


TYPED = [("name", "pkg", {}), ("count", "7", {}),
         ("bundle", zip_bytes({"inner/x.txt": "zipped"}),
          {"filename": "b.zip", "content_type": "application/zip"}),
         ("doc", b"doc-bytes", {"filename": "d.bin",
                                "content_type": "application/octet-stream"}),
         ("raw", b"\x00\x01", {"filename": "r.bin",
                               "content_type": "application/octet-stream"}),
         ("text", "hello text".encode(), {"filename": "t.txt",
                                          "content_type": "text/plain"})]

# case -> (method, path, request kwargs; a form is built per request)
CASES = {
    "get": ("GET", "/things/7?q=a,b&q=c", {}),
    "get_list": ("GET", "/things", {}),
    "post_json": ("POST", "/things/1", {"json": {"name": "x"}}),
    "post_empty": ("POST", "/things/1", {}),
    "post_bad_json": ("POST", "/things/1",
                      {"data": b"{nope", "headers": {
                          "Content-Type": "application/json"}}),
    "post_form": ("POST", "/things/1", {"data": {"a": "1", "b": "two"}}),
    "post_bytes": ("POST", "/things/1", {"data": b"\x00\xffraw", "headers": {
        "Content-Type": "application/octet-stream"}}),
    "put": ("PUT", "/things/2", {"json": {"v": 2}}),
    "patch": ("PATCH", "/things/3", {"json": {"v": 3}}),
    "delete": ("DELETE", "/things/4", {}),
    "head": ("HEAD", "/things/5", {}),
    "options": ("OPTIONS", "/opts", {}),
    "lowercase_method": ("POST", "/lower", {"json": [1]}),
    "sync_handler": ("GET", "/sync?x=y", {}),
    "method_not_allowed": ("PATCH", "/things", {}),
    "post_on_get_route": ("POST", "/sync", {}),
    "not_registered": ("GET", "/truly/unknown", {}),
    "favicon": ("GET", "/favicon.ico", {}),
    "panic": ("GET", "/boom", {}),
    "timeout": ("GET", "/slow", {}),
    **{f"error_{k}": ("GET", f"/error/{k}", {}) for k in (
        "not_found", "exists", "unauthorized", "forbidden", "invalid_param",
        "missing_param", "unavailable")},
    **{f"result_{k}": ("GET", f"/result/{k}", {"allow_redirects": False})
       for k in ("raw", "redirect", "redirect301", "response", "template",
                 "file", "file_path", "tuple_set")},
    "static_file": ("GET", "/public/hello.txt", {}),
    "static_openapi_forbidden": ("GET", "/public/openapi.json", {}),
    "static_traversal": ("GET", "/public/..%2Fsecret.txt", {}),
    "static_missing": ("GET", "/public/nope.txt", {}),
    "multipart_typed": ("POST", "/typed", {"form": TYPED}),
    "multipart_untyped": ("POST", "/untyped", {"form": [
        ("f", b"abc", {"filename": "f.bin"}), ("k", "v", {})]}),
    "multipart_bad_zip": ("POST", "/zip", {"form": [
        ("archive", b"not a zip", {"filename": "a.zip"})]}),
    "multipart_plain_on_file_field": ("POST", "/zip", {"form": [
        ("archive", "just text", {})]}),
    "zip_extract": ("POST", "/extract", {"form": [
        ("archive", zip_bytes({"a.txt": "1", "d/b.txt": "2"}),
         {"filename": "ok.zip"})]}),
    "zip_traversal": ("POST", "/extract", {"form": [
        ("archive", zip_bytes({"../evil.txt": "x"}),
         {"filename": "evil.zip"})]}),
}


async def drive(pkg: str, root: str) -> dict:
    from aiohttp.test_utils import TestClient, TestServer

    app = build(pkg, root)
    client = TestClient(TestServer(app._build_http_app()))
    await client.start_server()
    out = {}
    try:
        for case, (method, path, kw) in CASES.items():
            kw = dict(kw)
            if "form" in kw:
                kw["data"] = form(kw.pop("form"))
            r = await client.request(method, path, **kw)
            body = await r.read()
            out[case] = (r.status, {h: r.headers.get(h) for h in HEADERS},
                         body)
        ws = await client.ws_connect("/ws")
        frames = []
        for frame in ('{"hello": "card"}', "not json", "[1, 2]"):
            await ws.send_str(frame)
            frames.append((await ws.receive()).data)
        await ws.close()
        out["ws"] = frames
        out["ws_registered_after_close"] = len(
            app.container.websocket_connections)
    finally:
        await client.close()
        await app.container.close()
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("surface"))
    return {pkg: asyncio.run(drive(pkg, root)) for pkg in PKGS}


@pytest.mark.parametrize("case", list(CASES))
def test_same_status_body_and_headers(served, case):
    jax, port = served["gofr_tpu"][case], served["gofr_tpu_torch"][case]
    assert port == jax


def test_surface_answers_what_the_framework_promises(served):
    """The port's answers themselves (both packages agree on them): the
    envelope rules of ``tests/test_http_app.py``."""
    got = served["gofr_tpu_torch"]

    def body(case):
        return json.loads(got[case][2])

    assert got["post_json"][0] == 201
    assert body("post_json")["data"]["body"] == {"name": "x"}
    assert got["delete"][0] == 204 and got["delete"][2] == b""
    assert body("get")["data"]["q"] == ["a", "b", "c"]
    assert body("post_form")["data"]["body"] == {"a": "1", "b": "two"}
    assert got["post_bad_json"][0] == 400
    assert got["method_not_allowed"][0] == 405
    assert got["not_registered"][0] == 404
    assert body("not_registered")["error"]["message"] == "route not registered"
    assert got["panic"][0] == 500 and b"secret" not in got["panic"][2]
    assert got["timeout"][0] == 408
    assert [got[f"error_{k}"][0] for k in ("not_found", "exists",
                                           "unauthorized", "forbidden")] \
        == [404, 409, 401, 403]
    assert got["result_raw"][2] == b"[1, 2, 3]"
    assert got["result_redirect"][0] == 302
    assert got["result_redirect"][1]["Location"] == "https://example.com/next"
    assert got["result_response"][1]["X-Custom"] == "yes"
    assert body("result_response") == {"data": {"k": "v"},
                                       "meta": {"page": 2}}
    assert got["result_template"][2] == b"<b>ada</b> in the lab"
    assert got["result_file"][1]["Content-Type"] == "application/x-thing"
    assert got["static_file"][2] == b"static hello"
    assert got["static_openapi_forbidden"][0] == 403
    assert got["static_traversal"][0] == 404
    typed = body("multipart_typed")["data"]
    assert typed["archive"] == {"inner/x.txt": "zipped"}
    assert typed["doc"] == ["d.bin", "application/octet-stream", 9,
                            "doc-bytes"]
    assert typed["count"] == 7 and typed["text"] == "hello text"
    assert got["multipart_bad_zip"][0] == 400
    assert "zip" in body("multipart_bad_zip")["error"]["message"].lower()
    assert "uploaded file" in \
        body("multipart_plain_on_file_field")["error"]["message"]
    assert body("zip_extract")["data"] == ["a.txt", os.path.join("d",
                                                                 "b.txt")]
    assert got["zip_traversal"][0] == 400
    assert "escapes destination" in body("zip_traversal")["error"]["message"]
    assert got["options"][1]["Access-Control-Allow-Origin"] == \
        "https://ui.example.com"
    assert got["ws"][0] == json.dumps({"echo": {"hello": "card"}})
    assert got["ws_registered_after_close"] == 0


def test_http_metrics_label_the_route_template(run):
    """``app_http_response`` carries the route template, not the raw
    path, as JAX's does."""
    async def scenario():
        from aiohttp.test_utils import TestClient, TestServer

        from gofr_tpu_torch.app import App
        from gofr_tpu_torch.config import MapConfig

        app = App(config=MapConfig({"APP_NAME": "m", "LOG_LEVEL": "FATAL"}))

        async def h(ctx):
            return "ok"

        app.get("/m/{id}", h)
        client = TestClient(TestServer(app._build_http_app()))
        await client.start_server()
        try:
            await client.get("/m/1")
            await client.get("/m/2")
        finally:
            await client.close()
        return app.container.metrics_manager.expose_text()

    text = run(scenario())
    assert 'path="/m/{id}"' in text and 'method="GET"' in text
    assert "/m/1" not in text
