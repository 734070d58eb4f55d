"""PyTorch port, cron and inter-service clients, against ``gofr_tpu``.

Cron: ``parse_schedule`` of both packages on a fixed set of expressions
and on hypothesis-drawn ones fires on the same seconds of one day (a
leap day, so the day and weekday fields meet a rare date), and raises
the same text for invalid ones; a job registered with
``add_cron_job`` runs each second with a Context of its own in both
apps. Services: ``new_http_service`` of both packages, with the same
options, against one local downstream that fails on cue: the same
downstream hits (retries included), the same breaker states (closed,
open, half-open while its probe finds the downstream down, closed when
it is up again), the same outgoing auth and default headers, a W3C
``traceparent`` on every call, the same health results and OAuth
client-credentials token flow. Then ``add_http_service`` in an app.
"""

import asyncio
import calendar
import importlib
import re
import time

import pytest
from aiohttp import web
from hypothesis import given, settings
from hypothesis import strategies as st

pytestmark = pytest.mark.timeout(120)

PKGS = ("gofr_tpu", "gofr_tpu_torch")
# every second of 2024-02-29 (a Thursday), as the scheduler reads it
DAY = [time.gmtime(calendar.timegm((2024, 2, 29, 0, 0, 0)) + s)
       for s in range(86400)]


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def firing(pkg: str, expr: str):
    """The seconds of ``DAY`` the schedule fires on, or its error."""
    try:
        sched = mod(pkg, "cron").parse_schedule(expr)
    except ValueError as exc:
        return (type(exc).__name__, str(exc))
    return [i for i, t in enumerate(DAY) if sched.matches(t)]


FIXED = ["* * * * * *", "*/15 * * * *", "0 0 * * *", "30 */2 * * * *",
         "0 9-17/2 * * 1-5", "0 0 29 2 *", "0 0 1 * 4", "0 12 15 * 0",
         "5,10,59 0 0 * * *", "0 0 * * 0-6", "0 0 0 30 2 *",
         "7 6-6 * 2 4", "  1   2  3 *  * ", "*/7 */13 * * * *",
         # invalid ones
         "", "* * * *", "* * * * * * *", "60 * * * * *", "* 24 * * *",
         "*/0 * * * *", "a * * * *", "5-1 * * * *", "1-x * * * *",
         "*/q * * * *", "0 0 0 * 13 *", "0 0 0 0 * *", "0 0 * * 7"]


@pytest.mark.parametrize("expr", FIXED)
def test_fixed_schedules_fire_alike(expr):
    jax, port = (firing(pkg, expr) for pkg in PKGS)
    assert port == jax


def test_fixed_schedules_fire_as_cron_does():
    assert len(firing("gofr_tpu_torch", "* * * * * *")) == 86400
    assert firing("gofr_tpu_torch", "0 0 29 2 *") == [0]
    # day 29 and Thursday both restricted: either matches
    assert firing("gofr_tpu_torch", "0 0 1 * 4") == [0]
    assert firing("gofr_tpu_torch", "0 12 15 * 0") == []
    assert firing("gofr_tpu_torch", "* * * *")[0] == "InvalidCronError"


def _field(lo: int, hi: int):
    value = st.integers(lo, hi).map(str)
    rng = st.tuples(st.integers(lo - 1, hi), st.integers(lo, hi + 1)).map(
        lambda ab: f"{ab[0]}-{ab[1]}")
    step = st.tuples(st.sampled_from(["*", f"{lo}-{hi}"]),
                     st.integers(0, 20)).map(lambda p: f"{p[0]}/{p[1]}")
    atom = st.one_of(st.just("*"), value, rng, step,
                     st.sampled_from(["x", "1-", "*/"]))
    return st.lists(atom, min_size=1, max_size=3).map(",".join)


SCHEDULE = st.one_of(
    st.tuples(_field(0, 59), _field(0, 23), _field(1, 31), _field(1, 12),
              _field(0, 6)),
    st.tuples(_field(0, 59), _field(0, 59), _field(0, 23), _field(1, 31),
              _field(1, 12), _field(0, 6))).map(" ".join)


@settings(max_examples=25, deadline=None)
@given(SCHEDULE)
def test_drawn_schedules_fire_alike(expr):
    jax, port = (firing(pkg, expr) for pkg in PKGS)
    assert port == jax


def test_cron_job_runs_with_a_context(run):
    """A 6-field job each second in both apps, run side by side for a
    little over two seconds: each ran at least twice, each time with a
    fresh Context of its own over the app's container."""
    async def scenario():
        seen = {pkg: [] for pkg in PKGS}
        apps = []
        for pkg in PKGS:
            app = mod(pkg, "app").App(config=mod(pkg, "config").MapConfig({
                "LOG_LEVEL": "FATAL", "DB_DIALECT": "sqlite",
                "HTTP_PORT": "0", "METRICS_PORT": "0"}))

            async def job(ctx, pkg=pkg):
                seen[pkg].append((
                    ctx.request.host_name(), ctx.param("x"),
                    await ctx.bind(), ctx.sql.query("SELECT 1 AS one"),
                    ctx.span.name, ctx))

            app.add_cron_job("* * * * * *", "tick", job)
            await app.start()
            apps.append(app)
        try:
            await asyncio.sleep(2.6)
        finally:
            for app in apps:
                await app.shutdown()
        return seen

    seen = run(scenario())
    for pkg in PKGS:
        assert len(seen[pkg]) >= 2, seen
        assert len({id(s[-1]) for s in seen[pkg]}) == len(seen[pkg])
    jax, port = ({repr(s[:-1]) for s in seen[pkg]} for pkg in PKGS)
    assert port == jax == {repr(("gofr-cron", "", None, [{"one": 1}],
                                 "cron tick"))}


# -- inter-service clients ---------------------------------------------------------

class Downstream:
    """A local service whose routes fail on cue; it records every hit's
    path and headers."""

    def __init__(self) -> None:
        self.hits: list = []
        self.fail = False

        async def any_route(request: web.Request) -> web.Response:
            self.hits.append((request.method, request.path,
                              dict(request.headers)))
            if request.path == "/token":
                form = await request.post()
                ok = (form.get("client_id"), form.get("client_secret"),
                      form.get("grant_type"), form.get("scope")) == (
                    "cid", "csecret", "client_credentials", "a b")
                return web.json_response(
                    {"access_token": "tok-1" if ok else "bad",
                     "expires_in": 3600})
            if self.fail:
                return web.json_response({"error": "down"}, status=503)
            return web.json_response({"path": request.path,
                                      "q": dict(request.query)})

        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", any_route)
        self.runner = web.AppRunner(app)

    async def start(self) -> str:
        await self.runner.setup()
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        return f"http://127.0.0.1:{port}"

    def take(self) -> list:
        hits, self.hits = self.hits, []
        return hits


def service(pkg: str, url: str, *options):
    tracer = mod(pkg, "tracing").Tracer("client", None, 1.0)
    metrics = mod(pkg, "metrics").Manager()
    metrics.new_histogram("app_http_service_response", "")
    return mod(pkg, "service").new_http_service(url, None, metrics, tracer,
                                                *options)


async def _wait(pred, limit: float = 5.0):
    deadline = time.monotonic() + limit
    while not pred():
        assert time.monotonic() < deadline, "condition never held"
        await asyncio.sleep(0.01)


async def breaker_story(pkg: str, down: Downstream, url: str) -> dict:
    svc_mod = mod(pkg, "service")
    svc = service(
        pkg, url, svc_mod.CircuitBreakerConfig(threshold=2, interval=0.1),
        svc_mod.RetryConfig(max_retries=2),
        svc_mod.BasicAuthConfig("user", "pw"),
        svc_mod.APIKeyConfig("key-1"),
        svc_mod.DefaultHeaders({"X-Team": "ml", "X-Api-Key": "shadowed"}))
    states, calls = ["closed"], []

    async def call(path, **kw):
        try:
            r = await svc.get(path, **kw)
            got = (r.status_code, r.json())
        except svc_mod.CircuitOpenError as exc:
            got = ("open", str(exc))
        hits = down.take()
        calls.append((path, *got, [p for _, p, _ in hits],
                      [{k: h.get(k) for k in ("Authorization", "X-Api-Key",
                                              "X-Team")} for _, _, h in hits]))

    await call("items/1", params={"a": "b"})
    await call("items/2")
    down.fail = True
    await call("items/3")             # 1 + 2 retries, all 503: opens
    await call("items/4")             # fails fast
    states.append("open")
    await _wait(lambda: any(p == "/.well-known/alive"
                            for _, p, _ in down.hits))
    states.append("half-open")        # the probe found it down
    down.take()
    down.fail = False
    await _wait(lambda: any(p == "/.well-known/alive"
                            for _, p, _ in down.hits))
    while svc._open:                  # the probe closes it
        await asyncio.sleep(0.01)
    down.take()
    states.append("closed")
    await call("items/6", headers={"X-Api-Key": "per-call"})
    health = [await svc.health_check()]
    down.fail = True
    health.append(await svc.health_check())
    down.fail = False
    await svc.close()
    health.append([p for _, p, _ in down.take()])
    return {"states": states, "calls": calls, "health": health}


async def header_story(pkg: str, down: Downstream, url: str) -> dict:
    svc_mod = mod(pkg, "service")
    out = {}
    for name, options in {
            "basic": (svc_mod.BasicAuthConfig("user", "pw"),),
            "api_key": (svc_mod.APIKeyConfig("key-1"),
                        svc_mod.DefaultHeaders({"X-Team": "ml"})),
            "oauth": (svc_mod.OAuthConfig("cid", "csecret", url + "/token",
                                          ["a", "b"]),),
            "health": (svc_mod.HealthConfig("ready", 2.0),)}.items():
        svc = service(pkg, url, *options)
        await svc.post("things", json_body={"k": 1})
        await svc.put("things/1", body=b"raw")
        await svc.get("things", params={"q": "1"})
        await svc.delete("things/1")
        health = await svc.health_check()
        await svc.close()
        hits = down.take()
        out[name] = {"hits": [(m, p, {k: h.get(k) for k in (
            "Authorization", "X-Api-Key", "X-Team", "Content-Type")})
            for m, p, h in hits], "health": health,
            "traceparents": [h.get("traceparent") for _, p, h in hits
                             if p != "/token"]}
    return out


@pytest.fixture(scope="module")
def services():
    async def scenario():
        down = Downstream()
        url = await down.start()
        try:
            out = {}
            for pkg in PKGS:
                out[pkg] = {"breaker": await breaker_story(pkg, down, url),
                            "headers": await header_story(pkg, down, url)}
            return out
        finally:
            await down.runner.cleanup()

    return asyncio.run(scenario())


def test_breaker_and_retries_alike(services):
    jax, port = (services[pkg]["breaker"] for pkg in PKGS)
    assert port == jax
    assert port["states"] == ["closed", "open", "half-open", "closed"]
    calls = {c[0]: c for c in port["calls"]}
    assert calls["items/3"][1] == 503
    assert calls["items/3"][3] == ["/items/3"] * 3  # one try, two retries
    assert calls["items/4"][1] == "open" and calls["items/4"][3] == []
    assert calls["items/6"][1] == 200
    assert port["health"][0]["status"] == "UP"
    assert port["health"][1]["status"] == "DOWN"


@pytest.mark.parametrize("name", ["basic", "api_key", "oauth", "health"])
def test_outgoing_headers_alike(services, name):
    jax, port = (services[pkg]["headers"][name] for pkg in PKGS)
    assert port["hits"] == jax["hits"]
    assert port["health"] == jax["health"]
    for tp in port["traceparents"]:
        assert re.fullmatch(r"00-[0-9a-f]{32}-[0-9a-f]{16}-01", tp), tp
    assert len(set(port["traceparents"])) == len(port["traceparents"])


def test_outgoing_headers_as_promised(services):
    got = services["gofr_tpu_torch"]["headers"]
    assert got["basic"]["hits"][0][2]["Authorization"] == "Basic dXNlcjpwdw=="
    assert got["api_key"]["hits"][0][2]["X-Api-Key"] == "key-1"
    assert got["api_key"]["hits"][0][2]["X-Team"] == "ml"
    assert got["oauth"]["hits"][0][1] == "/token"
    assert got["oauth"]["hits"][1][2]["Authorization"] == "Bearer tok-1"
    assert len([h for h in got["oauth"]["hits"] if h[1] == "/token"]) == 1
    assert got["health"]["hits"][-1][1] == "/ready"


def test_add_http_service_joins_health_and_context(run):
    """``add_http_service`` in an app: the handler reaches it through
    ``ctx.get_http_service``, the call carries the request's trace, and
    its health joins the app's as ``<name>-service``."""
    async def scenario():
        from aiohttp.test_utils import TestClient, TestServer

        from gofr_tpu_torch.app import App
        from gofr_tpu_torch.config import MapConfig
        from gofr_tpu_torch.service import RetryConfig

        down = Downstream()
        url = await down.start()
        app = App(config=MapConfig({"LOG_LEVEL": "FATAL"}))
        app.add_http_service("facts", url, RetryConfig(max_retries=1))

        async def fact(ctx):
            r = await ctx.get_http_service("facts").get(
                f"fact/{ctx.path_param('n')}")
            return r.json()

        app.get("/fact/{n}", fact)
        client = TestClient(TestServer(app._build_http_app()))
        await client.start_server()
        try:
            tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
            r = await client.get("/fact/7", headers={"traceparent": tp})
            body = await r.json()
            sent = down.take()[0][2]["traceparent"]
            health = await (await client.get("/.well-known/health")).json()
        finally:
            await client.close()
            await app.container.close()
            await down.runner.cleanup()
        text = app.container.metrics_manager.expose_text()
        return body, sent, health, text

    body, sent, health, text = run(scenario())
    assert body["data"]["path"] == "/fact/7"
    assert sent.startswith("00-" + "ab" * 16 + "-")  # the same trace
    assert health["data"]["facts-service"]["status"] == "UP"
    assert "app_http_service_response_count" in text
