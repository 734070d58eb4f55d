"""PyTorch port, config and observability, against ``gofr_tpu``.

Held equal between the packages: the values ``new_env_config`` reads
from one config directory (``.env``, the ``.{APP_ENV}.env`` overlay, the
process environment over both); the JSON lines and terminal lines of the
same log calls, timestamps dropped, and a file logger's; the remote log
level (the same bodies give the same level, and an app started with
``REMOTE_LOG_URL`` applies it); the Zipkin and OTLP encodings of the same
spans with fixed ids, as encoded and as a collector receives them; the
exporter ``new_tracer`` picks; the Prometheus text of the same custom
metrics, and ``/metrics`` of the same app.
"""

import asyncio
import importlib
import io
import json
import re
import types

import pytest
from aiohttp import web

pytestmark = pytest.mark.timeout(120)

PKGS = ("gofr_tpu", "gofr_tpu_torch")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


# -- config ----------------------------------------------------------------------

ENV = """# a comment
APP_NAME=from-dotenv
export EXPORTED = yes
QUOTED="a value # kept"
SINGLE='single'
INLINE=plain # dropped
EMPTY=
NOEQUALS
APP_ENV=stage
OVERLAID=base
"""
STAGE = "OVERLAID=stage\nSTAGE_ONLY=1\n"
KEYS = ("APP_NAME", "EXPORTED", "QUOTED", "SINGLE", "INLINE", "EMPTY",
        "NOEQUALS", "APP_ENV", "OVERLAID", "STAGE_ONLY", "FROM_PROCESS",
        "MISSING")


@pytest.mark.parametrize("process_env", [{}, {"APP_ENV": "prod"},
                                         {"OVERLAID": "proc",
                                          "FROM_PROCESS": "p"}])
def test_config_dir_gives_the_same_values(tmp_path, monkeypatch,
                                          process_env):
    (tmp_path / ".env").write_text(ENV)
    (tmp_path / ".stage.env").write_text(STAGE)
    (tmp_path / ".prod.env").write_text("OVERLAID=prod\n")
    for key in KEYS:
        monkeypatch.delenv(key, raising=False)
    for key, value in process_env.items():
        monkeypatch.setenv(key, value)
    got = []
    for pkg in PKGS:
        cfg = mod(pkg, "config").new_env_config(str(tmp_path))
        got.append({k: (cfg.get(k), cfg.get_or_default(k, "dflt"))
                    for k in KEYS})
    assert got[1] == got[0]
    assert got[1]["QUOTED"][0] == "a value # kept"
    assert got[1]["INLINE"][0] == "plain"
    want = {"OVERLAID": "proc"}.get("OVERLAID") if "OVERLAID" in \
        process_env else {"prod": "prod"}.get(process_env.get("APP_ENV"),
                                             "stage")
    assert got[1]["OVERLAID"][0] == want


def test_load_env_file_and_app_config_dir(tmp_path, monkeypatch):
    (tmp_path / ".env").write_text("APP_NAME=dir-app\nHTTP_PORT=8123\n")
    for pkg in PKGS:
        assert mod(pkg, "config").load_env_file(str(tmp_path / ".env")) == \
            {"APP_NAME": "dir-app", "HTTP_PORT": "8123"}
        assert mod(pkg, "config").load_env_file(str(tmp_path / "no")) == {}
    from gofr_tpu_torch.app import App

    for key in ("APP_NAME", "HTTP_PORT", "APP_ENV"):
        monkeypatch.delenv(key, raising=False)
    app = App(config_dir=str(tmp_path))
    assert (app.container.app_name, app.http_port) == ("dir-app", 8123)


# -- logging ---------------------------------------------------------------------

STAMP = re.compile(r'"time": "[0-9T:.\-]+Z", ')
CLOCK = re.compile(r"\[\d\d:\d\d:\d\d\]")


def log_calls(pkg: str, terminal: bool) -> tuple[str, str]:
    logging = mod(pkg, "logging")
    out, err = io.StringIO(), io.StringIO()
    log = logging.Logger(logging.Level.INFO, out=out, err=err,
                         is_terminal=terminal)
    mw = mod(pkg, "http.middleware")
    sql = mod(pkg, "datasource.sql")
    log.debug("hidden at INFO")
    log.info("hello", user="ada", n=3)
    log.infof("formatted %d %s", 7, "x")
    log.info("a", "b", 3)
    log.notice("notice me")
    log.warn("careful", code=418)
    log.warnf("%s%%", "pct")
    log.error("bad", error="boom")
    log.errorf("bad %s", "f")
    log.fatal("fatal, logged")
    log.log("plain log")
    log.info(mw.RequestLog("t" * 32, "s" * 16, "2024-01-01T00:00:00", 1234,
                           "GET", "127.0.0.1", "/x?y=1", 200))
    log.info(sql.QueryLog("SELECT 1", 55, (1,)))
    log.info({"nested": [1, {"k": "v"}]},
             obj=types.SimpleNamespace(a=1, _hidden=2), other={1, 2})
    log.change_level(logging.Level.DEBUG)
    log.debug("now shown")
    log.debugf("debug %d", 2)
    log.change_level(logging.Level.ERROR)
    log.warn("hidden at ERROR")
    return out.getvalue(), err.getvalue()


@pytest.mark.parametrize("terminal", [False, True])
def test_same_log_calls_give_the_same_lines(terminal):
    jax, port = (log_calls(pkg, terminal) for pkg in PKGS)
    # on a terminal the ESC bytes are dropped before comparing: JAX's
    # QueryLog writes its color codes without them (ROADMAP C)
    strip = (lambda s: CLOCK.sub("[clock]", s).replace("\x1b", "")) \
        if terminal else (lambda s: STAMP.sub("", s))
    assert [strip(s) for s in port] == [strip(s) for s in jax]
    if terminal:
        assert "\x1b[38;5;8mSQL\x1b[0m" in port[0]
    else:
        lines = [json.loads(x) for x in port[0].splitlines()]
        assert lines[0] == {"level": "INFO", "time": lines[0]["time"],
                            "message": "hello", "user": "ada", "n": 3}
        assert [x["level"] for x in lines].count("NOTICE") == 1
        assert lines[7]["message"]["response_time"] == 1234
        assert len(port[1].splitlines()) == 3  # ERROR, errorf, FATAL


def test_level_names_and_file_logger(tmp_path):
    for pkg in PKGS:
        logging = mod(pkg, "logging")
        assert [logging.get_level_from_string(s).name for s in (
            "debug", " WARN ", "nope", None, "fatal")] == \
            ["DEBUG", "WARN", "INFO", "INFO", "FATAL"]
        path = tmp_path / f"{pkg}.log"
        log = logging.new_file_logger(str(path), logging.Level.DEBUG)
        log.debug("to file", k=1)
        log.error("also to file")
        log._out.close()
    jax, port = (STAMP.sub("", (tmp_path / f"{p}.log").read_text())
                 for p in PKGS)
    assert port == jax and len(port.splitlines()) == 2


# -- the remote log level --------------------------------------------------------

BODIES = [{"data": [{"serviceName": "svc", "logLevel": {"LOG_LEVEL":
                                                        "DEBUG"}}]},
          {"data": {"logLevel": "warn"}}, {"LOG_LEVEL": "ERROR"},
          {"level": "notice"}, "FATAL", {"data": []}, {"data": [{}]},
          {"logLevel": {"level": "info"}}, ["DEBUG"], 7, {"level": 3}]


def test_extract_level_alike():
    for body in BODIES:
        jax, port = (mod(pkg, "logging.remote").extract_level(body)
                     for pkg in PKGS)
        assert port == jax, body


class LevelServer:
    def __init__(self) -> None:
        self.body: object = "DEBUG"
        self.hits = 0

        async def level(_):
            self.hits += 1
            if self.body is None:
                return web.Response(text="<html>not json</html>")
            return web.json_response(self.body)

        app = web.Application()
        app.router.add_get("/level", level)
        self.runner = web.AppRunner(app)

    async def start(self) -> str:
        await self.runner.setup()
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        await site.start()
        return f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"


def test_remote_level_is_applied(run):
    async def scenario():
        server = LevelServer()
        url = await server.start() + "/level"
        out = {pkg: [] for pkg in PKGS}
        try:
            for body in [*BODIES[:5], "verbose", None]:
                server.body = body
                for pkg in PKGS:
                    logging = mod(pkg, "logging")
                    log = logging.Logger(logging.Level.INFO,
                                         out=io.StringIO(),
                                         err=io.StringIO(),
                                         is_terminal=False)
                    up = mod(pkg, "logging.remote").RemoteLevelUpdater(
                        log, url, 0.05)
                    out[pkg].append((await up.poll_once(), log.level.name,
                                     up.polls))
            # an app started with REMOTE_LOG_URL polls and applies it
            server.body = {"data": [{"logLevel": {"LOG_LEVEL": "DEBUG"}}]}
            from gofr_tpu_torch.app import App
            from gofr_tpu_torch.config import MapConfig

            app = App(config=MapConfig({
                "LOG_LEVEL": "WARN", "HTTP_PORT": "0", "METRICS_PORT": "0",
                "REMOTE_LOG_URL": url, "REMOTE_LOG_FETCH_INTERVAL": "0.05"}))
            assert app.logger.level.name == "WARN"
            await app.start()
            for _ in range(200):
                if app.logger.level.name == "DEBUG":
                    break
                await asyncio.sleep(0.01)
            out["app"] = app.logger.level.name
            await app.shutdown()
            hits = server.hits
            await asyncio.sleep(0.15)
            out["polls_after_shutdown"] = server.hits - hits
        finally:
            await server.runner.cleanup()
        return out

    out = run(scenario())
    assert out["gofr_tpu_torch"] == out["gofr_tpu"]
    assert [lvl for _, lvl, _ in out["gofr_tpu_torch"]] == [
        "DEBUG", "WARN", "ERROR", "NOTICE", "FATAL", "INFO", "INFO"]
    assert out["app"] == "DEBUG"
    assert out["polls_after_shutdown"] == 0


# -- trace export ----------------------------------------------------------------

def spans(pkg: str) -> list:
    tracing = mod(pkg, "tracing")
    root = tracing.Span(
        name="GET /things/{id}",
        context=tracing.SpanContext("0af7651916cd43dd8448eb211c80319c",
                                    "b7ad6b7169203331", True),
        kind="SERVER", start_time=1_700_000_000.25, end_time=1_700_000_000.5,
        attributes={"http.method": "GET", "http.status_code": 200,
                    "ratio": 0.5, "ok": True, "big": 2**40})
    child = tracing.Span(
        name="work", context=tracing.SpanContext(
            "0af7651916cd43dd8448eb211c80319c", "00f067aa0ba902b7", True),
        parent_span_id="b7ad6b7169203331", kind="INTERNAL",
        start_time=1_700_000_000.3, end_time=1_700_000_000.3,
        attributes={"step": "decode"},
        events=[(1_700_000_000.31, "exception",
                 {"type": "ValueError", "message": "bad"})],
        status_code="ERROR", status_message="bad")
    client = tracing.Span(
        name="http-service GET fact/7", context=tracing.SpanContext(
            "0af7651916cd43dd8448eb211c80319c", "1111111111111111", True),
        parent_span_id="b7ad6b7169203331", kind="CLIENT",
        start_time=1_700_000_000.4, end_time=None, status_code="OK")
    return [root, child, client]


@pytest.mark.parametrize("exporter", ["ZipkinJSONExporter",
                                      "OTLPHTTPExporter"])
def test_exporters_encode_the_same_json(exporter):
    got = [json.dumps(getattr(mod(pkg, "tracing"), exporter)(
        "http://collector:4318", "svc").encode(spans(pkg)), sort_keys=True)
        for pkg in PKGS]
    assert got[1] == got[0]
    body = json.loads(got[1])
    if exporter == "OTLPHTTPExporter":
        s = body["resourceSpans"][0]["scopeSpans"][0]["spans"]
        assert abs(int(s[0]["startTimeUnixNano"]) - 1_700_000_000_25 * 10**7
                   ) < 1000
        assert s[0]["attributes"][4] == {"key": "big",
                                         "value": {"intValue": "1099511627776"}}
        assert s[1]["status"] == {"code": 2, "message": "bad"}
    else:
        assert body[0]["duration"] == 250000 and body[1]["duration"] == 1
        assert body[1]["tags"]["error"] == "bad"
        assert "kind" not in body[1]


def test_exporters_post_the_same_bodies(run):
    """Each exporter of each package posts its batch to a local
    collector: the same path, content type and body."""
    async def scenario():
        got = []

        async def collect(request):
            got.append((request.path, request.content_type,
                        await request.json()))
            return web.Response(status=202)

        app = web.Application()
        app.router.add_post("/{tail:.*}", collect)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        base = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
        try:
            for name, url in (("OTLPHTTPExporter", base),
                              ("ZipkinJSONExporter", base + "/api/v2/spans")):
                for pkg in PKGS:
                    exp = getattr(mod(pkg, "tracing"), name)(url, "svc")
                    await asyncio.to_thread(exp.export, spans(pkg))
        finally:
            await runner.cleanup()
        return got

    got = run(scenario())
    assert len(got) == 4
    assert got[1] == got[0] and got[3] == got[2]
    assert got[0][:2] == ("/v1/traces", "application/json")
    assert got[2][0] == "/api/v2/spans"


def test_export_to_a_dead_collector_warns_and_goes_on():
    for pkg in PKGS:
        logging = mod(pkg, "logging")
        out = io.StringIO()
        log = logging.Logger(logging.Level.INFO, out=out, err=out,
                             is_terminal=False)
        exp = mod(pkg, "tracing").ZipkinJSONExporter(
            "http://127.0.0.1:9/api/v2/spans", "svc", log, timeout=0.5)
        exp.export(spans(pkg))
        assert "trace export to http://127.0.0.1:9/api/v2/spans failed" in \
            out.getvalue()


@pytest.mark.parametrize("conf", [
    {}, {"TRACE_EXPORTER": "console"}, {"TRACE_EXPORTER": "zipkin"},
    {"TRACE_EXPORTER": "zipkin", "TRACER_URL": "http://c:9411/api/v2/spans"},
    {"TRACE_EXPORTER": "gofr", "TRACER_URL": "http://c/x"},
    {"TRACE_EXPORTER": "otlp", "TRACER_URL": "http://c:4318"},
    {"TRACE_EXPORTER": "jaeger", "TRACER_URL": "http://c:4318/v1/traces"},
    {"TRACE_EXPORTER": "otlp", "TRACER_URL": "http://c:9411/api/v2/spans"},
    {"TRACE_EXPORTER": "OTLP", "TRACER_URL": "http://c", "TRACER_RATIO":
     "0.25", "APP_NAME": "named"},
    {"TRACE_EXPORTER": "other", "TRACER_URL": "http://c",
     "TRACER_RATIO": "x"}])
def test_new_tracer_picks_the_same_exporter(conf):
    got = []
    for pkg in PKGS:
        tracer = mod(pkg, "tracing").new_tracer(
            mod(pkg, "config").MapConfig(conf))
        proc = tracer._processor
        exp = proc._exporter if proc is not None else None
        got.append((tracer.service_name, tracer.sample_ratio,
                    type(exp).__name__, getattr(exp, "url", None)))
        tracer.shutdown()
    assert got[1] == got[0]


def test_noop_tracer_samples_nothing():
    from gofr_tpu_torch.tracing import NoopTracer

    t = NoopTracer()
    with t.start_span("x") as span:
        assert not span.context.sampled
    assert t._processor is None


# -- metrics ---------------------------------------------------------------------

def custom_metrics(pkg: str) -> str:
    metrics = mod(pkg, "metrics")
    m = metrics.Manager()
    m.new_counter("orders_total", "orders taken")
    m.new_updown_counter("queue_depth", "items waiting")
    m.new_gauge("stock", "items in stock")
    m.new_histogram("latency_ms", "a latency", buckets=(1, 5, 10))
    m.new_histogram("timed", "seconds of a block")
    m.increment_counter("orders_total")
    m.increment_counter("orders_total", shop="a")
    m.add_counter("orders_total", 2.5, shop="a")
    m.delta_updown_counter("queue_depth", 3)
    m.delta_updown_counter("queue_depth", -5, lane='q"1\n')
    m.set_gauge("stock", 9)
    m.set_gauge("stock", 1e-7, sku="x")
    for v in (0.5, 4, 7, 100):
        m.record_histogram("latency_ms", v, route="/r")
    with metrics.Timer(m, "timed", job="j"):
        pass
    errors = []
    for call in (lambda: m.new_counter("stock"),
                 lambda: m.increment_counter("stock"),
                 lambda: m.set_gauge("nope", 1)):
        try:
            call()
        except metrics.MetricsError as exc:
            errors.append((type(exc).__name__, str(exc)))
    text = m.expose_text()
    # the Timer's seconds differ run to run: its sum is dropped
    text = re.sub(r'(timed_sum\{job="j"\}) \S+', r"\1 <s>", text)
    return text + json.dumps(errors)


def test_custom_metrics_expose_the_same_text():
    jax, port = (custom_metrics(pkg) for pkg in PKGS)
    assert port == jax
    assert 'orders_total{shop="a"} 3.5' in port
    assert 'timed_count{job="j"} 1' in port
    assert 'timed_bucket{job="j",le="0.001"} 1' in port
    assert 'queue_depth{lane="q\\"1\\n"} -5' in port


def test_metrics_endpoint_of_the_same_app(run, monkeypatch):
    """The custom-metrics example of each package, the same requests,
    then ``/metrics``: the example's series, the HTTP histogram's counts
    and the SQL histogram agree."""
    async def scenario(pkg):
        from aiohttp.test_utils import TestClient, TestServer

        if pkg == "gofr_tpu":
            from examples.using_custom_metrics.main import main
        else:
            from gofr_tpu_torch.examples.using_custom_metrics import main
        app = main()
        client = TestClient(TestServer(app._build_http_app()))
        metrics = TestClient(TestServer(app._build_metrics_app()))
        await client.start_server()
        await metrics.start_server()
        try:
            await client.post("/transaction", json={"amount": 100,
                                                    "stock_left": 9})
            await client.post("/transaction", json={"amount": 5})
            await client.post("/return", json={"amount": 40})
            text = await (await metrics.get("/metrics")).text()
        finally:
            await client.close()
            await metrics.close()
        keep = ("transaction_success", "total_credit_day_sale",
                "product_stock", "transaction_time_count",
                "app_http_response_count", "# TYPE app_http",
                "# HELP transaction", "# TYPE transaction")
        return [line for line in text.splitlines() if line.startswith(keep)]

    monkeypatch.setenv("LOG_LEVEL", "FATAL")
    jax, port = (run(scenario(pkg)) for pkg in PKGS)
    assert port == jax
    assert "transaction_success 2" in port
    assert "total_credit_day_sale 65" in port
    assert "product_stock 0" in port
