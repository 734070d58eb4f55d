"""App — the composition root of the port's framework, counterpart of
``gofr_tpu/app.py``.

``new_app(config=None, config_dir="./configs")`` reads config
(``config.new_env_config``: ``.env`` and ``.{APP_ENV}.env`` under the
process environment) and builds the container (logger, metrics, tracer,
SQL under ``DB_DIALECT``). Before ``start()`` an app registers routes
(``get`` / ``post`` / ``put`` / ``patch`` / ``delete`` / ``head`` /
``options``), static directories, websocket routes, gRPC services, user
middleware, auth (Basic, API key, OAuth with a decoder or a JWKS URL),
inter-service clients (``add_http_service``), cron jobs, migrations
(``migrate``, run at once), CRUD resources (``add_rest_handlers``),
injected datasources (``add_*``), shutdown hooks, and models and LLMs
mounted in ``ctx.ml``.

``start()`` starts the gauge sampler, the Prometheus text on
``METRICS_PORT`` at ``/metrics``, HTTP on ``HTTP_PORT`` (TLS with
``CERT_FILE`` / ``KEY_FILE``) behind the middleware chain (tracing,
request log with panic recovery, CORS, ``app_http_response``, then the
auth guards and user middleware), the health, liveness, favicon, swagger
and ``/debug/*`` routes, gRPC on ``GRPC_PORT`` when a service is registered,
the cron loop, and the remote log level poller under
``REMOTE_LOG_URL``. ``shutdown()`` is the bounded drain, in the JAX
package's order: the sampler, the remote level poller, the cron loop,
the gRPC server (5 s grace), the ``on_shutdown`` hooks, the HTTP and
metrics servers, then the container (its datasources and service
clients; ``LLMServer.close`` drains in-flight decode for
``GOFR_ML_DRAIN_S``); the whole drain is bounded by 30 s. ``run()``
starts everything and drains on SIGINT or SIGTERM.
"""

from __future__ import annotations

import asyncio
import inspect
import os
import signal
import time
from typing import Any, Callable

from aiohttp import web

from .config import Config, new_env_config
from .container import Container, new_container
from .handler import (HandlerFunc, alive_handler, catch_all_handler,
                      health_handler, wrap_handler)
from .http import middleware as mw
from .metrics import SamplerThread
from .tracing import new_tracer

__all__ = ["App", "new_app"]

DEFAULT_HTTP_PORT = 8000
DEFAULT_GRPC_PORT = 9000
DEFAULT_METRICS_PORT = 2121
SHUTDOWN_GRACE_PERIOD = 30.0


class App:
    def __init__(self, config: Config | None = None,
                 config_dir: str = "./configs") -> None:
        self.config: Config = (config if config is not None
                               else new_env_config(config_dir))
        self.container: Container = new_container(self.config)
        self.logger = self.container.logger
        self.tracer = new_tracer(self.config, self.logger)
        self.container.tracer = self.tracer
        port = self.config.get_or_default
        self.http_port = int(port("HTTP_PORT", str(DEFAULT_HTTP_PORT)))
        self.grpc_port = int(port("GRPC_PORT", str(DEFAULT_GRPC_PORT)))
        self.metrics_port = int(port("METRICS_PORT",
                                     str(DEFAULT_METRICS_PORT)))
        timeout_cfg = port("REQUEST_TIMEOUT", "")
        self.request_timeout = float(timeout_cfg) if timeout_cfg else None
        self._routes: list[tuple[str, str, HandlerFunc]] = []
        self._static_routes: list[tuple[str, str]] = []
        self._auth_middlewares: list = []
        self._ws_routes: dict[str, HandlerFunc] = {}
        self._grpc_services: list = []
        self._cron = None
        self._remote_level = None
        self._background_tasks: list[asyncio.Task] = []
        self._on_shutdown_hooks: list[Callable] = []
        self._runner: web.AppRunner | None = None
        self._metrics_runner: web.AppRunner | None = None
        self._gauge_sampler: SamplerThread | None = None
        self._grpc_server = None
        self._shut_down = False
        self.logger.infof(
            "starting %s (gofr-tpu-torch) http=:%d grpc=:%d metrics=:%d",
            self.container.app_name, self.http_port, self.grpc_port,
            self.metrics_port)

    # -- registration ----------------------------------------------------------
    def add_route(self, method: str, pattern: str, handler: HandlerFunc) -> None:
        self._routes.append((method.upper(), pattern, handler))

    def get(self, pattern: str, handler: HandlerFunc) -> None:
        self.add_route("GET", pattern, handler)

    def post(self, pattern: str, handler: HandlerFunc) -> None:
        self.add_route("POST", pattern, handler)

    def put(self, pattern: str, handler: HandlerFunc) -> None:
        self.add_route("PUT", pattern, handler)

    def patch(self, pattern: str, handler: HandlerFunc) -> None:
        self.add_route("PATCH", pattern, handler)

    def delete(self, pattern: str, handler: HandlerFunc) -> None:
        self.add_route("DELETE", pattern, handler)

    def head(self, pattern: str, handler: HandlerFunc) -> None:
        self.add_route("HEAD", pattern, handler)

    def options(self, pattern: str, handler: HandlerFunc) -> None:
        self.add_route("OPTIONS", pattern, handler)

    def add_static_files(self, route: str, directory: str) -> None:
        """Serve ``directory`` under ``route`` (``openapi.json`` answers
        403, a path outside the directory 404)."""
        self._static_routes.append((route.rstrip("/") or "/",
                                    os.path.abspath(directory)))

    def websocket(self, pattern: str, handler: HandlerFunc) -> None:
        """A websocket route: the handler runs once per inbound message."""
        self._ws_routes[pattern] = handler

    def add_middleware(self, middleware) -> None:
        """A user middleware, ``async (request, next) -> response``, after
        the built-in chain and the auth guards."""
        self._auth_middlewares.append(middleware)

    def on_shutdown(self, hook: Callable) -> None:
        """A sync or async callable run by ``shutdown()`` before the
        servers close."""
        self._on_shutdown_hooks.append(hook)

    def register_service(self, service, impl=None) -> None:
        """A gRPC ``JSONService`` (``impl`` is accepted for the JAX
        package's signature and unused)."""
        self._grpc_services.append(service)

    def add_http_service(self, name: str, address: str,
                         *options: Any) -> None:
        """An outbound HTTP client, ``ctx.get_http_service(name)``, with
        ``service.py``'s options; its health joins the app's."""
        from .service import new_http_service

        if name in self.container.services:
            self.logger.warnf("service %s already registered, overwriting",
                              name)
        self.container.services[name] = new_http_service(
            address, self.logger, self.container.metrics_manager,
            self.tracer, *options)

    def add_cron_job(self, schedule: str, job_name: str,
                     fn: HandlerFunc) -> None:
        """A job on a 5- or 6-field cron schedule (``cron.py``)."""
        from .cron import Cron

        if self._cron is None:
            self._cron = Cron(self.container, self.tracer)
        self._cron.add_job(schedule, job_name, fn)

    def migrate(self, migrations: dict[int, Any]) -> None:
        """Apply the pending migrations now (``migration.run``)."""
        from .migration import run as migration_run

        migration_run(migrations, self.container)

    def add_rest_handlers(self, entity: type) -> None:
        """CRUD routes for a dataclass entity (``crud.py``)."""
        from .crud import register_crud_handlers

        register_crud_handlers(self, entity)

    # injected datasources: observability in, connect(), then
    # ctx.<name>
    def add_cassandra(self, db: Any) -> None:
        self.container.add_datasource("cassandra", db)

    def add_mongo(self, db: Any) -> None:
        self.container.add_datasource("mongo", db)

    def add_clickhouse(self, db: Any) -> None:
        self.container.add_datasource("clickhouse", db)

    def add_solr(self, db: Any) -> None:
        self.container.add_datasource("solr", db)

    def add_opentsdb(self, db: Any) -> None:
        self.container.add_datasource("opentsdb", db)

    def add_dgraph(self, db: Any) -> None:
        self.container.add_datasource("dgraph", db)

    def add_kv_store(self, db: Any) -> None:
        self.container.add_datasource("kv", db)

    def add_file_store(self, fs: Any) -> None:
        self.container.add_datasource("file", fs)

    def _ensure_ml(self):
        from .ml import MLDatasource

        if self.container.ml is None:
            self.container.ml = MLDatasource(
                self.logger, self.container.metrics_manager,
                tracer=self.tracer)
        return self.container.ml

    def register_llm(self, name: str, params: Any, cfg: Any,
                     **kwargs: Any) -> None:
        """Mount a continuous-batching LLM (``ml/llm.py``); handlers reach
        it as ``ctx.ml.llm(name)``."""
        self._ensure_ml().register_llm(name, params, cfg, **kwargs)

    def register_model(self, name: str, model: Any, **kwargs: Any) -> None:
        """Mount a model in the ``ml`` datasource (an ``Engine``, with a
        ``DynamicBatcher`` under ``batching=True``); handlers call
        ``ctx.ml.predict(name, ...)``."""
        self._ensure_ml().register(name, model, **kwargs)

    # -- auth ------------------------------------------------------------------
    def enable_basic_auth(self, username: str, password: str) -> None:
        users = {username: password}
        self.enable_basic_auth_with_validator(
            lambda u, p: u in users and mw.constant_time_equals(users[u], p))

    def enable_basic_auth_with_validator(
            self, validator: Callable[[str, str], bool]) -> None:
        self._auth_middlewares.append(mw.basic_auth_middleware(validator))

    def enable_api_key_auth(self, *keys: str) -> None:
        keyset = set(keys)
        self.enable_api_key_auth_with_validator(lambda k: k in keyset)

    def enable_api_key_auth_with_validator(
            self, validator: Callable[[str], bool]) -> None:
        self._auth_middlewares.append(mw.api_key_auth_middleware(validator))

    def enable_oauth(self, decoder: Callable[[str], dict] | None = None, *,
                     jwks_url: str | None = None,
                     refresh_interval: float = 300.0,
                     allow_unverified: bool = False) -> None:
        """Bearer tokens: verified RS256 against the JWKS document at
        ``jwks_url`` (``http/jwks.py``), or by the caller's ``decoder``;
        with neither the app refuses unless ``allow_unverified`` (tests
        only)."""
        if jwks_url is not None:
            from .http.jwks import JWKSProvider

            provider = JWKSProvider(jwks_url,
                                    refresh_interval=refresh_interval,
                                    logger=self.logger)
            self._auth_middlewares.append(mw.jwks_oauth_middleware(provider))
            return
        if decoder is None and not allow_unverified:
            raise ValueError(
                "enable_oauth requires jwks_url or a verifying decoder; pass "
                "allow_unverified=True only for tests")
        self._auth_middlewares.append(mw.oauth_middleware(decoder))

    # -- servers ---------------------------------------------------------------
    def _registered_methods(self) -> str:
        methods = sorted({m for m, _, _ in self._routes})
        return ", ".join(methods + ["OPTIONS"]) if methods else "GET, OPTIONS"

    def _build_http_app(self) -> web.Application:
        chain = [mw.tracer_middleware(self.tracer),
                 mw.logging_middleware(self.logger),
                 mw.cors_middleware(mw.CORSConfig.from_config(self.config),
                                    self._registered_methods),
                 mw.metrics_middleware(self.container.metrics_manager),
                 *self._auth_middlewares]
        app = web.Application(
            middlewares=[self._adapt_middleware(f) for f in chain],
            client_max_size=64 * 1024 * 1024)
        app.router.add_get("/.well-known/health", wrap_handler(
            health_handler(self.container), self.container))
        app.router.add_get("/.well-known/alive",
                           wrap_handler(alive_handler, self.container))
        app.router.add_get("/favicon.ico", self._favicon_handler)
        self._maybe_add_swagger(app)
        # the serving debug endpoints, always on like /metrics; the
        # profiler session's start/stop routes only under APP_ENV=DEBUG
        from .debug import register_debug_routes, register_profiler_routes

        register_debug_routes(self, app)
        if (self.config.get("APP_ENV") or "").upper() == "DEBUG":
            register_profiler_routes(self, app)
        for method, pattern, handler in self._routes:
            app.router.add_route(method, pattern, wrap_handler(
                handler, self.container, self.request_timeout))
        from .websocket import websocket_route_handler

        for pattern, ws_handler in self._ws_routes.items():
            app.router.add_get(pattern, websocket_route_handler(
                ws_handler, self.container))
        for route, directory in self._static_routes:
            app.router.add_get(route + "/{filename:.*}",
                               self._static_handler(directory))
        # catch-all 404 / 405 with the JSON envelope
        app.router.add_route("*", "/{tail:.*}",
                             wrap_handler(catch_all_handler, self.container))
        return app

    @staticmethod
    async def _favicon_handler(_: web.Request) -> web.Response:
        """The package's ``static/favicon.ico``; a bare 404 without one."""
        path = os.path.join(os.path.dirname(__file__), "static",
                            "favicon.ico")
        try:
            with open(path, "rb") as fh:
                return web.Response(body=fh.read(),
                                    content_type="image/x-icon")
        except FileNotFoundError:
            return web.Response(status=404)

    def _maybe_add_swagger(self, app: web.Application) -> None:
        """``./static/openapi.json`` and the viewer, when the file
        exists."""
        spec_path = os.path.abspath("./static/openapi.json")
        if not os.path.exists(spec_path):
            return
        from .swagger import openapi_handler, swagger_ui_handler

        app.router.add_get("/.well-known/openapi.json",
                           openapi_handler(spec_path))
        app.router.add_get("/.well-known/swagger", swagger_ui_handler())
        self.logger.info("swagger UI enabled at /.well-known/swagger")

    @staticmethod
    def _static_handler(directory: str):
        async def handler(request: web.Request) -> web.StreamResponse:
            filename = request.match_info.get("filename", "")
            if filename.endswith("openapi.json"):
                return web.json_response(
                    {"error": {"message": "403 forbidden"}}, status=403)
            full = os.path.abspath(os.path.join(directory,
                                                filename or "index.html"))
            try:
                inside = os.path.commonpath([full, directory]) == directory
            except ValueError:  # another drive
                inside = False
            if not inside or not os.path.isfile(full):
                return web.json_response(
                    {"error": {"message": "route not registered"}},
                    status=404)
            return web.FileResponse(full)

        return handler

    @staticmethod
    def _adapt_middleware(func) -> Any:
        @web.middleware
        async def adapted(request: web.Request, handler):
            return await func(request, handler)

        return adapted

    def _build_metrics_app(self) -> web.Application:
        """The separate metrics server: process gauges refreshed and the
        samplers run on every scrape, then the Prometheus text."""

        async def metrics_handler(_: web.Request) -> web.Response:
            self.container.refresh_process_metrics()
            text = self.container.metrics_manager.expose_text()
            return web.Response(text=text, content_type="text/plain",
                                charset="utf-8")

        app = web.Application()
        app.router.add_get("/metrics", metrics_handler)
        return app

    # -- lifecycle -------------------------------------------------------------
    def run(self) -> None:
        """Start every server; block until SIGINT/SIGTERM; drain."""
        try:
            asyncio.run(self._run_async())
        except KeyboardInterrupt:
            pass

    async def _run_async(self) -> None:
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await self.start()
        await stop.wait()
        self.logger.info("shutdown signal received; draining")
        await self.shutdown()

    async def start(self) -> None:
        """Start the servers without blocking (``run`` and tests)."""
        t0 = time.perf_counter()
        try:
            interval = float(self.config.get_or_default(
                "METRICS_SAMPLE_INTERVAL", "10"))
        except ValueError:
            interval = 10.0  # an optional knob never fails startup
        self._gauge_sampler = SamplerThread(self.container.metrics_manager,
                                            interval)
        self._gauge_sampler.start()
        self._metrics_runner = web.AppRunner(self._build_metrics_app())
        await self._metrics_runner.setup()
        await web.TCPSite(self._metrics_runner, "0.0.0.0",
                          self.metrics_port).start()
        self.logger.infof("metrics server on :%d/metrics", self.metrics_port)
        self._runner = web.AppRunner(self._build_http_app(), access_log=None)
        await self._runner.setup()
        ssl_ctx = self._tls_context()
        await web.TCPSite(self._runner, "0.0.0.0", self.http_port,
                          ssl_context=ssl_ctx).start()
        self.logger.infof("http server on :%d (%s)", self.http_port,
                          "https" if ssl_ctx else "http")
        if self._grpc_services:
            from .grpc import start_grpc_server

            self._grpc_server = await start_grpc_server(
                self._grpc_services, self.grpc_port, self.logger, self.tracer)
            self.logger.infof("grpc server on :%d", self.grpc_port)
        if self._cron is not None:
            self._background_tasks.append(
                asyncio.create_task(self._cron.run(), name="cron"))
        remote_url = self.config.get("REMOTE_LOG_URL")
        if remote_url:
            from .logging.remote import RemoteLevelUpdater

            self._remote_level = RemoteLevelUpdater(
                self.logger, remote_url, float(self.config.get_or_default(
                    "REMOTE_LOG_FETCH_INTERVAL", "15")))
            self._remote_level.start()
        self.logger.infof("startup complete in %.0fms",
                          (time.perf_counter() - t0) * 1e3)

    def _tls_context(self):
        """The server's TLS context from ``CERT_FILE`` / ``KEY_FILE``, or
        None."""
        cert, key = self.config.get("CERT_FILE"), self.config.get("KEY_FILE")
        if not (cert and key):
            return None
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(cert, key)
        return ctx

    async def shutdown(self) -> None:
        """Graceful drain bounded by ``SHUTDOWN_GRACE_PERIOD``: gRPC stops
        (in-flight streams get 5 s) before the LLM servers drain and their
        serving threads stop. A second call returns at once."""
        if self._shut_down:
            return
        self._shut_down = True

        async def _drain() -> None:
            if self._gauge_sampler is not None:
                self._gauge_sampler.stop()
            if self._remote_level is not None:
                await self._remote_level.stop()
            for task in self._background_tasks:
                task.cancel()
            await asyncio.gather(*self._background_tasks,
                                 return_exceptions=True)
            if self._grpc_server is not None:
                await self._grpc_server.stop(grace=5)
            for hook in self._on_shutdown_hooks:
                result = hook()
                if inspect.isawaitable(result):
                    await result
            if self._runner is not None:
                await self._runner.cleanup()
            if self._metrics_runner is not None:
                await self._metrics_runner.cleanup()
            await self.container.close()

        try:
            await asyncio.wait_for(_drain(), timeout=SHUTDOWN_GRACE_PERIOD)
        except asyncio.TimeoutError:
            self.logger.error("graceful shutdown timed out; forcing exit")
        _forget_routed_handlers()
        self.tracer.shutdown()
        self.logger.info("server shutdown complete")


def _forget_routed_handlers() -> None:
    """Empty aiohttp's module-level cache of middleware chains. It is keyed
    by each routed request's (handler, applications), so it keeps every
    handler that ever answered, with what the handler closes over: a
    shut-down app, its models and their device memory. Live apps rebuild
    their entries on their next request."""
    from aiohttp import web_app

    cache = getattr(web_app, "_cached_build_middleware", None)
    if cache is not None:
        cache.cache_clear()


def new_app(config: Config | None = None,
            config_dir: str = "./configs") -> App:
    return App(config=config, config_dir=config_dir)
