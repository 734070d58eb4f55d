"""App — the composition root of the port's serving front, counterpart of
``gofr_tpu/app.py``.

``new_app()`` reads config from the environment and builds the container
(logger, metrics, tracer). Routes (``get``/``post``/...), websocket
routes (``websocket``), gRPC services (``register_service``), models
(``register_model``) and LLMs (``register_llm``), both mounted in
``ctx.ml``, are registered before
``start()``, which serves HTTP on ``HTTP_PORT`` behind the middleware
chain (tracing, request log with panic recovery, CORS from the
``ACCESS_CONTROL_*`` keys, ``app_http_response``: JAX's order),
the ``/debug/*`` routes (``debug.py``), the Prometheus text on
``METRICS_PORT`` at ``/metrics``, and gRPC on
``GRPC_PORT`` when a service is registered. ``shutdown()`` is the bounded
drain, in the JAX package's order: the gauge sampler, the gRPC server
(5 s grace), the HTTP and metrics servers, then the
container (``LLMServer.close`` drains in-flight decode for
``GOFR_ML_DRAIN_S``); the whole drain is bounded by 30 s. ``run()``
starts everything and drains on SIGINT or SIGTERM.
"""

from __future__ import annotations

import asyncio
import signal
import time
from typing import Any

from aiohttp import web

from .config import Config, EnvConfig
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
    def __init__(self, config: Config | None = None) -> None:
        self.config: Config = config if config is not None else EnvConfig()
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
        self._ws_routes: dict[str, HandlerFunc] = {}
        self._grpc_services: list = []
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

    def websocket(self, pattern: str, handler: HandlerFunc) -> None:
        """A websocket route: the handler runs once per inbound message."""
        self._ws_routes[pattern] = handler

    def register_service(self, service, impl=None) -> None:
        """A gRPC ``JSONService`` (``impl`` is accepted for the JAX
        package's signature and unused)."""
        self._grpc_services.append(service)

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

    # -- servers ---------------------------------------------------------------
    def _registered_methods(self) -> str:
        methods = sorted({m for m, _, _ in self._routes})
        return ", ".join(methods + ["OPTIONS"]) if methods else "GET, OPTIONS"

    def _build_http_app(self) -> web.Application:
        chain = [mw.tracer_middleware(self.tracer),
                 mw.logging_middleware(self.logger),
                 mw.cors_middleware(mw.CORSConfig.from_config(self.config),
                                    self._registered_methods),
                 mw.metrics_middleware(self.container.metrics_manager)]
        app = web.Application(
            middlewares=[self._adapt_middleware(f) for f in chain],
            client_max_size=64 * 1024 * 1024)
        app.router.add_get("/.well-known/health", wrap_handler(
            health_handler(self.container), self.container))
        app.router.add_get("/.well-known/alive",
                           wrap_handler(alive_handler, self.container))
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
        # catch-all 404 / 405 with the JSON envelope
        app.router.add_route("*", "/{tail:.*}",
                             wrap_handler(catch_all_handler, self.container))
        return app

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
        await web.TCPSite(self._runner, "0.0.0.0", self.http_port).start()
        self.logger.infof("http server on :%d", self.http_port)
        if self._grpc_services:
            from .grpc import start_grpc_server

            self._grpc_server = await start_grpc_server(
                self._grpc_services, self.grpc_port, self.logger, self.tracer)
            self.logger.infof("grpc server on :%d", self.grpc_port)
        self.logger.infof("startup complete in %.0fms",
                          (time.perf_counter() - t0) * 1e3)

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
            if self._grpc_server is not None:
                await self._grpc_server.stop(grace=5)
            if self._runner is not None:
                await self._runner.cleanup()
            if self._metrics_runner is not None:
                await self._metrics_runner.cleanup()
            await self.container.close()

        try:
            await asyncio.wait_for(_drain(), timeout=SHUTDOWN_GRACE_PERIOD)
        except asyncio.TimeoutError:
            self.logger.error("graceful shutdown timed out; forcing exit")
        self.tracer.shutdown()
        self.logger.info("server shutdown complete")


def new_app(config: Config | None = None) -> App:
    return App(config=config)
