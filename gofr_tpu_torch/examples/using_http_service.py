"""An inter-service HTTP client on the port — counterpart of
``examples/using_http_service/main.py``: the downstream at
``FACT_SERVICE_URL`` is registered as ``fact-service`` with a circuit
breaker, a health endpoint and retries; ``GET /fact/{number}`` calls it
and answers its body as ``Raw``, and its health joins
``/.well-known/health``.

    FACT_SERVICE_URL=http://localhost:9091 \\
        python -m gofr_tpu_torch.examples.using_http_service
"""

from __future__ import annotations

import os

from ..app import App, new_app
from ..context import Context
from ..http.errors import EntityNotFound
from ..http.response import Raw
from ..service import CircuitBreakerConfig, HealthConfig, RetryConfig

__all__ = ["main"]


async def fact(ctx: Context):
    svc = ctx.get_http_service("fact-service")
    number = ctx.path_param("number")
    resp = await svc.get(f"fact/{number}")
    if resp.status_code >= 400:
        raise EntityNotFound("fact", number)
    return Raw(resp.json())


def main() -> App:
    app = new_app()
    app.add_http_service(
        "fact-service",
        os.environ.get("FACT_SERVICE_URL", "http://localhost:9091"),
        CircuitBreakerConfig(threshold=4, interval=1.0),
        HealthConfig(endpoint=".well-known/alive"),
        RetryConfig(max_retries=2))
    app.get("/fact/{number}", fact)
    return app


if __name__ == "__main__":
    main().run()
