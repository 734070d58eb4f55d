"""The canonical HTTP server on the port — counterpart of
``examples/http_server/main.py`` (BASELINE config #1): ``GET /greet``,
``GET /hello?name=``, a ``Raw`` body at ``GET /raw``, a typed 404 at
``GET /missing/{id}``, and, with ``DB_DIALECT=sqlite``, the ``Employee``
CRUD resource at ``/employee``.

    DB_DIALECT=sqlite DB_NAME=/tmp/demo.db \\
        python -m gofr_tpu_torch.examples.http_server

It runs no model, so it needs no card. Ports: ``HTTP_PORT`` (8000) and
``METRICS_PORT`` (2121); config from ``./configs/.env`` under the
environment.
"""

from __future__ import annotations

import dataclasses

from ..app import App, new_app
from ..context import Context
from ..http.errors import EntityNotFound
from ..http.response import Raw

__all__ = ["Employee", "main"]


@dataclasses.dataclass
class Employee:
    id: int = dataclasses.field(default=0, metadata={"sql": "auto_increment"})
    name: str = ""
    role: str = ""


async def greet(ctx: Context):
    return "Hello World!"


async def hello_name(ctx: Context):
    return f"Hello {ctx.param('name') or 'there'}!"


async def raw_handler(ctx: Context):
    return Raw({"plain": True})


async def fail_handler(ctx: Context):
    raise EntityNotFound("id", ctx.path_param("id"))


def main() -> App:
    app = new_app()
    app.get("/greet", greet)
    app.get("/hello", hello_name)
    app.get("/raw", raw_handler)
    app.get("/missing/{id}", fail_handler)
    if app.container.sql is not None:
        app.container.sql.exec(
            "CREATE TABLE IF NOT EXISTS employee"
            " (id INTEGER PRIMARY KEY AUTOINCREMENT, name TEXT, role TEXT)")
        app.add_rest_handlers(Employee)
    return app


if __name__ == "__main__":
    main().run()
