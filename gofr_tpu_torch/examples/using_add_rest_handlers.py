"""CRUD auto-handlers with a verb override on the port — counterpart of
``examples/using_add_rest_handlers/main.py``: the ``User`` dataclass
becomes a REST resource at ``/user`` (POST, GET, GET by id, PUT, DELETE)
over sqlite, and its own ``get_all`` (employed users only) replaces that
one verb.

    DB_DIALECT=sqlite DB_NAME=/tmp/users.db \\
        python -m gofr_tpu_torch.examples.using_add_rest_handlers
"""

from __future__ import annotations

import asyncio
import dataclasses

from ..app import App, new_app
from ..context import Context

__all__ = ["User", "main"]


@dataclasses.dataclass
class User:
    id: int = dataclasses.field(default=0, metadata={"sql": "auto_increment"})
    name: str = ""
    age: int = 0
    is_employed: bool = False

    async def get_all(self, ctx: Context):
        return await asyncio.to_thread(
            ctx.sql.query,
            "SELECT id, name, age FROM user WHERE is_employed = 1")


def main() -> App:
    app = new_app()
    if app.container.sql is not None:
        app.container.sql.exec(
            "CREATE TABLE IF NOT EXISTS user ("
            " id INTEGER PRIMARY KEY AUTOINCREMENT,"
            " name TEXT NOT NULL, age INTEGER, is_employed INTEGER)")
    app.add_rest_handlers(User)
    return app


if __name__ == "__main__":
    main().run()
