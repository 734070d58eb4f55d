"""Database migrations on the port — counterpart of
``examples/using_migrations/main.py``: two versioned migrations (create
``employee``, add ``email``) recorded in ``gofr_migrations`` and skipped
once applied, then ``POST /employee`` and ``GET /employee?name=`` over
the migrated table.

    DB_DIALECT=sqlite DB_NAME=/tmp/m.db \\
        python -m gofr_tpu_torch.examples.using_migrations
"""

from __future__ import annotations

from ..app import App, new_app
from ..context import Context
from ..http.errors import EntityNotFound
from ..migration import Migrate

__all__ = ["ALL", "main"]


def create_table(ds):
    ds.sql.exec(
        "CREATE TABLE IF NOT EXISTS employee"
        " (id INTEGER PRIMARY KEY, name TEXT NOT NULL, gender TEXT,"
        " phone TEXT)")


def add_email_column(ds):
    ds.sql.exec("ALTER TABLE employee ADD COLUMN email TEXT")


ALL = {
    20240226153000: Migrate(up=create_table),
    20240226153001: Migrate(up=add_email_column),
}


async def add_employee(ctx: Context):
    body = await ctx.bind()
    ctx.sql.exec(
        "INSERT INTO employee (id, name, gender, phone, email)"
        " VALUES (?,?,?,?,?)",
        body["id"], body["name"], body.get("gender", ""),
        body.get("phone", ""), body.get("email", ""))
    return body


async def get_employee(ctx: Context):
    name = ctx.param("name")
    rows = ctx.sql.query(
        "SELECT id, name, email FROM employee WHERE name = ?", name)
    if not rows:
        raise EntityNotFound("name", name)
    return rows


def main() -> App:
    app = new_app()
    app.migrate(ALL)
    app.post("/employee", add_employee)
    app.get("/employee", get_employee)
    return app


if __name__ == "__main__":
    main().run()
