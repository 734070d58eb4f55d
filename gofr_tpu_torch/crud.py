"""CRUD auto-handlers — counterpart of ``gofr_tpu/crud.py``.

``App.add_rest_handlers(Entity)`` scans a dataclass (its first field is
the primary key; field metadata ``sql="auto_increment"`` /
``"not_null"``, comma-separated, is honoured) and registers POST, GET,
GET by id, PUT and DELETE under ``/{snake_case(Entity)}``, with SQL built
for the datasource's dialect (quoted identifiers; ``RETURNING`` on a
postgres insert). A None in a ``not_null`` field is a 400; an unknown id
a 404. The entity overrides any verb by defining ``create``, ``get_all``,
``get``, ``update`` or ``delete`` itself, as an instance method (called on
an instance built without ``__init__``) or a plain function of ``ctx``.
Statements run off the event loop.
"""

from __future__ import annotations

import asyncio
import dataclasses
import inspect
import re
from typing import Any

from .context import Context
from .http.errors import EntityNotFound, InvalidInput


__all__ = ["register_crud_handlers", "scan_entity", "snake_case",
           "quote_ident", "insert_query", "select_all_query",
           "select_query", "update_query", "delete_query"]


async def _sql(fn, *args):
    """A blocking SQL call on a worker thread: the loop never waits on a
    statement."""
    return await asyncio.to_thread(fn, *args)


def snake_case(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


# -- SQL for the dialect --------------------------------------------------------

def quote_ident(name: str, dialect: str) -> str:
    """mysql quotes identifiers with backticks, postgres/sqlite with double
    quotes (both also accept their own unquoted lowercase names, but
    quoting keeps reserved words like ``order`` usable as tables)."""
    return f"`{name}`" if dialect == "mysql" else f'"{name}"'


def insert_query(meta: "_EntityMeta", fields: list[str], dialect: str) -> str:
    q = quote_ident
    cols = ", ".join(q(f, dialect) for f in fields)
    ph = ", ".join("?" for _ in fields)
    sql = f"INSERT INTO {q(meta.table, dialect)} ({cols}) VALUES ({ph})"
    if dialect == "postgres" and meta.auto_increment:
        # postgres has no lastrowid: the wire client surfaces RETURNING
        sql += f" RETURNING {q(meta.primary_key, dialect)}"
    return sql


def select_all_query(meta: "_EntityMeta", dialect: str) -> str:
    return f"SELECT * FROM {quote_ident(meta.table, dialect)}"


def select_query(meta: "_EntityMeta", dialect: str) -> str:
    q = quote_ident
    return (f"SELECT * FROM {q(meta.table, dialect)} "
            f"WHERE {q(meta.primary_key, dialect)} = ?")


def update_query(meta: "_EntityMeta", fields: list[str], dialect: str) -> str:
    q = quote_ident
    sets = ", ".join(f"{q(f, dialect)} = ?" for f in fields)
    return (f"UPDATE {q(meta.table, dialect)} SET {sets} "
            f"WHERE {q(meta.primary_key, dialect)} = ?")


def delete_query(meta: "_EntityMeta", dialect: str) -> str:
    q = quote_ident
    return (f"DELETE FROM {q(meta.table, dialect)} "
            f"WHERE {q(meta.primary_key, dialect)} = ?")


def _dialect(ctx: Context) -> str:
    return getattr(ctx.sql, "dialect", "sqlite")


@dataclasses.dataclass
class _EntityMeta:
    name: str
    table: str
    fields: list[str]
    primary_key: str
    auto_increment: bool
    not_null: list[str]


def scan_entity(entity: type) -> _EntityMeta:
    if not dataclasses.is_dataclass(entity):
        raise InvalidInput(f"entity {entity.__name__} must be a dataclass")
    fields = dataclasses.fields(entity)
    if not fields:
        raise InvalidInput(f"entity {entity.__name__} has no fields")
    pk = fields[0]

    def tags(f):  # comma-separated
        return {t.strip() for t in f.metadata.get("sql", "").split(",")}

    return _EntityMeta(
        name=entity.__name__,
        table=snake_case(entity.__name__),
        fields=[f.name for f in fields],
        primary_key=pk.name,
        auto_increment="auto_increment" in tags(pk),
        not_null=[f.name for f in fields if "not_null" in tags(f)],
    )


def register_crud_handlers(app, entity: type) -> None:
    meta = scan_entity(entity)
    route = f"/{meta.table}"

    def override(verb: str):
        fn = getattr(entity, verb, None)
        if not callable(fn):
            return None
        params = list(inspect.signature(fn).parameters)
        if params and params[0] == "self":
            # instance method: def get_all(self, ctx). Bind a shell
            # instance WITHOUT __init__ — entities may have required
            # fields, and self here is only a method receiver.
            async def bound(ctx, _fn=fn):
                result = _fn(entity.__new__(entity), ctx)
                if inspect.isawaitable(result):
                    result = await result
                return result

            return bound
        return fn  # staticmethod / plain function taking (ctx, ...)

    app.post(route, override("create") or _create_handler(entity, meta))
    app.get(route, override("get_all") or _get_all_handler(entity, meta))
    app.get(route + "/{id}", override("get") or _get_handler(entity, meta))
    app.put(route + "/{id}", override("update") or _update_handler(entity, meta))
    app.delete(route + "/{id}", override("delete") or _delete_handler(entity, meta))


def _check_not_null(meta: _EntityMeta, obj, *, skip: str | None = None) -> None:
    for f in meta.not_null:
        if f == skip:
            continue
        # only None, not an empty string
        if getattr(obj, f, None) is None:
            raise InvalidInput(f"field {f!r} must not be null")


def _create_handler(entity: type, meta: _EntityMeta):
    async def create(ctx: Context) -> Any:
        obj = await ctx.bind(entity)
        _check_not_null(meta, obj)
        fields = list(meta.fields)
        if meta.auto_increment:
            fields = fields[1:]
        values = [getattr(obj, f) for f in fields]
        new_id = await _sql(
            ctx.sql.exec_last_id, insert_query(meta, fields, _dialect(ctx)),
            *values,
        )
        if meta.auto_increment:
            return {"id": new_id, "message": f"{meta.name} successfully "
                                             f"created with id: {new_id}"}
        pk = getattr(obj, meta.primary_key)
        return {"message": f"{meta.name} successfully created with id: {pk}"}

    return create


def _get_all_handler(entity: type, meta: _EntityMeta):
    async def get_all(ctx: Context) -> Any:
        return await _sql(ctx.sql.select, entity,
                          select_all_query(meta, _dialect(ctx)))

    return get_all


def _get_handler(entity: type, meta: _EntityMeta):
    async def get(ctx: Context) -> Any:
        entity_id = ctx.path_param("id")
        rows = await _sql(
            ctx.sql.select, entity, select_query(meta, _dialect(ctx)), entity_id
        )
        if not rows:
            raise EntityNotFound(meta.primary_key, entity_id)
        return rows[0]

    return get


def _update_handler(entity: type, meta: _EntityMeta):
    async def update(ctx: Context) -> Any:
        entity_id = ctx.path_param("id")
        obj = await ctx.bind(entity)
        # the PK comes from the path and is never written by UPDATE —
        # don't demand it in the body
        _check_not_null(meta, obj, skip=meta.primary_key)
        fields = [f for f in meta.fields if f != meta.primary_key]
        values = [getattr(obj, f) for f in fields]
        n = await _sql(
            ctx.sql.exec, update_query(meta, fields, _dialect(ctx)),
            *values, entity_id,
        )
        if n == 0:
            raise EntityNotFound(meta.primary_key, entity_id)
        return f"{meta.name} successfully updated with id: {entity_id}"

    return update


def _delete_handler(entity: type, meta: _EntityMeta):
    async def delete(ctx: Context) -> Any:
        entity_id = ctx.path_param("id")
        n = await _sql(
            ctx.sql.exec, delete_query(meta, _dialect(ctx)), entity_id
        )
        if n == 0:
            raise EntityNotFound(meta.primary_key, entity_id)
        return f"{meta.name} successfully deleted with id: {entity_id}"

    return delete
