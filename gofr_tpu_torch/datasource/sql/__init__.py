"""SQL datasource — counterpart of ``gofr_tpu/datasource/sql``, on
sqlite (the standard library's ``sqlite3``).

Every statement runs on one worker thread per connection (sqlite's
same-thread rule, and the event loop never blocks on it), is logged at
DEBUG as a ``QueryLog`` and recorded into the ``app_sql_stats``
histogram. ``exec`` / ``exec_last_id`` commit, ``query`` returns rows as
dicts, ``select`` binds them into dataclasses, ``begin()`` opens a ``Tx``
(DDL takes part: a failed migration's ``CREATE TABLE`` rolls back), and
``health_check`` runs ``SELECT 1``. The JAX package's wire dialects
(``mysql`` and ``postgres`` over its own wire clients) are not ported:
``new_sql`` raises ``ValueError`` for them.
"""

from __future__ import annotations

import dataclasses
import queue
import sqlite3
import threading
import time
import typing
from typing import Any

from ...metrics import MetricsError

__all__ = ["SQL", "Tx", "new_sql", "QueryLog"]


@dataclasses.dataclass
class QueryLog:
    """One statement's structured log entry."""

    query: str
    duration_us: int
    args: tuple = ()

    def to_dict(self) -> dict:
        return {"query": self.query, "duration": self.duration_us}

    def pretty_print(self, writer) -> None:
        writer.write(f"\x1b[38;5;8mSQL\x1b[0m {self.duration_us:8d}μs "
                     f"{self.query} ")


class _Worker:
    """One thread running closures in order (sqlite's thread affinity)."""

    def __init__(self, name: str = "gofr-sql") -> None:
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=name)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, box, done = item
            try:
                box.append(fn())
            except BaseException as exc:  # noqa: BLE001 - relayed to caller
                box.append(exc)
                box.append(True)
            done.set()

    def call(self, fn):
        box: list = []
        done = threading.Event()
        self._q.put((fn, box, done))
        done.wait()
        if len(box) == 2:
            raise box[0]
        return box[0]

    def close(self) -> None:
        self._q.put(None)


class _Common:
    """Shared query surface for SQL and Tx."""

    _metrics = None
    _logger = None
    _worker: _Worker

    def _observe(self, query: str, start: float, args: tuple) -> None:
        dur_us = int((time.perf_counter() - start) * 1e6)
        if self._logger is not None:
            self._logger.debug(QueryLog(query=query, duration_us=dur_us,
                                        args=args))
        if self._metrics is not None:
            try:
                self._metrics.record_histogram(
                    "app_sql_stats", dur_us / 1e6,
                    type=query.split(" ", 1)[0].lower())
            except MetricsError:
                pass  # a manager without the framework's metric set

    def _conn(self) -> sqlite3.Connection:
        raise NotImplementedError

    def exec(self, query: str, *args: Any) -> int:
        """Execute and commit a statement; its rowcount."""
        start = time.perf_counter()
        try:
            def run():
                cur = self._conn().execute(query, args)
                self._conn().commit()
                return cur.rowcount if cur.rowcount is not None else 0

            return self._worker.call(run)
        finally:
            self._observe(query, start, args)

    def exec_last_id(self, query: str, *args: Any) -> int:
        start = time.perf_counter()
        try:
            def run():
                cur = self._conn().execute(query, args)
                self._conn().commit()
                return cur.lastrowid

            return self._worker.call(run)
        finally:
            self._observe(query, start, args)

    def query(self, query: str, *args: Any) -> list[dict]:
        """A SELECT's rows as dicts."""
        start = time.perf_counter()
        try:
            def run():
                cur = self._conn().execute(query, args)
                cols = [d[0] for d in cur.description] if cur.description else []
                return [dict(zip(cols, row, strict=True))
                        for row in cur.fetchall()]

            return self._worker.call(run)
        finally:
            self._observe(query, start, args)

    def query_row(self, query: str, *args: Any) -> dict | None:
        rows = self.query(query, *args)
        return rows[0] if rows else None

    def select(self, model: type, query: str, *args: Any) -> list[Any]:
        """A SELECT's rows bound into ``model`` (a dataclass; ints into
        its bool fields as bools)."""
        rows = self.query(query, *args)
        if not dataclasses.is_dataclass(model):
            return rows
        hints = typing.get_type_hints(model)
        out = []
        names = {f.name for f in dataclasses.fields(model)}
        for row in rows:
            kwargs = {k: row[k] for k in row if k in names}
            for k, v in list(kwargs.items()):
                annot = hints.get(k)
                if annot is bool and isinstance(v, int):
                    kwargs[k] = bool(v)
            out.append(model(**kwargs))
        return out


class Tx(_Common):
    """Transaction handle; statements share the SQL worker + connection."""

    def __init__(self, db: "SQL") -> None:
        self._db = db
        self._worker = db._worker
        self._logger = db._logger
        self._metrics = db._metrics
        self._done = False

    def _conn(self) -> sqlite3.Connection:
        return self._db._connection

    def exec(self, query: str, *args: Any) -> int:
        start = time.perf_counter()
        try:
            def run():
                cur = self._db._connection.execute(query, args)
                return cur.rowcount if cur.rowcount is not None else 0

            return self._worker.call(run)
        finally:
            self._observe(query, start, args)

    def exec_last_id(self, query: str, *args: Any) -> int:
        start = time.perf_counter()
        try:
            def run():
                cur = self._db._connection.execute(query, args)
                return cur.lastrowid

            return self._worker.call(run)
        finally:
            self._observe(query, start, args)

    def commit(self) -> None:
        if self._done:
            return
        self._worker.call(lambda: self._db._connection.commit())
        self._done = True

    def rollback(self) -> None:
        if self._done:
            return
        self._worker.call(lambda: self._db._connection.rollback())
        self._done = True

    def __enter__(self) -> "Tx":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.rollback()
        else:
            self.commit()


class SQL(_Common):
    """The sqlite datasource; ``dialect`` tells the CRUD query builder
    how to quote."""

    def __init__(self, database: str = ":memory:", dialect: str = "sqlite",
                 logger=None, metrics=None) -> None:
        self.dialect = dialect
        self.database = database
        self._logger = logger
        self._metrics = metrics
        self._worker = _Worker()

        def _open() -> sqlite3.Connection:
            conn = sqlite3.connect(database, check_same_thread=False)
            # transactional mode (PEP 249): DDL participates in transactions,
            # so a failed migration's CREATE TABLE really rolls back
            conn.autocommit = False
            return conn

        self._connection: sqlite3.Connection = self._worker.call(_open)

    def _conn(self) -> sqlite3.Connection:
        return self._connection

    def begin(self) -> Tx:
        return Tx(self)

    def health_check(self) -> dict:
        try:
            self.query("SELECT 1")
            return {
                "status": "UP",
                "details": {"database": self.database, "dialect": self.dialect},
            }
        except sqlite3.Error as exc:
            return {"status": "DOWN", "error": str(exc)}

    def close(self) -> None:
        try:
            self._worker.call(self._connection.close)
        finally:
            self._worker.close()


def new_sql(config, logger=None, metrics=None) -> SQL:
    """The SQL datasource of ``DB_DIALECT`` (sqlite when unset) and
    ``DB_NAME`` (``:memory:`` by default)."""
    dialect = (config.get("DB_DIALECT") or "sqlite").lower()
    if dialect in ("mysql", "postgres"):
        raise ValueError(
            f"DB_DIALECT {dialect!r} is not ported yet: the port's SQL runs "
            f"on sqlite only (the mysql and postgres wire clients, mywire "
            f"and pgwire, come in a later slice)")
    if dialect != "sqlite":
        raise ValueError(f"unsupported DB_DIALECT {dialect!r}")
    name = config.get_or_default("DB_NAME", ":memory:")
    db = SQL(name, "sqlite", logger, metrics)
    if logger is not None:
        logger.infof("connected to sqlite database %s", name)
    return db
