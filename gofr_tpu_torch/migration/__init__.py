"""Database migrations — counterpart of ``gofr_tpu/migration``, with its
SQL migrator.

``run(migrations, container)`` (``App.migrate``) applies the migrations of
a ``{version: Migrate(up=fn)}`` map (or bare functions) in version order,
skipping every version at or below the last one recorded. Each runs inside
a SQL transaction: its UP function gets a ``Datasource`` whose ``sql`` is
the ``Tx``; on success the bookkeeping row goes into the
``gofr_migrations`` table (version, ``UP``, the start time in UTC, the
duration in ms) in the same transaction, so a database migrated by either
package reads as migrated by the other; on failure the transaction rolls
back and the run halts with the error. UP functions may be ``async``.
The JAX package's Redis, ClickHouse, Cassandra and Mongo migrators come
with those datasources.
"""

from __future__ import annotations

import asyncio
import inspect
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

__all__ = ["Migrate", "Datasource", "run"]

_CREATE_TABLE = """
CREATE TABLE IF NOT EXISTS gofr_migrations (
    version    INTEGER NOT NULL,
    method     TEXT    NOT NULL,
    start_time TEXT    NOT NULL,
    duration   INTEGER,
    PRIMARY KEY (version, method)
)
"""


class Datasource:
    """What a migration's UP function receives: the container's
    datasources (``sql`` the migration's transaction) and logger."""

    def __init__(self, container) -> None:
        self._container = container
        self.sql = container.sql
        self.redis = container.redis
        self.kv = container.kv
        self.pubsub = container.pubsub
        self.clickhouse = container.clickhouse
        self.cassandra = container.cassandra
        self.mongo = container.mongo
        self.logger = container.logger


@dataclass
class Migrate:
    up: Callable[[Datasource], Any]


def _ts(t: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t))


class _SQLMigrator:
    name = "sql"

    def __init__(self, sql) -> None:
        self._sql = sql

    def ensure(self) -> None:
        self._sql.exec(_CREATE_TABLE)

    def last(self) -> int:
        row = self._sql.query_row(
            "SELECT MAX(version) AS v FROM gofr_migrations")
        return int(row["v"]) if row and row["v"] is not None else 0

    def begin(self, ds: Datasource):
        tx = self._sql.begin()
        ds.sql = tx
        return tx

    def commit(self, tx, version: int, start: float, dur_ms: int) -> None:
        tx.exec("INSERT INTO gofr_migrations (version, method, start_time, "
                "duration) VALUES (?, ?, ?, ?)", version, "UP", _ts(start),
                dur_ms)
        tx.commit()

    def rollback(self, tx) -> None:
        tx.rollback()


async def _run_async(migrations: dict[int, Any], container) -> None:
    logger = container.logger
    chain = [_SQLMigrator(container.sql)] if container.sql is not None else []
    for m in chain:
        m.ensure()
    last = max((m.last() for m in chain), default=0)
    for version in sorted(migrations):
        if version <= last:
            continue
        entry = migrations[version]
        up = entry.up if isinstance(entry, Migrate) else entry
        start = time.time()
        ds = Datasource(container)
        states = [(m, m.begin(ds)) for m in chain]
        try:
            result = up(ds)
            if inspect.isawaitable(result):
                await result
            dur_ms = int((time.time() - start) * 1e3)
            for m, state in states:
                m.commit(state, version, start, dur_ms)
            logger.infof("migration %d applied in %dms", version, dur_ms)
        except Exception as exc:
            for m, state in states:
                try:
                    m.rollback(state)
                except Exception:  # report it; the first error is raised
                    logger.errorf("migration %d: %s rollback failed",
                                  version, m.name)
            logger.errorf("migration %d failed: %s; halting", version, exc)
            raise


def run(migrations: dict[int, Migrate | Callable], container) -> None:
    """Apply the pending migrations in version order; halt on the first
    failure. Called inside a running event loop (an app built in an async
    server or test), the migrations run on a private loop in a worker
    thread."""
    if not migrations:
        return
    invalid = [k for k in migrations if not isinstance(k, int) or k <= 0]
    if invalid:
        container.logger.errorf("invalid migration versions: %s", invalid)
        return
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        asyncio.run(_run_async(migrations, container))
        return
    failed: list[BaseException] = []

    def worker() -> None:
        try:
            asyncio.run(_run_async(migrations, container))
        except BaseException as exc:  # re-raised on the caller's thread
            failed.append(exc)

    t = threading.Thread(target=worker, name="gofr-migrations")
    t.start()
    t.join()
    if failed:
        raise failed[0]
