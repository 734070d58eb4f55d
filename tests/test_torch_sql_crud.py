"""PyTorch port, SQL, migrations and CRUD: the same apps in ``gofr_tpu``
and ``gofr_tpu_torch`` over sqlite (``DB_DIALECT=sqlite``).

Held: the CRUD resources of ``add_rest_handlers`` (every verb, an
auto-increment and a given primary key, ``not_null`` fields, a verb the
entity overrides, a reserved word as a table) answer the same requests
with the same status and body; migrations interoperate on one database
file in both orders (what one package applied, the other sees as
applied, and the ``gofr_migrations`` rows are alike); a failing
migration rolls back alike; ``SQL``'s queries, transactions, ``select``
and health agree; ``new_sql`` refuses the wire dialects. The port's twins
of the CRUD tests of ``tests/test_http_app.py`` and of
``tests/test_sql_dialects.py``'s sqlite cases.
"""

import asyncio
import dataclasses
import importlib
import re
import sqlite3

import pytest

pytestmark = pytest.mark.timeout(120)

PKGS = ("gofr_tpu", "gofr_tpu_torch")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def sqlite_app(pkg: str, db: str = ":memory:"):
    config = mod(pkg, "config").MapConfig({
        "APP_NAME": "crud", "LOG_LEVEL": "FATAL", "DB_DIALECT": "sqlite",
        "DB_NAME": db})
    return mod(pkg, "app").App(config=config)


@dataclasses.dataclass
class Book:
    id: int = dataclasses.field(default=0, metadata={"sql": "auto_increment"})
    title: str = ""
    pages: int = 0
    in_print: bool = False


@dataclasses.dataclass
class Gadget:
    id: int | None = dataclasses.field(
        default=None, metadata={"sql": "auto_increment,index"})
    name: str | None = dataclasses.field(default=None,
                                         metadata={"sql": "not_null"})
    note: str = ""


@dataclasses.dataclass
class Order:  # "order" is a reserved word: the builder quotes it
    code: str = ""
    qty: int = 0

    async def get_all(self, ctx):
        return await asyncio.to_thread(
            ctx.sql.query, 'SELECT code FROM "order" WHERE qty > 1')


TABLES = (
    "CREATE TABLE book (id INTEGER PRIMARY KEY AUTOINCREMENT, title TEXT,"
    " pages INTEGER, in_print INTEGER)",
    "CREATE TABLE gadget (id INTEGER PRIMARY KEY AUTOINCREMENT,"
    " name TEXT NOT NULL, note TEXT)",
    'CREATE TABLE "order" (code TEXT PRIMARY KEY, qty INTEGER)')

CALLS = [
    ("POST", "/book", {"title": "Dune", "pages": 412, "in_print": True}),
    ("POST", "/book", {"title": "Emma", "pages": "300"}),
    ("GET", "/book", None), ("GET", "/book/1", None),
    ("PUT", "/book/1", {"title": "Dune", "pages": 500, "in_print": False}),
    ("GET", "/book/1", None), ("PUT", "/book/9", {"title": "x"}),
    ("DELETE", "/book/2", None), ("DELETE", "/book/2", None),
    ("GET", "/book/2", None), ("POST", "/book", {"pages": "many"}),
    ("POST", "/gadget", {"note": "no name"}),
    ("POST", "/gadget", {"name": "ok"}),
    ("PUT", "/gadget/1", {"name": "", "note": "x"}),
    ("PUT", "/gadget/1", {"name": None, "note": "x"}),
    ("GET", "/gadget", None),
    ("POST", "/order", {"code": "A-1", "qty": 3}),
    ("POST", "/order", {"code": "B-2", "qty": 1}),
    ("POST", "/order", {"code": "A-1", "qty": 3}),
    ("GET", "/order", None), ("GET", "/order/B-2", None),
    ("PATCH", "/book/1", {"pages": 1}),
]


async def drive_crud(pkg: str) -> list:
    from aiohttp.test_utils import TestClient, TestServer

    app = sqlite_app(pkg)
    for ddl in TABLES:
        app.container.sql.exec(ddl)
    for entity in (Book, Gadget, Order):
        app.add_rest_handlers(entity)
    client = TestClient(TestServer(app._build_http_app()))
    await client.start_server()
    out = []
    try:
        for method, path, body in CALLS:
            kw = {"json": body} if body is not None else {}
            r = await client.request(method, path, **kw)
            out.append((method, path, r.status, await r.text()))
        r = await client.get("/.well-known/health")
        out.append(("health", r.status, await r.json()))
    finally:
        await client.close()
        await app.container.close()
    return out


@pytest.fixture(scope="module")
def crud():
    return {pkg: asyncio.run(drive_crud(pkg)) for pkg in PKGS}


@pytest.mark.parametrize("i", range(len(CALLS) + 1))
def test_crud_call_answers_match(crud, i):
    assert crud["gofr_tpu_torch"][i] == crud["gofr_tpu"][i]


def test_crud_answers_as_promised(crud):
    got = {i: c for i, c in enumerate(crud["gofr_tpu_torch"])}
    assert [got[i][2] for i in (0, 1, 4, 6, 7, 8, 9)] == \
        [201, 201, 200, 404, 204, 404, 404]
    assert '"pages": 500' in got[5][3] and '"in_print": false' in got[5][3]
    assert got[10][2] == 400  # "many" is no int
    assert got[11][2] == 400 and "name" in got[11][3]
    assert [got[i][2] for i in (12, 13, 14)] == [201, 200, 400]
    assert got[18][2] == 500  # the duplicate key: an opaque 500
    assert got[19][3] == '{"data": [{"code": "A-1"}]}'  # the override
    assert got[21][2] == 405
    assert got[22][1] == 200 and got[22][2]["data"]["sql"]["status"] == "UP"


def test_crud_query_builder_quotes_per_dialect():
    for dialect in ("sqlite", "mysql", "postgres"):
        metas = [mod(pkg, "crud").scan_entity(Gadget) for pkg in PKGS]
        for name in ("insert_query", "update_query"):
            got = [getattr(mod(pkg, "crud"), name)(m, ["name", "note"],
                                                   dialect)
                   for pkg, m in zip(PKGS, metas)]
            assert got[1] == got[0]
        for name in ("select_all_query", "select_query", "delete_query"):
            got = [getattr(mod(pkg, "crud"), name)(m, dialect)
                   for pkg, m in zip(PKGS, metas)]
            assert got[1] == got[0]
    meta = mod("gofr_tpu_torch", "crud").scan_entity(Gadget)
    assert meta.not_null == ["name"] and meta.auto_increment
    assert mod("gofr_tpu_torch", "crud").insert_query(
        meta, ["name"], "postgres").endswith('RETURNING "id"')


# -- migrations ------------------------------------------------------------------

def v1(ds):
    ds.sql.exec("CREATE TABLE employee (id INTEGER PRIMARY KEY, name TEXT)")


def v2(ds):
    ds.sql.exec("ALTER TABLE employee ADD COLUMN email TEXT")


async def v3(ds):  # an async UP
    ds.sql.exec("INSERT INTO employee (id, name, email) VALUES (1, 'a', 'e')")


def failing(ds):
    ds.sql.exec("CREATE TABLE half_done (x INTEGER)")
    raise RuntimeError("boom in migration")


def rows(db: str) -> list[tuple]:
    with sqlite3.connect(db) as conn:
        return conn.execute(
            "SELECT version, method, start_time, duration FROM "
            "gofr_migrations ORDER BY version").fetchall()


def tables(db: str) -> list[str]:
    with sqlite3.connect(db) as conn:
        return sorted(r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type = 'table'"))


def migrate(pkg: str, db: str, migrations: dict) -> None:
    app = sqlite_app(pkg, db)
    Migrate = mod(pkg, "migration").Migrate
    try:
        app.migrate({v: Migrate(up=fn) for v, fn in migrations.items()})
    finally:
        app.container.sql.close()


@pytest.mark.parametrize("first,second", [PKGS, PKGS[::-1]])
def test_migrations_interoperate_on_one_file(tmp_path, first, second):
    """``first`` applies versions 1 and 2; ``second``, given 1, 2 and 3,
    applies only 3; both write the same kind of row."""
    db = str(tmp_path / "m.db")
    migrate(first, db, {1: v1, 2: v2})
    after_first = rows(db)
    migrate(second, db, {1: v1, 2: v2, 3: v3})
    got = rows(db)
    assert got[:2] == after_first
    assert [(v, m) for v, m, _, _ in got] == [(1, "UP"), (2, "UP"),
                                               (3, "UP")]
    for _, _, start, dur in got:
        assert re.fullmatch(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ", start)
        assert isinstance(dur, int) and dur >= 0
    with sqlite3.connect(db) as conn:
        assert conn.execute("SELECT id, name, email FROM employee"
                            ).fetchall() == [(1, "a", "e")]


def test_gofr_migrations_table_is_the_same(tmp_path):
    schemas = []
    for pkg in PKGS:
        db = str(tmp_path / f"{pkg}.db")
        migrate(pkg, db, {1: v1})
        with sqlite3.connect(db) as conn:
            schemas.append(conn.execute(
                "SELECT sql FROM sqlite_master WHERE name = "
                "'gofr_migrations'").fetchone())
    assert schemas[1] == schemas[0]


def test_failing_migration_rolls_back_alike(tmp_path):
    results = []
    for pkg in PKGS:
        db = str(tmp_path / f"{pkg}.db")
        with pytest.raises(RuntimeError, match="boom in migration"):
            migrate(pkg, db, {1: v1, 2: failing, 3: v2})
        results.append(([(v, m) for v, m, _, _ in rows(db)], tables(db)))
    assert results[1] == results[0]
    assert results[1] == ([(1, "UP")], ["employee", "gofr_migrations"])


def test_invalid_versions_are_refused_alike(tmp_path):
    for pkg in PKGS:
        db = str(tmp_path / f"{pkg}.db")
        migrate(pkg, db, {0: v1, -2: v2})
        assert tables(db) == []


def test_migrate_inside_a_running_loop(tmp_path, run):
    """Built inside an async server, the app still migrates (on a worker
    thread's loop)."""
    async def scenario():
        migrate("gofr_tpu_torch", str(tmp_path / "loop.db"),
                {1: v1, 2: v2, 3: v3})

    run(scenario())
    assert [r[0] for r in rows(str(tmp_path / "loop.db"))] == [1, 2, 3]


# -- the SQL datasource ----------------------------------------------------------

@dataclasses.dataclass
class Row:
    id: int = 0
    name: str = ""
    flag: bool = False


def sql_ops(pkg: str) -> list:
    db = mod(pkg, "datasource.sql").SQL(":memory:")
    out = [db.exec("CREATE TABLE t (id INTEGER PRIMARY KEY, name TEXT,"
                   " flag INTEGER)")]
    out.append(db.exec_last_id("INSERT INTO t (name, flag) VALUES (?, ?)",
                               "a", 1))
    out.append(db.exec_last_id("INSERT INTO t (name, flag) VALUES (?, ?)",
                               "b", 0))
    out.append(db.query("SELECT * FROM t ORDER BY id"))
    out.append(db.query_row("SELECT name FROM t WHERE id = ?", 2))
    out.append(db.query_row("SELECT name FROM t WHERE id = ?", 9))
    out.append([dataclasses.asdict(r) for r in db.select(
        Row, "SELECT * FROM t ORDER BY id")])
    with db.begin() as tx:
        out.append(tx.exec("UPDATE t SET name = ? WHERE id = ?", "z", 1))
    tx = db.begin()
    tx.exec("DELETE FROM t")
    tx.rollback()
    out.append(db.query("SELECT count(*) AS n FROM t"))
    try:
        with db.begin() as tx:
            tx.exec("INSERT INTO t (name) VALUES ('in tx')")
            raise KeyError("abort")
    except KeyError:
        pass
    out.append(db.query("SELECT name FROM t ORDER BY id"))
    try:
        db.exec("SELECT * FROM nope")
    except sqlite3.Error as exc:
        out.append(("error", type(exc).__name__, str(exc)))
    out.append(db.health_check())
    db.close()
    return out


def test_sql_datasource_agrees():
    jax, port = (sql_ops(pkg) for pkg in PKGS)
    assert port == jax
    assert port[6][0] == {"id": 1, "name": "a", "flag": True}
    assert port[-1]["status"] == "UP"


def test_sql_records_its_statements():
    from gofr_tpu_torch.container import new_container
    from gofr_tpu_torch.config import MapConfig

    c = new_container(MapConfig({"DB_DIALECT": "sqlite",
                                 "LOG_LEVEL": "FATAL"}))
    c.sql.exec("CREATE TABLE t (x INTEGER)")
    c.sql.query("SELECT * FROM t")
    text = c.metrics_manager.expose_text()
    assert 'app_sql_stats_count{type="create"} 1' in text
    assert 'app_sql_stats_count{type="select"} 1' in text
    asyncio.run(c.close())


@pytest.mark.parametrize("dialect", ["mysql", "postgres"])
def test_new_sql_refuses_the_wire_dialects(dialect):
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.datasource.sql import new_sql

    with pytest.raises(ValueError, match=f"{dialect}.*not ported.*mywire"):
        new_sql(MapConfig({"DB_DIALECT": dialect}))
    with pytest.raises(ValueError, match="not ported"):  # through the app
        App(config=MapConfig({"DB_DIALECT": dialect, "LOG_LEVEL": "FATAL"}))


def test_unknown_dialect_is_refused_alike():
    for pkg in PKGS:
        cfg = mod(pkg, "config").MapConfig({"DB_DIALECT": "oracle"})
        with pytest.raises(ValueError, match="unsupported DB_DIALECT"):
            mod(pkg, "datasource.sql").new_sql(cfg)


def test_sql_health_down_after_a_failed_check():
    """A check that raises reports DOWN in the aggregate and turns it
    DEGRADED, in both packages."""
    class Broken:
        def health_check(self):
            raise RuntimeError("disk gone")

    out = []
    for pkg in PKGS:
        app = sqlite_app(pkg)
        app.container.add_datasource("broken", Broken())
        out.append(asyncio.run(app.container.health()))
        asyncio.run(app.container.close())
    assert out[1] == out[0]
    assert out[1]["status"] == "DEGRADED"
    assert out[1]["broken"] == {"status": "DOWN", "error": "disk gone"}
