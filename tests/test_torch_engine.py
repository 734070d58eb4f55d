"""PyTorch port, the model engine and dynamic batcher (``ctx.ml.predict``):
the port's ``MLDatasource`` / ``Engine`` / ``DynamicBatcher`` against the
JAX package's, on the CPU, with the same weights (the JAX MLP's tree
carried across with ``mlp.params_from_jax``) and the same numpy inputs.

Twins of the nine tests of ``tests/test_ml.py`` and of
``tests/test_goodput.py::test_engine_program_row``, each run through both
datasources; then what the port adds or changes: the JAX error contract of
the backends, the device rule, successful steps only in
``app_tpu_step_seconds``, the ``ml.device_step`` span, the pad cache, a
tree of outputs cut row by row, the snapshots' shapes against JAX's, and
``close``. Logits are compared within 2e-2 of their range (bf16 matmuls;
the two agree to the bit on this machine, the tolerance is the repo's
bf16 rule).
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from gofr_tpu.ml import EngineConfig as JEngineConfig
from gofr_tpu.ml import MLDatasource as JMLDatasource
from gofr_tpu.models.mlp import mnist_mlp as jmnist_mlp
from gofr_tpu_torch.ml import Engine, EngineConfig, MLDatasource
from gofr_tpu_torch.ml.batching import DynamicBatcher
from gofr_tpu_torch.models import mlp as tmlp

pytestmark = pytest.mark.timeout(300)

BF16_TOL = 2e-2


def _range_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(want.max() - want.min())


def _pair(hidden: int, seed: int = 0):
    """The JAX MNIST MLP and the port's on its weights (CPU)."""
    jm = jmnist_mlp(hidden=hidden, seed=seed)
    tree = jax.tree.map(np.asarray, jm.params)
    return jm, tmlp.mnist_mlp(hidden, params=tmlp.params_from_jax(tree, "cpu"))


@pytest.fixture(scope="module")
def ml():
    """Both datasources with ``mnist`` (hidden 64) mounted, batching on."""
    jm, tm = _pair(64)
    jds, tds = JMLDatasource(), MLDatasource()
    jds.register("mnist", jm, batching=True)
    tds.register("mnist", tm, batching=True)
    yield jds, tds
    jds.close()
    tds.close()


# -- twins of tests/test_ml.py -----------------------------------------------

def test_engine_predict_sync(ml):
    jds, tds = ml
    x = np.random.default_rng(0).normal(size=(4, 784)).astype(np.float32)
    want = jds.predict_sync("mnist", x)
    got = tds.predict_sync("mnist", x)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == (4, 10) and np.isfinite(got).all()
    assert _range_err(got, want) <= BF16_TOL


def test_engine_async_predict(ml, run):
    jds, tds = ml

    async def scenario():
        x = np.random.default_rng(1).normal(size=(2, 784)).astype(np.float32)
        return (await jds.engine("mnist").predict(x),
                await tds.engine("mnist").predict(x))

    want, got = run(scenario())
    assert got.shape == (2, 10)
    assert _range_err(got, want) <= BF16_TOL


def test_unknown_model_raises(ml):
    jds, tds = ml
    with pytest.raises(KeyError) as jerr:
        jds.engine("nope")
    with pytest.raises(KeyError) as terr:
        tds.engine("nope")
    assert str(terr.value) == str(jerr.value)


def test_engine_donate_inputs_matches_plain(run):
    """``donate_inputs`` changes no result, and the caller's array or
    tensor is never consumed (the static buffers are the engine's own)."""
    jm, tm = _pair(32)
    x = np.random.default_rng(1).normal(size=(4, 784)).astype(np.float32)
    jds, tds = JMLDatasource(), MLDatasource()
    try:
        jds.register("donated", jm, config=JEngineConfig(donate_inputs=True))
        tds.register("plain", tm)
        tds.register("donated", tm, config=EngineConfig(donate_inputs=True))
        want = jds.predict_sync("donated", x)
        ref = tds.predict_sync("plain", x)
        out = tds.predict_sync("donated", x)
        assert np.array_equal(out, ref)
        assert _range_err(out, want) <= BF16_TOL
        xt = torch.from_numpy(x.copy())
        again = tds.predict_sync("donated", xt)
        assert np.array_equal(again, ref)
        assert torch.equal(xt, torch.from_numpy(x))  # still the caller's
    finally:
        jds.close()
        tds.close()


class _FakeEngine:
    name = "fake"

    def __init__(self, calls):
        self.calls = calls

    def bucket_for(self, n):
        return 8  # always pad to 8

    async def predict(self, x):
        self.calls.append(x.shape[0])
        return x * 2


@pytest.mark.parametrize("side", ["jax", "port"])
def test_dynamic_batcher_coalesces(side, run):
    from gofr_tpu.ml.batching import DynamicBatcher as JDynamicBatcher

    cls = JDynamicBatcher if side == "jax" else DynamicBatcher
    calls: list = []

    async def scenario():
        batcher = cls(_FakeEngine(calls), max_batch=8, max_delay_s=0.02)
        inputs = [np.full((3,), i, np.float32) for i in range(5)]
        outs = await asyncio.gather(*(batcher.submit(x) for x in inputs))
        for i, out in enumerate(outs):
            assert np.allclose(out, inputs[i] * 2)
        batcher.close()

    run(scenario())
    # all 5 concurrent requests coalesced into one padded batch of 8
    assert calls == [8]


@pytest.mark.parametrize("side", ["jax", "port"])
def test_batcher_error_propagates(side, run):
    from gofr_tpu.ml.batching import DynamicBatcher as JDynamicBatcher

    cls = JDynamicBatcher if side == "jax" else DynamicBatcher

    class BadEngine:
        name = "bad"

        def bucket_for(self, n):
            return n

        async def predict(self, x):
            raise RuntimeError("device on fire")

    async def scenario():
        batcher = cls(BadEngine(), max_delay_s=0.02)
        results = await asyncio.gather(
            *(batcher.submit(np.zeros(3, np.float32)) for _ in range(3)),
            return_exceptions=True)
        batcher.close()
        return results

    results = run(scenario())
    # every caller of the failed batch gets the error
    assert all(isinstance(r, RuntimeError) and "device on fire" in str(r)
               for r in results)


def test_predict_routes_through_batcher(ml, run):
    jds, tds = ml

    async def scenario():
        # datasource-level predict on a batching model takes ONE example
        rng = np.random.default_rng(2)
        xs = [rng.normal(size=(784,)).astype(np.float32) for _ in range(6)]
        want = await asyncio.gather(*(jds.predict("mnist", x) for x in xs))
        got = await asyncio.gather(*(tds.predict("mnist", x) for x in xs))
        return want, got

    want, got = run(scenario())
    for w, g in zip(want, got):
        assert g.shape == (10,)
        assert _range_err(g, w) <= BF16_TOL


def test_ml_health_and_hbm_metrics(ml):
    from gofr_tpu.metrics import Manager as JManager
    from gofr_tpu_torch.metrics import Manager

    jds, tds = ml
    jh, th = jds.health_check(), tds.health_check()
    assert th["status"] == jh["status"] == "UP"
    assert set(th["details"]["models"]) == set(jh["details"]["models"]) \
        == {"mnist"}
    assert set(th["details"]["models"]["mnist"]) == \
        set(jh["details"]["models"]["mnist"])
    assert th["details"]["models"]["mnist"]["steps"] == \
        tds.engine("mnist").steps
    for side, manager in ((jds, JManager()), (tds, Manager())):
        manager.new_gauge("app_tpu_hbm_bytes_in_use")
        manager.new_gauge("app_tpu_hbm_bytes_limit")
        side.refresh_device_metrics(manager)  # must not raise on the CPU
    # on the CPU the process RSS stands in for device memory, as in JAX
    m = Manager()
    m.new_gauge("app_ml_host_rss_bytes")
    tds.refresh_device_metrics(m)
    assert "app_ml_host_rss_bytes " in m.expose_text()


def test_register_model_on_app(run):
    from gofr_tpu.app import App as JApp
    from gofr_tpu.config import MapConfig as JMapConfig
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig

    jm, tm = _pair(32)
    japp, app = JApp(config=JMapConfig({})), App(config=MapConfig({}))
    japp.register_model("mnist", jm)
    app.register_model("mnist", tm)
    assert app.container.ml is not None
    x = np.random.default_rng(3).normal(size=(1, 784)).astype(np.float32)
    want = japp.container.ml.predict_sync("mnist", x)
    got = app.container.ml.predict_sync("mnist", x)
    assert got.shape == want.shape == (1, 10)
    assert _range_err(got, want) <= BF16_TOL
    japp.container.ml.close()
    app.container.ml.close()


# -- twin of tests/test_goodput.py::test_engine_program_row -------------------

def test_engine_program_row():
    x = np.ones((2, 4), np.float32)
    rows = {}
    for side, ds in (("jax", JMLDatasource()), ("port", MLDatasource())):
        kw = {} if side == "jax" else {"device": "cpu"}
        engine = ds.register("toy", apply_fn=lambda p, a: a * p,
                             params=np.float32(2.0), example_inputs=(x,),
                             **kw)
        assert "apply/b2" in engine.programs
        row = next(r for r in engine.programs.snapshot(cost=True)
                   if r["name"] == "apply/b2")
        assert row["wall_s"] > 0 and row["cache"] != ""
        snap = ds.programs_snapshot(cost=False)
        assert "toy" in snap["models"]
        assert snap["models"]["toy"]["totals"]["programs"] >= 1
        assert "hbm" in snap
        assert np.array_equal(ds.predict_sync("toy", x), x * 2)
        rows[side] = row
        ds.close()
    port = rows["port"]
    assert port["cache"] == "none" and port["kind"] == "eager"
    assert port["shapes"] == {"inputs": [[2, 4]]}


# -- what the port adds or changes --------------------------------------------

def test_backends_raise_as_jax_does():
    from gofr_tpu.ml.engine import Engine as JEngine

    with pytest.raises(ValueError) as jerr:
        JEngine("m", lambda p, x: x, np.float32(1.0), backend="xla")
    with pytest.raises(ValueError) as terr:
        Engine("m", lambda p, x: x, np.float32(1.0), backend="xla",
               device="cpu")
    assert str(terr.value) == str(jerr.value)
    # the native slot builds and runs (tests/test_torch_pjrt.py holds it
    # against JAX's jit engine)
    native = Engine("m", lambda p, x: x * p, np.float32(2.0), backend="pjrt",
                    device="cpu")
    try:
        x = np.arange(6, dtype=np.float32).reshape(2, 3)
        assert np.array_equal(native.predict_sync(x), 2 * x)
        assert native.backend == "pjrt"
        assert [r["kind"] for r in native.programs.snapshot()] == \
            ["pjrt_native"]
    finally:
        native.close()
    # out_sharding: JAX's takes a NamedSharding, the port a (Mesh, P)
    # pair; both answer the same outputs (they return to the host), and
    # the port checks the output against the spec over the mesh
    from gofr_tpu import parallel as jpar
    from gofr_tpu.ml.engine import Engine as JEngine
    from gofr_tpu_torch import parallel as par

    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    jmesh = jpar.make_mesh(jpar.MeshConfig(dp=2, tp=4))
    jeng = JEngine("m", lambda p, x: x * p, np.float32(2.0),
                   out_sharding=jpar.NamedSharding(jmesh, jpar.P("dp")))
    mesh = par.make_mesh(par.MeshConfig(dp=2),
                         devices=[torch.device("cpu")] * 2)
    eng = Engine("m", lambda p, x: x * p, np.float32(2.0),
                 out_sharding=(mesh, par.P("dp")), device="cpu")
    try:
        assert np.array_equal(eng.predict_sync(x),
                              np.asarray(jeng.predict_sync(x)))
        with pytest.raises(ValueError, match="does not divide"):
            eng.predict_sync(x[:3])
    finally:
        eng.close()
        jeng.close()
    with pytest.raises(TypeError, match="out_sharding"):
        Engine("m", lambda p, x: x, np.float32(1.0), out_sharding=object(),
               device="cpu")


def test_engine_runs_on_the_card_unless_asked(monkeypatch):
    """No device and no tensor among the params: the first card, and
    without one the engine raises instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine("m", lambda p, x: x * p, np.float32(2.0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmlp.mnist_mlp(32)
    engine = Engine("m", lambda p, x: x * p, np.float32(2.0), device="cpu")
    assert engine.device.type == "cpu"
    engine.close()


def test_step_metric_span_and_numpy_results():
    """``app_tpu_step_seconds`` counts successful steps only; every execute
    opens ``ml.device_step`` with the model, backend and batch; bf16 comes
    back widened to f32, 64-bit host arrays narrow to 32 bits."""
    from gofr_tpu_torch.metrics import Manager
    from gofr_tpu_torch.tracing import Tracer

    spans = []

    class Recording(Tracer):
        def _on_end(self, span):
            spans.append(span)

    def apply(p, x):
        if float(x[0, 0]) < 0:
            raise ValueError("negative")
        return {"y": (x * p).to(torch.bfloat16), "n": x.sum(1)}

    m = Manager()
    m.new_histogram("app_tpu_step_seconds")
    engine = Engine("toy", apply, np.float32(3.0), metrics=m,
                    tracer=Recording(), device="cpu")
    out = engine.predict_sync(np.ones((2, 3)))  # float64 in
    assert out["y"].dtype == np.float32 and out["n"].dtype == np.float32
    assert np.array_equal(out["y"], np.full((2, 3), 3.0, np.float32))
    with pytest.raises(ValueError, match="negative"):
        engine.predict_sync(-np.ones((2, 3), np.float32))
    engine.close()
    assert engine.steps == 1
    assert 'app_tpu_step_seconds_count{model="toy"} 1' in m.expose_text()
    assert [s.name for s in spans] == ["ml.device_step"] * 2
    assert spans[0].attributes == {"ml.model": "toy", "ml.backend": "jit",
                                   "ml.batch": 2}
    assert spans[1].status_code == "ERROR"


def test_batcher_pads_from_one_block_and_cuts_trees(run):
    """Padding reuses one cached zero block per (rows, shape, dtype), and a
    dict of outputs reaches each caller as the dict of its rows."""
    engine = Engine("toy", lambda p, x: {"double": x * p, "sum": x.sum(1)},
                    np.float32(2.0), device="cpu",
                    config=EngineConfig(batch_buckets=(4,)))
    batcher = DynamicBatcher(engine, max_batch=4, max_delay_s=0.2)

    async def scenario():
        outs = []
        for _ in range(2):
            xs = [np.full((3,), i + 1, np.float32) for i in range(3)]
            outs.append(await asyncio.gather(*(batcher.submit(x)
                                               for x in xs)))
        return outs

    outs = run(scenario())
    batcher.close()
    engine.close()
    assert list(batcher._pad_cache) == [(1, (3,), "<f4")]
    for round_ in outs:
        for i, out in enumerate(round_):
            assert np.array_equal(out["double"], np.full((3,), 2 * (i + 1)))
            assert out["sum"] == 3 * (i + 1)
    assert engine.compiled_buckets == {4}


def test_snapshots_and_gauges_match_jax(ml):
    """``/debug/serving``'s model row, ``/debug/programs``' model set and
    the queue-depth gauges have JAX's shape."""
    from gofr_tpu.metrics import Manager as JManager
    from gofr_tpu_torch.metrics import Manager

    jds, tds = ml
    jrow = jds.serving_snapshot()["models"]["mnist"]
    trow = tds.serving_snapshot()["models"]["mnist"]
    assert set(trow) == set(jrow)
    for key in ("backend", "batch_buckets", "compiled_buckets", "batcher"):
        assert trow[key] == jrow[key], key
    assert set(tds.programs_snapshot()["models"]) == \
        set(jds.programs_snapshot()["models"])

    def depth_series(ds, manager):
        manager.new_gauge("app_ml_queue_depth")
        manager.new_gauge("app_ml_host_rss_bytes")
        for name in ("app_tpu_hbm_bytes_in_use", "app_tpu_hbm_bytes_limit",
                     "app_ml_programs"):
            manager.new_gauge(name)
        for name in ("app_ml_events_dropped_total",
                     "app_ml_compile_seconds_total",
                     "app_ml_compile_cache_hits_total",
                     "app_llm_tokens_wasted_total"):
            manager.new_counter(name)
        manager.new_gauge("app_llm_goodput_fraction")
        ds._metrics = manager
        ds.sample_runtime_gauges()
        return sorted(line for line in manager.expose_text().splitlines()
                      if line.startswith("app_ml_queue_depth{"))

    jseries = depth_series(jds, JManager())
    tseries = depth_series(tds, Manager())
    assert tseries == jseries
    assert any('component="batcher"' in s for s in tseries)


def test_close_stops_every_engine():
    ds = MLDatasource()
    ds.register("a", tmlp.mnist_mlp(16, device="cpu"), batching=True)
    ds.register("b", apply_fn=lambda p, x: x, params=np.float32(0),
                device="cpu")
    engines = [ds.engine("a"), ds.engine("b")]
    ds.close()
    assert not any(e._thread.is_alive() for e in engines)
    assert ds.batcher("a")._closed
