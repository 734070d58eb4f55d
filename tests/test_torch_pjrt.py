"""PyTorch port, the native executor slot: ``Engine(backend="pjrt")`` over
``gofr_tpu_torch.native.aoti`` (``torch.export`` + AOTInductor packages run
by the port's own C++ binding, ``native/aoti_shim.cpp``), on the CPU.

Twins of the seven tests of ``tests/test_pjrt.py`` that do not test PJRT
itself (a compile error's message, an echo, an add, the arity error, the
lifecycle, the artifact, the selftest); then ``Engine(backend="pjrt")`` on
the MNIST MLP and a tiny BERT against JAX's ``Engine(backend="jit")`` at
f32 with the weights bridged (within ``F32_TOL`` of the range: Inductor
fuses and orders sums its own way), one compile per input signature and a
disk hit for a fresh executor and a second process, the ``pjrt/…`` rows
and ``/debug/programs``' ``pjrt`` keys against JAX's, the GIL released
while a package runs, a failed build that raises instead of falling back,
and the plugin arguments the port refuses.

Compiles are few and small (module fixtures: each takes ~15 s on a CPU).
"""

import json
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ml.engine import Engine as JEngine
from gofr_tpu.models import bert as jbert
from gofr_tpu.models.mlp import mnist_mlp as jmnist_mlp
from gofr_tpu_torch import native
from gofr_tpu_torch.ml import Engine, EngineConfig, MLDatasource
from gofr_tpu_torch.models import bert as tbert
from gofr_tpu_torch.models import mlp as tmlp
from gofr_tpu_torch.native import aoti

pytestmark = pytest.mark.timeout(600)

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 1e-5


def _range_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(want.max() - want.min())


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 and back: JAX's MLP casts its input to bf16,
    so an input already on that grid makes the two f32 paths compare."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def _echo_add_args():
    """Inputs of the shared program: two f32 blocks to add, and an f32, an
    int64 and a uint8 tensor to echo."""
    return [torch.ones(2, 4), torch.full((2, 4), 2.0),
            torch.arange(12, dtype=torch.float32).reshape(3, 4),
            torch.tensor([[1, 2], [3, 2 ** 40]], dtype=torch.int64),
            torch.tensor([255, 0, 7], dtype=torch.uint8)]


@pytest.fixture(scope="module")
def add_exe():
    """One small program for the twins (JAX's fake plugin has an add and an
    echo mode): ``x + y`` and the three echoed tensors."""
    compiled = aoti.compile(lambda x, y, *echo: (x + y, *echo),
                            _echo_add_args(), device="cpu")
    exe = aoti.Executable(compiled.path, "cpu")
    yield compiled, exe
    exe.destroy()


# -- twins of tests/test_pjrt.py -------------------------------------------------

def test_compile_error_surfaces_message():
    with pytest.raises(aoti.AotiError, match="empty program"):
        aoti.compile(lambda x: (), [torch.ones(2)], device="cpu")

    def data_dependent(x):
        return x if float(x.sum()) > 0 else -x

    with pytest.raises(aoti.AotiError, match="export: .*data.dependent"):
        aoti.compile(data_dependent, [torch.ones(2)], device="cpu")


def test_echo_roundtrip_preserves_dtype_shape_and_bytes(add_exe):
    _, exe = add_exe
    args = _echo_add_args()
    a, b, c = args[2:]
    a += 0.5
    b[0, 0] = -(2 ** 50)
    assert exe.num_outputs == 4
    outs = exe.run(*args)[1:]
    assert len(outs) == 3
    for orig, got in zip((a, b, c), outs):
        assert got.dtype == orig.dtype and got.shape == orig.shape
        assert got.numpy().tobytes() == orig.numpy().tobytes()


def test_add_computes_through_the_binding(add_exe):
    _, exe = add_exe
    x = torch.linspace(-2, 2, 8).reshape(2, 4)
    y = torch.full((2, 4), 0.5)
    out = exe.run(x, y, *_echo_add_args()[2:])[0]
    assert torch.equal(out, x + y)
    out = exe.run(x, x, *_echo_add_args()[2:])[0]  # one tensor twice
    assert torch.equal(out, 2 * x)


def test_execute_arity_error(add_exe):
    _, exe = add_exe
    with pytest.raises(aoti.AotiError, match="takes 5 args, got 1"):
        exe.run(torch.ones(2, 4))


def test_executable_lifecycle(add_exe):
    """Outputs are tensors of their own (they outlive the executable);
    ``destroy`` is idempotent and a run after it raises."""
    compiled, _ = add_exe
    exe = aoti.Executable(compiled.path, "cpu")
    assert exe.device_type == "cpu"
    assert (exe.num_inputs, exe.num_outputs) == (5, 4)
    args = _echo_add_args()
    outs = exe.run(*args)
    exe.destroy()
    exe.destroy()  # idempotent
    assert torch.equal(outs[0], args[0] + args[1])
    assert torch.equal(outs[3], args[4])
    with pytest.raises(aoti.AotiError, match="destroyed"):
        exe.run(*args)


def test_artifact_is_a_torch_export_graph():
    """What the compiler is handed is a real ``torch.export`` program."""
    ep, spec = aoti.export(lambda x: {"y": x * 2.0}, [torch.ones(2, 2)])
    assert isinstance(ep, torch.export.ExportedProgram)
    assert "aten.mul" in ep.graph_module.code
    assert ep.graph_signature.user_outputs and spec.num_leaves == 1


def test_selftest_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "gofr_tpu_torch.native.aoti_selftest",
         "--device", "cpu"], capture_output=True, text=True, timeout=400,
        cwd=ROOT)
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert proc.returncode == 0 and result["ok"], (result, proc.stderr[-2000:])
    assert result["platform"] == "cpu" and result["num_outputs"] == 2
    assert result["mnist_program"]["kind"] == "pjrt_native"


# -- Engine(backend="pjrt") against JAX's jit engine ---------------------------

@pytest.fixture(scope="module")
def mnist():
    """JAX's MNIST MLP (hidden 64) at f32 with bf16-exact biases, the port's
    on the same weights behind a native engine, JAX's jit engine, and an
    input on the bf16 grid."""
    jm = jmnist_mlp(hidden=64, seed=3)
    rng = np.random.default_rng(3)
    tree = [{"w": np.asarray(layer["w"], np.float32),
             "b": _bf16_exact(rng.normal(size=layer["b"].shape) * 0.1)}
            for layer in jax.tree.map(np.asarray, jm.params)]
    x = _bf16_exact(rng.normal(size=(4, 784)))
    jeng = JEngine("mnist", jm.apply, jax.tree.map(jnp.asarray, tree),
                   example_inputs=(x,))
    tm = tmlp.mnist_mlp(64, params=tmlp.params_from_jax(tree, "cpu"))
    teng = Engine("mnist", tm.apply, tm.params, backend="pjrt", device="cpu",
                  example_inputs=(x,), config=EngineConfig(batch_buckets=(4,)))
    yield jeng, teng, tm, x
    jeng.close()
    teng.close()


def test_engine_mnist_matches_jax_jit_at_f32(mnist):
    jeng, teng, _, x = mnist
    got = teng.predict_sync(x)
    want = np.asarray(jeng.predict_sync(x))
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == (4, 10)
    assert _range_err(got, want) <= F32_TOL
    assert np.array_equal(got.argmax(1), want.argmax(1))


def test_engine_tiny_bert_matches_jax_jit_at_f32():
    jcfg = jbert.tiny_bert(dtype=jnp.float32)
    tcfg = tbert.tiny_bert(dtype=torch.float32)
    jparams = jbert.init_params(jcfg, jax.random.PRNGKey(5))
    tparams = tbert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, jcfg.vocab_size, (2, 16)).astype(np.int32)
    lens = np.array([16, 7], np.int32)
    jeng = JEngine("bert", lambda p, t, n: jbert.forward(
        p, t, jcfg, seq_lens=n)["mean"], jparams, example_inputs=(tokens, lens))
    teng = Engine("bert", tbert.Bert(tcfg, params=tparams).apply, tparams,
                  backend="pjrt", device="cpu", example_inputs=(tokens, lens))
    try:
        got = teng.predict_sync(tokens, lens)
        want = np.asarray(jeng.predict_sync(tokens, lens))
        assert got.shape == (2, tcfg.dim)
        assert _range_err(got, want) <= F32_TOL
        assert teng.programs.snapshot()[0]["kind"] == "pjrt_native"
    finally:
        jeng.close()
        teng.close()


def test_one_compile_per_signature_and_disk_hits(mnist, add_exe):
    """A repeat of a signature runs its executable; a fresh executor of the
    same function and shapes loads the package from disk, and so does a
    second process, neither compiling."""
    _, teng, tm, x = mnist
    stats = dict(teng._pjrt.stats)
    teng.predict_sync(x)
    teng.predict_sync(x + 1)
    assert teng._pjrt.stats == stats and stats["entries"] == 1
    fresh = Engine("mnist", tm.apply, tm.params, backend="pjrt",
                   device="cpu", example_inputs=(x,))
    try:
        (row,) = fresh.programs.snapshot()
        assert row["cache"] == "disk" and row["compile_s"] == 0.0
        assert fresh._pjrt.stats == {"compiles": 0, "compile_s": 0.0,
                                     "entries": 1}
        assert fresh.programs.totals()["cache_hits"] == 1
        assert np.array_equal(fresh.predict_sync(x), teng.predict_sync(x))
    finally:
        fresh.close()
    code = ("import torch\n"
            "from gofr_tpu_torch.native import aoti\n"
            "args = [torch.ones(2, 4), torch.full((2, 4), 2.0),"
            " torch.arange(12, dtype=torch.float32).reshape(3, 4),"
            " torch.tensor([[1, 2], [3, 2 ** 40]]),"
            " torch.tensor([255, 0, 7], dtype=torch.uint8)]\n"
            "c = aoti.compile(lambda x, y, *echo: (x + y, *echo), args,"
            " device='cpu')\n"
            "print(c.cached, c.path)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    cached, path = proc.stdout.split()
    assert cached == "True", proc.stderr[-2000:]
    assert Path(path).parent == aoti.PACKAGE_DIR


def test_program_rows_and_debug_programs_match_jax(mnist, add_exe):
    """Each executable is a ``pjrt/<shape>#n`` row of kind ``pjrt_native``,
    no ``apply/bN`` row is written, and ``/debug/programs`` carries the
    native stats under JAX's keys (JAX's executor on its fake plugin)."""
    from gofr_tpu.ml.pjrt_backend import PjrtExecutor as JPjrtExecutor
    from gofr_tpu.native import pjrt

    _, teng, _, _ = mnist
    rows = teng.programs.snapshot()
    assert [r["name"] for r in rows] == ["pjrt/4x784#1"]
    assert rows[0]["kind"] == "pjrt_native"
    assert rows[0]["shapes"] == {"inputs": [[4, 784]]}
    ds = MLDatasource()
    ds.register("mnist", teng)
    snap = ds.programs_snapshot()["models"]["mnist"]
    assert snap["pjrt"] == teng._pjrt.stats
    assert ds.serving_snapshot()["models"]["mnist"]["backend"] == "pjrt"
    plugin = pjrt.fake_plugin_path()
    if plugin is None:
        pytest.skip("no pjrt_c_api.h header for JAX's fake plugin")
    jexe = JPjrtExecutor(lambda p, x: x, {}, plugin_path=plugin)
    try:
        assert set(snap["pjrt"]) == set(jexe.stats)
    finally:
        jexe.close()


def test_device_step_span_names_the_native_backend(mnist):
    from gofr_tpu_torch.tracing import Tracer

    spans = []

    class Recording(Tracer):
        def _on_end(self, span):
            spans.append(span)

    _, _, tm, x = mnist
    engine = Engine("mnist", tm.apply, tm.params, backend="pjrt",
                    device="cpu", tracer=Recording())
    try:
        engine.predict_sync(x)
    finally:
        engine.close()
    assert spans[0].attributes == {"ml.model": "mnist", "ml.backend": "pjrt",
                                   "ml.batch": 4}


def test_run_releases_the_gil():
    """A second thread runs Python while a package is in flight. The
    interpreter's switch interval is set far out, so a runner that held
    the GIL through the native run would let the watcher in only after its
    ``returned`` event; a released GIL lets it in between ``entered`` and
    ``returned`` (the run's two products take far longer than a thread's
    wake-up)."""
    a, b = torch.randn(1536, 1536), torch.randn(1536, 1536)
    compiled = aoti.compile(lambda x, y: (x @ y) @ y, [a, b], device="cpu")
    exe = aoti.Executable(compiled.path, "cpu")
    entered, returned = threading.Event(), threading.Event()
    seen: dict = {}

    def runner():
        entered.set()
        seen["out"] = exe.run(a, b)
        returned.set()

    def watcher():
        if entered.wait(timeout=60):
            seen["during"] = not returned.is_set()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(60.0)
    try:
        w = threading.Thread(target=watcher)
        w.start()
        r = threading.Thread(target=runner)
        r.start()
        r.join(timeout=120)
        w.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
        exe.destroy()
    assert not r.is_alive() and not w.is_alive()
    assert returned.is_set()
    assert seen["during"], "the watcher ran only after the native run"
    assert seen["out"][0].shape == (1536, 1536)


def test_failed_build_raises_and_never_falls_back(mnist, monkeypatch,
                                                  tmp_path):
    """No compiler for the binding: the engine's first execute raises in the
    caller's future, naming the build; nothing runs on the jit path."""
    _, _, tm, x = mnist
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    engine = Engine("mnist", tm.apply, tm.params, backend="pjrt",
                    device="cpu")
    try:
        with pytest.raises(aoti.AotiError, match="did not build"):
            engine.predict_sync(x)
        assert engine.steps == 0 and not engine.graphs
        assert engine._pjrt.stats["entries"] == 0
    finally:
        engine.close()


def test_plugin_arguments_raise():
    from gofr_tpu_torch.ml.pjrt_backend import PjrtExecutor

    with pytest.raises(ValueError, match="no PJRT plugin"):
        Engine("m", lambda p, x: x, np.float32(1.0), backend="pjrt",
               plugin_path="libtpu.so", device="cpu")
    with pytest.raises(ValueError, match="no PJRT plugin"):
        PjrtExecutor(lambda p, x: x, {}, device="cpu",
                     client_options={"rank": 0})
