"""Selftest of the native executor — counterpart of
``gofr_tpu/native/pjrt_selftest.py``.

    python -m gofr_tpu_torch.native.aoti_selftest [--device cpu]

Takes JAX's selftest function, ``tanh(x @ y) + 1, (2 x).sum(1)``, on the
same seeded inputs (x [8, 16], y [16, 4], normal, numpy seed 0), and drives
the native executor on the device (the first card unless ``--device``
names another): export and AOT compile (or the package from the disk
cache), load through the port's C++ binding, execute, host copy, each
timed; the outputs against the eager function on the same device. Then, as
JAX's does, ``Engine(backend="pjrt")`` against ``Engine(backend="jit")`` on
the MNIST MLP behind config #2 (hidden 128, batch 8, bf16 weights). Prints
one JSON line; exits 0 when every check holds.
"""

from __future__ import annotations

import json
import sys
import time

# JAX's selftest holds its outputs within this (atol and rtol), and the
# MNIST engines within it too (bf16 weights)
TOL = 2e-2


def reference(device):
    """JAX's function, its inputs on ``device`` and its eager outputs."""
    import numpy as np
    import torch

    def f(x, y):
        return torch.tanh(x @ y) + 1.0, (x * 2.0).sum(dim=1)

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))
    x, y = x.to(device), y.to(device)
    return f, [x, y], [o.cpu() for o in f(x, y)]


def mnist_engine_parity(device) -> dict:
    """``Engine(backend="pjrt")`` against ``Engine(backend="jit")`` on the
    MNIST MLP, the model behind config #2's ``POST /predict``."""
    import numpy as np

    from ..ml.engine import Engine
    from ..models.mlp import mnist_mlp

    model = mnist_mlp(hidden=128, device=device)
    x = np.random.default_rng(1).normal(size=(8, 784)).astype(np.float32)
    native = Engine("mnist-native", model.apply, model.params,
                    backend="pjrt", example_inputs=(x,), device=device)
    jit = Engine("mnist-jit", model.apply, model.params,
                 example_inputs=(x,), device=device)
    try:
        got = native.predict_sync(x)
        want = jit.predict_sync(x)
        err = float(np.abs(got - want).max())
        return {"mnist_parity_ok": bool(np.allclose(got, want, atol=TOL,
                                                    rtol=TOL)),
                "mnist_max_abs_err": err,
                "engine_platform": native._pjrt.platform_name,
                "mnist_program": native.programs.snapshot()[0]}
    finally:
        native.close()
        jit.close()


def run(device) -> dict:
    """The selftest on ``device``: the result ``main`` prints."""
    import torch

    from . import aoti

    f, inputs, expected = reference(device)
    compiled = aoti.compile(f, inputs, device=device)
    t0 = time.perf_counter()
    exe = aoti.Executable(compiled.path, device)
    load_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        outs = exe.run(*inputs)
        host = [o.cpu() for o in outs]  # waits for the device
        run_ms = (time.perf_counter() - t0) * 1e3
        ok = len(host) == len(expected) and all(
            torch.allclose(o, e, atol=TOL, rtol=TOL)
            for o, e in zip(host, expected))
        result = {
            "ok": bool(ok),
            "device": str(device),
            "platform": exe.device_type,
            "num_inputs": exe.num_inputs,
            "num_outputs": exe.num_outputs,
            "max_abs_err": max(float((o - e).abs().max())
                               for o, e in zip(host, expected))
            if len(host) == len(expected) else None,
            "export_s": compiled.export_s,
            "compile_s": compiled.compile_s,
            "cached": compiled.cached,
            "load_s": load_s,
            "run_ms": run_ms,
        }
        if device.type == "cuda":
            result["card"] = torch.cuda.get_device_name(device)
    finally:
        exe.destroy()
    try:
        result.update(mnist_engine_parity(device))
        result["ok"] = bool(result["ok"] and result["mnist_parity_ok"])
    except Exception as exc:  # noqa: BLE001 - a selftest reports, not raises
        result["ok"] = False
        result["mnist_parity_error"] = f"{type(exc).__name__}: {exc}"
    return result


def main(argv: list[str]) -> int:
    from .. import resolve_device

    device = resolve_device(argv[argv.index("--device") + 1]
                            if "--device" in argv else None)
    result = run(device)
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
