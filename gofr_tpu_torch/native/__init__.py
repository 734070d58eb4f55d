"""Native (C++) pieces of the port, built on first use — counterpart of
``gofr_tpu/native/__init__.py``.

- ``bpe.cpp``: the byte-level BPE tokenizer (a copy of JAX's), a plain C
  interface loaded with ``ctypes`` by ``gofr_tpu_torch/tokenizer.py``.
- ``aoti_shim.cpp``: the native executor's binding, a Python extension
  over PyTorch's C++ API that holds AOTInductor model packages
  (``native/aoti.py``).

Each builds with one ``g++`` into ``build/gofr_tpu_torch/native/`` at the
root of the checkout (listed in ``.gitignore``), keyed by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
loads as it is. ``start_builds`` launches every missing build at once and
returns without waiting; a later load waits for its own. A failed build
raises ``BuildError`` with the compiler's stderr: the tokenizer then keeps
its Python path, as JAX's does; the executor raises.

The executor's Inductor compiles cache under ``build/gofr_tpu_torch/
inductor/`` (``TORCHINDUCTOR_CACHE_DIR``, unless the caller set it), so a
run writes nothing outside ignored paths. ``inductor_cxx`` picks the C++
compiler Inductor links packages with: one that has OpenMP.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "BuildError", "INDUCTOR_CACHE", "inductor_cxx",
           "load_extension", "load_library", "start_builds",
           "use_build_cache"]

SRC = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gofr_tpu_torch" \
    / "native"
INDUCTOR_CACHE = BUILD_DIR.parent / "inductor"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_running: dict[Path, subprocess.Popen] = {}
_loaded: dict[Path, object] = {}


class BuildError(RuntimeError):
    """A native source that did not compile (or no compiler)."""


def _torch_flags(name: str) -> list[str]:
    """What a PyTorch extension compiles and links with: torch's headers and
    libraries, the interpreter's headers, torch's C++ and pybind11 ABI."""
    import warnings

    import torch
    from torch.utils import cpp_extension

    with warnings.catch_warnings():  # deprecated where pybind11 handles it
        warnings.simplefilter("ignore", DeprecationWarning)
        abi = getattr(cpp_extension, "_get_pybind11_abi_build_flags",
                      list)()
    flags = [f"-DTORCH_EXTENSION_NAME={name}",
             "-DTORCH_API_INCLUDE_EXTENSION_H",
             f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
             *abi, "-I" + sysconfig.get_paths()["include"]]
    flags += ["-I" + p for p in cpp_extension.include_paths()]
    for lib in cpp_extension.library_paths():
        flags += ["-L" + lib, "-Wl,-rpath," + lib]
    return flags + ["-lc10", "-ltorch", "-ltorch_cpu", "-ltorch_python"]


def _target(source: str, stem: str, flags: tuple) -> Path:
    digest = hashlib.sha256((SRC / source).read_bytes())
    digest.update("\0".join((*CXX_FLAGS, *flags)).encode())
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"


def _start(source: str, stem: str, flags: tuple) -> Path:
    """Start the build of ``source`` unless its library exists or is being
    built; the caller holds ``_lock``."""
    out = _target(source, stem, flags)
    if out.exists() or out in _running:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SRC / source),
           "-o", str(tmp), *flags]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    except OSError as exc:
        raise BuildError(f"{source}: cannot run {cmd[0]} ({exc})") from exc
    proc.tmp = tmp  # type: ignore[attr-defined]
    _running[out] = proc
    return out


def _wait(source: str, out: Path) -> None:
    """Wait for the build of ``out`` (if one runs) and publish it."""
    proc = _running.get(out)
    if proc is None:
        return
    _, err = proc.communicate()
    del _running[out]
    if proc.returncode != 0:
        proc.tmp.unlink(missing_ok=True)
        raise BuildError(f"{source} (exit {proc.returncode}):\n{err}")
    os.replace(proc.tmp, out)


def _extension_spec(name: str) -> tuple:
    return ("aoti_shim.cpp", name, tuple(_torch_flags(name)))


def start_builds() -> None:
    """Start every missing native build, all at once, and return: a script
    calls it first so that the compiles run beside its other set-up."""
    with _lock:
        _start("bpe.cpp", "libgofrbpe", ())
        _start(*_extension_spec("gofr_aoti_shim"))


def load_library(source: str, stem: str) -> ctypes.CDLL:
    """``source`` built as a plain shared library and loaded with ctypes."""
    with _lock:
        out = _start(source, stem, ())
        lib = _loaded.get(out)
        if lib is None:
            _wait(source, out)
            lib = _loaded[out] = ctypes.CDLL(str(out))
        return lib


def load_extension():
    """The executor's binding (``aoti_shim.cpp``) built as the Python
    extension module ``gofr_aoti_shim`` and imported."""
    name = "gofr_aoti_shim"
    with _lock:
        spec_args = _extension_spec(name)
        out = _start(*spec_args)
        mod = _loaded.get(out)
        if mod is None:
            _wait(spec_args[0], out)
            import torch  # noqa: F401 - the extension links against it

            loader = importlib.machinery.ExtensionFileLoader(name, str(out))
            spec = importlib.util.spec_from_file_location(name, str(out),
                                                          loader=loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            sys.modules.setdefault(name, mod)
            _loaded[out] = mod
        return mod


def use_build_cache() -> None:
    """Point Inductor's cache (and with it Triton's) under ``build/`` unless
    the caller chose a directory: an unset ``TORCHINDUCTOR_CACHE_DIR``, or
    the temporary one Inductor sets itself once any of its code has asked
    for it."""
    from torch._inductor.runtime.cache_dir_utils import default_cache_dir

    current = os.environ.get("TORCHINDUCTOR_CACHE_DIR")
    if current is None or os.path.abspath(current) == os.path.abspath(
            default_cache_dir()):
        os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(INDUCTOR_CACHE)


@functools.cache
def inductor_cxx() -> str | None:
    """The C++ compiler to give Inductor: the first of ``$CXX`` and ``g++``
    on ``PATH`` that links OpenMP (AOTInductor links every package with
    ``-fopenmp``: a toolchain without ``libgomp.spec`` cannot, and a
    package linked without it crashes the loader). None (Inductor's own
    choice, and its error) where neither does."""
    seen = set()
    for name in (os.environ.get("CXX"), "g++"):
        path = shutil.which(name) if name else None
        if path is None or path in seen:
            continue
        seen.add(path)
        spec = subprocess.run([path, "-print-file-name=libgomp.spec"],
                              capture_output=True, text=True).stdout.strip()
        if os.path.isabs(spec) and os.path.exists(spec):
            return path
    return None
