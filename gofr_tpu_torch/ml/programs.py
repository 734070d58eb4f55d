"""Program telemetry — counterpart of ``gofr_tpu/ml/programs.py``: the
inventory of a generator's device programs.

In the JAX package a program is one jitted executable and its row comes
with XLA's compile seconds, cache provenance and ``cost_analysis``. In the
port a program is one captured CUDA graph of a decode dispatch (a ladder
entry at a gather width, ``graphs.py``) or one prefill bucket (eager, its
first run at ``warmup``); on the CPU the decode shapes are eager too. A
row holds the shapes, the capture (or first-use) seconds, the graph pool
bytes the capture added (graphs only), and FLOPs and bytes from the
model's own count (``model_cost``) where JAX's rows take them from XLA.
A native engine's row (``backend="pjrt"``, ``ml/pjrt_backend.py``) is one
AOTInductor package, kind ``pjrt_native``; its ``cache`` reads ``"disk"``
when the package was loaded rather than compiled, and ``cache_hits``
counts those rows. Every other row's ``cache`` reads ``"none"``.

Aggregates export as ``app_ml_programs`` and
``app_ml_compile_seconds_total`` (the datasource's sampler publishes the
deltas); the rows are served at ``GET /debug/programs``. Stdlib only.
"""

from __future__ import annotations

import threading
import time

__all__ = ["ProgramLog", "model_cost"]


def model_cost(cfg, rows: int, steps: int, key_len: int,
               prefill: bool = False) -> dict:
    """FLOPs and bytes of ``steps`` decode steps over ``rows`` rows (or,
    with ``prefill``, one prefill of ``steps`` positions a row), counted
    from the model's shape: every weight matrix read once a step (once for
    a prefill) with 2 FLOPs a weight a position, and attention of each
    position over ``key_len`` keys, the key capacity the program covers
    (the live prefix is shorter and data dependent)."""
    d, f, L = cfg.dim, cfg.ffn_dim, cfg.n_layers
    kv = cfg.n_kv_heads * cfg.head_dim
    per_layer = d * d * 2 + d * kv * 2 + 3 * d * f  # wq, wo, wk, wv, mlp
    mat = L * per_layer + d * cfg.vocab_size         # + the lm head
    w_bytes = 1 if getattr(cfg, "w8", False) else (
        2 if str(cfg.dtype).endswith("bfloat16") else 4)
    kv_bytes = {16: w_bytes, 8: 1, 4: 0.5}[getattr(cfg, "kv_bits", 16)]
    positions = rows * steps
    flops = 2 * mat * positions + 4 * L * cfg.n_heads * cfg.head_dim \
        * key_len * positions
    nbytes = mat * w_bytes * (1 if prefill else steps) \
        + 2 * L * rows * key_len * kv * kv_bytes
    return {"flops": int(flops), "bytes_accessed": int(nbytes)}


class ProgramLog:
    """One generator's program inventory. ``record`` keeps the first row
    of a name (a later use only bumps ``warm_count``); ``snapshot`` and
    ``totals`` are safe from any thread."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: dict[str, dict] = {}
        self.compile_s_total = 0.0

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def record(self, name: str, *, wall_s: float, kind: str,
               shapes=None, cost: dict | None = None, **extra) -> None:
        """Add one program row: ``wall_s`` is the capture (or first-use)
        seconds, ``kind`` ``graph``, ``eager`` or ``prefill``."""
        with self._lock:
            row = self._entries.get(name)
            if row is not None:
                row["warm_count"] += 1
                return
            row = {"name": name, "kind": kind,
                   "wall_s": round(float(wall_s), 6), "cache": "none",
                   "warm_count": 1, "at": round(time.time(), 3)}
            if shapes is not None:
                row["shapes"] = shapes
            if cost is not None:
                row["cost"] = cost
            row.update(extra)
            self._entries[name] = row
            self.compile_s_total += float(wall_s)

    def snapshot(self, cost: bool = True) -> list[dict]:
        """JSON-safe rows, oldest first (``cost=False`` leaves out the
        model count)."""
        with self._lock:
            rows = [dict(r) for r in self._entries.values()]
        if not cost:
            for r in rows:
                r.pop("cost", None)
        return rows

    def totals(self) -> dict:
        with self._lock:
            return {"programs": len(self._entries),
                    "compile_s": round(self.compile_s_total, 6),
                    "backend_compile_s": 0.0,
                    "cache_hits": sum(r["cache"] == "disk"
                                      for r in self._entries.values())}
