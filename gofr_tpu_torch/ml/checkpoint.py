"""Checkpoints of trees of tensors — counterpart of
``gofr_tpu/ml/checkpoint.py``, with its surface: numbered steps under one
directory, the latest discoverable, ``max_to_keep`` rotation, and a restore
that resumes exactly (params, optimizer state, step counter).

The on-disk format is the port's own (orbax, which the JAX package writes
through, is not used). A step is ``<dir>/<step>/`` holding:

- ``leaves.safetensors``: every tensor leaf, named by its path in the tree
  (``params/layers/wq``), in the safetensors format (``ml.hf_import``
  writes and parses it; bf16, f32 and int leaves keep their dtype);
- ``tree.json``: ``{"format", "step", "tree"}``, the tree's skeleton: each
  node one of ``{"dict": {...}}``, ``{"list": [...]}``, ``{"tuple":
  [...]}``, ``{"tensor": <leaf name>}`` or ``{"value": <JSON value>}``
  (a Python number, string, bool or None).

A save writes both into a temporary directory beside the steps, syncs
them, and renames it into place, so a killed process never leaves a half
checkpoint as the latest. A restore maps and copies one leaf at a time to
its device, so the host never holds the tree. A directory the JAX package
wrote (orbax) is refused: reading it needs orbax and tensorstore; the
format both packages read is an HF directory (``ml.hf_import``).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any

import numpy as np
import torch

from .hf_import import _header, _mapped, _st_dtype, write_safetensors

__all__ = ["Checkpointer"]

_FORMAT = "gofr_tpu_torch.checkpoint/1"
_TREE = "tree.json"
_LEAVES = "leaves.safetensors"
# files orbax writes into a step directory
_ORBAX = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


def _flatten(tree: Any, path: str, tensors: dict) -> dict:
    """``tree`` -> its skeleton; tensor leaves go into ``tensors`` by path."""
    if isinstance(tree, dict):
        return {"dict": {str(k): _flatten(v, f"{path}/{k}", tensors)
                         for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        kind = "tuple" if isinstance(tree, tuple) else "list"
        return {kind: [_flatten(v, f"{path}/{i}", tensors)
                       for i, v in enumerate(tree)]}
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(tree)
    if isinstance(tree, torch.Tensor):
        name = path.lstrip("/") or "."
        tensors[name] = tree
        return {"tensor": name}
    if isinstance(tree, np.generic):
        tree = tree.item()
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"value": tree}
    raise TypeError(f"checkpoint leaf {path or '.'}: cannot store "
                    f"{type(tree).__name__}")


def _check(node: dict, like: Any, path: str, header: dict) -> None:
    """Raise ValueError unless the saved ``node`` has ``like``'s structure
    and its tensors (described by the leaves' ``header``) ``like``'s
    shapes."""
    (kind, val), = node.items()
    where = path or "."
    if kind == "dict":
        if not isinstance(like, dict) or set(map(str, like)) != set(val):
            raise ValueError(f"checkpoint {where}: saved keys {sorted(val)} "
                             "do not match the target's")
        for k, v in like.items():
            _check(val[str(k)], v, f"{path}/{k}", header)
    elif kind in ("list", "tuple"):
        if not isinstance(like, (list, tuple)) or len(like) != len(val):
            raise ValueError(f"checkpoint {where}: saved a {kind} of "
                             f"{len(val)}, the target differs")
        for i, (n, v) in enumerate(zip(val, like)):
            _check(n, v, f"{path}/{i}", header)
    elif kind == "tensor":
        if not isinstance(like, (torch.Tensor, np.ndarray)):
            raise ValueError(f"checkpoint {where}: saved a tensor, the "
                             f"target has {type(like).__name__}")
        if tuple(header[val]["shape"]) != tuple(like.shape):
            raise ValueError(f"checkpoint {where}: saved shape "
                             f"{tuple(header[val]['shape'])}, target "
                             f"{tuple(like.shape)}")


class Checkpointer:
    """Directory of numbered checkpoints: ``<dir>/<step>/``."""

    def __init__(self, directory: str, *, max_to_keep: int | None = 3,
                 logger=None) -> None:
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._logger = logger
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None
        for name in os.listdir(self.directory):
            step_dir = os.path.join(self.directory, name)
            if name.isdigit() and any(
                    os.path.exists(os.path.join(step_dir, f))
                    or os.path.exists(os.path.join(step_dir, "default", f))
                    for f in _ORBAX):
                raise ValueError(
                    f"{step_dir} is an orbax checkpoint (the JAX package's "
                    "format): reading it needs orbax and tensorstore, which "
                    "the port does not use. Export the weights as an HF "
                    "directory (config.json + *.safetensors), which both "
                    "packages read")

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    # -- save ------------------------------------------------------------------
    def save(self, step: int, tree: Any, *, wait: bool = True) -> None:
        """Atomically persist ``tree`` at ``step``. ``wait=False`` copies the
        tensors to the host and writes them on a background thread
        (``wait_until_finished`` joins it; the next save, restore and
        ``close`` do too)."""
        self.wait_until_finished()
        step = int(step)
        if os.path.exists(self._step_dir(step)):
            raise FileExistsError(f"checkpoint step {step} already exists "
                                  f"under {self.directory}")
        tensors: dict[str, torch.Tensor] = {}
        skeleton = _flatten(tree, "", tensors)
        if wait:
            self._write(step, skeleton, tensors)
            return
        host = {k: t.detach().to("cpu", copy=True) for k, t in tensors.items()}

        def write() -> None:
            try:
                self._write(step, skeleton, host)
            except BaseException as exc:  # re-raised by wait_until_finished
                self._error = exc

        self._writer = threading.Thread(target=write, daemon=True,
                                        name=f"gofr-checkpoint-{step}")
        self._writer.start()

    def _write(self, step: int, skeleton: dict, tensors: dict) -> None:
        tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=self.directory)
        try:
            write_safetensors(os.path.join(tmp, _LEAVES), tensors)
            with open(os.path.join(tmp, _TREE), "w") as f:
                json.dump({"format": _FORMAT, "step": step,
                           "tree": skeleton}, f)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, self._step_dir(step))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        fd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(fd)  # the rename itself survives a crash
        finally:
            os.close(fd)
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        if self._logger is not None:
            self._logger.infof("checkpoint %d saved to %s", step,
                               self.directory)

    def wait_until_finished(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    # -- steps -----------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(
                          os.path.join(self.directory, n, _TREE)))

    def latest_step(self) -> int | None:
        self.wait_until_finished()
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- restore ---------------------------------------------------------------
    def _skeleton(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), _TREE)) as f:
            return json.load(f)["tree"]

    def saved_keys(self, step: int | None = None) -> list[str] | None:
        """The top-level keys of the tree saved at ``step`` (default: the
        latest), None when that tree is not a dict."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        node = self._skeleton(step)
        return list(node["dict"]) if "dict" in node else None

    def restore(self, step: int | None = None, *, like: Any = None,
                device=None, item: str | None = None, mesh=None,
                specs: Any = None) -> Any:
        """The tree saved at ``step`` (default: the latest).

        ``like`` gives the target structure and dtypes (meta tensors are
        fine): the saved tree must match it (else ValueError), and each
        tensor is cast to its ``like`` leaf's dtype. Tensors land on
        ``device`` when given, else on their ``like`` leaf's device, else on
        the first CUDA card (``device="cpu"`` for the host). ``item`` reads
        one entry of a saved dict alone (a training state's ``"params"``).
        ``mesh``/``specs`` (a sharded restore) raise: not ported yet
        (ROADMAP A.11)."""
        from .. import resolve_device

        if mesh is not None or specs is not None:
            raise NotImplementedError(
                "a sharded restore (mesh=, specs=) is not ported yet "
                "(ROADMAP A.11)")
        if step is None:
            step = self.latest_step()
        else:
            self.wait_until_finished()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        step_dir = self._step_dir(step)
        node = self._skeleton(step)
        if item is not None:
            if "dict" not in node or item not in node["dict"]:
                raise ValueError(f"checkpoint step {step} holds no entry "
                                 f"{item!r}")
            node = node["dict"][item]
        leaves = os.path.join(step_dir, _LEAVES)
        header, start = _header(leaves)
        if like is not None:
            _check(node, like, "", header)
        fixed = None if device is None else resolve_device(device)

        def build(node: dict, like: Any) -> Any:
            (kind, val), = node.items()
            if kind == "dict":
                return {k: build(v, None if like is None else like[k])
                        for k, v in val.items()}
            if kind in ("list", "tuple"):
                out = [build(n, None if like is None else like[i])
                       for i, n in enumerate(val)]
                return tuple(out) if kind == "tuple" else out
            if kind == "value":
                return val
            meta = header[val]
            dev = fixed
            if dev is None and isinstance(like, torch.Tensor) \
                    and like.device.type != "meta":
                dev = like.device
            if dev is None:
                dev = resolve_device(None)
            if isinstance(like, torch.Tensor):
                dtype = like.dtype
            elif isinstance(like, np.ndarray):
                dtype = torch.from_numpy(like[:0]).dtype
            else:
                dtype = _st_dtype(meta["dtype"])
            dst = torch.empty(meta["shape"], dtype=dtype, device=dev)
            with _mapped(leaves, start, meta) as t:
                src = t.to(dev)
                dst.copy_(src)
                del src, t
            return dst

        return build(node, like)

    def close(self) -> None:
        self.wait_until_finished()
