"""Device-mesh parallelism — counterpart of ``gofr_tpu/parallel/__init__.py``.

JAX's mesh is GSPMD's: arrays carry shardings and XLA inserts the
collectives. The port's mesh is a single controller's: a numpy grid of
``torch.device`` under the same six named axes, and a module that shards
does so explicitly, one tensor a shard on that shard's device. The
collectives below work on such lists of shard tensors: ``ppermute`` is a
``.to(next device)``, ``psum`` / ``pmax`` a gather to the first shard's
device and a reduce, ``all_to_all`` a chunk and a concatenate.

What differs from JAX, and why:

- a mesh may name the same device more than once (``make_mesh(cfg,
  devices=[cuda:0] * 4)``). JAX's tests split one CPU into 8 virtual
  devices; here four shards on one card run the sharded algorithms (the
  ring rotation, the online-softmax merge across shards, the Ulysses
  reshard, the striped page pool, the decode combine) with the same code
  that spreads over several cards with peer-to-peer copies;
- GSPMD's automatic placement is explicit here. ``shard_params`` places
  a leaf whose spec names a ``tp``, ``ep`` or ``dp`` axis of size > 1 as
  a ``ShardedTensor``: the dimension split into equal contiguous blocks,
  block i on the i-th device along that axis (a second sharded dimension,
  MoE's ``P("ep", None, "tp")``, splits each block again along its own
  axis); every other leaf goes to the mesh's first device, replicated
  there. The modules that run such weights (``models.llama``,
  ``models.moe``, ``models.bert``, ``models.diffusion``) compute each
  shard's block on its device and combine with ``psum`` after a
  row-parallel product and ``all_gather`` after a vocabulary-split one.
  An ``fsdp`` axis of size > 1 raises naming ROADMAP A.11 (sharded
  training is the rest of that item); ``parallel.ring``,
  ``parallel.ulysses``, ``parallel.pipeline`` and the sequence-parallel
  serving path shard activations and state by hand;
- ``constrain`` checks a spec against the ambient mesh (``with mesh:``)
  and returns its input: an unknown axis or a dimension the axis does not
  divide raises, as JAX's promises; outside a mesh it does nothing;
- ``init_distributed`` brings up ``torch.distributed`` (the role
  ``jax.distributed.initialize`` plays) and does nothing in one process.

``ShardedTensor`` is the sharded state the serving path keeps: a logical
tensor split along one axis into equal blocks, block i on shard i's
device. ``row_write``, ``row_read``, ``set_at_pos``, ``pool_put`` and
``pool_take`` are the cache's accesses: each takes a plain tensor or a
``ShardedTensor`` split along its sequence or page axis (sequence
parallelism), and routes every position or page of the latter to the
shard that owns it, so the owner arithmetic lives here alone. A cache
split along its KV-head axis (tensor parallelism) is read and written a
shard at a time by the model (``ShardedTensor.shards``); its whole-page
copies (``index_select`` / ``index_copy_`` along the page axis: the host
tier, the KV transport) gather or scatter every shard's heads.
"""

from __future__ import annotations

import re
import threading
from typing import Any, Sequence

import numpy as np
import torch

__all__ = [
    "P",
    "AXES",
    "Mesh",
    "MeshConfig",
    "make_mesh",
    "mesh_shape_for",
    "visible_devices",
    "shard_params",
    "shards_of",
    "constrain",
    "specs_from_rules",
    "init_distributed",
    "pad_to_multiple",
    "ShardedTensor",
    "owner",
    "row_write",
    "row_read",
    "set_at_pos",
    "pool_put",
    "pool_take",
    "shard",
    "unshard",
    "ppermute",
    "psum",
    "pmax",
    "all_to_all",
    "all_gather",
]

AXES = ("dp", "fsdp", "pp", "ep", "tp", "sp")


class P(tuple):
    """A partition spec: one entry a dimension, each an axis name, a tuple
    of axis names, or None (that dimension replicated). ``P()``
    replicates the whole tensor. Equal to another spec of the same
    entries, as ``jax.sharding.PartitionSpec`` is."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


class MeshConfig:
    """Mesh axis sizes for the canonical 6-axis mesh: data, fully-sharded
    data, pipeline, expert, tensor and sequence parallelism. Size-1 axes
    cost nothing, so every program shares one spec vocabulary."""

    def __init__(self, dp: int = 1, fsdp: int = 1, tp: int = 1, sp: int = 1,
                 pp: int = 1, ep: int = 1) -> None:
        self.dp, self.fsdp, self.pp, self.ep = dp, fsdp, pp, ep
        self.tp, self.sp = tp, sp

    def sizes(self) -> tuple[int, int, int, int, int, int]:
        return (self.dp, self.fsdp, self.pp, self.ep, self.tp, self.sp)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"MeshConfig(dp={self.dp}, fsdp={self.fsdp}, pp={self.pp}, "
                f"ep={self.ep}, tp={self.tp}, sp={self.sp})")


def mesh_shape_for(n_devices: int, *, tp: int | None = None, sp: int = 1,
                   fsdp: int = 1, pp: int = 1, ep: int = 1) -> MeshConfig:
    """Default layout: TP takes as many devices as divide evenly (it needs
    the fastest links), the other axes as requested, DP the rest."""
    fixed = sp * fsdp * pp * ep
    if tp is None:
        tp = 1
        for cand in (8, 4, 2):
            if n_devices % (cand * fixed) == 0:
                tp = cand
                break
    dp = n_devices // (tp * fixed)
    if dp * tp * fixed != n_devices:
        raise ValueError(
            f"mesh dp={dp} fsdp={fsdp} pp={pp} ep={ep} tp={tp} sp={sp} "
            f"does not cover {n_devices} devices")
    return MeshConfig(dp=dp, fsdp=fsdp, pp=pp, ep=ep, tp=tp, sp=sp)


_AMBIENT = threading.local()


class Mesh:
    """A grid of ``torch.device`` under ``AXES``: ``devices`` is the numpy
    object array, ``shape[axis]`` an axis's size. ``with mesh:`` makes it
    the ambient mesh ``constrain`` checks against (per thread)."""

    def __init__(self, devices: np.ndarray, axis_names=AXES) -> None:
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape, strict=True))

    @property
    def empty(self) -> bool:
        return self.devices.size == 0

    @property
    def first(self) -> torch.device:
        """The device of the mesh's first position: where replicated
        weights and activations live."""
        return self.devices.flat[0]

    def axis_devices(self, axis: str, **at) -> list:
        """The devices along ``axis`` at position 0 of every other axis (or
        at ``at[name]``), in axis order: shard i of a tensor sharded over
        ``axis`` lives on the i-th."""
        idx = [at.get(name, 0) for name in self.axis_names]
        idx[self.axis_names.index(axis)] = slice(None)
        return list(self.devices[tuple(idx)])

    def __enter__(self) -> "Mesh":
        stack = getattr(_AMBIENT, "stack", None)
        if stack is None:
            stack = _AMBIENT.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _AMBIENT.stack.pop()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Mesh({self.shape}, first={self.first})"


def visible_devices() -> list:
    """Every visible CUDA card, in index order; empty without one."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(config: MeshConfig | None = None, *,
              devices: Sequence | None = None) -> Mesh:
    """The canonical mesh over ``devices`` (default: every visible card;
    without a card the caller names the CPU: ``devices=[torch.device(
    "cpu")] * n``). A device may repeat: its positions then share it.
    Axis order is (dp, fsdp, pp, ep, tp, sp), outermost to innermost."""
    if devices is None:
        devs = visible_devices()
        if not devs:
            raise RuntimeError(
                "no CUDA device: pass devices=[torch.device('cpu')] * n to "
                "build a mesh on the host")
    else:
        devs = [torch.device(d) for d in devices]
        devs = [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d for d in devs]
    if config is None:
        config = mesh_shape_for(len(devs))
    sizes = config.sizes()
    total = int(np.prod(sizes))
    if total != len(devs):
        raise ValueError(f"mesh sizes {sizes} != {len(devs)} devices")
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(sizes), AXES)


def init_distributed(config=None) -> None:
    """Multi-process bring-up over ``torch.distributed`` (the role
    ``jax.distributed.initialize`` plays): reads the coordinator address
    (``host:port``), the process count and this process's id from
    ``config`` (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``, the JAX package's keys) and does nothing when no
    address is set or the group is up already. NCCL on a card, gloo on
    the host."""
    if config is None:
        return
    coord = config.get("JAX_COORDINATOR_ADDRESS")
    if not coord:
        return
    import torch.distributed as dist

    if dist.is_initialized():
        return
    num_procs = config.get("JAX_NUM_PROCESSES")
    proc_id = config.get("JAX_PROCESS_ID")
    dist.init_process_group(
        "nccl" if torch.cuda.is_available() else "gloo",
        init_method=f"tcp://{coord}",
        world_size=int(num_procs) if num_procs else 1,
        rank=int(proc_id) if proc_id is not None else 0)


# ---------------------------------------------------------------------------
# Sharding rules: map tree paths -> P by regex, first match wins
# ---------------------------------------------------------------------------

def specs_from_rules(params: Any, rules: Sequence[tuple[str, P]]) -> Any:
    """A tree of ``P`` shaped like ``params``: the first regex (searched
    against the 'a/b/c'-joined tree path) wins; unmatched leaves
    replicate (``P()``)."""

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, (*path, str(k))) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, (*path, str(i)))
                              for i, v in enumerate(tree))
        s = "/".join(path)
        for pat, spec in rules:
            if re.search(pat, s):
                return spec
        return P()

    return walk(params, ())


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _split_dims(leaf, spec, mesh: Mesh) -> list:
    """The (dimension, axis) pairs a leaf splits along: every axis of
    ``spec`` whose size on ``mesh`` is > 1. ``fsdp`` raises naming ROADMAP
    A.11; a dimension the axis does not divide raises ``ValueError``, as
    GSPMD refuses such a sharding."""
    out = []
    for dim, entry in enumerate(spec):
        axes = [ax for ax in _axes_of(entry) if mesh.shape.get(ax, 1) > 1]
        if not axes:
            continue
        if "fsdp" in axes:
            raise NotImplementedError(
                f"shard_params: placing a weight over the mesh axis 'fsdp' "
                f"of size {mesh.shape['fsdp']} (sharded training) is not "
                f"ported yet (ROADMAP A.11)")
        if len(axes) > 1:
            raise NotImplementedError(
                f"shard_params: dimension {dim} over the axes {axes} at "
                f"once is not ported (one mesh axis a dimension)")
        if dim >= leaf.dim():
            raise ValueError(f"shard_params: spec {spec!r} has more entries "
                             f"than the rank {leaf.dim()} of the leaf")
        n = mesh.shape[axes[0]]
        if leaf.shape[dim] % n:
            raise ValueError(
                f"shard_params: dimension {dim} of size {leaf.shape[dim]} "
                f"does not divide over {axes[0]!r} of size {n}")
        out.append((dim, axes[0]))
    return out


def shard_params(params: Any, specs: Any, mesh: Mesh) -> Any:
    """Place a parameter tree on the mesh per its spec tree, as JAX's
    ``device_put`` with ``NamedSharding``s does. A leaf whose spec names an
    axis of size > 1 becomes a ``ShardedTensor``: block i of that
    dimension on the i-th device along the axis (the other axes at their
    first position); a second such dimension splits each block again, a
    ``ShardedTensor`` of ``ShardedTensor``s. Blocks on a leaf's own device
    are views of it (nothing is copied). Every other leaf goes to the
    mesh's first device. ``fsdp`` > 1 raises naming ROADMAP A.11."""

    def split(leaf, dims, fixed):
        (dim, ax), rest = dims[0], dims[1:]
        devs = mesh.axis_devices(ax, **fixed)
        blocks = leaf.chunk(len(devs), dim=dim)
        if rest:
            return ShardedTensor([split(b, rest, {**fixed, ax: i})
                                  for i, b in enumerate(blocks)], dim)
        return ShardedTensor([b.to(d) for b, d in zip(blocks, devs,
                                                       strict=True)], dim)

    def place(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        dims = _split_dims(leaf, spec, mesh)
        return split(leaf, dims, {}) if dims else leaf.to(mesh.first)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)) and not isinstance(spec, P):
            return type(tree)(walk(v, s) for v, s in zip(tree, spec,
                                                         strict=True))
        return place(tree, spec)

    return walk(params, specs)


def shards_of(w) -> list:
    """A weight's blocks in shard order: a ``ShardedTensor``'s shards, or
    a plain tensor whole, the one block of an unsplit weight (so a model
    runs one layer body over split and unsplit params alike)."""
    return list(w.shards) if isinstance(w, ShardedTensor) else [w]


def _ambient_mesh() -> Mesh | None:
    stack = getattr(_AMBIENT, "stack", None)
    return stack[-1] if stack else None


def constrain(x: Any, spec: P) -> Any:
    """Check ``spec`` against the ambient mesh and return ``x``: a no-op
    outside a mesh (single-device paths); inside one, an axis the mesh has
    not, a spec longer than ``x``'s rank or a dimension the axes' size
    does not divide raises, as JAX's ``with_sharding_constraint`` would.
    The port places nothing here: a module that shards does it itself."""
    mesh = _ambient_mesh()
    if mesh is None or mesh.empty:
        return x
    if len(spec) > x.dim():
        raise ValueError(f"constrain: spec {spec!r} has more entries than "
                         f"the rank {x.dim()} of the tensor")
    for dim, entry in enumerate(spec):
        size = 1
        for ax in _axes_of(entry):
            if ax not in mesh.shape:
                raise ValueError(f"constrain: unknown mesh axis {ax!r} in "
                                 f"{spec!r} (axes {mesh.axis_names})")
            size *= mesh.shape[ax]
        if x.shape[dim] % size:
            raise ValueError(
                f"constrain: dimension {dim} of size {x.shape[dim]} does "
                f"not divide over {entry!r} of size {size}")
    return x


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Sharded tensors and the collectives over per-shard lists
# ---------------------------------------------------------------------------

class ShardedTensor:
    """A logical tensor split along ``axis`` into one block of ``block``
    entries a shard, block i on shard i's device (``shards[i]``). A shard
    may carry trailing entries of its own past its block (the striped
    page pool's dump page): they are no part of the logical tensor.
    ``shape``, ``numel`` and ``element_size`` describe the logical tensor,
    so size accounting reads it as a plain one; ``index_select`` and
    ``index_copy_`` along ``axis`` route each index to its owner."""

    def __init__(self, shards: Sequence[torch.Tensor], axis: int,
                 block: int | None = None) -> None:
        self.shards = list(shards)
        self.axis = axis
        self.block = int(block if block is not None
                         else self.shards[0].shape[axis])

    @property
    def n(self) -> int:
        return len(self.shards)

    @property
    def shape(self) -> torch.Size:
        s = list(self.shards[0].shape)
        s[self.axis] = self.block * self.n
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def dim(self) -> int:
        return self.shards[0].dim()

    def numel(self) -> int:
        return int(np.prod(self.shape))

    def element_size(self) -> int:
        return self.shards[0].element_size()

    @classmethod
    def of(cls, x, devices: Sequence, axis: int) -> "ShardedTensor":
        """``x`` as it is when it is split already, else split here along
        ``axis`` over ``devices``."""
        if isinstance(x, cls):
            return x
        return cls(shard(x, devices, axis), axis)

    def block_of(self, d: int) -> torch.Tensor:
        """Shard ``d``'s block (its entries past the block left out)."""
        return self.shards[d].narrow(self.axis, 0, self.block)

    def blocks(self):
        """(shard index, its device, its block) in shard order."""
        for d, sh in enumerate(self.shards):
            yield d, sh.device, self.block_of(d)

    def owner(self, g: int) -> int:
        """The shard that owns global index ``g`` along ``axis``."""
        return int(g) // self.block

    def positions(self, d: int) -> torch.Tensor:
        """The global indices of shard ``d``'s block, on its device."""
        return d * self.block + torch.arange(self.block,
                                             device=self.shards[d].device)

    def local(self, d: int, index: torch.Tensor):
        """Shard ``d``'s view of the global indices ``index`` (a tensor),
        on its device: (the local indices, clamped into its block; whether
        the shard owns each)."""
        lo = d * self.block
        i = index.to(self.shards[d].device)
        own = (i >= lo) & (i < lo + self.block)
        return (i - lo).clamp(0, self.block - 1), own

    def full(self, device=None) -> torch.Tensor:
        """The logical tensor, concatenated on ``device`` (default: the
        first shard's)."""
        device = device or self.device
        return torch.cat([b.to(device) for _, _, b in self.blocks()],
                         dim=self.axis)

    def _route(self, index) -> dict:
        """Positions of ``index`` (global, along ``axis``) grouped by owner:
        {shard: (positions in ``index``, local indices)}."""
        idx = (index.tolist() if isinstance(index, torch.Tensor)
               else [int(i) for i in index])
        out: dict = {}
        for pos, g in enumerate(idx):
            d, local = divmod(int(g), self.block)
            out.setdefault(d, ([], []))
            out[d][0].append(pos)
            out[d][1].append(local)
        return out

    def index_select(self, dim: int, index) -> torch.Tensor:
        """``index_select`` of the logical tensor, on the first shard's
        device: along the sharded axis each index comes from its owner, in
        ``index`` order; along another axis every shard selects from its
        block and the blocks concatenate along the sharded axis."""
        if dim != self.axis:
            return torch.cat(
                [b.index_select(dim, torch.as_tensor(index, device=dev))
                 .to(self.device) for _, dev, b in self.blocks()],
                dim=self.axis)
        n_idx = len(index)
        shape = list(self.shape)
        shape[dim] = n_idx
        out = torch.empty(shape, dtype=self.dtype, device=self.device)
        for d, (pos, local) in self._route(index).items():
            sh = self.shards[d]
            got = sh.index_select(dim, torch.as_tensor(local,
                                                       device=sh.device))
            out.index_copy_(dim, torch.as_tensor(pos, device=self.device),
                            got.to(self.device))
        return out

    def index_copy_(self, dim: int, index, source: torch.Tensor
                    ) -> "ShardedTensor":
        """``index_copy_`` of the logical tensor: along the sharded axis
        each entry of ``source`` lands on its owner; along another axis
        every shard takes its block of ``source`` (along the sharded
        axis)."""
        if dim != self.axis:
            for d, dev, b in self.blocks():
                b.index_copy_(dim, torch.as_tensor(index, device=dev),
                              source.narrow(self.axis, d * self.block,
                                            self.block).to(dev))
            return self
        for d, (pos, local) in self._route(index).items():
            sh = self.shards[d]
            part = source.index_select(
                dim, torch.as_tensor(pos, device=source.device))
            sh.index_copy_(dim, torch.as_tensor(local, device=sh.device),
                           part.to(sh.device))
        return self

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"ShardedTensor(shape={tuple(self.shape)}, axis={self.axis}, "
                f"n={self.n}, dtype={self.dtype})")


# The cache layout: one call a cache access, on a plain tensor or on a
# ShardedTensor, whose entries each go to (or come from) their owner.

def owner(arr, g: int) -> int:
    """The shard that owns global index ``g`` along ``arr``'s split axis:
    0 for a plain tensor."""
    return arr.owner(g) if isinstance(arr, ShardedTensor) else 0


def row_write(arr, layer: int, slot: int, axis: int, start: int, new,
              zero_to: int | None = None) -> None:
    """Write ``new`` into row ``arr[layer, slot]`` at positions
    ``start ..`` along the row's sequence axis ``axis`` (in place), then
    zero the positions after it up to ``zero_to``."""
    n = new.shape[axis]
    end = start + n
    if not isinstance(arr, ShardedTensor):
        dst = arr[layer, slot]
        dst.narrow(axis, start, n).copy_(new)
        if zero_to is not None:
            dst.narrow(axis, end, zero_to - end).zero_()
        return
    blk = arr.block
    zend = end if zero_to is None else zero_to
    for d, dev, block in arr.blocks():
        lo, hi = d * blk, (d + 1) * blk
        dst = block[layer, slot]
        a, b = max(lo, start), min(hi, end)
        if a < b:
            dst.narrow(axis, a - lo, b - a).copy_(
                new.narrow(axis, a - start, b - a).to(dev))
        a, b = max(lo, end), min(hi, zend)
        if a < b:
            dst.narrow(axis, a - lo, b - a).zero_()


def row_read(arr, layer: int, slot: int, axis: int) -> torch.Tensor:
    """Row ``arr[layer, slot]`` whole (split, its blocks concatenated on
    the first shard's device)."""
    if not isinstance(arr, ShardedTensor):
        return arr[layer, slot]
    return torch.cat([block[layer, slot].to(arr.device)
                      for _, _, block in arr.blocks()], dim=axis)


def _masked_set(arr, idx, new, fits) -> None:
    """arr[idx] = new, in place, for the rows where ``fits`` [B] holds."""
    keep = fits.view(-1, *([1] * (new.dim() - 1)))
    arr[idx] = torch.where(keep, new, arr[idx])


def set_at_pos(arr, layer: int, index, pos, new, fits) -> None:
    """``arr[layer][index(pos, device)] = new`` where ``fits`` [B] holds,
    in place. Split, each row is written on the shard that owns its
    position; every other shard keeps what it held (a masked write of its
    clamped local position within that same row, so rows never
    collide)."""
    if not isinstance(arr, ShardedTensor):
        _masked_set(arr[layer], index(pos, pos.device), new, fits)
        return
    for d, dev, block in arr.blocks():
        local, own = arr.local(d, pos)
        _masked_set(block[layer], index(local, dev), new.to(dev),
                    own & fits.to(dev))


def pool_put(arr, layer: int, page, rest: tuple, val) -> None:
    """``arr[layer][page, *rest] = val`` (``page`` global page ids, a
    device tensor). Striped, each entry is written on the shard owning its
    page; on every other shard it goes to that shard's dump page, the
    entry past its block."""
    if not isinstance(arr, ShardedTensor):
        arr[layer][(page, *rest)] = val.to(arr.dtype)
        return
    for d, sh in enumerate(arr.shards):
        dev = sh.device
        local, own = arr.local(d, page)
        local = torch.where(own, local, arr.block)
        sh[layer][(local, *(r.to(dev) for r in rest))] = val.to(dev,
                                                                sh.dtype)


def pool_take(arr, layer: int, idx) -> torch.Tensor:
    """Pages ``idx`` (global ids) of ``layer``, gathered: ``arr[layer]
    .index_select(0, idx)``. Striped, each page comes from its owner, onto
    the first shard's device."""
    if not isinstance(arr, ShardedTensor):
        return arr[layer].index_select(0, idx)
    out = None
    for d, _, block in arr.blocks():
        local, own = arr.local(d, idx)
        got = block[layer].index_select(0, local).to(arr.device)
        own = own.view(-1, *([1] * (got.dim() - 1))).to(arr.device)
        out = torch.where(own, got, torch.zeros_like(got) if out is None
                          else out)
    return out


def shard(x: torch.Tensor, devices: Sequence, axis: int) -> list:
    """Split ``x`` along ``axis`` into ``len(devices)`` equal blocks, block
    i on ``devices[i]``; the size must divide."""
    n = len(devices)
    if x.shape[axis] % n:
        raise ValueError(f"dimension {axis} of size {x.shape[axis]} does not "
                         f"divide into {n} shards")
    return [c.to(dev) for c, dev in zip(x.chunk(n, dim=axis), devices,
                                        strict=True)]


def unshard(xs: Sequence[torch.Tensor], axis: int, device=None
            ) -> torch.Tensor:
    """Concatenate per-shard blocks along ``axis`` on ``device`` (default:
    the first shard's)."""
    device = device or xs[0].device
    return torch.cat([x.to(device) for x in xs], dim=axis)


def ppermute(xs: Sequence[torch.Tensor], perm) -> list:
    """``jax.lax.ppermute`` over per-shard tensors: for each (src, dst) in
    ``perm``, shard dst receives shard src's tensor on its own device;
    a shard no pair names receives zeros."""
    out: list = [None] * len(xs)
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device)
    return [torch.zeros_like(x) if o is None else o
            for o, x in zip(out, xs, strict=True)]


def _reduce(xs, op, to=None):
    """Reduce the shards with ``op`` on the first shard's device (or
    ``to``'s): the result on every shard's device, or the one tensor on
    ``to``. A shard already on the target device is not copied."""
    dev0 = torch.device(to) if to is not None else xs[0].device
    acc = xs[0].to(dev0)
    for x in xs[1:]:
        acc = op(acc, x.to(dev0))
    if to is not None:
        return acc
    return [acc.to(x.device) for x in xs]


def psum(xs: Sequence[torch.Tensor], to=None):
    """The sum over shards, on every shard's device (shard order); with
    ``to``, the one sum on that device: a row-parallel product's reduce
    onto the device its activations live on. On a repeated device the
    shards are added where they are: nothing is copied."""
    return _reduce(xs, torch.add, to)


def pmax(xs: Sequence[torch.Tensor]) -> list:
    """The elementwise max over shards, on every shard's device."""
    return _reduce(xs, torch.maximum)


def all_to_all(xs: Sequence[torch.Tensor], split_axis: int,
               concat_axis: int) -> list:
    """Tiled ``jax.lax.all_to_all``: every shard splits its tensor into n
    blocks along ``split_axis``; shard j receives block j of every shard,
    concatenated along ``concat_axis`` in shard order."""
    n = len(xs)
    parts = [x.chunk(n, dim=split_axis) for x in xs]
    for x, p in zip(xs, parts, strict=True):
        if len(p) != n or x.shape[split_axis] % n:
            raise ValueError(f"all_to_all: dimension {split_axis} of size "
                             f"{x.shape[split_axis]} does not split {n} ways")
    return [torch.cat([parts[i][j].to(xs[j].device) for i in range(n)],
                      dim=concat_axis) for j in range(n)]


def all_gather(xs: Sequence[torch.Tensor], axis: int, to=None):
    """Every shard receives all shards' tensors concatenated along
    ``axis``, on its own device; with ``to``, the one concatenation on
    that device (a vocabulary-split head's logits, gathered for sampling;
    one shard's tensor is returned as it is). Shards on one device share
    one concatenation."""
    if to is not None:
        if len(xs) == 1:
            return xs[0].to(to)
        return torch.cat([x.to(to) for x in xs], dim=axis)
    done: dict = {}
    for x in xs:
        if x.device not in done:
            done[x.device] = torch.cat([y.to(x.device) for y in xs],
                                       dim=axis)
    return [done[x.device] for x in xs]
