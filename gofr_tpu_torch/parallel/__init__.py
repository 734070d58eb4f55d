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
  a leaf whose spec names a ``tp``, ``ep``, ``dp`` or ``fsdp`` axis of
  size > 1 as a ``ShardedTensor``: the dimension split into equal
  contiguous blocks, block i on the i-th device along that axis (a second
  sharded dimension, MoE's ``P("ep", None, "tp")``, splits each block
  again along its own axis); every other leaf goes to the mesh's first
  device, replicated there. ``fsdp`` is always the innermost split: a
  weight under ``P(None, "fsdp", "tp")`` is a ``ShardedTensor`` over tp
  whose every block is a ``ShardedTensor`` over fsdp (its fsdp blocks on
  the devices at that tp position), so ``shards_of`` still returns one
  entry a tp shard and the model gathers that entry's fsdp blocks
  (``gather``) onto the device it computes on, just in time, as GSPMD's
  ZeRO-3 all-gather does; autograd through the gather returns each block
  its own gradient (the reduce-scatter). The modules that run such
  weights (``models.llama``, ``models.moe``, ``models.bert``,
  ``models.diffusion``) compute each shard's block on its device and
  combine with ``psum`` after a row-parallel product and ``all_gather``
  after a vocabulary-split one; ``parallel.ring``, ``parallel.ulysses``,
  ``parallel.pipeline`` and the sequence-parallel serving path shard
  activations and state by hand;
- a batch placed with ``shard_like(batch, P("dp"), mesh)`` is a
  ``ShardedTensor`` of row blocks, block g on the device of dp group g;
  a model computes each group on its own devices and the weights
  ``.to()`` there (nothing is copied on a repeated device); the backward
  pass of that copy adds the groups' gradients onto the weight, which is
  GSPMD's dp all-reduce;
- an axis may span processes (``make_mesh(..., process_axis="dp")``):
  the mesh then holds this process's devices only (``shape`` is the local
  grid, ``n_processes`` the count); ``process_sum`` all-reduces over
  the ``torch.distributed`` group (gloo through the host, or NCCL on the
  cards), which the trainer calls once a step where GSPMD inserts its
  cross-host psum;
- ``constrain`` checks a spec against the ambient mesh (``with mesh:``)
  and returns its input: an unknown axis or a dimension the axis does not
  divide raises, as JAX's promises; outside a mesh it does nothing;
- ``init_distributed`` brings up ``torch.distributed`` (the role
  ``jax.distributed.initialize`` plays) and does nothing in one process;
  ``dist_backend`` picks its backend: NCCL when every rank of the host
  has a card of its own, gloo when they share one (NCCL refuses two ranks
  on one device) or have none.

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
    "place",
    "shard_params",
    "shard_like",
    "shards_of",
    "gather",
    "current_mesh",
    "constrain",
    "specs_from_rules",
    "init_distributed",
    "dist_backend",
    "process_sum",
    "dp_mean",
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
        # an axis spanning processes (make_mesh's process_axis): its name,
        # the torch.distributed group and the process count
        self.process_axis: str | None = None
        self.group = None
        self.n_processes = 1

    @property
    def empty(self) -> bool:
        return self.devices.size == 0

    @property
    def first(self) -> torch.device:
        """The device of the mesh's first position: where replicated
        weights and activations live."""
        return self.devices.flat[0]

    def sub(self, **at) -> "Mesh":
        """The mesh with the named axes fixed at the given positions (each
        of size 1): ``mesh.sub(tp=d)`` is tp shard d's sp mesh, over which
        that shard's heads run ring or Ulysses attention."""
        idx = tuple(slice(at[n], at[n] + 1) if n in at else slice(None)
                    for n in self.axis_names)
        out = Mesh(self.devices[idx], self.axis_names)
        out.process_axis, out.group = self.process_axis, self.group
        out.n_processes = self.n_processes
        return out

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
              devices: Sequence | None = None,
              process_axis: str | None = None, group=None) -> Mesh:
    """The canonical mesh over ``devices`` (default: every visible card;
    without a card the caller names the CPU: ``devices=[torch.device(
    "cpu")] * n``). A device may repeat: its positions then share it.
    Axis order is (dp, fsdp, pp, ep, tp, sp), outermost to innermost.

    ``process_axis`` names an axis that spans the processes of the
    ``torch.distributed`` ``group`` (default the world), as JAX's global
    mesh over ``jax.devices()`` does: ``config`` then gives the global
    sizes, the axis's size must be a multiple of the process count, and
    ``devices`` are this process's own, one a position of its share
    (``MeshConfig(dp=2, tp=4)`` over two processes: four devices each,
    a local grid of dp 1 x tp 4)."""
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
    n_proc = 1
    if process_axis is not None:
        import torch.distributed as dist

        if process_axis not in AXES:
            raise ValueError(f"unknown mesh axis {process_axis!r}")
        if config is None:
            raise ValueError("a mesh spanning processes needs its config")
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                f"process_axis={process_axis!r} needs an initialised "
                "torch.distributed group (parallel.init_distributed or "
                "torch.distributed.init_process_group)")
        n_proc = dist.get_world_size(group)
    if config is None:
        config = mesh_shape_for(len(devs))
    sizes = list(config.sizes())
    if process_axis is not None:
        i = AXES.index(process_axis)
        if sizes[i] % n_proc:
            raise ValueError(f"mesh axis {process_axis!r} of size {sizes[i]} "
                             f"does not divide over {n_proc} processes")
        sizes[i] //= n_proc
    total = int(np.prod(sizes))
    if total != len(devs):
        raise ValueError(f"mesh sizes {tuple(sizes)} != {len(devs)} devices"
                         + (" of this process" if n_proc > 1 else ""))
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    mesh = Mesh(grid.reshape(sizes), AXES)
    if process_axis is not None:
        mesh.process_axis, mesh.group = process_axis, group
        mesh.n_processes = n_proc
    return mesh


def dist_backend(local_processes: int, n_cards: int | None = None) -> str:
    """The ``torch.distributed`` backend for ``local_processes`` ranks on
    one host with ``n_cards`` cards (default: the visible ones): NCCL when
    each rank has a card of its own, gloo when there is none or the ranks
    outnumber the cards (NCCL refuses two ranks on one device; gloo
    reduces through the host)."""
    if n_cards is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
    return "nccl" if 0 < int(local_processes) <= n_cards else "gloo"


def _local_processes(config, coord: str, num_procs: int) -> int:
    """The ranks on this host: ``LOCAL_WORLD_SIZE`` (torchrun's key) when
    set, else all of them for a coordinator on this host, else one."""
    local = config.get("LOCAL_WORLD_SIZE")
    if local:
        return int(local)
    host = coord.rsplit(":", 1)[0].strip("[]")
    return num_procs if host in ("localhost", "::1") \
        or host.startswith("127.") else 1


def init_distributed(config=None) -> None:
    """Multi-process bring-up over ``torch.distributed`` (the role
    ``jax.distributed.initialize`` plays): reads the coordinator address
    (``host:port``), the process count and this process's id from
    ``config`` (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``, the JAX package's keys) and does nothing when no
    address is set or the group is up already. The backend is
    ``dist_backend``'s choice for the ranks on this host
    (``LOCAL_WORLD_SIZE``, else all of them when the coordinator is on
    this host): gloo when they share a card or have none, NCCL when each
    has its own."""
    if config is None:
        return
    coord = config.get("JAX_COORDINATOR_ADDRESS")
    if not coord:
        return
    import torch.distributed as dist

    if dist.is_initialized():
        return
    num_procs = int(config.get("JAX_NUM_PROCESSES") or 1)
    proc_id = config.get("JAX_PROCESS_ID")
    dist.init_process_group(
        dist_backend(_local_processes(config, coord, num_procs)),
        init_method=f"tcp://{coord}", world_size=num_procs,
        rank=int(proc_id) if proc_id is not None else 0)


def process_sum(tensors: Sequence[torch.Tensor], mesh: Mesh | None,
                axis: str = "dp") -> list:
    """Sum ``tensors`` in place over the processes ``mesh``'s ``axis``
    spans: one ``all_reduce`` a dtype over the mesh's group, through one
    flat host buffer under gloo (or on the first tensor's card under
    NCCL), summed in the tensors' own dtype as GSPMD's psum sums. Nothing
    happens when the axis spans no processes. Returns ``tensors``."""
    tensors = list(tensors)
    if (mesh is None or mesh.process_axis != axis or mesh.n_processes == 1
            or not tensors):
        return tensors
    import torch.distributed as dist

    on_host = dist.get_backend(mesh.group) != "nccl"
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, ts in by_dtype.items():
        dev = torch.device("cpu") if on_host else ts[0].device
        flat = torch.empty(sum(t.numel() for t in ts), dtype=dtype,
                           device=dev)
        off = 0
        for t in ts:
            flat[off:off + t.numel()].copy_(t.reshape(-1))
            off += t.numel()
        dist.all_reduce(flat, group=mesh.group)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
    return tensors


def dp_mean(sums: Sequence[torch.Tensor], counts: Sequence) -> torch.Tensor:
    """The global batch's mean from each dp group's sum and count: both
    added over the groups onto the first sum's device (``psum``), the
    counts also over the processes the ambient mesh's dp axis spans, then
    one division (by at least 1). Not the mean of the groups' means, which
    differs as soon as their counts do. Under a process-spanning dp axis
    the result is this process's part of the global mean: ``ml.train``
    sums the parts."""
    dev = sums[0].device
    total = psum(list(sums), to=dev)
    count = psum([torch.as_tensor(c, dtype=torch.float32).to(dev)
                  for c in counts], to=dev).detach().clone()
    process_sum([count], current_mesh(), "dp")
    return total / torch.clamp(count, min=1.0)


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


def _split_dims(shape, spec, mesh: Mesh) -> list:
    """The (dimension, axis) pairs a leaf of ``shape`` splits along: every
    axis of ``spec`` whose size on ``mesh`` is > 1, ``fsdp`` last (the
    innermost split). A dimension the axis does not divide raises
    ``ValueError``, as GSPMD refuses such a sharding."""
    out = []
    for dim, entry in enumerate(spec):
        axes = [ax for ax in _axes_of(entry) if mesh.shape.get(ax, 1) > 1]
        if not axes:
            continue
        if len(axes) > 1:
            raise NotImplementedError(
                f"shard_params: dimension {dim} over the axes {axes} at "
                f"once is not ported (one mesh axis a dimension)")
        if dim >= len(shape):
            raise ValueError(f"shard_params: spec {spec!r} has more entries "
                             f"than the rank {len(shape)} of the leaf")
        n = mesh.shape[axes[0]]
        if shape[dim] % n:
            raise ValueError(
                f"shard_params: dimension {dim} of size {shape[dim]} "
                f"does not divide over {axes[0]!r} of size {n}")
        out.append((dim, axes[0]))
    return sorted(out, key=lambda d: d[1] == "fsdp")


def place(shape, spec, mesh: Mesh, take):
    """The layout of a leaf of ``shape`` under ``spec`` on ``mesh``, built
    a block at a time: ``take(index, device)`` returns the block at
    ``index`` (a tuple of slices of the whole leaf) on ``device``. An
    unsplit leaf is ``take`` of the whole on the mesh's first device; a
    split one a (nested) ``ShardedTensor``, each level over one axis
    (``_split_dims``' order), block i of a level on the i-th device along
    its axis with the outer levels' positions fixed."""
    dims = _split_dims(shape, spec, mesh)
    whole = tuple(slice(None) for _ in shape)
    if not dims:
        return take(whole, mesh.first)

    def split(index, dims, fixed):
        (dim, ax), rest = dims[0], dims[1:]
        devs = mesh.axis_devices(ax, **fixed)
        size = shape[dim] // len(devs)
        blocks = []
        for i, dev in enumerate(devs):
            idx = list(index)
            idx[dim] = slice(i * size, (i + 1) * size)
            blocks.append(split(tuple(idx), rest, {**fixed, ax: i}) if rest
                          else take(tuple(idx), dev))
        return ShardedTensor(blocks, dim, size, mesh_axis=ax)

    return split(whole, dims, {})


def shard_params(params: Any, specs: Any, mesh: Mesh) -> Any:
    """Place a parameter tree on the mesh per its spec tree, as JAX's
    ``device_put`` with ``NamedSharding``s does (``place``): a leaf whose
    spec names an axis of size > 1 becomes a ``ShardedTensor``, block i of
    that dimension on the i-th device along the axis (the other axes at
    their first position); a second such dimension splits each block
    again, ``fsdp`` innermost. Blocks on a leaf's own device are views of
    it (nothing is copied). Every other leaf goes to the mesh's first
    device."""

    def put(leaf, spec):
        if isinstance(leaf, np.ndarray):
            leaf = torch.from_numpy(leaf)
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return place(tuple(leaf.shape), spec, mesh,
                     lambda idx, dev: leaf[idx].to(dev))

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)) and not isinstance(spec, P):
            return type(tree)(walk(v, s) for v, s in zip(tree, spec,
                                                         strict=True))
        return put(tree, spec)

    return walk(params, specs)


def shard_like(tree: Any, spec: P, mesh: Mesh) -> Any:
    """Place every leaf of ``tree`` (tensors or numpy arrays) with one
    spec, as JAX's ``shard_like`` does: a batch under ``P("dp")`` becomes
    a ``ShardedTensor`` of row blocks, block g on dp group g's device.
    Over a mesh whose dp axis spans processes, the leaves are this
    process's rows, split over its own dp positions."""

    def specs(t):
        if isinstance(t, dict):
            return {k: specs(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(specs(v) for v in t)
        return spec

    return shard_params(tree, specs(tree), mesh)


def shards_of(w) -> list:
    """A weight's compute shards in order: a ``ShardedTensor``'s shards,
    or the weight whole, the one shard of an unsplit weight (so a model
    runs one layer body over split and unsplit params alike). A split over
    ``fsdp`` is no compute split: such a weight (or a tp shard's fsdp
    blocks) is one entry, which ``gather`` joins."""
    if isinstance(w, ShardedTensor) and w.mesh_axis != "fsdp":
        return list(w.shards)
    return [w]


def gather(w, device=None):
    """``w`` whole on ``device`` (default: where it is): a tensor moved
    there, a ``ShardedTensor``'s blocks (nested ones too) concatenated
    there, a dict (an int8 weight's ``{"q", "s"}``) entry by entry. The
    just-in-time all-gather of fsdp blocks: differentiable, so each block
    gets its own gradient back."""
    if isinstance(w, dict):
        return {k: gather(v, device) for k, v in w.items()}
    if isinstance(w, ShardedTensor):
        return w.full(device)
    return w if device is None else w.to(device)


def current_mesh() -> Mesh | None:
    """The ambient mesh (the innermost ``with mesh:`` of this thread), or
    None."""
    stack = getattr(_AMBIENT, "stack", None)
    return stack[-1] if stack else None


def constrain(x: Any, spec: P) -> Any:
    """Check ``spec`` against the ambient mesh and return ``x``: a no-op
    outside a mesh (single-device paths); inside one, an axis the mesh has
    not, a spec longer than ``x``'s rank or a dimension the axes' size
    does not divide raises, as JAX's ``with_sharding_constraint`` would.
    The port places nothing here: a module that shards does it itself."""
    mesh = current_mesh()
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
    ``index_copy_`` along ``axis`` route each index to its owner. A shard
    may itself be a ``ShardedTensor`` (a second split of its block);
    ``mesh_axis`` names the mesh axis of a placed weight's split (None for
    the caches' own splits)."""

    def __init__(self, shards: Sequence, axis: int,
                 block: int | None = None,
                 mesh_axis: str | None = None) -> None:
        self.shards = list(shards)
        self.axis = axis
        self.block = int(block if block is not None
                         else self.shards[0].shape[axis])
        self.mesh_axis = mesh_axis

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

    def block_of(self, d: int):
        """Shard ``d``'s block (its entries past the block left out)."""
        sh = self.shards[d]
        if sh.shape[self.axis] == self.block:
            return sh
        return sh.narrow(self.axis, 0, self.block)

    def leaf_blocks(self, index: tuple | None = None):
        """(index, tensor) of every innermost block, in shard order:
        ``index`` is the block's tuple of slices of the logical tensor."""
        if index is None:
            index = tuple(slice(0, n) for n in self.shape)
        for d, _, b in self.blocks():
            idx = list(index)
            lo = index[self.axis].start + d * self.block
            idx[self.axis] = slice(lo, lo + self.block)
            if isinstance(b, ShardedTensor):
                yield from b.leaf_blocks(tuple(idx))
            else:
                yield tuple(idx), b

    def map_blocks(self, fn) -> "ShardedTensor":
        """A ``ShardedTensor`` of the same layout whose innermost blocks
        are ``fn(block)``."""
        return ShardedTensor(
            [sh.map_blocks(fn) if isinstance(sh, ShardedTensor) else fn(sh)
             for sh in self.shards], self.axis, self.block, self.mesh_axis)

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
        return torch.cat([gather(b, device) for _, _, b in self.blocks()],
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
                f"n={self.n}, dtype={self.dtype}, mesh_axis={self.mesh_axis})")


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
