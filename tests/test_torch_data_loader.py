"""PyTorch port, the training input pipeline: twins of
``tests/test_data_loader.py``. The port's ``DataLoader`` (on the CPU here,
``device="cpu"``) yields the JAX loader's batches: the same static shapes
and dropped remainder, the same seeded shuffle order, per-epoch reshuffles,
transforms, producer errors, JSONL / CSV sources over a path or a duck-typed
``filesystem``, and batches a training step consumes. Placement over a mesh
is not ported (A.11) and raises.
"""

from __future__ import annotations

import io
import json

import numpy as np
import pytest
import torch

from gofr_tpu.ml.data import DataLoader as JDataLoader
from gofr_tpu_torch.ml import optim
from gofr_tpu_torch.ml.data import DataLoader, csv_source, jsonl_source
from gofr_tpu_torch.ml.train import make_train_step
from gofr_tpu_torch.models.mlp import MLP

pytestmark = pytest.mark.timeout(120)


def _range_source(n):
    def gen():
        for i in range(n):
            yield {"x": np.full((4,), i, np.float32), "y": np.int32(i)}
    return gen


def _ys(dl):
    return [int(v) for b in dl for v in b["y"].tolist()]


def test_batches_are_static_and_remainder_dropped():
    dl = DataLoader(_range_source(10), batch_size=4, device="cpu")
    batches = list(dl)
    assert len(batches) == 2  # 10 // 4, remainder dropped for static shapes
    assert batches[0]["x"].shape == (4, 4)
    assert isinstance(batches[0]["x"], torch.Tensor)
    assert batches[0]["y"].tolist() == [0, 1, 2, 3]
    assert batches[1]["y"].tolist() == [4, 5, 6, 7]


def test_shuffle_is_seeded_and_complete():
    def ys(seed):
        return _ys(DataLoader(_range_source(16), batch_size=4,
                              shuffle_buffer=8, seed=seed, device="cpu"))

    a, b, c = ys(1), ys(1), ys(2)
    assert a == b                      # deterministic for a seed
    assert a != c                      # different seed, different order
    assert sorted(a) == list(range(16))  # a permutation, nothing lost
    assert a != list(range(16))        # actually shuffled
    # the JAX loader's order for the same seed
    want = [int(v) for bt in JDataLoader(_range_source(16), batch_size=4,
                                         shuffle_buffer=8, seed=1)
            for v in np.asarray(bt["y"])]
    assert a == want


def test_repeat_reshuffles_each_epoch():
    dl = DataLoader(_range_source(8), batch_size=4, shuffle_buffer=8,
                    seed=3, repeat=True, device="cpu")
    it = iter(dl)
    epoch1 = [int(v) for _ in range(2) for v in next(it)["y"].tolist()]
    epoch2 = [int(v) for _ in range(2) for v in next(it)["y"].tolist()]
    assert sorted(epoch1) == sorted(epoch2) == list(range(8))
    assert epoch1 != epoch2  # epoch-seeded reshuffle
    jit = iter(JDataLoader(_range_source(8), batch_size=4, shuffle_buffer=8,
                           seed=3, repeat=True))
    want = [int(v) for _ in range(4) for v in np.asarray(next(jit)["y"])]
    assert epoch1 + epoch2 == want


def test_sharded_placement_on_mesh():
    """JAX places dp-sharded batches on a mesh; the port's mesh is A.11."""
    for kw in ({"mesh": object(), "spec": ("dp",)}, {"sharding": object()}):
        with pytest.raises(NotImplementedError, match="A.11"):
            DataLoader(_range_source(16), batch_size=8, device="cpu", **kw)
    # one process without a torch.distributed group reads every record
    dl = DataLoader(_range_source(16), batch_size=8, shard_by_process=True,
                    device="cpu")
    assert _ys(dl) == list(range(16))
    assert float(next(iter(dl))["x"].sum()) == float(sum(i * 4
                                                         for i in range(8)))


def test_transform_and_scalar_records():
    dl = DataLoader(lambda: iter(range(6)), batch_size=3,
                    transform=lambda i: {"v": np.float32(i * 2)},
                    device="cpu")
    batches = list(dl)
    assert batches[0]["v"].tolist() == [0.0, 2.0, 4.0]
    # records that are not dicts stack under "data"
    plain = list(DataLoader(lambda: iter(range(4)), batch_size=2,
                            device="cpu"))
    assert plain[1]["data"].tolist() == [2, 3]


def test_producer_error_surfaces_in_consumer():
    def bad():
        yield {"x": np.zeros(2)}
        raise RuntimeError("corrupt shard")

    it = iter(DataLoader(bad, batch_size=1, device="cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="corrupt shard"):
        next(it)


def test_jsonl_and_csv_sources(tmp_path):
    p = tmp_path / "d.jsonl"
    p.write_text("\n".join(json.dumps({"a": i}) for i in range(4)) + "\n")
    dl = DataLoader(jsonl_source(str(p)), batch_size=2,
                    transform=lambda r: {"a": np.int32(r["a"])},
                    device="cpu")
    assert [int(v) for b in dl for v in b["a"].tolist()] == [0, 1, 2, 3]

    c = tmp_path / "d.csv"
    c.write_text("a,b\n1,x\n2,y\n")
    rows = list(csv_source(str(c))())
    assert rows == [{"a": "1", "b": "x"}, {"a": "2", "b": "y"}]


class _MemoryFS:
    """A duck-typed filesystem: ``open(path)`` returns a handle with
    ``read(n)`` and ``close()`` (any FTP/SFTP/S3 mount has the same)."""

    def __init__(self, files: dict[str, bytes]) -> None:
        self.files = files
        self.opened: list[str] = []

    def open(self, path):
        self.opened.append(path)
        return io.BytesIO(self.files[path])


def test_jsonl_source_over_filesystem():
    fs = _MemoryFS({"/fs.jsonl": b'{"a": 7}\n{"a": 8}\n',
                    "/fs.csv": b"a,b\n1,x\n2,y"})
    dl = DataLoader(jsonl_source("/fs.jsonl", filesystem=fs), batch_size=2,
                    transform=lambda r: {"a": np.int32(r["a"])},
                    device="cpu")
    assert [int(v) for b in dl for v in b["a"].tolist()] == [7, 8]
    assert list(csv_source("/fs.csv", filesystem=fs)()) == [
        {"a": "1", "b": "x"}, {"a": "2", "b": "y"}]
    assert fs.opened == ["/fs.jsonl", "/fs.csv"]


def test_train_step_consumes_loader():
    """End to end: loader -> batches -> make_train_step."""
    model = MLP(sizes=(4, 8, 2), seed=0, device="cpu")

    def loss_fn(p, x, y):
        return ((MLP.apply(p, x) - y) ** 2).mean()

    opt = optim.sgd(0.1)
    step = make_train_step(loss_fn, opt)
    opt_state = opt.init(model.params)
    rng = np.random.default_rng(0)
    records = [{"x": rng.normal(size=(4,)).astype(np.float32),
                "y": rng.normal(size=(2,)).astype(np.float32)}
               for _ in range(32)]
    dl = DataLoader(lambda: iter(records), batch_size=16, device="cpu")
    params = model.params
    losses = []
    for batch in dl:
        params, opt_state, loss = step(params, opt_state, batch["x"],
                                       batch["y"])
        losses.append(float(loss))
    assert len(losses) == 2
    assert np.isfinite(losses).all()


def test_empty_source_with_repeat_raises():
    """An empty source must error out, not spin a core forever while the
    consumer hangs on an empty queue."""
    it = iter(DataLoader(lambda: iter(()), batch_size=2, repeat=True,
                         device="cpu"))
    with pytest.raises(ValueError, match="no records"):
        next(it)


def test_device_defaults_to_the_card():
    """Without ``device`` the loader places batches on the first CUDA card,
    and without a card it raises instead of quietly staying on the host."""
    if torch.cuda.is_available():
        assert DataLoader(_range_source(4), 2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DataLoader(_range_source(4), 2)
