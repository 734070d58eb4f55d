"""PyTorch port, kernel build and launch planning, on the CPU (no nvcc, no
card): a library is keyed on every file its build reads, and the decode
kernels' split plan fills the card at the serving shapes."""

import shutil

import pytest

from gofr_tpu_torch.ops import _build
from gofr_tpu_torch.ops.decode_attention import (MAX_SPAN, MAX_SPLITS, TILE,
                                                 split_plan)


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the kernel sources, standing in for ``csrc/``."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", _build.KERNELS)
def test_build_key_follows_the_source_and_every_header(csrc, name):
    key = _build._target(name)
    assert key == _build._target(name)
    header = csrc / "cp_async.cuh"
    text = header.read_text()
    header.write_text(text + "// edited\n")
    assert _build._target(name) != key
    header.write_text(text)
    assert _build._target(name) == key
    (csrc / "new_helpers.cuh").write_text("#pragma once\n")
    assert _build._target(name) != key
    (csrc / "new_helpers.cuh").unlink()
    src = csrc / f"{name}.cu"
    src.write_text(src.read_text() + "\n")
    assert _build._target(name) != key


@pytest.mark.parametrize("shape", [
    # B, KV, S_max, SMs, least CTAs in the grid (about 2 a SM)
    (4, 8, 1024, 132, 256),         # bf16 serving path: 4 slots x 1024
    (8, 8, 4096, 132, 256),         # int8 serving path: 8 slots x 4096
    (1, 8, 4096, 132, 64),          # one long row: 8 clusters of 8
    (2, 2, 300, 132, 20),           # a ragged S_max: 5 tiles, 5 splits
    (64, 8, 32768, 132, 4 * 64 * 8),  # many long rows: spans at their cap
])
def test_split_plan_fills_the_card(shape):
    b, kv, s_max, n_sm, least = shape
    span, n_splits = split_plan(b, kv, s_max, n_sm)
    tiles = -(-s_max // TILE)
    assert span % TILE == 0 and TILE <= span <= MAX_SPAN
    assert 1 <= n_splits <= min(MAX_SPLITS, tiles)
    # split k takes tiles k, k + n_splits, ...: span covers the most
    assert span == -(-tiles // n_splits) * TILE
    assert b * kv * n_splits >= least


def test_split_plan_refuses_what_one_cluster_cannot_cover():
    split_plan(1, 8, MAX_SPLITS * MAX_SPAN, 132)
    with pytest.raises(ValueError, match="S_max"):
        split_plan(1, 8, MAX_SPLITS * MAX_SPAN + 1, 132)


@pytest.mark.parametrize("case", [
    # label, B, T, kv_len, FLOPs, bytes, bound ms, bound_by
    ("512 wave of 2", 2, 512, [512, 301], 3.937e9, 20.11e6, 0.0060, "bytes"),
    ("2048 trickle", 1, 2048, [2000], 34.36e9, 41.75e6, 0.0347, "operations"),
    ("2048 burst of 8", 8, 2048, [2000, 1942, 1500, 1024, 777, 513, 129, 37],
     167.95e9, 300.9e6, 0.1698, "operations"),
])
def test_flash_bound_counts_the_work_the_masks_keep(case):
    """chip_smoke's flash bound at the serving shapes: 4 * D FLOPs per
    (query, key) pair that the causal and kv_len masks keep, every query
    row included; q and o once, the live K/V prefix once."""
    import torch

    import chip_smoke

    label, B, T, lens, flops, nbytes, ms, by = case
    c = {"B": B, "T": T, "H": 32, "KV": 8, "D": 128,
         "kv_len": torch.tensor(lens, dtype=torch.int32)}
    b_ms, b_by, got_bytes = chip_smoke.flash_bound(c)
    pairs = sum(min(i + 1, n) for n in lens for i in range(T))
    assert 4 * 128 * 32 * pairs == pytest.approx(flops, rel=3e-3)
    assert got_bytes == pytest.approx(nbytes, rel=3e-3)
    assert b_by == by and b_ms == pytest.approx(ms, rel=3e-3)


def test_flash_bound_counts_the_paged_suffix():
    """The bound at the paged path's suffix shape: 512 queries at
    q_offset 1536 over 2048 keys, causal, no kv_len; each query row keeps
    1537..2048 keys."""
    import chip_smoke

    c = {"B": 1, "T": 512, "Tk": 2048, "q_offset": 1536, "H": 32, "KV": 8,
         "D": 128, "kv_len": None}
    b_ms, b_by, got_bytes = chip_smoke.flash_bound(c)
    pairs = sum(1537 + i for i in range(512))
    assert pairs == 917_760
    assert got_bytes == 2 * (2 * 512 * 32 * 128 + 2 * 2048 * 8 * 128)
    assert b_by == "operations"
    assert b_ms == pytest.approx(4 * 128 * 32 * pairs / 989e12 * 1e3,
                                 rel=1e-9)
