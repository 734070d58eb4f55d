"""PyTorch port on the card: the CUDA kernels (flash prefill, fp decode,
int8 decode) against their plain versions at ragged shapes, and the tiny
model through the kernels against the plain path, with the fp cache and
with the int8 cache and int8 weights. Marked ``cuda``: each test skips where there is no card (decided in
the fixture, never at import). Run on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The flash kernel is also held at the serving paths' 2048-token shapes, at
every head_dim and n_rep, at ragged Tq/Tk and q_offset, at kv_len 0 (the
row is zeros) and under one tile, on structured inputs that expose a
fragment-layout mix-up, in a CUDA-graph replay and on two streams. The
decode kernels are also held at every head_dim and n_rep they take, at
the kv_len edges (tiles, splits, 1, 0, -1, S_max, S_max + 1), for one long
row, over 20 back-to-back calls and on two streams; and over speculative
verify windows of 8, 16 and 32 query rows a launch and of several
launches, with W = 1 bit for bit the decode launch.

Tolerance 2e-2 absolute on bf16 attention outputs of O(1) (one bf16 ulp is
2**-7 there, and the kernels round P to bf16 before P@V).
"""

import numpy as np
import pytest
import torch

pytestmark = [pytest.mark.cuda, pytest.mark.timeout(600)]

TOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rnd(g, dev, *shape):
    return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.parametrize("case", [
    # B, Tq, Tk, H, KV, D, causal, kv_len, q_offset
    (2, 512, 512, 32, 8, 128, True, [512, 301], 0),
    # the 2048-bucket shapes of the int8 path: one prompt, a burst of 8
    (1, 2048, 2048, 32, 8, 128, True, [2000], 0),
    (8, 2048, 2048, 32, 8, 128, True,
     [2000, 1942, 1500, 1024, 777, 513, 129, 37], 0),
    # Tq, Tk off the tiles (77, 130, 200), kv_len, q_offset with Tq < Tk
    (1, 130, 130, 4, 2, 128, True, None, 0),
    (1, 200, 200, 8, 2, 128, True, [177], 0),
    (2, 77, 130, 4, 1, 128, False, [130, 77], 0),
    (2, 77, 200, 4, 4, 64, False, [200, 33], 0),
    (1, 64, 192, 2, 1, 16, True, [150], 128),
    (1, 100, 300, 8, 1, 128, True, [290], 70),
    # the first warpgroup's 64 query rows end before the item's last K/V
    # tile
    (1, 128, 192, 4, 2, 128, True, None, 64),
    # a single live query row; K/V many tiles long, full attention
    (1, 40, 1000, 4, 2, 128, False, None, 0),
])
def test_flash_kernel_matches_plain(dev, case):
    from gofr_tpu_torch.ops.flash_attention import (flash_attention_cuda,
                                                    flash_attention_plain)

    B, Tq, Tk, H, KV, D, causal, kvl, q_offset = case
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (_rnd(g, dev, B, Tq, H, D), _rnd(g, dev, B, Tk, KV, D),
               _rnd(g, dev, B, Tk, KV, D))
    kv_len = (None if kvl is None
              else torch.tensor(kvl, dtype=torch.int32, device=dev))
    n0 = flash_attention_cuda.launches
    out = flash_attention_cuda(q, k, v, kv_len, causal=causal,
                               q_offset=q_offset)
    ref = flash_attention_plain(q, k, v, kv_len, causal=causal,
                                q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == n0 + 1
    assert (out.float() - ref.float()).abs().max().item() <= TOL


def _flash_inputs(dev, B, Tq, Tk, H, KV, D, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (_rnd(g, dev, B, Tq, H, D), _rnd(g, dev, B, Tk, KV, D),
            _rnd(g, dev, B, Tk, KV, D))


@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("D", [16, 64, 128])
def test_flash_kernel_at_every_head_dim_and_group(dev, n_rep, D):
    """Every head_dim the wrapper takes, with 1, 2, 4 and 8 query heads a
    KV head, causal over ragged rows and full over a short one."""
    from gofr_tpu_torch.ops.flash_attention import (flash_attention_cuda,
                                                    flash_attention_plain)

    q, k, v = _flash_inputs(dev, 3, 333, 333, 2 * n_rep, 2, D)
    kv_len = torch.tensor([333, 5, 200], dtype=torch.int32, device=dev)
    for causal in (True, False):
        out = flash_attention_cuda(q, k, v, kv_len, causal=causal)
        ref = flash_attention_plain(q, k, v, kv_len, causal=causal)
        torch.cuda.synchronize()
        assert (out.float() - ref.float()).abs().max().item() <= TOL


@pytest.mark.parametrize("D", [16, 64, 128])
def test_flash_kernel_kv_len_edges(dev, D):
    """A row with kv_len 0 reads nothing and writes zeros (the TPU kernel's
    empty loop); rows with kv_len 1, 37 and 64 (inside the first 128-key
    tile) and of the whole row match the plain version."""
    from gofr_tpu_torch.ops.flash_attention import (flash_attention_cuda,
                                                    flash_attention_plain)

    q, k, v = _flash_inputs(dev, 5, 300, 300, 8, 2, D, seed=1)
    kv_len = torch.tensor([0, 1, 37, 64, 300], dtype=torch.int32, device=dev)
    out = flash_attention_cuda(q, k, v, kv_len, causal=True)
    ref = flash_attention_plain(q, k, v, kv_len, causal=True)
    torch.cuda.synchronize()
    assert out[0].abs().max().item() == 0.0
    assert (out[1:].float() - ref[1:].float()).abs().max().item() <= TOL


@pytest.mark.parametrize("D", [16, 64, 128])
def test_flash_kernel_fragment_layout(dev, D):
    """Structured inputs that expose a mix-up of rows or columns between
    the product S = Q K^T, the softmax and P V. V is one-hot (key j carries
    e_(j mod D)), so O reads back the attention weights by key residue.
    With q_i = 8 sqrt(D) e_(i mod D) and k_j = e_(j mod D), query i's logit
    is 8 at the keys of its own residue and 0 elsewhere, so its weight sits
    in column i mod D; with random Q and K it is spread. Both against the
    plain version."""
    from gofr_tpu_torch.ops.flash_attention import (flash_attention_cuda,
                                                    flash_attention_plain)

    T, H = 256, 2
    eye = torch.eye(D, device=dev)
    one_hot = eye[torch.arange(T, device=dev) % D][None, :, None, :]
    v = one_hot.to(torch.bfloat16)
    sharp = ((8 * D ** 0.5 * one_hot).expand(1, T, H, D).contiguous()
             .to(torch.bfloat16), v)
    q, k, _ = _flash_inputs(dev, 1, T, T, H, 1, D, seed=6)
    for qk in (sharp, (q, k)):
        for causal in (True, False):
            out = flash_attention_cuda(*qk, v, causal=causal)
            ref = flash_attention_plain(*qk, v, causal=causal)
            torch.cuda.synchronize()
            assert (out.float() - ref.float()).abs().max().item() <= TOL


def test_flash_kernel_graph_replay_matches_eager(dev):
    """A CUDA graph captures the kernel with its tensor maps by value: a
    replay on new inputs in the same buffers equals an eager call."""
    from gofr_tpu_torch.ops.flash_attention import flash_attention_cuda

    q, k, v = _flash_inputs(dev, 2, 300, 300, 8, 2, 128, seed=2)
    kv_len = torch.tensor([300, 150], dtype=torch.int32, device=dev)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        flash_attention_cuda(q, k, v, kv_len)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = flash_attention_cuda(q, k, v, kv_len)
    q2, k2, v2 = _flash_inputs(dev, 2, 300, 300, 8, 2, 128, seed=3)
    for dst, src in ((q, q2), (k, k2), (v, v2)):
        dst.copy_(src)
    kv_len.copy_(torch.tensor([211, 300], dtype=torch.int32, device=dev))
    graph.replay()
    want = flash_attention_cuda(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_flash_kernel_on_two_streams(dev):
    """Calls on two CUDA streams at once both match their plain version."""
    from gofr_tpu_torch.ops.flash_attention import (flash_attention_cuda,
                                                    flash_attention_plain)

    inputs = [_flash_inputs(dev, 2, 700, 700, 32, 8, 128, seed=s)
              for s in (4, 5)]
    kv_len = torch.tensor([700, 333], dtype=torch.int32, device=dev)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(5):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs.append((i, flash_attention_cuda(*inputs[i], kv_len)))
    torch.cuda.synchronize()
    refs = [flash_attention_plain(*x, kv_len) for x in inputs]
    for i, out in outs:
        assert (out.float() - refs[i].float()).abs().max().item() <= TOL


@pytest.mark.parametrize("case", [
    # L, B, S, KV, D, n_rep, layer, kv_len (S + 1 = a row at capacity)
    (32, 4, 1024, 8, 128, 4, 7, [1, 1000, 1024, 1025]),
    (2, 3, 200, 2, 64, 2, 1, [5, 200, 130]),
    (2, 2, 64, 4, 16, 2, 1, [3, 65]),
])
def test_decode_kernel_matches_plain(dev, case):
    from gofr_tpu_torch.ops.decode_attention import (
        gqa_decode_attention_cuda, gqa_decode_attention_plain)

    L, B, S, KV, D, n_rep, layer, kvl = case
    g = torch.Generator(device=dev).manual_seed(1)
    kc, vc = _rnd(g, dev, L, B, S, KV, D), _rnd(g, dev, L, B, S, KV, D)
    q = _rnd(g, dev, B, 1, KV * n_rep, D)
    kv_len = torch.tensor(kvl, dtype=torch.int32, device=dev)
    out = gqa_decode_attention_cuda(q, kc, vc, kv_len, layer=layer)
    ref = gqa_decode_attention_plain(q, kc, vc, kv_len, layer=layer)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= TOL


@pytest.mark.parametrize("case", [
    # L, B, S, KV, D, n_rep, layer, kv_len (S + 1 = a row at capacity)
    (8, 8, 4096, 8, 128, 4, 7, [1, 129, 1000, 2048, 2049, 4000, 4096, 4097]),
    (2, 3, 256, 1, 128, 8, 1, [1, 256, 257]),
    (2, 3, 200, 2, 64, 4, 1, [1, 130, 201]),
    (2, 2, 64, 4, 16, 1, 0, [1, 65]),
])
def test_int8_decode_kernel_matches_plain(dev, case):
    from gofr_tpu_torch.ops import quantize_kv
    from gofr_tpu_torch.ops.decode_attention import (
        gqa_decode_attention_int8_cuda, gqa_decode_attention_int8_plain)

    L, B, S, KV, D, n_rep, layer, kvl = case
    g = torch.Generator(device=dev).manual_seed(2)

    def int8_cache():
        codes, scale = quantize_kv(torch.randn((L, B, S, KV, D), generator=g,
                                               device=dev))
        return (codes.reshape(L, B, S, KV * D),
                scale.transpose(2, 3).contiguous())

    (kc, ks), (vc, vs) = int8_cache(), int8_cache()
    q = _rnd(g, dev, B, 1, KV * n_rep, D)
    kv_len = torch.tensor(kvl, dtype=torch.int32, device=dev)
    n0 = gqa_decode_attention_int8_cuda.launches
    out = gqa_decode_attention_int8_cuda(q, kc, vc, kv_len, layer=layer,
                                         k_scale=ks, v_scale=vs)
    ref = gqa_decode_attention_int8_plain(q, kc, vc, kv_len, layer=layer,
                                          k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert gqa_decode_attention_int8_cuda.launches == n0 + 1
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= TOL


def _decode_inputs(dev, seed, L, B, S, KV, D, n_rep, int8):
    """Seeded stacked caches and a query: (q, caches, scale kwargs)."""
    from gofr_tpu_torch.ops import quantize_kv

    g = torch.Generator(device=dev).manual_seed(seed)
    q = _rnd(g, dev, B, 1, KV * n_rep, D)
    if not int8:
        return q, (_rnd(g, dev, L, B, S, KV, D), _rnd(g, dev, L, B, S, KV, D)), {}
    planes = []
    for _ in range(2):
        codes, scale = quantize_kv(torch.randn((L, B, S, KV, D), generator=g,
                                               device=dev))
        planes.append((codes.reshape(L, B, S, KV * D),
                       scale.transpose(2, 3).contiguous()))
    (kc, ks), (vc, vs) = planes
    return q, (kc, vc), {"k_scale": ks, "v_scale": vs}


def _decode_fns(int8):
    from gofr_tpu_torch.ops import decode_attention as da

    if int8:
        return da.gqa_decode_attention_int8_cuda, da.gqa_decode_attention_int8_plain
    return da.gqa_decode_attention_cuda, da.gqa_decode_attention_plain


def _edge_lens(dev, B, KV, S):
    """kv_len at the tile edges, the split edges, 1, 0, -1 (a uniform row),
    S_max and S_max + 1 (a row at capacity), as many as fit."""
    from gofr_tpu_torch.ops.decode_attention import TILE, split_plan

    span, _ = split_plan(B, KV, S, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    lens = [1, 0, -1, S, S + 1]
    for edge in (TILE, span, 2 * span):
        lens += [n for n in (edge - 1, edge, edge + 1) if 0 < n < S]
    return list(dict.fromkeys(lens))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("D", [16, 64, 128])
def test_decode_kernels_at_every_head_dim_and_edge(dev, int8, n_rep, D):
    """Both decode kernels against their plain versions at every head_dim
    and n_rep they take, one batch row per kv_len edge case."""
    kernel, plain = _decode_fns(int8)
    L, KV, S, layer = 2, 2, 300, 1
    lens = _edge_lens(dev, 16, KV, S)
    q, (kc, vc), sc = _decode_inputs(dev, 3, L, len(lens), S, KV, D, n_rep,
                                     int8)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    out = kernel(q, kc, vc, kv_len, layer=layer, **sc)
    ref = plain(q, kc, vc, kv_len, layer=layer, **sc)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= TOL


def _window_fns(int8):
    from gofr_tpu_torch.ops import decode_attention as da

    if int8:
        return da.gqa_decode_window_int8_cuda, da.gqa_decode_window_int8_plain
    return da.gqa_decode_window_cuda, da.gqa_decode_window_plain


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("W", [2, 5, 12])
def test_window_kernels_at_every_head_dim_and_edge(dev, int8, n_rep, D, W):
    """The verify window through the decode kernel against its plain
    version (JAX's ``attention`` with ``q_offset = kv_len - 1``) at every
    head_dim and n_rep, the kv_len edge cases a row, and windows of 8, 16
    and 32 query rows a launch and of several launches (W * n_rep above
    32: 12 positions at n_rep 4 and 8)."""
    from gofr_tpu_torch.ops.decode_attention import MAX_ROWS

    kernel, plain = _window_fns(int8)
    L, KV, S, layer = 2, 2, 300, 1
    lens = _edge_lens(dev, 16, KV, S)
    q1, (kc, vc), sc = _decode_inputs(dev, 3, L, len(lens), S, KV, D, n_rep,
                                      int8)
    g = torch.Generator(device=dev).manual_seed(30 + W)
    q = _rnd(g, dev, len(lens), W, KV * n_rep, D)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    n0 = kernel.launches
    out = kernel(q, kc, vc, kv_len, layer=layer, **sc)
    ref = plain(q, kc, vc, kv_len, layer=layer, **sc)
    torch.cuda.synchronize()
    per = MAX_ROWS // n_rep
    assert kernel.launches == n0 + -(-W // per)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= TOL


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_window_kernel_one_position_is_the_decode_launch(dev, int8):
    """W = 1 of the window entry is the decode kernel's own launch: the
    same instantiation on the same inputs, bit for bit."""
    window, _ = _window_fns(int8)
    kernel, _ = _decode_fns(int8)
    q, (kc, vc), sc = _decode_inputs(dev, 6, 4, 8, 2048, 8, 128, 4, int8)
    kv_len = torch.tensor([2000, 1, 2048, 2049, 65, 0, 1500, 777],
                          dtype=torch.int32, device=dev)
    out = window(q, kc, vc, kv_len, layer=3, **sc)
    ref = kernel(q, kc, vc, kv_len, layer=3, **sc)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_window_kernel_at_the_8b_verify_shape(dev, int8):
    """Llama-3-8B's verify window (K = 4: q [8, 5, 32, 128]) over a 2048
    cache with rows near capacity, and K = 9 split over two launches."""
    kernel, plain = _window_fns(int8)
    _, (kc, vc), sc = _decode_inputs(dev, 7, 2, 8, 2048, 8, 128, 4, int8)
    kv_len = torch.tensor([2000, 1, 2044, 2048, 2049, 17, 1024, 1999],
                          dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(8)
    for W, launches in ((5, 1), (10, 2)):
        q = _rnd(g, dev, 8, W, 32, 128)
        n0 = kernel.launches
        out = kernel(q, kc, vc, kv_len, layer=1, **sc)
        ref = plain(q, kc, vc, kv_len, layer=1, **sc)
        torch.cuda.synchronize()
        assert kernel.launches == n0 + launches
        assert (out.float() - ref.float()).abs().max().item() <= TOL


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("kvl", [4096, 3000, 65])
def test_decode_kernels_one_long_row(dev, int8, kvl):
    """B = 1 with a long row: the grid splits the one row over many CTAs
    and the last of them merges."""
    kernel, plain = _decode_fns(int8)
    q, (kc, vc), sc = _decode_inputs(dev, 4, 2, 1, 4096, 8, 128, 4, int8)
    kv_len = torch.tensor([kvl], dtype=torch.int32, device=dev)
    out = kernel(q, kc, vc, kv_len, layer=1, **sc)
    ref = plain(q, kc, vc, kv_len, layer=1, **sc)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= TOL


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_decode_kernels_back_to_back_calls_reset_the_merge(dev, int8):
    """20 calls in a row on alternating layers, without a sync between
    them, each match: no state carries from one call to the next."""
    kernel, plain = _decode_fns(int8)
    q, (kc, vc), sc = _decode_inputs(dev, 5, 2, 4, 1024, 8, 128, 4, int8)
    kv_len = torch.tensor([1000, 1024, 1025, 517], dtype=torch.int32,
                          device=dev)
    n0 = kernel.launches
    outs = [kernel(q, kc, vc, kv_len, layer=i % 2, **sc) for i in range(20)]
    assert kernel.launches == n0 + 20
    refs = [plain(q, kc, vc, kv_len, layer=layer, **sc) for layer in (0, 1)]
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        assert (out.float() - refs[i % 2].float()).abs().max().item() <= TOL


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_decode_kernels_on_two_streams(dev, int8):
    """Calls on two CUDA streams at once both match: the kernels keep no
    state between calls that two streams could share."""
    kernel, plain = _decode_fns(int8)
    q, (kc, vc), sc = _decode_inputs(dev, 6, 2, 8, 2048, 8, 128, 4, int8)
    kv_len = torch.tensor([2000, 1, 2048, 700, 1500, 64, 65, 2049],
                          dtype=torch.int32, device=dev)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(5):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs.append((i, kernel(q, kc, vc, kv_len, layer=i, **sc)))
    torch.cuda.synchronize()
    refs = [plain(q, kc, vc, kv_len, layer=layer, **sc) for layer in (0, 1)]
    torch.cuda.synchronize()
    for layer, out in outs:
        assert (out.float() - refs[layer].float()).abs().max().item() <= TOL


def test_int8_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from gofr_tpu_torch.ops.decode_attention import (
        gqa_decode_attention_int8_cuda)

    q = torch.zeros((1, 1, 4, 16), dtype=torch.bfloat16, device=dev)
    vals = torch.zeros((2, 1, 8, 32), dtype=torch.int8, device=dev)
    sc = torch.zeros((2, 1, 2, 8), dtype=torch.bfloat16, device=dev)
    kv_len = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="torch.int8"):
        gqa_decode_attention_int8_cuda(q, vals.bfloat16(), vals.bfloat16(),
                                       kv_len, k_scale=sc, v_scale=sc)
    with pytest.raises(ValueError, match="bfloat16"):
        gqa_decode_attention_int8_cuda(q, vals, vals, kv_len,
                                       k_scale=sc.float(), v_scale=sc.float())
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((2, 1, 8, 2), dtype=torch.bfloat16,
                        device=dev).transpose(2, 3)
        gqa_decode_attention_int8_cuda(q, vals, vals, kv_len, k_scale=t,
                                       v_scale=t)
    with pytest.raises(ValueError, match="head_dim"):
        gqa_decode_attention_int8_cuda(
            torch.zeros((1, 1, 4, 8), dtype=torch.bfloat16, device=dev),
            vals[..., :16].contiguous(), vals[..., :16].contiguous(), kv_len,
            k_scale=sc, v_scale=sc)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from gofr_tpu_torch.ops.decode_attention import gqa_decode_attention_cuda
    from gofr_tpu_torch.ops.flash_attention import flash_attention_cuda

    def zeros(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device=dev)

    kv = zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention_cuda(zeros(1, 8, 4, 16, dtype=torch.float32), kv, kv)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(zeros(1, 4, 8, 16).transpose(1, 2), kv, kv)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_cuda(zeros(1, 8, 4, 8), zeros(1, 8, 2, 8),
                             zeros(1, 8, 2, 8))
    # contiguous, but 2 bytes past a 16-byte boundary: TMA cannot load it
    buf = zeros(1 + 8 * 4 * 16)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_cuda(buf[1:].view(1, 8, 4, 16), kv, kv)
    cache = zeros(2, 1, 8, 2, 16)
    with pytest.raises(ValueError, match="layer"):
        gqa_decode_attention_cuda(zeros(1, 1, 4, 16), cache, cache,
                                  torch.ones(1, dtype=torch.int32, device=dev),
                                  layer=3)


def test_tiny_generator_on_the_card_matches_plain_path(dev):
    """The tiny model served on the card through the kernels gives the
    greedy tokens the same weights give on the CPU's plain path, for the
    first tokens (bf16: a near-tie may flip later ones)."""
    from gofr_tpu_torch.ml.generate import Generator
    from gofr_tpu_torch.models import llama

    cfg = llama.tiny_llama()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    on_card = {k: (v.to(dev) if not isinstance(v, dict)
                   else {n: t.to(dev) for n, t in v.items()})
               for k, v in params.items()}
    prompt = np.arange(1, 12).tolist()
    kw = dict(batch_slots=2, max_seq=64, prefill_buckets=(16,), chunk=4)
    cpu = Generator(params, cfg, device="cpu", **kw).generate(prompt, 4)
    card = Generator(on_card, cfg, device=dev, **kw).generate(prompt, 4)
    assert card[:2] == cpu[:2]


def test_tiny_int8_generator_on_the_card_matches_plain_path(dev):
    """kv_quant + w8 on the card: warmup and decode launch the int8 kernel
    and never the fp one, and the greedy tokens are the CPU plain path's
    for the first tokens (bf16)."""
    from gofr_tpu_torch.ml.generate import Generator
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.ops.decode_attention import (
        gqa_decode_attention_cuda, gqa_decode_attention_int8_cuda)

    cfg = llama.tiny_llama(kv_quant=True, w8=True)
    params = llama.params_from_config(cfg, seed=0, device="cpu")
    prompt = np.arange(1, 12).tolist()
    kw = dict(batch_slots=2, max_seq=64, prefill_buckets=(16,), chunk=4)
    cpu = Generator(params, cfg, device="cpu", **kw).generate(prompt, 4)
    gen = Generator(_to(params, dev), cfg, device=dev, **kw)
    fp0, q0 = (gqa_decode_attention_cuda.launches,
               gqa_decode_attention_int8_cuda.launches)
    gen.warmup()
    assert gqa_decode_attention_int8_cuda.launches > q0
    card = gen.generate(prompt, 4)
    assert gqa_decode_attention_cuda.launches == fp0
    assert card[:2] == cpu[:2]


# -- the paged path and chunked prefill through the kernels ------------------------

def _attention_probe(monkeypatch, llama, name, plain):
    """Wrap the dispatcher ``name`` the model calls: each call runs the
    kernel (the real dispatcher) and ``plain(...)`` on the same inputs;
    returns the list of (kwargs, max abs error) it fills."""
    kernel = getattr(llama, name)
    seen = []

    def probe(*args, **kw):
        out = kernel(*args, **kw)
        ref = plain(*args, **kw)
        seen.append((kw, (out.float() - ref.float()).abs().max().item()))
        return out

    monkeypatch.setattr(llama, name, probe)
    return seen


def _tiny_on_card(dev, **kw):
    from gofr_tpu_torch.models import llama

    cfg = llama.tiny_llama(max_seq_len=512, **kw)
    params = llama.params_from_config(cfg, seed=0, device="cpu")
    return llama, cfg, _to(params, dev)


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_paged_decode_step_kernels_match_plain(dev, monkeypatch, kv_bits):
    """paged_decode_step on the card: each layer's attention over the
    gathered pages goes through ONE decode kernel (the int8 one for int8
    pages with their scales transposed to [B, KV, S]; the bf16 one for
    bf16 pages and for int4 pages dequantized) and agrees with the plain
    version on the same gathered inputs; a row at virtual capacity writes
    only scratch page 0."""
    from gofr_tpu_torch.ops import decode_attention as da

    llama, cfg, params = _tiny_on_card(
        dev, **({} if kv_bits == 16 else {"kv_bits": kv_bits}))
    ps, p_max = 16, 8
    pool = llama.init_paged_cache(cfg, 3, 1 + 3 * p_max, ps, device=dev)
    table = np.arange(1, 1 + 3 * p_max, dtype=np.int32).reshape(3, p_max)
    r = np.random.default_rng(0)
    for slot, n in enumerate((37, 100)):
        toks = np.zeros((1, 128), np.int32)
        toks[0, :n] = r.integers(0, cfg.vocab_size, n)
        llama.paged_prefill_into(params, toks, [n], cfg, pool, table[slot],
                                 slot, ps)
    pool["len"][2] = p_max * ps  # row 2 sits at virtual capacity

    def plain(q, k, v, kv_len, **scales):
        if scales:
            return da.gqa_decode_attention_int8_plain(q, k, v, kv_len,
                                                      **scales)
        return da.gqa_decode_attention_plain(q, k, v, kv_len)

    seen = _attention_probe(monkeypatch, llama, "cached_decode_attention",
                            plain)
    row2 = {k: v[:, table[2]].clone() for k, v in pool.items() if k != "len"}
    int8 = kv_bits == 8
    kern, other = ((da.gqa_decode_attention_int8_cuda,
                    da.gqa_decode_attention_cuda) if int8 else
                   (da.gqa_decode_attention_cuda,
                    da.gqa_decode_attention_int8_cuda))
    n0, o0 = kern.launches, other.launches
    tok = torch.tensor([1, 2, 3], dtype=torch.int32, device=dev)
    tdev = torch.from_numpy(table).to(dev)
    for n_cols in (8, 8, 8):
        logits, pool = llama.paged_decode_step(params, tok, pool, tdev, cfg,
                                               n_cols=n_cols)
        tok = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    assert kern.launches - n0 == 3 * cfg.n_layers and other.launches == o0
    assert len(seen) == 3 * cfg.n_layers
    assert max(err for _, err in seen) <= TOL
    assert bool(torch.isfinite(logits).all())
    assert pool["len"].tolist() == [40, 103, p_max * ps]
    for key, was in row2.items():
        assert torch.equal(pool[key][:, table[2]], was), key


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_suffix_prefill_through_flash_with_offset_matches_plain(
        dev, monkeypatch, kv_bits):
    """A suffix after a registered prefix and a later chunked-prefill
    segment (paged, bf16 / int8 / int4 pages) launch the flash kernel with
    q_offset > 0 and Tq < Tk over the gathered, dequantized pages, and it
    agrees with the plain version on the same inputs; the generator's
    greedy tokens on the card match the CPU plain path's first tokens."""
    from gofr_tpu_torch.ml.generate import Generator
    from gofr_tpu_torch.ops.flash_attention import flash_attention_plain

    llama, cfg, params = _tiny_on_card(
        dev, **({} if kv_bits == 16 else {"kv_bits": kv_bits}))
    seen = _attention_probe(
        monkeypatch, llama, "flash_attention",
        lambda q, k, v, *, causal=True, q_offset=0, kv_len=None:
        flash_attention_plain(q, k, v, kv_len, causal=causal,
                              q_offset=q_offset))
    kw = dict(batch_slots=2, max_seq=256, prefill_buckets=(32, 128),
              chunk=2, page_size=16, prefill_chunk=64)
    gen = Generator(params, cfg, device=dev, **kw)
    prefix = np.arange(1, 41).tolist()  # 32 shared + an 8-token tail
    pid = gen.register_prefix(prefix)
    got = {}
    gen.add_request([5, 6, 7], 4, lambda i, t: got.setdefault(0, []).extend(t),
                    prefix=pid)
    long_prompt = (np.arange(150) % 300 + 3).tolist()
    gen.add_request(long_prompt, 4,
                    lambda i, t: got.setdefault(1, []).extend(t))
    while gen.n_live:
        gen.step()
    gen.drain()
    offsets = [kw_["q_offset"] for kw_, _ in seen
               if kw_.get("q_offset", 0) > 0]
    assert 32 in offsets and {64, 128} <= set(offsets)
    assert max(err for _, err in seen) <= TOL
    cpu_params = llama.params_from_config(cfg, seed=0, device="cpu")
    ref = Generator(cpu_params, cfg, device="cpu", **kw)
    ref_pid = ref.register_prefix(prefix)
    assert ref.generate(long_prompt, 4)[:2] == got[1][:2]
    slot = ref.add_request([5, 6, 7], 4, prefix=ref_pid)
    while ref.slots[slot].live:
        ref.step()
    ref.drain()
    assert ref.slots[slot].tokens[:2] == got[0][:2]


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_dense_segment_prefill_through_flash_matches_plain(dev, monkeypatch,
                                                           kv_quant):
    """The dense prefill_segment_into on the card: the later segments
    launch flash with q_offset > 0 over the slot's row (int8: dequantized
    first), agree with the plain version on the same inputs, and the
    chunked generator's first greedy tokens match the CPU plain path."""
    from gofr_tpu_torch.ml.generate import Generator
    from gofr_tpu_torch.ops.flash_attention import flash_attention_plain

    llama, cfg, params = _tiny_on_card(dev, kv_quant=kv_quant)
    seen = _attention_probe(
        monkeypatch, llama, "flash_attention",
        lambda q, k, v, *, causal=True, q_offset=0, kv_len=None:
        flash_attention_plain(q, k, v, kv_len, causal=causal,
                              q_offset=q_offset))
    kw = dict(batch_slots=2, max_seq=256, prefill_buckets=(32, 128),
              chunk=2, prefill_chunk=64)
    prompt = (np.arange(150) % 300 + 3).tolist()
    card = Generator(params, cfg, device=dev, **kw).generate(prompt, 4)
    offsets = {kw_.get("q_offset", 0) for kw_, _ in seen}
    assert {64, 128} <= offsets
    assert max(err for _, err in seen) <= TOL
    cpu_params = llama.params_from_config(cfg, seed=0, device="cpu")
    cpu = Generator(cpu_params, cfg, device="cpu", **kw).generate(prompt, 4)
    assert card[:2] == cpu[:2]


# -- decode dispatches as CUDA graphs ----------------------------------------------

def _graph_gen(dev, kv_bits, **kw):
    """A tiny generator on the card (bf16) with two live rows of 20 and 45
    tokens, their first tokens folded in: ready for a decode dispatch."""
    from gofr_tpu_torch.ml.generate import Generator

    paged = kv_bits is not None
    llama, cfg, params = _tiny_on_card(
        dev, **({"kv_bits": kv_bits} if kv_bits in (8, 4) else {}))
    opts = dict(batch_slots=2, max_seq=256, prefill_buckets=(64,), chunk=4,
                token_budget=0)
    if paged:
        opts["page_size"] = 16
    opts.update(kw)
    gen = Generator(params, cfg, device=dev, **opts)
    r = np.random.default_rng(0)
    for n in (20, 45):
        gen.add_request(r.integers(0, cfg.vocab_size, n).tolist(), 64)
    gen.step()  # the mini-chunk: folds the first tokens in
    return gen


def _state(gen):
    return ({k: v.clone() for k, v in gen.cache.items()},
            gen._tok_dev.clone())


def _set_state(gen, state):
    cache, tok = state
    for k, v in cache.items():
        gen.cache[k].copy_(v)
    gen._tok_dev.copy_(tok)


@pytest.mark.parametrize("kv_bits", [None, 16, 8, 4],
                         ids=["dense", "paged-bf16", "paged-int8",
                              "paged-int4"])
def test_decode_graph_replay_equals_eager(dev, kv_bits):
    """One 4-step decode dispatch replayed from its CUDA graph and run
    eagerly through the same kernels from the same state: the same tokens,
    the same first-step logits, the same cache afterwards; the graph's
    replays count their decode-kernel launches."""
    from gofr_tpu_torch.ops import decode_attention as da

    gen = _graph_gen(dev, kv_bits)
    n_cols = gen._gather_cols() if gen.page_size else None
    state = _state(gen)
    kern = (da.gqa_decode_attention_int8_cuda if kv_bits == 8
            else da.gqa_decode_attention_cuda)
    n0 = kern.launches
    block = gen._decode_chunk(4, n_cols).clone()
    logits = gen.dispatch_logits.clone()
    torch.cuda.synchronize()
    assert kern.launches - n0 == 4 * gen.cfg.n_layers
    assert ("chunk", 4, n_cols) in gen._graphs
    after = _state(gen)
    _set_state(gen, state)
    eager, eager_logits = gen._chunk_body(4, n_cols)
    torch.cuda.synchronize()
    assert torch.equal(block, eager)
    assert torch.equal(logits, eager_logits)
    for k, v in after[0].items():
        assert torch.equal(gen.cache[k], v), k


@pytest.mark.parametrize("kv_bits,window,draft", [
    (None, 0, False), (None, 0, True), (16, 0, False), (8, 4, False),
    (4, 4, False)],
    ids=["dense", "dense-draft", "paged-bf16", "paged-int8-window",
         "paged-int4-window"])
def test_spec_graph_replay_equals_eager(dev, kv_bits, window, draft):
    """A speculative dispatch of 2 verify windows (K = 3; fused windows
    where set, a self draft where set) replayed from its CUDA graph and
    run eagerly from the same state: the same packed block, the same
    first logits, the same cache, history rows and draft cache; the
    replay counts its window-kernel launches (the draft's decode launches
    too). Then the same tiny generator serves the CPU plain path's first
    greedy tokens."""
    from gofr_tpu_torch.ml.generate import Generator
    from gofr_tpu_torch.ops import decode_attention as da

    extra = dict(spec_k=3, decode_window=window)
    if draft:
        llama, cfg, params = _tiny_on_card(dev)
        extra.update(draft_params=params, draft_cfg=cfg)
    gen = _graph_gen(dev, kv_bits, **extra)
    n_cols = gen._gather_cols() if gen.page_size else None
    b = gen.batch_slots
    mask = np.ones((b,), bool)
    cap = np.full((b,), 6, np.int32)
    kern = (da.gqa_decode_window_int8_cuda if kv_bits == 8
            else da.gqa_decode_window_cuda)

    def state():
        out = {k: v.clone() for k, v in gen.cache.items()}
        out["tok"] = gen._tok_dev.clone()
        out["hist"] = gen._tokens_dev.clone()
        for k, v in getattr(gen, "_draft_cache", {}).items():
            out[f"draft_{k}"] = v.clone()
        return out

    def restore(saved):
        for k, v in gen.cache.items():
            v.copy_(saved[k])
        gen._tok_dev.copy_(saved["tok"])
        gen._tokens_dev.copy_(saved["hist"])
        for k, v in getattr(gen, "_draft_cache", {}).items():
            v.copy_(saved[f"draft_{k}"])

    before = state()
    n0, d0 = kern.launches, da.gqa_decode_attention_cuda.launches
    block = gen._decode_spec(2, mask, mask, cap, n_cols).clone()
    logits = gen.dispatch_logits.clone()
    torch.cuda.synchronize()
    assert kern.launches - n0 == 2 * gen.cfg.n_layers
    if draft:  # 4 draft steps a window
        assert da.gqa_decode_attention_cuda.launches - d0 \
            == 2 * 4 * gen.cfg.n_layers
    after = state()
    restore(before)
    eager, eager_logits = gen._spec_body(2, n_cols, bool(window))
    torch.cuda.synchronize()
    assert torch.equal(block, eager)
    assert torch.equal(logits, eager_logits)
    now = state()
    for k, v in after.items():
        assert torch.equal(now[k], v), k
    # served end to end: the CPU plain path's first greedy tokens
    llama, cfg, params = _tiny_on_card(
        dev, **({"kv_bits": kv_bits} if kv_bits in (8, 4) else {}))
    kw = dict(batch_slots=2, max_seq=256, prefill_buckets=(64,), chunk=4,
              spec_k=3, decode_window=window)
    if kv_bits is not None:
        kw["page_size"] = 16
    prompt = (np.arange(40) % 7 + 3).tolist()
    card = Generator(params, cfg, device=dev, **kw,
                     **({"draft_params": params, "draft_cfg": cfg}
                        if draft else {})).generate(prompt, 8)
    cpu_params = llama.params_from_config(cfg, seed=0, device="cpu")
    cpu = Generator(cpu_params, cfg, device="cpu", **kw,
                    **({"draft_params": cpu_params, "draft_cfg": cfg}
                       if draft else {})).generate(prompt, 8)
    assert card[:2] == cpu[:2]


def test_two_dispatches_in_flight_keep_their_blocks(dev):
    """The pipeline's two blocks: one graph replayed twice before either
    block is read (each block's copy to the host is enqueued right after
    its replay) gives the two halves of an eager 8-step run; a pipelined
    generator serves the tokens of a lag-one one."""
    from gofr_tpu_torch.ml.generate import _HostBlock

    gen = _graph_gen(dev, 16)
    n_cols = gen._gather_cols()
    state = _state(gen)
    first = _HostBlock(gen._decode_chunk(4, n_cols))
    second = _HostBlock(gen._decode_chunk(4, n_cols))
    got = np.concatenate([first.numpy(), second.numpy()[1:]])
    _set_state(gen, state)
    want, _ = gen._chunk_body(8, n_cols)
    np.testing.assert_array_equal(got, want.cpu().numpy())

    outs = {}
    for pipeline in (0, 1):
        gen = _graph_gen(dev, 16, pipeline=pipeline)
        while gen.n_live:
            gen.step()
        gen.drain()
        outs[pipeline] = [s.tokens for s in gen.slots]
        assert (pipeline == 0) == (gen.pipeline_stats() is None)
    assert outs[0] == outs[1]


def test_sampled_graph_draws_differ_between_replays(dev):
    """Temperature sampling inside a graph: the generator's own
    torch.Generator is registered with the graph, so two replays from the
    same state draw different tokens (at T=1 over the tiny model's
    near-flat logits, 2 rows x 4 steps all equal has probability ~0)."""
    from gofr_tpu_torch.ml.generate import Sampler

    gen = _graph_gen(dev, 16, sampler=Sampler(temperature=1.0))
    n_cols = gen._gather_cols()
    state = _state(gen)
    a = gen._decode_chunk(4, n_cols).clone()
    _set_state(gen, state)
    b = gen._decode_chunk(4, n_cols).clone()
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and not torch.equal(a[1:], b[1:])


def test_capture_failure_raises_without_eager_fallback(dev, monkeypatch):
    """A dispatch whose body cannot be captured (a host sync inside it)
    raises from step(); nothing falls back to the eager loop, and no graph
    is kept for it."""
    from gofr_tpu_torch.ml import generate

    gen = _graph_gen(dev, 16)
    real = generate._sample_impl

    def syncing(logits, rng, sampler):
        logits.sum().item()  # a host sync: illegal while capturing
        return real(logits, rng, sampler)

    monkeypatch.setattr(generate, "_sample_impl", syncing)
    steps = gen.steps
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        gen.step()
    assert gen.steps == steps and len(gen._graphs) == 1  # the mini-chunk's


# -- the model engine's graph path ---------------------------------------------

def _engine_models(dev):
    """The three engine models at tiny widths on the card, the DiT's
    ``ada_w`` and ``patch_out`` perturbed (zero, they hide the trunk)."""
    from gofr_tpu_torch.examples import sdxl_server
    from gofr_tpu_torch.models import bert, diffusion, mlp

    dit = diffusion.DiT(diffusion.tiny_dit(), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    for tree, key in ((dit.params, "patch_out"), (dit.params["layers"], "ada_w")):
        tree[key].copy_(torch.randn(tree[key].shape, generator=g,
                                    device=dev) * 0.02)
    # the example's sampler: its noise drawn once a batch shape, before
    # the capture (a generator cannot be made inside one)
    sample = sdxl_server._sampler(dit.cfg, steps=3)

    m = mlp.mnist_mlp(64, device=dev)
    b = bert.Bert(bert.tiny_bert(), device=dev)
    rng = np.random.default_rng(0)
    return {
        "mlp": (m.apply, m.params,
                lambda n: [rng.random((n, 784), dtype=np.float32)]),
        "bert": (b.apply, b.params,
                 lambda n: [rng.integers(0, 256, (n, 16)).astype(np.int32),
                            rng.integers(1, 17, n).astype(np.int32)]),
        "dit": (sample, dit.params,
                lambda n: [rng.standard_normal((n, 5, 32)).astype(np.float32)]),
    }


@pytest.mark.parametrize("model", ["mlp", "bert", "dit"])
def test_engine_graph_replay_equals_eager(dev, model):
    """Each bucket's captured graph, replayed on fresh inputs, equals the
    eager apply on the same inputs bit for bit; a second shape of the same
    batch is a second graph; the row records the capture."""
    from gofr_tpu_torch.ml import Engine, EngineConfig

    apply, params, inputs = _engine_models(dev)[model]
    engine = Engine(model, apply, params, device=dev,
                    config=EngineConfig(batch_buckets=(1, 4)),
                    example_inputs=tuple(x[:1] for x in inputs(1)))
    try:
        engine.warmup_buckets()
        assert len(engine.graphs) == 2
        for n in (1, 4, 4):
            xs = inputs(n)
            got = engine.predict_sync(*xs)
            want = apply(engine.params, *(torch.from_numpy(x).to(dev)
                                          for x in xs))
            want = want.float().cpu().numpy()
            assert np.array_equal(got, want)
        rows = {r["name"]: r for r in engine.programs.snapshot()}
        assert set(rows) == {"apply/b1", "apply/b4"}
        assert all(r["kind"] == "graph" and r["wall_s"] > 0
                   for r in rows.values())
    finally:
        engine.close()


def test_engine_keeps_the_callers_tensor_and_serves_bf16_as_f32(dev):
    from gofr_tpu_torch.ml import Engine, EngineConfig

    engine = Engine("toy", lambda p, x: (x * p).to(torch.bfloat16),
                    torch.tensor(3.0, device=dev), device=dev,
                    config=EngineConfig(donate_inputs=True))
    try:
        x = torch.arange(8.0, device=dev).reshape(2, 4)
        for _ in range(2):
            out = engine.predict_sync(x)
            assert out.dtype == np.float32
            assert np.array_equal(out, 3 * np.arange(8.0).reshape(2, 4))
        assert torch.equal(x, torch.arange(8.0, device=dev).reshape(2, 4))
        assert engine.memory_stats()["bytes_in_use"] > 0
    finally:
        engine.close()


def test_engine_capture_failure_raises_without_eager_fallback(dev):
    """An apply that syncs the host cannot be captured: the execute raises
    naming the shape, and nothing runs eagerly in its place."""
    from gofr_tpu_torch.ml import Engine

    calls = []

    def apply(p, x):
        calls.append(torch.cuda.is_current_stream_capturing())
        return x * float(x.sum())  # .item() under capture: refused

    engine = Engine("bad", apply, torch.tensor(1.0, device=dev), device=dev)
    try:
        with pytest.raises(RuntimeError, match="CUDA graph capture"):
            engine.predict_sync(np.ones((2, 3), np.float32))
        assert calls == [False, True]  # the warm run, the capture; no replay
        assert engine.steps == 0 and not engine.graphs
    finally:
        engine.close()


def test_pool_replicas_on_one_card_share_weights(dev):
    """Two replicas of a ``ReplicaPool`` on ``cuda:0`` share the weight
    tensors (no copy) and each owns its page pool and decode graphs; the
    disaggregated path ships the prefix through the host tier and both
    replicas' greedy tokens equal a single server's on the same prompts."""
    import asyncio

    from gofr_tpu_torch.ml.generate import Generator
    from gofr_tpu_torch.ml.llm import LLMServer
    from gofr_tpu_torch.ml.replica import (ReplicaPool,
                                           build_replica_generators)

    _, cfg, params = _tiny_on_card(dev)
    opts = dict(batch_slots=2, max_seq=256, prefill_buckets=(64,), chunk=4,
                page_size=16, n_pages=64)
    gens = build_replica_generators(params, cfg, 2, devices=[dev], **opts)
    assert gens[0].params is params and gens[1].params is params
    assert gens[0].cache["k"].data_ptr() != gens[1].cache["k"].data_ptr()
    r = np.random.default_rng(1)
    long, short = (r.integers(0, cfg.vocab_size, n).tolist() for n in (41, 9))
    single = LLMServer(Generator(params, cfg, device=dev, **opts))
    pool = ReplicaPool(gens, name="card-pool", disagg=True)

    async def both():
        # the single server computes the split the pool ships: 32 tokens
        # of whole pages registered, the rest prefilled over them
        pid = await asyncio.to_thread(single.register_prefix, long[:40])
        want = [await single.generate(long[40:], 12, prefix=pid),
                await single.generate(short, 12)]
        got = [await pool.generate(long, 12), await pool.generate(short, 12)]
        return want, got

    try:
        want, got = asyncio.run(both())
        assert got == want
        snap = pool.routing_snapshot()["disagg"]
        assert snap["ships"] == snap["lands"] == 1 and snap["failures"] == 0
        assert pool.replicas[1].gen.kv_restores == 1
        assert all(c.gen.graph_stats()["graphs"] for c in pool.replicas)
    finally:
        pool.close()
        single.close()


def test_scale_up_capture_beside_a_serving_replica(dev):
    """A scale-up builds, warms and captures a replica's decode graphs
    on a side stream while the other replica replays its own: no request
    fails and a fixed prompt's tokens are the same before, during and
    after the scale event."""
    import asyncio
    import threading

    from gofr_tpu_torch.ml.generate import Generator
    from gofr_tpu_torch.ml.replica import ReplicaPool

    _, cfg, params = _tiny_on_card(dev)
    opts = dict(batch_slots=2, max_seq=256, prefill_buckets=(64,), chunk=4,
                page_size=16, n_pages=64)

    def spawn(idx):
        gen = Generator(params, cfg, device=dev, **opts)
        gen.warmup()
        return gen

    first = spawn(0)
    pool = ReplicaPool([first], name="card-elastic", spawn=spawn)
    fixed = list(range(3, 40))

    async def scenario():
        before = await pool.generate(fixed, 16)
        scaler = threading.Thread(target=pool.scale_to, args=(2,))
        scaler.start()
        during = []
        while scaler.is_alive():
            during.append(await pool.generate(fixed, 16))
        scaler.join()
        after = await asyncio.gather(*(pool.generate(fixed, 16)
                                       for _ in range(4)))
        return before, during, after

    try:
        before, during, after = asyncio.run(scenario())
        assert pool.fleet_size() == 2
        assert during and all(o == before for o in during)
        assert all(o == before for o in after)
        assert pool.replicas[1].gen.graph_stats()["graphs"]
    finally:
        pool.close()


@pytest.mark.parametrize("case", [
    # B, T, H, KV, D, kv_len, q_offset
    (2, 200, 8, 2, 128, [200, 150], 0),
    (1, 96, 4, 4, 16, None, 0),
    (1, 64, 4, 2, 64, [120], 64),
])
def test_flash_under_autograd_is_the_kernel_forward_and_plain_backward(
        dev, case):
    """``ops.flash_attention`` on inputs that require grad goes through
    ``_FlashDiff``: one kernel launch forward, and a backward that is the
    plain version's vjp on the same inputs (bit for bit)."""
    from gofr_tpu_torch.ops import flash_attention
    from gofr_tpu_torch.ops.flash_attention import (flash_attention_cuda,
                                                    flash_attention_plain)

    B, T, H, KV, D, kvl, off = case
    Tk = T + off
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (_rnd(g, dev, B, T, H, D), _rnd(g, dev, B, Tk, KV, D),
               _rnd(g, dev, B, Tk, KV, D))
    kv_len = (None if kvl is None
              else torch.tensor(kvl, dtype=torch.int32, device=dev))
    up = _rnd(g, dev, B, T, H, D)
    grads = {}
    for name in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        n0 = flash_attention_cuda.launches
        if name == "kernel":
            out = flash_attention(*leaves, causal=True, q_offset=off,
                                  kv_len=kv_len)
            assert flash_attention_cuda.launches == n0 + 1
            assert out.grad_fn is not None
        else:
            out = flash_attention_plain(*leaves, kv_len, causal=True,
                                        q_offset=off)
        out.backward(up)
        assert flash_attention_cuda.launches == n0 + (name == "kernel")
        grads[name] = (out.detach(), [t.grad for t in leaves])
    (ko, kg), (po, pg) = grads["kernel"], grads["plain"]
    assert (ko.float() - po.float()).abs().max().item() <= TOL
    for a, b in zip(kg, pg):
        assert torch.equal(a, b)
    # with grad off the serving path launches the kernel directly
    with torch.no_grad():
        assert flash_attention(q, k, v, causal=True, q_offset=off,
                               kv_len=kv_len).grad_fn is None


def test_tiny_training_through_the_kernel_matches_plain(dev, monkeypatch):
    """The card-side twin of ``chip_smoke.py`` phase 15(c), on the tiny bf16
    model with ``remat``: loss and every gradient leaf through the flash
    kernel (``_FlashDiff``) against the plain attention, loss within 1e-2
    relative and each leaf's gradient cosine >= 0.99; the kernel launches
    twice a layer a step (forward and the remat recompute); then a
    ``Trainer`` fed by a ``DataLoader`` on the card lowers the loss over a
    repeated batch."""
    import functools

    from gofr_tpu_torch.ml.data import DataLoader
    from gofr_tpu_torch.ml.train import Trainer, _value_and_grad
    from gofr_tpu_torch.ml.tree import tree_leaves
    from gofr_tpu_torch.ops.flash_attention import (flash_attention_cuda,
                                                    flash_attention_plain)

    llama, cfg, params = _tiny_on_card(dev, remat=True)
    r = np.random.default_rng(0)
    toks = r.integers(0, cfg.vocab_size, (2, 128)).astype(np.int32)
    tgts = np.roll(toks, -1, axis=1)
    mask = np.ones_like(toks)
    mask[:, -1] = 0
    batch = [torch.from_numpy(a).to(dev) for a in (toks, tgts, mask)]
    loss_fn = functools.partial(llama.loss_fn, cfg=cfg)

    n0 = flash_attention_cuda.launches
    k_loss, k_grads = _value_and_grad(loss_fn, params, *batch)
    assert flash_attention_cuda.launches - n0 == 2 * cfg.n_layers
    monkeypatch.setattr(llama, "flash_attention",
                        lambda q, k, v, *, causal=True, kv_len=None:
                        flash_attention_plain(q, k, v, kv_len,
                                              causal=causal))
    p_loss, p_grads = _value_and_grad(loss_fn, params, *batch)
    monkeypatch.undo()
    assert abs(k_loss.item() - p_loss.item()) <= 1e-2 * abs(p_loss.item())
    for a, b in zip(tree_leaves(k_grads), tree_leaves(p_grads)):
        cos = torch.nn.functional.cosine_similarity(
            a.float().flatten(), b.float().flatten(), dim=0).item()
        assert cos >= 0.99, cos

    records = [{"t": toks[i], "y": tgts[i], "m": mask[i]} for i in range(2)]
    loader = DataLoader(lambda: iter(records), batch_size=2, repeat=True,
                        prefetch=2, device=dev)
    trainer = Trainer(lambda p, t, y, m: llama.loss_fn(p, t, y, m, cfg),
                      params, learning_rate=1e-2)
    it = iter(loader)
    losses = []
    for _ in range(4):
        b = next(it)
        assert b["t"].device.type == "cuda"
        losses.append(trainer.step(b["t"], b["y"], b["m"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


_MESH_RANK = r"""
import sys
import torch

from gofr_tpu_torch.ml.multihost import MultiHostWorker
from gofr_tpu_torch.models import llama

pid, coord, port = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
w = MultiHostWorker(pid, 2, coord, port=port if pid == 0 else 0,
                    cfg=llama.tiny_llama(max_seq_len=512), batch_slots=4,
                    max_seq=256, prompt_bucket=64, chunk=4, heartbeat_s=1.0)
w.run()
print(f"OK proc={pid} device={w.device}", flush=True)
"""


def test_mesh_ranks_share_one_card(dev, tmp_path):
    """Two ``MultiHostWorker`` ranks over gloo on ``cuda:0`` (one rank a
    card, round-robin past the card count): each request's tokens equal
    an in-process Generator of the rank's shape over the same seed-0
    weights, concurrent requests all finish, and both ranks exit clean on
    ``shutdown_workers``."""
    import asyncio
    import os
    import socket
    import subprocess
    import sys

    from gofr_tpu_torch.ml.generate import Generator
    from gofr_tpu_torch.ml.multihost import MultiHostLLMClient
    from gofr_tpu_torch.models import llama

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    coord, port = f"127.0.0.1:{free_port()}", free_port()
    script = tmp_path / "rank.py"
    script.write_text(_MESH_RANK)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    logs = [open(tmp_path / f"r{i}.log", "w+") for i in range(2)]
    procs = [subprocess.Popen([sys.executable, str(script), str(i), coord,
                               str(port)], stdout=logs[i],
                              stderr=subprocess.STDOUT, env=env, cwd=root)
             for i in range(2)]
    cfg = llama.tiny_llama(max_seq_len=512)
    gen = Generator(llama.params_from_config(cfg, seed=0, device=dev), cfg,
                    batch_slots=2, max_seq=256, prefill_buckets=(64,),
                    chunk=4, device=dev)
    r = np.random.default_rng(3)
    prompts = [r.integers(0, cfg.vocab_size, n).tolist() for n in (5, 33, 60)]
    want = [gen.generate(p, 12) for p in prompts]

    async def scenario():
        llm = MultiHostLLMClient("127.0.0.1", port)
        for _ in range(600):
            try:
                await llm._ensure()
                break
            except OSError:
                assert all(p.poll() is None for p in procs)
                await asyncio.sleep(0.2)
        try:
            got = [await llm.generate(p, 12) for p in prompts]
            many = await asyncio.gather(*(llm.generate(p, 12)
                                          for p in prompts * 2))
            await llm.shutdown_workers()
            return got, many
        finally:
            await llm.close()

    try:
        got, many = asyncio.run(scenario())
        assert got == want
        assert [len(m) for m in many] == [12] * 6
        for i, p in enumerate(procs):
            assert p.wait(timeout=60) == 0
            logs[i].seek(0)
            assert f"OK proc={i} device=cuda:0" in logs[i].read()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()


def test_federated_hosts_on_one_card_share_weights(dev):
    """Two federated hosts in one process on one card over one weight
    dict: a prompt extending b's promoted prefix routes from a to b by its
    gossiped digest and its tokens equal a single server computing the
    same prefix split."""
    import asyncio
    import socket
    import time

    from gofr_tpu_torch.ml.federation import FederatedPool, FederationConfig
    from gofr_tpu_torch.ml.generate import Generator
    from gofr_tpu_torch.ml.llm import LLMServer

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    _, cfg, params = _tiny_on_card(dev)
    opts = dict(batch_slots=2, max_seq=256, prefill_buckets=(64,), chunk=4,
                page_size=16, n_pages=64, device=dev)
    pa, pb = free_port(), free_port()

    def fed(host, port, peer, peer_port):
        return FederatedPool(
            LLMServer(Generator(params, cfg, **opts), name=f"card-{host}"),
            FederationConfig(host, ("127.0.0.1", port),
                             {peer: ("127.0.0.1", peer_port)}, gossip_s=0.1,
                             suspect_beats=2, dead_beats=5, frame_gap_s=30),
            name=f"card-{host}")

    fed_a, fed_b = fed("a", pa, "b", pb), fed("b", pb, "a", pa)
    single = LLMServer(Generator(params, cfg, **opts))
    assert fed_a.local.gen.params is fed_b.local.gen.params is params
    r = np.random.default_rng(4)
    warm = r.integers(0, cfg.vocab_size, 40).tolist()
    tail = r.integers(0, cfg.vocab_size, 7).tolist()

    async def scenario():
        for _ in range(2):
            await fed_b.generate(warm, 4)
        rows = fed_b.local.prefix_cache.hot_prefixes(16)
        reg = [int(t) for t in rows[0]["ids"]]
        peer = fed_a._peers["b"]
        deadline = time.monotonic() + 10
        while not (peer.state == "up" and peer.warm and peer.digests):
            assert time.monotonic() < deadline
            await asyncio.sleep(0.05)
        got = await fed_a.generate(reg + tail, 12)
        pid = await asyncio.to_thread(single.register_prefix, reg)
        want = await single.generate(tail, 12, prefix=pid)
        return got, want

    try:
        got, want = asyncio.run(scenario())
        assert got == want
        assert fed_a.remote_routed == 1 and fed_b.remote_served == 1
    finally:
        fed_a.close()
        fed_b.close()
        single.close()
