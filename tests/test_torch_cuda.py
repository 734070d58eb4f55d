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
row, over 20 back-to-back calls and on two streams.

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
