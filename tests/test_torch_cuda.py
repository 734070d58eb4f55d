"""PyTorch port on the card: the CUDA kernels against their plain versions
at ragged shapes, and the tiny model through the kernels against the plain
path. Marked ``cuda``: each test skips where there is no card (decided in
the fixture, never at import). Run on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

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


@pytest.mark.parametrize("case", [
    # B, Tq, Tk, H, KV, D, causal, kv_len, q_offset
    (2, 512, 512, 32, 8, 128, True, [512, 301], 0),
    (1, 130, 130, 4, 2, 128, True, None, 0),
    (2, 77, 200, 4, 4, 64, False, [200, 33], 0),
    (1, 64, 192, 2, 1, 16, True, [150], 128),
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
