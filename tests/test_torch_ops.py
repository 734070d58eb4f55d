"""PyTorch port, ops: each plain op against its JAX counterpart, and the plain
versions of the CUDA kernels (flash prefill, fp decode, int8 decode) against
the Pallas kernels they replace (run in interpret mode, as tests/test_ops.py
and tests/test_kv_quant.py run them).

Inputs come from a numpy seed and go through both frameworks; JAX runs on
the CPU, torch on the CPU. Tolerances: 1e-5 where both sides compute the
same f32 arithmetic; 2e-2 for a kernel against its plain version, at f32
(the online softmax sums in a different order, as test_ops.py allows) and
at bf16 (one bf16 ulp of an O(1) output is 2**-7 ~ 8e-3, and the two
sides round probabilities at different points). The int8 quantizers are
held bit for bit: the same f32 arithmetic, rounding half to even on both
sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gofr_tpu.models.llama  # noqa: F401
import gofr_tpu.ops as jops
from gofr_tpu.ops.decode_attention import gqa_decode_attention_tpu
from gofr_tpu.ops.flash_attention import flash_attention_tpu
from gofr_tpu_torch import ops as tops
from gofr_tpu_torch.ops.decode_attention import (gqa_decode_attention_cuda,
                                                 gqa_decode_attention_int8_cuda,
                                                 gqa_decode_attention_int8_plain,
                                                 gqa_decode_attention_plain)
from gofr_tpu_torch.ops.flash_attention import (flash_attention_cuda,
                                                flash_attention_plain)

# Importing the submodule gofr_tpu.ops.flash_attention (above) rebinds the
# package attribute ``gofr_tpu.ops.flash_attention`` from the dispatcher
# function to the module. gofr_tpu.models.llama is imported first so that
# it binds the function, whichever test file a process collects next.

pytestmark = pytest.mark.timeout(120)

F32 = dict(atol=1e-5, rtol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_t(a):
    """A bf16 numpy array (JAX's ml_dtypes) -> torch, bit for bit."""
    bits = np.ascontiguousarray(np.asarray(a)).view(np.uint16).copy()
    return torch.from_numpy(bits).view(torch.bfloat16)


def _bf16_bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _bf16_pair(a):
    """The same bf16 values on both sides (rounded once, by JAX)."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, _t(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


def test_rms_norm_matches_jax():
    r = _rng(0)
    x, w = r.standard_normal((2, 5, 64)), r.standard_normal(64)
    x, w = x.astype(np.float32), w.astype(np.float32)
    np.testing.assert_allclose(_np(tops.rms_norm(_t(x), _t(w))),
                               _np(jops.rms_norm(x, w)), **F32)


@pytest.mark.parametrize("head_dim", [16, 128])
@pytest.mark.parametrize("scaling", [None, {"rope_type": "llama3",
                                            "factor": 8.0}])
def test_rope_matches_jax(head_dim, scaling):
    r = _rng(1)
    pos = r.integers(0, 9000, (2, 7))
    x = r.standard_normal((2, 7, 3, head_dim)).astype(np.float32)
    jc, js = jops.rope_table(jnp.asarray(pos), head_dim, 500_000.0,
                             scaling=scaling)
    tc, ts = tops.rope_table(_t(pos), head_dim, 500_000.0, scaling=scaling)
    np.testing.assert_allclose(_np(tc), _np(jc), **F32)
    np.testing.assert_allclose(_np(ts), _np(js), **F32)
    # apply_rope on the SAME tables: identical f32 arithmetic
    np.testing.assert_allclose(
        _np(tops.apply_rope(_t(x), _t(np.asarray(jc)), _t(np.asarray(js)))),
        _np(jops.apply_rope(x, jc, js)), **F32)


def test_scale_rope_freqs_matches_jax():
    freqs = (1.0 / (500_000.0 ** (np.arange(64) / 64))).astype(np.float32)
    for sc in ({"rope_type": "llama3", "factor": 8.0},
               {"type": "linear", "factor": 4.0}):
        np.testing.assert_allclose(_np(tops.scale_rope_freqs(_t(freqs), sc)),
                                   _np(jops.scale_rope_freqs(freqs, sc)), **F32)
    with pytest.raises(ValueError, match="rope_scaling"):
        tops.scale_rope_freqs(_t(freqs), {"rope_type": "yarn"})


def test_repeat_kv_and_swiglu_match_jax():
    r = _rng(2)
    kv = r.standard_normal((2, 3, 2, 4)).astype(np.float32)
    np.testing.assert_array_equal(_np(tops.repeat_kv(_t(kv), 3)),
                                  _np(jops.repeat_kv(kv, 3)))
    x = r.standard_normal((2, 3, 16)).astype(np.float32)
    wg, wu = (r.standard_normal((16, 32)).astype(np.float32) for _ in range(2))
    wd = r.standard_normal((32, 16)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tops.swiglu(*map(_t, (x, wg, wu, wd)))),
        _np(jops.swiglu(x, wg, wu, wd)), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("case", ["causal", "full", "kv_len", "row_offsets"])
def test_attention_matches_jax(case):
    r = _rng(3)
    q, k, v = (r.standard_normal((2, 6, 2, 8)).astype(np.float32)
               for _ in range(3))
    kw = {"causal": case != "full"}
    tkw = dict(kw)
    if case == "kv_len":
        kw["kv_len"] = jnp.asarray([4, 6])
        tkw["kv_len"] = torch.tensor([4, 6])
    if case == "row_offsets":
        kw["q_offset"] = jnp.asarray([0, 3])
        tkw["q_offset"] = torch.tensor([0, 3])
    np.testing.assert_allclose(
        _np(tops.attention(_t(q), _t(k), _t(v), **tkw)),
        _np(jops.attention(q, k, v, **kw)), **F32)


@pytest.mark.parametrize("head_dim", [16, 128])
def test_gqa_decode_attention_matches_jax(head_dim):
    r = _rng(4)
    B, S, KV, n_rep = 3, 16, 2, 4
    q = r.standard_normal((B, 1, KV * n_rep, head_dim)).astype(np.float32)
    kc, vc = (r.standard_normal((B, S, KV, head_dim)).astype(np.float32)
              for _ in range(2))
    kv_len = np.array([5, 16, 1], np.int32)
    np.testing.assert_allclose(
        _np(tops.gqa_decode_attention(_t(q), _t(kc), _t(vc), _t(kv_len))),
        _np(jops.gqa_decode_attention(q, kc, vc, jnp.asarray(kv_len))),
        atol=1e-5, rtol=1e-4)


# -- the flash kernel's plain version vs the Pallas kernel ---------------------

@pytest.mark.parametrize("head_dim", [16, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas(causal, head_dim):
    r = _rng(5)
    B, T, H, KV = 2, 128, 4, 2
    q = r.standard_normal((B, T, H, head_dim)).astype(np.float32)
    k, v = (r.standard_normal((B, T, KV, head_dim)).astype(np.float32)
            for _ in range(2))
    want = flash_attention_tpu(jnp.asarray(q), jops.repeat_kv(k, 2),
                               jops.repeat_kv(v, 2), causal=causal,
                               block_q=64, block_k=64, interpret=True)
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)


def test_flash_plain_kv_len_padding_matches_pallas():
    r = _rng(6)
    B, T, H, KV, D = 2, 128, 4, 2, 16
    q = r.standard_normal((B, T, H, D)).astype(np.float32)
    k, v = (r.standard_normal((B, T, KV, D)).astype(np.float32)
            for _ in range(2))
    kv_len = np.array([50, 128], np.int32)
    want = flash_attention_tpu(jnp.asarray(q), jops.repeat_kv(k, 2),
                               jops.repeat_kv(v, 2), jnp.asarray(kv_len),
                               causal=True, block_q=64, block_k=64,
                               interpret=True)
    got = flash_attention_plain(_t(q), _t(k), _t(v), _t(kv_len), causal=True)
    # rows past a sequence's kv_len see only masked keys: compare the valid area
    np.testing.assert_allclose(_np(got)[0, :50], _np(want)[0, :50],
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_np(got)[1], _np(want)[1], atol=2e-2, rtol=2e-2)


def test_flash_plain_bf16_matches_pallas():
    r = _rng(7)
    B, T, H, KV, D = 1, 128, 4, 2, 128
    qj, qt = _bf16_pair(r.standard_normal((B, T, H, D)))
    kj, kt = _bf16_pair(r.standard_normal((B, T, KV, D)))
    vj, vt = _bf16_pair(r.standard_normal((B, T, KV, D)))
    want = flash_attention_tpu(qj, jops.repeat_kv(kj, 2), jops.repeat_kv(vj, 2),
                               causal=True, block_q=64, block_k=64,
                               interpret=True)
    got = flash_attention_plain(qt, kt, vt, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)


# -- the decode kernel's plain version vs the Pallas kernel --------------------

@pytest.mark.parametrize("head_dim", [16, 128])
def test_decode_plain_matches_pallas_stacked(head_dim):
    """Stacked cache, layer != 0, ragged kv_len — including a row at
    capacity whose kv_len is S_max + 1 (pos + 1 of a full row): the port
    clamps it to S_max, the Pallas kernel's cdiv would overrun, so that row
    is held against the Pallas kernel at kv_len = S_max."""
    r = _rng(8)
    L, B, S, KV, n_rep = 3, 4, 256, 2, 4
    q = r.standard_normal((B, 1, KV * n_rep, head_dim)).astype(np.float32)
    kc, vc = (r.standard_normal((L, B, S, KV, head_dim)).astype(np.float32)
              for _ in range(2))
    kv_len = np.array([1, 100, 256, 257], np.int32)
    want = gqa_decode_attention_tpu(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(np.minimum(kv_len, S)), layer=2, interpret=True)
    got = gqa_decode_attention_plain(_t(q), _t(kc), _t(vc), _t(kv_len),
                                     layer=2)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-4)


def test_decode_plain_bf16_matches_pallas():
    r = _rng(9)
    L, B, S, KV, n_rep, D = 2, 2, 256, 2, 4, 128
    qj, qt = _bf16_pair(r.standard_normal((B, 1, KV * n_rep, D)))
    kj, kt = _bf16_pair(r.standard_normal((L, B, S, KV, D)))
    vj, vt = _bf16_pair(r.standard_normal((L, B, S, KV, D)))
    kv_len = np.array([37, 256], np.int32)
    want = gqa_decode_attention_tpu(qj, kj, vj, jnp.asarray(kv_len), layer=1,
                                    interpret=True)
    got = gqa_decode_attention_plain(qt, kt, vt, _t(kv_len), layer=1)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)


# -- int8 quantization ---------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 33, 8, 16), (2, 5, 2, 128)])
def test_quantize_kv_matches_jax(shape):
    """Codes equal and bf16 scales bit-equal on the same f32 input,
    including an all-zero vector (the 1e-6 floor) and exact halves (scale
    exactly 1: round half to even on both sides)."""
    r = _rng(11)
    x = (r.standard_normal(shape) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 0] = 0.0
    x[0, 1, 0, :6] = [127.0, 0.5, 1.5, 2.5, -2.5, -0.5]
    jq, js = jops.quantize_kv(jnp.asarray(x))
    tq, ts = tops.quantize_kv(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bf16_bits(ts), _bf16_bits(js))
    assert tq[0, 1, 0, :6].tolist() == [127, 0, 2, 2, -2, 0]
    assert not tq[0, 0, 0].any()
    for dtype, tdtype in ((jnp.float32, torch.float32),
                          (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            _np(tops.dequantize_kv(tq, ts, tdtype)),
            _np(jops.dequantize_kv(jq, js, dtype)))


@pytest.mark.parametrize("shape,dtype", [((3, 64, 48), "float32"),
                                         ((64, 96), "bfloat16")])
def test_quantize_weight_matches_jax(shape, dtype):
    """Stacked layer weights and an lm_head-shaped matrix, f32 and bf16:
    codes equal, f32 scales bit-equal (a zero column takes the eps floor)."""
    r = _rng(12)
    w = r.standard_normal(shape).astype(np.float32)
    w[..., 3] = 0.0
    wj = jnp.asarray(w).astype(getattr(jnp, dtype))
    wt = _t(np.asarray(wj.astype(jnp.float32))).to(getattr(torch, dtype))
    jq, js = jops.quantize_weight(wj)
    tq, ts = tops.quantize_weight(wt)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))


def _int8_stacked_cache(r, L, B, S, KV, D):
    """A stacked int8 cache quantized by JAX, in both frameworks: values
    FLAT [L, B, S, KV*D], scales seq-minor [L, B, KV, S]."""
    out = []
    for _ in range(2):
        q, sc = jops.quantize_kv(jnp.asarray(
            r.standard_normal((L, B, S, KV, D)).astype(np.float32)))
        q = np.asarray(q).reshape(L, B, S, KV * D)
        sc = np.asarray(sc).transpose(0, 1, 3, 2)
        out.append((jnp.asarray(q), jnp.asarray(sc), _t(q), _bf16_t(sc)))
    return out


@pytest.mark.parametrize("head_dim", [16, 128])
def test_int8_decode_plain_matches_pallas_stacked(head_dim):
    """The int8 plain version against the Pallas int8 kernel on a stacked
    flat cache at layer 2, with kv_len 1 and a row at capacity (S_max + 1,
    held against the Pallas kernel at S_max as for the fp cache); and
    against the JAX package's XLA path, which it follows, at f32."""
    r = _rng(13)
    L, B, S, KV, n_rep = 3, 4, 256, 2, 4
    q = r.standard_normal((B, 1, KV * n_rep, head_dim)).astype(np.float32)
    (kj, ksj, kt, kst), (vj, vsj, vt, vst) = _int8_stacked_cache(
        r, L, B, S, KV, head_dim)
    kv_len = np.array([1, 100, 256, 257], np.int32)
    want = gqa_decode_attention_tpu(
        jnp.asarray(q), kj, vj, jnp.asarray(np.minimum(kv_len, S)), layer=2,
        k_scale=ksj, v_scale=vsj, interpret=True)
    got = gqa_decode_attention_int8_plain(_t(q), kt, vt, _t(kv_len), layer=2,
                                          k_scale=kst, v_scale=vst)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)
    xla = jops.cached_decode_attention(
        jnp.asarray(q), kj, vj, jnp.asarray(kv_len), layer=2,
        use_kernel=False, k_scale=ksj, v_scale=vsj)
    np.testing.assert_allclose(_np(got), _np(xla), atol=1e-5, rtol=1e-4)


def test_int8_decode_plain_bf16_matches_pallas():
    """bf16 queries: the plain version dequantizes to q.dtype, as the JAX
    code does; one layer's [B, S, KV*D] cache (no layer axis)."""
    r = _rng(14)
    B, S, KV, n_rep, D = 2, 256, 2, 4, 128
    qj, qt = _bf16_pair(r.standard_normal((B, 1, KV * n_rep, D)))
    (kj, ksj, kt, kst), (vj, vsj, vt, vst) = _int8_stacked_cache(
        r, 1, B, S, KV, D)
    kv_len = np.array([37, 256], np.int32)
    want = gqa_decode_attention_tpu(qj, kj[0], vj[0], jnp.asarray(kv_len),
                                    k_scale=ksj[0], v_scale=vsj[0],
                                    interpret=True)
    got = gqa_decode_attention_int8_plain(qt, kt[0], vt[0], _t(kv_len),
                                          k_scale=kst[0], v_scale=vst[0])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)


# -- dispatchers ----------------------------------------------------------------

def test_dispatchers_take_the_plain_version_on_cpu():
    r = _rng(10)
    q = _t(r.standard_normal((1, 8, 4, 16)).astype(np.float32))
    k = _t(r.standard_normal((1, 8, 2, 16)).astype(np.float32))
    before = (flash_attention_cuda.launches, gqa_decode_attention_cuda.launches)
    torch.testing.assert_close(tops.flash_attention(q, k, k),
                               flash_attention_plain(q, k, k))
    kc = k[None]
    kv_len = torch.tensor([5], dtype=torch.int32)
    torch.testing.assert_close(
        tops.cached_decode_attention(q[:, :1], kc, kc, kv_len, layer=0),
        gqa_decode_attention_plain(q[:, :1], kc, kc, kv_len, layer=0))
    assert (flash_attention_cuda.launches,
            gqa_decode_attention_cuda.launches) == before


def test_decode_dispatcher_takes_the_int8_plain_version_on_cpu():
    r = _rng(15)
    q = _t(r.standard_normal((2, 1, 4, 16)).astype(np.float32))
    (_, _, kt, kst), (_, _, vt, vst) = _int8_stacked_cache(r, 2, 2, 8, 2, 16)
    kv_len = torch.tensor([3, 8], dtype=torch.int32)
    before = (gqa_decode_attention_cuda.launches,
              gqa_decode_attention_int8_cuda.launches)
    torch.testing.assert_close(
        tops.cached_decode_attention(q, kt, vt, kv_len, layer=1,
                                     k_scale=kst, v_scale=vst),
        gqa_decode_attention_int8_plain(q, kt, vt, kv_len, layer=1,
                                        k_scale=kst, v_scale=vst),
        rtol=0, atol=0)
    assert (gqa_decode_attention_cuda.launches,
            gqa_decode_attention_int8_cuda.launches) == before


def test_cuda_wrappers_refuse_cpu_tensors():
    """No fallback: a wrapper handed a CPU tensor raises, it never computes
    the plain version itself."""
    q = torch.zeros((1, 8, 4, 16), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        gqa_decode_attention_cuda(q[:, :1], k[None], k[None],
                                  torch.ones(1, dtype=torch.int32))
    cache = torch.zeros((1, 8, 32), dtype=torch.int8)
    scale = torch.zeros((1, 2, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        gqa_decode_attention_int8_cuda(q[:, :1], cache, cache,
                                       torch.ones(1, dtype=torch.int32),
                                       k_scale=scale, v_scale=scale)
