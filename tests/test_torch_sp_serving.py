"""Sequence-parallel SERVING in the port (``ml/sp_serving.py`` and the
Generator's SP plan), twins of ``tests/test_sp_serving.py``.

``GOFR_ML_SP`` / ``sp=`` arms a per-generator plan: prompts at or past
``min_tokens`` prefill through ring or Ulysses attention across the mesh's
shards, shorter ones through the single-device prefill; the dense cache
splits its sequence axis over the shards, a paged one stripes its page
pool and decodes through ``sp_paged_decode_step``. The contracts:

- **Off means off**: unset builds no SP machinery.
- **Greedy tokens at f32 on the tiny config with JAX's weights**: the
  port's SP Generator equals the port without SP, JAX without SP and
  JAX's SP Generator: dense (ring, Ulysses), striped bf16/f32, int8 and
  int4 pages, the prefix build, chunked routing, fused windows, the host
  tier, both fault fallbacks and the disaggregated SP prefill worker
  (in process and over the sharded wire frames).
- **Loud validation**, with JAX's messages.

The port's meshes are ``[cpu] * 2`` (sp = 2); JAX's plans build theirs
over the conftest's virtual devices.
"""

from __future__ import annotations

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.ml.sp_serving import SPConfig as JSPConfig
from gofr_tpu.ml.sp_serving import resolve as jresolve
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch import parallel as par
from gofr_tpu_torch.ml.generate import Generator
from gofr_tpu_torch.ml.sp_serving import SPConfig, resolve, sp_mode_from_env
from gofr_tpu_torch.models import llama as tllama
from gofr_tpu_torch.parallel import ShardedTensor
from gofr_tpu_torch.testutil.faults import FaultInjector

pytestmark = pytest.mark.timeout(240)

CPU = torch.device("cpu")
KW = dict(batch_slots=2, max_seq=64, prefill_buckets=(16,), chunk=4)
N_NEW = 16
LAYOUTS = {"dense": ({}, 0), "paged": ({}, 8), "int8": ({"kv_bits": 8}, 8),
           "int4": ({"kv_bits": 4}, 8)}


def _mesh(n=2):
    return par.make_mesh(par.MeshConfig(sp=n), devices=[CPU] * n)


def _sp(mode="ring", min_tokens=8, shards=2):
    return SPConfig(mode, min_tokens=min_tokens, shards=shards)


@pytest.fixture(scope="module")
def setup():
    """JAX's tiny weights at f32 (every precision shares them), the port's
    copy, and the 12-token prompt."""
    jcfg = jllama.tiny_llama(use_flash=False, dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    params = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    prompt = np.arange(1, 13, dtype=np.int32) % jcfg.vocab_size
    return jparams, params, prompt


def _cfg(**kw):
    return tllama.tiny_llama(dtype=torch.float32, **kw)


def _build(params, cfg, **kw):
    if kw.get("sp") is not None and kw["sp"] is not False:
        kw.setdefault("mesh", _mesh())
    return Generator(params, cfg, device="cpu", **{**KW, **kw})


@pytest.fixture(scope="module")
def jax_tokens(setup):
    """JAX's greedy tokens per layout, without SP and with its SP plan
    (ring; Ulysses at int4, as JAX's own int4 test runs it)."""
    jparams, _, prompt = setup
    out = {}
    for name, (kw, page_size) in LAYOUTS.items():
        cfg = jllama.tiny_llama(use_flash=False, dtype=jnp.float32, **kw)
        mode = "ulysses" if name == "int4" else "ring"
        for sp in (None, JSPConfig(mode, min_tokens=8, shards=2)):
            gen = JGenerator(jparams, cfg, page_size=page_size,
                             sp=sp if sp is not None else False, **KW)
            out[name, sp is not None] = gen.generate(prompt, N_NEW)
    return out


@pytest.fixture(scope="module")
def plain(setup):
    """The port's own tokens per layout without SP."""
    _, params, prompt = setup
    return {name: _build(params, _cfg(**kw), page_size=ps).generate(
        prompt, N_NEW) for name, (kw, ps) in LAYOUTS.items()}


# ---------------------------------------------------------- knob validation

def test_env_mode_validation(monkeypatch):
    monkeypatch.setenv("GOFR_ML_SP", "rign")
    with pytest.raises(ValueError, match="GOFR_ML_SP"):
        sp_mode_from_env()
    for off in ("", "0", "off"):
        monkeypatch.setenv("GOFR_ML_SP", off)
        assert sp_mode_from_env() is None
    monkeypatch.setenv("GOFR_ML_SP", "ULYSSES")
    assert sp_mode_from_env() == "ulysses"


def test_env_knob_validation(monkeypatch):
    monkeypatch.setenv("GOFR_ML_SP_MIN_TOKENS", "zero")
    with pytest.raises(ValueError, match="GOFR_ML_SP_MIN_TOKENS"):
        SPConfig("ring")
    monkeypatch.setenv("GOFR_ML_SP_MIN_TOKENS", "0")
    with pytest.raises(ValueError, match="GOFR_ML_SP_MIN_TOKENS"):
        SPConfig("ring")
    monkeypatch.delenv("GOFR_ML_SP_MIN_TOKENS")
    monkeypatch.setenv("GOFR_ML_SP_SHARDS", "1")
    with pytest.raises(ValueError, match="shards"):
        SPConfig("ring")
    monkeypatch.delenv("GOFR_ML_SP_SHARDS")
    with pytest.raises(ValueError, match="sp mode"):
        SPConfig("rings")


_REJECTS = {
    "more shards than devices": (("ring", 8, 16), {}),
    "ulysses head count": (("ulysses", 8, 3),
                           {"max_seq": 66, "prefill_buckets": (15,)}),
    "bucket divisibility": (("ring", 8, 3), {}),
    "min_tokens past every bucket": (("ring", 1024, 2), {}),
    "dense max_seq": (("ring", 8, 2), {"max_seq": 63}),
    "speculation": (("ring", 8, 2), {"spec_k": 3}),
    "shard_cache": (("ring", 8, 2), {"shard_cache": True}),
}


@pytest.mark.parametrize("case", sorted(_REJECTS))
def test_resolve_rejects_nonsense_with_jax_messages(case):
    """Every bad combination raises at construction with JAX's message:
    JAX's ``resolve`` over its 8 devices, the port's over ``[cpu] * 8``."""
    (mode, min_tokens, shards), over = _REJECTS[case]
    common = dict(cfg=_cfg(), mesh=None, prefill_buckets=(16,), max_seq=64,
                  page_size=0, spec_k=0, shard_cache=False)
    common.update(over)
    jcommon = dict(common, cfg=jllama.tiny_llama())
    with pytest.raises(ValueError) as want:
        jresolve(JSPConfig(mode, min_tokens, shards), **jcommon)
    with pytest.raises(ValueError) as got:
        resolve(SPConfig(mode, min_tokens, shards), devices=[CPU] * 8,
                **common)
    assert str(got.value) == str(want.value)


def test_resolve_builds_its_mesh_over_the_devices():
    """Without a mesh the plan builds one over ``devices`` (a repeated
    device works); one device, as on one card, raises JAX's "needs >= 2
    devices"; a mesh's sp axis must match an explicit shard count."""
    common = dict(cfg=_cfg(), mesh=None, prefill_buckets=(16,), max_seq=64,
                  page_size=0, spec_k=0, shard_cache=False)
    plan = resolve(SPConfig("ring", 8), devices=[CPU] * 4, **common)
    assert plan.shards == 4 and plan.mesh.axis_devices("sp") == [CPU] * 4
    assert plan.sp_cfg.attn_impl == "ring" and plan.sp_cfg.dim == 128
    with pytest.raises(ValueError, match="needs >= 2 devices"):
        resolve(SPConfig("ring", 8), devices=[CPU], **common)
    with pytest.raises(ValueError, match="GOFR_ML_SP_SHARDS=4 != the mesh"):
        resolve(SPConfig("ring", 8, 4), **dict(common, mesh=_mesh(2)))
    with pytest.raises(ValueError, match="only >1 axis is sp"):
        resolve(SPConfig("ring", 8), **dict(common, page_size=8, mesh=par.make_mesh(
            par.MeshConfig(dp=2, sp=2), devices=[CPU] * 4)))
    assert resolve(False, devices=[CPU] * 4, **common) is None


def test_generator_rejects_spec_plus_sp(setup):
    _, params, _ = setup
    with pytest.raises(ValueError, match="GOFR_ML_SPEC_K"):
        _build(params, _cfg(), sp=_sp(), spec_k=2)


def test_generator_mesh_must_start_on_its_device(setup):
    """Weights and activations live on the mesh's first device, so it must
    be the generator's."""
    _, params, _ = setup
    meta = par.make_mesh(par.MeshConfig(sp=2), devices=["meta", "cpu"])
    with pytest.raises(ValueError, match="first device"):
        _build(params, _cfg(), sp=_sp(), mesh=meta)


# ------------------------------------------------- off = no SP machinery

def test_unset_env_builds_no_sp_machinery(setup, monkeypatch):
    _, params, _ = setup
    gen = _build(params, _cfg())
    assert gen._sp is None and gen.sp_stats() is None
    assert not hasattr(gen, "sp_prefills")
    assert gen._admit_cap > 1  # the wave-admission path is untouched
    assert not isinstance(gen.cache["k"], ShardedTensor)
    # sp=False wins over an armed env (explicit opt-out)
    monkeypatch.setenv("GOFR_ML_SP", "ring")
    assert _build(params, _cfg(), sp=False)._sp is None


def test_env_arms_the_plan_over_a_given_mesh(setup, plain, monkeypatch):
    _, params, prompt = setup
    monkeypatch.setenv("GOFR_ML_SP", "ulysses")
    monkeypatch.setenv("GOFR_ML_SP_MIN_TOKENS", "8")
    gen = _build(params, _cfg(), mesh=_mesh())
    assert gen.sp_stats()["mode"] == "ulysses"
    assert gen.generate(prompt, N_NEW) == plain["dense"]
    assert gen.sp_prefills == 1


# ------------------------------------------------------ greedy token identity

def test_dense_sp_token_identity_and_dual_path(setup, plain, jax_tokens):
    _, params, prompt = setup
    want = jax_tokens["dense", False]
    assert plain["dense"] == want == jax_tokens["dense", True]
    for mode in ("ring", "ulysses"):
        gen = _build(params, _cfg(), sp=_sp(mode))
        assert gen.generate(prompt, N_NEW) == want
        assert gen.sp_prefills == 1 and gen.sp_fallbacks == 0
        # the dense cache's sequence axis rides the shards
        assert gen.cache["k"].axis == 2 and gen.cache["k"].n == 2
    # under the threshold: the single-device prefill, no SP counters
    short = _build(params, _cfg(), sp=_sp(min_tokens=13))
    assert short.generate(prompt, N_NEW) == want
    assert short.sp_prefills == 0


def test_striped_pages_token_identity(setup, plain, jax_tokens):
    _, params, prompt = setup
    gen = _build(params, _cfg(), page_size=8, sp=_sp())
    got = gen.generate(prompt, N_NEW)
    assert got == plain["paged"] == jax_tokens["paged", False]
    assert got == jax_tokens["paged", True]
    assert gen.sp_prefills == 1
    # the POOL is striped: the page axis over sp, the page count a
    # multiple of the shard count (each shard's dump page past its block)
    k = gen.cache["k"]
    assert k.axis == 1 and gen.n_pages % 2 == 0
    assert k.shape[1] == gen.n_pages and k.shards[0].shape[1] == k.block + 1
    stats = gen.sp_stats()
    assert stats["striped_pages"] and stats["mode"] == "ring"


def test_striped_allocator_round_robins_devices(setup):
    _, params, prompt = setup
    gen = _build(params, _cfg(), page_size=8, sp=_sp())
    slot = gen.add_request(prompt, max_new_tokens=4)
    pages = gen._slot_pages[slot]
    assert len(pages) >= 2
    p_loc = gen.n_pages // 2
    assert {pg // p_loc for pg in pages} == {0, 1}
    free = gen.free_pages
    gen.drain()
    while gen.slots[slot].live:
        gen.step()
    gen.release(slot)
    assert gen.free_pages == free + len(pages)
    assert all(pg // p_loc == d for d, stack in enumerate(gen._free_dev)
               for pg in stack)


@pytest.mark.parametrize("layout", ["int8", "int4"])
def test_striped_quantized_pages_token_identity(setup, plain, jax_tokens,
                                                layout):
    """int8 and int4 pages stripe too (values and every plane); each shard
    dequantizes its own pages. int4 runs Ulysses, as JAX's test does."""
    _, params, prompt = setup
    kw, _ = LAYOUTS[layout]
    mode = "ulysses" if layout == "int4" else "ring"
    gen = _build(params, _cfg(**kw), page_size=8, sp=_sp(mode))
    got = gen.generate(prompt, N_NEW)
    assert got == plain[layout] == jax_tokens[layout, False]
    assert got == jax_tokens[layout, True]
    assert gen.cache["k_scale"].axis == 1
    if layout == "int4":
        assert gen.cache["k_zero"].axis == 1


# ------------------------------------------------------------ fault fallback

@pytest.mark.parametrize("point", ["sp_prefill", "sp_gather"])
def test_sp_fault_falls_back_bit_identically(setup, plain, point):
    _, params, prompt = setup
    gen = _build(params, _cfg(), page_size=8, sp=_sp())
    gen.fault = FaultInjector.parse(f"{point}:1")
    assert gen.generate(prompt, N_NEW) == plain["paged"]
    assert gen.sp_fallbacks == 1 and gen.sp_prefills == 0
    # the fallback admitted on the plain path: no shard count stamped
    assert all(s.sp_shards == 0 for s in gen.slots)


def test_dense_fault_falls_back_bit_identically(setup, plain):
    _, params, prompt = setup
    gen = _build(params, _cfg(), sp=_sp("ulysses"))
    gen.fault = FaultInjector.parse("sp_gather:1")
    assert gen.generate(prompt, N_NEW) == plain["dense"]
    assert gen.sp_fallbacks == 1


# ------------------------------------- register_prefix (the disagg ship leg)

def test_register_prefix_sp_build_matches_plain(setup):
    _, params, _ = setup
    prefix = np.arange(1, 17, dtype=np.int32) % 512  # 2 pages
    suffix = np.array([3, 1, 4], np.int32)

    def run(gen):
        pid = gen.register_prefix(prefix)
        slot = gen.add_request(suffix, max_new_tokens=10, prefix=pid)
        while gen.slots[slot].live:
            gen.step()
        gen.drain()
        return gen.slots[slot].tokens[:10]

    want = run(_build(params, _cfg(), page_size=8))
    gen = _build(params, _cfg(), page_size=8, sp=_sp())
    assert run(gen) == want
    assert gen.sp_prefills == 1  # the prefix built sequence-parallel


def test_host_tier_spill_restore_on_the_striped_pool(setup):
    """A striped prefix spills (each page gathered from its owner) and
    restores (each page back to its owner): the suffix served on the
    restored prefix gives the never-evicted tokens."""
    from gofr_tpu_torch.ml.kv_offload import HostKVStore, OffloadConfig

    _, params, _ = setup
    prefix = np.arange(1, 17, dtype=np.int32) % 512
    suffix = [3, 1, 4]

    def serve(gen, pid):
        slot = gen.add_request(suffix, max_new_tokens=8, prefix=pid)
        while gen.slots[slot].live:
            gen.step()
        gen.drain()
        out = gen.slots[slot].tokens[:8]
        gen.release(slot)
        return out

    gen = _build(params, _cfg(), page_size=8, sp=_sp(),
                 host_kv=HostKVStore(OffloadConfig(budget_mb=8)))
    pid = gen.register_prefix(prefix)
    want = serve(gen, pid)
    free = gen.free_pages
    assert gen.drop_prefix(pid, spill=True)
    pid2 = gen.restore_prefix(prefix)
    assert gen.kv_spills == 1 and gen.kv_restores == 1
    assert serve(gen, pid2) == want
    assert gen.free_pages == free


# ------------------------------------------------ composition with the knobs

def test_chunked_prefill_routes_sp_eligible_prompts_whole(setup, plain):
    """With ``prefill_chunk`` an SP-eligible prompt prefills whole across
    the mesh instead of in segments; a longer-than-chunk prompt under the
    threshold still takes the segments (on the striped pool)."""
    _, params, prompt = setup
    gen = _build(params, _cfg(), page_size=8, prefill_chunk=8, sp=_sp())
    assert not gen._routes_chunked(12) and gen._routes_chunked(9) is False
    assert gen.generate(prompt, N_NEW) == plain["paged"]
    assert gen.sp_prefills == 1 and gen.prefill_segments_run == 0
    short = _build(params, _cfg(), page_size=8, prefill_chunk=8,
                   sp=_sp(min_tokens=16))
    assert short._routes_chunked(12)
    assert short.generate(prompt, N_NEW) == plain["paged"]
    assert short.prefill_segments_run == 2 and short.sp_prefills == 0
    dense = _build(params, _cfg(), prefill_chunk=8, sp=_sp(min_tokens=16))
    assert dense.generate(prompt, N_NEW) == plain["dense"]
    assert dense.prefill_segments_run == 2


def test_fused_windows_and_pipeline_compose(setup, plain):
    _, params, prompt = setup
    gen = _build(params, _cfg(), page_size=8, sp=_sp(), decode_window=4,
                 pipeline=1)
    assert gen.generate(prompt, N_NEW) == plain["paged"]
    assert gen.windows > 0 and gen.sp_prefills == 1


# ----------------------------------------------- scheduler / slots / debug

def test_scheduler_charged_at_tokens_over_shards(setup):
    _, params, prompt = setup
    gen = _build(params, _cfg(), page_size=8, sp=_sp(), token_budget=64)
    gen.add_request(prompt, max_new_tokens=4)
    sched = gen.scheduler
    assert sched.sp_charges == 1
    # 12 tokens over 2 shards -> 6 of restore-ledger debt
    assert sched.restore_debt == 6
    assert sched.snapshot()["sp_charges"] == 1


def test_slot_carries_shard_count_and_sp_stats(setup):
    _, params, prompt = setup
    gen = _build(params, _cfg(), sp=_sp())
    slot = gen.add_request(prompt, max_new_tokens=4)
    assert gen.slots[slot].sp_shards == 2
    assert gen.sp_stats() == {"mode": "ring", "shards": 2, "min_tokens": 8,
                              "striped_pages": False, "prefills": 1,
                              "fallbacks": 0, "tokens": 12}


def test_sp_warmup_runs_eligible_buckets(setup, plain):
    _, params, prompt = setup
    for page_size in (8, 0):
        gen = _build(params, _cfg(), page_size=page_size, sp=_sp())
        gen.warmup()
        assert "sp_prefill/b16" in gen.programs
        # warmup leaves the generator serving-identical
        want = plain["paged" if page_size else "dense"]
        assert gen.generate(prompt, N_NEW) == want


def test_debug_serving_metrics_and_journey(setup, plain, run):
    """``/debug/serving`` carries the ``sp`` block, ``/metrics`` the shard
    gauge and the prefill counter, and the admit mark of an SP prompt its
    shard count."""
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig

    _, params, prompt = setup
    ml = App(config=MapConfig({"APP_NAME": "sp-debug"}))._ensure_ml()
    gen = _build(params, _cfg(), page_size=8, sp=_sp())
    server = ml.register_llm("sp", None, None, generator=gen, warmup=False)
    try:
        assert run(server.generate(list(prompt), N_NEW)) == plain["paged"]
        snap = ml.serving_snapshot()["llms"]["sp"]
        assert snap["sp"]["prefills"] == 1 and snap["sp"]["shards"] == 2
        server._export_pool_gauges()
        text = ml._metrics.expose_text()
        assert 'app_ml_sp_shards{model="sp"} 2' in text
        assert 'app_ml_sp_prefills_total{model="sp"} 1' in text
        log = server._journeys
        marks = [m for rid in log.snapshot()["recent_rids"]
                 for m in log.get(rid).snapshot()["marks"]
                 if m["mark"] == "admit"]
        assert any(m.get("sp_shards") == 2 for m in marks)
    finally:
        server.close()


# ----------------------------------------------------- per-shard wire frames

def test_kv_transport_shard_frames_round_trip():
    from gofr_tpu_torch.ml.kv_transport import decode_entry, encode_entry_shards

    rng = np.random.default_rng(0)
    key = tuple(range(12))
    arrays = {n: torch.from_numpy(rng.normal(size=(2, 5, 8, 4)).astype(
        np.float32)) for n in ("k", "v")}
    meta = {"len": 40, "tail": [], "ids_full": list(key), "pinned": False}
    frames = encode_entry_shards(key, arrays, meta, 2)
    assert len(frames) == 2
    (k0, a0, m0), (k1, a1, m1) = (decode_entry(f) for f in frames)
    assert k0 == k1 == key and m0["_sp_shard"] == [0, 2]
    assert m1["_sp_shard"] == [1, 2]
    assert torch.equal(torch.cat([a0["k"], a1["k"]], dim=1), arrays["k"])
    # degenerate cases collapse to one plain frame
    assert len(encode_entry_shards(key, arrays, meta, 1)) == 1
    assert len(encode_entry_shards(key, arrays, meta, 9)) == 1


def test_kv_transport_land_bytes_reassembles_shards():
    from gofr_tpu_torch.ml.kv_transport import KVTransport, encode_entry_shards

    key = tuple(range(8))
    arrays = {"k": torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 4, 8, 4)).astype(np.float32))}
    meta = {"len": 32, "tail": [], "ids_full": list(key), "pinned": False}
    frames = encode_entry_shards(key, arrays, meta, 2)
    landed = {}

    class Dst:
        def import_prefix_kv(self, key, arrays, meta, timeout_s):
            landed.update(key=key, arrays=arrays, meta=meta)
            return True

    t = KVTransport(name="llm")
    assert t.land_bytes(Dst(), frames[0]) is None  # first shard parks
    assert t.snapshot()["sp_shards_pending"] == 1
    assert t.land_bytes(Dst(), frames[1]) == key
    assert t.snapshot()["sp_shards_pending"] == 0
    assert t.snapshot()["sp_shard_frames"] == 2
    assert torch.equal(landed["arrays"]["k"], arrays["k"])
    assert "_sp_shard" not in landed["meta"]


# ------------------------------------- disagg composition (the ship path)

def _disagg_gen(params, **kw):
    return Generator(params, _cfg(), batch_slots=1, max_seq=64,
                     prefill_buckets=(8, 16), page_size=4, chunk=2,
                     device="cpu", **kw)


DG_PROMPT = [5, 9, 2, 7, 1, 4, 8, 3, 6]  # 2 whole pages at page_size 4


def test_disagg_sp_prefill_worker_bit_identity(setup, run):
    """A prefill-biased replica with an SP plan is a SEQUENCE-PARALLEL
    prefill worker: the prefix KV builds across its mesh, ships, and the
    decode replica restores and decodes suffix-only. Greedy output equals a
    plain single generator's and JAX's."""
    from gofr_tpu_torch.ml.replica import ReplicaPool

    jparams, params, _ = setup
    want = _disagg_gen(params).generate(DG_PROMPT, 6)
    jcfg = jllama.tiny_llama(use_flash=False, dtype=jnp.float32)
    assert want == JGenerator(jparams, jcfg, batch_slots=1, max_seq=64,
                              prefill_buckets=(8, 16), page_size=4,
                              chunk=2).generate(DG_PROMPT, 6)
    worker = _disagg_gen(params, sp=_sp(min_tokens=8), mesh=_mesh())
    pool = ReplicaPool([worker, _disagg_gen(params)], name="sp-dg",
                       disagg=True)

    async def scenario():
        out = await asyncio.wait_for(pool.generate(DG_PROMPT, 6), 120)
        assert out == want
        snap = pool.routing_snapshot()["disagg"]
        assert snap["ships"] == 1 and snap["lands"] == 1
        assert snap["failures"] == 0
        assert worker.sp_prefills == 1  # the prefix built sequence-parallel
        assert pool.replicas[1].gen.kv_restores == 1

    try:
        run(scenario())
    finally:
        pool.close()


def test_sharded_ship_from_an_sp_worker(setup, run):
    """The cross-host half: an SP prefill worker ships its striped pages
    as one frame a shard (``ship_bytes_sharded``); the receiver reassembles
    them and the landed pages decode to the plain tokens."""
    from gofr_tpu_torch.ml.kv_offload import HostKVStore, OffloadConfig
    from gofr_tpu_torch.ml.kv_transport import KVTransport, decode_entry
    from gofr_tpu_torch.ml.llm import LLMServer

    _, params, _ = setup
    want = _disagg_gen(params).generate(DG_PROMPT, 6)
    src = LLMServer(_disagg_gen(params, sp=_sp(min_tokens=8), mesh=_mesh(),
                                host_kv=HostKVStore(OffloadConfig(
                                    budget_mb=64))), name="sp-src")
    dst = LLMServer(_disagg_gen(params, host_kv=HostKVStore(
        OffloadConfig(budget_mb=64))), name="sp-dst")
    t = KVTransport(name="sp-xhost")
    try:
        shards = src.gen.sp_stats()["shards"]
        frames = t.ship_bytes_sharded(src, DG_PROMPT, shards)
        assert frames is not None and len(frames) == 2
        assert [decode_entry(f)[2]["_sp_shard"] for f in frames] == [
            [0, 2], [1, 2]]
        assert src.gen.sp_prefills == 1
        assert t.land_bytes(dst, frames[0]) is None
        assert t.land_bytes(dst, frames[1]) == tuple(DG_PROMPT)

        async def scenario():
            assert await dst.generate(DG_PROMPT, 6) == want
            assert dst.gen.kv_restores == 1

        run(scenario())
    finally:
        src.close()
        dst.close()


def test_replica_of_several_devices_gets_an_sp_mesh(setup, plain,
                                                    monkeypatch):
    """``sp=`` on a replica that owns several devices (here the CPU named
    twice) builds an sp mesh over them; an env-armed plan stays off on a
    one-device replica; several devices without SP make a
    tensor-parallel replica (``tests/test_torch_tensor_parallel.py``)
    whose tokens equal the unsharded generator's at f32."""
    from gofr_tpu_torch.ml.replica import build_replica_generators

    _, params, prompt = setup
    (gen,) = build_replica_generators(params, _cfg(), 1, warmup=False,
                                      devices=[CPU, CPU], sp=_sp(), **KW)
    assert gen.sp_stats()["shards"] == 2
    assert gen.generate(prompt, N_NEW) == plain["dense"]
    monkeypatch.setenv("GOFR_ML_SP", "ring")
    (one,) = build_replica_generators(params, _cfg(), 1, warmup=False,
                                      devices=[CPU], **KW)
    assert one.sp_stats() is None
    monkeypatch.delenv("GOFR_ML_SP")
    (tp,) = build_replica_generators(params, _cfg(), 1, warmup=False,
                                     devices=[CPU, CPU], **KW)
    assert tp.sp_stats() is None and tp.mesh.shape["tp"] == 2
    assert tp.generate(prompt, N_NEW) == plain["dense"]
