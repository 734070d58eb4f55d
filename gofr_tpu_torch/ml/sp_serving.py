"""Sequence-parallel serving's plan — counterpart of ``gofr_tpu/ml/sp_serving.py``.

``GOFR_ML_SP=ring|ulysses`` (or ``Generator(sp=...)``,
``register_llm(..., sp=...)``) arms it; unset, ``0`` or ``off`` builds no
sequence-parallel machinery at all. ``GOFR_ML_SP_MIN_TOKENS`` (default
1024) is the dual-path threshold: prompts at or past it prefill
sequence-parallel across the generator's mesh, shorter ones take the
single-device prefill. ``GOFR_ML_SP_SHARDS`` fixes the shard count (0 or
unset: every device the mesh, or the visible cards, offer).

``resolve`` validates everything at construction with the knob's name in
the message (shards against devices, Ulysses' head divisibility, bucket
and ``max_seq`` divisibility, the striped pool's mesh, the modes SP does
not compose with) and returns an ``SPPlan`` or None. The messages are
JAX's. Without a mesh the plan builds one over the visible cards
(``parallel.visible_devices``), or over ``devices`` when given: on one
card, or on the host, that is one device, and ``resolve`` raises "needs
>= 2 devices" as JAX's does on one chip. Four shards on one card come from
an explicit mesh that names the card four times
(``make_mesh(MeshConfig(sp=4), devices=[cuda:0] * 4)``).

A dense SP generator splits its KV cache's sequence axis over the mesh; a
paged one stripes its page POOL instead (each device owns
``n_pages / shards`` pages, the host allocator round-robins a slot's pages
across them) and decodes through ``models/llama.sp_paged_decode_step``.
An SP prefill that faults (the ``sp_prefill`` / ``sp_gather`` points)
falls back to the single-device prefill, bit for bit: sequence
parallelism may lose speed, never tokens.
"""

from __future__ import annotations

import os
from typing import Any

from .generate import _env_int

__all__ = ["SPConfig", "SPPlan", "sp_mode_from_env", "resolve"]

_MODES = ("ring", "ulysses")
_OFF = ("", "0", "off", "none")


def sp_mode_from_env() -> str | None:
    """``GOFR_ML_SP`` → ``"ring"`` | ``"ulysses"`` | ``None`` (off).
    Malformed values fail loudly at construction instead of silently
    serving single-device."""
    raw = os.environ.get("GOFR_ML_SP", "").strip().lower()
    if raw in _OFF:
        return None
    if raw in _MODES:
        return raw
    raise ValueError(
        f"GOFR_ML_SP must be one of {_MODES} (or 0/off), got {raw!r}")


class SPConfig:
    """Requested sequence-parallel serving knobs (pre-resolution).

    ``min_tokens``/``shards`` default from ``GOFR_ML_SP_MIN_TOKENS`` /
    ``GOFR_ML_SP_SHARDS`` when not given; ``shards=0`` means "every
    device the generator's mesh owns"."""

    def __init__(self, mode: str, min_tokens: int | None = None,
                 shards: int | None = None) -> None:
        mode = str(mode).strip().lower()
        if mode not in _MODES:
            raise ValueError(f"sp mode must be one of {_MODES}, got {mode!r}")
        self.mode = mode
        self.min_tokens = (_env_int("GOFR_ML_SP_MIN_TOKENS", 1024, minimum=1)
                           if min_tokens is None else int(min_tokens))
        if self.min_tokens < 1:
            raise ValueError(
                f"sp min_tokens must be >= 1, got {self.min_tokens}")
        self.shards = (_env_int("GOFR_ML_SP_SHARDS", 0)
                       if shards is None else int(shards))
        if self.shards == 1 or self.shards < 0:
            raise ValueError(
                f"sp shards must be 0 (auto) or >= 2, got {self.shards}")

    @classmethod
    def from_env(cls) -> "SPConfig | None":
        """The env-armed config, or ``None`` when ``GOFR_ML_SP`` is
        unset/off — the caller then constructs NO SP machinery."""
        mode = sp_mode_from_env()
        if mode is None:
            return None
        return cls(mode)


class SPPlan:
    """A fully-resolved, validated sequence-parallel serving plan: the
    mode, shard count, dual-path threshold, the sp mesh, and the model
    config clone (``attn_impl=mode``) the SP programs trace with."""

    def __init__(self, mode: str, min_tokens: int, shards: int, mesh,
                 sp_cfg) -> None:
        self.mode = mode
        self.min_tokens = min_tokens
        self.shards = shards
        self.mesh = mesh
        self.sp_cfg = sp_cfg

    def snapshot(self) -> dict:
        return {"mode": self.mode, "shards": self.shards,
                "min_tokens": self.min_tokens}


def _clone_cfg(cfg, mode: str):
    """The SP twin of a serving config: EVERY field identical (a shallow
    copy, so a future LlamaConfig knob can never silently revert to its
    default on the SP path only), ``attn_impl`` swapped to the
    sequence-parallel strategy (``mode`` was validated by SPConfig)."""
    import copy

    out = copy.copy(cfg)
    out.attn_impl = mode
    return out


def resolve(sp: Any, *, cfg, mesh, prefill_buckets, max_seq: int,
            page_size: int, spec_k: int, shard_cache: bool,
            devices=None) -> SPPlan | None:
    """Resolve the generator's sequence-parallel plan — or ``None``.

    ``sp`` accepts: ``None`` (consult ``GOFR_ML_SP``; unset → None →
    no SP machinery at all), ``False`` (explicitly off, even when the
    env is set), a mode string, or an ``SPConfig``. Every constraint is
    checked HERE, at construction, with the knob's name in the error —
    nonsense never reaches a device dispatch.
    """
    if sp is False:
        return None
    if sp is None:
        sp = SPConfig.from_env()
        if sp is None:
            return None
    if isinstance(sp, str):
        sp = SPConfig(sp)
    if not isinstance(sp, SPConfig):
        raise ValueError(
            f"sp= must be None, False, 'ring'/'ulysses' or an SPConfig, "
            f"got {type(sp).__name__}")
    if spec_k:
        raise ValueError(
            "GOFR_ML_SP doesn't compose with speculative decoding "
            "(GOFR_ML_SPEC_K) yet — arm one or the other")
    if shard_cache:
        raise ValueError(
            "GOFR_ML_SP doesn't compose with multi-controller "
            "shard_cache — the sp mesh is a single-controller layout")

    from .. import parallel as par

    if mesh is not None:
        sizes = dict(mesh.shape)
        mesh_sp = sizes.get("sp", 1)
        if mesh_sp < 2:
            raise ValueError(
                f"GOFR_ML_SP={sp.mode} needs a mesh with an sp axis of "
                f">= 2 devices; this mesh has sp={mesh_sp}")
        if sp.shards and sp.shards != mesh_sp:
            raise ValueError(
                f"GOFR_ML_SP_SHARDS={sp.shards} != the mesh's sp axis "
                f"size {mesh_sp}")
        shards = mesh_sp
        if page_size and any(v > 1 for ax, v in sizes.items() if ax != "sp"):
            raise ValueError(
                "striped KV pages (page_size > 0 with GOFR_ML_SP) need a "
                "mesh whose only >1 axis is sp; other axes found: "
                f"{ {ax: v for ax, v in sizes.items() if ax != 'sp' and v > 1} }")
    else:
        devs = (list(devices) if devices is not None
                else par.visible_devices())
        shards = sp.shards or len(devs)
        if shards < 2:
            raise ValueError(
                f"GOFR_ML_SP={sp.mode} needs >= 2 devices to shard the "
                f"sequence over, have {len(devs)} "
                f"(GOFR_ML_SP_SHARDS={sp.shards})")
        if shards > len(devs):
            raise ValueError(
                f"GOFR_ML_SP_SHARDS={shards} exceeds the {len(devs)} "
                f"available device(s)")
        mesh = par.make_mesh(par.MeshConfig(sp=shards),
                             devices=devs[:shards])

    if sp.mode == "ulysses" and cfg.n_heads % shards:
        raise ValueError(
            f"GOFR_ML_SP=ulysses needs the head count {cfg.n_heads} to "
            f"divide by the shard count {shards} (use ring, or change "
            f"GOFR_ML_SP_SHARDS)")
    buckets = tuple(prefill_buckets)
    eligible = [b for b in buckets if b >= sp.min_tokens]
    if not eligible:
        raise ValueError(
            f"GOFR_ML_SP_MIN_TOKENS={sp.min_tokens} exceeds the largest "
            f"prefill bucket {max(buckets)} — no prompt could ever take "
            f"the sequence-parallel path")
    for b in eligible:
        if b % shards:
            raise ValueError(
                f"prefill bucket {b} (>= GOFR_ML_SP_MIN_TOKENS="
                f"{sp.min_tokens}) must be a multiple of the sp shard "
                f"count {shards}")
    if not page_size and max_seq % shards:
        raise ValueError(
            f"max_seq {max_seq} must be a multiple of the sp shard count "
            f"{shards} (the dense KV cache shards its sequence axis)")

    return SPPlan(sp.mode, sp.min_tokens, shards, mesh,
                  _clone_cfg(cfg, sp.mode))
