"""Llama chat serving on the port — counterpart of
``examples/llama_server/main.py``, with the same handlers, environment
knobs and transports:

- ``POST /generate``          -> the full completion (JSON)
- ``WS   /stream``            -> one ``{"token": id}`` frame per token
- gRPC ``llm.Chat/Generate``  -> one JSON frame per decode burst

    LLAMA_PRESET=8b python -m gofr_tpu_torch.examples.llama_server

``main(device=None)`` builds the app on the first CUDA card (``device=
"cpu"`` for the plain PyTorch path); ``mount(app, params, cfg, **kw)``
registers the model and the routes on an app, so a caller can mount
weights it already holds. Knobs: ``LLAMA_PRESET`` / ``LLAMA_DTYPE`` /
``LLAMA_KV_QUANT`` / ``LLAMA_W8`` / ``GOFR_ML_KV_BITS`` (the model),
``LLM_SLOTS``, ``LLM_CHUNK``, ``LLM_TEMPERATURE``, ``LLM_PAGE_SIZE``,
``LLM_PAGES``, ``LLM_PREFILL_CHUNK``, ``LLM_SPEC_K`` (speculative
decoding, falling back to ``GOFR_ML_SPEC_K``; drafts from
``LLM_DRAFT_PRESET=self|tiny|1b``, else prompt lookup) (the generator),
the server's ``GOFR_ML_*`` knobs, and ``HTTP_PORT`` / ``GRPC_PORT`` /
``METRICS_PORT``. ``GOFR_ML_REPLICAS=2`` serves through a replica pool
(on one card the replicas share the weights), and ``LLM_DISAGG=1`` with
it (falling back to ``GOFR_ML_DISAGG``) splits the pool into a
prefill-biased and a decode replica over the KV transport (paged
generators only: set ``LLM_PAGE_SIZE``). Real weights: ``LLAMA_CKPT``
names an HF directory (it defines the architecture, and its
``tokenizer.json``, when present, the tokenizer) or a ``Checkpointer``
directory (a params tree or a training state; the preset gives the
architecture); ``TOKENIZER_JSON`` names a tokenizer over either;
``LLM_DRAFT_CKPT`` an HF draft. A checkpoint's ``eos_token_id`` ends a
stream.
"""

from __future__ import annotations

import math
import os

from .. import resolve_device
from ..app import App, new_app
from ..context import Context
from ..grpc import JSONService
from ..http.errors import InvalidInput, MissingParam
from ..ml.generate import Sampler, spec_k_from_env
from ..ml.scheduler import normalize_priority
from ..models import llama
from ..tokenizer import BPETokenizer

__all__ = ["main", "mount"]

# byte-level fallback vocabulary: 256 bytes + <eos>; a real one loads from
# TOKENIZER_JSON or the LLAMA_CKPT directory's tokenizer.json in main()
TOKENIZER = BPETokenizer.byte_level(specials=["<eos>"])


def _tokenizer_from_env() -> BPETokenizer:
    tk = os.environ.get("TOKENIZER_JSON")
    ckpt = os.environ.get("LLAMA_CKPT")
    if not tk and ckpt and os.path.isfile(os.path.join(ckpt,
                                                       "tokenizer.json")):
        tk = os.path.join(ckpt, "tokenizer.json")
    if tk:
        from ..ml.hf_import import load_hf_tokenizer

        return load_hf_tokenizer(tk)
    return BPETokenizer.byte_level(specials=["<eos>"])


def _prompt_ids(body) -> list[int]:
    if body.get("prompt_ids"):
        return body["prompt_ids"]
    if body.get("prompt"):
        return TOKENIZER.encode(body["prompt"])
    raise MissingParam("prompt or prompt_ids")


def _admissible(llm, ids, max_new) -> None:
    """A request that can never admit answers 400 / INVALID_ARGUMENT
    before any stream opens."""
    try:
        llm.check_admissible(ids, max_new)
    except ValueError as exc:
        raise InvalidInput(str(exc)) from exc


def _priority(body) -> int:
    """``"priority": "high" | "normal" | "low"``; unknown values answer
    400, not a demotion."""
    try:
        return normalize_priority(body.get("priority"))
    except ValueError as exc:
        raise InvalidInput(str(exc)) from exc


def _deadline(body):
    """``"deadline_s": 2.5``: past it the request is reaped, queued or
    mid-decode, with 504 / DEADLINE_EXCEEDED. None defers to
    ``GOFR_ML_DEFAULT_DEADLINE_S``."""
    raw = body.get("deadline_s")
    if raw is None:
        return None
    try:
        deadline = float(raw)
        if not math.isfinite(deadline) or deadline < 0:
            raise ValueError
    except (TypeError, ValueError):
        raise InvalidInput(
            f"deadline_s must be a finite number >= 0, got {raw!r}") from None
    return deadline


async def generate(ctx: Context):
    body = await ctx.bind()
    ids = _prompt_ids(body)
    max_new = int(body.get("max_new_tokens", 64))
    llm = ctx.ml.llm("chat")
    _admissible(llm, ids, max_new)
    tokens = await llm.generate(ids, max_new, priority=_priority(body),
                                deadline_s=_deadline(body))
    out = {"tokens": tokens}
    if body.get("prompt"):  # text in -> text out
        out["text"] = TOKENIZER.decode(tokens)
    return out


async def stream_ws(ctx: Context):
    body = await ctx.bind()
    ids = _prompt_ids(body)
    llm = ctx.ml.llm("chat")
    max_new = int(body.get("max_new_tokens", 64))
    _admissible(llm, ids, max_new)
    async for tok in llm.stream(ids, max_new, priority=_priority(body),
                                deadline_s=_deadline(body)):
        await ctx.write_message_to_socket({"token": tok})
    return {"done": True}


def mount(app: App, params, cfg, **kwargs) -> App:
    """Register the ``chat`` LLM on ``params`` / ``cfg`` with the
    example's generator knobs (``kwargs``, e.g. ``device``, go to
    ``register_llm`` over them) and the three transports' routes."""
    # LLM_SPEC_K, falling back to GOFR_ML_SPEC_K through its validated
    # parse; the draft model from LLM_DRAFT_PRESET when set
    raw_spec = os.environ.get("LLM_SPEC_K", "").strip()
    spec_k = int(raw_spec) if raw_spec else spec_k_from_env()
    draft_params, draft_cfg = (llama.draft_from_env(cfg, params)
                               if spec_k else (None, None))
    raw_disagg = os.environ.get("LLM_DISAGG", "").strip()
    if raw_disagg and raw_disagg not in ("0", "1"):
        raise ValueError(f"LLM_DISAGG must be 0 or 1, got {raw_disagg!r}")
    knobs = dict(
        batch_slots=int(os.environ.get("LLM_SLOTS", "4")),
        max_seq=min(cfg.max_seq_len, 1024),
        chunk=int(os.environ.get("LLM_CHUNK", "4")),
        sampler=Sampler(temperature=float(
            os.environ.get("LLM_TEMPERATURE", "0"))),
        # a checkpoint carries its stop id (hf_config); random-weight
        # presets keep decoding to max_new (any id is as likely as eos)
        eos_id=getattr(cfg, "eos_id", None), spec_k=spec_k,
        draft_params=draft_params,
        draft_cfg=draft_cfg,
        prefill_chunk=int(os.environ.get("LLM_PREFILL_CHUNK", "0")),
        page_size=int(os.environ.get("LLM_PAGE_SIZE", "0")),
        n_pages=int(os.environ.get("LLM_PAGES", "0")) or None,
        **({"disagg": raw_disagg == "1"} if raw_disagg else {}))
    knobs.update(kwargs)
    app.register_llm("chat", params, cfg, **knobs)
    app.post("/generate", generate)
    app.websocket("/stream", stream_ws)

    svc = JSONService("llm.Chat")

    async def grpc_generate(request, context):
        # one frame per decode burst, not per token
        llm = app.container.ml.llm("chat")
        max_new = int(request.get("max_new_tokens", 64))
        _admissible(llm, request["prompt_ids"], max_new)
        async for burst in llm.stream_chunks(request["prompt_ids"], max_new,
                                             priority=_priority(request),
                                             deadline_s=_deadline(request)):
            yield {"tokens": burst}

    svc.stream("Generate", grpc_generate)
    app.register_service(svc, impl=None)
    return app


def main(device=None) -> App:
    """The example app on ``device`` (default the first CUDA card): the
    model from ``LLAMA_PRESET`` with random weights from seed 0, or from
    ``LLAMA_CKPT``."""
    global TOKENIZER
    device = resolve_device(device)
    TOKENIZER = _tokenizer_from_env()
    app = new_app()
    cfg = llama.config_from_env(tiny_vocab_size=TOKENIZER.vocab_size)
    params = llama.params_from_config(cfg, device=device)
    return mount(app, params, cfg, device=device)


if __name__ == "__main__":
    main().run()
