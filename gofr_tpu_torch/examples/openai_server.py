"""OpenAI-compatible chat/completions API over the port's continuous-
batching LLM — counterpart of ``examples/openai_server/main.py``, with the
same routes, bodies and knobs, so clients built for the OpenAI wire format
(SDKs, curl recipes) point at it unchanged:

- ``POST /v1/chat/completions`` — messages in, a choice out; ``"stream":
  true`` sends ``chat.completion.chunk`` frames over SSE ending with
  ``data: [DONE]`` (``stream_options.include_usage`` adds a usage frame)
- ``POST /v1/completions``      — a prompt in, text out (and streaming)
- ``GET  /v1/models``           — the model listing

    LLAMA_PRESET=8b python -m gofr_tpu_torch.examples.openai_server

``main(device=None)`` builds the app on the first CUDA card (``device=
"cpu"`` for the plain PyTorch path); ``mount(app, params, cfg, **kw)``
registers the model and the routes on weights the caller holds. Knobs:
those of ``examples/llama_server.py`` (the model, ``LLM_SLOTS`` default 4,
``LLM_CHUNK``, ``LLM_TEMPERATURE``, ``LLM_PAGE_SIZE``, ``LLM_PAGES``,
``LLM_PREFILL_CHUNK``, ``LLM_SPEC_K``), ``MODEL_ID`` (default
``gofr-llama``), and the headers ``X-Request-Priority`` (``high`` /
``normal`` / ``low``) and ``X-Request-Deadline-S``. The byte-level
tokenizer keeps the example self-contained; ``LLM_DISAGG=1`` with
``GOFR_ML_REPLICAS=2`` boots a disaggregated pool as in
``llama_server.py``; ``LLAMA_CKPT`` / ``TOKENIZER_JSON`` (ROADMAP A.12)
raise.
"""

from __future__ import annotations

import codecs
import math
import os
import time
import uuid

from .. import resolve_device
from ..app import App, new_app
from ..context import Context
from ..http.errors import InvalidInput, InvalidParam, MissingParam
from ..http.response import Raw
from ..http.sse import EventStream
from ..ml.generate import Sampler, spec_k_from_env
from ..ml.scheduler import normalize_priority
from ..models import llama
from ..tokenizer import BPETokenizer
from .llama_server import _tokenizer_from_env

__all__ = ["main", "mount"]

TOKENIZER = BPETokenizer.byte_level(specials=["<eos>"])
MODEL_ID = os.environ.get("MODEL_ID", "gofr-llama")


def _render_chat(messages) -> str:
    """Minimal chat template: role-tagged lines and an assistant cue."""
    lines = [f"{m.get('role', 'user')}: {m.get('content', '')}"
             for m in messages]
    lines.append("assistant:")
    return "\n".join(lines)


def _decode(ids) -> str:
    """Ids beyond the tokenizer's vocabulary (a model with a larger
    embedding, the 8b preset on random weights) render as U+FFFD instead
    of failing the request."""
    vocab = TOKENIZER.vocab_size
    if all(0 <= i < vocab for i in ids):
        return TOKENIZER.decode(list(ids))
    return "".join(TOKENIZER.decode([i]) if 0 <= i < vocab else "�"
                   for i in ids)


class _StreamDecoder:
    """Incremental token -> text for streaming: a multi-byte UTF-8
    character split across byte-level tokens must not surface as
    replacement characters mid-stream."""

    def __init__(self) -> None:
        self._dec = codecs.getincrementaldecoder("utf-8")(errors="replace")

    def push(self, tok: int) -> str:
        if not 0 <= tok < TOKENIZER.vocab_size:
            return "�"
        return self._dec.decode(TOKENIZER.decode_bytes([tok]))

    def flush(self) -> str:
        return self._dec.decode(b"", True)


def _usage(prompt_toks, completion_toks) -> dict:
    return {"prompt_tokens": prompt_toks,
            "completion_tokens": completion_toks,
            "total_tokens": prompt_toks + completion_toks}


def _choice_delta(index, content=None, role=None, finish=None) -> dict:
    delta = {}
    if role:
        delta["role"] = role
    if content is not None:
        delta["content"] = content
    return {"index": index, "delta": delta, "finish_reason": finish}


def _admissible_or_400(llm, ids, max_new) -> None:
    """Reject a request that can never admit before any stream opens:
    once SSE headers are on the wire a clean 400 is impossible."""
    try:
        llm.check_admissible(ids, max_new)
    except ValueError as exc:
        raise InvalidInput(str(exc)) from exc


def _priority_or_400(ctx) -> int:
    """The admission class from ``X-Request-Priority``: the OpenAI wire
    format has no priority field, so the transport carries it."""
    try:
        return normalize_priority(ctx.headers.get("X-Request-Priority"))
    except ValueError as exc:
        raise InvalidInput(str(exc)) from exc


def _deadline_or_400(ctx):
    """The request's TTL from ``X-Request-Deadline-S`` (seconds); absent
    defers to ``GOFR_ML_DEFAULT_DEADLINE_S``."""
    raw = ctx.headers.get("X-Request-Deadline-S")
    if raw is None:
        return None
    try:
        deadline = float(raw)
        if not math.isfinite(deadline) or deadline < 0:
            raise ValueError
    except (TypeError, ValueError):
        raise InvalidInput(
            f"X-Request-Deadline-S must be a finite number >= 0, "
            f"got {raw!r}") from None
    return deadline


def _openai_finish(info: dict, n_out: int, max_new: int) -> str:
    """The server's finish reason in OpenAI's vocabulary: an eviction (a
    dry page pool truncated the answer) reports "length", never a false
    natural "stop"; the precise reason rides ``gofr_finish_reason``."""
    reason = info.get("finish_reason")
    if reason == "eviction":
        return "length"
    if reason in ("stop", "length"):
        return reason
    return "length" if n_out >= max_new else "stop"


def _finish_extra(info: dict) -> dict:
    return ({"gofr_finish_reason": "eviction"}
            if info.get("finish_reason") == "eviction" else {})


def _chunk(kind: str, rid: str, created: int, choices) -> dict:
    return {"id": rid, "object": kind, "created": created,
            "model": MODEL_ID, "choices": choices}


async def chat_completions(ctx: Context):
    body = await ctx.bind()
    messages = body.get("messages")
    if not messages:
        raise MissingParam("messages")
    max_new = int(body.get("max_tokens") or 64)
    llm = ctx.ml.llm(MODEL_ID)
    # shared-prefix reuse is the server's: over a paged generator its
    # radix cache matches this prompt at admission
    ids = TOKENIZER.encode(_render_chat(messages))
    n_prompt = len(ids)
    _admissible_or_400(llm, ids, max_new)
    prio = _priority_or_400(ctx)
    ttl = _deadline_or_400(ctx)
    rid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
    created = int(time.time())

    if body.get("stream"):
        async with EventStream(ctx) as stream:
            await stream.send(_chunk(
                "chat.completion.chunk", rid, created,
                [_choice_delta(0, role="assistant", content="")]))
            n_out = 0
            dec = _StreamDecoder()
            fin: dict = {}
            # one SSE chunk per decode burst (a delta may carry several
            # tokens' text: valid protocol, far fewer frames)
            async for burst in llm.stream_chunks(ids, max_new, info=fin,
                                                 priority=prio,
                                                 deadline_s=ttl):
                n_out += len(burst)
                await stream.send(_chunk(
                    "chat.completion.chunk", rid, created,
                    [_choice_delta(0, content="".join(
                        dec.push(t) for t in burst))]))
            tail = dec.flush()
            if tail:
                await stream.send(_chunk(
                    "chat.completion.chunk", rid, created,
                    [_choice_delta(0, content=tail)]))
            await stream.send(_chunk(
                "chat.completion.chunk", rid, created,
                [{**_choice_delta(0, finish=_openai_finish(fin, n_out,
                                                           max_new)),
                  **_finish_extra(fin)}]))
            if (body.get("stream_options") or {}).get("include_usage"):
                await stream.send({**_chunk("chat.completion.chunk", rid,
                                            created, []),
                                   "usage": _usage(n_prompt, n_out)})
            await stream.done()
        return stream.response

    fin = {}
    try:
        toks = await llm.generate(ids, max_new, info=fin, priority=prio,
                                  deadline_s=ttl)
    except ValueError as exc:
        # an admission race between the check above and the serving thread
        raise InvalidInput(str(exc)) from exc
    return Raw({
        "id": rid, "object": "chat.completion", "created": created,
        "model": MODEL_ID,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant", "content": _decode(toks)},
            "finish_reason": _openai_finish(fin, len(toks), max_new),
            **_finish_extra(fin),
        }],
        "usage": _usage(n_prompt, len(toks)),
    })


async def completions(ctx: Context):
    body = await ctx.bind()
    prompt = body.get("prompt")
    if prompt is None:
        raise MissingParam("prompt")
    if isinstance(prompt, list):
        # one completion a request: a one-string list is that string
        if len(prompt) == 1 and isinstance(prompt[0], str):
            prompt = prompt[0]
        else:
            raise InvalidParam("prompt (batch/token-array prompts "
                               "unsupported: send one string)")
    ids = TOKENIZER.encode(prompt)
    max_new = int(body.get("max_tokens") or 64)
    llm = ctx.ml.llm(MODEL_ID)
    _admissible_or_400(llm, ids, max_new)
    prio = _priority_or_400(ctx)
    ttl = _deadline_or_400(ctx)
    rid = f"cmpl-{uuid.uuid4().hex[:24]}"
    created = int(time.time())

    if body.get("stream"):
        async with EventStream(ctx) as stream:
            n_out = 0
            dec = _StreamDecoder()
            fin: dict = {}
            async for burst in llm.stream_chunks(ids, max_new, info=fin,
                                                 priority=prio,
                                                 deadline_s=ttl):
                n_out += len(burst)
                await stream.send(_chunk(
                    "text_completion", rid, created,
                    [{"index": 0,
                      "text": "".join(dec.push(t) for t in burst),
                      "finish_reason": None}]))
            await stream.send(_chunk(
                "text_completion", rid, created,
                [{"index": 0, "text": dec.flush(),
                  "finish_reason": _openai_finish(fin, n_out, max_new),
                  **_finish_extra(fin)}]))
            await stream.done()
        return stream.response

    fin = {}
    try:
        toks = await llm.generate(ids, max_new, info=fin, priority=prio,
                                  deadline_s=ttl)
    except ValueError as exc:
        raise InvalidInput(str(exc)) from exc
    return Raw({
        "id": rid, "object": "text_completion", "created": created,
        "model": MODEL_ID,
        "choices": [{"index": 0, "text": _decode(toks),
                     "finish_reason": _openai_finish(fin, len(toks),
                                                     max_new),
                     **_finish_extra(fin)}],
        "usage": _usage(len(ids), len(toks)),
    })


async def models(ctx: Context):
    return Raw({
        "object": "list",
        "data": [{"id": MODEL_ID, "object": "model",
                  "created": 0, "owned_by": "gofr-tpu"}],
    })


def mount(app: App, params, cfg, **kwargs) -> App:
    """Register the LLM ``MODEL_ID`` on ``params`` / ``cfg`` with the
    example's generator knobs (``kwargs``, e.g. ``device``, go to
    ``register_llm`` over them) and the three routes."""
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
        eos_id=getattr(cfg, "eos_id", None),
        spec_k=spec_k, draft_params=draft_params, draft_cfg=draft_cfg,
        prefill_chunk=int(os.environ.get("LLM_PREFILL_CHUNK", "0")),
        page_size=int(os.environ.get("LLM_PAGE_SIZE", "0")),
        n_pages=int(os.environ.get("LLM_PAGES", "0")) or None,
        **({"disagg": raw_disagg == "1"} if raw_disagg else {}))
    knobs.update(kwargs)
    app.register_llm(MODEL_ID, params, cfg, **knobs)
    app.post("/v1/chat/completions", chat_completions)
    app.post("/v1/completions", completions)
    app.get("/v1/models", models)
    return app


def main(device=None) -> App:
    """The example app on ``device`` (default the first CUDA card): the
    model from ``LLAMA_PRESET`` with random weights from seed 0."""
    global TOKENIZER
    device = resolve_device(device)
    TOKENIZER = _tokenizer_from_env()
    cfg = llama.config_from_env(tiny_vocab_size=TOKENIZER.vocab_size)
    params = llama.params_from_config(cfg, device=device)
    return mount(new_app(), params, cfg, device=device)


if __name__ == "__main__":
    main().run()
