"""An ML service that keeps its replies, on the port: the framework around
the model in one app.

- ``PUT  /chat/{id}`` with ``{"prompt_ids": [...], "max_new_tokens": n}``
  generates through ``ctx.ml.llm("chat")`` and stores the prompt and the
  tokens in the ``chat`` table through the ``Chat`` CRUD entity (its own
  ``update`` verb: a PUT creates or replaces), answering
  ``{"id", "tokens"}``;
- ``GET  /chat/{id}``, ``GET /chat``, ``DELETE /chat/{id}``: the
  generated CRUD verbs over the stored rows (``prompt`` and ``tokens``
  as JSON text);
- ``POST /generate``: the tokens alone, stored nowhere.

Every route but ``/.well-known/*`` wants an ``X-Api-Key`` of
``CHAT_API_KEYS`` (comma-separated; the app refuses to start without
one). A migration creates the table; SQL is ``DB_DIALECT=sqlite`` with
``DB_NAME``.

    DB_DIALECT=sqlite DB_NAME=/tmp/chat.db CHAT_API_KEYS=k1 \\
        LLAMA_PRESET=8b python -m gofr_tpu_torch.examples.chat_store

``main(device=None)`` builds it on the first CUDA card (``device="cpu"``
for the plain PyTorch path) with the model of ``LLAMA_PRESET`` and
random weights from seed 0; ``mount(app, params, cfg, api_keys=...)``
mounts weights the caller holds.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os

from .. import resolve_device
from ..app import App, new_app
from ..context import Context
from ..crud import insert_query, scan_entity, update_query
from ..http.errors import InvalidParam, MissingParam
from ..migration import Migrate
from ..models import llama

__all__ = ["Chat", "MIGRATIONS", "main", "mount"]

DEFAULT_MAX_NEW = 32


def create_chat_table(ds) -> None:
    ds.sql.exec("CREATE TABLE IF NOT EXISTS chat (id INTEGER PRIMARY KEY,"
                " prompt TEXT NOT NULL, tokens TEXT NOT NULL)")


MIGRATIONS = {1: Migrate(up=create_chat_table)}


async def _generate(ctx: Context) -> tuple[list[int], list[int]]:
    body = await ctx.bind()
    ids = body.get("prompt_ids") if isinstance(body, dict) else None
    if not ids:
        raise MissingParam("prompt_ids")
    max_new = int(body.get("max_new_tokens", DEFAULT_MAX_NEW))
    return ids, await ctx.ml.llm("chat").generate(ids, max_new)


@dataclasses.dataclass
class Chat:
    id: int = 0
    prompt: str = dataclasses.field(default="", metadata={"sql": "not_null"})
    tokens: str = dataclasses.field(default="", metadata={"sql": "not_null"})

    async def update(self, ctx: Context):
        """PUT /chat/{id}: generate, then store the row (replace or
        create) with the CRUD entity's statements."""
        try:
            chat_id = int(ctx.path_param("id"))
        except ValueError:
            raise InvalidParam("id") from None
        ids, tokens = await _generate(ctx)
        meta, dialect = scan_entity(Chat), ctx.sql.dialect
        row = Chat(chat_id, json.dumps(ids), json.dumps(tokens))

        def store() -> None:
            with ctx.sql.begin() as tx:
                if tx.exec(update_query(meta, ["prompt", "tokens"], dialect),
                           row.prompt, row.tokens, row.id) == 0:
                    tx.exec(insert_query(meta, meta.fields, dialect),
                            row.id, row.prompt, row.tokens)

        await asyncio.to_thread(store)
        return {"id": chat_id, "tokens": tokens}


async def generate(ctx: Context):
    _, tokens = await _generate(ctx)
    return {"tokens": tokens}


def mount(app: App, params, cfg, *, api_keys, **kwargs) -> App:
    """API-key auth over ``api_keys``, the migrations, the ``chat`` LLM on
    ``params`` / ``cfg`` (``kwargs`` go to ``register_llm``) and the
    routes."""
    if not api_keys:
        raise ValueError("chat_store needs at least one API key")
    if app.container.sql is None:
        raise ValueError("chat_store needs SQL: set DB_DIALECT=sqlite")
    app.enable_api_key_auth(*api_keys)
    app.migrate(MIGRATIONS)
    app.register_llm("chat", params, cfg, **kwargs)
    app.add_rest_handlers(Chat)
    app.post("/generate", generate)
    return app


def main(device=None) -> App:
    device = resolve_device(device)
    app = new_app()
    keys = [k for k in app.config.get_or_default("CHAT_API_KEYS",
                                                 "").split(",") if k]
    cfg = llama.config_from_env()
    params = llama.params_from_config(cfg, device=device)
    return mount(app, params, cfg, api_keys=keys, device=device,
                 batch_slots=int(os.environ.get("LLM_SLOTS", "4")),
                 max_seq=min(cfg.max_seq_len, 1024))


if __name__ == "__main__":
    main().run()
