"""BERT embeddings service on the port — counterpart of
``examples/bert_server/main.py``, BASELINE config #3 (gRPC unary, batch
32): ``ml.Embeddings/Embed`` over gRPC and ``POST /embed`` over HTTP, one
engine behind the dynamic batcher. Concurrent calls coalesce into padded
batches of ``MAX_LEN`` tokens; each row carries its valid length, so
padding does not change an embedding.

    BERT_PRESET=base python -m gofr_tpu_torch.examples.bert_server

Both take ``{"token_ids": [...]}`` (cut to ``MAX_LEN``) and answer
``{"embedding": [...]}``; no ids answers 400. ``BERT_PRESET=tiny|base``
(default tiny) picks the encoder, with random weights from seed 0.
``main(device=None)`` builds the app on the first CUDA card (``device=
"cpu"`` for the plain PyTorch path); ``mount(app, model)`` registers an
encoder the caller holds. Ports: ``HTTP_PORT`` / ``GRPC_PORT`` /
``METRICS_PORT``.
"""

from __future__ import annotations

import os

import numpy as np

from .. import resolve_device
from ..app import App, new_app
from ..context import Context
from ..grpc import JSONService
from ..http.errors import MissingParam
from ..models import bert

__all__ = ["MAX_LEN", "main", "mount"]

MAX_LEN = 128


def _prep(ids):
    ids = list(ids)[:MAX_LEN]
    n = len(ids)
    padded = np.zeros((MAX_LEN,), np.int32)
    padded[:n] = ids
    return padded, np.int32(n)


async def embed(ctx: Context):
    body = await ctx.bind()
    ids = body.get("token_ids")
    if not ids:
        raise MissingParam("token_ids")
    padded, n = _prep(ids)
    vec = await ctx.ml.predict("bert", padded, n)
    return {"embedding": [round(float(v), 6) for v in vec]}


def mount(app: App, model: bert.Bert) -> App:
    """Register ``model`` as ``bert`` (batching on, every bucket captured
    at ``MAX_LEN``), the HTTP route and the gRPC service."""
    model.example_inputs = (
        np.zeros((1, MAX_LEN), np.int32), np.full((1,), 1, np.int32),
    )
    app.register_model("bert", model, batching=True)
    app.post("/embed", embed)

    svc = JSONService("ml.Embeddings")

    async def grpc_embed(request, context):
        padded, n = _prep(request["token_ids"])
        vec = await app.container.ml.predict("bert", padded, n)
        return {"embedding": [float(v) for v in vec]}

    svc.unary("Embed", grpc_embed)
    app.register_service(svc, impl=None)
    return app


def main(device=None) -> App:
    preset = os.environ.get("BERT_PRESET", "tiny")
    cfg = bert.tiny_bert() if preset == "tiny" else bert.bert_base()
    return mount(new_app(), bert.Bert(cfg, device=resolve_device(device)))


if __name__ == "__main__":
    main().run()
