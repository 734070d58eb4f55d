"""MNIST MLP served at ``POST /predict`` on the port — counterpart of
``examples/mnist_server/main.py``, BASELINE config #2: the model in the
``ml`` datasource behind the dynamic batcher, step time and device memory
on ``/metrics``.

    python -m gofr_tpu_torch.examples.mnist_server

``POST /predict`` with ``{"image": [[...28 x 28...]]}`` (or 784 flat
values) answers ``{"digit", "probs"}``; another shape answers 400.
``main(device=None)`` builds the app on the first CUDA card (``device=
"cpu"`` for the plain PyTorch path) with the MLP's random weights from seed
0; ``mount(app, model)`` registers a model the caller holds. Ports:
``HTTP_PORT`` / ``METRICS_PORT``.
"""

from __future__ import annotations

import numpy as np

from .. import resolve_device
from ..app import App, new_app
from ..context import Context
from ..http.errors import InvalidParam
from ..models.mlp import MLP, mnist_mlp

__all__ = ["main", "mount"]


async def predict(ctx: Context):
    body = await ctx.bind()
    image = np.asarray(body.get("image"), dtype=np.float32)
    if image.shape != (28, 28) and image.shape != (784,):
        raise InvalidParam("image (want 28x28 or flat 784)")
    logits = await ctx.ml.predict("mnist", image.reshape(784))
    probs = np.exp(logits - logits.max())
    probs /= probs.sum()
    return {
        "digit": int(np.argmax(logits)),
        "probs": [round(float(p), 5) for p in probs],
    }


def mount(app: App, model: MLP) -> App:
    """Register ``model`` as ``mnist`` (batching on, every bucket captured)
    and the route."""
    app.register_model("mnist", model, batching=True)
    app.post("/predict", predict)
    return app


def main(device=None) -> App:
    return mount(new_app(), mnist_mlp(device=resolve_device(device)))


if __name__ == "__main__":
    main().run()
