"""Text-to-image serving on the port — counterpart of
``examples/sdxl_server/main.py``, BASELINE config #5.

Per request: prompt -> the byte-level BPE tokenizer -> the BERT encoder's
hidden states (the cross-attention context) -> the DiT's DDIM sampler ->
a fixed linear latent->RGB map -> PNG. Both models ride the ``ml`` engine
(the sampler, guidance 5.0, is the DiT engine's apply: one CUDA graph a
batch shape on a card), so device work never blocks the event loop.

    DIT_PRESET=base DIT_STEPS=30 python -m gofr_tpu_torch.examples.sdxl_server

``GET /image?prompt=...`` answers ``image/png``. ``DIT_PRESET=tiny|base``
(default tiny; base = a BERT-base encoder and DiT-XL/2), ``DIT_STEPS``
(default 8), random weights from seed 0. JAX draws the sampler's initial
noise from ``PRNGKey(0)`` inside the program; threefry has no torch
counterpart, so here it is drawn once a batch shape from a generator seeded
0 on the device: a prompt always gives the same image, not JAX's image.
``main(device=None)`` builds the app on the first CUDA card (``device=
"cpu"`` for the plain PyTorch path); ``mount(app, encoder, dit)`` registers
models the caller holds. Ports: ``HTTP_PORT`` / ``METRICS_PORT``.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from .. import resolve_device
from ..app import App, new_app
from ..context import Context
from ..http.response import File
from ..models import bert, diffusion
from ..tokenizer import BPETokenizer

__all__ = ["MAX_CTX", "main", "mount"]

TOKENIZER = BPETokenizer.byte_level()
MAX_CTX = 32
GUIDANCE = 5.0


def _png(rgb: np.ndarray) -> bytes:
    """Minimal PNG writer (no imaging libraries needed)."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[i].astype(np.uint8).tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def _latent_to_rgb(latents: np.ndarray) -> np.ndarray:
    """Fixed linear latent->RGB map (VAE stand-in)."""
    mix = np.array([[0.6, 0.2, 0.1, 0.1],
                    [0.1, 0.6, 0.2, 0.1],
                    [0.1, 0.1, 0.2, 0.6]], np.float32)
    img = latents @ mix.T
    img = (img - img.min()) / max(float(np.ptp(img)), 1e-6)
    return (img * 255).astype(np.uint8)


async def image(ctx: Context):
    prompt = ctx.param("prompt") or "a photo"
    ids = TOKENIZER.encode(prompt)[:MAX_CTX]
    padded = np.zeros((MAX_CTX,), np.int32)
    padded[: len(ids)] = ids

    emb = await ctx.ml.predict(
        "text_encoder", padded[None], np.array([max(len(ids), 1)], np.int32))
    context = np.asarray(emb)  # [1, S, ctx_dim] hidden states

    latents = await ctx.ml.predict("dit", context)
    rgb = _latent_to_rgb(np.asarray(latents)[0])
    return File(_png(rgb), content_type="image/png")


def _sampler(cfg: diffusion.DiTConfig, steps: int):
    """The DiT engine's apply: ``ddim_sample`` from noise drawn once a batch
    shape (a generator seeded 0 on the context's device), so a prompt
    always gives the same image."""
    noise: dict[int, torch.Tensor] = {}

    def sample(params, context):
        b = context.shape[0]
        if b not in noise:
            gen = torch.Generator(device=context.device).manual_seed(0)
            noise[b] = torch.randn(
                (b, cfg.latent_size, cfg.latent_size, cfg.latent_channels),
                generator=gen, device=context.device, dtype=torch.float32)
        return diffusion.ddim_sample(params, context, cfg, noise[b],
                                     steps=steps, guidance=GUIDANCE)

    return sample


def mount(app: App, encoder: bert.Bert, dit: diffusion.DiT,
          steps: int | None = None) -> App:
    """Register the encoder as ``text_encoder`` (its hidden states) and the
    sampler over ``dit`` as ``dit`` (``steps``, default ``DIT_STEPS``),
    and the route."""
    enc_cfg = encoder.cfg
    if steps is None:
        steps = int(os.environ.get("DIT_STEPS", "8"))
    app.register_model(
        "text_encoder", encoder,
        apply_fn=lambda p, toks, n: bert.forward(
            p, toks, enc_cfg, seq_lens=n)["hidden"],
        params=encoder.params,
        example_inputs=(np.zeros((1, MAX_CTX), np.int32),
                        np.full((1,), 1, np.int32)),
    )
    app.register_model(
        "dit", dit, apply_fn=_sampler(dit.cfg, steps), params=dit.params,
        example_inputs=(np.zeros((1, MAX_CTX, enc_cfg.dim), np.float32),),
    )
    app.get("/image", image)
    return app


def main(device=None) -> App:
    device = resolve_device(device)
    app = new_app()
    if os.environ.get("DIT_PRESET", "tiny") == "tiny":
        enc_cfg = bert.tiny_bert(vocab_size=max(257, TOKENIZER.vocab_size))
        dit_cfg = diffusion.tiny_dit(ctx_dim=enc_cfg.dim)
    else:
        enc_cfg = bert.bert_base()
        dit_cfg = diffusion.dit_xl(ctx_dim=enc_cfg.dim)
    return mount(app, bert.Bert(enc_cfg, device=device),
                 diffusion.DiT(dit_cfg, device=device))


if __name__ == "__main__":
    main().run()
