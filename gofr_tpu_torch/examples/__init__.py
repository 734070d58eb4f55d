"""Runnable examples of the port: ``python -m
gofr_tpu_torch.examples.llama_server`` serves Llama chat over HTTP, WS
and gRPC on the card."""
