"""Runnable examples of the port, each ``python -m
gofr_tpu_torch.examples.<name>`` on the card: ``llama_server`` (Llama chat
over HTTP, WS and gRPC, BASELINE config #4), ``mnist_server`` (config #2),
``bert_server`` (config #3) and ``sdxl_server`` (config #5)."""
