"""Models of the port. ``llama`` is the Llama-3 decoder of the serving path."""
