"""Serving layer of the port: the dense-cache ``Generator`` (generate.py),
its host-side scheduling policy (scheduler.py), the ``LLMServer`` that owns
it on a serving thread (llm.py) and the typed errors clients see
(errors.py)."""
