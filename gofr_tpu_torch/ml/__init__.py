"""Serving layer of the port: the ``Generator`` over a dense or paged KV
cache (generate.py), its host-side scheduling policy (scheduler.py), the
shared-prefix cache policy (prefix_cache.py), the ``LLMServer`` that owns
the generator on a serving thread (llm.py) and the typed errors clients
see (errors.py)."""
