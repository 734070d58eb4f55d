"""Speculative decoding for one stream — counterpart of
``gofr_tpu/ml/speculate.py``: prompt-lookup (n-gram) drafts and a batched
verify.

Plain decode runs one token a step, and every step sweeps the weights out
of device memory. A verify window checks K drafted tokens in ONE pass of
K+1 positions (``llama.decode_window``), so the sweep amortizes over every
accepted token, and with greedy sampling the output is the verifier's own
argmax chain: a bad draft costs speed, never correctness. Drafts come from
prompt lookup: the longest trailing n-gram of the history is matched
against its earlier occurrences and what followed the most recent one is
proposed. Acceptance is a host-side prefix match, and "rollback" is not
advancing ``len`` past the accepted prefix (the rejected rows are written
again before any query reaches them).

``SpeculativeDecoder`` is the standalone single-stream loop (greedy only,
fp KV cache only, as in JAX); the serving path is the ``Generator``'s
device-resident speculation (``generate.py``, ``spec_k``), which also
composes with the int8 cache, pages and draft models.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["propose_lookup", "SpeculativeDecoder"]


def propose_lookup(history: Sequence[int], k: int, max_ngram: int = 3
                   ) -> list[int]:
    """Draft up to ``k`` tokens by matching the longest trailing n-gram
    against the earlier history and copying what followed it."""
    h = list(history)
    n_hist = len(h)
    for n in range(min(max_ngram, n_hist - 1), 0, -1):
        pattern = h[-n:]
        # the most recent earlier occurrence wins (local context first)
        for start in range(n_hist - n - 1, -1, -1):
            if h[start:start + n] == pattern:
                follow = h[start + n:start + n + k]
                if follow:
                    return follow
    return []


class SpeculativeDecoder:
    """Greedy decode of one stream with prompt-lookup speculation.

    ``generate()`` emits exactly the greedy continuation (the verify
    window's argmax chain); ``accepted`` / ``proposed`` count the drafts.
    The model runs where ``params`` live. Needs the fp KV cache.
    """

    def __init__(self, params, cfg, *, k: int = 4, max_ngram: int = 3,
                 max_seq: int | None = None, draft_fn=None) -> None:
        if cfg.kv_quant:
            raise ValueError("speculative decode needs the fp KV cache")
        self.params = params
        self.cfg = cfg
        self.k = k
        self.max_ngram = max_ngram
        self.max_seq = max_seq or cfg.max_seq_len
        # draft_fn(history, k) -> up to k proposed tokens; prompt lookup
        # when None
        self.draft_fn = draft_fn
        self.accepted = 0
        self.proposed = 0

    def generate(self, prompt_ids, max_new_tokens: int) -> list[int]:
        from ..models import llama

        cfg, params = self.cfg, self.params
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        n = len(prompt)
        if n == 0 or n + max_new_tokens + self.k + 1 > self.max_seq:
            raise ValueError("prompt + max_new + draft window must fit max_seq")
        dev = params["embed"].device
        cache = llama.init_cache(cfg, 1, self.max_seq, device=dev)
        logits, cache = llama.prefill(params, prompt[None], np.array([n]),
                                      cfg, cache)
        first = int(logits[0].argmax())
        history = [int(t) for t in prompt] + [first]
        out = [first]
        K = self.k + 1
        while len(out) < max_new_tokens:
            pos0 = int(cache["len"][0])
            if pos0 + K <= self.max_seq:
                props = (list(self.draft_fn(history, self.k))
                         if self.draft_fn is not None
                         else propose_lookup(history, self.k, self.max_ngram))
            else:
                props = []
            if len(props) == self.k:
                window = torch.tensor([[history[-1]] + props],
                                      dtype=torch.int32, device=dev)
                logits, cache = llama.decode_window(params, window, cache, cfg)
                greedy = logits[0].argmax(-1).tolist()
                n_acc = 0
                while n_acc < self.k and props[n_acc] == greedy[n_acc]:
                    n_acc += 1
                new_tokens = props[:n_acc] + [greedy[n_acc]]
                self.proposed += self.k
                self.accepted += n_acc
                cache["len"] += 1 + n_acc
            else:
                tok = torch.tensor([history[-1]], dtype=torch.int32,
                                   device=dev)
                logits, cache = llama.decode_step(params, tok, cache, cfg)
                new_tokens = [int(logits[0].argmax())]
            take = new_tokens[:max_new_tokens - len(out)]
            out.extend(take)
            history.extend(take)
        return out

    def reset_counters(self) -> None:
        """Zero the accepted / proposed tallies (after a warm-up run, so
        ``acceptance_rate`` covers only the measured window)."""
        self.accepted = 0
        self.proposed = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0
