"""Byte-level BPE tokenizer — counterpart of the pure-Python path of
``gofr_tpu/native/tokenizer.py`` (the C++ ``bpe.cpp`` binding is not
ported; the JAX package's two paths give the same ids).

Encoding merges the lowest-ranked adjacent pair first, leftmost on ties.
``decode_bytes`` degrades an id past the vocabulary to U+FFFD instead of
raising: a model's vocabulary can exceed the tokenizer's (random 8b
weights emit any id below 128256 over the 257-entry byte vocabulary).
"""

from __future__ import annotations

import heapq
from typing import Iterable, Sequence

__all__ = ["BPETokenizer"]


class BPETokenizer:
    """``vocab``: id -> bytes; ``merges``: ordered (left, right, merged)
    ids; ``byte_map``: raw byte value -> base token id."""

    def __init__(self, vocab: Sequence[bytes],
                 merges: Sequence[tuple[int, int, int]],
                 byte_map: Sequence[int] | None = None, *,
                 specials: dict[str, int] | None = None) -> None:
        if byte_map is None:
            byte_map = list(range(256))
        if len(byte_map) != 256:
            raise ValueError("byte_map must have 256 entries")
        self.vocab = [bytes(v) for v in vocab]
        self.merges = [tuple(m) for m in merges]
        self.byte_map = list(byte_map)
        self.specials = dict(specials or {})
        self._ranks = {(l, r): (i, m)
                       for i, (l, r, m) in enumerate(self.merges)}

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @classmethod
    def byte_level(cls, *, specials: Iterable[str] = ()) -> "BPETokenizer":
        """The 256 single bytes plus ``specials`` appended (``<eos>`` makes
        257): the tokenizer when no trained vocabulary is mounted."""
        vocab = [bytes([i]) for i in range(256)]
        sp = {}
        for name in specials:
            sp[name] = len(vocab)
            vocab.append(name.encode())
        return cls(vocab, [], specials=sp)

    def encode(self, text: str | bytes) -> list[int]:
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        if not data:
            return []
        ids = [self.byte_map[b] for b in data]
        nxt = list(range(1, len(ids))) + [-1]
        prv = [-1] + list(range(len(ids) - 1))
        heap: list[tuple[int, int, tuple[int, int]]] = []

        def push(pos: int) -> None:
            n = nxt[pos]
            if n < 0:
                return
            info = self._ranks.get((ids[pos], ids[n]))
            if info is not None:
                heapq.heappush(heap, (info[0], pos, (ids[pos], ids[n])))

        for i in range(len(ids) - 1):
            push(i)
        while heap:
            rank, left, key = heapq.heappop(heap)
            if ids[left] < 0:
                continue
            r = nxt[left]
            if r < 0 or (ids[left], ids[r]) != key:
                continue  # stale: a neighbour merged since the push
            info = self._ranks.get(key)
            if info is None or info[0] != rank:
                continue
            ids[left] = info[1]
            ids[r] = -1
            nxt[left] = nxt[r]
            if nxt[r] >= 0:
                prv[nxt[r]] = left
            if prv[left] >= 0:
                push(prv[left])
            push(left)
        out = []
        i = 0
        while i >= 0:
            out.append(ids[i])
            i = nxt[i]
        return out

    def decode(self, ids: Sequence[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        n = len(self.vocab)
        return b"".join(self.vocab[int(i)] if 0 <= int(i) < n
                        else b"\xef\xbf\xbd" for i in ids)
