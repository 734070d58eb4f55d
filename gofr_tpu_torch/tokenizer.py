"""Byte-level BPE tokenizer — counterpart of ``gofr_tpu/native/
tokenizer.py``: a C++ core (``native/bpe.cpp``, the port's copy of JAX's)
loaded with ``ctypes``, and a pure-Python path with the same ids.

Python owns formats and vocabulary construction; the native library sees
flat tables (the vocabulary blob, the byte map, merge triples). Both paths
merge the lowest-ranked adjacent pair first, leftmost on ties, so their ids
are identical and the Python path is the oracle in tests. ``use_native``
(default True) builds the library on first use (``native/__init__.py``);
where it does not build, the tokenizer keeps the Python path, as JAX's
does, and ``.native`` says which runs: the tokenizer is host code, not the
device path.

``decode_bytes`` degrades an id past the vocabulary to U+FFFD instead of
raising: a model's vocabulary can exceed the tokenizer's (random 8b
weights emit any id below 128256 over the 257-entry byte vocabulary).
``train_bpe`` is JAX's tiny greedy trainer.
"""

from __future__ import annotations

import ctypes
import heapq
import struct
from typing import Iterable, Sequence

__all__ = ["BPETokenizer", "train_bpe"]


class BPETokenizer:
    """``vocab``: id -> bytes; ``merges``: ordered (left, right, merged)
    ids; ``byte_map``: raw byte value -> base token id."""

    def __init__(self, vocab: Sequence[bytes],
                 merges: Sequence[tuple[int, int, int]],
                 byte_map: Sequence[int] | None = None, *,
                 specials: dict[str, int] | None = None,
                 use_native: bool = True) -> None:
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
        # the C++ core is built and made at first use, not here: examples
        # make their tokenizer when imported
        self._core: _NativeBPE | None = None
        self._core_made = not use_native

    @property
    def _native(self) -> "_NativeBPE | None":
        if not self._core_made:
            self._core = _NativeBPE.create(self.vocab, self.merges,
                                           self.byte_map)
            self._core_made = True
        return self._core

    @property
    def native(self) -> bool:
        """Whether the C++ core encodes and decodes."""
        return self._native is not None

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @classmethod
    def byte_level(cls, *, specials: Iterable[str] = (),
                   use_native: bool = True) -> "BPETokenizer":
        """The 256 single bytes plus ``specials`` appended (``<eos>`` makes
        257): the tokenizer when no trained vocabulary is mounted."""
        vocab = [bytes([i]) for i in range(256)]
        sp = {}
        for name in specials:
            sp[name] = len(vocab)
            vocab.append(name.encode())
        return cls(vocab, [], specials=sp, use_native=use_native)

    def encode(self, text: str | bytes) -> list[int]:
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        if not data:
            return []
        native = self._native
        if native is not None:
            return native.encode(data)
        return self._encode_py(data)

    def decode(self, ids: Sequence[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        n = len(self.vocab)
        if any(not 0 <= int(i) < n for i in ids):
            return b"".join(self.vocab[int(i)] if 0 <= int(i) < n
                            else b"\xef\xbf\xbd" for i in ids)
        native = self._native
        if native is not None and len(ids):
            return native.decode([int(i) for i in ids])
        return b"".join(self.vocab[int(i)] for i in ids)

    # -- the pure-Python path ------------------------------------------------
    def _encode_py(self, data: bytes) -> list[int]:
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


class _NativeBPE:
    """The ``ctypes`` binding over ``libgofrbpe`` (``native/bpe.cpp``'s C
    interface)."""

    def __init__(self, lib, handle) -> None:
        self._lib = lib
        self._handle = handle

    @classmethod
    def create(cls, vocab, merges, byte_map) -> "_NativeBPE | None":
        """The native tokenizer over these tables, or None where the
        library does not build."""
        from .native import BuildError, load_library

        try:
            lib = load_library("bpe.cpp", "libgofrbpe")
        except (BuildError, OSError):
            return None
        lib.gofr_bpe_new.restype = ctypes.c_void_p
        lib.gofr_bpe_new.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_uint32]
        lib.gofr_bpe_encode.restype = ctypes.c_int64
        lib.gofr_bpe_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_uint64]
        lib.gofr_bpe_decode.restype = ctypes.c_int64
        lib.gofr_bpe_decode.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_uint64]
        # without argtypes ctypes cuts the 64-bit handle to a C int
        lib.gofr_bpe_free.restype = None
        lib.gofr_bpe_free.argtypes = [ctypes.c_void_p]
        blob = b"".join(struct.pack("<I", len(v)) + v for v in vocab)
        bm = (ctypes.c_int32 * 256)(*byte_map)
        flat = [x for merge in merges for x in merge]
        mg = (ctypes.c_int32 * max(len(flat), 1))(*flat)
        handle = lib.gofr_bpe_new(blob, len(blob), len(vocab), bm, mg,
                                  len(merges))
        if not handle:
            return None
        return cls(lib, handle)

    def encode(self, data: bytes) -> list[int]:
        out = (ctypes.c_int32 * len(data))()
        n = self._lib.gofr_bpe_encode(self._handle, data, len(data), out,
                                      len(data))
        if n < 0:
            raise RuntimeError("bpe encode overflow")
        return list(out[:n])

    def decode(self, ids: list[int]) -> bytes:
        arr = (ctypes.c_int32 * len(ids))(*ids)
        cap = 16
        while True:  # grow the buffer until the bytes fit
            buf = ctypes.create_string_buffer(cap * len(ids))
            n = self._lib.gofr_bpe_decode(self._handle, arr, len(ids), buf,
                                          len(buf))
            if n >= 0:
                return buf.raw[:n]
            if cap > 4096:
                raise RuntimeError("bpe decode failed (unknown id?)")
            cap *= 4

    def __del__(self):
        lib, handle = getattr(self, "_lib", None), getattr(self, "_handle",
                                                           None)
        if lib is not None and handle:
            lib.gofr_bpe_free(handle)


def train_bpe(corpus: Iterable[str | bytes], vocab_size: int, *,
              specials: Iterable[str] = (), use_native: bool = True
              ) -> BPETokenizer:
    """JAX's tiny reference trainer (greedy most-frequent pair, ties to the
    smallest pair): real vocabularies for examples and tests without
    external files."""
    specials = tuple(specials)  # a generator would be spent on first use
    data = [t.encode("utf-8") if isinstance(t, str) else bytes(t)
            for t in corpus]
    vocab: list[bytes] = [bytes([i]) for i in range(256)]
    seqs = [list(d) for d in data if d]
    merges: list[tuple[int, int, int]] = []
    while len(vocab) < vocab_size - len(specials):
        counts: dict[tuple[int, int], int] = {}
        for seq in seqs:
            for a, b in zip(seq, seq[1:]):
                counts[(a, b)] = counts.get((a, b), 0) + 1
        if not counts:
            break
        (a, b), freq = max(counts.items(),
                           key=lambda kv: (kv[1], -kv[0][0], -kv[0][1]))
        if freq < 2:
            break
        new_id = len(vocab)
        vocab.append(vocab[a] + vocab[b])
        merges.append((a, b, new_id))
        for seq in seqs:
            i = 0
            while i < len(seq) - 1:
                if seq[i] == a and seq[i + 1] == b:
                    seq[i:i + 2] = [new_id]
                else:
                    i += 1
    sp = {}
    for name in specials:
        sp[name] = len(vocab)
        vocab.append(name.encode())
    return BPETokenizer(vocab, merges, specials=sp, use_native=use_native)
