"""PyTorch port, the byte-level BPE tokenizer with its C++ core:
``gofr_tpu_torch.tokenizer`` (``native/bpe.cpp``, the port's copy) against
``gofr_tpu.native.tokenizer`` on the same corpus.

Twins of ``tests/test_tokenizer.py`` (the library builds, roundtrips,
merges compress, native equals the Python path, the byte-level tokenizer,
edge cases), each also held against JAX's ids; then ``train_bpe``'s merges
against JAX's, ids on non-ASCII text and specials, an id past the
vocabulary, a tokenizer made without building anything, and a build that
fails (the tokenizer keeps its Python path, as JAX's does). JAX's
``test_stale_native_builds_swept`` has no twin: the port builds into
``build/`` under a key of source and flags, and leaves its own package
directory alone.
"""

import numpy as np
import pytest

from gofr_tpu.native.tokenizer import BPETokenizer as JBPETokenizer
from gofr_tpu.native.tokenizer import train_bpe as jtrain_bpe
from gofr_tpu_torch import native
from gofr_tpu_torch.tokenizer import BPETokenizer, train_bpe

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "pack my box with five dozen liquor jugs",
    "the five boxing wizards jump quickly",
    "how vexingly quick daft zebras jump",
] * 4
# non-ASCII text (two- to four-byte UTF-8) and a special's spelling
WIDE = ["épée à la crème brûlée, épée", "漢字かな交じり文 漢字",
        "emoji 🙂🙂 and <eos> inside", "naïve café <eos>"] * 3


@pytest.fixture(scope="module")
def pair():
    """JAX's and the port's tokenizer, trained on the same corpus."""
    return (jtrain_bpe(CORPUS, vocab_size=300, specials=["<eos>"]),
            train_bpe(CORPUS, vocab_size=300, specials=["<eos>"]))


@pytest.fixture(scope="module")
def tok(pair):
    return pair[1]


def test_native_library_builds(tok):
    assert tok.native, "the C++ tokenizer did not build (g++ is needed)"


def test_roundtrip(pair):
    jtok, tok = pair
    for text in CORPUS[:4] + ["unseen words épée 漢字 🙂"]:
        assert tok.decode(tok.encode(text)) == text
        assert tok.encode(text) == jtok.encode(text)


def test_merges_compress(tok):
    text = "the quick brown fox"
    assert len(tok.encode(text)) < len(text.encode())


def test_native_matches_python_reference(pair):
    """The C++ heap merger gives the Python path's ids, and JAX's."""
    jtok, tok = pair
    py = BPETokenizer(tok.vocab, tok.merges, tok.byte_map, use_native=False)
    assert not py.native
    rng = np.random.default_rng(0)
    for text in CORPUS + ["zzz", " ", "ab" * 500]:
        assert tok.encode(text) == py.encode(text) == jtok.encode(text)
    for _ in range(20):  # random byte strings, never seen in training
        blob = bytes(rng.integers(0, 256, rng.integers(1, 200)).tolist())
        assert tok.encode(blob) == py.encode(blob) == jtok.encode(blob)
        assert tok.decode_bytes(tok.encode(blob)) == blob


def test_byte_level_fallback_tokenizer():
    tok = BPETokenizer.byte_level(specials=["<eos>"])
    jtok = JBPETokenizer.byte_level(specials=["<eos>"])
    ids = tok.encode("hi")
    assert ids == [104, 105] == jtok.encode("hi")
    assert tok.specials["<eos>"] == 256 == jtok.specials["<eos>"]
    assert tok.decode(ids) == "hi"
    assert tok.native and jtok.native


def test_empty_and_edge_cases(tok):
    assert tok.encode("") == []
    assert tok.decode([]) == ""
    assert len(tok.encode("a")) == 1


def test_train_bpe_merges_equal_jax():
    """The trainer's vocabulary and merges on non-ASCII text and specials,
    and the ids of both packages' three paths."""
    jtok = jtrain_bpe(WIDE + CORPUS, vocab_size=320, specials=["<eos>",
                                                             "<pad>"])
    tok = train_bpe(WIDE + CORPUS, vocab_size=320, specials=["<eos>",
                                                           "<pad>"])
    assert tok.merges == [tuple(m) for m in jtok.merges]
    assert tok.vocab == jtok.vocab and tok.specials == jtok.specials
    assert len(tok.merges) > 20  # multi-byte pairs merged too
    py = BPETokenizer(tok.vocab, tok.merges, tok.byte_map, use_native=False)
    for text in WIDE + ["unseen: Ωμέγα 🙂 <pad>"]:
        ids = tok.encode(text)
        assert ids == py.encode(text) == jtok.encode(text)
        assert tok.decode(ids) == text == jtok.decode(ids)


def test_id_past_the_vocabulary_decodes_to_replacement(tok):
    """A model's vocabulary can exceed the tokenizer's: such an id reads as
    U+FFFD on both paths, as in JAX."""
    jtok = JBPETokenizer(tok.vocab, tok.merges, tok.byte_map)
    ids = tok.encode("fox") + [tok.vocab_size + 7]
    assert tok.decode(ids) == jtok.decode(ids) == "fox�"


def test_python_path_builds_nothing(monkeypatch):
    """``use_native=False`` never asks for the library."""
    def refuse(*_a, **_k):
        raise AssertionError("a build was asked for")

    monkeypatch.setattr(native, "load_library", refuse)
    tok = BPETokenizer.byte_level(use_native=False)
    assert tok.encode("ok") == [111, 107] and not tok.native


def test_failed_build_keeps_the_python_path(monkeypatch, tmp_path):
    """No compiler: the library does not build and the tokenizer encodes
    in Python with the same ids (JAX's ``build_and_load`` returns None)."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(native.BuildError):
        native.load_library("bpe.cpp", "libgofrbpe")
    tok = train_bpe(CORPUS, vocab_size=300)
    assert not tok.native
    assert tok.encode(CORPUS[0]) == jtrain_bpe(CORPUS, 300).encode(CORPUS[0])
