"""PyTorch port, real-weights ingestion: twins of ``tests/test_hf_import.py``.
One HF directory, written with the installed ``safetensors`` (the JAX
test's own writer, ``_export_hf``), is read by both packages: the port's
from-scratch parser and importer give the JAX package's leaves bit for bit
(bf16 compared as its 16-bit patterns), ``LLAMA_CKPT`` serves the same
greedy tokens as JAX's Generator at f32, the tokenizer gives JAX's ids, and
``rope_scaling`` flows into the config and validates at load time.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ml import hf_import as jhf
from gofr_tpu.ml.generate import Generator as JGenerator
from gofr_tpu.models import llama as jllama
from gofr_tpu_torch.ml.generate import Generator
from gofr_tpu_torch.ml.hf_import import (hf_config, import_hf_llama,
                                         is_hf_dir, load_hf_tokenizer,
                                         read_safetensors, write_safetensors)
from gofr_tpu_torch.models import llama as tllama
from tests.test_hf_import import _export_hf

pytestmark = pytest.mark.timeout(180)


def _bits(x) -> np.ndarray:
    """A leaf's raw bit pattern (bf16 as uint16), for bit-for-bit checks."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _port_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_paths(v, f"{prefix}['{k}']"))
        return out
    return {prefix: tree}


def _assert_trees_bit_equal(port: dict, ref) -> None:
    want = {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_leaves_with_path(ref)}
    got = _port_paths(port)
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_array_equal(_bits(got[path]), _bits(w),
                                      err_msg=path)
        assert str(got[path].dtype).replace("torch.", "") == \
            np.asarray(w).dtype.name, path


def test_read_safetensors_matches_reference_writer(tmp_path):
    """Both parsers read the official writer's file alike, bf16 included;
    the port's own writer is read back by the official reader."""
    from safetensors.flax import save_file
    from safetensors.numpy import load_file

    tensors = {
        "a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
        "b": jnp.asarray([[1.5, -2.25]], dtype=jnp.bfloat16),
        "c": jnp.asarray([1, 2, 3], dtype=jnp.int8),
        "d": jnp.asarray([[True], [False]]),
    }
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path)
    got, want = read_safetensors(path), jhf.read_safetensors(path)
    assert set(got) == set(want) == set(tensors)
    for name, ref in tensors.items():
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]))
        np.testing.assert_array_equal(_bits(got[name]), _bits(ref))

    mine = str(tmp_path / "mine.safetensors")
    write_safetensors(mine, got)
    back = load_file(mine)
    for name in ("a", "c", "d"):
        np.testing.assert_array_equal(back[name], np.asarray(tensors[name]))
    np.testing.assert_array_equal(_bits(read_safetensors(mine)["b"]),
                                  _bits(tensors["b"]))


@pytest.mark.parametrize("shards", [1, 3])
def test_hf_roundtrip_params_equal(tmp_path, shards):
    cfg = jllama.tiny_llama(use_flash=False)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    model_dir = str(tmp_path / "hf")
    _export_hf(cfg, params, model_dir, shards=shards)

    assert is_hf_dir(model_dir) and not is_hf_dir(str(tmp_path))
    got_cfg, got = import_hf_llama(model_dir, device="cpu")
    jcfg, jgot = jhf.import_hf_llama(model_dir)
    for name in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                 "ffn_dim", "max_seq_len", "rope_theta", "norm_eps",
                 "eos_id", "tie_word_embeddings"):
        assert getattr(got_cfg, name) == getattr(jcfg, name), name
    assert got_cfg.eos_id == 2
    _assert_trees_bit_equal(got, jgot)
    _assert_trees_bit_equal(got, params)


def test_hf_tied_embeddings(tmp_path):
    cfg = jllama.tiny_llama(use_flash=False)
    params = jllama.init_params(cfg, jax.random.PRNGKey(1))
    model_dir = str(tmp_path / "hf")
    _export_hf(cfg, params, model_dir, tie=True)
    _, got = import_hf_llama(model_dir, device="cpu")
    _, want = jhf.import_hf_llama(model_dir)
    np.testing.assert_array_equal(_bits(got["lm_head"]),
                                  _bits(want["lm_head"]))
    assert torch.equal(got["lm_head"], got["embed"].T)


def test_llama_ckpt_env_serves_hf_weights(tmp_path, monkeypatch):
    """``LLAMA_CKPT=<hf dir>`` boots the imported architecture and weights
    through ``config_from_env`` / ``params_from_config`` and generates the
    JAX Generator's greedy tokens on the original tree (f32)."""
    cfg = jllama.tiny_llama(use_flash=False, dtype=jnp.float32)
    params = jllama.init_params(cfg, jax.random.PRNGKey(2))
    model_dir = str(tmp_path / "hf")
    _export_hf(cfg, params, model_dir)

    monkeypatch.setenv("LLAMA_CKPT", model_dir)
    monkeypatch.setenv("LLAMA_DTYPE", "f32")
    boot_cfg = tllama.config_from_env()
    assert boot_cfg.dim == cfg.dim and boot_cfg.eos_id == 2
    assert boot_cfg.dtype == torch.float32
    boot_params = tllama.params_from_config(boot_cfg, device="cpu")

    prompt = [5, 9, 2]
    want = JGenerator(params, cfg, batch_slots=1, max_seq=64,
                      prefill_buckets=(8,)).generate(prompt, 8)
    got = Generator(boot_params, boot_cfg, batch_slots=1, max_seq=64,
                    prefill_buckets=(8,), device="cpu").generate(prompt, 8)
    assert got == want

    # w8 quantizes the imported weights
    monkeypatch.setenv("LLAMA_W8", "1")
    w8_cfg = tllama.config_from_env()
    q = tllama.params_from_config(w8_cfg, device="cpu")
    want_q, _ = tllama.quantize_weight(boot_params["lm_head"])
    assert torch.equal(q["lm_head"]["q"], want_q)


def _tokenizer_json(path):
    dec_chars = {b: ch for ch, b in jhf._gpt2_byte_decoder().items()}
    vocab = {dec_chars[b]: b for b in range(256)}
    vocab[dec_chars[ord("h")] + dec_chars[ord("e")]] = 256      # "he"
    vocab[dec_chars[ord("l")] + dec_chars[ord("l")]] = 257      # "ll"
    vocab["hello".translate(str.maketrans(
        {c: dec_chars[ord(c)] for c in "hello"}))] = 258
    vocab[dec_chars[ord("l")] + dec_chars[ord("o")]] = 259      # "lo"
    merges = [f"{dec_chars[ord('h')]} {dec_chars[ord('e')]}",
              f"{dec_chars[ord('l')]} {dec_chars[ord('l')]}",
              f"{dec_chars[ord('l')]} {dec_chars[ord('o')]}"]
    tj = {"model": {"type": "BPE", "vocab": vocab, "merges": merges},
          "added_tokens": [{"id": 300, "content": "<|eot|>"},
                           {"id": 301, "content": "<|start|>"}]}
    path.write_text(json.dumps(tj))
    return str(path)


def test_load_hf_tokenizer_byte_level(tmp_path):
    """The same tokenizer.json through both packages: the port's ids equal
    JAX's on strings with merges, specials and unseen bytes; decode is
    exact."""
    path = _tokenizer_json(tmp_path / "tokenizer.json")
    tok, jtok = load_hf_tokenizer(path), jhf.load_hf_tokenizer(path)
    assert tok.encode("hello") == [256, 257, ord("o")]
    assert tok.specials == jtok.specials == {"<|eot|>": 300,
                                             "<|start|>": 301}
    for text in ("hello", "hello world", "<|start|>hello<|eot|>",
                 "yellow hollow", "héllo ☃", "", "llllo"):
        assert tok.encode(text) == jtok.encode(text), text
        assert tok.decode(tok.encode(text)) == text
    raw = bytes([0, 7, 255])
    assert tok.encode(raw) == jtok.encode(raw)
    assert tok.decode_bytes(tok.encode(raw)) == raw
    assert tok.decode([300]) == jtok.decode([300]) == "<|eot|>"
    assert tok.vocab_size == jtok.vocab_size
    # a model dir holding tokenizer.json loads the same tables
    assert load_hf_tokenizer(str(tmp_path)).encode("hello") == [256, 257, 111]


def test_hf_config_rope_scaling_flows_and_validates(tmp_path):
    cfg = jllama.tiny_llama(use_flash=False)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    model_dir = str(tmp_path / "hf")
    _export_hf(cfg, params, model_dir)
    with open(os.path.join(model_dir, "config.json")) as f:
        hc = json.load(f)
    hc["rope_scaling"] = {
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 64}
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(hc, f)

    got = hf_config(model_dir)
    assert got.rope_scaling == jhf.hf_config(model_dir).rope_scaling
    assert got.rope_scaling["rope_type"] == "llama3"
    # the scaled config changes the forward pass, as in JAX
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, params),
                                     device="cpu")
    x = np.arange(24, dtype=np.int32).reshape(1, 24)
    scaled = tllama.forward(tparams, x, got)
    plain = tllama.forward(tparams, x, tllama.tiny_llama())
    assert not torch.allclose(scaled, plain)
    want = jllama.forward(params, x, jhf.hf_config(model_dir))
    np.testing.assert_allclose(scaled.numpy(), np.asarray(want, np.float32),
                               atol=5e-2)

    hc["rope_scaling"] = {"rope_type": "yarn", "factor": 2.0}
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(hc, f)
    with pytest.raises(ValueError, match="rope_scaling"):
        hf_config(model_dir)
