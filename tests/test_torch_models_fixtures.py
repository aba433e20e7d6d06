"""The port's models/fixtures.py against the JAX package's: the constants
equal, and every function that builds a checkpoint, called with the same
arguments, writes the same files byte for byte (config.json,
generation_config.json, model.safetensors and the tokenizer files):
``train_tiny_family`` for each of the four families with and without
``KERNEL_SHAPE_OVERRIDES`` at a few steps, ``make_tiny_hf_checkpoint``
untrained and trained, and ``make_tiny_hf_encoder_checkpoint``.

One exception is the reference's own: ``tokenizers``' WordPiece trainer
numbers the continuation alphabet ("##a", "##i", ...) in hash order, and
merges of equal counts follow those ids, so the JAX package's
``train_wordpiece_tokenizer`` writes a different tokenizer.json on two calls
in one process. There the files hold the same vocabulary as a set, the same
special tokens at the same ids and every other field equal
(``assert_same_wordpiece``); the byte-level BPE trainer is deterministic and
its files are held byte for byte."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from vnsum_tpu.models import fixtures as jf
from vnsum_tpu_torch.models import fixtures as tf

from test_torch_ops_flash import one_torch_thread  # noqa: F401

VI_EVAL = Path(__file__).resolve().parent.parent / "data" / "vi_eval"


def corpus() -> list[str]:
    return [p.read_text(encoding="utf-8") for p in sorted((VI_EVAL / "doc").glob("*.txt"))]


def assert_same_files(a: Path, b: Path, wordpiece: bool = False) -> None:
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    assert "tokenizer.json" in names
    for name in names:
        if wordpiece and name == "tokenizer.json":
            assert_same_wordpiece(a / name, b / name)
        else:
            assert (a / name).read_bytes() == (b / name).read_bytes(), name


def assert_same_wordpiece(a: Path, b: Path) -> None:
    """Two WordPiece tokenizer.json files: the same vocabulary, the special
    tokens at the same ids, every other field equal."""
    ja, jb = (json.loads(p.read_text(encoding="utf-8")) for p in (a, b))
    va, vb = ja["model"].pop("vocab"), jb["model"].pop("vocab")
    assert ja == jb  # added_tokens (the specials and their ids) included
    assert set(va) == set(vb) and len(va) == len(vb)
    assert {t["content"]: va[t["content"]] for t in ja["added_tokens"]} == {
        t["content"]: vb[t["content"]] for t in jb["added_tokens"]}


@pytest.mark.parametrize("name", ["GEN_CORPUS", "TRAINED_FAMILIES", "KERNEL_SHAPE_OVERRIDES",
                                  "_BOS", "_EOS", "_PAD"])
def test_constants_equal(name):
    assert getattr(tf, name) == getattr(jf, name)


@pytest.mark.parametrize("overrides", [None, "kernel_shape"])
@pytest.mark.parametrize("family", sorted(jf.TRAINED_FAMILIES))
def test_train_tiny_family_writes_the_same_files(tmp_path, family, overrides):
    kw = {"steps": 3,
          "overrides": dict(jf.KERNEL_SHAPE_OVERRIDES) if overrides else None}
    jf.train_tiny_family(family, tmp_path / "jax", **kw)
    tf.train_tiny_family(family, tmp_path / "torch", **kw)
    assert_same_files(tmp_path / "jax", tmp_path / "torch")


def test_train_tiny_family_takes_a_corpus_and_longer_positions(tmp_path):
    """The committed fixture's arguments (scripts/make_torch_fixture.py):
    a corpus of its own and max_position_embeddings over the override."""
    kw = {"steps": 2, "corpus": corpus()[:2],
          "overrides": {**jf.KERNEL_SHAPE_OVERRIDES, "max_position_embeddings": 2048}}
    jf.train_tiny_family("llama", tmp_path / "jax", **kw)
    _, tok = tf.train_tiny_family("llama", tmp_path / "torch", **kw)
    assert_same_files(tmp_path / "jax", tmp_path / "torch")
    assert len(tok) == 384


@pytest.mark.parametrize("train_steps", [0, 2])
def test_make_tiny_hf_checkpoint_writes_the_same_files(tmp_path, train_steps):
    kw = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
              intermediate=128, max_seq_len=256, train_steps=train_steps,
              train_seq_len=32, train_batch=4)
    want = jf.make_tiny_hf_checkpoint(tmp_path / "jax", corpus(), **kw)
    got = tf.make_tiny_hf_checkpoint(tmp_path / "torch", corpus(), **kw)
    assert got == want
    assert_same_files(tmp_path / "jax", tmp_path / "torch")


def test_make_tiny_hf_encoder_checkpoint_writes_the_same_files(tmp_path):
    kw = dict(vocab_size=512, dim=32, n_layers=2, n_heads=2, intermediate=64, max_len=128)
    want = jf.make_tiny_hf_encoder_checkpoint(tmp_path / "jax", corpus(), **kw)
    got = tf.make_tiny_hf_encoder_checkpoint(tmp_path / "torch", corpus(), **kw)
    assert got == want
    assert_same_files(tmp_path / "jax", tmp_path / "torch", wordpiece=True)
    assert "model.safetensors" in {p.name for p in (tmp_path / "torch").iterdir()}


def test_tokenizers_train_the_same(tmp_path):
    for fn, vocab in (("train_bpe_tokenizer", 384), ("train_wordpiece_tokenizer", 512)):
        getattr(jf, fn)(corpus(), vocab_size=vocab).save_pretrained(tmp_path / f"jax_{fn}")
        getattr(tf, fn)(corpus(), vocab_size=vocab).save_pretrained(tmp_path / f"torch_{fn}")
        assert_same_files(tmp_path / f"jax_{fn}", tmp_path / f"torch_{fn}",
                          wordpiece=fn == "train_wordpiece_tokenizer")
