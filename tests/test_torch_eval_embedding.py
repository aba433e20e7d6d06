"""The port's eval encoder and embedding metrics (vnsum_tpu_torch.models.
encoder, models.convert_encoder, eval.embedding, eval.semantic,
utils.evaluate_summaries) against the JAX package's, on the same weights.

A JAX ``tiny_encoder`` parameter tree, converted to numpy, becomes the
port's through ``encoder_params_from_numpy``. Everything is f32 and
differs only in summation order: embeddings, cosines and scores agree
within EMBED_ATOL (~1e-7 observed). A HF BERT checkpoint built by the JAX
package's fixture (``transformers.BertModel`` saved to safetensors, with a
WordPiece tokenizer) loads on both sides and in ``transformers``.
"""
from __future__ import annotations

import functools
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from vnsum_tpu.eval import EmbeddingModel as JaxEmbeddingModel
from vnsum_tpu.eval import SemanticEvaluator as JaxSemanticEvaluator
from vnsum_tpu.eval.embedding import bert_scores as jax_bert_scores
from vnsum_tpu.eval.embedding import cosine_similarities as jax_cosine
from vnsum_tpu.models import encoder as je
from vnsum_tpu.models.convert_encoder import load_hf_encoder as jax_load_hf_encoder
from vnsum_tpu.models.fixtures import make_tiny_hf_encoder_checkpoint
from vnsum_tpu.utils import evaluate_summaries as jax_evaluate
from vnsum_tpu_torch.backend.fake import FakeBackend
from vnsum_tpu_torch.eval import EmbeddingModel, LLMJudge, SemanticEvaluator
from vnsum_tpu_torch.eval.embedding import bert_scores, cosine_similarities
from vnsum_tpu_torch.models import encoder as te
from vnsum_tpu_torch.models.convert_encoder import load_hf_encoder
from vnsum_tpu_torch.pipeline import runner as port_runner
from vnsum_tpu_torch.utils import evaluate_summaries as port_evaluate

from test_torch_ops_flash import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).resolve().parent.parent / "data" / "vi_eval"
EMBED_ATOL = 1e-5
TEXTS = ["Quốc hội thông qua nghị quyết về kinh tế.", "tóm tắt văn bản một", "",
         "Nhà trường tổ chức kỳ thi tốt nghiệp. " * 4, "một hai ba"]
REFS = ["Quốc hội thông qua nghị quyết.", "tóm tắt văn bản hai", "x", "", "một hai ba"]


def carried_embedders(max_len: int = 64, batch_size: int = 4):
    """(JAX EmbeddingModel, port EmbeddingModel on the CPU) on
    ``tiny_encoder`` with the same weights: the JAX model's random init,
    carried leaf for leaf."""
    jm = JaxEmbeddingModel(config=je.tiny_encoder(), max_len=max_len, batch_size=batch_size)
    params = te.encoder_params_from_numpy(
        jax.tree.map(np.asarray, jm.params), te.tiny_encoder(), device="cpu")
    pm = EmbeddingModel(config=te.tiny_encoder(), params=params, max_len=max_len,
                        batch_size=batch_size, device="cpu")
    return jm, pm


def small_default_encoder(monkeypatch) -> None:
    """Makes the port runner's default encoder (a random-init minilm_like at
    max_len 512: ~15 s a [32, 512] batch on one CPU thread) a tiny one, for
    CLI tests that do not check the embedding metrics' values."""
    monkeypatch.setattr(port_runner, "EmbeddingModel", functools.partial(
        EmbeddingModel, config=te.tiny_encoder(), max_len=64))


def tiny_bert_dir(root: Path) -> Path:
    """A tiny HF BERT checkpoint (config.json, model.safetensors, WordPiece
    tokenizer) at ``root``, built on the data/vi_eval summaries."""
    corpus = [p.read_text(encoding="utf-8") for p in sorted((FIXTURE / "summary").glob("*.txt"))]
    make_tiny_hf_encoder_checkpoint(root, corpus, vocab_size=512, max_len=128)
    return root


def assert_embedding_stats_close(got: dict, want: dict) -> None:
    """The embedding columns of two summary_statistics blocks, within
    EMBED_ATOL; both present and finite."""
    for key in ("semantic_similarity", "bert_scores"):
        assert sorted(got[key]) == sorted(want[key])
        for field, v in want[key].items():
            assert math.isfinite(got[key][field])
            assert got[key][field] == pytest.approx(v, abs=EMBED_ATOL), (key, field)


@pytest.fixture(scope="module")
def embedders():
    return carried_embedders()


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    return tiny_bert_dir(tmp_path_factory.mktemp("bert"))


def test_encode_and_mean_pool_match_jax(embedders):
    jm, pm = embedders
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 259, size=(3, 40)).astype(np.int32)
    mask = np.ones((3, 40), dtype=bool)
    mask[1, 25:] = False
    mask[2, 7:] = False
    want = je.encode(jm.params, jm.cfg, toks, mask)
    got = te.encode(pm.params, pm.cfg, torch.from_numpy(toks), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=EMBED_ATOL, rtol=0)
    np.testing.assert_allclose(
        te.mean_pool(got, torch.from_numpy(mask)).numpy(),
        np.asarray(je.mean_pool(want, mask)), atol=EMBED_ATOL, rtol=0)


def test_sentence_cosine_and_bert_scores_match_jax(embedders):
    jm, pm = embedders
    got_emb, want_emb = pm.sentence_embeddings(TEXTS), np.asarray(jm.sentence_embeddings(TEXTS))
    np.testing.assert_allclose(got_emb, want_emb, atol=EMBED_ATOL, rtol=0)
    refs_g, refs_w = pm.sentence_embeddings(REFS), np.asarray(jm.sentence_embeddings(REFS))
    np.testing.assert_allclose(cosine_similarities(got_emb, refs_g),
                               jax_cosine(want_emb, refs_w), atol=EMBED_ATOL, rtol=0)
    # 5 pairs at batch 4: a full chunk and a padded one
    got, want = bert_scores(pm, TEXTS, REFS), jax_bert_scores(jm, TEXTS, REFS)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose([g.precision, g.recall, g.f1],
                                   [w.precision, w.recall, w.f1], atol=EMBED_ATOL, rtol=0)


def test_identical_texts_score_one_and_empty_stays_finite(embedders):
    _, pm = embedders
    same = bert_scores(pm, TEXTS[:2] + TEXTS[3:], TEXTS[:2] + TEXTS[3:])
    assert all(s.f1 == pytest.approx(1.0, abs=1e-6) for s in same)
    emb = pm.sentence_embeddings(TEXTS)
    assert cosine_similarities(emb, emb)[0] == pytest.approx(1.0, abs=1e-6)
    # an empty side contributes 0, never -inf or NaN
    empty = bert_scores(pm, ["", "a b", ""], ["a b", "", ""])
    assert [(s.precision, s.recall, s.f1) for s in empty] == [(0.0, 0.0, 0.0)] * 3
    assert np.isfinite(cosine_similarities(pm.sentence_embeddings([""]), emb[:1])).all()


def test_load_hf_encoder_matches_jax_and_transformers(bert_dir):
    transformers = pytest.importorskip("transformers")
    cfg, params = load_hf_encoder(str(bert_dir), device="cpu")
    jcfg, jparams = jax_load_hf_encoder(str(bert_dir))
    assert (cfg.vocab_size, cfg.dim, cfg.n_layers, cfg.n_heads, cfg.intermediate,
            cfg.max_len, cfg.norm_eps) == (jcfg.vocab_size, jcfg.dim, jcfg.n_layers,
                                           jcfg.n_heads, jcfg.intermediate, jcfg.max_len,
                                           jcfg.norm_eps)
    carried = te.encoder_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    for key in ("tok_embed", "pos_embed"):
        assert torch.equal(params[key], carried[key])
    for key, stack in params["layers"].items():
        assert torch.equal(stack, carried["layers"][key]), key

    # the embeddings of real tokenized text against transformers' BertModel
    texts = TEXTS[:2] + TEXTS[3:]
    model = EmbeddingModel.from_hf(str(bert_dir), batch_size=4, device="cpu")
    assert model._cls is not None and model._sep is not None
    embs, mask = model.token_embeddings(texts)
    hf_tok = transformers.AutoTokenizer.from_pretrained(str(bert_dir))
    hf = transformers.AutoModel.from_pretrained(str(bert_dir)).eval()
    enc = hf_tok(texts, padding="max_length", max_length=model.max_len, truncation=True,
                 return_tensors="pt")
    assert torch.equal(mask, enc["attention_mask"].bool())
    with torch.no_grad():
        want = hf(**enc).last_hidden_state
    m = mask[..., None]
    np.testing.assert_allclose((embs * m).numpy(), (want * m).numpy(), atol=1e-4, rtol=0)
    jm = JaxEmbeddingModel.from_hf(str(bert_dir), batch_size=4)
    np.testing.assert_allclose(model.sentence_embeddings(texts),
                               np.asarray(jm.sentence_embeddings(texts)), atol=EMBED_ATOL, rtol=0)


def folders(root: Path) -> tuple[Path, Path]:
    """Generated and reference folders over data/vi_eval: each reference
    summary against its document's first 300 characters, an identical pair,
    an empty summary, and an unpaired file."""
    gen, ref = root / "gen", root / "ref"
    gen.mkdir()
    ref.mkdir()
    for i, p in enumerate(sorted((FIXTURE / "summary").glob("*.txt"))[:5]):
        summary = p.read_text(encoding="utf-8")
        doc = (FIXTURE / "doc" / p.name).read_text(encoding="utf-8")
        (ref / p.name).write_text(summary, encoding="utf-8")
        (gen / p.name).write_text([doc[:300], summary, ""][min(i, 2)], encoding="utf-8")
    (gen / "unpaired.txt").write_text("không có tham chiếu", encoding="utf-8")
    return gen, ref


def test_semantic_evaluator_matches_jax(tmp_path, embedders):
    jm, pm = embedders
    gen, ref = folders(tmp_path)
    got = SemanticEvaluator(pm).evaluate_folders(gen, ref, output=tmp_path / "out" / "r.json")
    want = JaxSemanticEvaluator(jm).evaluate_folders(gen, ref)
    stats, jstats = got["summary_statistics"], want["summary_statistics"]
    assert set(stats) == set(jstats) == {"semantic_similarity", "rouge_scores", "bert_scores"}
    assert stats["rouge_scores"] == jstats["rouge_scores"]
    assert_embedding_stats_close(stats, jstats)
    assert [d["filename"] for d in got["detailed_results"]] == [
        d["filename"] for d in want["detailed_results"]]
    for d, jd in zip(got["detailed_results"], want["detailed_results"]):
        assert d["semantic_similarity"] == pytest.approx(jd["semantic_similarity"], abs=EMBED_ATOL)
    assert json.loads((tmp_path / "out" / "r.json").read_text()) == got
    assert SemanticEvaluator(pm).evaluate_pairs(
        {"a.txt": "xin chào"}, {"a.txt": "xin chào"})["summary_statistics"][
        "bert_scores"]["bert_f1"] == pytest.approx(1.0, abs=1e-6)


def test_evaluate_summaries_cli_matches_jax(tmp_path, monkeypatch, capsys, embedders):
    jm, pm = embedders
    gen, ref = folders(tmp_path)
    # the CLIs' default encoder is minilm_like with random weights of each
    # framework's own generator: give both the same carried tiny one
    monkeypatch.setattr(port_evaluate, "EmbeddingModel", lambda device: pm)
    monkeypatch.setattr(jax_evaluate, "EmbeddingModel", lambda: jm)
    outs = {}
    for name, mod in (("port", port_evaluate), ("jax", jax_evaluate)):
        argv = [str(gen), str(ref), "--output", str(tmp_path / name / "eval.json")]
        assert mod.main(argv + (["--device", "cpu"] if name == "port" else [])) == 0
        outs[name] = json.loads((tmp_path / name / "eval.json").read_text())
        assert "Evaluated 5 summary pairs" in capsys.readouterr().out
    got, want = outs["port"], outs["jax"]
    assert got["num_pairs"] == want["num_pairs"] == 5
    assert set(got["aggregate"]) == set(want["aggregate"]) == {"rouge1", "rouge2", "rougeL",
                                                               "bert"}
    for metric in ("rouge1", "rouge2", "rougeL"):
        assert got["aggregate"][metric] == want["aggregate"][metric]
    for name, scores in want["per_file"].items():
        np.testing.assert_allclose(list(got["per_file"][name]["bert"].values()),
                                   list(scores["bert"].values()), atol=EMBED_ATOL, rtol=0)
    np.testing.assert_allclose(list(got["aggregate"]["bert"].values()),
                               list(want["aggregate"]["bert"].values()), atol=EMBED_ATOL, rtol=0)
    skip = port_evaluate.evaluate_summaries(gen, ref, skip_bert=True, max_samples=2)
    assert skip["num_pairs"] == 2 and "bert" not in skip["aggregate"]


def test_cuda_without_a_card_raises_and_the_judge_waits():
    """What still raises without a card: the encoder (also the evaluator's
    default one) and its loader. The judge no longer waits: an evaluator
    with it builds, given an encoder on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        EmbeddingModel(config=te.tiny_encoder())
    with pytest.raises(RuntimeError, match="no CUDA card"):
        load_hf_encoder("does-not-matter")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        SemanticEvaluator(include_llm_eval=True)
    judge = LLMJudge(backend=FakeBackend(responses=['{"score": 5}', "3"]))
    ev = SemanticEvaluator(EmbeddingModel(config=te.tiny_encoder(), max_len=32, device="cpu"),
                           include_llm_eval=True, llm_judge=judge)
    assert ev.include_llm_eval and ev.llm_judge is judge


def test_init_follows_the_jax_scheme():
    gen = torch.Generator().manual_seed(0)
    cfg = te.tiny_encoder()
    params = te.init_encoder_params(cfg, gen, device="cpu")
    jparams = jax.tree.map(np.asarray, je.init_encoder_params(jax.random.key(0), je.tiny_encoder()))
    flat, jflat = {}, {}
    te._map(params, flat.__setitem__)
    te._map(jparams, jflat.__setitem__)
    assert flat.keys() == jflat.keys()
    for k, w in jflat.items():
        t = flat[k].numpy()
        assert t.shape == w.shape and t.dtype == w.dtype, k
        if np.all(w == w.flat[0]):  # ones or zeros
            assert np.array_equal(t, w), k
        else:  # normal * 0.02
            assert 0.015 < t.std() < 0.025 and abs(t.mean()) < 0.005, k
