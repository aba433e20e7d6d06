"""The port's hierarchical pipeline against the JAX package's over
data/vi_eval (tests/torch_strategy_parity.py: JAX engine dense, the port's
through its kernel wrappers, 32 new tokens), with its trees loaded from
``--tree-json``.

The tree JSON, written into the test's directory, is built from the
documents: the title line is the Document's text, the paragraphs sit under
Header nodes. The first document nests each paragraph under a sub-header
(depth 3), the second keeps its paragraphs under two headers (depth 2),
and the third is left out of the tree, so it takes the plain-text
fallback. At max_depth 2 the lockstep collapse runs level 2 (the first
document's sub-headers only: the second's level 2 is paragraphs) and then
level 1 for both; at max_depth 1 only level 1. chunk_size 1024 against
max_context 640 takes the 75% context clamp (chunks of 480).
"""
from __future__ import annotations

import json

import pytest

from vnsum_tpu_torch.backend.engine import TorchBackend
from vnsum_tpu_torch.core.config import PipelineConfig
from vnsum_tpu_torch.eval import EmbeddingModel
from vnsum_tpu_torch.models.encoder import tiny_encoder
from vnsum_tpu_torch.pipeline.runner import PipelineRunner
from vnsum_tpu_torch.strategies import prompts
from vnsum_tpu_torch.text import DocumentTree, tree_depth

from torch_strategy_parity import FIXTURE, assert_same, dirs, docs, kinds, run_pair
from test_torch_models_llama import carried_weights, one_torch_thread  # noqa: F401

N_DOCS = 3
KNOBS = dict(chunk_size=1024, chunk_overlap=48, max_context=640)
TEMPLATES = {n: getattr(prompts, n) for n in (
    "HIERARCHICAL_MAP", "HIERARCHICAL_REDUCE", "HIERARCHICAL_POLISH")}


def doc_tree(text: str, nested: bool) -> dict:
    title, _, body = text.partition("\n")
    paras = [p.strip() for p in body.split("\n\n") if p.strip()]
    halves = (paras[: len(paras) // 2], paras[len(paras) // 2 :])

    def leaf(i, p):
        node = {"type": "Paragraph", "text": p}
        return {"type": "Header", "text": f"Đoạn {i + 1}", "children": [node]} if nested else node

    return {"type": "Document", "text": title.strip(), "children": [
        {"type": "Header", "text": f"Phần {h + 1}",
         "children": [leaf(i, p) for i, p in enumerate(half)]}
        for h, half in enumerate(halves)]}


def write_trees(tmp_path):
    names = sorted(p.name for p in (FIXTURE / "doc").glob("*.txt"))[:N_DOCS]
    texts = docs(N_DOCS)
    trees = {names[0]: doc_tree(texts[0], nested=True), names[1]: doc_tree(texts[1], nested=False)}
    path = tmp_path / "tree.json"
    path.write_text(json.dumps(trees, ensure_ascii=False), encoding="utf-8")
    return path, names


@pytest.mark.parametrize("max_depth", [1, 2])
def test_hierarchical_over_vi_eval_matches_jax(tmp_path, monkeypatch, max_depth):
    path, names = write_trees(tmp_path)
    tree = DocumentTree.load(path)
    depths = [tree_depth(tree.get(name)) for name in names[:2]]
    knobs = dict(KNOBS, max_depth=max_depth, tree_json_path=str(path))
    jax, port = run_pair(tmp_path, monkeypatch, "mapreduce_hierarchical", knobs, N_DOCS)
    assert_same(jax, port, N_DOCS)
    assert port.strategy.chunk_size == 480  # int(640 * 0.75)

    seq = kinds(port.calls, TEMPLATES)
    levels = max_depth  # the nested tree reaches every level asked for
    # the tree batch: a map and a reduce per level, then the final map,
    # reduce and polish; then the fallback document's final three
    assert seq == (["HIERARCHICAL_MAP", "HIERARCHICAL_REDUCE"] * (levels + 1)
                   + ["HIERARCHICAL_POLISH", "HIERARCHICAL_MAP", "HIERARCHICAL_REDUCE",
                      "HIERARCHICAL_POLISH"])
    tree_rounds = [r.rounds for r in port.strategy_results[:2]]
    assert tree_rounds == [max_depth, 1]
    assert port.strategy_results[2].rounds == 0  # plain text: no level to collapse
    # level 1's texts are titled by their header; at depth 2 the first
    # document's sub-headers collapse first, into "Đoạn i:" paragraphs
    level_prompts, _ = port.calls[0]
    if max_depth == 2:
        assert any(p.startswith(prompts.HIERARCHICAL_MAP.split("{")[0] + "Đoạn 1:\n")
                   for p in level_prompts)
        level1_prompts, _ = port.calls[2]
        assert any("Phần 1:\nĐoạn 1:\n" in p for p in level1_prompts)
    else:
        assert any("Phần 1:\n" in p for p in level_prompts)
    assert depths == [3, 2]
    # the fallback document's final map covers its whole text
    fallback_maps, _ = port.calls[-3]
    assert len(fallback_maps) == port.strategy_results[2].num_chunks > 1


def test_missing_tree_json_wraps_plain_text(tmp_path):
    """Without the tree file the runner warns and summarizes plain text."""
    _, _, model = carried_weights(max_seq_len=1024 + 32)
    cfg = PipelineConfig(
        approach="mapreduce_hierarchical", models=["tiny"], max_samples=1, max_new_tokens=8,
        tree_json_path=str(tmp_path / "absent.json"), **dirs(tmp_path), **KNOBS)
    runner = PipelineRunner(cfg, device="cpu", backend_factory=lambda _: TorchBackend(
        model=model, flash=False, batch_size=8, max_new_tokens=8, device="cpu"),
        embedding_model=EmbeddingModel(config=tiny_encoder(), max_len=64, batch_size=4,
                                       device="cpu"))
    runner.run()
    assert runner.failures == []
    assert "hierarchical will wrap plain text" in runner.log_path.read_text(encoding="utf-8")
    assert runner.results.summarization["tiny"]["successful"] == 1
