"""The port's approaches, per-approach defaults and CLI configure all six
strategies as the JAX package's do (``vnsum_tpu/core/config.py``,
``vnsum_tpu/pipeline/cli.py``), for every field the port has; every
strategy registers; ``--tree-json`` takes the hierarchical tree branch."""
from __future__ import annotations

import dataclasses
import json

import pytest

from vnsum_tpu.core.config import APPROACHES as JAX_APPROACHES
from vnsum_tpu.core.config import PipelineConfig as JaxPipelineConfig
from vnsum_tpu.core.config import approach_defaults as jax_approach_defaults
from vnsum_tpu.pipeline import cli as jax_cli
from vnsum_tpu.strategies.base import STRATEGY_REGISTRY as JAX_REGISTRY
from vnsum_tpu_torch.core.config import (
    APPROACHES,
    EvalConfig,
    PipelineConfig,
    approach_defaults,
)
from vnsum_tpu_torch.pipeline import cli
from vnsum_tpu_torch.strategies import HierarchicalStrategy
from vnsum_tpu_torch.strategies.base import STRATEGY_REGISTRY

from torch_strategy_parity import FIXTURE, dirs
from test_torch_eval_embedding import small_default_encoder
from test_torch_models_llama import one_torch_thread  # noqa: F401

# the fields both configs have, but ``backend``: both have it, with the
# default of each package's own engine ("torch" here, "tpu" there)
COMMON = sorted(
    {f.name for f in dataclasses.fields(PipelineConfig)}
    & {f.name for f in dataclasses.fields(JaxPipelineConfig)}
    - {"backend"}
)
# flags both CLIs take; the port's own (--device, --logs-dir,
# --prefill-chunk-tokens) are left at their defaults
FLAG_SETS = {
    "defaults": [],
    "chunk_size": ["--chunk-size", "1024"],
    "tree": ["--tree-json", "trees/document_tree.json", "--max-depth", "2"],
    "budgets": ["--token-max", "1500", "--max-new-tokens", "64", "--max-context", "8192",
                "--chunk-size", "90", "--max-samples", "3", "--batch-size", "4"],
    "checkpoints": ["--weights-dir", "ckpt/llama", "--embedding-dir", "ckpt/minilm"],
    "quantize": ["--quantize", "--quantize-act"],
    "judge": ["--judge-backend", "ollama:qwen3:8b", "--ollama-url", "http://h:1"],
    "llm_eval": ["--include-llm-eval", "--backend", "fake"],
    "mesh": ["--mesh", "data=2,model=4"],
    "long_context": ["--long-context", "--quantize", "--mesh", "data=2,seq=4",
                     "--max-context", "65536"],
    # --quantize-kv-long needs --long-context in both configs (each raises
    # alike without it: tests/test_torch_pipeline_mesh.py)
    "quantize_kv_long": ["--quantize-kv-long", "--long-context", "--mesh", "seq=2",
                         "--allow-cpu-mesh"],
}


def common(cfg) -> dict:
    """The fields both configs have (COMMON), and the nested EvalConfig's."""
    out = {k: getattr(cfg, k) for k in COMMON}
    out["evaluation"] = {f.name: getattr(cfg.evaluation, f.name)
                         for f in dataclasses.fields(EvalConfig)}
    return out


def test_approaches_match_jax():
    """Both configs have the same fields, the mesh's and the long launch's
    among them; ``backend`` differs only in its default."""
    assert APPROACHES == JAX_APPROACHES
    assert set(STRATEGY_REGISTRY) == set(JAX_REGISTRY) == set(APPROACHES)
    assert {f.name for f in dataclasses.fields(JaxPipelineConfig)} - set(COMMON) == {"backend"}
    assert {"iterative_chunk_size", "iterative_chunk_overlap", "max_critique_iterations",
            "max_depth", "tree_json_path", "quantize", "quantize_act", "mesh_shape",
            "allow_cpu_mesh", "long_context", "long_context_quantize_kv"} <= set(COMMON)


@pytest.mark.parametrize("approach", JAX_APPROACHES)
def test_approach_defaults_match_jax(approach):
    assert approach_defaults(approach) == jax_approach_defaults(approach)
    cfg = PipelineConfig(approach=approach, **approach_defaults(approach))
    want = JaxPipelineConfig(approach=approach, **jax_approach_defaults(approach))
    assert common(cfg) == common(want)


def test_unknown_approach_and_bad_iterative_overlap_raise_as_in_jax():
    for kw in ({"approach": "nope"},
               {"iterative_chunk_size": 100, "iterative_chunk_overlap": 100}):
        with pytest.raises(ValueError) as got:
            PipelineConfig(**kw)
        with pytest.raises(ValueError) as want:
            JaxPipelineConfig(**kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown approach"):
        approach_defaults("nope")


@pytest.mark.parametrize("approach", JAX_APPROACHES)
def test_cli_accepts_every_approach(approach):
    args = cli.build_parser().parse_args(["--approach", approach])
    assert args.approach == approach
    assert cli.config_from_args(args).approach == approach


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
@pytest.mark.parametrize("approach", ["mapreduce_critique", "iterative",
                                      "mapreduce_hierarchical", "skeleton"])
def test_config_from_args_matches_jax(approach, flags):
    argv = ["--approach", approach, "--models", "tiny", *FLAG_SETS[flags]]
    got = cli.config_from_args(cli.build_parser().parse_args(argv))
    want = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    assert common(got) == common(want)


def test_cli_tree_json_takes_the_tree_branch(tmp_path, monkeypatch):
    """--tree-json loads the trees: a document with a tree goes through
    summarize_tree_batch (its header level collapsed), one without it
    through the plain-text entry."""
    name = sorted(p.name for p in (FIXTURE / "doc").glob("*.txt"))[0]
    tree = {"type": "Document", "text": "Áo dài", "children": [
        {"type": "Header", "text": "Phần 1", "children": [
            {"type": "Paragraph", "text": "Áo dài là trang phục truyền thống."}]}]}
    path = tmp_path / "trees.json"
    path.write_text(json.dumps({name: tree}, ensure_ascii=False), encoding="utf-8")
    seen = []
    inner = HierarchicalStrategy.summarize_tree_batch

    def spy(self, roots, **kw):
        seen.append([r.get("text") for r in roots])
        out = inner(self, roots, **kw)
        seen[-1].append([r.rounds for r in out])
        return out

    monkeypatch.setattr(HierarchicalStrategy, "summarize_tree_batch", spy)
    small_default_encoder(monkeypatch)
    argv = ["--approach", "mapreduce_hierarchical", "--models", "tiny", "--device", "cpu",
            "--tree-json", str(path), "--max-depth", "2", "--chunk-size", "400",
            "--max-new-tokens", "8", "--max-samples", "2"]
    for k, v in dirs(tmp_path).items():
        argv += ["--" + k.replace("_", "-"), v]
    assert cli.main(argv) == 0
    # the tree batch (its one header level collapsed), then the plain-text
    # fallback's wrapped Document (title "", no level to collapse)
    assert seen == [["Áo dài", [1]], ["", [0]]]
    saved = json.loads(next((tmp_path / "results").glob("pipeline_results_*.json")).read_text())
    assert saved["config"]["tree_json_path"] == str(path) and saved["config"]["max_depth"] == 2
    assert saved["results"]["summarization"]["tiny"]["successful"] == 2
