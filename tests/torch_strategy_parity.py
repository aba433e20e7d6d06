"""Shared harness of the strategy parity tests (tests/test_torch_strategies_*.py).

:func:`run_pair` runs one approach through the JAX package's
``PipelineRunner`` on ``TpuBackend`` and through the port's on
``TorchBackend(device="cpu")``, both on the same carried tiny f32 weights
over the first documents of ``data/vi_eval``, and records on each side
every ``generate`` call's prompts and every ``StrategyResult``.

The JAX engine runs with ``flash=False``: its Pallas decode kernel in
interpret mode needs a cache length that is a multiple of 128 (its ragged
last block reads NaN), which ties the decode budget to 128 new tokens; the
dense path lets these tests decode 32, and its greedy ids match the port's
byte for byte. The port's engine runs ``flash=True`` with an f32 cache
(``quantize_kv=False``), so its prefill and decode go through the K1 and K2
wrappers, which take their plain versions for CPU tensors.
"""
from __future__ import annotations

import math
from pathlib import Path

import vnsum_tpu.pipeline.runner as jax_runner_mod
import vnsum_tpu_torch.pipeline.runner as port_runner_mod
from vnsum_tpu.backend.engine import TpuBackend
from vnsum_tpu.core import PipelineConfig as JaxPipelineConfig
from vnsum_tpu_torch.backend.engine import TorchBackend
from vnsum_tpu_torch.core.config import PipelineConfig

from test_torch_eval_embedding import assert_embedding_stats_close, carried_embedders
from test_torch_models_llama import carried_weights

FIXTURE = Path(__file__).resolve().parent.parent / "data" / "vi_eval"
MAX_NEW = 32
# the longest prompt of these tests (an iterative refine: a 1593-byte
# template, a summary and a chunk) fits whole, so no prompt is cut
MAX_SEQ_LEN = 4096 + MAX_NEW


def dirs(root: Path) -> dict:
    return dict(
        docs_dir=str(FIXTURE / "doc"),
        summary_dir=str(FIXTURE / "summary"),
        generated_summaries_dir=str(root / "gen"),
        results_dir=str(root / "results"),
        logs_dir=str(root / "logs"),
    )


def docs(n: int) -> list[str]:
    """The texts of the first ``n`` documents, in the runners' order."""
    return [p.read_text(encoding="utf-8")
            for p in sorted((FIXTURE / "doc").glob("*.txt"))[:n]]


def recording(backend, calls: list):
    """``backend`` with every generate call's (prompts, outputs) appended to
    ``calls``."""
    inner = backend.generate

    def generate(prompts, **kw):
        outs = inner(prompts, **kw)
        calls.append((list(prompts), list(outs)))
        return outs

    backend.generate = generate
    return backend


def spying(get_strategy, strategies: list, results: list):
    """``get_strategy`` that appends each strategy it makes to
    ``strategies`` and whose strategies append each batch's StrategyResults
    (plain-text and tree batches) to ``results``."""

    def make(*args, **kw):
        strategy = get_strategy(*args, **kw)
        strategies.append(strategy)
        # hierarchical's plain-text entry runs through its tree batch
        method = ("summarize_tree_batch" if hasattr(strategy, "summarize_tree_batch")
                  else "summarize_batch")
        inner = getattr(strategy, method)

        def spy(items, **kw2):
            out = inner(items, **kw2)
            results.extend(out)
            return out

        setattr(strategy, method, spy)
        return strategy

    return make


class Side:
    """One side's run: the results object, the generated summaries by
    name, every generate call's (prompts, outputs), the strategy and its
    StrategyResults, the engine."""

    def __init__(self, results, gen_dir: Path, calls, strategy, strategy_results, engine):
        self.results = results
        self.summaries = {p.name: p.read_bytes() for p in sorted(gen_dir.glob("*.txt"))}
        self.calls = calls
        self.strategy = strategy
        self.strategy_results = strategy_results
        self.engine = engine

    def record(self) -> dict:
        return self.results.summarization["tiny"]

    def per_doc(self) -> list:
        return [(d["filename"], d["num_chunks"], d["llm_calls"])
                for d in self.record()["processing_details"]]


def run_pair(tmp_path: Path, monkeypatch, approach: str, knobs: dict, n_docs: int,
             cfg_kw: dict | None = None):
    """Runs ``approach`` with ``knobs`` (PipelineConfig fields, the same on
    both sides) over the first ``n_docs`` documents, on ``carried_weights``
    of a tiny config with ``cfg_kw`` (default: tiny_llama's); returns (jax
    Side, port Side)."""
    jcfg, params, model = carried_weights(max_seq_len=MAX_SEQ_LEN, **(cfg_kw or {}))
    jax_embedder, port_embedder = carried_embedders()
    knobs = {"max_new_tokens": MAX_NEW, "max_samples": n_docs, **knobs}
    sides = []
    for name, config_cls, runner_mod in (
        ("jax", JaxPipelineConfig, jax_runner_mod),
        ("port", PipelineConfig, port_runner_mod),
    ):
        calls, strategies, strategy_results, engines = [], [], [], []
        monkeypatch.setattr(runner_mod, "get_strategy", spying(
            runner_mod.get_strategy, strategies, strategy_results))
        cfg = config_cls(approach=approach, models=["tiny"], **dirs(tmp_path / name), **knobs)
        if name == "jax":
            def factory(_):
                engines.append(TpuBackend(
                    model_config=jcfg, params=params, flash=False,
                    batch_size=8, max_new_tokens=MAX_NEW))
                return recording(engines[-1], calls)

            runner = runner_mod.PipelineRunner(
                cfg, backend_factory=factory,
                embedding_model=jax_embedder,
            )
        else:
            def factory(_):
                engines.append(TorchBackend(
                    model=model, flash=True, quantize_kv=False,
                    batch_size=8, max_new_tokens=MAX_NEW, device="cpu"))
                return recording(engines[-1], calls)

            runner = runner_mod.PipelineRunner(cfg, backend_factory=factory,
                                               embedding_model=port_embedder, device="cpu")
        results = runner.run()
        if name == "port":
            assert runner.failures == []
        gen_dir = tmp_path / name / f"gen_{approach}_tiny"
        sides.append(Side(results, gen_dir, calls, strategies[0], strategy_results, engines[0]))
    return tuple(sides)


def assert_same(jax: Side, port: Side, n_docs: int) -> None:
    """Byte-identical summaries, the same prompts in the same calls, and
    equal per-document chunks, calls and rounds, and ROUGE; the embedding
    metrics within EMBED_ATOL."""
    names = sorted(p.name for p in (FIXTURE / "doc").glob("*.txt"))[:n_docs]
    assert sorted(port.summaries) == names
    assert port.summaries == jax.summaries
    # every generate call: the same prompts, the same outputs. Random
    # weights emit text after some prompts and nothing after others: the
    # comparison must not be of empty strings only
    assert port.calls == jax.calls
    assert any(o for _, outs in port.calls for o in outs)
    assert port.record()["successful"] == n_docs and port.record()["failed"] == 0
    assert port.per_doc() == jax.per_doc()
    assert port.record()["total_chunks"] == jax.record()["total_chunks"]
    assert [(r.num_chunks, r.llm_calls, r.rounds, r.summary) for r in port.strategy_results] == [
        (r.num_chunks, r.llm_calls, r.rounds, r.summary) for r in jax.strategy_results]
    rouge = port.results.evaluation["tiny"]["rouge_scores"]
    assert rouge == jax.results.evaluation["tiny"]["rouge_scores"]
    assert all(math.isfinite(v) for v in rouge.values())
    assert_embedding_stats_close(port.results.evaluation["tiny"], jax.results.evaluation["tiny"])
    assert port.engine.stats.calls == len(port.calls)


def kinds(calls: list, templates: dict) -> list:
    """Each call named by the template its prompts were formatted from
    (matched on the template's header); a call mixing templates fails."""
    from vnsum_tpu_torch.strategies.prompts import template_header

    out = []
    for prompts, _ in calls:
        names = {n for p in prompts for n, t in templates.items()
                 if p.startswith(template_header(t))}
        assert len(names) == 1, names
        out.append(names.pop())
    return out
