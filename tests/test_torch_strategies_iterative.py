"""The port's iterative-refinement pipeline against the JAX package's over
data/vi_eval (tests/torch_strategy_parity.py: JAX engine dense, the port's
through its kernel wrappers, 32 new tokens).

iterative_chunk_size 400 (overlap 40) cuts the two documents into 10 and 9
chunks, so the run takes 10 rounds of one batch each, across documents: the
first round seeds both foundation summaries, rounds 2-9 refine both, and
round 10 refines only the longer document (a batch of one row). 400 keeps
the longest refine prompt (a 1593-byte template, a summary, a chunk) in the
2048 bucket.
"""
from __future__ import annotations

from vnsum_tpu_torch.strategies import prompts

from torch_strategy_parity import assert_same, docs, kinds, run_pair
from test_torch_models_llama import one_torch_thread  # noqa: F401

N_DOCS = 2
KNOBS = dict(iterative_chunk_size=400, iterative_chunk_overlap=40)
TEMPLATES = {n: getattr(prompts, n) for n in ("ITERATIVE_INITIAL", "ITERATIVE_REFINE")}


def test_iterative_over_vi_eval_matches_jax(tmp_path, monkeypatch):
    jax, port = run_pair(tmp_path, monkeypatch, "iterative", KNOBS, N_DOCS)
    assert_same(jax, port, N_DOCS)

    counts = [r.num_chunks for r in port.strategy_results]
    assert counts == [10, 9]
    # one call a round; every document's rounds = calls = its chunks
    assert [(r.rounds, r.llm_calls) for r in port.strategy_results] == [(10, 10), (9, 9)]
    assert kinds(port.calls, TEMPLATES) == ["ITERATIVE_INITIAL"] + ["ITERATIVE_REFINE"] * 9
    # later rounds have fewer rows once the shorter document is done
    assert [len(p) for p, _ in port.calls] == [2] * 9 + [1]
    assert port.engine.stats.by_bucket[(1, 2048)] == 1
    # the engine's decode steps, tallied by the batch shape that ran them
    st = port.engine.stats
    assert set(st.steps_by_bucket) == set(st.by_bucket)
    assert sum(st.steps_by_bucket.values()) == st.decode_steps
    assert st.to_dict()["steps_by_bucket"]["B=1,S=2048"] == st.steps_by_bucket[(1, 2048)] > 0
    # round r refines each summary with chunk r: the carried summary is
    # the document's previous output, byte for byte
    chunks = port.strategy.splitter.split_text(docs(N_DOCS)[0])
    for r in range(1, 10):
        (prompt, *_), _ = port.calls[r]
        _, (prev, *_) = port.calls[r - 1]
        assert prompt == prompts.ITERATIVE_REFINE.format(existing_answer=prev, context=chunks[r])
