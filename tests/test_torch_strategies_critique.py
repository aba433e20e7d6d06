"""The port's map-reduce-with-critique pipeline against the JAX package's
over data/vi_eval (tests/torch_strategy_parity.py: JAX engine dense, the
port's through its kernel wrappers, 32 new tokens).

The knobs force every data-dependent branch: 512-byte chunks give 7 and 9
map summaries; token_max 2 makes both documents collapse (the random
model's summaries count one whitespace token each, or none), groups of two
summaries whose critique reference is their two original chunks;
token_max // 2 = 1 then sends the collapsed summaries through the context
pass; with max_critique_iterations 1 only the first collapse round is
critiqued and refined, so the later rounds, the context pass and the final
reduce make their critique and refine rounds with no prompts, which must
be no generate call at all.
"""
from __future__ import annotations

from collections import Counter

from vnsum_tpu_torch.strategies import prompts

from torch_strategy_parity import assert_same, docs, kinds, run_pair
from test_torch_models_llama import one_torch_thread  # noqa: F401

N_DOCS = 2
KNOBS = dict(chunk_size=512, chunk_overlap=51, token_max=2, max_critique_iterations=1)
TEMPLATES = {n: getattr(prompts, n) for n in (
    "CRITIQUE_MAP", "CRITIQUE_REDUCE", "CRITIQUE_CRITIQUE", "CRITIQUE_REFINE")}


def test_critique_over_vi_eval_matches_jax(tmp_path, monkeypatch):
    jax, port = run_pair(tmp_path, monkeypatch, "mapreduce_critique", KNOBS, N_DOCS)
    assert_same(jax, port, N_DOCS)

    seq = kinds(port.calls, TEMPLATES)
    rounds = [r.rounds for r in port.strategy_results]
    assert [r.num_chunks for r in port.strategy_results] == [7, 9]
    # at least one collapse round for every document
    assert min(rounds) >= 1
    # the map, then the first collapse round's reduce, critique and refine
    assert seq[:4] == ["CRITIQUE_MAP", "CRITIQUE_REDUCE", "CRITIQUE_CRITIQUE", "CRITIQUE_REFINE"]
    # only that round is critiqued: the empty critique and refine rounds
    # after it are no calls
    assert Counter(seq)["CRITIQUE_CRITIQUE"] == Counter(seq)["CRITIQUE_REFINE"] == 1
    # one reduce a collapse round, then the context pass's, then the final
    assert seq[4:] == ["CRITIQUE_REDUCE"] * (max(rounds) - 1 + 2)
    # the final reduce: one prompt a document, tagged sections of what the
    # context pass left
    final_prompts, _ = port.calls[-1]
    assert len(final_prompts) == N_DOCS
    assert all("[PHẦN 1]" in p for p in final_prompts)
    # the first round's critique reference is the group's original chunks,
    # found by the positional cursor
    crit_prompts, _ = port.calls[2]
    chunks = port.strategy.splitter.split_text(docs(N_DOCS)[0])
    assert "\n\n---\n\n".join(chunks[:2]) in crit_prompts[0]
