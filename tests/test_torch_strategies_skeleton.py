"""The port's Skeleton-of-Thought pipeline against the JAX package's over
data/vi_eval (tests/torch_strategy_parity.py: JAX engine dense, the port's
through its kernel wrappers, 32 new tokens), and its outline parser
against the JAX one.

max_context 581 with 32 new tokens cuts every document to its first 549
byte tokens, two of them inside a two-byte Vietnamese letter, so the
outline and expand prompts fit the 1024 bucket. Random weights write no
numbered line, so every outline takes the parser's single-point fallback:
one expansion per document, all in one round.
"""
from __future__ import annotations

import pytest

from vnsum_tpu.strategies.skeleton import SkeletonStrategy as JaxSkeletonStrategy
from vnsum_tpu_torch.strategies import prompts
from vnsum_tpu_torch.strategies.skeleton import _POINT_RE, SkeletonStrategy

from torch_strategy_parity import assert_same, docs, kinds, run_pair
from test_torch_models_llama import one_torch_thread  # noqa: F401

N_DOCS = 3
KNOBS = dict(max_context=581)
TEMPLATES = {n: getattr(prompts, n) for n in ("SKELETON_OUTLINE", "SKELETON_EXPAND")}


def test_skeleton_over_vi_eval_matches_jax(tmp_path, monkeypatch):
    jax, port = run_pair(tmp_path, monkeypatch, "skeleton", KNOBS, N_DOCS)
    assert_same(jax, port, N_DOCS)

    assert kinds(port.calls, TEMPLATES) == ["SKELETON_OUTLINE", "SKELETON_EXPAND"]
    (outline_prompts, outlines), (expand_prompts, expansions) = port.calls
    # every document cut to max_context - max_new_tokens byte tokens
    cut = [port.strategy._truncate(d) for d in docs(N_DOCS)]
    # the letter cut in two is dropped whole
    assert [len(c.encode()) for c in cut] == [547, 548, 549]
    assert outline_prompts == [prompts.SKELETON_OUTLINE.format(content=c) for c in cut]
    # the single-point fallback: no numbered line, so the point is the
    # whole outline (or the stock point for an empty one)
    assert not any(_POINT_RE.match(line) for o in outlines for line in o.splitlines())
    points = [o.strip() or "Tóm tắt nội dung chính." for o in outlines]
    assert expand_prompts == [prompts.SKELETON_EXPAND.format(point=p, content=c)
                              for p, c in zip(points, cut)]
    assert [(r.num_chunks, r.llm_calls, r.rounds, r.meta) for r in port.strategy_results] == [
        (1, 2, 2, {"points": 1})] * N_DOCS
    assert [r.summary for r in port.strategy_results] == expansions


OUTLINES = {
    "numbered": "Dàn ý:\n1. Áo dài là trang phục truyền thống.\n2. Nguồn gốc từ áo ngũ thân.\n"
                "3. Ngày nay mặc trong lễ hội.",
    "paren_indented": "  1) Cà phê đến Việt Nam từ thế kỷ 19.\n\t2)   Tây Nguyên trồng nhiều nhất.  \n"
                      "ghi chú không đánh số\n10) Xuất khẩu lớn thứ hai.",
    "unnumbered": "Một đoạn văn không có dàn ý đánh số nào cả.\nDòng thứ hai.",
    "blank": "  \n\t\n",
    "over_max_points": "\n".join(f"{i}. ý {i}" for i in range(1, 12)),
    "number_only": "1.\n2) \n3. x",
}


@pytest.mark.parametrize("name", sorted(OUTLINES))
def test_parse_points_matches_jax(name):
    outline = OUTLINES[name]
    got = SkeletonStrategy(backend=None)._parse_points(outline)
    want = JaxSkeletonStrategy(backend=None)._parse_points(outline)
    assert got == want
    assert 1 <= len(got) <= 8
