"""The port's G-Eval judge (vnsum_tpu_torch.eval.geval) against the JAX
package's: the same criteria, template and score parsing, and the same
``llm_scores`` block over the scripted fake judge, the constrained judge on
carried weights, a trained judge fixture and the HTTP branch.

The constrained judge picks a score digit by ``score_choices`` on both
sides. The JAX engine runs its prefill kernel in interpret mode, the port's
K1 wrapper its plain version. Equal picks give equal blocks, which are
compared exactly.
"""
from __future__ import annotations

import sys
import types
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from vnsum_tpu.backend.engine import TpuBackend
from vnsum_tpu.backend.fake import FakeBackend as JaxFakeBackend
from vnsum_tpu.eval import geval as jg
from vnsum_tpu.eval.judge_fixture import build_cases, train_judge_fixture
from vnsum_tpu.models.convert import load_hf_checkpoint as jax_load_hf_checkpoint
from vnsum_tpu_torch.backend.engine import TorchBackend
from vnsum_tpu_torch.backend.fake import FakeBackend
from vnsum_tpu_torch.eval import LLMJudge
from vnsum_tpu_torch.eval import geval as tg
from vnsum_tpu_torch.models.convert import load_hf_checkpoint

from test_torch_models_llama import carried_weights, one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).resolve().parent.parent / "data" / "vi_eval"
GENERATED = {"a.txt": "Quốc hội thông qua nghị quyết về kinh tế.",
             "b.txt": "Nhà trường tổ chức kỳ thi tốt nghiệp cho học sinh.",
             "c.txt": "tóm tắt"}
REFERENCES = {"a.txt": "Quốc hội đã thông qua nghị quyết.",
              "b.txt": "Kỳ thi tốt nghiệp diễn ra an toàn.",
              "c.txt": "văn bản tham chiếu", "d.txt": "không có cặp"}


def test_criteria_template_and_prefix_equal_jax_byte_for_byte():
    assert tg.CORRECTNESS_CRITERIA == jg.CORRECTNESS_CRITERIA
    assert tg.COHERENCE_CRITERIA == jg.COHERENCE_CRITERIA
    assert tg._JUDGE_TEMPLATE == jg._JUDGE_TEMPLATE
    assert tg._SCORE_RE.pattern == jg._SCORE_RE.pattern
    assert LLMJudge._FORCED_PREFIX == jg.LLMJudge._FORCED_PREFIX == '\n{"score": '


@pytest.mark.parametrize("text", [
    '{"score": 4, "reason": "ok"}', '{"score":5}', '{"score": 3.5}', '{"score": 0}',
    '{"score": 7, "reason": "x"}', "Score: 1", "5", "2.25 of 5", "no score here 9000",
    "", "điểm 3 trên 5", "the score is 6", '{"score": "4"}', "1-5", "12 345",
    '{"score": 4.0.1}', "5.0", "\n{\"score\": 2",
])
def test_parse_score_matches_jax(text):
    def outcome(parse):
        try:
            return parse(text)
        except ValueError as e:  # "4.0.1": float() refuses it on both sides
            return repr(e)

    assert outcome(tg._parse_score) == outcome(jg._parse_score)


# scripted verdicts in call order, two per file (correctness, coherence)
SCRIPTS = {
    "success": ['{"score": 5}', '{"score": 3}', '{"score": 4, "reason": "x"}', "2", "1", "5"],
    "garbage": ["garbage", "garbage", '{"score": 5}', '{"score": 5}', "4", "nothing"],
    "out_of_range": ['{"score": 9}', "3", "Score: 2", "Score: 4", "5", "5"],
    # the third file's call finds no response left: a RuntimeError, contained
    "run_out": ['{"score": 5}', '{"score": 1}', "3", "3"],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_scripted_fake_judge_matches_jax(script):
    port_fb, jax_fb = FakeBackend(responses=SCRIPTS[script]), JaxFakeBackend(
        responses=SCRIPTS[script])
    got = LLMJudge(backend=port_fb).evaluate(GENERATED, REFERENCES)
    want = jg.LLMJudge(backend=jax_fb).evaluate(GENERATED, REFERENCES)
    assert got == want
    assert got["llm_total_cases_processed"] == 3
    assert port_fb.calls == jax_fb.calls and port_fb.batch_sizes == jax_fb.batch_sizes
    assert port_fb.batch_sizes == [2] * len(port_fb.batch_sizes)


def test_extractive_fake_judge_matches_jax():
    """The unscripted fake echoes the prompt's first words, which carry the
    criteria's "(1-5)": a score of 1 on every case, on both sides."""
    got = LLMJudge(backend=FakeBackend()).evaluate(GENERATED, REFERENCES)
    assert got == jg.LLMJudge(backend=JaxFakeBackend()).evaluate(GENERATED, REFERENCES)
    assert got["llm_successful_cases"] == 3 and got["llm_correctness_mean"] == 0.0


def test_judge_refusals_match_jax():
    with pytest.raises(ValueError) as got:
        LLMJudge()
    with pytest.raises(ValueError) as want:
        jg.LLMJudge()
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        LLMJudge(backend=FakeBackend(), constrained=True)
    with pytest.raises(ValueError) as want:
        jg.LLMJudge(backend=JaxFakeBackend(), constrained=True)
    assert str(got.value) == str(want.value).replace("TpuBackend", "TorchBackend")


@pytest.mark.parametrize("arm", ["int8_cache", "dense"])
def test_constrained_judge_on_carried_weights_matches_jax(arm):
    """Judge prompts of ~0.8 KB at S=1024 (byte tokenizer), two a file; the
    prompts past the context are cut from the left on both sides."""
    jcfg, params, model = carried_weights(max_seq_len=1024)
    flash = arm == "int8_cache"
    jb = TpuBackend(model_config=jcfg, params=params, flash=flash, interpret=flash,
                    max_new_tokens=64)
    tb = TorchBackend(model=model, flash=flash, max_new_tokens=64, device="cpu")
    got = LLMJudge(backend=tb, constrained=True).evaluate(GENERATED, REFERENCES)
    want = jg.LLMJudge(backend=jb, constrained=True).evaluate(GENERATED, REFERENCES)
    assert got == want
    assert got["llm_successful_cases"] == 3 and got["llm_failed_cases"] == 0
    assert tb.stats.by_bucket == jb.stats.by_bucket == {(2, 1024): 3}
    assert tb.stats.prompt_tokens == jb.stats.prompt_tokens


@pytest.fixture(scope="module")
def trained_judge(tmp_path_factory):
    """The JAX package's judge fixture (an HF Llama checkpoint with a BPE
    tokenizer) trained at its own test's size, loaded into both packages in
    f32 with its ``hf:`` tokenizer."""
    d = tmp_path_factory.mktemp("judge")
    torch.manual_seed(0)
    train_judge_fixture(d, n_per_level=2, steps=3, vocab_size=384)
    jcfg, params = jax_load_hf_checkpoint(str(d), dtype=jnp.float32)
    _, model = load_hf_checkpoint(str(d), dtype=torch.float32, device="cpu")
    jb = TpuBackend(model_config=jcfg, params=params, tokenizer=f"hf:{d}", flash=True,
                    interpret=True, max_new_tokens=64)
    tb = TorchBackend(model=model, tokenizer=f"hf:{d}", flash=True, max_new_tokens=64,
                      device="cpu")
    return jb, tb


def curriculum_pairs(n_per_level: int, seed: int) -> tuple[dict, dict]:
    """(generated, references) of the fixture's correctness cases, read back
    out of their prompts: the judge's prompts on them are the curriculum's."""
    generated, references = {}, {}
    for i, c in enumerate(build_cases(n_per_level, seed=seed)):
        if c.kind != "correctness":
            continue
        body = c.prompt.split("Generated summary:\n", 1)[1]
        gen, rest = body.split("\n\nReference summary:\n", 1)
        generated[f"{i:02d}.txt"] = gen
        references[f"{i:02d}.txt"] = rest.split("\n\nRespond with ONLY")[0]
    return generated, references


def test_trained_judge_picks_match_jax(trained_judge):
    jb, tb = trained_judge
    prompts = [c.prompt for c in build_cases(2, seed=5)]
    got = tb.score_choices(prompts, ["1", "2", "3", "4", "5"])
    assert got == jb.score_choices(prompts, ["1", "2", "3", "4", "5"])
    # content-dependent: not one digit for every prompt
    assert len(set(got)) > 1


def test_trained_judge_scores_match_jax(trained_judge):
    jb, tb = trained_judge
    generated, references = curriculum_pairs(2, seed=5)
    assert len(generated) == 10
    got = LLMJudge(backend=tb, constrained=True).evaluate(generated, references)
    want = jg.LLMJudge(backend=jb, constrained=True).evaluate(generated, references)
    assert got == want
    assert got["llm_successful_cases"] == 10 and got["llm_failed_cases"] == 0
    assert got["llm_coherence_std"] > 0  # the picks differ between cases


@pytest.fixture()
def fake_requests(monkeypatch):
    """A stub ``requests`` module that records every POST and answers from
    a script (a verdict string, or an exception to raise)."""
    mod = types.ModuleType("requests")
    mod.calls, mod.answers = [], []

    class Response:
        def __init__(self, content):
            self.content = content

        def raise_for_status(self):
            if isinstance(self.content, Exception):
                raise self.content

        def json(self):
            return {"choices": [{"message": {"content": self.content}}]}

    def post(url, headers=None, json=None, timeout=None):
        mod.calls.append({"url": url, "headers": headers, "json": json, "timeout": timeout})
        return Response(mod.answers.pop(0))

    mod.post = post
    monkeypatch.setitem(sys.modules, "requests", mod)
    return mod


@pytest.mark.parametrize("answers", [
    ['{"score": 4}', "3", '{"score": 2, "reason": "r"}', "5", "1", "1"],
    ['{"score": 4}', RuntimeError("HTTP 500"), "3", "3", "nothing", "2"],
], ids=["success", "contained_failure"])
def test_http_judge_sends_what_jax_sends(fake_requests, answers):
    results, calls = [], []
    for judge_cls in (LLMJudge, jg.LLMJudge):
        fake_requests.calls, fake_requests.answers = [], list(answers)
        judge = judge_cls(api_base="https://judge.example/v1/", api_key="k",
                          model="openai/gpt-4o-mini", max_new_tokens=32)
        results.append(judge.evaluate(GENERATED, REFERENCES))
        calls.append(fake_requests.calls)
    assert results[0] == results[1]
    assert calls[0] == calls[1]
    assert calls[0][0]["url"] == "https://judge.example/v1/chat/completions"
    assert calls[0][0]["headers"] == {"Authorization": "Bearer k"}
    assert calls[0][0]["json"]["max_tokens"] == 32 and calls[0][0]["timeout"] == 120


def test_modules_import_without_requests():
    """``requests`` is imported inside the calls that need it: the card
    machine has none."""
    import ast

    root = Path(__file__).resolve().parent.parent / "vnsum_tpu_torch"
    for rel in ("eval/geval.py", "backend/ollama.py"):
        tree = ast.parse((root / rel).read_text(encoding="utf-8"))
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = {a.name for n in top for a in n.names} | {
            n.module for n in top if isinstance(n, ast.ImportFrom) and n.module}
        assert "requests" not in names, rel
