"""Reference-guided speculative decoding in the PyTorch port against the JAX
package: the drafter, the acceptance rule, the engine's spec path and the
map-reduce pipeline with a spec backend, on carried weights.

Greedy spec decode must emit exactly the plain decode's tokens, and exactly
the JAX spec path's, with the same per-prompt draft and acceptance counts.
The JAX engine runs its kernels in interpret mode, the port's wrappers their
plain versions. The spec cache holds C = S + max_new + k + 1 slots; the
budgets here keep every C a multiple of 128 (or within one 128-slot block):
the JAX kernels' interpret mode pads a ragged last block with NaN.
"""
from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnsum_tpu.backend.engine import TpuBackend
from vnsum_tpu.core.config import GenerationConfig as JaxGenerationConfig
from vnsum_tpu.models import sampling as js
from vnsum_tpu.spec import propose_drafts as jax_propose_drafts
from vnsum_tpu_torch.backend.engine import TorchBackend
from vnsum_tpu_torch.core.config import GenerationConfig
from vnsum_tpu_torch.models import sampling as ts
from vnsum_tpu_torch.spec import NO_TOKEN, propose_drafts, propose_drafts_host

from test_torch_eval_embedding import assert_embedding_stats_close, carried_embedders
from test_torch_models_llama import carried_weights, one_torch_thread  # noqa: F401

PROMPTS = [
    "văn bản một về kinh tế",
    "hai " * 5,
    "một tài liệu dài hơn hẳn về pháp luật",
]
REFS = [
    "văn bản một về kinh tế xã hội và phát triển bền vững",
    None,  # no reference: the row retires one token a step
    "một tài liệu dài hơn hẳn về pháp luật và đời sống",
]
# prompts bucket to S=64, so the spec cache is 64 + 58 + 5 + 1 = 128 slots
MAX_NEW, K = 58, 5


def counts(report) -> list:
    """SpecRecords as (drafted, accepted, steps): the two packages' record
    classes are distinct types with the same fields."""
    return [(r.draft_tokens, r.accepted_tokens, r.verify_steps) for r in report]


@pytest.fixture(scope="module")
def engines():
    """(JAX backend, port backend) on one carried weight set."""
    jcfg, params, model = carried_weights()
    jb = TpuBackend(
        model_config=jcfg, params=params, flash=True, interpret=True,
        batch_size=4, max_new_tokens=MAX_NEW,
    )
    tb = TorchBackend(model=model, flash=True, batch_size=4, max_new_tokens=MAX_NEW, device="cpu")
    return jb, tb


@pytest.fixture(scope="module")
def plain(engines):
    jb, tb = engines
    out = tb.generate(PROMPTS)
    assert out == jb.generate(PROMPTS)
    return out


# -- the drafter and the acceptance rule ---------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_propose_drafts_matches_jax(seed):
    """Torch drafting equals the JAX package's jnp drafting and the numpy
    mirror on random cases: a small vocabulary makes matches (and ties
    between positions) common; some rows have short or empty references and
    NO_TOKEN-padded tails."""
    rng = np.random.default_rng(seed)
    B, R, N, k = 6, 40, 3, 4
    ref = rng.integers(0, 5, (B, R)).astype(np.int32)
    lens = rng.integers(0, R + 1, B).astype(np.int32)
    lens[0] = 0
    for b in range(B):
        ref[b, lens[b]:] = NO_TOKEN
    tail = rng.integers(0, 5, (B, N)).astype(np.int32)
    tail[1, 0] = NO_TOKEN
    tail[2, :2] = NO_TOKEN
    want_d, want_n = jax_propose_drafts(jnp.asarray(ref), jnp.asarray(lens), jnp.asarray(tail), k)
    got_d, got_n = propose_drafts(torch.from_numpy(ref), torch.from_numpy(lens), torch.from_numpy(tail), k)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    host_d, host_n = propose_drafts_host(ref, lens, tail, k)
    np.testing.assert_array_equal(got_d.numpy(), host_d)
    np.testing.assert_array_equal(got_n.numpy(), host_n)
    assert got_n.max() > 0


@pytest.mark.parametrize("seed", range(4))
def test_greedy_acceptance_matches_jax(seed):
    """Greedy draft_acceptance_rows: the same accepted counts and next ids.
    Drafts agree with the argmax for a random prefix of each row."""
    rng = np.random.default_rng(seed)
    B, K1, V = 5, 5, 30
    logits = rng.standard_normal((B, K1, V)).astype(np.float32)
    g = logits.argmax(-1)
    drafts = g[:, : K1 - 1].copy()
    for b in range(B):
        cut = rng.integers(0, K1)
        drafts[b, cut:] = (drafts[b, cut:] + 1 + rng.integers(0, V - 1, K1 - 1 - cut)) % V
    n_draft = rng.integers(0, K1, B).astype(np.int32)
    want_m, want_nxt = js.draft_acceptance_rows(
        jnp.asarray(logits), jnp.asarray(drafts, jnp.int32), jnp.asarray(n_draft), None, 0.0
    )
    got_m, got_nxt = ts.draft_acceptance_rows(
        torch.from_numpy(logits), torch.from_numpy(drafts), torch.from_numpy(n_draft)
    )
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_nxt.numpy(), np.asarray(want_nxt))


def test_sampled_acceptance_is_keyed_per_row_and_position():
    """Sampled acceptance: a row's outcome depends only on its own seeds
    (reversing the batch reverses the results), accepts at most its real
    drafts, and at top_k=1 (a point mass) it is the greedy rule."""
    rng = np.random.default_rng(3)
    B, K1, V = 4, 4, 20
    logits = torch.from_numpy(rng.standard_normal((B, K1, V)).astype(np.float32) * 3)
    drafts = logits.argmax(-1)[:, : K1 - 1].clone()
    drafts[1, 1] = (drafts[1, 1] + 1) % V
    n_draft = torch.tensor([3, 3, 1, 0])
    seeds = [[ts.row_seed(5, b, p) for p in range(K1)] for b in range(B)]
    m, nxt = ts.draft_acceptance_rows(logits, drafts, n_draft, seeds, 1.0)
    m_r, nxt_r = ts.draft_acceptance_rows(
        logits.flip(0), drafts.flip(0), n_draft.flip(0), seeds[::-1], 1.0
    )
    assert torch.equal(m, m_r.flip(0)) and torch.equal(nxt, nxt_r.flip(0))
    assert bool((m <= n_draft).all())
    gm, gnxt = ts.draft_acceptance_rows(logits, drafts, n_draft)
    pm, pnxt = ts.draft_acceptance_rows(logits, drafts, n_draft, seeds, 1.0, top_k=1)
    assert torch.equal(pm, gm) and torch.equal(pnxt, gnxt)


# -- the engine's spec path ------------------------------------------------------


def test_greedy_spec_matches_jax_spec_and_plain_decode(engines, plain):
    jb, tb = engines
    want = jb.generate(PROMPTS, config=JaxGenerationConfig(spec_k=K), references=REFS)
    got = tb.generate(PROMPTS, config=GenerationConfig(spec_k=K), references=REFS)
    assert got == want == plain
    report = tb.take_spec_report()
    assert counts(report) == counts(jb.take_spec_report()) and len(report) == len(PROMPTS)
    assert report[1].draft_tokens == 0  # no reference, nothing proposed
    assert all(r.verify_steps > 0 for r in report)
    assert tb.take_spec_report() == []  # the report is consumed


def test_oracle_reference_is_accepted(engines, plain):
    """Each row's own greedy continuation as its reference: the drafter
    proposes what the model will emit, so acceptance fires (multi-token
    steps, ragged per-row fills) and the output is still the plain one."""
    jb, tb = engines
    want = jb.generate(PROMPTS, config=JaxGenerationConfig(spec_k=K), references=plain)
    got = tb.generate(PROMPTS, config=GenerationConfig(spec_k=K), references=plain)
    assert got == want == plain
    report = tb.take_spec_report()
    assert counts(report) == counts(jb.take_spec_report())
    assert sum(r.accepted_tokens for r in report) > 0
    steps = tb.stats.spec_verify_steps
    assert any(r.verify_steps < MAX_NEW for r in report)
    assert steps > 0 and tb.stats.spec_accepted_tokens > 0


def test_custom_eos_stops_and_strips_under_spec(engines, plain):
    """A custom stop token ends a speculative row mid-stream, also when it
    arrives inside an accepted draft run, and is stripped like plain decode."""
    jb, tb = engines
    ids = tb.tok.encode(plain[0], add_bos=False)
    stop = ids[len(ids) // 2]
    kw = dict(eos_ids=(stop,), spec_k=K)
    want = jb.generate(PROMPTS, config=JaxGenerationConfig(**kw), references=plain)
    got = tb.generate(PROMPTS, config=GenerationConfig(**kw), references=plain)
    assert got == want
    assert got[0] == tb.tok.decode(ids[: ids.index(stop)]).strip()
    assert counts(tb.take_spec_report()) == counts(jb.take_spec_report())


def test_spec_k_zero_and_refless_groups_take_the_plain_path(engines, plain):
    """spec_k=0 never enters the spec path; with spec on, a group whose
    prompts carry no reference decodes plainly (its report rows are zero)
    while a referenced group speculates; an all-empty references list is
    spec-off."""
    _, tb = engines
    before = tb.stats.spec_verify_steps
    assert tb.generate(PROMPTS, references=REFS) == plain
    assert tb.take_spec_report() == [] and tb.stats.spec_verify_steps == before

    _, _, model = carried_weights()
    b2 = TorchBackend(model=model, flash=True, batch_size=2, max_new_tokens=MAX_NEW, device="cpu")
    prompts = ["a", "b", PROMPTS[0], PROMPTS[2]]
    plain2 = b2.generate(prompts)
    got = b2.generate(prompts, config=GenerationConfig(spec_k=K), references=[None, None, REFS[0], REFS[2]])
    assert got == plain2
    report = b2.take_spec_report()
    assert [r.verify_steps > 0 for r in report] == [False, False, True, True]
    before = b2.stats.spec_verify_steps
    assert b2.generate(prompts[:2], config=GenerationConfig(spec_k=K), references=[None, ""]) == plain2[:2]
    assert b2.take_spec_report() == [] and b2.stats.spec_verify_steps == before


def test_spec_batch_invariance(engines):
    _, tb = engines
    gen = GenerationConfig(spec_k=K)
    alone = tb.generate([PROMPTS[0]], config=gen, references=[REFS[0]])[0]
    assert tb.generate(PROMPTS, config=gen, references=REFS)[0] == alone


def test_sampled_spec_terminates_and_reports(engines):
    """Sampling through the rejection rule: not the plain stream, but it
    terminates within the budget with coherent counters, and a rerun with
    the same seed replays it."""
    jb, tb = engines
    _, _, model = carried_weights()
    gen = GenerationConfig(spec_k=K, temperature=1.0, seed=11)
    runs = []
    for _ in range(2):
        b = TorchBackend(model=model, flash=True, batch_size=4, max_new_tokens=MAX_NEW, device="cpu")
        runs.append((b.generate(PROMPTS, config=gen, references=REFS), b.take_spec_report()))
    assert runs[0] == runs[1]
    for r in runs[0][1]:
        assert 0 <= r.accepted_tokens <= r.draft_tokens
        assert 0 < r.verify_steps <= MAX_NEW


def test_misaligned_references_and_hints_rejected(engines):
    _, tb = engines
    with pytest.raises(ValueError, match="references must align"):
        tb.generate(PROMPTS, config=GenerationConfig(spec_k=2), references=["x"])
    with pytest.raises(ValueError, match="cache_hints must align"):
        tb.generate(PROMPTS, cache_hints=["x"])


# -- the strategy seam and the pipeline -----------------------------------------


class Recorder:
    """A backend stub that records what the strategy hands it."""

    name = "recorder"

    def __init__(self):
        self.prompts: list[str] = []
        self.references: list = []
        self.hints: list = []

    def generate(self, prompts, *, max_new_tokens=None, config=None, references=None,
                 cache_hints=None):
        self.prompts += prompts
        self.references += references if references is not None else [None] * len(prompts)
        self.hints += cache_hints if cache_hints is not None else [None] * len(prompts)
        return [f"tóm tắt {len(p.split())}" for p in prompts]

    def count_tokens(self, text):
        return len(text.split())


def test_strategies_thread_chunk_references_to_backend():
    """The map round hands each chunk to the backend as that prompt's
    reference (the seam speculation rides), and every call passes the same
    references and cache hints as the JAX package's strategy."""
    from vnsum_tpu.strategies.mapreduce import MapReduceStrategy as JaxMapReduce
    from vnsum_tpu.text.splitter import RecursiveTokenSplitter as JaxSplitter
    from vnsum_tpu_torch.strategies.mapreduce import MapReduceStrategy
    from vnsum_tpu_torch.text.splitter import RecursiveTokenSplitter
    from vnsum_tpu_torch.text.tokenizer import whitespace_token_count

    doc = " ".join(f"từ{i}" for i in range(120))
    rec = Recorder()
    splitter = RecursiveTokenSplitter(40, 5, length_function=whitespace_token_count)
    res = MapReduceStrategy(rec, splitter, token_max=60).summarize(doc)
    assert res.summary
    assert len(rec.references) == len(rec.prompts) == res.llm_calls
    for ref in rec.references[: res.num_chunks]:
        assert ref and ref in doc
    assert all(h for h in rec.hints)

    jrec = Recorder()
    jsplitter = JaxSplitter(40, 5, length_function=whitespace_token_count)
    JaxMapReduce(jrec, jsplitter, token_max=60).summarize(doc)
    assert (rec.prompts, rec.references, rec.hints) == (jrec.prompts, jrec.references, jrec.hints)


def test_mapreduce_with_a_spec_backend_matches_jax(tmp_path):
    """The whole pipeline over data/vi_eval with spec_k on: every map and
    reduce group speculates against its references, and the summaries and
    ROUGE equal the JAX run's. max_new 120 and k 7 keep C = S + 128."""
    from vnsum_tpu.core import PipelineConfig as JaxPipelineConfig
    from vnsum_tpu.pipeline.runner import PipelineRunner as JaxPipelineRunner
    from vnsum_tpu_torch.core.config import PipelineConfig
    from vnsum_tpu_torch.pipeline.runner import PipelineRunner

    fixture = Path(__file__).resolve().parent.parent / "data" / "vi_eval"
    knobs = dict(chunk_size=1024, chunk_overlap=100, token_max=1500, max_new_tokens=120)

    def dirs(root):
        return dict(
            docs_dir=str(fixture / "doc"), summary_dir=str(fixture / "summary"),
            generated_summaries_dir=str(root / "gen"), results_dir=str(root / "results"),
            logs_dir=str(root / "logs"),
        )

    jcfg, params, model = carried_weights(max_seq_len=4096)
    jax_embedder, port_embedder = carried_embedders()
    jax_runner = JaxPipelineRunner(
        JaxPipelineConfig(approach="mapreduce", models=["tiny"], **dirs(tmp_path / "jax"), **knobs),
        backend_factory=lambda _: TpuBackend(
            model_config=jcfg, params=params, flash=True, interpret=True, batch_size=8,
            max_new_tokens=120, generation=JaxGenerationConfig(spec_k=7),
        ),
        embedding_model=jax_embedder,
    )
    want = jax_runner.run()
    engines = []

    def factory(_):
        engines.append(TorchBackend(
            model=model, flash=True, batch_size=8, max_new_tokens=120,
            generation=GenerationConfig(spec_k=7), device="cpu",
        ))
        return engines[-1]

    runner = PipelineRunner(
        PipelineConfig(approach="mapreduce", models=["tiny"], **dirs(tmp_path / "port"), **knobs),
        backend_factory=factory, embedding_model=port_embedder, device="cpu",
    )
    got = runner.run()
    assert runner.failures == []
    names = sorted(p.name for p in (fixture / "doc").glob("*.txt"))
    gen, jgen = tmp_path / "port" / "gen_mapreduce_tiny", tmp_path / "jax" / "gen_mapreduce_tiny"
    assert sorted(p.name for p in gen.glob("*.txt")) == names
    for name in names:
        assert (gen / name).read_bytes() == (jgen / name).read_bytes(), name
    assert got.evaluation["tiny"]["rouge_scores"] == want.evaluation["tiny"]["rouge_scores"]
    assert_embedding_stats_close(got.evaluation["tiny"], want.evaluation["tiny"])
    st = engines[0].stats
    assert st.spec_verify_steps > 0 and st.decode_steps == 0
