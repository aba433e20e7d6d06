"""The committed trained fixture (data/fixtures/llama_k128: 2 layers, hidden
256, 2 query heads on 1 KV head at head_dim 128, a byte-level BPE
tokenizer) through the port and the JAX package on the CPU, in f32.

The JAX engine runs dense (``flash=False``, as tests/torch_strategy_parity.py
runs it), the port's through its kernel wrappers, whose plain versions take
CPU tensors, over an f32 cache. The JAX package reads the tokenizer through
transformers, the port through its own reader (text/bpe.py). Every path
gives the JAX package's ids: map-reduce through both PipelineRunners with
``--weights-dir``, the reference-guided spec path and its oracle run, the
in-flight slot loop with staggered joins, and a warm prefix-cache resume.
The fixture itself: its config is KERNEL_SHAPE_OVERRIDES at 2048
positions, its files are the ones its README lists, and it stays under 4 MB.
"""
from __future__ import annotations

import hashlib
import json
import re
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from vnsum_tpu.backend.engine import TpuBackend
from vnsum_tpu.core import PipelineConfig as JaxPipelineConfig
from vnsum_tpu.core.config import GenerationConfig as JaxGenerationConfig
from vnsum_tpu.models import convert as jc
from vnsum_tpu.pipeline.runner import PipelineRunner as JaxPipelineRunner
from vnsum_tpu_torch.backend.engine import TorchBackend
from vnsum_tpu_torch.core.config import GenerationConfig, PipelineConfig
from vnsum_tpu_torch.models import convert as tc
from vnsum_tpu_torch.models.fixtures import KERNEL_SHAPE_OVERRIDES
from vnsum_tpu_torch.pipeline.runner import PipelineRunner
from vnsum_tpu_torch.strategies.prompts import MAPREDUCE_MAP
from vnsum_tpu_torch.text.bpe import BPETokenizer

from test_torch_engine import record_ids
from test_torch_eval_embedding import assert_embedding_stats_close, carried_embedders
from test_torch_ops_flash import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "data" / "fixtures" / "llama_k128"
VI_EVAL = ROOT / "data" / "vi_eval"
# new tokens a prompt: the map prompts (1,100-1,400 tokens) bucket to
# S = 2048 - NEW, one group of 8 rows with an all-pad filler
NEW = 32
SPEC_K = 8


def documents() -> list[str]:
    return [p.read_text(encoding="utf-8") for p in sorted((VI_EVAL / "doc").glob("*.txt"))]


PROMPTS = [MAPREDUCE_MAP.format(content=d) for d in documents()]


@pytest.fixture(scope="module")
def weights():
    """(JAX config, JAX params, port model): the fixture in f32 through
    each package's own loader."""
    jcfg, params = jc.load_hf_checkpoint(str(FIXTURE), dtype=jnp.float32)
    _, model = tc.load_hf_checkpoint(str(FIXTURE), dtype=torch.float32, device="cpu")
    return jcfg, params, model


def backends(weights, **kw):
    """(JAX backend, port backend) on the fixture, each with its own
    reading of the fixture's tokenizer."""
    jcfg, params, model = weights
    kw = {"batch_size": 8, "max_new_tokens": NEW, **kw}
    jb = TpuBackend(model_config=jcfg, params=params, tokenizer=f"hf:{FIXTURE}", flash=False,
                    **kw)
    tb = TorchBackend(model=model, tokenizer=f"hf:{FIXTURE}", flash=True, quantize_kv=False,
                      device="cpu", **kw)
    assert isinstance(tb.tok, BPETokenizer)
    return jb, tb


@pytest.fixture(scope="module")
def oneshot(weights):
    """The map prompts' greedy one-shot outputs and id rows, both sides."""
    jb, tb = backends(weights)
    jrows, rows = record_ids(jb), record_ids(tb)
    want, got = jb.generate(PROMPTS), tb.generate(PROMPTS)
    return want, got, jrows, rows


def test_config_is_the_kernel_shape():
    hf = json.loads((FIXTURE / "config.json").read_text())
    for key, value in KERNEL_SHAPE_OVERRIDES.items():
        assert hf[key] == value, key
    assert hf["max_position_embeddings"] == 2048
    assert (hf["vocab_size"], hf["num_hidden_layers"], hf["tie_word_embeddings"]) == (384, 2, True)
    cfg = tc.config_from_hf(hf)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.max_seq_len) == (2, 1, 128, 2048)
    assert cfg.n_heads // cfg.n_kv_heads == 2


def test_fixture_is_small_and_its_readme_lists_its_files():
    files = {p.name: p.read_bytes() for p in FIXTURE.iterdir() if p.name != "README.md"}
    assert sum(len(b) for b in files.values()) + len((FIXTURE / "README.md").read_bytes()) < 4e6
    listed = dict(re.findall(r"^\| `([^`]+)` \| [\d,]+ \| `([0-9a-f]{64})` \|$",
                             (FIXTURE / "README.md").read_text(), re.MULTILINE))
    assert listed == {name: hashlib.sha256(b).hexdigest() for name, b in files.items()}


def test_oneshot_ids_match_jax(oneshot):
    want, got, jrows, rows = oneshot
    assert got == want and rows == jrows
    assert all(want) and len(set(want)) > 1  # text, and not one text for all


def test_mapreduce_weights_dir_matches_jax(tmp_path):
    """--weights-dir through both PipelineRunners over the 7 documents (one
    chunk each): byte-identical summaries, equal ROUGE, embedding metrics
    within their tolerance. The port's runner resolves the checkpoint and
    its tokenizer as the CLI does (``_resolve_model``); its engine takes the
    kernels' plain versions."""
    jm, pm = carried_embedders()
    knobs = dict(approach="mapreduce", models=["fixture"], weights_dir=str(FIXTURE),
                 dtype="float32", max_new_tokens=NEW, batch_size=8,
                 docs_dir=str(VI_EVAL / "doc"), summary_dir=str(VI_EVAL / "summary"))

    def paths(name):
        root = tmp_path / name
        return dict(generated_summaries_dir=str(root / "gen"),
                    results_dir=str(root / "results"), logs_dir=str(root / "logs"))

    want = JaxPipelineRunner(JaxPipelineConfig(**knobs, **paths("jax")),
                             embedding_model=jm).run()
    runner = PipelineRunner(PipelineConfig(**knobs, **paths("port")), embedding_model=pm,
                            device="cpu")
    engines = []

    def factory(model):
        cfg = runner.config
        engines.append(TorchBackend(**runner._resolve_model(model), flash=True,
                                    quantize_kv=False, batch_size=cfg.batch_size,
                                    max_new_tokens=cfg.max_new_tokens, device="cpu"))
        return engines[-1]

    runner.backend_factory = factory
    got = runner.run()
    assert runner.failures == []
    assert isinstance(engines[0].tok, BPETokenizer) and engines[0].use_kernels
    gen = {p.name: p.read_bytes() for p in (tmp_path / "port" / "gen_mapreduce_fixture").glob("*")}
    jgen = {p.name: p.read_bytes() for p in (tmp_path / "jax" / "gen_mapreduce_fixture").glob("*")}
    assert len(gen) == 7 and gen == jgen
    assert all(gen.values())
    rec, jrec = got.summarization["fixture"], want.summarization["fixture"]
    assert rec["total_chunks"] == jrec["total_chunks"] == 7
    ev, jev = got.evaluation["fixture"], want.evaluation["fixture"]
    assert ev["rouge_scores"] == jev["rouge_scores"]
    assert_embedding_stats_close(ev, jev)


def spec_counts(report) -> list:
    return [(r.draft_tokens, r.accepted_tokens, r.verify_steps) for r in report]


@pytest.mark.parametrize("refs", ["documents", "oracle"])
def test_spec_path_matches_jax_and_the_oneshot(weights, oneshot, refs):
    """The reference-guided spec path (each prompt's document as its
    reference, as the pipeline passes its chunk) and the oracle run (the
    one-shot outputs as references): the JAX spec path's texts and draft
    counts, and the one-shot outputs (greedy speculation changes no token)."""
    want_plain = oneshot[0]
    references = documents() if refs == "documents" else want_plain
    jb, tb = backends(weights)
    want = jb.generate(PROMPTS, config=JaxGenerationConfig(spec_k=SPEC_K), references=references)
    got = tb.generate(PROMPTS, config=GenerationConfig(spec_k=SPEC_K), references=references)
    assert got == want == want_plain
    report, jreport = tb.take_spec_report(), jb.take_spec_report()
    assert spec_counts(report) == spec_counts(jreport)
    accepted = sum(r.accepted_tokens for r in report)
    assert accepted > 0
    if refs == "oracle":  # every draft of an oracle reference is the model's own token
        assert accepted == sum(r.draft_tokens for r in report)


def staggered(b, prompts, slots=4):
    """Admits 3 prompts, then refills as slots free until all are done."""
    loop = b.start_slot_loop(slots)
    outs: dict = {}
    adm, rej = loop.admit([(i, prompts[i], None) for i in range(3)])
    assert rej == [] and len(adm) == 3
    pending = list(range(3, len(prompts)))
    for _ in range(64):
        for c in loop.step().completions:
            outs[c.key] = c.text
        if pending and loop.free:
            adm, rej = loop.admit([(i, prompts[i], None) for i in pending])
            assert rej == []
            for a in adm:
                pending.remove(a.key)
        if not pending and loop.active == 0:
            break
    assert loop.active == 0 and not pending
    texts = [outs[i] for i in range(len(prompts))]
    loop.close()
    return texts, loop


def test_slot_loop_matches_jax_loop_and_the_oneshot(weights, oneshot):
    """The 7 map prompts through 4 slots with staggered joins: the JAX slot
    loop's texts and counters, and the one-shot outputs."""
    jb, tb = backends(weights, segment_tokens=8)
    (got, loop), (want, jloop) = staggered(tb, PROMPTS), staggered(jb, PROMPTS)
    assert got == want == oneshot[0]
    assert loop.refills == jloop.refills == len(PROMPTS)
    assert (loop.segments, loop.fused_dispatches) == (jloop.segments, jloop.fused_dispatches)
    assert loop.decode_steps > 0


def test_warm_prefix_cache_resume_matches_jax_and_the_cold_call(weights, oneshot):
    """The map prompts twice through a 256-block prefix cache: the cold and
    the warm call give the JAX package's ids and the uncached one-shot's
    texts; the warm call resumes from the cached blocks (prompt tokens
    skipped, the same cache reports as JAX's)."""
    jb, tb = backends(weights, cache_blocks=256, cache_block_tokens=64)
    jrows, rows = record_ids(jb), record_ids(tb)
    for call in ("cold", "warm"):
        want, got = jb.generate(PROMPTS), tb.generate(PROMPTS)
        assert got == want == oneshot[0], call
        assert tb.take_cache_report() == jb.take_cache_report()
    assert rows == jrows
    assert tb.stats.cache_hit_tokens == jb.stats.cache_hit_tokens > 0
    assert tb.prefix_cache_stats() == jb.prefix_cache_stats()
