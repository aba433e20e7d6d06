"""Generation with int8 weights (``quantize=True``) and W8A8 prefill
(``quantize_act=True``) in the port against the JAX package, on carried
weights: the one-shot engine, the spec path, the slot loop, the
long-context backend and the map-reduce pipeline (with carried weights and
with an HF checkpoint through both runners' default backends).

Each JAX engine runs its kernels in interpret mode (dense where the case
says so), the port's wrappers their plain versions, the int8 projections
the GEMV's plain version. Everything is f32, so greedy outputs must be
byte-identical. Cache lengths stay multiples of 128 (see
tests/test_torch_engine.py).
"""
from __future__ import annotations

import json

import pytest

from vnsum_tpu.backend import long_context as jlc
from vnsum_tpu.backend.engine import TpuBackend
from vnsum_tpu.core import PipelineConfig as JaxPipelineConfig
from vnsum_tpu.core.config import GenerationConfig as JaxGenerationConfig
from vnsum_tpu.parallel.mesh import make_mesh
from vnsum_tpu.pipeline.runner import PipelineRunner as JaxPipelineRunner
from vnsum_tpu_torch.backend import long_context as tlc
from vnsum_tpu_torch.backend.engine import TorchBackend
from vnsum_tpu_torch.core.config import GenerationConfig, PipelineConfig
from vnsum_tpu_torch.pipeline import cli
from vnsum_tpu_torch.pipeline.runner import PipelineRunner

from test_torch_engine import PROMPTS, record_ids
from test_torch_eval_embedding import (
    assert_embedding_stats_close,
    carried_embedders,
    small_default_encoder,
)
from test_torch_models_convert import hf_dir  # noqa: F401
from test_torch_models_llama import carried_weights, one_torch_thread  # noqa: F401
from test_torch_pipeline import DOC_NAMES, FIXTURE, KNOBS, MAX_NEW, dirs

# mode -> TpuBackend / TorchBackend quantization keywords
MODES = {"int8": dict(quantize=True), "w8a8": dict(quantize=True, quantize_act=True)}


@pytest.fixture(scope="module")
def carried():
    return carried_weights(max_seq_len=1024)


# arm -> (prompts, batch_size, prefill_chunk_tokens, flash)
ARMS = {
    "whole": (PROMPTS, 4, 0, True),
    "chunked": ([p * 4 for p in PROMPTS], 4, 128, True),
    "dense": (PROMPTS, 4, 0, False),
}


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_generate_matches_jax_engine(carried, mode, arm):
    jcfg, params, model = carried
    prompts, batch, chunk, flash = ARMS[arm]
    jb = TpuBackend(
        model_config=jcfg, params=params, flash=flash, interpret=flash,
        batch_size=batch, max_new_tokens=MAX_NEW, prefill_chunk_tokens=chunk, **MODES[mode],
    )
    tb = TorchBackend(
        model=model, flash=flash, batch_size=batch, max_new_tokens=MAX_NEW,
        prefill_chunk_tokens=chunk, device="cpu", **MODES[mode],
    )
    assert tb.model.quantized and tb.cfg.w8a8_prefill == (mode == "w8a8")
    j_ids, t_ids = record_ids(jb), record_ids(tb)
    want = jb.generate(prompts)
    got = tb.generate(prompts)
    assert got == want and any(got)
    assert t_ids == j_ids
    assert tb.stats.by_bucket == jb.stats.by_bucket


SPEC_PROMPTS = [
    "văn bản một về kinh tế",
    "hai " * 5,
    "một tài liệu dài hơn hẳn về pháp luật",
]
SPEC_REFS = [
    "văn bản một về kinh tế xã hội và phát triển bền vững",
    None,
    "một tài liệu dài hơn hẳn về pháp luật và đời sống",
]
# prompts bucket to S=64: the spec cache is 64 + 58 + 5 + 1 = 128 slots
SPEC_NEW, SPEC_K = 58, 5


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_spec_matches_jax_spec_and_plain_decode(mode):
    """The spec path's verify forwards (per-row slots, so never W8A8) on
    int8 weights: JAX's spec texts and counts, and the port's own plain
    decode."""
    jcfg, params, model = carried_weights()
    kw = dict(batch_size=4, max_new_tokens=SPEC_NEW, **MODES[mode])
    jb = TpuBackend(model_config=jcfg, params=params, flash=True, interpret=True, **kw)
    tb = TorchBackend(model=model, flash=True, device="cpu", **kw)
    want = jb.generate(SPEC_PROMPTS, config=JaxGenerationConfig(spec_k=SPEC_K),
                       references=SPEC_REFS)
    got = tb.generate(SPEC_PROMPTS, config=GenerationConfig(spec_k=SPEC_K),
                      references=SPEC_REFS)
    assert got == want and any(got)
    report, jreport = tb.take_spec_report(), jb.take_spec_report()
    assert [(r.draft_tokens, r.accepted_tokens, r.verify_steps) for r in report] == [
        (r.draft_tokens, r.accepted_tokens, r.verify_steps) for r in jreport]
    assert tb.stats.spec_verify_steps > 0
    assert got == tb.generate(SPEC_PROMPTS)


SLOT_PROMPTS = ["văn bản một về kinh tế", "hai", "văn bản thứ ba dài hơn một chút về xã hội",
                "bốn bốn", "năm năm năm"]


def drain(loop, prompts) -> list:
    outs: dict = {}
    adm, rej = loop.admit([(i, p, None) for i, p in enumerate(prompts[:3])])
    assert rej == [] and len(adm) == 3
    pending = list(range(3, len(prompts)))
    for _ in range(64):
        for c in loop.step().completions:
            outs[c.key] = c.text
        if pending and loop.free:
            adm, _ = loop.admit([(i, prompts[i], None) for i in pending])
            for a in adm:
                pending.remove(a.key)
        if not pending and loop.active == 0:
            break
    assert loop.active == 0 and not pending
    return [outs[i] for i in range(len(prompts))]


@pytest.mark.parametrize("mode", list(MODES))
def test_slot_loop_matches_jax_loop(mode):
    """The in-flight slot loop on int8 weights (its segment forwards at
    per-row slots, its joins' prefills W8A8 in that mode), with staggered
    joins: the JAX loop's texts, and each request's solo generate."""
    jcfg, params, model = carried_weights(max_seq_len=128)
    kw = dict(batch_size=8, max_new_tokens=24, seed=1, segment_tokens=4, **MODES[mode])
    jb = TpuBackend(model_config=jcfg, params=params, flash=True, interpret=True, **kw)
    tb = TorchBackend(model=model, flash=True, device="cpu", **kw)
    got = drain(tb.start_slot_loop(4), SLOT_PROMPTS)
    assert got == drain(jb.start_slot_loop(4), SLOT_PROMPTS) and any(got)
    solo = TorchBackend(model=model, flash=True, device="cpu", **kw)
    assert got == [solo.generate([p])[0] for p in SLOT_PROMPTS]


LONG_PROMPTS = [
    "Tóm tắt văn bản sau: nền kinh tế tăng trưởng ổn định trong quý một. " * 2,
    "hai",
    "Một tài liệu dài hơn hẳn nói về chính sách giáo dục và y tế cơ sở "
    "tại các địa phương miền núi phía bắc. " * 3,
]


def test_long_context_backend_matches_jax():
    """TorchLongContextBackend(quantize=True) at one rank against the JAX
    LongContextBackend(quantize=True) on a four-device seq mesh (its decode
    kernel in interpret mode), and against the port's one-card engine on
    the same int8 weights."""
    jcfg, params, model = carried_weights(4, max_seq_len=2048)
    mesh = make_mesh({"seq": 4}, platform="cpu")
    jax_be = jlc.LongContextBackend(
        model_config=jcfg, mesh=mesh, params=params, batch_size=4, max_new_tokens=16,
        max_total_tokens=2048, quantize=True, decode_kernel=True, interpret=True,
    )
    port = tlc.TorchLongContextBackend(
        model=model, batch_size=4, max_new_tokens=16, max_total_tokens=2048, quantize=True,
        device="cpu",
    )
    assert port.model.quantized and not model.quantized
    got = port.generate(LONG_PROMPTS)
    assert got == jax_be.generate(LONG_PROMPTS) and any(got)
    engine = TorchBackend(model=port.model, flash=False, batch_size=4, max_new_tokens=16,
                          device="cpu")
    assert got == engine.generate(LONG_PROMPTS)


@pytest.mark.parametrize("mode", list(MODES))
def test_mapreduce_over_vi_eval_matches_jax(tmp_path, mode):
    """The map-reduce pipeline over data/vi_eval with --quantize (and
    --quantize-act) on carried weights: byte-identical summaries, equal
    ROUGE, embedding metrics as in tests/test_torch_pipeline.py."""
    jcfg, params, model = carried_weights(max_seq_len=4096)
    jax_embedder, port_embedder = carried_embedders()
    flags = dict(quantize=True, quantize_act=mode == "w8a8")
    jax_cfg = JaxPipelineConfig(approach="mapreduce", models=["tiny"],
                                **dirs(tmp_path / "jax"), **KNOBS, **flags)
    want = JaxPipelineRunner(
        jax_cfg,
        backend_factory=lambda _: TpuBackend(
            model_config=jcfg, params=params, flash=True, interpret=True, batch_size=8,
            max_new_tokens=MAX_NEW, quantize=jax_cfg.quantize, quantize_act=jax_cfg.quantize_act,
        ),
        embedding_model=jax_embedder,
    ).run()
    engines = []
    cfg = PipelineConfig(approach="mapreduce", models=["tiny"], **dirs(tmp_path / "port"),
                         **KNOBS, **flags)

    def factory(_):
        engines.append(TorchBackend(
            model=model, flash=True, batch_size=8, max_new_tokens=MAX_NEW,
            quantize=cfg.quantize, quantize_act=cfg.quantize_act, device="cpu",
        ))
        return engines[-1]

    runner = PipelineRunner(cfg, backend_factory=factory, embedding_model=port_embedder,
                            device="cpu")
    got = runner.run()
    assert runner.failures == []
    assert engines[0].model.quantized
    gen, jgen = tmp_path / "port" / "gen_mapreduce_tiny", tmp_path / "jax" / "gen_mapreduce_tiny"
    assert sorted(p.name for p in gen.glob("*.txt")) == DOC_NAMES
    for name in DOC_NAMES:
        assert (gen / name).read_bytes() == (jgen / name).read_bytes(), name
    assert any((gen / name).stat().st_size for name in DOC_NAMES)
    ev = got.evaluation["tiny"]
    assert ev["rouge_scores"] == want.evaluation["tiny"]["rouge_scores"]
    assert_embedding_stats_close(ev, want.evaluation["tiny"])


def test_weights_dir_pipeline_with_quantize_matches_jax(hf_dir, tmp_path):  # noqa: F811
    """--weights-dir with --quantize through both runners' default
    backends (the JAX engine dense on the CPU, as is the port's by
    default): byte-identical summaries over two documents."""
    jm, pm = carried_embedders()
    knobs = dict(approach="mapreduce", models=["tiny-ckpt"], weights_dir=str(hf_dir),
                 dtype="float32", chunk_size=300, chunk_overlap=30, token_max=400,
                 max_new_tokens=16, batch_size=4, max_samples=2, quantize=True,
                 docs_dir=str(FIXTURE / "doc"), summary_dir=str(FIXTURE / "summary"))

    def paths(name):
        root = tmp_path / name
        return dict(generated_summaries_dir=str(root / "gen"),
                    results_dir=str(root / "results"), logs_dir=str(root / "logs"))

    JaxPipelineRunner(JaxPipelineConfig(**knobs, **paths("jax")), embedding_model=jm).run()
    runner = PipelineRunner(PipelineConfig(**knobs, **paths("port")), embedding_model=pm,
                            device="cpu")
    engines = []
    factory = runner.backend_factory
    runner.backend_factory = lambda m: engines.append(factory(m)) or engines[-1]
    runner.run()
    assert runner.failures == [] and engines[0].model.quantized
    gen = {p.name: p.read_bytes() for p in (tmp_path / "port" / "gen_mapreduce_tiny-ckpt").glob("*")}
    jgen = {p.name: p.read_bytes() for p in (tmp_path / "jax" / "gen_mapreduce_tiny-ckpt").glob("*")}
    assert len(gen) == 2 and gen == jgen and any(gen.values())


def test_cli_quantize_flags_reach_the_backend(tmp_path, monkeypatch):
    """--quantize --quantize-act on the CLI with a registry model: the
    default backend runs int8 weights with W8A8 prefill, and the run record
    says so."""
    small_default_encoder(monkeypatch)
    built = []
    real = TorchBackend.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        built.append(self)

    monkeypatch.setattr(TorchBackend, "__init__", spy)
    argv = ["--approach", "mapreduce", "--models", "tiny", "--device", "cpu",
            "--chunk-size", "400", "--max-new-tokens", "8", "--max-samples", "2",
            "--quantize", "--quantize-act"]
    for k, v in dirs(tmp_path).items():
        argv += ["--" + k.replace("_", "-"), v]
    assert cli.main(argv) == 0
    assert built and all(b.model.quantized and b.model.cfg.w8a8_prefill for b in built)
    saved = json.loads(next((tmp_path / "results").glob("pipeline_results_*.json")).read_text())
    assert saved["config"]["quantize"] and saved["config"]["quantize_act"]
    assert saved["results"]["summarization"]["tiny"]["successful"] == 2
