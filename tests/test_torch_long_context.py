"""The port's long-context path (TorchLongContextBackend at one rank, on the
CPU) against the JAX package's LongContextBackend on a four-device
``{"seq": 4}`` CPU mesh, on carried weights.

The port's kernels take their plain versions (K1 for the prefill, K2p for
the decode partials); the JAX decode kernel runs in interpret mode where a
case asks for it. Everything is f32, so greedy outputs must be
byte-identical and numbers agree to summation order. Prefill shards stay
multiples of 128 slots: the JAX decode kernel's interpret mode pads a
ragged last block with NaN. Two ranks over gloo are in
tests/test_torch_parallel_seq.py.
"""
from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnsum_tpu.backend import long_context as jlc
from vnsum_tpu.core import PipelineConfig as JaxPipelineConfig
from vnsum_tpu.models.llama import init_kv_cache as jax_init_kv_cache
from vnsum_tpu.parallel.mesh import make_mesh
from vnsum_tpu.pipeline.runner import PipelineRunner as JaxPipelineRunner
from vnsum_tpu_torch.backend import long_context as tlc
from vnsum_tpu_torch.backend.engine import TorchBackend
from vnsum_tpu_torch.core.config import GenerationConfig, PipelineConfig
from vnsum_tpu_torch.models import llama as tl
from vnsum_tpu_torch.pipeline.runner import PipelineRunner
from vnsum_tpu_torch.strategies import TruncatedStrategy

from test_torch_eval_embedding import (
    assert_embedding_stats_close,
    carried_embedders,
    small_default_encoder,
)
from test_torch_models_llama import carried_weights, one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).resolve().parent.parent / "data" / "vi_eval"
DOC_NAMES = sorted(p.name for p in (FIXTURE / "doc").glob("*.txt"))
PROMPTS = [
    "Tóm tắt văn bản sau: nền kinh tế tăng trưởng ổn định trong quý một. " * 2,
    "hai",
    "Một tài liệu dài hơn hẳn nói về chính sách giáo dục và y tế cơ sở "
    "tại các địa phương miền núi phía bắc. " * 3,
]
LONG_DOC = (
    "Chính phủ ban hành nghị định mới về phát triển hạ tầng giao thông "
    "và chuyển đổi số tại đồng bằng sông Cửu Long. " * 6
)  # ~700 bytes, past a 128-token one-card ceiling
MAX_NEW = 16


@pytest.fixture(scope="module")
def mesh():
    return make_mesh({"seq": 4}, platform="cpu")


@pytest.fixture(scope="module")
def carried():
    # seed 4: random greedy rows that do not all collapse onto one token
    return carried_weights(4, max_seq_len=2048)


def tensors(tree: dict) -> dict:
    return {n: torch.from_numpy(np.array(a)) for n, a in tree.items()}


def prefill_inputs(seed: int, B: int = 3, S: int = 512):
    """Random prompt ids [B, S] with left pads 0, 70 and 300 (the last row's
    pad covers the first two 128-slot shards of the JAX mesh)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, size=(B, S)).astype(np.int32)
    pads = np.array([0, 70, 300][:B], dtype=np.int32)
    for b, p in enumerate(pads):
        tokens[b, :p] = 258
    return tokens, pads


def test_long_prefill_matches_jax(mesh, carried):
    jcfg, params, model = carried
    tokens, pads = prefill_inputs(0)
    want_logits, want_cache = jlc.long_prefill(
        params, jcfg, jnp.asarray(tokens), jnp.asarray(pads), mesh
    )
    logits, cache = tlc.long_prefill(model, torch.from_numpy(tokens), torch.from_numpy(pads))
    assert cache["k"].shape == (jcfg.n_layers, 3, jcfg.n_kv_heads, 512, jcfg.head_dim)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=2e-4, atol=2e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            cache[name].numpy(), np.asarray(want_cache[name]), rtol=2e-4, atol=2e-4
        )


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "dense"])
def test_long_decode_attention_matches_jax(mesh, carried, kernel, quantized):
    """The same frozen prefill cache, the merged attention over it and a
    decode cache with four written slots: the port (K2p's plain version)
    against JAX with its kernel in interpret mode, and against JAX's dense
    partial. f32 on both sides -> 2e-5, as the JAX package's own check."""
    jcfg, params, _ = carried
    tokens, pads = prefill_inputs(1)
    _, jcache = jlc.long_prefill(params, jcfg, jnp.asarray(tokens), jnp.asarray(pads), mesh)
    if quantized:
        jcache = jlc.quantize_prefill_cache(jcache)
    rng = np.random.default_rng(2)
    B, H, hd, G = 3, jcfg.n_heads, jcfg.head_dim, jcfg.q_per_kv
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    jdec = jax_init_kv_cache(jcfg, B, 8)
    dec = {n: rng.standard_normal(a.shape).astype(np.float32) for n, a in jdec.items()}
    for a in dec.values():
        a[:, :, :, 4:] = 0.0  # slots past t are never written
    t, layer = 3, 1
    want = jlc.make_long_decode_attention(
        mesh, jcache, jnp.asarray(pads), G, decode_kernel=kernel, interpret=kernel
    )(jnp.asarray(q), {n: jnp.asarray(a) for n, a in dec.items()}, jnp.int32(layer), t)
    got = tlc.make_long_decode_attention(tensors(jcache), torch.from_numpy(pads), G)(
        torch.from_numpy(q), tensors(dec), layer, t
    )
    assert got.shape == (B, 1, H, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arm", ["kernel", "dense", "int8"])
def test_greedy_generate_matches_jax_and_engine(mesh, carried, arm):
    """The port (K2p's plain version) against JAX with its decode kernel in
    interpret mode ("kernel"), with its dense partial ("dense"), and with an
    int8 prefill cache ("int8")."""
    jcfg, params, model = carried
    quantize_kv = arm == "int8"
    jax_be = jlc.LongContextBackend(
        model_config=jcfg, mesh=mesh, params=params, batch_size=4,
        max_new_tokens=MAX_NEW, max_total_tokens=2048, quantize_kv=quantize_kv,
        decode_kernel=arm == "kernel", interpret=arm == "kernel",
    )
    port = tlc.TorchLongContextBackend(
        model=model, batch_size=4, max_new_tokens=MAX_NEW, max_total_tokens=2048,
        quantize_kv=quantize_kv, device="cpu",
    )
    got = port.generate(PROMPTS)
    assert got == jax_be.generate(PROMPTS)
    assert any(got)
    if not quantize_kv:
        engine = TorchBackend(
            model=model, flash=False, batch_size=4, max_new_tokens=MAX_NEW, device="cpu"
        )
        assert got == engine.generate(PROMPTS)
    # one group of 3 rows + a filler row at bucket 512; one prefill forward
    assert port.stats.by_bucket == {(4, 512): 1} and port.stats.prefill_forwards == 1
    assert 0 < port.stats.decode_steps <= MAX_NEW


def test_prompt_past_the_one_card_ceiling(mesh):
    """A prompt longer than the model's max_seq_len runs untruncated and
    matches JAX and a big-context one-card oracle on the same weights."""
    jcfg, params, small = carried_weights(7, max_seq_len=128)
    _, _, big = carried_weights(7, max_seq_len=2048)
    assert len(LONG_DOC.encode()) > small.cfg.max_seq_len
    port = tlc.TorchLongContextBackend(
        model=small, max_new_tokens=12, max_total_tokens=2048, device="cpu"
    )
    got = port.generate([LONG_DOC])
    jax_be = jlc.LongContextBackend(
        model_config=jcfg, mesh=mesh, params=params, max_new_tokens=12,
        max_total_tokens=2048,
    )
    assert got == jax_be.generate([LONG_DOC])
    oracle = TorchBackend(model=big, flash=False, batch_size=2, max_new_tokens=12, device="cpu")
    assert got == oracle.generate([LONG_DOC])
    assert port.stats.prompt_tokens == len(LONG_DOC.encode()) + 1  # BOS, no cut


def test_batch_grouping_and_config_max_new(carried):
    """Prompts group into batch_size rows with per-group buckets, order is
    kept, and config.max_new_tokens is honoured."""
    _, _, model = carried
    be = tlc.TorchLongContextBackend(
        model=model, batch_size=2, max_new_tokens=16, max_total_tokens=2048, device="cpu"
    )
    prompts = ["a " * n for n in (4, 300, 8, 280, 2)]
    outs = be.generate(prompts)
    assert len(outs) == 5
    # short prompts bucket apart from long ones
    assert len({s for _, s in be.stats.by_bucket}) >= 2
    assert outs == [be.generate([p])[0] for p in prompts]
    short = be.generate(["một văn bản"], config=GenerationConfig(max_new_tokens=4))[0]
    longer = be.generate(["một văn bản"], config=GenerationConfig(max_new_tokens=16))[0]
    assert len(short.encode()) <= len(longer.encode())


def test_budget_checks(carried):
    _, _, model = carried
    with pytest.raises(ValueError, match="max_new_tokens"):
        tlc.TorchLongContextBackend(
            model=model, max_new_tokens=512, max_total_tokens=512, device="cpu"
        )
    be = tlc.TorchLongContextBackend(
        model=model, max_new_tokens=8, max_total_tokens=512, device="cpu"
    )
    with pytest.raises(ValueError, match="max_new_tokens"):
        be.generate(["x"], max_new_tokens=600)
    # the default total budget is the one-card ceiling times the ranks
    assert tlc.TorchLongContextBackend(model=model, max_new_tokens=8, device="cpu") \
        .max_total_tokens == model.cfg.max_seq_len
    assert be.generate([]) == []


def test_parameter_tree_or_model(carried):
    """A JAX-layout parameter tree of numpy arrays builds the same model."""
    import jax

    jcfg, params, model = carried
    tree = jax.tree.map(np.asarray, params)
    kw = dict(batch_size=4, max_new_tokens=8, max_total_tokens=1024, device="cpu")
    from_tree = tlc.TorchLongContextBackend(model_config=model.cfg, params=tree, **kw)
    assert from_tree.generate(PROMPTS) == tlc.TorchLongContextBackend(model=model, **kw) \
        .generate(PROMPTS)


def test_sampled_seed_replay():
    # unscaled random weights: flat distributions, so draws differ
    model = tl.init_model(tl.tiny_llama(max_seq_len=512), 5, "cpu")

    def fresh():
        return tlc.TorchLongContextBackend(
            model=model, batch_size=2, max_new_tokens=8, max_total_tokens=512, device="cpu"
        )

    gen = GenerationConfig(temperature=1.0, seed=4, max_new_tokens=8)
    a = fresh()
    a1 = a.generate(["văn bản"], config=gen)
    a2 = a.generate(["văn bản"], config=gen)
    assert a1 != a2  # fresh randomness per dispatch
    b = fresh()
    assert b.generate(["văn bản"], config=gen) == a1  # same-seed replay
    assert b.generate(["văn bản"], config=gen) == a2


def test_truncated_pipeline_matches_jax(tmp_path, mesh, carried):
    """PipelineRunner(approach="truncated") over data/vi_eval, the long
    backend built by the factory: summaries byte-identical to the JAX
    long-context run's, ROUGE equal. The registry's tiny model has a
    one-card ceiling of 256; every document is longer."""
    jcfg, params, model = carried
    jax_embedder, port_embedder = carried_embedders()
    knobs = dict(max_context=1024, max_new_tokens=MAX_NEW, batch_size=8)

    def dirs(root):
        return dict(
            docs_dir=str(FIXTURE / "doc"), summary_dir=str(FIXTURE / "summary"),
            generated_summaries_dir=str(root / "gen"), results_dir=str(root / "results"),
            logs_dir=str(root / "logs"),
        )

    want = JaxPipelineRunner(
        JaxPipelineConfig(approach="truncated", models=["tiny"], **dirs(tmp_path / "jax"), **knobs),
        backend_factory=lambda _: jlc.LongContextBackend(
            model_config=jcfg, mesh=mesh, params=params, batch_size=8,
            max_new_tokens=MAX_NEW, max_total_tokens=1024 + 1024,
        ),
        embedding_model=jax_embedder,
    ).run()
    backends = []

    def factory(_):
        backends.append(tlc.TorchLongContextBackend(
            model=model, batch_size=8, max_new_tokens=MAX_NEW, max_total_tokens=1024 + 1024,
            device="cpu",
        ))
        return backends[-1]

    runner = PipelineRunner(
        PipelineConfig(approach="truncated", models=["tiny"], **dirs(tmp_path / "port"), **knobs),
        backend_factory=factory, embedding_model=port_embedder, device="cpu",
    )
    got = runner.run()
    assert runner.failures == []
    rec = got.summarization["tiny"]
    assert rec["successful"] == len(DOC_NAMES) and rec["failed"] == 0
    assert rec["total_chunks"] == len(DOC_NAMES)  # one shot per document
    gen = tmp_path / "port" / "gen_truncated_tiny"
    jgen = tmp_path / "jax" / "gen_truncated_tiny"
    assert sorted(p.name for p in gen.glob("*.txt")) == DOC_NAMES
    for name in DOC_NAMES:
        assert (gen / name).read_bytes() == (jgen / name).read_bytes(), name
    assert got.evaluation["tiny"]["rouge_scores"] == want.evaluation["tiny"]["rouge_scores"]
    assert_embedding_stats_close(got.evaluation["tiny"], want.evaluation["tiny"])
    # every document was past the one-card ceiling and the prompts were cut
    # to max_context - max_new tokens of document plus the template
    assert all(len((FIXTURE / "doc" / n).read_bytes()) > tl.tiny_llama().max_seq_len
               for n in DOC_NAMES)
    assert backends[0].stats.by_bucket == {(8, 2048): 1}


def test_truncated_strategy_cuts_to_max_context():
    """The strategy cuts the document to max_context - max_new tokens and
    sends one prompt per document."""

    class Echo:
        name = "echo"

        def generate(self, prompts, **kw):
            return prompts

    doc = "Báo cáo kinh tế xã hội sáu tháng đầu năm. " * 40
    res = TruncatedStrategy(Echo(), max_context=300, max_new_tokens=20).summarize(doc)
    assert res.num_chunks == res.llm_calls == res.rounds == 1
    assert doc.encode()[:280].decode("utf-8", "ignore") in res.summary
    assert doc.encode()[:281].decode("utf-8", "ignore") not in res.summary


def test_truncated_cli_on_the_one_card_engine(tmp_path, monkeypatch):
    """The CLI's truncated approach on the one-card engine (tiny registry
    model, random weights): each document is cut to --max-context."""
    import json

    from vnsum_tpu_torch.pipeline import cli

    small_default_encoder(monkeypatch)

    args = ["--approach", "truncated", "--models", "tiny", "--device", "cpu",
            "--max-context", "200", "--max-new-tokens", "8", "--max-samples", "2",
            "--docs-dir", str(FIXTURE / "doc"), "--summary-dir", str(FIXTURE / "summary")]
    for k in ("generated_summaries_dir", "results_dir", "logs_dir"):
        args += ["--" + k.replace("_", "-"), str(tmp_path / k)]
    assert cli.config_from_args(cli.build_parser().parse_args(args)).max_context == 200
    assert cli.main(args) == 0
    saved = json.loads(next((tmp_path / "results_dir").glob("pipeline_results_*.json")).read_text())
    rec = saved["results"]["summarization"]["tiny"]
    assert rec["successful"] == 2 and rec["total_chunks"] == 2
    assert rec["approach"] == "truncated"


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tlc.TorchLongContextBackend(model_config=tl.tiny_llama(), device="cuda")
