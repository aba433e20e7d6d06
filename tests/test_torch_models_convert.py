"""The port's HF checkpoint reader, writer and loader
(vnsum_tpu_torch.models.convert) against the ``safetensors`` package,
``transformers`` and the JAX package's loader, and ``--weights-dir``
through both pipelines.

The port reads and writes safetensors with its own code (the card has no
``safetensors`` package); here the package is the reference. Checkpoints
are built by the JAX package's fixtures (a ``transformers``
``LlamaForCausalLM`` saved in f32) and by both packages'
``save_hf_checkpoint`` (bf16). Logits are f32 and differ only in summation
order: LOGITS_ATOL.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import load_file, save_file

from vnsum_tpu.core import PipelineConfig as JaxPipelineConfig
from vnsum_tpu.models import convert as jc
from vnsum_tpu.models import llama as jl
from vnsum_tpu.models.fixtures import make_tiny_hf_checkpoint
from vnsum_tpu.pipeline.runner import PipelineRunner as JaxPipelineRunner
from vnsum_tpu_torch.core.config import PipelineConfig
from vnsum_tpu_torch.models import convert as tc
from vnsum_tpu_torch.models import llama as tl
from vnsum_tpu_torch.pipeline.runner import PipelineRunner
from vnsum_tpu_torch.text.bpe import BPETokenizer

from test_torch_eval_embedding import assert_embedding_stats_close, carried_embedders
from test_torch_models_llama import carried_weights
from test_torch_ops_flash import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).resolve().parent.parent / "data" / "vi_eval"
LOGITS_ATOL = 1e-4


def corpus() -> list[str]:
    return [p.read_text(encoding="utf-8") for p in sorted((FIXTURE / "doc").glob("*.txt"))]


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A tiny trained HF Llama checkpoint (f32 safetensors, BPE tokenizer)."""
    root = tmp_path_factory.mktemp("hf")
    make_tiny_hf_checkpoint(root, corpus(), vocab_size=1024, dim=128, n_layers=2,
                            max_seq_len=2048, train_steps=100, train_batch=8,
                            train_seq_len=64)
    return root


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """The JAX package's save_hf_checkpoint of carried tiny Qwen3-style
    weights (qk_norm, untied head), bf16, one shard per layer."""
    root = tmp_path_factory.mktemp("jax")
    jcfg, params, _ = carried_weights(qk_norm=True, tie_embeddings=False)
    jc.save_hf_checkpoint(params, jcfg, str(root), shard_layers=1)
    return root


def shard_files(d: Path) -> list[Path]:
    return sorted(d.glob("*.safetensors"))


@pytest.mark.parametrize("which", ["hf_f32", "jax_bf16"])
def test_reader_matches_safetensors(which, hf_dir, jax_dir):
    d = hf_dir if which == "hf_f32" else jax_dir
    want_dtype = torch.float32 if which == "hf_f32" else torch.bfloat16
    n = 0
    for path in shard_files(d):
        got = tc.read_safetensors(str(path))
        with safe_open(str(path), framework="pt") as f:
            assert sorted(got) == sorted(f.keys())
            for name in f.keys():
                want = f.get_tensor(name)
                assert got[name].dtype == want.dtype == want_dtype, name
                assert torch.equal(got[name], want), name
                n += 1
    assert n > 10


def test_writer_is_read_back_by_safetensors(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        # odd element counts: the writer orders by element size, so every
        # tensor stays aligned
        "a.bf16": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)).bfloat16(),
        "b.f16": torch.from_numpy(rng.standard_normal(7).astype(np.float16)),
        "c.f32": torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32)),
        "d.i64": torch.from_numpy(rng.integers(-9, 9, size=5)),
        "e.scalar": torch.tensor(3.5),
        "f.empty": torch.zeros(0, 4),
        # a transposed view is written in its logical (C) order
        "g.view": torch.arange(12, dtype=torch.float32).view(3, 4).t(),
    }
    path = tmp_path / "x.safetensors"
    nbytes = tc.write_safetensors(tensors, str(path))
    assert nbytes == sum(t.numel() * t.element_size() for t in tensors.values())
    back = load_file(str(path))
    ours = tc.read_safetensors(str(path))
    for name, t in tensors.items():
        assert back[name].dtype == t.dtype and torch.equal(back[name], t), name
        assert ours[name].dtype == t.dtype and torch.equal(ours[name], t), name


def header_file(path: Path, header: dict, data: bytes) -> None:
    raw = json.dumps(header).encode()
    path.write_bytes(len(raw).to_bytes(8, "little") + raw + data)


@pytest.mark.parametrize("case", ["dtype", "short", "gap", "tail", "header"])
def test_reader_rejects_a_malformed_file(case, tmp_path):
    path = tmp_path / "bad.safetensors"
    if case == "dtype":
        save_file({"x": torch.zeros(3, dtype=torch.float64)}, str(path))
        match = "dtype F64"
    elif case == "short":  # 3 f32 elements in 8 bytes
        header_file(path, {"x": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}}, b"\0" * 8)
        match = "spans bytes"
    elif case == "gap":  # the second tensor does not start where the first ends
        header_file(path, {"x": {"dtype": "F32", "shape": [1], "data_offsets": [0, 4]},
                           "y": {"dtype": "F32", "shape": [1], "data_offsets": [8, 12]}},
                    b"\0" * 12)
        match = "spans bytes"
    elif case == "tail":  # bytes past the last tensor
        header_file(path, {"x": {"dtype": "F32", "shape": [1], "data_offsets": [0, 4]}},
                    b"\0" * 8)
        match = "tensors end"
    else:
        path.write_bytes((10_000).to_bytes(8, "little") + b"{}")
        match = "header of 10000 bytes"
    with pytest.raises(ValueError, match=match):
        tc.read_safetensors(str(path))


def params_of(model: tl.LlamaModel) -> dict:
    return {k: v.float() for k, v in model.state_dict().items()}


def jax_params_as_port(params: dict, cfg) -> dict:
    return params_of(tl.params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu"))


def test_jax_checkpoint_loads_in_the_port_and_back(jax_dir, tmp_path):
    cfg, model = tc.load_hf_checkpoint(str(jax_dir), dtype=torch.float32, device="cpu")
    jcfg, jparams = jc.load_hf_checkpoint(str(jax_dir), dtype=jnp.float32)
    assert cfg.qk_norm and not cfg.tie_embeddings
    want = jax_params_as_port(jparams, cfg)
    got = params_of(model)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k

    # the port's writer, read by the JAX loader: the same layout and names
    out = tmp_path / "port"
    index = tc.save_hf_checkpoint(model, cfg, str(out), shard_layers=1)
    assert index == json.loads((jax_dir / tc.INDEX_FILE).read_text())
    assert json.loads((out / "config.json").read_text()) == json.loads(
        (jax_dir / "config.json").read_text())
    _, back = jc.load_hf_checkpoint(str(out), dtype=jnp.float32)
    for k, v in jax_params_as_port(back, cfg).items():
        assert torch.equal(v, got[k]), k


@pytest.mark.parametrize("layout", ["sharded_with_index", "single_file"])
def test_layouts(layout, tmp_path):
    cfg = tl.tiny_llama(n_layers=3, dtype=torch.bfloat16)
    model = tl.init_model(cfg, 0, "cpu")
    d = tmp_path / layout
    index = tc.save_hf_checkpoint(model, cfg, str(d), shard_layers=2)
    assert sorted(set(index["weight_map"].values())) == [
        f"model-0000{i}-of-00003.safetensors" for i in (1, 2, 3)]
    if layout == "single_file":
        tensors = {}
        for path in shard_files(d):
            tensors.update(tc.read_safetensors(str(path)))
            path.unlink()
        (d / tc.INDEX_FILE).unlink()
        tc.write_safetensors(tensors, str(d / "model.safetensors"))
    lcfg, loaded = tc.load_hf_checkpoint(str(d), device="cpu")
    assert lcfg == cfg
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


LLAMA32_3B = {
    "model_type": "llama", "vocab_size": 128256, "hidden_size": 3072,
    "intermediate_size": 8192, "num_hidden_layers": 28, "num_attention_heads": 24,
    "num_key_value_heads": 8, "head_dim": 128, "max_position_embeddings": 131072,
    "rms_norm_eps": 1e-5, "rope_theta": 500000.0, "tie_word_embeddings": True,
    "rope_scaling": {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
}
QWEN3 = {
    "model_type": "qwen3", "vocab_size": 151936, "hidden_size": 1024,
    "intermediate_size": 3072, "num_hidden_layers": 28, "num_attention_heads": 16,
    "num_key_value_heads": 8, "head_dim": 128, "max_position_embeddings": 40960,
    "rms_norm_eps": 1e-6, "rope_theta": 1000000.0, "tie_word_embeddings": True,
}
LINEAR = {
    "model_type": "llama", "vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "rope_scaling": {"type": "linear", "factor": 4.0},
}


@pytest.mark.parametrize("hf", [LLAMA32_3B, QWEN3, LINEAR], ids=["llama3", "qwen3", "linear"])
def test_config_from_hf_matches_jax(hf):
    got = tc.config_from_hf(hf, max_seq_len=4096)
    want = jc.config_from_hf(hf, max_seq_len=4096)
    for field in tl.LlamaConfig.__dataclass_fields__:
        mine, theirs = getattr(got, field), getattr(want, field)
        if field == "dtype":
            assert str(mine).split(".")[-1] == jnp.dtype(theirs).name
        else:
            assert mine == theirs, field
    if hf is LLAMA32_3B:
        assert tc.config_from_hf(hf, max_seq_len=16384) == tl.llama32_3b()


@pytest.mark.parametrize("hf", [
    {**LINEAR, "model_type": "gemma3_text"},
    {"model_type": "gemma3", "text_config": LINEAR},
    {**LINEAR, "model_type": "phi3"},
], ids=["gemma3", "gemma3_multimodal", "phi3"])
def test_other_families_wait_for_their_port(hf):
    """The families that came after Llama and Qwen3: Gemma3 (text, and a
    multimodal config's text_config) and Phi-3/Phi-4 load, each equal to
    the JAX package's config field by field."""
    got, want = tc.config_from_hf(hf), jc.config_from_hf(hf)
    for field in tl.LlamaConfig.__dataclass_fields__:
        if field != "dtype":
            assert getattr(got, field) == getattr(want, field), field
    # the multimodal case's text_config names no model_type: JAX and the
    # port both read it as the wrapper's text decoder, unwrapped
    assert got.dim == LINEAR["hidden_size"]
    if hf.get("model_type") == "gemma3_text":
        assert got.sandwich_norms and got.norm_plus_one and got.qk_norm
        assert got.act == "gelu_tanh"
    if hf.get("model_type") == "phi3":  # Llama math: its layout is in the loader alone
        assert not (got.qk_norm or got.sandwich_norms or got.norm_plus_one or got.sliding_window)
        assert got.rope_linear_factor == 4.0


def test_unknown_rope_scaling_raises():
    with pytest.raises(NotImplementedError, match="longrope"):
        tc.config_from_hf({**LINEAR, "rope_scaling": {"type": "longrope"}})


def test_linear_rope_divides_positions():
    cfg = tc.config_from_hf(LINEAR)
    pos = torch.arange(6)[None]
    cos, sin = tl.rope_cos_sin(cfg, pos)
    jcos, jsin = jl._rope_cos_sin(jc.config_from_hf(LINEAR), jnp.arange(6)[None])
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    # factor 4: position 4k turns as far as position k does unscaled
    plain = tl.rope_cos_sin(tl.LlamaConfig(**{**cfg.__dict__, "rope_linear_factor": 0.0}), pos)
    scaled = tl.rope_cos_sin(cfg, pos * 4)
    for a, b in zip(scaled, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_logits_match_transformers_and_jax(hf_dir):
    transformers = pytest.importorskip("transformers")
    cfg, model = tc.load_hf_checkpoint(str(hf_dir), dtype=torch.float32, device="cpu")
    B, S = 2, 20
    rng = np.random.default_rng(0)
    toks = rng.integers(3, cfg.vocab_size, size=(B, S))
    pads = torch.zeros(B, dtype=torch.int32)
    cache = tl.init_kv_cache(cfg, B, S, device="cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(toks), tl.prefill_positions(pads, S), cache, 0,
                    tl.prefill_attention_mask(pads, S, S)).numpy()

    hf = transformers.LlamaForCausalLM.from_pretrained(str(hf_dir)).eval()
    with torch.no_grad():
        want_hf = hf(torch.from_numpy(toks)).logits.float().numpy()
    np.testing.assert_allclose(got, want_hf, atol=LOGITS_ATOL, rtol=0)

    jcfg, jparams = jc.load_hf_checkpoint(str(hf_dir), dtype=jnp.float32)
    jpads = jnp.zeros((B,), jnp.int32)
    want_jax, _ = jl.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                             jl.prefill_positions(jpads, S), jl.init_kv_cache(jcfg, B, S), 0,
                             jl.prefill_attention_mask(jpads, S, S))
    np.testing.assert_allclose(got, np.asarray(want_jax), atol=LOGITS_ATOL, rtol=0)
    assert np.abs(got).max() > 0.1  # the comparison is not of zeros


def test_missing_pieces_raise_naming_the_file(jax_dir, tmp_path):
    with pytest.raises(FileNotFoundError, match="no config.json in"):
        tc.load_hf_checkpoint(str(tmp_path), device="cpu")
    d = tmp_path / "ckpt"
    shutil.copytree(jax_dir, d)
    shard = sorted(set(json.loads((d / tc.INDEX_FILE).read_text())["weight_map"].values()))[0]
    (d / shard).unlink()
    with pytest.raises(FileNotFoundError, match=shard):
        tc.load_hf_checkpoint(str(d), device="cpu")
    shutil.rmtree(d)
    shutil.copytree(jax_dir, d)
    index = json.loads((d / tc.INDEX_FILE).read_text())
    last = sorted(set(index["weight_map"].values()))[-1]  # the embeddings' shard
    index["weight_map"]["model.layers.0.mlp.up_proj.weight"] = last
    shard = last
    (d / tc.INDEX_FILE).write_text(json.dumps(index))
    with pytest.raises(KeyError, match=f"model.layers.0.mlp.up_proj.weight.*{shard}"):
        tc.load_hf_checkpoint(str(d), device="cpu")
    del index["weight_map"]["model.layers.0.mlp.up_proj.weight"]
    (d / tc.INDEX_FILE).write_text(json.dumps(index))
    with pytest.raises(KeyError, match="is in no shard of"):
        tc.load_hf_checkpoint(str(d), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tc.load_hf_checkpoint(str(jax_dir))


def test_weights_dir_tokenizer_rule(hf_dir, tmp_path):
    runner = PipelineRunner(PipelineConfig(weights_dir=str(hf_dir), logs_dir=str(tmp_path)),
                            device="cpu")
    got = runner._resolve_model("any name")
    assert got["tokenizer"] == f"hf:{hf_dir}" and got["model"].cfg.dtype == torch.bfloat16
    runner.config.tokenizer = "hf:/another/tokenizer"
    runner.config.dtype = "float32"
    got = runner._resolve_model("any name")
    assert got["tokenizer"] == "hf:/another/tokenizer"
    assert got["model"].embed.dtype == torch.float32
    with pytest.raises(ValueError, match="ONE checkpoint"):
        PipelineConfig(weights_dir=str(hf_dir), models=["a", "b"])


def test_weights_dir_pipeline_matches_jax(hf_dir, tmp_path):
    """--weights-dir through both PipelineRunners over two documents, f32,
    the JAX engine dense (it takes no kernel on the CPU): byte-identical
    summaries, equal ROUGE, embedding metrics within EMBED_ATOL. The port
    reads the checkpoint's byte-level BPE tokenizer.json with its own
    reader (text/bpe.py), the JAX package through transformers."""
    jm, pm = carried_embedders()
    knobs = dict(approach="mapreduce", models=["tiny-ckpt"], weights_dir=str(hf_dir),
                 dtype="float32", chunk_size=300, chunk_overlap=30, token_max=400,
                 max_new_tokens=16, batch_size=4, max_samples=2,
                 docs_dir=str(FIXTURE / "doc"), summary_dir=str(FIXTURE / "summary"))

    def paths(name):
        root = tmp_path / name
        return dict(generated_summaries_dir=str(root / "gen"),
                    results_dir=str(root / "results"), logs_dir=str(root / "logs"))

    want = JaxPipelineRunner(JaxPipelineConfig(**knobs, **paths("jax")),
                             embedding_model=jm).run()
    runner = PipelineRunner(PipelineConfig(**knobs, **paths("port")), embedding_model=pm,
                            device="cpu")
    engines = []
    factory = runner.backend_factory
    runner.backend_factory = lambda m: engines.append(factory(m)) or engines[-1]
    got = runner.run()
    assert runner.failures == []
    assert isinstance(engines[0].tok, BPETokenizer)
    gen = {p.name: p.read_bytes() for p in (tmp_path / "port" / "gen_mapreduce_tiny-ckpt").glob("*")}
    jgen = {p.name: p.read_bytes() for p in (tmp_path / "jax" / "gen_mapreduce_tiny-ckpt").glob("*")}
    assert len(gen) == 2 and gen == jgen
    assert any(gen.values())
    rec, jrec = got.summarization["tiny-ckpt"], want.summarization["tiny-ckpt"]
    assert rec["total_chunks"] == jrec["total_chunks"] > 2
    ev, jev = got.evaluation["tiny-ckpt"], want.evaluation["tiny-ckpt"]
    assert ev["rouge_scores"] == jev["rouge_scores"]
    assert_embedding_stats_close(ev, jev)


# -- Gemma3 --------------------------------------------------------------------

# tests/test_model_gemma.py's tiny HF Gemma3: layers 0, 1, 3 sliding
# (window 8), 2 global, a local RoPE base of its own
GEMMA_HF = dict(
    vocab_size=384, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16, max_position_embeddings=256,
    rope_theta=10000.0, rope_local_base_freq=5000.0, rms_norm_eps=1e-6,
    tie_word_embeddings=True, query_pre_attn_scalar=32, sliding_window=8,
    layer_types=["sliding_attention", "sliding_attention", "full_attention",
                 "sliding_attention"],
)
# f32 on both sides, transformers' eager attention against the port's:
# the JAX package's own tolerance for this model (tests/test_model_gemma.py)
GEMMA_ATOL, GEMMA_RTOL = 3e-4, 3e-3


@pytest.fixture(scope="module")
def gemma_dirs(tmp_path_factory):
    """(text dir, multimodal dir) of one random tiny HF Gemma3, f32: the
    text one as transformers writes it, the multimodal one with its config
    under text_config and its tensors under language_model."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.Gemma3ForCausalLM(transformers.Gemma3TextConfig(**GEMMA_HF)).eval()
    with torch.no_grad():  # norms away from zero, so 1 + w scales
        for name, w in hf.named_parameters():
            if name.endswith("norm.weight"):
                w.copy_(torch.randn_like(w) * 0.2)
    text = tmp_path_factory.mktemp("gemma_text")
    hf.save_pretrained(str(text), safe_serialization=True)
    mm = tmp_path_factory.mktemp("gemma_mm")
    inner = json.loads((text / "config.json").read_text())
    (mm / "config.json").write_text(json.dumps(
        {"architectures": ["Gemma3ForConditionalGeneration"], "model_type": "gemma3",
         "text_config": inner}))
    tensors = {}
    for f in shard_files(text):
        tensors.update(load_file(str(f)))
    save_file({f"language_model.{k}": v.contiguous() for k, v in tensors.items()},
              str(mm / "model.safetensors"))
    return text, mm, hf


@pytest.mark.parametrize("layout", ["text", "multimodal"])
def test_gemma3_checkpoint_loads_as_jax(gemma_dirs, layout):
    """The port's loader against the JAX package's: equal config, every
    parameter equal (sandwich, plus-one and Q/K norms among them)."""
    d = gemma_dirs[0] if layout == "text" else gemma_dirs[1]
    cfg, model = tc.load_hf_checkpoint(str(d), dtype=torch.float32, device="cpu")
    jcfg, jparams = jc.load_hf_checkpoint(str(d), dtype=jnp.float32)
    assert cfg.layer_is_global == jcfg.layer_is_global == (False, False, True, False)
    assert (cfg.sliding_window, cfg.rope_local_theta, cfg.query_scale) == (8, 5000.0, 32.0)
    for field in tl.LlamaConfig.__dataclass_fields__:
        if field != "dtype":
            assert getattr(cfg, field) == getattr(jcfg, field), field
    got = model.tree()
    assert sorted(got["layers"]) == sorted(jparams["layers"])
    for name, want in jparams["layers"].items():
        np.testing.assert_array_equal(got["layers"][name].numpy(), np.asarray(want), name)
    np.testing.assert_array_equal(got["embed"].numpy(), np.asarray(jparams["embed"]))
    np.testing.assert_array_equal(got["final_norm"].numpy(), np.asarray(jparams["final_norm"]))


def test_gemma3_logits_match_transformers(gemma_dirs):
    """Prefill logits of 24 tokens (past the window of 8) and three decode
    steps against transformers' Gemma3ForCausalLM on the same checkpoint."""
    text, _, hf = gemma_dirs
    cfg, model = tc.load_hf_checkpoint(str(text), dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(2)
    S, T = 24, 3
    seq = rng.integers(0, cfg.vocab_size, (2, S + T))
    with torch.no_grad():
        want = hf(torch.from_numpy(seq)).logits.float().numpy()
    pads = torch.zeros(2, dtype=torch.int32)
    C = S + T
    cache = tl.init_kv_cache(cfg, 2, C, device="cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(seq[:, :S]), tl.prefill_positions(pads, S), cache, 0,
                    tl.prefill_attention_mask(pads, S, C)).numpy()
        np.testing.assert_allclose(got, want[:, :S], atol=GEMMA_ATOL, rtol=GEMMA_RTOL)
        for t in range(T):
            step = model(torch.from_numpy(seq[:, S + t:S + t + 1]),
                         torch.full((2, 1), S + t), cache, S + t,
                         tl.decode_attention_mask(pads, S + t, C)).numpy()
            np.testing.assert_allclose(step[:, 0], want[:, S + t], atol=GEMMA_ATOL,
                                       rtol=GEMMA_RTOL)
    assert np.abs(got).max() > 0.1


def test_gemma3_save_load_round_trip(gemma_dirs, tmp_path):
    """save_hf_checkpoint writes Gemma3ForCausalLM / gemma3_text; the port
    and the JAX package load it back equal to the (bf16-rounded) source,
    with equal logits."""
    cfg, model = tc.load_hf_checkpoint(str(gemma_dirs[0]), dtype=torch.float32, device="cpu")
    out = tmp_path / "export"
    tc.save_hf_checkpoint(model, cfg, str(out), shard_layers=2)
    written = json.loads((out / "config.json").read_text())
    assert written["architectures"] == ["Gemma3ForCausalLM"]
    assert written["model_type"] == "gemma3_text"
    cfg2, model2 = tc.load_hf_checkpoint(str(out), dtype=torch.float32, device="cpu")
    assert cfg2 == cfg
    jcfg2, jparams2 = jc.load_hf_checkpoint(str(out), dtype=jnp.float32)
    src = model.tree()
    for name, t in model2.tree()["layers"].items():
        assert torch.equal(t, src["layers"][name].to(torch.bfloat16).float()), name
        np.testing.assert_array_equal(t.numpy(), np.asarray(jparams2["layers"][name]), name)
    S = 16
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, S)))
    pads = torch.zeros(1, dtype=torch.int32)
    rounded = tl.LlamaModel(cfg, {
        "embed": src["embed"].to(torch.bfloat16).float(),
        "final_norm": src["final_norm"].to(torch.bfloat16).float(),
        "layers": {k: t.to(torch.bfloat16).float() for k, t in src["layers"].items()}})
    logits = [m(toks, tl.prefill_positions(pads, S), tl.init_kv_cache(cfg, 1, S, device="cpu"),
                0, tl.prefill_attention_mask(pads, S, S)) for m in (model2, rounded)]
    assert torch.equal(logits[0], logits[1]) and logits[0].abs().max() > 0.1
