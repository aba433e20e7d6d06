"""Phi-3/Phi-4 in the port (``phi4_14b``, the registry names, and the fused
checkpoint layout of vnsum_tpu_torch.models.convert) against the JAX
package and ``transformers``.

Phi checkpoints fuse q/k/v into one ``qkv_proj`` and gate/up into one
``gate_up_proj``; the math is Llama's. Tiny ``Phi3ForCausalLM`` checkpoints
written by ``transformers`` (f32, seed 0; GQA groups 2 and 4, the group
Phi-4 runs at) are loaded by both packages' loaders: every parameter equal
exactly, and the port's prefill logits within LOGITS_ATOL of JAX
``forward`` and of ``transformers`` (f32 differing in summation order,
~2e-7 on logits of scale ~0.7). The engine runs a tiny Phi-shaped f32
config at G = 4 and head_dim 128 (the kernels' head_dim) against the JAX
engine, its kernels in interpret mode: greedy ids byte for byte, plain,
with int8 weights and on the spec path (Sq * G = 36 verify rows). Cache
lengths stay a multiple of 128 (ROADMAP §C: the JAX decode kernel's
interpret mode pads a ragged block with NaN).
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from vnsum_tpu.backend.engine import TpuBackend
from vnsum_tpu.core.config import GenerationConfig as JaxGenerationConfig
from vnsum_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from vnsum_tpu.models import convert as jc
from vnsum_tpu.models import llama as jl
from vnsum_tpu_torch.backend.engine import TorchBackend
from vnsum_tpu_torch.core.config import GenerationConfig
from vnsum_tpu_torch.models import MODEL_REGISTRY
from vnsum_tpu_torch.models import convert as tc
from vnsum_tpu_torch.models import llama as tl

from test_torch_engine import record_ids
from test_torch_models_llama import carried_weights
from test_torch_ops_flash import one_torch_thread  # noqa: F401

LOGITS_ATOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent

# Phi-4's config.json (microsoft/phi-4), the keys the loaders read
PHI4 = {
    "architectures": ["Phi3ForCausalLM"], "model_type": "phi3", "vocab_size": 100352,
    "hidden_size": 5120, "intermediate_size": 17920, "num_hidden_layers": 40,
    "num_attention_heads": 40, "num_key_value_heads": 10, "max_position_embeddings": 16384,
    "original_max_position_embeddings": 16384, "rms_norm_eps": 1e-05, "rope_scaling": None,
    "rope_theta": 250000, "sliding_window": None, "tie_word_embeddings": False,
}
# Phi-3-mini-4k's: no GQA, a sliding_window key that only Gemma3 reads
PHI3_MINI = {
    "model_type": "phi3", "vocab_size": 32064, "hidden_size": 3072, "intermediate_size": 8192,
    "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 32,
    "max_position_embeddings": 4096, "rms_norm_eps": 1e-05, "rope_scaling": None,
    "rope_theta": 10000.0, "sliding_window": 2047, "tie_word_embeddings": False,
}
# tiny checkpoints written by transformers: GQA group 2 and Phi-4's 4
TINY = dict(
    vocab_size=384, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
    rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
    # Phi3Config's pad/bos/eos default to 32k-range ids: keep them in the vocab
    pad_token_id=0, bos_token_id=1, eos_token_id=2,
)
GROUPS = {"g2": dict(num_attention_heads=4, num_key_value_heads=2),
          "g4": dict(num_attention_heads=8, num_key_value_heads=2)}
HF_CONFIGS = {
    "phi4": PHI4,
    "phi3_mini": PHI3_MINI,
    "full_rotary": {**PHI4, "partial_rotary_factor": 1.0},
    "tiny_g2": {**TINY, "model_type": "phi3"},
    "tiny_g4": {**TINY, **GROUPS["g4"], "model_type": "phi3"},
}
# the port's leaves, each compared with the JAX loader's
LEAVES = ("embed", "final_norm", "lm_head") + tuple(
    f"layers.{k}" for k in ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up",
                            "w_down"))


def assert_config_equal(got, want) -> None:
    for field in tl.LlamaConfig.__dataclass_fields__:
        mine, theirs = getattr(got, field), getattr(want, field)
        if field == "dtype":
            assert str(mine).split(".")[-1] == jnp.dtype(theirs).name
        else:
            assert mine == theirs, field


@pytest.mark.parametrize("name", list(HF_CONFIGS))
def test_config_from_hf_matches_jax(name):
    """A phi3 config.json gives the JAX package's config field by field:
    Llama math, no QK norm, no window, the checkpoint's own tie."""
    hf = HF_CONFIGS[name]
    got, want = tc.config_from_hf(hf), jc.config_from_hf(hf)
    assert_config_equal(got, want)
    assert not got.qk_norm and not got.sliding_window and not got.tie_embeddings
    if name in ("phi4", "full_rotary"):
        assert got == tl.phi4_14b()


@pytest.mark.parametrize("factor", [0.5, 0.75])
def test_partial_rotary_raises_in_both(factor):
    hf = {**PHI4, "partial_rotary_factor": factor}
    with pytest.raises(NotImplementedError, match="partial rotary"):
        tc.config_from_hf(hf)
    with pytest.raises(NotImplementedError, match="partial rotary"):
        jc.config_from_hf(hf)


def test_longrope_raises_in_both():
    """Phi-3.5's longrope keeps raising through the RoPE branch, as JAX's."""
    hf = {**PHI3_MINI, "rope_scaling": {"type": "longrope", "long_factor": [1.0] * 48,
                                        "short_factor": [1.0] * 48}}
    with pytest.raises(NotImplementedError, match="longrope"):
        tc.config_from_hf(hf)
    with pytest.raises(NotImplementedError, match="longrope"):
        jc.config_from_hf(hf)


@pytest.mark.parametrize("name", ["phi4:14b", "phi4-14b"])
def test_registry_phi4_matches_jax(name):
    """Both registry names give Phi-4-14B at its published widths, equal to
    the JAX package's phi4_14b() field by field."""
    got = MODEL_REGISTRY[name]()
    assert_config_equal(got, JAX_REGISTRY[name]())
    assert_config_equal(got, jl.phi4_14b())
    assert (got.n_layers, got.dim, got.n_heads, got.n_kv_heads, got.head_dim, got.intermediate,
            got.vocab_size, got.q_per_kv) == (40, 5120, 40, 10, 128, 17920, 100352, 4)
    assert (got.rope_theta, got.norm_eps, got.tie_embeddings, got.qk_norm,
            got.sliding_window) == (250000.0, 1e-5, False, False, 0)


@pytest.fixture(scope="module", params=list(GROUPS))
def hf_checkpoint(request, tmp_path_factory):
    """A tiny Phi3ForCausalLM (transformers' init, seed 0) saved in f32:
    (group, transformers model, checkpoint dir)."""
    torch.manual_seed(0)
    cfg = transformers.Phi3Config(**{**TINY, **GROUPS[request.param]})
    model = transformers.Phi3ForCausalLM(cfg).eval()
    out = tmp_path_factory.mktemp(f"phi_{request.param}") / "ckpt"
    model.save_pretrained(out, safe_serialization=True)
    return request.param, model, str(out)


@pytest.fixture(scope="module")
def loaded(hf_checkpoint):
    """Both packages' loads of the checkpoint, f32."""
    _, _, ckpt = hf_checkpoint
    cfg, model = tc.load_hf_checkpoint(ckpt, dtype=torch.float32, device="cpu")
    jcfg, jparams = jc.load_hf_checkpoint(ckpt, dtype=jnp.float32)
    return cfg, model, jcfg, jparams


def leaf(tree, path):
    for part in path.split("."):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("path", LEAVES)
def test_fused_checkpoint_params_equal_jax(loaded, path):
    """Each parameter the port loads from the fused layout equals the JAX
    loader's exactly (q/k/v and gate/up sliced in the same row order)."""
    cfg, model, jcfg, jparams = loaded
    assert_config_equal(cfg, jcfg)
    got, want = leaf(model.tree(), path), np.asarray(leaf(jparams, path))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_checkpoint_logits_match_jax_and_transformers(hf_checkpoint, loaded):
    """Prefill logits of the port's load against JAX forward on JAX's load
    and against transformers on the checkpoint, rows with and without a
    left pad."""
    _, hf, _ = hf_checkpoint
    cfg, model, jcfg, jparams = loaded
    B, S = 2, 20
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    pads = torch.zeros(B, dtype=torch.int32)
    with torch.inference_mode():
        got = model(torch.from_numpy(toks), tl.prefill_positions(pads, S),
                    tl.init_kv_cache(cfg, B, S, device="cpu"), 0,
                    tl.prefill_attention_mask(pads, S, S)).numpy()
        want_hf = hf(torch.from_numpy(toks)).logits.float().numpy()
    jpads = jnp.zeros((B,), jnp.int32)
    want_jax, _ = jl.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                             jl.prefill_positions(jpads, S), jl.init_kv_cache(jcfg, B, S), 0,
                             jl.prefill_attention_mask(jpads, S, S))
    np.testing.assert_allclose(got, want_hf, atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(want_jax), atol=LOGITS_ATOL, rtol=0)
    assert np.abs(got).max() > 0.1  # the comparison is not of zeros


def test_fused_checkpoint_loads_in_bf16_equal_to_jax(hf_checkpoint):
    """dtype=bf16 rounds each sliced tensor as JAX's loader does."""
    _, _, ckpt = hf_checkpoint
    cfg, model = tc.load_hf_checkpoint(ckpt, dtype=torch.bfloat16, device="cpu")
    jcfg, jparams = jc.load_hf_checkpoint(ckpt, dtype=jnp.bfloat16)
    assert cfg.dtype == torch.bfloat16
    for path in LEAVES:
        got = leaf(model.tree(), path)
        assert got.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(leaf(jparams, path)).astype(np.float32), path)


def test_fused_getter_serves_views_in_qkv_order(hf_checkpoint):
    """The getter slices views of the memory-mapped fused tensors, no
    copies: q, k, v and gate, up are consecutive row ranges of one
    storage, in that order."""
    _, hf, ckpt = hf_checkpoint
    cfg = tc.config_from_hf(json.loads((Path(ckpt) / "config.json").read_text()))
    raw = tc.safetensors_getter(ckpt)
    get = tc.phi_fused_getter(raw, cfg)
    H, KV, hd, I = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.intermediate
    attn = hf.model.layers[1].self_attn.qkv_proj.weight.detach()
    mlp = hf.model.layers[1].mlp.gate_up_proj.weight.detach()
    for fused_name, fused, parts in (
            ("self_attn.qkv_proj", attn, (("self_attn.q_proj", 0, H * hd),
                                          ("self_attn.k_proj", H * hd, (H + KV) * hd),
                                          ("self_attn.v_proj", (H + KV) * hd, (H + 2 * KV) * hd))),
            ("mlp.gate_up_proj", mlp, (("mlp.gate_proj", 0, I), ("mlp.up_proj", I, 2 * I)))):
        whole = raw(f"model.layers.1.{fused_name}.weight")
        for name, lo, hi in parts:
            w = get(f"model.layers.1.{name}.weight")
            assert w.untyped_storage().data_ptr() == whole.untyped_storage().data_ptr(), name
            assert w.data_ptr() == whole[lo].data_ptr() and w.shape[0] == hi - lo, name
            assert torch.equal(w, fused[lo:hi]), name
    # the names outside the fused pairs pass through
    assert get.has("model.layers.0.self_attn.o_proj.weight")
    assert torch.equal(get("model.layers.0.mlp.down_proj.weight"),
                       hf.model.layers[0].mlp.down_proj.weight.detach())


def test_fused_rows_that_do_not_fit_the_config_raise(hf_checkpoint):
    _, _, ckpt = hf_checkpoint
    group = hf_checkpoint[0]
    kv = GROUPS[group]["num_key_value_heads"]
    with pytest.raises(ValueError, match="qkv_proj.*rows, the config needs"):
        tc.load_hf_checkpoint(ckpt, dtype=torch.float32, device="cpu", n_kv_heads=kv * 2)
    with pytest.raises(ValueError, match="gate_up_proj.*rows, the config needs"):
        tc.load_hf_checkpoint(ckpt, dtype=torch.float32, device="cpu", intermediate=64)


def test_engine_on_the_fused_checkpoint_matches_jax(hf_checkpoint, loaded):
    """Greedy generation on the loaded checkpoint (dense, f32 cache; head_dim
    16 is below the kernels' 128 on both sides): the port's text and ids
    equal the JAX engine's."""
    _, model, jcfg, jparams = loaded
    prompts = ["văn bản một", "hai ba bốn năm", "Tóm tắt: Hà Nội"]
    kw = dict(batch_size=4, max_new_tokens=64)
    jb = TpuBackend(model_config=jcfg, params=jparams, flash=False, **kw)
    tb = TorchBackend(model=model, flash=False, device="cpu", **kw)
    j_ids, t_ids = record_ids(jb), record_ids(tb)
    assert tb.generate(prompts) == jb.generate(prompts)
    assert t_ids == j_ids and any(any(t != tb.tok.pad_id for t in r) for r in t_ids)


# a tiny Phi-shaped config at Phi-4's group of 4 and the kernels' head_dim:
# dim = H * hd, untied head, Phi-4's RoPE base and norm eps
PHI_KW = dict(dim=512, n_heads=4, n_kv_heads=1, head_dim=128, intermediate=512,
              tie_embeddings=False, rope_theta=250_000.0, norm_eps=1e-5, max_seq_len=256)
PROMPTS = [
    "Xin chào thế giới, đây là một bài kiểm tra.",
    "Tóm tắt nội dung văn bản sau bằng tiếng Việt",
    "abc " * 12,
]
# arm -> (quantize (int8 weights on both sides), spec_k, new tokens); each
# cache is C = 64 + new (+ spec_k + 1) = 128
ENGINE_ARMS = {"plain": (False, 0, 64), "int8_weights": (True, 0, 64),
               "spec": (False, 8, 55), "spec_int8_weights": (True, 8, 55)}


@pytest.fixture(scope="module")
def phi_shaped():
    return carried_weights(**PHI_KW)


@pytest.mark.parametrize("arm", list(ENGINE_ARMS))
def test_greedy_ids_match_jax_engine_at_group_4(phi_shaped, arm):
    """The port's engine through its kernel wrappers (their plain versions,
    an int8 KV cache) against the JAX engine through its kernels in
    interpret mode: greedy text and ids byte for byte, with f32 weights or
    int8 ones (quantize=True on both), one-shot or on the spec path with
    references (spec_k 8: Sq * G = 36 rows a verify step, whose text must
    also equal the one-shot path's)."""
    jcfg, params, model = phi_shaped
    quantize, spec_k, new = ENGINE_ARMS[arm]
    assert model.cfg.q_per_kv == 4
    kw = dict(batch_size=4, max_new_tokens=new, quantize=quantize)
    jb = TpuBackend(model_config=jcfg, params=params, flash=True, interpret=True, **kw)
    tb = TorchBackend(model=model, flash=True, device="cpu", **kw)
    assert tb.use_kernels and tb.quantize_kv and jb.quantize_kv
    assert tb.model.quantized == quantize
    refs = ["Xin chào thế giới, đây là", None, "abc abc abc abc"]
    jgen = dict(config=JaxGenerationConfig(spec_k=spec_k), references=refs) if spec_k else {}
    tgen = dict(config=GenerationConfig(spec_k=spec_k), references=refs) if spec_k else {}
    j_ids, t_ids = record_ids(jb), record_ids(tb)
    want = jb.generate(PROMPTS, **jgen)
    got = tb.generate(PROMPTS, **tgen)
    assert got == want
    assert t_ids == j_ids and any(any(t != tb.tok.pad_id for t in r) for r in t_ids)
    assert tb.stats.by_bucket == jb.stats.by_bucket == {(4, 64): 1}
    if spec_k:
        assert tb.stats.spec_verify_steps > 0
        assert got == tb.generate(PROMPTS)


def chip_smoke():
    """The card script as a module (its helpers take torch as an argument
    and import nothing at the top but the standard library)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_phi_writer_is_a_phi3_checkpoint(tmp_path):
    """chip_smoke.py's fused-layout writer (the card's Phi-4 checkpoint
    phase) writes what transformers' Phi3ForCausalLM and the JAX loader
    read: transformers' logits within LOGITS_ATOL of the source model's,
    and the JAX loader's parameters equal to the source's. So the card's
    bit-for-bit round trip holds the port's loader to a real Phi-3 layout,
    not to the script's writer alone. The writer stores bf16, so the
    source's weights are bf16 values (held in f32)."""
    _, _, carried = carried_weights(**{**PHI_KW, "dim": 64, "head_dim": 16,
                                       "intermediate": 96})

    def rounded(tree):
        return {k: rounded(v) if isinstance(v, dict) else v.to(torch.bfloat16).float()
                for k, v in tree.items()}

    model = tl.LlamaModel(carried.cfg, rounded(carried.tree()))
    cfg = model.cfg
    chip_smoke().write_phi_checkpoint(torch, model, cfg, str(tmp_path))
    hf_cfg = json.loads((tmp_path / "config.json").read_text())
    assert hf_cfg["model_type"] == "phi3" and hf_cfg["architectures"] == ["Phi3ForCausalLM"]
    hf = transformers.Phi3ForCausalLM.from_pretrained(str(tmp_path)).float().eval()
    B, S = 2, 20
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    pads = torch.zeros(B, dtype=torch.int32)
    with torch.inference_mode():
        want = hf(torch.from_numpy(toks)).logits.float().numpy()
        got = model(torch.from_numpy(toks), tl.prefill_positions(pads, S),
                    tl.init_kv_cache(cfg, B, S, device="cpu"), 0,
                    tl.prefill_attention_mask(pads, S, S)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL * np.abs(want).max(), rtol=0)
    assert np.abs(got).max() > 0.1
    jcfg, jparams = jc.load_hf_checkpoint(str(tmp_path), dtype=jnp.float32)
    assert_config_equal(tc.config_from_hf(hf_cfg, dtype=torch.float32), jcfg)
    for path in LEAVES:
        np.testing.assert_array_equal(np.asarray(leaf(jparams, path)),
                                      leaf(model.tree(), path).numpy(), path)


def runners(tmp_path, **kw):
    """The port's and the JAX package's PipelineRunner on the same config."""
    from vnsum_tpu.core.config import PipelineConfig as JaxPipelineConfig
    from vnsum_tpu.pipeline.runner import PipelineRunner as JaxPipelineRunner
    from vnsum_tpu_torch.core.config import PipelineConfig
    from vnsum_tpu_torch.pipeline.runner import PipelineRunner

    fixture = ROOT / "data" / "vi_eval"
    kw = dict(docs_dir=str(fixture / "doc"), summary_dir=str(fixture / "summary"),
              generated_summaries_dir=str(tmp_path / "gen"), results_dir=str(tmp_path / "res"),
              logs_dir=str(tmp_path / "logs"), **kw)
    return (PipelineRunner(PipelineConfig(**kw), device="cpu"),
            JaxPipelineRunner(JaxPipelineConfig(**kw)))


@pytest.mark.parametrize("name", ["phi4:14b", "phi4-14b"])
def test_runner_resolves_phi4_through_the_registry(tmp_path, name):
    """--models phi4:14b (or phi4-14b) reaches Phi-4-14B through the
    registry alone: the runner's backend arguments are its config, equal to
    what the JAX runner resolves, with the run's tokenizer."""
    port, jax = runners(tmp_path, models=[name])
    got = port._resolve_model(name)
    jcfg, jparams, jtok = jax._resolve_model(name)
    assert_config_equal(got["model_config"], jcfg)
    assert got["model_config"] == tl.phi4_14b() and jparams is None
    assert got["tokenizer"] == jtok


def test_judge_backend_reaches_phi4_through_the_registry(tmp_path, monkeypatch):
    """--judge-backend torch:phi4-14b builds the judge from the registry's
    Phi-4-14B config (the backend's constructor recorded, not run: 29 GB of
    weights)."""
    from vnsum_tpu_torch.pipeline import runner as runner_mod

    calls = []
    monkeypatch.setattr(runner_mod, "get_backend", lambda *a, **kw: calls.append((a, kw)))
    port, _ = runners(tmp_path)
    port._judge_backend("torch:phi4-14b")
    (args, kw), = calls
    assert args == ("torch",) and kw["max_new_tokens"] == 64
    assert_config_equal(kw["model_config"], JAX_REGISTRY["phi4-14b"]())


def test_weights_dir_loads_the_fused_layout_through_the_runner(tmp_path, hf_checkpoint):
    """--weights-dir <a Phi-3 checkpoint> through the runner: the port's
    model (its loader on the fused layout) equals the JAX runner's params
    exactly, and both take the checkpoint's own tokenizer."""
    _, _, ckpt = hf_checkpoint
    port, jax = runners(tmp_path, models=["x"], weights_dir=ckpt, dtype="float32")
    got = port._resolve_model("x")
    jcfg, jparams, jtok = jax._resolve_model("x")
    assert got["tokenizer"] == jtok == f"hf:{ckpt}"
    assert_config_equal(got["model"].cfg, jcfg)
    for path in LEAVES:
        np.testing.assert_array_equal(leaf(got["model"].tree(), path).numpy(),
                                      np.asarray(leaf(jparams, path)), path)
