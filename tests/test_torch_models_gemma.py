"""Gemma3 in the port (the Gemma3 deltas of vnsum_tpu_torch.models.llama,
the registry, the engine's per-layer windows and kernel gates) against the
JAX package.

A tiny f32 Gemma3 of three layers, two sliding (window 8) and one global,
with a local RoPE base beside linearly scaled global positions, at head_dim
16 and at Gemma3-4B's head_dim 256. Its weights are carried from a JAX tree
(``carried_weights``; the plus-one norms drawn away from zero, so 1 + w
scales). Prompts run past the window, so the sliding layers mask. The JAX
kernels run in interpret mode, the port's wrappers on their plain versions.
Everything is f32: logits agree to summation order (LOGITS_TOL), greedy
ids and summaries byte for byte. Cache lengths stay a multiple of 128 or
within one 128-slot block (ROADMAP §C: the JAX decode kernel's interpret
mode pads a ragged block with NaN).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnsum_tpu.backend.engine import TpuBackend
from vnsum_tpu.core.config import GenerationConfig as JaxGenerationConfig
from vnsum_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from vnsum_tpu.models import llama as jl
from vnsum_tpu.ops.decode_attention import flash_decode_attention as jax_decode
from vnsum_tpu.ops.flash_attention import flash_prefill_attention as jax_flash
from vnsum_tpu_torch.backend import engine as te
from vnsum_tpu_torch.backend.engine import TorchBackend
from vnsum_tpu_torch.core.config import GenerationConfig
from vnsum_tpu_torch.models import MODEL_REGISTRY
from vnsum_tpu_torch.models import llama as tl
from vnsum_tpu_torch.ops.decode_attention import flash_decode_attention
from vnsum_tpu_torch.ops.flash_attention import flash_prefill_attention

from test_torch_engine import record_ids
from test_torch_models_llama import carried_weights
from test_torch_ops_flash import one_torch_thread  # noqa: F401

GEMMA_KW = dict(
    n_layers=3, qk_norm=True, act="gelu_tanh", sandwich_norms=True, norm_plus_one=True,
    embed_scale=True, query_scale=32.0, sliding_window=8,
    layer_is_global=(False, True, False), rope_local_theta=5000.0, rope_linear_factor=2.0,
)
HEAD_DIMS = {"hd16": {}, "hd256": dict(head_dim=256, n_heads=4, n_kv_heads=2)}
LOGITS_TOL = 1e-4  # rtol and atol, f32 logits of scale ~80
# an int8 cache: a K/V value within summation-order error of a half-way
# point may round to the other int8 step on one side (ROADMAP §C,
# rounding-boundary flips), which moves later logits; held, as the int8
# score_choices paths are, within this share of the largest |logit|
INT8_LOGITS_SHARE = 1e-3


def assert_caches_agree(jc: dict, tc: dict) -> None:
    """f32 caches to summation order; an int8 cache's values within one
    step (and 99.9% equal) and its scales within INT8_LOGITS_SHARE: a flip
    in a first chunk's cache moves the second chunk's K and V."""
    if "ks" not in tc:
        for n in ("k", "v"):
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), rtol=1e-5, atol=1e-5)
        return
    for n in ("ks", "vs"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), rtol=INT8_LOGITS_SHARE,
                                   atol=1e-9)
    for n in ("k", "v"):
        diff = np.abs(tc[n].numpy().astype(np.int32) - np.asarray(jc[n]).astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.999


def assert_logits_close(got, want, quantized: bool) -> None:
    want = np.asarray(want)
    if quantized:
        np.testing.assert_allclose(got, want, rtol=0, atol=INT8_LOGITS_SHARE * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=LOGITS_TOL, atol=LOGITS_TOL)
B, S, NEW = 3, 24, 8
C = S + NEW
# Vietnamese prompts of up to 54 bytes: past the window, within the S = 64 bucket
PROMPTS = [
    "Văn bản dài hơn cửa sổ trượt tám token.",
    "hai ngắn",
    "Tóm tắt: Hà Nội là thủ đô của Việt Nam.",
]


def gemma(hd: str, **kw):
    """(jax cfg, jax params, port model) of the tiny Gemma3 at ``hd``."""
    return carried_weights(**GEMMA_KW, **HEAD_DIMS[hd], **kw)


def jax_windows(jcfg):
    flags = jl._layer_global_flags(jcfg)
    return lambda li: jnp.where(flags[li], 0, jcfg.sliding_window).astype(jnp.int32)


def stacked(kind, side, cfg, pads, q_offset=0, fill=None):
    """The attention each side's forward takes: None (dense), or its
    kernels at each layer's window (JAX: a traced per-layer scalar)."""
    if kind == "dense":
        return None
    G = cfg.q_per_kv
    if side == "jax":
        win = jax_windows(cfg)
        if fill is None:
            return lambda q, c, li: jax_flash(q, c, li, pads, G, win(li), q_offset,
                                              interpret=True)
        return lambda q, c, li: jax_decode(q, c, li, pads, fill, G, win(li), interpret=True)
    windows = tl.layer_windows(cfg)
    if fill is None:
        return lambda q, c, li: flash_prefill_attention(q, c, li, pads, G, windows[li], q_offset)
    return lambda q, c, li: flash_decode_attention(q, c, li, pads, fill, G, windows[li])


@pytest.mark.parametrize("prefill", ["whole", "chunked"])
@pytest.mark.parametrize("kind", ["dense", "kernel-f32", "kernel-int8"])
@pytest.mark.parametrize("hd", list(HEAD_DIMS))
def test_forward_matches_jax(hd, kind, prefill):
    """Prefill (whole, or two chunks of 12 at q_offset 0 and 12) then one
    decode step, logits within LOGITS_TOL (an int8 cache: INT8_LOGITS_SHARE)
    and caches equal (int8: within one step), on rows with no pad, a left
    pad of 5 and an all-pad filler."""
    jcfg, params, model = gemma(hd)
    cfg = model.cfg
    quantized = kind == "kernel-int8"
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pads = np.array([0, 5, S], np.int32)
    jp, tp = jnp.asarray(pads), torch.from_numpy(pads)
    jcache = jl.init_kv_cache(jcfg, B, C, quantized=quantized)
    tcache = tl.init_kv_cache(cfg, B, C, quantized=quantized, device="cpu")
    jmask, tmask = jl.prefill_attention_mask(jp, S, C), tl.prefill_attention_mask(tp, S, C)
    jpos, tpos = jl.prefill_positions(jp, S), tl.prefill_positions(tp, S)
    step = S if prefill == "whole" else S // 2
    for lo in range(0, S, step):
        hi = lo + step
        jlogits, jcache = jl.forward(
            params, jcfg, jnp.asarray(tokens[:, lo:hi]), jpos[:, lo:hi], jcache, lo,
            jmask[:, lo:hi], last_only=hi == S, stacked_attention_fn=stacked(kind, "jax", jcfg, jp, lo),
        )
        tlogits = model(
            torch.from_numpy(tokens[:, lo:hi]), tpos[:, lo:hi], tcache, lo,
            None if kind != "dense" else tmask[:, lo:hi], last_only=hi == S,
            stacked_attention_fn=stacked(kind, "port", cfg, tp, lo),
        )
        assert_logits_close(tlogits.numpy(), jlogits, quantized)
    assert_caches_agree(jcache, tcache)

    nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = (S - pads)[:, None].astype(np.int32)
    jlogits, jcache = jl.forward(
        params, jcfg, jnp.asarray(nxt), jnp.asarray(pos), jcache, S,
        jl.decode_attention_mask(jp, S, C), stacked_attention_fn=stacked(kind, "jax", jcfg, jp, fill=S),
    )
    tlogits = model(
        torch.from_numpy(nxt), torch.from_numpy(pos), tcache, S,
        None if kind != "dense" else tl.decode_attention_mask(tp, S, C),
        stacked_attention_fn=stacked(kind, "port", cfg, tp, fill=S),
    )
    assert_logits_close(tlogits.numpy(), jlogits, quantized)
    assert_caches_agree(jcache, tcache)


def test_verify_forward_window_matches_jax():
    """A forward at per-row write slots (the spec verify step's and the slot
    segment's), dense: the per-row window mask of each sliding layer."""
    jcfg, params, model = gemma("hd16")
    cfg = model.cfg
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pads = np.array([0, 5, 2], np.int32)
    jp, tp = jnp.asarray(pads), torch.from_numpy(pads)
    jcache = jl.init_kv_cache(jcfg, B, C)
    tcache = tl.init_kv_cache(cfg, B, C, device="cpu")
    _, jcache = jl.forward(params, jcfg, jnp.asarray(tokens), jl.prefill_positions(jp, S), jcache,
                           0, jl.prefill_attention_mask(jp, S, C))
    model(torch.from_numpy(tokens), tl.prefill_positions(tp, S), tcache, 0,
          tl.prefill_attention_mask(tp, S, C))
    fills = np.array([S, S - 3, S - 7], np.int32)  # ragged rows after draft acceptance
    toks = rng.integers(0, cfg.vocab_size, (B, 4)).astype(np.int32)
    jf, tf = jnp.asarray(fills), torch.from_numpy(fills)
    jlogits, _ = jl.forward(params, jcfg, jnp.asarray(toks), jl.verify_positions(jp, jf, 4),
                            jcache, jf, jl.verify_attention_mask(jp, jf, 4, C))
    tlogits = model(torch.from_numpy(toks), tl.verify_positions(tp, tf, 4), tcache, tf,
                    tl.verify_attention_mask(tp, tf, 4, C))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)


# arm -> (head_dim, JAX flash (its kernels in interpret mode, int8 cache;
# else dense, f32 cache), the port's int8 cache)
ENGINE_ARMS = {"hd16": ("hd16", False, False), "hd256": ("hd256", False, False),
               "hd16-int8": ("hd16", True, True)}


@pytest.mark.parametrize("arm", list(ENGINE_ARMS))
def test_greedy_ids_match_jax_engine(arm):
    """The port's engine through its kernel wrappers (their plain versions)
    against the JAX engine: dense with an f32 cache, or through its kernels
    with an int8 cache as the port's; S = 64, 64 new tokens, C = 128."""
    hd, jax_flash_on, int8 = ENGINE_ARMS[arm]
    jcfg, params, model = gemma(hd, max_seq_len=256)
    kw = dict(batch_size=4, max_new_tokens=64)
    jb = TpuBackend(model_config=jcfg, params=params, flash=jax_flash_on,
                    interpret=jax_flash_on, **kw)
    tb = TorchBackend(model=model, flash=True, quantize_kv=int8, device="cpu", **kw)
    assert tb.use_kernels and jb.quantize_kv == tb.quantize_kv == int8
    assert tb.windows == [8, 0, 8]
    j_ids, t_ids = record_ids(jb), record_ids(tb)
    assert tb.generate(PROMPTS) == jb.generate(PROMPTS)
    assert t_ids == j_ids and any(any(t != tb.tok.pad_id for t in r) for r in t_ids)
    assert tb.stats.by_bucket == jb.stats.by_bucket == {(4, 64): 1}


def test_spec_path_and_slot_loop_run_on_the_cpu():
    """On the CPU the spec path (K3's plain version at each layer's window)
    matches the JAX spec path and plain decode, and the slot loop matches
    one-shot generation, for Gemma3 as for every config."""
    jcfg, params, model = gemma("hd16", max_seq_len=128)
    refs = ["văn bản một dài hơn cửa sổ trượt", None, "thủ đô của Việt Nam"]
    jb = TpuBackend(model_config=jcfg, params=params, flash=True, interpret=True,
                    batch_size=4, max_new_tokens=58)
    tb = TorchBackend(model=model, flash=True, batch_size=4, max_new_tokens=58, device="cpu")
    plain = tb.generate(PROMPTS)
    got = tb.generate(PROMPTS, config=GenerationConfig(spec_k=5), references=refs)
    want = jb.generate(PROMPTS, config=JaxGenerationConfig(spec_k=5), references=refs)
    assert got == want == plain
    assert tb.stats.spec_verify_steps > 0

    sb = TorchBackend(model=model, flash=True, batch_size=4, max_new_tokens=24, device="cpu")
    solo = [sb.generate([p])[0] for p in PROMPTS]
    loop = sb.start_slot_loop(4)
    adm, rej = loop.admit([(i, p, None) for i, p in enumerate(PROMPTS)])
    assert rej == [] and len(adm) == len(PROMPTS)
    outs = {}
    for _ in range(32):
        for c in loop.step().completions:
            outs[c.key] = c.text
        if loop.active == 0:
            break
    loop.close()
    assert [outs[i] for i in range(len(PROMPTS))] == solo


@pytest.mark.parametrize("head_dim,flash,on_card,want", [
    (128, True, True, (True, False)),
    (256, True, True, (True, False)),   # K1, K2 and K3 on the card (Gemma3)
    (64, True, True, (False, False)),   # Llama-3.2-1B: dense, as in JAX
    (256, True, False, (True, False)),  # the CPU: plain versions, any head_dim
    (256, False, True, (False, False)),
    (384, True, True, (False, False)),  # no kernel takes it: dense, no K3 either
])
def test_kernel_gates(head_dim, flash, on_card, want):
    """Each path asks for the kernel it launches: (use K1 and K2, the spec
    path and slot loop must raise)."""
    assert te.kernel_gates(head_dim, flash, on_card) == want


def test_spec_and_slot_paths_raise_naming_b4():
    """Where K1 and K2 run and K3 does not take the head_dim
    (``verify_missing``, set here on a CPU engine as the card's gate would
    set it), the spec path and the slot loop raise NotImplementedError
    naming ROADMAP B4 before any work, and never carry on through dense
    attention; plain decode still runs. No head_dim is such on the card
    since K3 takes 256 (test_kernel_gates); the gate stays for the next
    head_dim K1 and K2 take first."""
    _, _, model = gemma("hd256", max_seq_len=128)
    tb = TorchBackend(model=model, flash=True, batch_size=4, max_new_tokens=8, device="cpu")
    tb.verify_missing = True
    with pytest.raises(NotImplementedError, match="B4"):
        tb.generate(PROMPTS, config=GenerationConfig(spec_k=3), references=PROMPTS)
    with pytest.raises(NotImplementedError, match="B4"):
        tb.start_slot_loop(4)
    assert tb.stats.batches == 0
    assert len(tb.generate(PROMPTS)) == len(PROMPTS)


def test_params_from_numpy_carries_a_gemma_tree():
    """A JAX Gemma3 tree (sandwich and Q/K norms, tied head) becomes the
    port's model leaf for leaf; the port's own init draws plus-one norms at
    zero, as JAX's does."""
    jcfg = jl.tiny_llama(**GEMMA_KW, **HEAD_DIMS["hd256"])
    tree = jax.tree.map(np.asarray, jl.init_params(jax.random.key(5), jcfg))
    model = tl.params_from_numpy(tree, tl.tiny_llama(**GEMMA_KW, **HEAD_DIMS["hd256"]),
                                 device="cpu")
    got = model.tree()
    assert sorted(got["layers"]) == sorted(tree["layers"])
    assert {"post_attn_norm", "post_ffw_norm", "q_norm", "k_norm"} <= set(got["layers"])
    for name, want in tree["layers"].items():
        np.testing.assert_array_equal(got["layers"][name].numpy(), want, err_msg=name)
    np.testing.assert_array_equal(got["embed"].numpy(), tree["embed"])
    np.testing.assert_array_equal(got["final_norm"].numpy(), tree["final_norm"])
    own = tl.init_model(model.cfg, seed=0, device="cpu")
    for name in ("attn_norm", "mlp_norm", "post_attn_norm", "post_ffw_norm", "q_norm"):
        assert not own.layers[name].any(), name
        assert not tree["layers"][name].any(), name


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_registry_configs_match_jax(name):
    """Each registry name's config equals the JAX package's field by field
    (dtype by name), and so do its RoPE frequencies, global and local."""
    got, want = MODEL_REGISTRY[name](), JAX_REGISTRY[name]()
    for field in tl.LlamaConfig.__dataclass_fields__:
        mine, theirs = getattr(got, field), getattr(want, field)
        if field == "dtype":
            assert str(mine).split(".")[-1] == jnp.dtype(theirs).name
        else:
            assert mine == theirs, field
    np.testing.assert_allclose(tl.rope_inv_freq(got).numpy(),
                               np.asarray(jl._rope_inv_freq(want)), rtol=1e-6)
    if got.sliding_window:
        import dataclasses

        local = dataclasses.replace(want, rope_theta=want.rope_local_theta,
                                    use_llama3_rope_scaling=False, rope_linear_factor=0.0)
        np.testing.assert_allclose(tl.rope_inv_freq(tl.local_rope_config(got)).numpy(),
                                   np.asarray(jl._rope_inv_freq(local)), rtol=1e-6)


def test_gemma3_4b_is_gemma3_4b():
    cfg = MODEL_REGISTRY["gemma3-4b"]()
    assert (cfg.n_layers, cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.intermediate, cfg.vocab_size) == (34, 2560, 8, 4, 256, 10240, 262208)
    windows = tl.layer_windows(cfg)
    assert windows.count(0) == 5 and windows[5] == 0 and windows[0] == 1024
    assert MODEL_REGISTRY["llama3.2:1b"]().head_dim == 64


@pytest.mark.parametrize("kw", [
    dict(sliding_window=8, layer_is_global=(True, False)),
    dict(sliding_window=8),
    dict(),
    dict(sliding_window=8, layer_is_global=(True,)),
], ids=["mixed", "all_sliding", "no_window", "wrong_length"])
def test_layer_windows_match_jax(kw):
    jcfg, tcfg = jl.tiny_llama(**kw), tl.tiny_llama(**kw)
    if kw.get("layer_is_global") == (True,):
        with pytest.raises(ValueError, match="layer_is_global"):
            tl.layer_windows(tcfg)
        with pytest.raises(ValueError, match="layer_is_global"):
            jl._layer_global_flags(jcfg)
        return
    flags = np.asarray(jl._layer_global_flags(jcfg))
    want = [0 if g else jcfg.sliding_window for g in flags]
    assert tl.layer_windows(tcfg) == want


def test_mapreduce_through_both_runners(tmp_path, monkeypatch):
    """Map-reduce over data/vi_eval through both PipelineRunners on the
    tiny Gemma3 (JAX dense, the port through its kernel wrappers): equal
    summaries, prompts and ROUGE (the harness of the strategy tests)."""
    from torch_strategy_parity import assert_same, run_pair

    jax_side, port_side = run_pair(tmp_path, monkeypatch, "mapreduce", {"chunk_size": 400},
                                   n_docs=2, cfg_kw=GEMMA_KW)
    assert_same(jax_side, port_side, 2)
    assert port_side.engine.cfg.sliding_window == 8
