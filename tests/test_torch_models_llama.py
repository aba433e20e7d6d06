"""The port's decoder (vnsum_tpu_torch.models.llama) and sampling against
the JAX package's, on the same weights.

A JAX parameter tree, converted to numpy, becomes the port's model through
``params_from_numpy``. Prefill and one decode step then run on both sides,
through dense attention and through the kernels (the JAX kernels in
interpret mode, the port's wrappers on their plain versions), with an f32
cache and an int8 cache. Everything is f32, so logits agree to summation
order: 1e-4.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnsum_tpu.models import llama as jl
from vnsum_tpu.models import sampling as js
from vnsum_tpu.models.quant import quantize_params
from vnsum_tpu.ops.decode_attention import flash_decode_attention as jax_decode
from vnsum_tpu.ops.flash_attention import flash_prefill_attention as jax_flash
from vnsum_tpu_torch.models import llama as tl
from vnsum_tpu_torch.models import sampling as ts
from vnsum_tpu_torch.ops.decode_attention import flash_decode_attention
from vnsum_tpu_torch.ops.flash_attention import flash_prefill_attention

from test_torch_ops_flash import one_torch_thread  # noqa: F401

B, S, NEW = 3, 24, 8
C = S + NEW


def carried_weights(seed: int = 0, **cfg_kw):
    """(jax cfg, jax params, port model) sharing one random tiny_llama
    weight set. Matrices are scaled up from the 0.02 init so activations
    and logits are O(1) (a tolerance means something) and greedy rows of a
    random model do not all collapse onto one token."""
    jcfg = jl.tiny_llama(**cfg_kw)
    tree = jax.tree.map(np.asarray, jl.init_params(jax.random.key(seed), jcfg))
    tree["embed"] = tree["embed"] * 50.0
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        tree["layers"][name] = tree["layers"][name] * 8.0
    if jcfg.norm_plus_one:
        # plus-one norms start at zero: give 1 + w something to scale
        rng = np.random.default_rng(seed)
        for leaves in (tree, tree["layers"]):
            for name in [n for n in leaves if n.endswith("norm")]:
                w = rng.standard_normal(leaves[name].shape) * 0.2
                leaves[name] = w.astype(leaves[name].dtype)
    model = tl.params_from_numpy(tree, tl.tiny_llama(**cfg_kw), device="cpu")
    return jcfg, jax.tree.map(jnp.asarray, tree), model


def jax_stacked(kind, pads, G, fill=None):
    if kind == "dense":
        return None
    if fill is None:
        return lambda q, c, li: jax_flash(q, c, li, pads, G, 0, 0, interpret=True)
    return lambda q, c, li: jax_decode(q, c, li, pads, fill, G, 0, interpret=True)


def port_stacked(kind, pads, G, fill=None):
    if kind == "dense":
        return None
    if fill is None:
        return lambda q, c, li: flash_prefill_attention(q, c, li, pads, G, 0, 0)
    return lambda q, c, li: flash_decode_attention(q, c, li, pads, fill, G, 0)


def assert_caches_agree(jc: dict, tc: dict) -> None:
    if "ks" not in tc:
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), rtol=1e-5, atol=1e-5)
        return
    for n in ("ks", "vs"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), rtol=1e-5, atol=1e-9)
    for n in ("k", "v"):
        # f32 projections summed in another order may land a value on the
        # other side of a rounding boundary: one int8 step at most
        diff = np.abs(tc[n].numpy().astype(np.int32) - np.asarray(jc[n]).astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.999


@pytest.mark.parametrize("rope", [False, True], ids=["rope", "llama3_rope"])
@pytest.mark.parametrize("kind", ["dense", "kernel-f32", "kernel-int8"])
def test_forward_prefill_and_decode_match_jax(rope, kind):
    jcfg, params, model = carried_weights(use_llama3_rope_scaling=rope)
    cfg = model.cfg
    G = cfg.q_per_kv
    quantized = kind == "kernel-int8"
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    # row 1 left-padded, row 2 all-pad filler
    pads = np.array([0, 5, S], np.int32)

    # prefill
    jpads = jnp.asarray(pads)
    jcache = jl.init_kv_cache(jcfg, B, C, quantized=quantized)
    jlogits, jcache = jl.forward(
        params, jcfg, jnp.asarray(tokens), jl.prefill_positions(jpads, S), jcache,
        0, jl.prefill_attention_mask(jpads, S, C), last_only=True,
        stacked_attention_fn=jax_stacked(kind, jpads, G),
    )
    tpads = torch.from_numpy(pads)
    tcache = tl.init_kv_cache(cfg, B, C, quantized=quantized, device="cpu")
    mask = None if kind != "dense" else tl.prefill_attention_mask(tpads, S, C)
    tlogits = model(
        torch.from_numpy(tokens), tl.prefill_positions(tpads, S), tcache, 0, mask,
        last_only=True, stacked_attention_fn=port_stacked(kind, tpads, G),
    )
    assert tlogits.dtype == torch.float32 and tlogits.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    assert_caches_agree(jcache, tcache)

    # one decode step at fill = S: pos = S - pad
    nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = (S - pads)[:, None].astype(np.int32)
    jlogits, jcache = jl.forward(
        params, jcfg, jnp.asarray(nxt), jnp.asarray(pos), jcache, S,
        jl.decode_attention_mask(jpads, S, C),
        stacked_attention_fn=jax_stacked(kind, jpads, G, fill=S),
    )
    mask = None if kind != "dense" else tl.decode_attention_mask(tpads, S, C)
    tlogits = model(
        torch.from_numpy(nxt), torch.from_numpy(pos), tcache, S, mask,
        stacked_attention_fn=port_stacked(kind, tpads, G, fill=S),
    )
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    assert_caches_agree(jcache, tcache)


def test_quantize_kv_is_bit_exact():
    """Same scale, same round-half-to-even, same clip as the JAX package."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 3, 5, 16)) * 3).astype(np.float32)
    # a row whose scale is exactly 1, with values on rounding half-way points
    x[0, 0, 0, :6] = [127.0, 63.5, -0.5, 2.5, -3.5, 0.5]
    x[0, 0, 0, 6:] = 0.0
    x[1, 2, 4] = 0.0  # an all-zero row: the scale floor
    jq, js_ = jl._quantize_kv(jnp.asarray(x))
    tq, ts_ = tl.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts_.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))


@pytest.mark.parametrize("factory", ["llama32_3b", "qwen3_0p6b", "tiny_llama"])
def test_configs_and_rope_frequencies_match(factory):
    jcfg = getattr(jl, factory)()
    tcfg = getattr(tl, factory)()
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "head_dim",
              "intermediate", "rope_theta", "use_llama3_rope_scaling", "norm_eps",
              "max_seq_len", "tie_embeddings", "qk_norm"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    np.testing.assert_allclose(
        tl.rope_inv_freq(tcfg).numpy(), np.asarray(jl._rope_inv_freq(jcfg)),
        rtol=1e-6, atol=0,
    )


def test_params_from_numpy_refuses_int8_weights():
    """What params_from_numpy still refuses of an int8 tree: a {'q', 's'}
    leaf whose scales do not match its output channels, and an int8 leaf
    on a norm weight (tests/test_torch_models_quant.py holds the trees it
    accepts)."""
    jcfg = jl.tiny_llama()
    qtree = jax.tree.map(
        np.asarray, quantize_params(jl.init_params(jax.random.key(0), jcfg))
    )
    wrong_scales = {**qtree, "layers": {**qtree["layers"], "wq": {
        "q": qtree["layers"]["wq"]["q"], "s": qtree["layers"]["wq"]["s"][:, :, :-1]}}}
    with pytest.raises(ValueError, match="output channels"):
        tl.params_from_numpy(wrong_scales, tl.tiny_llama(), device="cpu")
    norm = qtree["layers"]["attn_norm"]
    int8_norm = {**qtree, "layers": {**qtree["layers"], "attn_norm": {
        "q": np.ones(norm.shape, np.int8), "s": np.ones(norm.shape[:1], np.float32)}}}
    with pytest.raises(ValueError, match="only matmul weights"):
        tl.params_from_numpy(int8_norm, tl.tiny_llama(), device="cpu")


def test_init_model_is_seeded():
    a = tl.init_model(tl.tiny_llama(), seed=3, device="cpu")
    b = tl.init_model(tl.tiny_llama(), seed=3, device="cpu")
    c = tl.init_model(tl.tiny_llama(), seed=4, device="cpu")
    assert torch.equal(a.layers["wq"], b.layers["wq"])
    assert not torch.equal(a.layers["wq"], c.layers["wq"])
    assert torch.equal(a.final_norm, torch.ones_like(a.final_norm))


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.8), (7, 0.6)])
def test_filter_logits_matches_jax(top_k, top_p):
    logits = np.random.default_rng(top_k).standard_normal((4, 50)).astype(np.float32)
    want = js.filter_logits(jnp.asarray(logits), 0.7, top_k, top_p)
    got = ts.filter_logits(torch.from_numpy(logits), 0.7, top_k, top_p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_sampling_greedy_and_row_streams():
    logits = torch.from_numpy(
        np.random.default_rng(2).standard_normal((3, 40)).astype(np.float32)
    )
    greedy = ts.sample_logits_rows(logits, [], 0.0)
    want = js.sample_logits(jnp.asarray(logits.numpy()), jax.random.key(0), 0.0)
    assert greedy.tolist() == np.asarray(want).tolist()
    # a row's draw depends only on its own (seed, uid, step) seed, never on
    # its batch position; top-k keeps draws inside the k best
    seeds = [ts.row_seed(7, u, 3) for u in range(3)]
    a = ts.sample_logits_rows(logits, seeds, 1.0, top_k=4)
    b = ts.sample_logits_rows(logits.flip(0), seeds[::-1], 1.0, top_k=4)
    assert torch.equal(a, b.flip(0))
    top4 = logits.topk(4, dim=-1).indices
    assert all(int(t) in top4[i].tolist() for i, t in enumerate(a))
