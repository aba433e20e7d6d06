"""The port's int8 weights (vnsum_tpu_torch.models.quant, the int8 arms of
models/llama.py, ops/int8_matmul.py) against the JAX package's
(vnsum_tpu/models/quant.py, ``_proj``, ``_lm_head_logits``), on the same
weights.

Quantization is held bit for bit: the same f32 arithmetic with round half
to even gives the same int8 values and scales. The GEMV's plain version
and the forwards run in f32 on both sides, so they agree to summation
order (stated per test); W8A8's s32 product is exact, so its projection is
bit-identical.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnsum_tpu.core.config import PipelineConfig as JaxPipelineConfig
from vnsum_tpu.models import llama as jl
from vnsum_tpu.models import quant as jq
from vnsum_tpu_torch.backend.engine import TorchBackend
from vnsum_tpu_torch.core.config import PipelineConfig
from vnsum_tpu_torch.models import llama as tl
from vnsum_tpu_torch.models import quant as tq
from vnsum_tpu_torch.ops import int8_matmul as im

from test_torch_models_llama import (  # noqa: F401
    B,
    C,
    S,
    carried_weights,
    jax_stacked,
    one_torch_thread,
    port_stacked,
)

# config name -> tiny_llama keyword overrides (qwen3: per-head Q/K norms)
CONFIGS = {
    "tied": {},
    "untied": {"tie_embeddings": False},
    "qwen3": {"qk_norm": True, "rope_theta": 1_000_000.0},
}


def torch_tree(tree) -> dict:
    """A numpy tree (leaves or {'q', 's'} dicts) as torch tensors."""
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def numpy_tree(tree) -> dict:
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module", params=list(CONFIGS))
def carried(request):
    """(name, jax cfg, jax params, port model) for one config."""
    jcfg, params, model = carried_weights(**CONFIGS[request.param])
    return request.param, jcfg, params, model


def test_quantize_params_matches_jax_bit_for_bit(carried):
    _, _, params, _ = carried
    want = numpy_tree(jq.quantize_params(params))
    got = tq.quantize_params(torch_tree(numpy_tree(params)))
    assert tq.is_quantized(got) and jq.is_quantized(want)
    got_leaves, want_leaves = dict(leaves(got)), dict(leaves(want))
    assert sorted(got_leaves) == sorted(want_leaves)
    for name, w in want_leaves.items():
        g = got_leaves[name].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    # the round trip too
    deq_want = dict(leaves(numpy_tree(jq.dequantize_params(jq.quantize_params(params)))))
    for name, d in leaves(tq.dequantize_params(got)):
        np.testing.assert_array_equal(d.numpy(), deq_want[name], err_msg=name)


def test_quantized_models_hold_the_jax_values_in_the_stored_layout(carried):
    """quantize_model on the port's model and params_from_numpy on JAX's
    quantized tree give the same stored leaves: JAX's values, output
    channel major."""
    _, _, params, model = carried
    qtree = numpy_tree(jq.quantize_params(params))
    from_jax = tl.params_from_numpy(qtree, model.cfg, device="cpu")
    mine = tq.quantize_model(model)
    assert from_jax.quantized and mine.quantized and not model.quantized
    for name, leaf in [("embed", qtree["embed"])] + [
            (k, v) for k, v in qtree["layers"].items() if isinstance(v, dict)] + (
            [("lm_head", qtree["lm_head"])] if "lm_head" in qtree else []):
        want = tq.to_stored(name, torch_tree(leaf))
        for m in (from_jax, mine):
            w = getattr(m, name) if name in ("embed", "lm_head") else m.layers[name]
            assert w.dtype == torch.int8 and torch.equal(w, want["q"]), name
            assert torch.equal(m.scales[name], want["s"]), name
    # row n of a stored layer matrix is output channel n, contraction along it
    wq = qtree["layers"]["wq"]["q"]
    np.testing.assert_array_equal(
        from_jax.layers["wq"][1].numpy(), wq[1].reshape(wq.shape[1], -1).T)
    # norms stay in the model dtype, shared untouched
    assert torch.equal(mine.layers["attn_norm"], model.layers["attn_norm"])


def test_init_params_quantized_layout_matches_jax():
    jcfg, tcfg = jl.tiny_llama(tie_embeddings=False), tl.tiny_llama(tie_embeddings=False)
    want = dict(leaves(numpy_tree(jq.init_params_quantized(jax.random.key(0), jcfg))))
    gen = torch.Generator().manual_seed(0)
    got = dict(leaves(tq.init_params_quantized(tcfg, gen, device="cpu")))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name.endswith(".s") or "norm" in name:
            np.testing.assert_allclose(g, w, rtol=1e-7, err_msg=name)
        else:
            assert g.min() >= -127 and g.max() <= 127, name
    # the port's model takes the tree through the stored layout
    tree = got_tree = tq.init_params_quantized(tcfg, torch.Generator().manual_seed(1), "cpu")
    stored = {k: tq.to_stored(k, v) for k, v in tree.items() if k in ("embed", "lm_head")}
    stored["layers"] = {k: tq.to_stored(k, v) if isinstance(v, dict) else v
                        for k, v in got_tree["layers"].items()}
    stored["final_norm"] = tree["final_norm"]
    assert tl.LlamaModel(tcfg, stored).quantized


# -- the GEMV's plain version -------------------------------------------------------


def gemv_inputs(M: int, N: int = 96, K: int = 64, seed: int = 0):
    """x [M, K] f32, int8 q [N, K] (the stored layout) with per-channel
    magnitudes that differ, and s [N] from quantizing them."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32) * rng.uniform(0.2, 3.0, N).astype(
        np.float32)
    leaf = jq._quantize(jnp.asarray(w), (0,))
    q, s = np.asarray(leaf["q"]), np.asarray(leaf["s"])
    x = rng.standard_normal((M, K)).astype(np.float32)
    return x, q, s


@pytest.mark.parametrize("mode", ["projection", "head"])
@pytest.mark.parametrize("M", [1, 8, 72])
def test_gemv_plain_version_is_the_jax_formula(M, mode):
    """int8_gemv_ref (what the wrapper runs for CPU tensors) against JAX's
    ``_proj`` (projection) and ``_lm_head_logits`` (head) with the same
    int8 weight: f32, so within summation order, rtol 1e-5 of the largest
    output; in bf16 against a float64 reckoning of the same formula, within
    two bf16 roundings (2^-6 of each output) plus the f32 sum's order."""
    x, q, s = gemv_inputs(M, seed=M)
    xt, qt, st = (torch.from_numpy(np.array(a)) for a in (x, q.T, s))
    head = mode == "head"
    got = im.int8_gemv(xt, qt, st, head=head).numpy()
    w = {"q": jnp.asarray(q), "s": jnp.asarray(s)}
    if head:
        cfg = jl.tiny_llama(tie_embeddings=False)
        want = jl._lm_head_logits(jnp.asarray(x)[None], {"lm_head": w}, cfg)[0]
    else:
        want = jl._proj("bsd,di->bsi", jnp.asarray(x)[None], w)[0]
    want = np.asarray(want)
    assert got.dtype == np.float32 and got.shape == (M, q.shape[1])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())

    xb = xt.to(torch.bfloat16)
    y64 = xb.double() @ qt.double().t()
    if head:
        want64 = (y64.float() * st).double()
        limit = 1e-6 * (xb.double().abs() @ qt.double().abs().t()) * st.double()
    else:
        want64 = ((y64.float().to(torch.bfloat16).float() * st).to(torch.bfloat16)).double()
        limit = 2.0 ** -6 * want64.abs() + 1e-6 * (
            xb.double().abs() @ qt.double().abs().t()) * st.double()
    got_b = im.int8_gemv(xb, qt, st, head=head)
    assert got_b.dtype == (torch.float32 if head else torch.bfloat16)
    assert bool(((got_b.double() - want64).abs() <= limit).all())


@pytest.mark.parametrize("M", [1, 72, 200])
def test_int8_linear_routes_keep_the_formula(M):
    """Every route of int8_linear (the GEMV at M <= MAX_M, the dequantized
    matmul above) and of int8_head computes the plain version's function
    on f32 inputs (summation order: rtol 1e-6 of the largest output)."""
    x, q, s = gemv_inputs(M, seed=3)
    xt, qt, st = (torch.from_numpy(np.array(a)) for a in (x, q.T, s))
    for head in (False, True):
        want = im.int8_gemv_ref(xt, qt, st, head=head)
        got = im.int8_head(xt, qt, st) if head else im.int8_linear(xt[None], qt, st)[0]
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))


def test_gemv_wrapper_counts_nothing_on_the_cpu_and_refuses_other_devices():
    x, q, s = (torch.from_numpy(np.array(a)) for a in gemv_inputs(4))
    before = im.launches
    im.int8_gemv(x, q.t().contiguous(), s)
    assert im.launches == before
    with pytest.raises(ValueError, match="no int8 GEMV kernel"):
        im.int8_gemv(x.to("meta"), q.t().contiguous().to("meta"), s.to("meta"))


# -- W8A8 -----------------------------------------------------------------------


# projection -> (JAX einsum, x shape, weight name)
W8A8_CASES = {
    "wq": ("bsd,dhk->bshk", (B, S, 64)),
    "wo": ("bshk,hkd->bsd", (B, S, 4, 16)),
    "w_down": ("bsi,id->bsd", (B, S, 128)),
}


@pytest.mark.parametrize("name", list(W8A8_CASES))
def test_w8a8_projection_bit_identical_to_jax(name):
    """The port's act_quant projection on f32 inputs equals JAX's
    ``_proj(..., act_quant=True)`` bit for bit: the same per-token int8
    rounding, an exact s32 product, and the scales applied in JAX's order."""
    sub, xshape = W8A8_CASES[name]
    jcfg = jl.tiny_llama()
    w = jl.init_params(jax.random.key(5), jcfg)["layers"][name][1] * 8.0
    qleaf = jq._quantize(w, jq._CONTRACT_AXES[name])
    x = np.random.default_rng(6).standard_normal(xshape).astype(np.float32)
    want = np.asarray(jl._proj(sub, jnp.asarray(x), qleaf, act_quant=True))
    stored = tq.to_stored(name, {"q": torch.from_numpy(np.array(qleaf["q"]))[None],
                                 "s": torch.from_numpy(np.array(qleaf["s"]))[None]})
    xt = torch.from_numpy(x).reshape(B, S, -1)
    got = im.int8_linear(xt, stored["q"][0], stored["s"][0], act_quant=True)
    np.testing.assert_array_equal(got.reshape(want.shape).numpy(), want)
    # the weight-only route differs from it (the activations were rounded)
    assert not torch.equal(im.int8_linear(xt, stored["q"][0], stored["s"][0]), got)


def quant_model(model, w8a8: bool):
    import dataclasses

    return tq.quantize_model(model, dataclasses.replace(model.cfg, w8a8_prefill=w8a8))


def test_w8a8_single_token_and_per_row_forwards_bit_identical():
    """W8A8 applies to multi-token forwards at one write slot only: a
    decode step (S = 1) and a per-row-slot verify forward give the same
    logits with and without it, bit for bit; a prefill does not."""
    _, _, model = carried_weights()
    plain, w8a8 = quant_model(model, False), quant_model(model, True)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, 384, (B, S)).astype(np.int64))
    pads = torch.tensor([0, 3, 7], dtype=torch.int32)
    pos = tl.prefill_positions(pads, S)
    mask = tl.prefill_attention_mask(pads, S, C)
    filled = tl.init_kv_cache(plain.cfg, B, C, device="cpu")
    plain(toks, pos, filled, 0, mask, last_only=True)
    fills = torch.tensor([S + 1, S + 2, S + 1], dtype=torch.int32)
    out = {}
    for name, m in (("plain", plain), ("w8a8", w8a8)):
        pre = m(toks, pos, tl.init_kv_cache(m.cfg, B, C, device="cpu"), 0, mask,
                last_only=True)
        # both decode from the same filled cache
        cache = {k: v.clone() for k, v in filled.items()}
        dec = m(toks[:, -1:], pos[:, -1:] + 1, cache, S, tl.decode_attention_mask(pads, S, C))
        ver = m(toks[:, :3], tl.verify_positions(pads, fills, 3), cache, fills,
                tl.verify_attention_mask(pads, fills, 3, C))
        out[name] = (pre, dec, ver, cache)
    assert not torch.equal(out["plain"][0], out["w8a8"][0])
    assert torch.equal(out["plain"][1], out["w8a8"][1])
    assert torch.equal(out["plain"][2], out["w8a8"][2])
    assert all(torch.equal(out["plain"][3][k], out["w8a8"][3][k]) for k in filled)


# -- forwards ---------------------------------------------------------------------


@pytest.mark.parametrize("w8a8", [False, True], ids=["int8", "w8a8"])
@pytest.mark.parametrize("kind", ["dense", "kernel"])
def test_quantized_forward_matches_jax(carried, kind, w8a8):
    """Prefill and one decode step with int8 weights on both sides (the
    port's from params_from_numpy of JAX's quantized tree), dense attention
    or the kernels (JAX's in interpret mode, the port's plain versions), an
    f32 model and cache: logits within 1e-4 (summation order). W8A8 rounds
    each token's activations to int8 steps of 1/127 of its absmax, and an
    activation within summation-order error of a half-way point may round
    the other way on the two sides: one step moves an output by ~1e-3 of
    the logits' scale, so W8A8 logits are held to 5e-3 of the largest."""
    import dataclasses

    _, jcfg, params, model = carried
    jcfg = dataclasses.replace(jcfg, w8a8_prefill=w8a8)
    cfg = dataclasses.replace(model.cfg, w8a8_prefill=w8a8)
    qparams = jq.quantize_params(params)
    port = tl.params_from_numpy(numpy_tree(qparams), cfg, device="cpu")
    G = cfg.q_per_kv
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pads = np.array([0, 5, S], np.int32)  # a left pad and an all-pad filler row
    jpads, tpads = jnp.asarray(pads), torch.from_numpy(pads)

    jcache = jl.init_kv_cache(jcfg, B, C)
    jlogits, jcache = jl.forward(
        qparams, jcfg, jnp.asarray(tokens), jl.prefill_positions(jpads, S), jcache,
        0, jl.prefill_attention_mask(jpads, S, C), last_only=True,
        stacked_attention_fn=jax_stacked(kind, jpads, G),
    )
    tcache = tl.init_kv_cache(cfg, B, C, device="cpu")
    mask = None if kind != "dense" else tl.prefill_attention_mask(tpads, S, C)
    tlogits = port(
        torch.from_numpy(tokens), tl.prefill_positions(tpads, S), tcache, 0, mask,
        last_only=True, stacked_attention_fn=port_stacked(kind, tpads, G),
    )
    limit = 5e-3 * float(np.abs(np.asarray(jlogits)).max()) if w8a8 else 1e-4
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=limit)

    nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = (S - pads)[:, None].astype(np.int32)
    jlogits, _ = jl.forward(
        qparams, jcfg, jnp.asarray(nxt), jnp.asarray(pos), jcache, S,
        jl.decode_attention_mask(jpads, S, C),
        stacked_attention_fn=jax_stacked(kind, jpads, G, fill=S),
    )
    mask = None if kind != "dense" else tl.decode_attention_mask(tpads, S, C)
    tlogits = port(
        torch.from_numpy(nxt), torch.from_numpy(pos), tcache, S, mask,
        stacked_attention_fn=port_stacked(kind, tpads, G, fill=S),
    )
    limit = 5e-3 * float(np.abs(np.asarray(jlogits)).max()) if w8a8 else 1e-4
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=limit)


# -- validation -------------------------------------------------------------------


def test_quantize_act_without_quantize_raises_as_in_jax():
    with pytest.raises(ValueError) as got:
        TorchBackend(model_config=tl.tiny_llama(), quantize_act=True, device="cpu")
    with pytest.raises(ValueError) as got_cfg:
        PipelineConfig(quantize_act=True)
    with pytest.raises(ValueError) as want:
        JaxPipelineConfig(quantize_act=True)
    assert str(got.value) == str(got_cfg.value) == str(want.value)
    assert "requires quantize=True" in str(want.value)


def test_backend_quantizes_its_model_once_and_keeps_an_int8_one():
    _, _, model = carried_weights()
    kw = dict(flash=True, max_new_tokens=64, device="cpu")
    tb = TorchBackend(model=model, quantize=True, **kw)
    assert tb.model.quantized and not model.quantized
    assert tb.model.layers["wq"].dtype == torch.int8
    assert tb.model.scales["wq"].dtype == torch.float32
    again = TorchBackend(model=tb.model, quantize=True, **kw)
    assert again.model is tb.model
    w8a8 = TorchBackend(model=tb.model, quantize=True, quantize_act=True, **kw)
    assert w8a8.model.cfg.w8a8_prefill
    # the same int8 tensors under the W8A8 config: nothing copied
    assert w8a8.model.layers["wq"].data_ptr() == tb.model.layers["wq"].data_ptr()
    assert not tb.model.cfg.w8a8_prefill
