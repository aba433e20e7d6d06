"""Flash prefill attention (kernel K1) of the PyTorch port against the JAX
package's Pallas kernel.

On the CPU the port's wrapper takes its plain version; the JAX kernel runs
in interpret mode. Both get the same inputs, made with numpy from a seed.
The CUDA kernel itself is held against the same plain version on the card
by chip_smoke.py.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnsum_tpu.models.llama import _quantize_kv
from vnsum_tpu.ops.flash_attention import flash_prefill_attention as jax_flash
from vnsum_tpu_torch.ops import flash_attention as fa

L, KV, G, HD = 3, 2, 3, 16
H = KV * G


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs test files in parallel worker processes; one intra-op
    thread each keeps torch from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_inputs(B, S, C, seed, quantized):
    """q [B, S, H, hd] and a stacked cache, as (jax cache, torch cache)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, HD)).astype(np.float32)
    k = rng.standard_normal((L, B, KV, C, HD)).astype(np.float32)
    v = rng.standard_normal((L, B, KV, C, HD)).astype(np.float32)
    if quantized:
        k8, ks = _quantize_kv(jnp.asarray(k))
        v8, vs = _quantize_kv(jnp.asarray(v))
        jc = {"k": k8, "v": v8, "ks": ks, "vs": vs}
    else:
        jc = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tc = {n: torch.from_numpy(np.array(a)) for n, a in jc.items()}
    return q, jc, tc


# (S, C, q_offset, window): ragged S and C, chunked prefill offsets, windows
CASES = [(37, 53, 0, 0), (37, 53, 0, 8), (45, 100, 11, 0), (45, 100, 40, 6)]


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("S,C,q_offset,window", CASES)
def test_prefill_plain_matches_jax_kernel(quantized, S, C, q_offset, window):
    """f32 queries: the only difference is summation order -> 1e-5."""
    B = 3
    q, jc, tc = make_inputs(B, S, C, seed=S + C + window, quantized=quantized)
    # row 1 is left-padded; row 2 is all-pad filler: it sees no key at all
    pads = np.array([0, 5, q_offset + S], np.int32)
    layer = 1
    want = jax_flash(
        jnp.asarray(q), jc, layer, jnp.asarray(pads), G, window, q_offset,
        interpret=True,
    )
    before = fa.launches
    got = fa.flash_prefill_attention(
        torch.from_numpy(q), tc, layer, torch.from_numpy(pads), G, window, q_offset
    )
    assert fa.launches == before  # CPU tensors never reach the kernel
    assert got.dtype == torch.float32 and got.shape == (B, S, H, HD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # a query row that sees no key comes out as 0 on both sides
    assert not got[2].any() and not np.asarray(want)[2].any()


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_prefill_plain_matches_jax_kernel_bf16(quantized):
    """bf16 queries (the engine's dtype): p is rounded to bf16 before PV,
    against the running max in the kernel and the row max in the plain
    version, and the output is rounded to bf16 -> 2e-2."""
    B, S, C, q_offset, window = 2, 45, 100, 11, 0
    q, jc, tc = make_inputs(B, S, C, seed=3, quantized=quantized)
    if not quantized:
        jc = {n: a.astype(jnp.bfloat16) for n, a in jc.items()}
        tc = {n: t.to(torch.bfloat16) for n, t in tc.items()}
    pads = np.array([0, 7], np.int32)
    want = jax_flash(
        jnp.asarray(q, jnp.bfloat16), jc, 2, jnp.asarray(pads), G, window,
        q_offset, interpret=True,
    )
    got = fa.flash_prefill_attention(
        torch.from_numpy(q).to(torch.bfloat16), tc, 2, torch.from_numpy(pads), G,
        window, q_offset,
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        rtol=2e-2, atol=2e-2,
    )


def test_prefill_plain_ignores_slots_it_cannot_see():
    """Slots past the last query and below the window floor must not leak
    in, however large they are."""
    B, S, C, q_offset, window = 1, 20, 64, 10, 5
    q, _, tc = make_inputs(B, S, C, seed=9, quantized=False)
    pads = torch.zeros((B,), dtype=torch.int32)
    clean = fa.flash_prefill_attention(torch.from_numpy(q), tc, 0, pads, G, window, q_offset)
    poisoned = {n: t.clone() for n, t in tc.items()}
    poisoned["k"][:, :, :, q_offset + S:] = 30.0
    poisoned["v"][:, :, :, q_offset + S:] = 1e9
    poisoned["v"][:, :, :, :q_offset - window + 1] = 1e9
    got = fa.flash_prefill_attention(torch.from_numpy(q), poisoned, 0, pads, G, window, q_offset)
    torch.testing.assert_close(got, clean, rtol=0, atol=0)


@pytest.mark.parametrize(
    "bad",
    ["q_f32", "q_hd64", "q_strided", "pads_i64", "cache_f32", "scales_f16",
     "cache_batch", "layer"],
)
def test_kernel_input_checks_raise(bad):
    """What the CUDA kernels do not take is refused before any launch."""
    B, S, C = 2, 8, 16
    q = torch.zeros((B, S, H, fa.HEAD_DIM), dtype=torch.bfloat16)
    pads = torch.zeros((B,), dtype=torch.int32)
    shape = (L, B, KV, C, fa.HEAD_DIM)
    cache = {
        "k": torch.zeros(shape, dtype=torch.int8),
        "v": torch.zeros(shape, dtype=torch.int8),
        "ks": torch.zeros(shape[:-1]),
        "vs": torch.zeros(shape[:-1]),
    }
    layer = 0
    if bad == "q_f32":
        q = q.float()
    elif bad == "q_hd64":
        q = q[..., :64].contiguous()
    elif bad == "q_strided":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "pads_i64":
        pads = pads.long()
    elif bad == "cache_f32":
        cache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    elif bad == "scales_f16":
        cache["ks"] = cache["ks"].half()
    elif bad == "cache_batch":
        cache = {n: t[:, :1].contiguous() for n, t in cache.items()}
    elif bad == "layer":
        layer = L
    with pytest.raises(ValueError):
        fa.check_query(q, pads)
        fa.check_cache(q, cache, layer)


def test_kernels_supported_rule():
    """K1, K2 and K3 take head_dim 128 and 256 (Gemma3); 16 and 64 run
    dense attention on the card, as in the JAX package. K2p takes 128 only
    and refuses 256 naming ROADMAP B4; every kernel refuses 384, a head_dim
    the JAX kernels take and no registry model has, naming B4 too."""
    assert fa.supports_flash(128) and fa.supports_flash(256)
    assert not any(fa.supports_flash(hd) for hd in (16, 64, 384))
    assert fa.supports_verify(128) and fa.supports_verify(256)
    assert not any(fa.supports_verify(hd) for hd in (16, 64, 384))
    fa.require_head_dim("K2p", 128)
    fa.require_head_dim("K2p", 64)  # not a kernel head_dim at all: dense
    with pytest.raises(NotImplementedError, match="B4"):
        fa.require_head_dim("K2p", 256)
    fa.require_head_dim("K3", 256, fa.HEAD_DIMS)
    with pytest.raises(NotImplementedError, match="B4"):
        fa.require_head_dim("K3", 384, fa.HEAD_DIMS)


# head_dim 256 (Gemma3: G = 2), cache lengths a multiple of 128
HD256_CASES = [(150, 256, 0, 0), (150, 256, 0, 40), (100, 256, 90, 0), (100, 256, 90, 40)]


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("S,C,q_offset,window", HD256_CASES)
def test_prefill_plain_matches_jax_kernel_hd256(quantized, S, C, q_offset, window):
    """The plain version at head_dim 256 (the card's yardstick for K1 there)
    against the JAX kernel, with a window and chunked-prefill offsets;
    f32 queries: 1e-5, and a row that sees no key is 0 on both sides."""
    B, kv, g, hd = 3, 2, 2, 256
    rng = np.random.default_rng(S + window + q_offset)
    q = rng.standard_normal((B, S, kv * g, hd)).astype(np.float32)
    k = rng.standard_normal((2, B, kv, C, hd)).astype(np.float32)
    v = rng.standard_normal((2, B, kv, C, hd)).astype(np.float32)
    if quantized:
        k8, ks = _quantize_kv(jnp.asarray(k))
        v8, vs = _quantize_kv(jnp.asarray(v))
        jc = {"k": k8, "v": v8, "ks": ks, "vs": vs}
    else:
        jc = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tc = {n: torch.from_numpy(np.array(a)) for n, a in jc.items()}
    pads = np.array([0, 7, q_offset + S], np.int32)
    want = jax_flash(jnp.asarray(q), jc, 1, jnp.asarray(pads), g, window, q_offset,
                     interpret=True)
    got = fa.flash_prefill_attention(torch.from_numpy(q), tc, 1, torch.from_numpy(pads), g,
                                     window, q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert not got[2].any() and not np.asarray(want)[2].any()
