"""Flash decode attention (kernel K2) of the PyTorch port against the JAX
package's Pallas kernel (``return_partials=False``).

On the CPU the port's wrapper takes its plain version; the JAX kernel runs
in interpret mode. Both get the same inputs, made with numpy from a seed.
The cache length stays within the JAX kernel's one 128-slot block: its
interpret mode pads a ragged last block with NaN, which reaches the PV
product as 0 * NaN.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnsum_tpu.ops.decode_attention import flash_decode_attention as jax_decode
from vnsum_tpu_torch.ops import decode_attention as da

from test_torch_ops_flash import G, H, HD, make_inputs, one_torch_thread  # noqa: F401


# (C, fill, window, layer): fill short of the cache end, layers other than 0
CASES = [(53, 40, 0, 1), (53, 52, 0, 2), (100, 70, 9, 2), (100, 30, 1, 0)]


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("C,fill,window,layer", CASES)
def test_decode_plain_matches_jax_kernel(quantized, C, fill, window, layer):
    """All-f32 arithmetic on both sides; only summation order differs -> 1e-5."""
    B = 3
    q, jc, tc = make_inputs(B, 1, C, seed=C + fill, quantized=quantized)
    # row 2's pad lies past the fill: it sees no key and comes out as 0
    pads = np.array([0, 6, fill + 1], np.int32)
    want = jax_decode(
        jnp.asarray(q), jc, layer, jnp.asarray(pads), fill, G, window,
        interpret=True,
    )
    before = da.launches
    got = da.flash_decode_attention(
        torch.from_numpy(q), tc, layer, torch.from_numpy(pads), fill, G, window
    )
    assert da.launches == before  # CPU tensors never reach the kernel
    assert got.shape == (B, 1, H, HD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert not got[2].any()


def test_decode_plain_matches_jax_kernel_bf16():
    """bf16 query and cache: f32 math, only the final bf16 cast and the
    summation order differ -> 1e-2."""
    B, C, fill = 2, 100, 77
    q, jc, tc = make_inputs(B, 1, C, seed=5, quantized=False)
    jc = {n: a.astype(jnp.bfloat16) for n, a in jc.items()}
    tc = {n: t.to(torch.bfloat16) for n, t in tc.items()}
    pads = np.array([3, 0], np.int32)
    want = jax_decode(
        jnp.asarray(q, jnp.bfloat16), jc, 1, jnp.asarray(pads), fill, G, 0,
        interpret=True,
    )
    got = da.flash_decode_attention(
        torch.from_numpy(q).to(torch.bfloat16), tc, 1, torch.from_numpy(pads), fill, G, 0
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        rtol=1e-2, atol=1e-2,
    )


def test_decode_plain_ignores_slots_past_fill():
    B, C, fill = 1, 64, 20
    q, _, tc = make_inputs(B, 1, C, seed=8, quantized=True)
    pads = torch.zeros((B,), dtype=torch.int32)
    clean = da.flash_decode_attention(torch.from_numpy(q), tc, 0, pads, fill, G)
    poisoned = {n: t.clone() for n, t in tc.items()}
    poisoned["k"][:, :, :, fill + 1:] = 127
    poisoned["ks"][:, :, :, fill + 1:] = 1e3
    poisoned["vs"][:, :, :, fill + 1:] = 1e9
    got = da.flash_decode_attention(torch.from_numpy(q), poisoned, 0, pads, fill, G)
    torch.testing.assert_close(got, clean, rtol=0, atol=0)


def test_decode_is_single_token():
    q, _, tc = make_inputs(1, 2, 16, seed=1, quantized=False)
    with pytest.raises(ValueError, match="single-token"):
        da.flash_decode_attention(
            torch.from_numpy(q), tc, 0, torch.zeros((1,), dtype=torch.int32), 3, G
        )


# head_dim 256 (Gemma3: G = 2); (fill, window): a window floor inside the
# cache, none, and a fill short of a 128-slot block of the JAX kernel
HD256_CASES = [(255, 0), (255, 100), (130, 40), (60, 0)]


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("fill,window", HD256_CASES)
def test_decode_plain_matches_jax_kernel_hd256(quantized, fill, window):
    """The plain version at head_dim 256 (the card's yardstick for K2 there)
    against the JAX kernel; f32 on both sides -> 1e-5. C = 256: a multiple
    of the JAX kernel's 128-slot block."""
    from vnsum_tpu.models.llama import _quantize_kv

    B, kv, g, hd, C = 3, 2, 2, 256, 256
    rng = np.random.default_rng(fill + window)
    q = rng.standard_normal((B, 1, kv * g, hd)).astype(np.float32)
    k = rng.standard_normal((2, B, kv, C, hd)).astype(np.float32)
    v = rng.standard_normal((2, B, kv, C, hd)).astype(np.float32)
    if quantized:
        k8, ks = _quantize_kv(jnp.asarray(k))
        v8, vs = _quantize_kv(jnp.asarray(v))
        jc = {"k": k8, "v": v8, "ks": ks, "vs": vs}
    else:
        jc = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tc = {n: torch.from_numpy(np.array(a)) for n, a in jc.items()}
    pads = np.array([0, 6, fill + 1], np.int32)
    want = jax_decode(jnp.asarray(q), jc, 1, jnp.asarray(pads), fill, g, window, interpret=True)
    got = da.flash_decode_attention(torch.from_numpy(q), tc, 1, torch.from_numpy(pads), fill,
                                    g, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert not got[2].any()
