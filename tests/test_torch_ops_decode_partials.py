"""Decode partials (kernel K2p) of the PyTorch port against the JAX
package's Pallas decode kernel with ``return_partials=True``.

On the CPU the port's wrapper takes its plain version; the JAX kernel runs
in interpret mode. Both get the same inputs, made with numpy from a seed.
Cache lengths are multiples of 128: the JAX kernel's interpret mode pads a
ragged last 128-slot block with NaN.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnsum_tpu.ops.decode_attention import flash_decode_attention as jax_decode
from vnsum_tpu_torch.ops import decode_attention as da

from test_torch_ops_flash import G, H, HD, make_inputs, one_torch_thread  # noqa: F401

# (C, fill, window, layer): fill short of the cache end and at it, a
# window, layers other than 0, several 128-slot blocks
CASES = [(128, 100, 0, 1), (256, 255, 0, 2), (256, 200, 9, 0), (384, 383, 0, 2)]


def partials(C, fill, window, layer, quantized):
    """(port's plain partials, JAX's, the inputs) on four rows: pad 0, a
    left pad, a pad past the fill and a pad of C (the last two see no key)."""
    B = 4
    q, jc, tc = make_inputs(B, 1, C, seed=C + fill + window, quantized=quantized)
    pads = np.array([0, 6, fill + 1, C], np.int32)
    want = jax_decode(
        jnp.asarray(q), jc, layer, jnp.asarray(pads), fill, G, window,
        interpret=True, return_partials=True,
    )
    before = da.partials_launches
    got = da.flash_decode_partials(
        torch.from_numpy(q), tc, layer, torch.from_numpy(pads), fill, G, window
    )
    assert da.partials_launches == before  # CPU tensors never reach the kernel
    return got, [np.asarray(w) for w in want], (q, tc, pads)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("C,fill,window,layer", CASES)
def test_partials_plain_matches_jax_kernel(quantized, C, fill, window, layer):
    """All-f32 arithmetic on both sides; only summation order differs -> 1e-5."""
    (o, m, l), (jo, jm, jl), _ = partials(C, fill, window, layer, quantized)
    assert o.shape == (4, H, HD) and m.shape == l.shape == (4, H)
    assert o.dtype == m.dtype == l.dtype == torch.float32
    np.testing.assert_allclose(m.numpy(), jm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), jl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o.numpy(), jo, rtol=1e-5, atol=1e-5)
    # rows 2 and 3 see no key: exactly inert on both sides
    for go, gm, gl in ((o.numpy(), m.numpy(), l.numpy()), (jo, jm, jl)):
        assert (gm[2:] == np.float32(-1e30)).all() and not gl[2:].any() and not go[2:].any()


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_partials_normalise_to_the_decode_output(quantized):
    """o / max(l, 1e-30) is K2's output on the same cache."""
    C, fill, window, layer = 256, 230, 0, 1
    (o, _, l), _, (q, tc, pads) = partials(C, fill, window, layer, quantized)
    want = da.flash_decode_attention(
        torch.from_numpy(q), tc, layer, torch.from_numpy(pads), fill, G, window
    )
    got = o / l.clamp_min(1e-30)[..., None]
    torch.testing.assert_close(got, want[:, 0], rtol=1e-6, atol=1e-6)


def test_partials_ignore_slots_past_fill():
    B, C, fill = 1, 128, 20
    q, _, tc = make_inputs(B, 1, C, seed=8, quantized=True)
    pads = torch.zeros((B,), dtype=torch.int32)
    clean = da.flash_decode_partials(torch.from_numpy(q), tc, 0, pads, fill, G)
    poisoned = {n: t.clone() for n, t in tc.items()}
    poisoned["k"][:, :, :, fill + 1:] = 127
    poisoned["ks"][:, :, :, fill + 1:] = 1e3
    poisoned["vs"][:, :, :, fill + 1:] = 1e9
    got = da.flash_decode_partials(torch.from_numpy(q), poisoned, 0, pads, fill, G)
    for a, b in zip(got, clean):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_partials_are_single_token():
    q, _, tc = make_inputs(1, 2, 128, seed=1, quantized=False)
    with pytest.raises(ValueError, match="single-token"):
        da.flash_decode_partials(
            torch.from_numpy(q), tc, 0, torch.zeros((1,), dtype=torch.int32), 3, G
        )
