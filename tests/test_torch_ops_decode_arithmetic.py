"""The arithmetic of the decode kernel (csrc/flash_decode.cu, K2 and K2p),
rebuilt from torch ops, against the JAX package's Pallas decode kernel.

The CUDA kernel runs only on the card. Here ``kernel_arithmetic`` computes
what it computes, in its order, with its sizes scaled down (512-slot splits
of four 128-slot warp ranges of 16-slot tiles on the card; 32, 8 and 4
here; its merge's chunks of two splits are kept): QK over bf16-exact
inputs, scores in the log2 domain, an online softmax per warp range, p
(times vs for int8) split into bf16 hi + lo for PV, the warps' states
merged into each split's partial, and the splits up to the fill's merged
by log-sum-exp, in order within a chunk and chunk by chunk. K2 then divides by max(l, 1e-30); K2p
converts m back to natural-log units, and a row that sees no key stays
exactly m = -1e30, l = 0, o = 0. The JAX kernel runs in interpret mode on
the same inputs, made with numpy from a seed; its cache length is a
multiple of its 128-slot block, since interpret mode pads a ragged block
with NaN.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnsum_tpu.models.llama import _quantize_kv
from vnsum_tpu.ops.decode_attention import flash_decode_attention as jax_decode
from vnsum_tpu_torch.ops import decode_attention as da

from test_torch_ops_flash import one_torch_thread  # noqa: F401

HD = 128
LOG2E = 1.4426950408889634
LN2 = np.float32(0.6931471805599453)
NEG = -1e30


def bf16_exact(x):
    """f32 values that bf16 holds exactly (numpy in, numpy out)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def hi_lo(p):
    """p = hi + lo + O(2^-18 p), both halves exact in bf16: the CUDA
    kernel's PV operand."""
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def merge(parts, chunk=None):
    """Log-sum-exp merge of (o, m, l) states in the log2 domain: in order,
    or (the splits' merge) in order within chunks of ``chunk`` and chunk by
    chunk."""
    m = torch.stack([p[1] for p in parts]).amax(0)
    f = [torch.exp2(p[1] - m) for p in parts]
    o = [p[0] * fi[:, None] for p, fi in zip(parts, f)]
    l = [p[2] * fi for p, fi in zip(parts, f)]
    step = chunk or len(parts)
    return (sum(sum(o[c:c + step]) for c in range(0, len(parts), step)), m,
            sum(sum(l[c:c + step]) for c in range(0, len(parts), step)))


def kernel_arithmetic(q, cache, layer, pads, fill, G, window=0, partials=False,
                      split=32, quarter=8, tile=4, chunk=2):
    """K2's output [B, 1, H, hd], or K2p's (o [B, H, hd], m [B, H], l [B, H]),
    computed the way csrc/flash_decode.cu computes them (module docstring)."""
    B, _, H, hd = q.shape
    k, v = cache["k"][layer].float(), cache["v"][layer].float()  # int8 widens exactly
    ks = cache["ks"][layer] if "ks" in cache else None
    vs = cache["vs"][layer] if "vs" in cache else None
    KV, C = k.shape[1], k.shape[2]
    scale_log2 = LOG2E / hd ** 0.5
    o_out, m_out, l_out = torch.zeros((B, H, hd)), torch.zeros((B, H)), torch.zeros((B, H))
    inert = (torch.zeros((G, hd)), torch.full((G,), NEG), torch.zeros(G))
    for b in range(B):
        pad = int(pads[b])
        for kv in range(KV):
            qg = q[b, 0, kv * G:(kv + 1) * G].float()
            splits = []
            for s0 in range(0, fill + 1, split):  # the splits up to the fill's
                lo = max(pad, s0, fill - window + 1 if window else 0)
                hi = min(fill, s0 + split - 1)
                if lo > hi:
                    splits.append(inert)
                    continue
                warps = []
                for w0 in range(s0, s0 + split, quarter):
                    w_lo, w_hi = max(lo, w0), min(hi, w0 + quarter - 1)
                    o, m, l = (x.clone() for x in inert)
                    for k0 in range(w_lo // tile * tile, w_hi + 1 if w_lo <= w_hi else 0, tile):
                        slots = torch.arange(k0, min(k0 + tile, w0 + quarter, C))
                        s = qg @ k[b, kv, slots].T * scale_log2
                        if ks is not None:
                            s = s * ks[b, kv, slots]
                        ok = (slots >= pad) & (slots <= fill)
                        if window:
                            ok &= slots > fill - window
                        s = torch.where(ok, s, torch.full_like(s, NEG))
                        m_new = torch.maximum(m, s.amax(1))
                        corr = torch.exp2(m - m_new)
                        p = torch.where(ok, torch.exp2(s - m_new[:, None]), torch.zeros_like(s))
                        l = l * corr + p.sum(1)
                        if vs is not None:
                            p = p * vs[b, kv, slots]
                        ph, pl = hi_lo(p)
                        o = o * corr[:, None] + ph @ v[b, kv, slots] + pl @ v[b, kv, slots]
                        m = m_new
                    warps.append((o, m, l))
                splits.append(merge(warps))
            o, m, l = merge(splits, chunk)
            heads = slice(kv * G, (kv + 1) * G)
            o_out[b, heads], m_out[b, heads], l_out[b, heads] = o, m, l
    if partials:
        return o_out, torch.where(m_out == NEG, m_out, m_out * LN2), l_out
    return (o_out / l_out.clamp_min(1e-30)[..., None])[:, None]


def make_case(B, KV, G, C, seed, quantized, L=2):
    """(q, jax cache, torch cache): q and K/V exact in bf16, as the card's are."""
    rng = np.random.default_rng(seed)
    q = bf16_exact(rng.standard_normal((B, 1, KV * G, HD)).astype(np.float32))
    k = bf16_exact(rng.standard_normal((L, B, KV, C, HD)).astype(np.float32))
    v = bf16_exact(rng.standard_normal((L, B, KV, C, HD)).astype(np.float32))
    if quantized:
        k8, ks = _quantize_kv(jnp.asarray(k))
        v8, vs = _quantize_kv(jnp.asarray(v))
        jc = {"k": k8, "v": v8, "ks": ks, "vs": vs}
    else:
        jc = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tc = {n: torch.from_numpy(np.array(a)) for n, a in jc.items()}
    return q, jc, tc


def v_amax(tc, layer):
    v = tc["v"][layer].float().abs().amax(-1)
    return float((v * tc["vs"][layer] if "vs" in tc else v).amax())


@pytest.mark.parametrize("partials", [False, True], ids=["K2", "K2p"])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("fill", [255, 97], ids=["fill=C-1", "fill=97"])
def test_kernel_arithmetic_matches_jax_kernel(partials, quantized, window, fill):
    """Four rows: pad 0, a left pad, a pad past the fill and a pad of C (the
    last two see no key). C=256 holds eight 32-slot splits: fill 255 reads
    them all, fill 97 stops two slots into the fourth (with window 16 its
    range 82..97 crosses a warp and a split boundary). The two differ by
    summation order (1e-5) and by the hi/lo split of p, which leaves each p
    off by at most 2^-18 of itself: a K2 output element, a p-weighted mean
    of v, moves by at most 2^-18 max|v|, and a K2p o element by l times
    that."""
    B, KV, G, C, layer = 4, 2, 3, 256, 1
    q, jc, tc = make_case(B, KV, G, C, 200 + fill + window + 2 * quantized, quantized)
    pads = np.array([0, 37, fill + 1, C], np.int32)
    want = jax_decode(jnp.asarray(q), jc, layer, jnp.asarray(pads), fill, G, window,
                      interpret=True, return_partials=partials)
    got = kernel_arithmetic(torch.from_numpy(q), tc, layer, pads, fill, G, window, partials)
    vmax = v_amax(tc, layer)
    if not partials:
        got = got.numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5 + 2.0**-18 * vmax)
        assert not got[2:].any() and got[:2].all()
        return
    (o, m, l), (jo, jm, jl) = [x.numpy() for x in got], [np.asarray(x) for x in want]
    np.testing.assert_allclose(m, jm, rtol=1e-5, atol=1e-5)  # natural-log units
    np.testing.assert_allclose(l, jl, rtol=1e-5, atol=1e-5)
    limit = (1e-5 + 2.0**-18 * vmax) * jl[..., None] + 1e-5 * np.abs(jo)
    assert (np.abs(o - jo) <= limit).all(), float((np.abs(o - jo) / limit).max())
    # rows 2 and 3 see no key: exactly inert, as in the JAX kernel
    for go, gm, gl in ((o, m, l), (jo, jm, jl)):
        assert (gm[2:] == np.float32(NEG)).all() and not gl[2:].any() and not go[2:].any()
    assert (l[:2] >= 1).all()


@pytest.mark.parametrize("partials", [False, True], ids=["K2", "K2p"])
def test_plain_takes_a_fill_tensor(partials):
    """The plain versions take the fill as a one-element int32 tensor, as the
    kernel reads it on the device, and give the int's result."""
    q, _, tc = make_case(3, 2, 3, 128, 7, quantized=True)
    q = torch.from_numpy(q)
    pads = torch.tensor([0, 9, 60], dtype=torch.int32)
    fn = da.flash_decode_partials if partials else da.flash_decode_attention
    want = fn(q, tc, 1, pads, 70, 3)
    got = fn(q, tc, 1, pads, torch.tensor([70], dtype=torch.int32), 3)
    for a, b in zip(got if partials else [got], want if partials else [want]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_plain_clamps_a_fill_tensor_to_the_cache():
    """A fill tensor past the cache reads the whole cache, as the kernel
    clamps a device fill to [0, C - 1]; one below 0 reads slot 0."""
    q, _, tc = make_case(2, 2, 3, 128, 8, quantized=False)
    q = torch.from_numpy(q)
    pads = torch.zeros(2, dtype=torch.int32)
    for past, at in ((500, 127), (-3, 0)):
        got = da.flash_decode_attention(q, tc, 0, pads, torch.tensor([past], dtype=torch.int32), 3)
        torch.testing.assert_close(got, da.flash_decode_attention(q, tc, 0, pads, at, 3),
                                   rtol=0, atol=0)
