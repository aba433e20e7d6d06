"""The arithmetic of the prefill kernel (csrc/flash_prefill.cu, K1), rebuilt
from torch ops, against the JAX package's Pallas prefill kernel.

The CUDA kernel runs only on the card. Here ``kernel_arithmetic`` computes
what it computes, in its order, with its sizes scaled down (blocks of 128
(position, group head) rows in two warpgroups of 64, 128-slot tiles on the
card; 32, 16 and 16 here): the rows taken position-major, a block's tiles
from its pad (or window floor) to its diagonal, each warpgroup skipping the
tiles its rows cannot see and masking only those that cross its diagonal,
the pad or the window floor, QK over bf16-exact inputs, scores in the log2
domain (times ks for int8), the running max and sum per tile with ``l`` kept
as four partials (the four threads of a fragment row) added pairwise at the
end, p (times vs for int8) rounded to bf16 against the running max for PV,
and O / max(l, 1e-30) cast to bf16. The JAX kernel runs in interpret mode on
the same inputs, made with numpy from a seed, with its K block set to the
same tile, so both round p against the same running max; its cache length
is a multiple of that block, since interpret mode pads a ragged block with
NaN.

At head_dim 256 the kernel is another tiling (``flash_prefill_wide_kernel``:
blocks of 64 rows in ONE consumer warpgroup, 64-slot tiles); its arithmetic
is the same function of those sizes, rebuilt at blocks of 16 rows in one
warpgroup of 16 over 16-slot tiles.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnsum_tpu.models.llama import _quantize_kv
from vnsum_tpu.ops.flash_attention import flash_prefill_attention as jax_flash

from test_torch_ops_decode_arithmetic import HD, LOG2E, NEG, bf16_exact
from test_torch_ops_flash import one_torch_thread  # noqa: F401


def kernel_arithmetic(q, cache, layer, pads, G, window=0, q_offset=0,
                      rows=32, wg_rows=16, tile=16):
    """K1's output [B, S, H, hd] (bf16 values as f32), computed the way
    csrc/flash_prefill.cu computes it (module docstring)."""
    B, S, H, hd = q.shape
    k, v = cache["k"][layer].float(), cache["v"][layer].float()  # int8 widens exactly
    ks = cache["ks"][layer] if "ks" in cache else None
    vs = cache["vs"][layer] if "vs" in cache else None
    KV, C = k.shape[1], k.shape[2]
    scale_log2 = torch.tensor(1.0 / hd ** 0.5, dtype=torch.float32) * LOG2E
    n_rows = S * G
    tig = (torch.arange(tile) % 8) // 2  # the fragment thread that holds each column
    out = torch.zeros((B, S, H, hd))
    for b in range(B):
        pad = int(pads[b])
        for kv in range(KV):
            # row r = (position r // G, head kv G + r % G)
            qr = q[b, :, kv * G:(kv + 1) * G].float().reshape(n_rows, hd)
            pos = q_offset + torch.arange(n_rows) // G
            for r0 in range(0, n_rows, rows):
                q_lo, q_hi = int(pos[r0]), int(pos[min(r0 + rows, n_rows) - 1])
                kt_lo = pad // tile
                if window:
                    kt_lo = max(kt_lo, max(q_lo - window + 1, 0) // tile)
                for w0 in range(r0, min(r0 + rows, n_rows), wg_rows):
                    w1 = min(w0 + wg_rows, n_rows)
                    wq_lo, wq_hi = int(pos[w0]), int(pos[w1 - 1])
                    rq = pos[w0:w1]
                    o = torch.zeros((w1 - w0, hd))
                    m = torch.full((w1 - w0,), NEG)
                    l4 = torch.zeros((w1 - w0, 4))
                    for kt in range(kt_lo, q_hi // tile + 1):
                        k0 = kt * tile
                        if not (k0 <= wq_hi and k0 + tile - 1 >= pad
                                and (not window or k0 + tile - 1 > wq_lo - window)):
                            continue  # this warpgroup's rows see none of the tile
                        interior = (w1 - w0 == wg_rows and k0 >= pad and k0 + tile - 1 <= wq_lo
                                    and (not window or k0 > wq_hi - window))
                        slots = torch.arange(k0, k0 + tile)
                        inside = slots < C  # TMA reads slots past C as zeros
                        kt_, vt_ = torch.zeros((tile, hd)), torch.zeros((tile, hd))
                        kt_[inside], vt_[inside] = k[b, kv, slots[inside]], v[b, kv, slots[inside]]
                        s = qr[w0:w1] @ kt_.T * scale_log2
                        if ks is not None:
                            s = s * torch.where(inside, ks[b, kv, slots.clamp_max(C - 1)], 0.0)
                        ok = torch.ones_like(s, dtype=torch.bool)
                        if not interior:
                            ok = (slots[None] >= pad) & (slots[None] <= rq[:, None])
                            if window:
                                ok &= slots[None] > rq[:, None] - window
                            s = torch.where(ok, s, torch.full_like(s, NEG))
                        m_new = torch.maximum(m, s.amax(1))
                        corr = torch.exp2(m - m_new)
                        p = torch.where(ok, torch.exp2(s - m_new[:, None]), torch.zeros_like(s))
                        l4 = l4 * corr[:, None] + torch.stack(
                            [p[:, tig == t].sum(1) for t in range(4)], 1)
                        if vs is not None:
                            p = p * torch.where(inside, vs[b, kv, slots.clamp_max(C - 1)], 0.0)
                        o = o * corr[:, None] + p.to(torch.bfloat16).float() @ vt_
                        m = m_new
                    l = (l4[:, 0] + l4[:, 1]) + (l4[:, 2] + l4[:, 3])
                    res = (o / l.clamp_min(1e-30)[:, None]).to(torch.bfloat16).float()
                    for i, r in enumerate(range(w0, w1)):
                        out[b, r // G, kv * G + r % G] = res[i]
    return out


def make_case(B, KV, G, S, C, seed, quantized, L=2, hd=HD):
    """(q, jax cache, torch cache): q and K/V exact in bf16, as the card's are."""
    rng = np.random.default_rng(seed)
    q = bf16_exact(rng.standard_normal((B, S, KV * G, hd)).astype(np.float32))
    k = bf16_exact(rng.standard_normal((L, B, KV, C, hd)).astype(np.float32))
    v = bf16_exact(rng.standard_normal((L, B, KV, C, hd)).astype(np.float32))
    if quantized:
        k8, ks = _quantize_kv(jnp.asarray(k))
        v8, vs = _quantize_kv(jnp.asarray(v))
        jc = {"k": k8, "v": v8, "ks": ks, "vs": vs}
    else:
        jc = {"k": jnp.asarray(k, jnp.bfloat16), "v": jnp.asarray(v, jnp.bfloat16)}
    tc = {n: torch.from_numpy(np.array(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a))
          for n, a in jc.items()}
    return q, jc, tc


def check_against_jax(G, quantized, window, q_offset, hd, rows, wg_rows, tile):
    """Three rows (pad 0, 9, and past the last query) of S=40 queries at
    q_offset of a C=96 cache through ``kernel_arithmetic`` at these sizes,
    against the JAX kernel with block_k = ``tile`` (limits: the test below)."""
    B, KV, S, C, layer = 3, 2, 40, 96, 1
    q, jc, tc = make_case(B, KV, G, S, C, 300 + 7 * G + window + q_offset + quantized,
                          quantized, hd=hd)
    pads = np.array([0, 9, q_offset + S], np.int32)
    want = jax_flash(jnp.asarray(q, jnp.bfloat16), jc, layer, jnp.asarray(pads), G, window,
                     q_offset, block_k=tile, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = kernel_arithmetic(torch.from_numpy(q), tc, layer, pads, G, window, q_offset,
                            rows=rows, wg_rows=wg_rows, tile=tile).numpy()
    v = tc["v"][layer].abs()
    vmax = float((v.amax(-1) * tc["vs"][layer]).amax() if quantized else v.amax())
    np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=2.0**-9 * vmax)
    blind = q_offset + np.arange(S)[None, :] < pads[:, None]
    for out in (got, want):
        assert not out[blind].any() and np.abs(out[~blind]).max(-1).min() > 0


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("q_offset", [0, 37])
def test_kernel_arithmetic_wide_matches_jax_kernel(quantized, window, q_offset):
    """The head_dim-256 kernel's tiling (one warpgroup a block, scaled to 16
    rows over 16-slot tiles) at Gemma3's G = 2, held as the test below."""
    check_against_jax(2, quantized, window, q_offset, hd=256, rows=16, wg_rows=16, tile=16)


@pytest.mark.parametrize("G", [2, 3])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("q_offset", [0, 37])
def test_kernel_arithmetic_matches_jax_kernel(G, quantized, window, q_offset):
    """Three rows: pad 0, a left pad of 9, and a pad past the last query (it
    sees no key and must be exactly 0). S=40 queries at slots q_offset ..
    q_offset + 39 of a C=96 cache: 6 tiles of 16, blocks of 32 rows whose
    warpgroups skip, mask and take whole tiles. Both sides round p to bf16
    against the same running max and cast the output to bf16. They differ
    by the order of sums and by exp against ex2 of log2-scaled scores
    (~1e-6 relative), which can move p across a bf16 rounding boundary (one
    bf16 ulp, 2^-7 of p at most, on a rare element) and the output across
    one of the final cast (2^-7 of |output|): 2^-7 |want| + 2^-9 max|v|."""
    B, KV, S, C, layer = 3, 2, 40, 96, 1
    q, jc, tc = make_case(B, KV, G, S, C, 300 + 7 * G + window + q_offset + quantized,
                          quantized)
    pads = np.array([0, 9, q_offset + S], np.int32)
    want = jax_flash(jnp.asarray(q, jnp.bfloat16), jc, layer, jnp.asarray(pads), G, window,
                     q_offset, block_k=16, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = kernel_arithmetic(torch.from_numpy(q), tc, layer, pads, G, window, q_offset).numpy()
    v = tc["v"][layer].abs()
    vmax = float((v.amax(-1) * tc["vs"][layer]).amax() if quantized else v.amax())
    np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=2.0**-9 * vmax)
    # a query that sees no key (all of row 2; row 1's queries at slots below
    # its pad) is exactly 0 on both sides, and every other query is not
    blind = q_offset + np.arange(S)[None, :] < pads[:, None]
    for out in (got, want):
        assert not out[blind].any() and np.abs(out[~blind]).max(-1).min() > 0
