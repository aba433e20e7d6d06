"""Verify attention (kernel K3) of the PyTorch port against the JAX
package's Pallas kernel ``flash_spec_verify_attention``.

On the CPU the port's wrapper takes its plain version; the JAX kernel runs
in interpret mode. Both get the same inputs, made with numpy from a seed,
and both compute in f32 throughout, so they differ by summation order only:
1e-5. The cases follow tests/test_ops_decode.py's verify cases (per-row
fills and pads, several layers, garbage beyond each row's limit, an int8
cache, windows) plus a row parked at limit C, as the slot segment parks a
finished row; at head_dim 256 (Gemma3: G = 2) the same at Gemma3's Sq = 9
and 1 with a sliding window. The JAX kernel's cache length stays a multiple
of its block: interpret mode pads a ragged last block with NaN.
"""
from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnsum_tpu.models.llama import _quantize_kv
from vnsum_tpu.ops.decode_attention import flash_spec_verify_attention as jax_verify
from vnsum_tpu_torch.ops import verify_attention as va

from test_torch_ops_flash import one_torch_thread  # noqa: F401

HD = 128
TOL = dict(rtol=1e-5, atol=1e-5)


def make_case(L, B, KV, C, Sq, H, seed, quantized=False, hd=HD):
    """(q, jax cache, torch cache) from one numpy seed."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((L, B, KV, C, hd)).astype(np.float32)
    v = rng.standard_normal((L, B, KV, C, hd)).astype(np.float32)
    if quantized:
        k8, ks = _quantize_kv(jnp.asarray(k))
        v8, vs = _quantize_kv(jnp.asarray(v))
        jc = {"k": k8, "v": v8, "ks": ks, "vs": vs}
    else:
        jc = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tc = {n: torch.from_numpy(np.array(a)) for n, a in jc.items()}
    return q, jc, tc


def both(q, jc, tc, layer, pads, fills, G, window=0, block_k=16):
    want = jax_verify(
        jnp.asarray(q), jc, layer, jnp.asarray(pads, jnp.int32),
        jnp.asarray(fills, jnp.int32), G,
        None if not window else jnp.int32(window), block_k=block_k, interpret=True,
    )
    before = va.launches
    got = va.flash_spec_verify_attention(
        torch.from_numpy(q), tc, layer, torch.tensor(pads, dtype=torch.int32),
        torch.tensor(fills, dtype=torch.int32), G, window,
    )
    assert va.launches == before  # CPU tensors never reach the kernel
    assert got.shape == q.shape and got.dtype == torch.float32
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("layer", [0, 2])
@pytest.mark.parametrize(
    "fills,pads", [([10, 40], [0, 5]), ([58, 12], [3, 0]), ([7, 7], [2, 2])]
)
def test_verify_plain_matches_jax_kernel(quantized, layer, fills, pads):
    """Per-row fills, Sq=5 query positions per row, layers 0 and 2."""
    L, B, KV, C, Sq, H = 3, 2, 2, 64, 5, 4
    q, jc, tc = make_case(L, B, KV, C, Sq, H, seed=layer + fills[0], quantized=quantized)
    got, want = both(q, jc, tc, layer, pads, fills, H // KV)
    np.testing.assert_allclose(got, want, **TOL)


def test_verify_plain_ignores_beyond_limit_garbage():
    """Slots past each row's per-query limit never leak in, including slots
    between two rows' different fills (the rollback region)."""
    L, B, KV, C, Sq, H = 1, 2, 1, 32, 3, 2
    q, jc, tc = make_case(L, B, KV, C, Sq, H, seed=9)
    fills, pads = [6, 20], [0, 0]
    # poison row 0 beyond ITS visibility (limit 6+3-1=8) but inside row 1's
    poisoned = {n: t.clone() for n, t in tc.items()}
    poisoned["k"][:, 0, :, 9:, :] = 30.0
    poisoned["v"][:, 0, :, 9:, :] = 1e9
    jpoisoned = {n: jnp.asarray(t.numpy()) for n, t in poisoned.items()}
    clean, want = both(q, jc, tc, 0, pads, fills, H // KV, block_k=8)
    dirty, want_dirty = both(q, jpoisoned, poisoned, 0, pads, fills, H // KV, block_k=8)
    np.testing.assert_array_equal(dirty[0], clean[0])
    np.testing.assert_allclose(dirty, want_dirty, **TOL)


@pytest.mark.parametrize("win", [4, 16])
def test_verify_plain_windowed_matches_jax_kernel(win):
    """Per-query window floor: k > fills_b + s - win."""
    L, B, KV, C, Sq, H = 1, 2, 2, 64, 3, 4
    q, jc, tc = make_case(L, B, KV, C, Sq, H, seed=5 + win)
    got, want = both(q, jc, tc, 0, [0, 2], [20, 44], H // KV, window=win)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_verify_plain_parked_row_and_blind_queries(quantized):
    """Row 0 is parked at limit C (its last query sits past the cache, as a
    finished slot-segment row does at t = max_new); row 1's pad hides every
    key from its first queries, which come out as 0; row 2 is an all-pad
    free slot (pad = C)."""
    L, B, KV, C, Sq, H = 2, 3, 2, 64, 4, 6
    q, jc, tc = make_case(L, B, KV, C, Sq, H, seed=31, quantized=quantized)
    fills, pads = [C - Sq + 1, 30, 40], [0, 32, C]
    got, want = both(q, jc, tc, 1, pads, fills, H // KV)
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[1, :2].any() and not got[2].any()
    assert got[1, 2:].any()


def test_verify_sq1_matches_the_decode_kernel_at_a_shared_fill():
    """At Sq=1 and one fill for every row, K3 computes K2's function."""
    from vnsum_tpu_torch.ops import decode_attention as da

    L, B, KV, C, H = 2, 3, 2, 64, 4
    _, _, tc = make_case(L, B, KV, C, 1, H, seed=4, quantized=True)
    q = torch.from_numpy(np.random.default_rng(4).standard_normal((B, 1, H, HD)).astype(np.float32))
    pads = torch.tensor([0, 9, 50], dtype=torch.int32)
    got = va.flash_spec_verify_attention(
        q, tc, 1, pads, torch.full((B,), 41, dtype=torch.int32), H // KV)
    want = da.flash_decode_attention(q, tc, 1, pads, 41, H // KV)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


LOG2E = 1.4426950408889634
NEG = -1e30


def bf16_exact(x):
    """f32 values that bf16 holds exactly (numpy in, numpy out)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def hi_lo(p):
    """p = hi + lo + O(2^-18 p), both halves exact in bf16: the CUDA
    kernel's PV operand."""
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def kernel_arithmetic(q, cache, layer, pads, fills, G, window=0, split=32, quarter=8, tile=4,
                      od=128, rows=32):
    """K3's function computed the way csrc/flash_verify.cu computes it, with
    its sizes scaled down (512-slot splits of four 128-slot warp ranges of
    16-slot tiles on the card): per tile, QK in f32 over bf16-exact inputs
    and all hd dims, scores in the log2 domain, masked per (query row,
    slot); an online softmax per warp range; p (times vs for int8) split
    into bf16 hi + lo, each multiplied into V's head dims in parts of
    ``od`` (at head_dim 256 two warps share a warp range, each with the
    same p and its own 128 dims of o); the warp ranges' (o, m, l) merged
    into the split's partial; the splits merged by log-sum-exp and divided
    by max(l, 1e-30). A warp takes at most ``rows`` of the R = Sq * G query
    rows (row r = s * G + g): above that (R = 36 at GQA group 4) the rows
    split into halves, each run by its own warps over the same slots and
    written back to its own rows."""
    B, Sq, H, hd = q.shape
    k, v = cache["k"][layer].float(), cache["v"][layer].float()  # int8 widens exactly
    ks = cache["ks"][layer] if "ks" in cache else None
    vs = cache["vs"][layer] if "vs" in cache else None
    KV, C = k.shape[1], k.shape[2]
    R = Sq * G
    scale_log2 = LOG2E / hd ** 0.5
    out = torch.zeros((B, Sq, H, hd))

    def merge(parts):
        m = torch.stack([p[1] for p in parts]).amax(0)
        f = [torch.exp2(p[1] - m) for p in parts]
        return (sum(p[0] * fi[:, None] for p, fi in zip(parts, f)), m,
                sum(p[2] * fi for p, fi in zip(parts, f)))

    for b, kv, r0 in itertools.product(range(B), range(KV), range(0, R, rows)):
        half = torch.arange(r0, min(R, r0 + rows))  # the rows of one warp (w or w + 4)
        limit = int(fills[b]) + half // G  # row r = s * G + g
        qr = q[b, :, kv * G:(kv + 1) * G].reshape(R, hd).float()[half]
        splits = []
        for s0 in range(0, C, split):
            warps = []
            for w0 in range(s0, min(s0 + split, C), quarter):
                n = len(half)
                o, m, l = torch.zeros((n, hd)), torch.full((n,), NEG), torch.zeros(n)
                for k0 in range(w0, min(w0 + quarter, C), tile):
                    slots = torch.arange(k0, min(k0 + tile, w0 + quarter, C))
                    s = qr @ k[b, kv, slots].T * scale_log2
                    if ks is not None:
                        s = s * ks[b, kv, slots]
                    ok = (slots >= int(pads[b])) & (slots <= limit[:, None])
                    if window:
                        ok &= slots > limit[:, None] - window
                    s = torch.where(ok, s, torch.full_like(s, NEG))
                    m_new = torch.maximum(m, s.amax(1))
                    corr = torch.exp2(m - m_new)
                    p = torch.where(ok, torch.exp2(s - m_new[:, None]), torch.zeros_like(s))
                    l = l * corr + p.sum(1)
                    if vs is not None:
                        p = p * vs[b, kv, slots]
                    hi, lo = hi_lo(p)
                    o = o * corr[:, None] + torch.cat(
                        [hi @ v[b, kv, slots, d0:d0 + od] + lo @ v[b, kv, slots, d0:d0 + od]
                         for d0 in range(0, hd, od)], dim=1)
                    m = m_new
                warps.append((o, m, l))
            splits.append(merge(warps))
        o, _, l = merge(splits)
        out[b, half // G, kv * G + half % G] = o / l.clamp_min(1e-30)[:, None]
    return out


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("Sq", [9, 1])
@pytest.mark.parametrize("window", [0, 16])
def test_kernel_arithmetic_matches_jax_kernel(quantized, Sq, window):
    """The CUDA kernel's arithmetic (kernel_arithmetic) against the JAX
    kernel, on q and K/V exact in bf16, as the card's are. Row 1's pad hides
    every key from its first queries (Sq=9); at Sq=1 row 0 is parked at
    limit C. The two differ by summation order (1e-5) and by the hi/lo split
    of p, which leaves each p off by at most 2^-18 of itself: an output
    element, a p-weighted mean of v, moves by at most 2^-18 max|v|."""
    L, B, KV, C, H = 2, 2, 2, 64, 4
    G = H // KV
    rng = np.random.default_rng(100 + Sq + window + quantized)
    q = bf16_exact(rng.standard_normal((B, Sq, H, HD)).astype(np.float32))
    k = bf16_exact(rng.standard_normal((L, B, KV, C, HD)).astype(np.float32))
    v = bf16_exact(rng.standard_normal((L, B, KV, C, HD)).astype(np.float32))
    if quantized:
        k8, ks = _quantize_kv(jnp.asarray(k))
        v8, vs = _quantize_kv(jnp.asarray(v))
        jc = {"k": k8, "v": v8, "ks": ks, "vs": vs}
    else:
        jc = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tc = {n: torch.from_numpy(np.array(a)) for n, a in jc.items()}
    fills, pads = ([20, 30], [0, 33]) if Sq == 9 else ([C, 17], [0, 3])
    layer = 1
    want = np.asarray(jax_verify(
        jnp.asarray(q), jc, layer, jnp.asarray(pads, jnp.int32), jnp.asarray(fills, jnp.int32),
        G, None if not window else jnp.int32(window), block_k=16, interpret=True))
    got = kernel_arithmetic(torch.from_numpy(q), tc, layer, pads, fills, G, window).numpy()
    vmax = float(tc["v"][layer].float().abs().amax(-1).mul(
        tc["vs"][layer] if quantized else 1.0).amax())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 + 2.0**-18 * vmax)
    if Sq == 9:
        assert not got[1, :3].any() and got[1, 3:].any()


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [0, 16])
def test_kernel_arithmetic_matches_jax_kernel_group4(quantized, window):
    """Phi-4-14B's spec step at GQA group 4: Sq = 9 queries of 4 heads make
    R = 36 rows, past one warp's 32, so the kernel's block runs the rows in
    two halves (warps w and w + 4 over the same slots; kernel_arithmetic's
    ``rows``). The arithmetic against the JAX kernel as in
    test_kernel_arithmetic_matches_jax_kernel, at the same limit. The first
    half holds rows 0-31 (queries 0-7), the second rows 32-35 (query 8);
    row 1's pad hides every key from its first 3 queries (rows 0-11),
    which must come out 0."""
    L, B, KV, C, G, Sq = 2, 2, 2, 64, 4, 9
    H = KV * G
    rng = np.random.default_rng(300 + window + quantized)
    q = bf16_exact(rng.standard_normal((B, Sq, H, HD)).astype(np.float32))
    k = bf16_exact(rng.standard_normal((L, B, KV, C, HD)).astype(np.float32))
    v = bf16_exact(rng.standard_normal((L, B, KV, C, HD)).astype(np.float32))
    if quantized:
        k8, ks = _quantize_kv(jnp.asarray(k))
        v8, vs = _quantize_kv(jnp.asarray(v))
        jc = {"k": k8, "v": v8, "ks": ks, "vs": vs}
    else:
        jc = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tc = {n: torch.from_numpy(np.array(a)) for n, a in jc.items()}
    fills, pads, layer = [20, 30], [0, 33], 1
    want = np.asarray(jax_verify(
        jnp.asarray(q), jc, layer, jnp.asarray(pads, jnp.int32), jnp.asarray(fills, jnp.int32),
        G, None if not window else jnp.int32(window), block_k=16, interpret=True))
    qt = torch.from_numpy(q)
    got = kernel_arithmetic(qt, tc, layer, pads, fills, G, window).numpy()
    vmax = float(tc["v"][layer].float().abs().amax(-1).mul(
        tc["vs"][layer] if quantized else 1.0).amax())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 + 2.0**-18 * vmax)
    assert not got[1, :3].any() and got[1, 3:].any()
    # the halves change no row's arithmetic: one warp over all 36 rows gives
    # the same values, up to the CPU product's summation order over a 36-
    # row matrix against a 32- and a 4-row one (~1e-6 here), inside the
    # limit above
    whole = kernel_arithmetic(qt, tc, layer, pads, fills, G, window, rows=Sq * G).numpy()
    np.testing.assert_allclose(got, whole, rtol=0, atol=1e-5)


def test_verify_wrapper_refuses_what_the_kernel_does_not_take():
    """On a tensor that is neither CPU nor CUDA the wrapper raises instead of
    falling back. The kernel's argument check (``check_verify``, run before
    every launch) takes head_dim 128 and 256 and refuses 384, a head_dim of
    the JAX kernel's that no registry model has, naming ROADMAP B4."""
    q = torch.zeros((1, 2, 4, HD), device="meta")
    cache = {"k": torch.zeros((1, 1, 2, 8, HD), device="meta"),
             "v": torch.zeros((1, 1, 2, 8, HD), device="meta")}
    with pytest.raises(ValueError, match="no verify attention kernel"):
        va.flash_spec_verify_attention(
            q, cache, 0, torch.zeros(1, dtype=torch.int32, device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"), 2)
    for hd in (128, 256):
        assert kernel_args(hd) == (False, 0)
    with pytest.raises(NotImplementedError, match="B4"):
        kernel_args(384)


def kernel_args(hd, B=2, Sq=9, KV=2, G=2, C=32, quantized=False, window=None, **bad):
    """``va.check_verify`` on CPU tensors of the kernel's types; ``bad``
    replaces one argument."""
    q = torch.zeros((B, Sq, KV * G, hd), dtype=torch.bfloat16)
    shape = (2, B, KV, C, hd)
    if quantized:
        cache = {"k": torch.zeros(shape, dtype=torch.int8),
                 "v": torch.zeros(shape, dtype=torch.int8),
                 "ks": torch.ones(shape[:-1]), "vs": torch.ones(shape[:-1])}
    else:
        cache = {"k": torch.zeros(shape, dtype=torch.bfloat16),
                 "v": torch.zeros(shape, dtype=torch.bfloat16)}
    args = dict(q=q, cache=cache, layer_idx=1, pad_lens=torch.zeros(B, dtype=torch.int32),
                fills=torch.full((B,), 3, dtype=torch.int32), q_per_kv=G, window=window)
    args.update(bad)
    return va.check_verify(**args)


@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("Sq,G,window", [(9, 2, None), (1, 2, 1024), (1, 8, 0)])
def test_check_verify_takes_gemma_and_llama_shapes(hd, quantized, Sq, G, window):
    """The spec step's and the slot segment's shapes at both head_dims, a
    window, and the largest group, on a bf16 or int8 cache."""
    assert kernel_args(hd, Sq=Sq, G=G, quantized=quantized, window=window) == (
        quantized, int(window or 0))


@pytest.mark.parametrize("hd,Sq,G,ok", [
    (128, 32, 2, True), (128, 33, 2, False),   # MAX_ROWS[128] = 64
    (256, 12, 2, True), (256, 13, 2, False),   # MAX_ROWS[256] = 24
    (256, 1, 16, False),                        # MAX_GROUP = 8
])
def test_check_verify_row_limits(hd, Sq, G, ok):
    """Sq * q_per_kv up to MAX_ROWS[hd] rows and q_per_kv up to MAX_GROUP, as
    csrc/flash_verify.cu takes them; one more raises."""
    assert va.MAX_ROWS == {128: 64, 256: 24} and va.MAX_GROUP == 8
    if ok:
        kernel_args(hd, Sq=Sq, G=G)
    else:
        with pytest.raises(ValueError, match="Sq \\* group"):
            kernel_args(hd, Sq=Sq, G=G)


@pytest.mark.parametrize("bad", ["hd64", "window", "fills"])
def test_check_verify_refuses_bad_arguments(bad):
    """A head_dim no kernel takes (64 runs dense), a negative window and
    fills of the wrong type raise ValueError."""
    with pytest.raises(ValueError):
        if bad == "hd64":
            kernel_args(64)
        elif bad == "window":
            kernel_args(256, window=-1)
        else:
            kernel_args(256, fills=torch.zeros(2, dtype=torch.int64))


# head_dim 256: Gemma3's G = 2, its spec step's Sq = 9 and its slot
# segment's Sq = 1; C a multiple of 128
HD256 = 256


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize(
    "fills,pads", [([10, 100], [0, 5]), ([118, 40], [3, 0]), ([60, 60], [2, 2])]
)
def test_verify_plain_matches_jax_kernel_hd256(quantized, window, fills, pads):
    """The plain version at head_dim 256 (the card's yardstick for K3
    there) against the JAX kernel: per-row fills, Sq=9, layer 2 of 3,
    global and windowed; 1e-5."""
    L, B, KV, C, Sq, H = 3, 2, 2, 128, 9, 4
    q, jc, tc = make_case(L, B, KV, C, Sq, H, seed=200 + window + fills[0],
                          quantized=quantized, hd=HD256)
    got, want = both(q, jc, tc, 2, pads, fills, H // KV, window=window)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("window", [0, 16])
def test_verify_plain_parked_row_and_blind_queries_hd256(quantized, window):
    """At head_dim 256 and Sq=1, as the slot segment sends: row 0 parked at
    limit C, row 1's pad past its fill (no key: 0), row 2 an all-pad free
    slot (pad = C), row 3 an ordinary row."""
    L, B, KV, C, Sq, H = 2, 4, 2, 128, 1, 4
    q, jc, tc = make_case(L, B, KV, C, Sq, H, seed=231 + window, quantized=quantized, hd=HD256)
    fills, pads = [C, 30, 40, 77], [0, 32, C, 9]
    got, want = both(q, jc, tc, 1, pads, fills, H // KV, window=window)
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[1].any() and not got[2].any()
    assert got[0].any() and got[3].any()


@pytest.mark.parametrize("window", [0, 16])
def test_verify_sq1_matches_the_decode_kernel_at_a_shared_fill_hd256(window):
    """At head_dim 256, Sq=1 and one fill for every row, K3 computes K2's
    function (the plain versions: 0 apart)."""
    from vnsum_tpu_torch.ops import decode_attention as da

    L, B, KV, C, H = 2, 3, 2, 128, 4
    _, _, tc = make_case(L, B, KV, C, 1, H, seed=4, quantized=True, hd=HD256)
    q = torch.from_numpy(
        np.random.default_rng(5).standard_normal((B, 1, H, HD256)).astype(np.float32))
    pads = torch.tensor([0, 9, 100], dtype=torch.int32)
    got = va.flash_spec_verify_attention(
        q, tc, 1, pads, torch.full((B,), 90, dtype=torch.int32), H // KV, window)
    want = da.flash_decode_attention(q, tc, 1, pads, 90, H // KV, window)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("Sq", [9, 1])
@pytest.mark.parametrize("window", [0, 16])
def test_kernel_arithmetic_matches_jax_kernel_hd256(quantized, Sq, window):
    """The head_dim-256 kernel's arithmetic (kernel_arithmetic: QK over all
    256 dims, the same p for both 128-dim halves of o) against the JAX
    kernel at G = 2, on q and K/V exact in bf16. Row 1's pad hides every key
    from its first queries (Sq=9); at Sq=1 row 0 is parked at limit C.
    Tolerance as at head_dim 128: 1e-5 for summation order, plus 2^-18
    max|v| for the hi/lo split of p."""
    L, B, KV, C, H = 2, 2, 2, 128, 4
    G = H // KV
    rng = np.random.default_rng(300 + Sq + window + quantized)
    q = bf16_exact(rng.standard_normal((B, Sq, H, HD256)).astype(np.float32))
    k = bf16_exact(rng.standard_normal((L, B, KV, C, HD256)).astype(np.float32))
    v = bf16_exact(rng.standard_normal((L, B, KV, C, HD256)).astype(np.float32))
    if quantized:
        k8, ks = _quantize_kv(jnp.asarray(k))
        v8, vs = _quantize_kv(jnp.asarray(v))
        jc = {"k": k8, "v": v8, "ks": ks, "vs": vs}
    else:
        jc = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tc = {n: torch.from_numpy(np.array(a)) for n, a in jc.items()}
    fills, pads = ([50, 70], [0, 73]) if Sq == 9 else ([C, 97], [0, 3])
    layer = 1
    want = np.asarray(jax_verify(
        jnp.asarray(q), jc, layer, jnp.asarray(pads, jnp.int32), jnp.asarray(fills, jnp.int32),
        G, None if not window else jnp.int32(window), block_k=16, interpret=True))
    got = kernel_arithmetic(torch.from_numpy(q), tc, layer, pads, fills, G, window).numpy()
    vmax = float(tc["v"][layer].float().abs().amax(-1).mul(
        tc["vs"][layer] if quantized else 1.0).amax())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 + 2.0**-18 * vmax)
    if Sq == 9:
        assert not got[1, :3].any() and got[1, 3:].any()
