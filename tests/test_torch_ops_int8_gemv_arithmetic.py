"""The arithmetic of the int8-weight GEMV (csrc/int8_gemv.cu), rebuilt from
torch ops, against the JAX package's int8 product (``_proj`` and
``_lm_head_logits`` in vnsum_tpu/models/llama.py) and the port's plain
version; and the routing that sends projections with a shared input
through one grouped launch.

The CUDA kernel runs only on the card. Here ``kernel_arithmetic`` computes
what it computes, in its order, at its real sizes: each member's channels
in tiles of 64, K in 256-byte chunks split over the ranks of a thread
block cluster of ``gemv_plan``'s size; in a chunk, four 64-byte slabs of
four mma steps, step j of a slab taking k = 16 t + 4 j + e (lane t = 0..3,
e = 0..3), a 16-term sum of exact products; warp w of the tile's four
m16 tiles adds the steps of slabs w // 4 and w // 4 + 2 of each of its
rank's chunks in order; a block sum is warp w % 4's sum plus warp w % 4 +
4's; the ranks' block sums meet in rank order; then each member's
epilogue, bf16(f32(bf16(sum)) * s) or sum * s for the head. The tensor
cores' own order inside a step is the hardware's; the model sums its 16
products in f32.

Tolerances are chip_smoke.py's for the kernel against its plain version
(GEMV_RTOL, GEMV_SUM_RTOL): every product is exact, so the sums differ by
their order only, below 1e-6 of sum |x q| s; the projection mode then
rounds to bf16 twice, and a sum within that error of a half-way point may
round to the other neighbour each time, two bf16 ulps, at most 2^-6 of the
output. Per element: 2^-6 |ref| + 1e-6 sum |x q| s in projection mode,
1e-6 sum |x q| s in head mode. Inputs are made with numpy from a seed.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnsum_tpu.models import llama as jl
from vnsum_tpu.models import quant as jq
from vnsum_tpu_torch.models import llama as tl
from vnsum_tpu_torch.models import quant as tq
from vnsum_tpu_torch.ops import int8_matmul as im

from test_torch_models_llama import B, S, carried_weights  # noqa: F401
from test_torch_ops_flash import one_torch_thread  # noqa: F401

GEMV_RTOL, GEMV_SUM_RTOL = 2.0**-6, 1e-6
SMS = 132  # an H100's SMs, what gemv_plan fills on the card


def weights(N: int, K: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """int8 q [N, K] (the stored layout) and f32 s [N], quantized by the
    JAX package from normal values whose channels differ in magnitude."""
    w = rng.standard_normal((K, N)).astype(np.float32) * rng.uniform(0.25, 2.0, N).astype(
        np.float32)
    leaf = jq._quantize(jnp.asarray(w), (0,))
    return np.asarray(leaf["q"]).T.copy(), np.array(leaf["s"])


def bf16_x(M: int, K: int, rng) -> np.ndarray:
    """x [M, K] f32 values that bf16 holds exactly."""
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


def step_index(n_chunks: int) -> torch.Tensor:
    """[n_chunks, 4 slabs, 4 steps, 16] the k of each mma step, in the
    kernel's permuted order: step j of slab sl in chunk c takes k = 256 c +
    64 sl + 16 t + 4 j + e for lanes t = 0..3 and bytes e = 0..3."""
    c, sl, j, t, e = torch.meshgrid(torch.arange(n_chunks), torch.arange(4), torch.arange(4),
                                    torch.arange(4), torch.arange(4), indexing="ij")
    return (im.CHUNK_K * c + 64 * sl + 16 * t + 4 * j + e).reshape(n_chunks, 4, 4, 16)


def kernel_arithmetic(x: torch.Tensor, members, head: bool = False, sms: int = SMS) -> list:
    """Each member's [M, N] output the way csrc/int8_gemv.cu computes it
    (module docstring): x [M, K] (bf16-exact f32), members [(q [N, K] int8,
    s [N] f32), ...] of one launch."""
    M, K = x.shape
    _, cluster = im.gemv_plan([q.shape[0] for q, _ in members], K, M, sms)
    n_chunks = -(-K // im.CHUNK_K)
    pad = n_chunks * im.CHUNK_K - K  # lanes past the row read zeros
    idx = step_index(n_chunks)
    xs = torch.nn.functional.pad(x.float(), (0, pad))[:, idx]  # [M, c, sl, j, 16]
    outs = []
    for q, s in members:
        qs = torch.nn.functional.pad(q.float(), (0, pad))[:, idx]
        steps = torch.einsum("mcsjk,ncsjk->mncsj", xs, qs)  # 16-term sums of exact products
        total = torch.zeros(M, q.shape[0])
        for rank in range(cluster):
            lo = n_chunks * rank // cluster
            hi = n_chunks * (rank + 1) // cluster
            halves = []
            for half in range(2):  # warp w % 4 (w // 4 = 0), then w % 4 + 4
                acc = torch.zeros(M, q.shape[0])
                for c in range(lo, hi):
                    for sl in (half, half + 2):
                        for j in range(4):
                            acc = acc + steps[:, :, c, sl, j]
                halves.append(acc)
            total = total + (halves[0] + halves[1])
        if head:
            outs.append(total * s)
        else:
            outs.append((total.to(torch.bfloat16).float() * s).to(torch.bfloat16))
    return outs


def jax_product(x: np.ndarray, q: np.ndarray, s: np.ndarray, head: bool) -> np.ndarray:
    """The JAX package's int8 product on bf16 x: ``_proj`` (projection) or
    ``_lm_head_logits`` (head, an untied LM head)."""
    xj = jnp.asarray(x, dtype=jnp.bfloat16)[None]
    w = {"q": jnp.asarray(q.T), "s": jnp.asarray(s)}
    if head:
        cfg = jl.tiny_llama(tie_embeddings=False)
        return np.asarray(jl._lm_head_logits(xj, {"lm_head": w}, cfg)[0], dtype=np.float32)
    return np.asarray(jl._proj("bsd,di->bsi", xj, w)[0].astype(jnp.float32))


def assert_within(got: torch.Tensor, want, x: torch.Tensor, q: torch.Tensor,
                  s: torch.Tensor, head: bool) -> None:
    want = torch.as_tensor(np.array(want)).double()
    mag = (x.double().abs() @ q.double().abs().t()) * s.double()
    limit = GEMV_SUM_RTOL * mag + (0.0 if head else GEMV_RTOL * want.abs())
    diff = (got.double() - want).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((diff <= limit).all()), float((diff / limit).max())


@pytest.mark.parametrize("mode", ["projection", "head"])
@pytest.mark.parametrize("M", [1, 2, 8, 72, 128])
@pytest.mark.parametrize("K", [3072, 8192])
def test_kernel_arithmetic_matches_jax(K, M, mode):
    """One weight of 100 channels (a whole 64-channel tile and a ragged
    one, N not a multiple of 16) at Llama-3.2-3B's contraction widths, the
    cluster split of gemv_plan: within the stated limit of JAX's int8
    product and of the port's plain version."""
    rng = np.random.default_rng(K + M)
    head = mode == "head"
    q, s = weights(100, K, rng)
    x = bf16_x(M, K, rng)
    xt, qt, st = torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s)
    got = kernel_arithmetic(xt, [(qt, st)], head)[0]
    assert got.dtype == (torch.float32 if head else torch.bfloat16)
    assert got.shape == (M, 100)
    assert_within(got, jax_product(x, q, s, head), xt, qt, st, head)
    plain = im.int8_gemv_ref(xt.to(torch.bfloat16), qt, st, head)
    assert_within(got, plain.float(), xt, qt, st, head)


@pytest.mark.parametrize("M", [1, 2, 8, 72, 128])
def test_grouped_kernel_arithmetic_matches_jax(M):
    """Three members of unequal N (192, 100 and 40 channels: whole tiles,
    a ragged tile, a tile of 40) in one launch: each member within the
    stated limit of JAX's ``_proj`` on its own weight and of the plain
    version, the grouped plain version equal to the members' one after
    another."""
    rng = np.random.default_rng(40 + M)
    K = 3072
    ws = [weights(N, K, rng) for N in (192, 100, 40)]
    x = bf16_x(M, K, rng)
    xt = torch.from_numpy(x)
    members = [(torch.from_numpy(q), torch.from_numpy(s)) for q, s in ws]
    got = kernel_arithmetic(xt, members)
    plain = im.int8_gemv_group(xt.to(torch.bfloat16), members)
    for g, p, (q, s), (qt, st) in zip(got, plain, ws, members):
        assert_within(g, jax_product(x, q, s, False), xt, qt, st, False)
        assert_within(g, p.float(), xt, qt, st, False)
        assert torch.equal(p, im.int8_gemv_ref(xt.to(torch.bfloat16), qt, st))


def test_kernel_arithmetic_is_the_order_it_states():
    """The rebuild's split is the kernel's: with one chunk of K, one rank
    and one warp pair, it is the sum of its 16 mma steps of 16 products in
    the stated order, and every k of the row is counted exactly once."""
    idx = step_index(3)
    assert sorted(idx.flatten().tolist()) == list(range(3 * im.CHUNK_K))
    # lane t's 16 bytes of a slab feed steps 0..3, four bytes each
    assert idx[0, 0, :, :4].flatten().tolist() == list(range(16))
    rng = np.random.default_rng(0)
    q, s = weights(16, 256, rng)
    x = bf16_x(1, 256, rng)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    got = kernel_arithmetic(xt, [(qt, torch.ones(16))], head=True, sms=1)[0]
    want = (xt.double() @ qt.double().t()).float()
    assert torch.equal(got, want)  # integers times bf16 values: exact here


# -- the launch plan ---------------------------------------------------------------

# Llama-3.2-3B's launches at a decode step: (channels of each member, K)
# -> (tiles, cluster) on 132 SMs
PLANS = {
    "q/k/v grouped": (((3072, 1024, 1024), 3072), (80, 1)),
    "wo": (((3072,), 3072), (48, 2)),
    "gate/up grouped": (((8192, 8192), 3072), (256, 1)),
    "w_down": (((3072,), 8192), (48, 2)),
    "head": (((128256,), 3072), (2004, 1)),
    "wk alone": (((1024,), 3072), (16, 8)),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_gemv_plan_fills_the_card(name):
    """Each launch of a decode step (M = 8) puts a block on at least half
    of 132 SMs (wk alone, 16 tiles, takes the largest cluster), and a rank
    of a cluster always keeps a chunk of K; with more than 8 rows (the
    verify forward's 72) no launch splits K."""
    (ns, K), want = PLANS[name]
    tiles, cluster = im.gemv_plan(ns, K, 8, SMS)
    assert (tiles, cluster) == want
    assert 2 * tiles * cluster >= SMS or cluster == im.MAX_CLUSTER
    assert cluster <= -(-K // im.CHUNK_K)
    assert im.gemv_plan(ns, K, 1, SMS) == want
    assert im.gemv_plan(ns, K, 9, SMS) == (tiles, 1)


@pytest.mark.parametrize("K", [16, 48, 256, 272])
def test_gemv_plan_keeps_a_chunk_for_every_rank(K):
    """A short K (one to two chunks) caps the cluster at its chunks, and
    the rebuild over it still matches the plain version."""
    _, cluster = im.gemv_plan([64], K, 3, SMS)
    assert 1 <= cluster <= max(1, -(-K // im.CHUNK_K))
    rng = np.random.default_rng(K)
    q, s = weights(64, K, rng)
    x = bf16_x(3, K, rng)
    xt, qt, st = torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s)
    got = kernel_arithmetic(xt, [(qt, st)])[0]
    assert_within(got, im.int8_gemv_ref(xt.to(torch.bfloat16), qt, st).float(), xt, qt, st,
                  False)


# -- the grouped route ---------------------------------------------------------------

GROUPS = {"q/k/v": (96, 32, 32), "gate/up": (160, 160)}


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("rows", [1, 8, 72, 128, 200])
@pytest.mark.parametrize("group", list(GROUPS))
def test_grouped_route_bit_identical_to_separate_calls(group, rows, act_quant):
    """int8_linear_group equals int8_linear member by member, bit for bit,
    on the GEMV's rows (M <= 128, one grouped launch on the card), above
    them (a dequantized matmul per member) and under W8A8 (torch._int_mm
    per member), on bf16 x [1, rows, K]."""
    rng = np.random.default_rng(rows)
    K = 64
    members = [tuple(torch.from_numpy(a) for a in weights(N, K, rng)) for N in GROUPS[group]]
    x = torch.from_numpy(bf16_x(rows, K, rng)).to(torch.bfloat16)[None]
    got = im.int8_linear_group(x, members, act_quant)
    want = [im.int8_linear(x, q, s, act_quant) for q, s in members]
    assert len(got) == len(want)
    for g, w, (q, _) in zip(got, want, members):
        assert g.shape == (1, rows, q.shape[0]) and g.dtype == torch.bfloat16
        assert torch.equal(g, w)


@pytest.mark.parametrize("count", [0, 4])
def test_grouped_gemv_takes_one_to_three_weights(count):
    rng = np.random.default_rng(1)
    members = [tuple(torch.from_numpy(a) for a in weights(16, 32, rng)) for _ in range(count)]
    x = torch.zeros(2, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="1 to 3 weights"):
        im.int8_gemv_group(x, members)


def test_grouped_gemv_counts_nothing_on_the_cpu_and_refuses_other_devices():
    rng = np.random.default_rng(2)
    members = [tuple(torch.from_numpy(a) for a in weights(N, 32, rng)) for N in (16, 8)]
    x = torch.from_numpy(bf16_x(2, 32, rng)).to(torch.bfloat16)
    before = im.launches
    im.int8_gemv_group(x, members)
    assert im.launches == before
    with pytest.raises(ValueError, match="no int8 GEMV kernel"):
        im.int8_gemv_group(x.to("meta"), [(q.to("meta"), s.to("meta")) for q, s in members])


# -- the model's projections ---------------------------------------------------------


@pytest.mark.parametrize("seq", [1, S])
@pytest.mark.parametrize("w8a8", [False, True])
def test_quantized_block_groups_shared_inputs(monkeypatch, seq, w8a8):
    """A quantized forward sends q/k/v and gate/up through one grouped call
    a layer each (two a layer) and wo and w_down alone; its logits equal,
    bit for bit, those of the same forward with every projection a
    separate int8_linear call. Under W8A8 a multi-token forward takes
    int8_linear_group's per-member W8A8 route, a decode step the GEMV."""
    import dataclasses

    _, _, model = carried_weights()
    qmodel = tq.quantize_model(model, dataclasses.replace(model.cfg, w8a8_prefill=w8a8))
    cfg = qmodel.cfg
    rng = np.random.default_rng(seq)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int64))
    pads = torch.zeros(B, dtype=torch.int32)
    pos = tl.prefill_positions(pads, seq)
    mask = tl.prefill_attention_mask(pads, seq, seq)

    def forward():
        cache = tl.init_kv_cache(cfg, B, seq, device="cpu")
        return qmodel(toks, pos, cache, 0, mask)

    calls = []
    grouped = im.int8_linear_group
    monkeypatch.setattr(tl, "int8_linear_group",
                        lambda x, members, aq=False: calls.append(len(members))
                        or grouped(x, members, aq))
    got = forward()
    assert calls == [3, 2] * cfg.n_layers
    monkeypatch.setattr(tl, "int8_linear_group",
                        lambda x, members, aq=False: [im.int8_linear(x, q, s, aq)
                                                      for q, s in members])
    assert torch.equal(got, forward())
