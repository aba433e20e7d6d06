"""The port's mesh wrappers of K1 and K2 (``vnsum_tpu_torch/ops/sharded.py``)
against the JAX package's ``sharded_flash_prefill`` / ``sharded_flash_decode``
on a ``{"data": 2, "model": 2}`` CPU mesh with the kernels in interpret
mode. The port's wrappers run in-process on each (data, model) shard (their
kernels' plain versions: CPU tensors) and the shards are joined along the
batch and the heads. Inputs come from numpy with a seed; f32 queries, so
only summation order differs: 1e-5. Cache lengths are multiples of 128
(ROADMAP §C: interpret mode pads a ragged block with NaN).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnsum_tpu.models.llama import _quantize_kv
from vnsum_tpu.ops import sharded as js
from vnsum_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vnsum_tpu_torch.ops import flash_attention as fa
from vnsum_tpu_torch.ops import sharded as ts
from vnsum_tpu_torch.parallel import SeqGroup
from vnsum_tpu_torch.parallel.mesh import Mesh

from test_torch_ops_flash import one_torch_thread  # noqa: F401

D, M = 2, 2                       # data and model ranks
L, B, KV, G, HD = 2, 4, 4, 2, 16  # B rows over data, KV heads over model
H = KV * G
TOL = 1e-5


def shard_mesh(i: int, j: int) -> Mesh:
    """Rank (i, j)'s view; placeholders stand for the process groups (the
    wrappers issue no collective)."""
    return Mesh({"data": D, "model": M, "seq": 1}, {"data": i, "model": j, "seq": 0},
                torch.device("cpu"),
                {"data": SeqGroup(i, D, object()), "model": SeqGroup(j, M, object())})


def make_inputs(S: int, C: int, seed: int, quantized: bool):
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
    return q, jc, {n: torch.from_numpy(np.array(a)) for n, a in jc.items()}


def per_shard(fn, q, cache, pads):
    """fn(mesh, q, cache, pads) on every (data, model) shard, joined."""
    Bl, Hl, KVl = B // D, H // M, KV // M
    rows = []
    for i in range(D):
        heads = []
        for j in range(M):
            b, h, kv = slice(i * Bl, (i + 1) * Bl), slice(j * Hl, (j + 1) * Hl), \
                slice(j * KVl, (j + 1) * KVl)
            c = {n: t[:, b, kv].contiguous() for n, t in cache.items()}
            heads.append(fn(shard_mesh(i, j), torch.from_numpy(q[b, :, h].copy()), c, pads[b]))
        rows.append(torch.cat(heads, dim=2))
    return torch.cat(rows, dim=0)


# (S, C, q_offset, window): whole prompts, a window, a chunk at q_offset > 0
PREFILL = [(128, 128, 0, 0), (128, 128, 0, 8), (64, 256, 128, 0), (64, 256, 96, 24)]


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("S,C,q_offset,window", PREFILL)
def test_sharded_prefill_matches_jax(quantized, S, C, q_offset, window):
    q, jc, tc = make_inputs(S, C, S + C + q_offset + window, quantized)
    # ragged pads; row 3 is an all-pad filler that sees no key
    pads = np.array([0, 13, 70, q_offset + S], np.int32)
    jmesh = jax_make_mesh({"data": D, "model": M}, platform="cpu")
    want = js.sharded_flash_prefill(jmesh, jnp.asarray(q), jc, 1, jnp.asarray(pads), G,
                                    window, q_offset, interpret=True)
    calls, launches = ts.prefill_calls, fa.launches
    got = per_shard(lambda mesh, qs, c, p: ts.sharded_flash_prefill(
        mesh, qs, c, 1, p, G, window, q_offset), q, tc, torch.from_numpy(pads))
    assert ts.prefill_calls == calls + D * M and fa.launches == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


# (C, fill, window): fills inside the cache and at its end, a window
DECODE = [(128, 90, 0), (256, 255, 0), (256, 200, 40)]


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("C,fill,window", DECODE)
def test_sharded_decode_matches_jax(quantized, C, fill, window):
    from vnsum_tpu_torch.ops import decode_attention as da

    q, jc, tc = make_inputs(1, C, C + fill + window, quantized)
    pads = np.array([0, 5, 33, 17], np.int32)
    jmesh = jax_make_mesh({"data": D, "model": M}, platform="cpu")
    want = js.sharded_flash_decode(jmesh, jnp.asarray(q), jc, 0, jnp.asarray(pads), fill, G,
                                   window, interpret=True)
    calls, launches = ts.decode_calls, da.launches
    got = per_shard(lambda mesh, qs, c, p: ts.sharded_flash_decode(
        mesh, qs, c, 0, p, fill, G, window), q, tc, torch.from_numpy(pads))
    assert ts.decode_calls == calls + D * M and da.launches == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_inconsistent_shards_raise():
    q, _, tc = make_inputs(8, 128, 0, False)
    pads = torch.zeros(B // D, dtype=torch.int32)
    qs = torch.from_numpy(q[: B // D, :, : H // M].copy())
    # a cache of every KV head beside queries of half the heads
    with pytest.raises(ValueError, match="not GQA group"):
        ts.sharded_flash_prefill(shard_mesh(0, 0), qs, {n: t[:, : B // D] for n, t in tc.items()},
                                 0, pads, G)
    # a cache of the whole batch beside a data shard's queries
    with pytest.raises(ValueError, match="shard mismatch"):
        ts.sharded_flash_decode(shard_mesh(0, 0), qs[:, :1],
                                {n: t[:, :, : KV // M] for n, t in tc.items()}, 0, pads, 5, G)
