"""The port's partition specs and shards (``vnsum_tpu_torch/parallel/sharding.py``)
against the JAX package's: ``param_specs`` for every combination of its five
flags and ``cache_specs`` as per-dim axis tuples, the divisibility error of
``shard_params`` word for word, and shards of carried tiny trees (bf16-free
f32 and int8; Qwen3's QK norms, Gemma3's sandwich norms and an untied head)
that concatenate back to the whole bit for bit. Shards are cut in-process
for each model coordinate (slicing issues no collective).
"""
from __future__ import annotations

import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from vnsum_tpu.parallel import sharding as js
from vnsum_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vnsum_tpu_torch.models import llama as tl
from vnsum_tpu_torch.models.quant import _CONTRACT_AXES, quantize_model
from vnsum_tpu_torch.parallel import SeqGroup
from vnsum_tpu_torch.parallel import sharding as ts
from vnsum_tpu_torch.parallel.mesh import Mesh

from test_torch_models_llama import carried_weights

FLAGS = ("tie_embeddings", "quantized", "fsdp", "qk_norm", "sandwich_norms")


def as_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("flags", list(itertools.product([False, True], repeat=5)),
                         ids=lambda f: "-".join(n for n, on in zip(FLAGS, f) if on) or "none")
def test_param_specs_match_jax(flags):
    kw = dict(zip(FLAGS, flags))
    assert ts.param_specs(**kw) == as_tuples(js.param_specs(**kw))


@pytest.mark.parametrize("quantized", [False, True])
def test_cache_and_batch_specs_match_jax(quantized):
    assert ts.cache_specs(quantized) == as_tuples(js.cache_specs(quantized))
    assert ts.batch_spec() == tuple(js.batch_spec())


def fake_mesh(m: int, j: int) -> Mesh:
    """Rank j's view of a model axis of m ranks; no process group is
    formed (a placeholder stands for it: slicing issues no collective)."""
    groups = {"model": SeqGroup(j, m, object())} if m > 1 else {}
    return Mesh({"data": 1, "model": m, "seq": 1}, {"data": 0, "model": j, "seq": 0},
                torch.device("cpu"), groups)


@pytest.mark.parametrize("m,quantized", [(3, False), (4, False), (4, True), (8, True)])
def test_divisibility_error_matches_jax(m, quantized):
    """tiny_llama (4/2 heads, hidden 128, vocab 384): the first leaf that
    does not divide, in JAX's tree order, named with its dim and axis."""
    jcfg, params, model = carried_weights(0)
    if quantized:
        from vnsum_tpu.models.quant import quantize_params

        params = quantize_params(params)
        model = quantize_model(model)
    with pytest.raises(ValueError) as want:
        js.shard_params(params, jax_make_mesh({"model": m}, platform="cpu"))
    with pytest.raises(ValueError) as got:
        ts.shard_params(model, fake_mesh(m, 0))
    assert str(got.value) == str(want.value)
    assert "is not divisible by mesh axis 'model'" in str(got.value)


# name -> tiny_llama keywords: Llama (tied), Qwen3-like, Gemma3-like (untied)
CONFIGS = {
    "llama": {},
    "qwen": dict(qk_norm=True),
    "gemma": dict(qk_norm=True, sandwich_norms=True, norm_plus_one=True, act="gelu_tanh",
                  tie_embeddings=False, n_layers=3, sliding_window=8,
                  layer_is_global=(False, True, False)),
}


def shard_dims(name: str, quantized: bool) -> tuple:
    """(q's dim, s's dim or None) along which the model's leaf ``name`` is
    split, read off the spec and the stored layout."""
    spec = ts.param_specs(False, False, qk_norm=True, sandwich_norms=True)
    spec = spec.get(name) or spec["layers"].get(name)
    if "model" not in spec:
        return None, None
    dim = spec.index("model")
    qdim = ts._stored_dim(name, dim, quantized)
    if not quantized:
        return qdim, None
    if name in ("embed", "lm_head"):
        return qdim, 0
    return qdim, (None if dim - 1 in _CONTRACT_AXES[name] else 1)


def flat(tree: dict) -> dict:
    out = {k: v for k, v in tree.items() if k != "layers"}
    out.update(tree["layers"])
    return out


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_shards_concatenate_to_the_whole(cfg_name, quantized):
    """Each model coordinate's shard, by shard_params and by the carry's
    params_from_numpy(mesh=), joined along its sharded dim, is the whole
    model bit for bit; replicated leaves are the whole's own."""
    m = 2
    jcfg, params, whole = carried_weights(1, **CONFIGS[cfg_name])
    tree = jax.tree.map(np.asarray, params)
    if quantized:
        from vnsum_tpu.models.quant import quantize_params

        tree = jax.tree.map(np.asarray, quantize_params(params))
        whole = quantize_model(whole)
    cfg = whole.cfg
    shards = [ts.shard_params(whole, fake_mesh(m, j)) for j in range(m)]
    carried = [tl.params_from_numpy(tree, cfg, device="cpu", mesh=fake_mesh(m, j))
               for j in range(m)]
    for j, s in enumerate(shards):
        assert s.tp.rank == j and s.tp.world == m
    want = flat(whole.tree())
    for parts in ([flat(s.tree()) for s in shards], [flat(c.tree()) for c in carried]):
        for name, w in want.items():
            qdim, sdim = shard_dims(name, isinstance(w, dict))
            if not isinstance(w, dict):
                got = parts[0][name] if qdim is None else torch.cat([p[name] for p in parts], qdim)
                torch.testing.assert_close(got, w, rtol=0, atol=0)
                continue
            q = torch.cat([p[name]["q"] for p in parts], qdim)
            s = parts[0][name]["s"] if sdim is None else torch.cat(
                [p[name]["s"] for p in parts], sdim)
            torch.testing.assert_close(q, w["q"], rtol=0, atol=0)
            torch.testing.assert_close(s, w["s"], rtol=0, atol=0)
            if sdim is None:  # a replicated scale is the same on every rank
                assert all(torch.equal(p[name]["s"], w["s"]) for p in parts)


def test_one_rank_model_axis_shares_the_tensors():
    _, _, whole = carried_weights(0)
    shard = ts.shard_params(whole, fake_mesh(1, 0))
    for (name, a), b in zip(whole.named_parameters(), shard.parameters()):
        assert a.data_ptr() == b.data_ptr(), name
    assert shard.tp.world == 1


def test_shard_shapes_are_the_local_head_counts():
    _, _, whole = carried_weights(0, **CONFIGS["gemma"])
    shard = ts.shard_params(whole, fake_mesh(2, 1))
    cfg = whole.cfg
    assert tuple(shard.layers["wq"].shape) == (cfg.n_layers, cfg.dim, cfg.n_heads // 2,
                                               cfg.head_dim)
    assert tuple(shard.layers["wk"].shape)[2] == cfg.n_kv_heads // 2
    assert tuple(shard.layers["w_down"].shape)[1] == cfg.intermediate // 2
    assert tuple(shard.lm_head.shape) == (cfg.dim, cfg.vocab_size // 2)
    assert tuple(shard.embed.shape) == (cfg.vocab_size // 2, cfg.dim)
    assert shard.layers["q_norm"].data_ptr() == whole.layers["q_norm"].data_ptr()
