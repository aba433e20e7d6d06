"""The port's training slice on one rank (``vnsum_tpu_torch.train``,
``forward_train`` in ``vnsum_tpu_torch/models/llama.py``) against the JAX
package's, on the same weights and batches.

Weights come from the JAX package's ``init_params`` (the carried, scaled-up
set of ``test_torch_models_llama.carried_weights`` where logits must be
O(1)) and cross to the port as numpy; batches come from numpy generators
with fixed seeds. Everything runs in f32 on the CPU, so the two sides
differ by summation order only: losses and every leaf's gradient within
rtol 1e-4, atol 1e-5; an optimizer update within rtol 1e-5, atol 1e-7;
parameters after five steps at lr 5e-3 within rtol 1e-4, atol 1e-4 = lr /
50 (AdamW divides by sqrt(nu): an element whose gradient sits near zero
takes a step near lr whatever the gradient's size, so the two sides'
last-bit differences in such a gradient move its parameter by a share of
lr, not of the gradient). Two configs: Llama's, and one with every
block option the cache-free path takes (QK norm, sandwich and plus-one
norms, GeGLU, the embedding scale, a query scale, an untied head).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vnsum_tpu.models import llama as jl
from vnsum_tpu.parallel import make_mesh as jax_mesh
from vnsum_tpu.train import TrainConfig as JaxTrainConfig
from vnsum_tpu.train import Trainer as JaxTrainer
from vnsum_tpu.train import lm_loss as jax_lm_loss
from vnsum_tpu_torch.models import llama as tl
from vnsum_tpu_torch.parallel import make_mesh
from vnsum_tpu_torch.parallel.autograd import copy_to_group, reduce_from_group
from vnsum_tpu_torch.parallel.mesh import Mesh
from vnsum_tpu_torch.parallel.seq import SeqGroup
from vnsum_tpu_torch.train import TrainCheckpointer, TrainConfig, Trainer, lm_loss
from vnsum_tpu_torch.train.trainer import AdamW

from test_torch_models_llama import carried_weights
from test_torch_ops_flash import one_torch_thread  # noqa: F401

CONFIGS = {
    "llama": {},
    "gemma_like": dict(qk_norm=True, sandwich_norms=True, norm_plus_one=True, act="gelu_tanh",
                       embed_scale=True, query_scale=32.0, tie_embeddings=False),
}
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def batch(seed: int, B: int = 2, S: int = 16, vocab: int = 384, p_mask: float = 0.25):
    """(tokens [B, S] int32, loss mask [B, S] bool with about p_mask of it off)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, size=(B, S), dtype=np.int32),
            rng.random((B, S)) >= p_mask)


def trainable(model: tl.LlamaModel) -> tl.LlamaModel:
    return tl.LlamaModel(model.cfg, {k: v for k, v in model.tree().items()}, trainable=True)


def leaves(tree: dict, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def port_grads(model: tl.LlamaModel) -> dict:
    out = {k: getattr(model, k).grad for k in ("embed", "final_norm", "lm_head")
           if getattr(model, k, None) is not None}
    out["layers"] = {k: v.grad for k, v in model.layers.items()}
    return out


def assert_trees_close(jax_tree: dict, port_tree: dict, **tol) -> None:
    got = dict(leaves(port_tree))
    for path, want in leaves(jax_tree):
        np.testing.assert_allclose(got[path].detach().numpy(), np.asarray(want),
                                   err_msg="/".join(path), **tol)


@pytest.fixture(scope="module")
def carried():
    return {name: carried_weights(5, **kw) for name, kw in CONFIGS.items()}


def cpu_mesh():
    return make_mesh({}, device="cpu")


def plain_tree(seed: int = 0, **kw) -> dict:
    """The JAX package's unscaled init (normal * 0.02) as numpy."""
    return jax.tree.map(np.asarray, jl.init_params(jax.random.key(seed), jl.tiny_llama(**kw)))


# -- (a) the training forward ------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_train_matches_jax(carried, name, remat):
    jcfg, params, model = carried[name]
    tokens, _ = batch(0)
    want = jl.forward_train(params, jcfg, jnp.asarray(tokens), remat=remat)
    got = tl.forward_train(trainable(model), torch.from_numpy(tokens), remat=remat)
    assert got.dtype == torch.float32 and got.shape == (2, 16, 384)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_train_matches_cached_forward(carried, name):
    """The counterpart of test_forward_train_matches_cached_forward: the
    cache-free forward against the port's own cached forward from slot 0."""
    _, _, model = carried[name]
    tokens = torch.arange(16, dtype=torch.int32).reshape(2, 8) + 3
    train = tl.forward_train(model, tokens, remat=False)
    pad = torch.zeros((2,), dtype=torch.int32)
    cache = tl.init_kv_cache(model.cfg, 2, 8, device="cpu")
    inf = model(tokens, tl.prefill_positions(pad, 8), cache, 0, tl.prefill_attention_mask(pad, 8, 8))
    np.testing.assert_allclose(train.numpy(), inf.numpy(), rtol=2e-4, atol=2e-4)


def test_forward_train_refuses_sliding_window():
    cfg = tl.tiny_llama(sliding_window=8)
    model = tl.init_model(cfg, 0, "cpu")
    with pytest.raises(NotImplementedError, match="sliding-window .* not supported on the "
                                                  "cache-free train/ring path"):
        tl.forward_train(model, torch.zeros((1, 4), dtype=torch.int32))


def test_trainable_model_refuses_int8_leaves():
    from vnsum_tpu_torch.models.quant import quantize_model

    q = quantize_model(tl.init_model(tl.tiny_llama(), 0, "cpu"))
    with pytest.raises(ValueError, match="int8 leaf cannot be trained"):
        tl.LlamaModel(q.cfg, q.tree(), trainable=True)
    with pytest.raises(ValueError, match="bf16 or f32 weights"):
        tl.forward_train(q, torch.zeros((1, 4), dtype=torch.int32))


def test_inference_model_stays_frozen(carried):
    _, _, model = carried["llama"]
    assert not any(p.requires_grad for p in model.parameters())
    assert all(p.requires_grad for p in trainable(model).parameters())


# -- (b) the loss and its gradients ------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_every_gradient_match_jax(carried, name, remat):
    jcfg, params, model = carried[name]
    tokens, mask = batch(1)
    want_loss, want_grads = jax.value_and_grad(jax_lm_loss)(
        params, jcfg, jnp.asarray(tokens), jnp.asarray(mask), remat=remat)
    m = trainable(model)
    loss = lm_loss(m, torch.from_numpy(tokens), torch.from_numpy(mask), remat=remat)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **GRAD_TOL)
    assert_trees_close(want_grads, port_grads(m), **GRAD_TOL)


def test_all_false_mask_gives_zero_loss_and_gradients(carried):
    jcfg, params, model = carried["llama"]
    tokens, _ = batch(2)
    mask = np.zeros_like(tokens, dtype=bool)
    want = jax_lm_loss(params, jcfg, jnp.asarray(tokens), jnp.asarray(mask), remat=False)
    m = trainable(model)
    loss = lm_loss(m, torch.from_numpy(tokens), torch.from_numpy(mask), remat=False)
    loss.backward()
    assert float(want) == 0.0 and loss.item() == 0.0
    assert all(not p.grad.any() for p in m.parameters())


def test_loss_mask_excludes_positions():
    """The counterpart of test_loss_mask_excludes_positions."""
    model = trainable(tl.init_model(tl.tiny_llama(), 0, "cpu"))
    tokens = torch.ones((1, 8), dtype=torch.int32) * 5
    full = lm_loss(model, tokens, torch.ones_like(tokens, dtype=torch.bool), remat=False)
    none = lm_loss(model, tokens, torch.zeros_like(tokens, dtype=torch.bool), remat=False)
    assert none.item() == 0.0
    assert full.item() > 0.0


# -- (c) the optimizer ------------------------------------------------------------------------


def optimizer_case(case: str):
    """(params, gradients as numpy trees, grad_clip): gradients of global
    norm above the clip, below it, or exactly on it (a 3-4-5 triangle)."""
    rng = np.random.default_rng(7)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    if case == "boundary":
        a = np.zeros((4, 3), np.float32)
        a[1, 2] = 3.0
        b = np.zeros((5,), np.float32)
        b[3] = 4.0
        return params, [{"a": a, "b": b}] * 3, 5.0
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    return params, grads, {"clipped": 1.0, "unclipped": 100.0}[case]


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("case", ["clipped", "unclipped", "boundary"])
def test_adamw_update_matches_optax(case, steps):
    params, grads, clip = optimizer_case(case)
    kw = dict(lr=3e-2, b1=0.9, b2=0.95, weight_decay=0.1)
    tx = optax.chain(optax.clip_by_global_norm(clip),
                     optax.adamw(kw["lr"], b1=kw["b1"], b2=kw["b2"],
                                 weight_decay=kw["weight_decay"]))
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = AdamW([{"params": [tp["a"]], "sharded": True}, {"params": [tp["b"]], "sharded": False}],
                grad_clip=clip, **kw)
    for g in grads[:steps]:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k].copy())
        opt.step()
    assert opt.count == steps
    for k in tp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(opt.state[tp[k]]["mu"].numpy(),
                                   np.asarray(state[1][0].mu[k]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(opt.state[tp[k]]["nu"].numpy(),
                                   np.asarray(state[1][0].nu[k]), rtol=1e-5, atol=1e-7)


# -- (d) the one-rank trainer ---------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
def test_trainer_matches_jax_trainer(remat):
    """Five steps' losses and the final parameters against JAX's Trainer on
    a one-device mesh, both started from the same parameters."""
    tree = plain_tree(3)
    tc = dict(learning_rate=5e-3, remat=remat)
    jt = JaxTrainer(jl.tiny_llama(), jax_mesh({"data": 1}, platform="cpu"),
                    JaxTrainConfig(**tc), params=jax.tree.map(jnp.asarray, tree))
    pt = Trainer(tl.tiny_llama(), cpu_mesh(), TrainConfig(**tc), params=tree)
    for i in range(5):
        tokens, mask = batch(10 + i, B=4)
        np.testing.assert_allclose(pt.step(tokens, mask), jt.step(tokens, mask), **GRAD_TOL)
    assert pt.step_count == jt.step_count == 5
    assert_trees_close(jt.params, pt.params, rtol=1e-4, atol=1e-4)


def test_trainer_trains_a_bf16_model():
    """The card's dtype on the CPU: a bf16 tree trains and its loss falls."""
    import dataclasses

    cfg = dataclasses.replace(tl.tiny_llama(), dtype=torch.bfloat16)
    t = Trainer(cfg, cpu_mesh(), TrainConfig(learning_rate=5e-3, remat=True), seed=1)
    tokens, _ = batch(4, B=2)
    losses = [t.step(tokens) for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert t.params["layers"]["wq"].dtype == torch.bfloat16
    assert t.opt_state["mu"]["layers"]["wq"].dtype == torch.bfloat16


def test_trainer_owns_its_parameters():
    """The trainer updates its own copy: the model it was given keeps its
    weights."""
    source = tl.init_model(tl.tiny_llama(), 4, "cpu")
    before = source.layers["wq"].clone()
    t = Trainer(tl.tiny_llama(), cpu_mesh(), TrainConfig(learning_rate=5e-3, remat=False),
                params=source)
    t.step(batch(5)[0])
    assert torch.equal(source.layers["wq"], before)
    assert not torch.equal(t.params["layers"]["wq"], before)


# -- (f) refusals ---------------------------------------------------------------------------------


def view(shape: dict, device="cpu") -> Mesh:
    """A rank's view of a mesh of ``shape`` without its process groups: what
    the trainer's checks read before any collective."""
    return Mesh(shape, {ax: 0 for ax in shape}, torch.device(device))


@pytest.mark.parametrize("shape,match", [({"data": 2}, "fsdp' axis"),
                                         ({"fsdp": 4, "data": 2}, "not divisible")])
def test_fsdp_requires_axis_and_divisibility(shape, match):
    """The counterpart of test_fsdp_requires_axis_and_divisibility, in JAX's
    words."""
    with pytest.raises(ValueError, match=match):
        Trainer(tl.tiny_llama(), view(shape), TrainConfig(fsdp=True))


@pytest.mark.parametrize("kw,shape", [(dict(fsdp=True), {"fsdp": 2, "data": 1}),
                                      (dict(context_parallel=True), {"seq": 2})])
def test_a12b_options_raise_by_name(kw, shape):
    """Each option builds on a one-rank view of a mesh with its axis, and
    its step refuses a shape that does not divide over the axis before any
    collective: the batch in the JAX trainer's words, the sequence naming
    its axis."""
    t = Trainer(tl.tiny_llama(), view(shape), TrainConfig(remat=False, **kw))
    if kw.get("fsdp"):
        bad, match = (3, 8), r"batch size 3 must be divisible by data×fsdp mesh axes \(2\)"
    else:
        bad, match = (2, 15), r"sequence length 15 must be divisible by the seq mesh axis \(2\)"
    with pytest.raises(ValueError, match=match):
        t.step(np.zeros(bad, np.int32))


def test_batch_must_divide_over_data():
    t = Trainer(tl.tiny_llama(), view({"data": 2}), TrainConfig(remat=False))
    with pytest.raises(ValueError, match=r"batch size 3 must be divisible by data mesh axes \(2\)"):
        t.step(np.zeros((3, 8), np.int32))


def test_trainer_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal needs a machine without one")
    with pytest.raises(RuntimeError, match="no CUDA card is visible"):
        Trainer(tl.tiny_llama(), view({}, device="cuda"))


def test_collectives_are_the_identity_on_one_rank():
    x = torch.randn(3, requires_grad=True)
    assert copy_to_group(x, SeqGroup()) is x
    assert reduce_from_group(x, SeqGroup()) is x


# -- (g) checkpoints (the counterparts of tests/test_train_checkpoint.py) --------------


def train_tokens(seed: int):
    return np.random.default_rng(seed).integers(0, 384, size=(4, 32), dtype=np.int32)


def test_save_restore_resumes_bit_exact(tmp_path):
    tc = TrainConfig(remat=False)
    a = Trainer(tl.tiny_llama(), cpu_mesh(), tc, seed=7)
    a.step(train_tokens(0))
    a.step(train_tokens(1))
    ckpt = TrainCheckpointer(tmp_path / "ckpt")
    assert ckpt.save(a) == 2
    loss_a = a.step(train_tokens(2))
    b = Trainer(tl.tiny_llama(), cpu_mesh(), tc, seed=99)
    assert ckpt.restore(b) == 2
    assert b.step(train_tokens(2)) == loss_a
    ckpt.close()


def test_restore_latest_and_specific_step(tmp_path):
    t = Trainer(tl.tiny_llama(), cpu_mesh(), TrainConfig(remat=False), seed=3)
    ckpt = TrainCheckpointer(tmp_path / "ckpt2", max_to_keep=2)
    for i in range(3):
        t.step(train_tokens(i))
        ckpt.save(t)
    assert ckpt.latest_step() == 3
    assert ckpt.all_steps() == [2, 3]  # max_to_keep dropped step 1
    t2 = Trainer(tl.tiny_llama(), cpu_mesh(), TrainConfig(remat=False), seed=4)
    assert ckpt.restore(t2, step=2) == 2
    assert t2.step_count == 2 and t2.optimizer.count == 2
    ckpt.close()


def test_restore_missing_raises(tmp_path):
    t = Trainer(tl.tiny_llama(), cpu_mesh(), TrainConfig(remat=False), seed=5)
    ckpt = TrainCheckpointer(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        ckpt.restore(t)
    ckpt.close()


def test_restored_state_in_place(tmp_path):
    """The counterpart of test_restored_shardings_preserved: every parameter
    and moment is restored into the trainer's own tensors, bit for bit."""
    t = Trainer(tl.tiny_llama(), cpu_mesh(), TrainConfig(remat=False), seed=6)
    t.step(train_tokens(0))
    ckpt = TrainCheckpointer(tmp_path / "ckpt3")
    ckpt.save(t)
    t2 = Trainer(tl.tiny_llama(), cpu_mesh(), TrainConfig(remat=False), seed=8)
    ptrs = [p.data_ptr() for p in t2.model.parameters()]
    ckpt.restore(t2)
    assert [p.data_ptr() for p in t2.model.parameters()] == ptrs
    for tree in ("params", "mu", "nu"):
        a = t.params if tree == "params" else t.opt_state[tree]
        b = t2.params if tree == "params" else t2.opt_state[tree]
        for (pa, x), (pb, y) in zip(leaves(a), leaves(b)):
            assert pa == pb and torch.equal(x, y), pa
    ckpt.close()
