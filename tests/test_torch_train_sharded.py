"""The port's trainer over a mesh of gloo ranks against the JAX package's
Trainer on a CPU mesh of the same shape.

Each mesh shape, (data, model) = (2, 1), (1, 2) and (2, 2), is one spawn
of that many CPU processes joined over gloo (``file://`` rendezvous, one
torch thread each, each joined with a 120 s limit, as
``tests/test_torch_engine_sharded.py`` does); the pytest process never
joins a group. Every rank runs its mesh's cases on the global batches
and saves what it got (its shards, its losses); the parametrised tests
here gather the shards and compare with the JAX side, which runs in this
process. Everything is f32: losses and gradients within rtol 1e-4, atol
1e-5, parameters after three steps at lr 5e-3 within rtol 1e-4, atol 1e-4
(``tests/test_torch_train.py`` says why). Every rank returns the same
loss, bit for bit, and holds the same replicated leaves.

The cases: one gradient of the loss on the carried (scaled-up) weights,
gathered, against ``jax.value_and_grad(lm_loss)``; three trainer steps,
on Llama's config and (with ``model`` = 2) on one with QK norm, sandwich
and plus-one norms, whose per-head norm weights meet the local heads; a
loss mask that gives the two data ranks different counts; the batch
divisibility error; and, on (2, 2), the counterparts of the four cases of
``tests/test_train_checkpoint.py``, with remat on.
"""
from __future__ import annotations

import multiprocessing
import os
import traceback

import numpy as np
import pytest
import torch

JOIN_S = 120
LR = 5e-3
STEPS = 3
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
# the tiny configs (tiny_llama's keywords)
CONFIGS = {
    "llama": {},
    "gemma_like": dict(qk_norm=True, sandwich_norms=True, norm_plus_one=True,
                       act="gelu_tanh", embed_scale=True, tie_embeddings=False),
}
# (data, model) of each spawn, and the cases its ranks run
MESHES = {
    "dp": ({"data": 2, "model": 1}, ("grads", "steps", "uneven", "indivisible")),
    "tp": ({"data": 1, "model": 2}, ("grads", "steps", "gemma")),
    "dp_tp": ({"data": 2, "model": 2},
              ("grads", "steps", "uneven", "gemma", "indivisible", "ckpt_resume",
               "ckpt_steps", "ckpt_missing", "ckpt_in_place")),
}


def batches(n: int = STEPS, B: int = 4, S: int = 16, uneven: bool = False) -> list:
    """``n`` global (tokens, loss mask) batches; ``uneven`` leaves the last
    two rows (the second data rank's) three counted positions each."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        tokens = rng.integers(0, 384, size=(B, S), dtype=np.int32)
        mask = rng.random((B, S)) >= 0.2
        if uneven:
            mask[:2] = True
            mask[2:] = False
            mask[2:, 4:7] = True
        out.append((tokens, mask))
    return out


# -- the ranks ---------------------------------------------------------------------------


def _trainer(mesh, tree, config="llama", remat=False, seed=0):
    """A trainer on ``tree`` (a whole numpy tree; None: drawn from ``seed``)."""
    from vnsum_tpu_torch.models.llama import tiny_llama
    from vnsum_tpu_torch.train import TrainConfig, Trainer

    return Trainer(tiny_llama(**CONFIGS[config]), mesh,
                   TrainConfig(learning_rate=LR, remat=remat), params=tree, seed=seed)


def _local(trainer) -> dict:
    return {"/".join(path): p.detach().clone() for path, p, _ in trainer.leaves()}


def _run_steps(trainer, uneven=False) -> dict:
    losses = [trainer.step(t, m) for t, m in batches(uneven=uneven)]
    return {"losses": losses, "params": _local(trainer)}


def case_grads(mesh, payload, tmp):
    """One backward of the global loss on the carried weights: this rank's
    shard of every leaf's gradient, summed over data as the trainer does."""
    from vnsum_tpu_torch.parallel.sharding import data_rows
    from vnsum_tpu_torch.train import lm_loss

    t = _trainer(mesh, payload["carried"])
    tokens, mask = batches(1)[0]
    lo, hi = data_rows(t.data, tokens.shape[0])
    loss = lm_loss(t.model, torch.from_numpy(tokens[lo:hi]), torch.from_numpy(mask[lo:hi]),
                   remat=True, data=t.data)
    loss.backward()
    grads = {}
    for path, p, _ in t.leaves():
        grads["/".join(path)] = t.data.all_reduce_sum(p.grad).clone()
    return {"loss": loss.item(), "grads": grads}


def case_steps(mesh, payload, tmp):
    return _run_steps(_trainer(mesh, payload["llama"], remat=mesh.shape["data"] > 1))


def case_uneven(mesh, payload, tmp):
    return _run_steps(_trainer(mesh, payload["llama"]), uneven=True)


def case_gemma(mesh, payload, tmp):
    return _run_steps(_trainer(mesh, payload["gemma_like"], "gemma_like", remat=True))


def case_indivisible(mesh, payload, tmp):
    try:
        _trainer(mesh, payload["llama"]).step(np.zeros((3, 8), np.int32))
    except ValueError as e:
        return str(e)
    return None


def ckpt_tokens(seed: int):
    return np.random.default_rng(seed).integers(0, 384, size=(4, 32), dtype=np.int32)


def case_ckpt_resume(mesh, payload, tmp):
    from vnsum_tpu_torch.train import TrainCheckpointer

    a = _trainer(mesh, None, remat=True, seed=7)
    a.step(ckpt_tokens(0))
    a.step(ckpt_tokens(1))
    ckpt = TrainCheckpointer(os.path.join(tmp, "ckpt"))
    saved = ckpt.save(a)
    loss_a = a.step(ckpt_tokens(2))
    b = _trainer(mesh, None, remat=True, seed=99)
    restored = ckpt.restore(b)
    loss_b = b.step(ckpt_tokens(2))
    ckpt.close()
    return {"saved": saved, "restored": restored, "loss_a": loss_a, "loss_b": loss_b,
            "a": _local(a), "b": _local(b)}


def case_ckpt_steps(mesh, payload, tmp):
    from vnsum_tpu_torch.train import TrainCheckpointer

    t = _trainer(mesh, None, seed=3)
    ckpt = TrainCheckpointer(os.path.join(tmp, "ckpt2"), max_to_keep=2)
    for i in range(3):
        t.step(ckpt_tokens(i))
        ckpt.save(t)
    out = {"latest": ckpt.latest_step(), "all": ckpt.all_steps()}
    t2 = _trainer(mesh, None, seed=4)
    out["restored"] = ckpt.restore(t2, step=2)
    out["step_count"], out["count"] = t2.step_count, t2.optimizer.count
    ckpt.close()
    return out


def case_ckpt_missing(mesh, payload, tmp):
    from vnsum_tpu_torch.train import TrainCheckpointer

    t = _trainer(mesh, None, seed=5)
    try:
        TrainCheckpointer(os.path.join(tmp, f"empty{mesh.coords['data']}{mesh.coords['model']}")
                          ).restore(t)
    except FileNotFoundError as e:
        return str(e)
    return None


def case_ckpt_in_place(mesh, payload, tmp):
    from vnsum_tpu_torch.train import TrainCheckpointer

    t = _trainer(mesh, None, seed=6)
    t.step(ckpt_tokens(0))
    ckpt = TrainCheckpointer(os.path.join(tmp, "ckpt3"))
    ckpt.save(t)
    t2 = _trainer(mesh, None, seed=8)
    ptrs = [p.data_ptr() for p in t2.model.parameters()]
    ckpt.restore(t2)
    same = all(torch.equal(t.optimizer.state[p][k], t2.optimizer.state[q][k])
               for (_, p, _), (_, q, _) in zip(t.leaves(), t2.leaves()) for k in ("mu", "nu"))
    return {"ptrs": ptrs == [p.data_ptr() for p in t2.model.parameters()],
            "params_equal": all(torch.equal(a, b) for a, b in
                                zip(_local(t).values(), _local(t2).values())),
            "moments_equal": same, "count": t2.optimizer.count}


def _rank_main(rank: int, key: str, init_file: str, out_dir: str, payload: dict) -> None:
    """One rank: join the group, build the mesh, run the mesh's cases (a
    failure is saved as its traceback), save, leave."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from vnsum_tpu_torch.parallel import init_distributed, make_mesh

    shape, cases = MESHES[key]
    world = shape["data"] * shape["model"]
    init_distributed(f"file://{init_file}", world, rank, device="cpu", timeout_s=30)
    try:
        mesh = make_mesh(shape, device="cpu")
        out = {"coords": dict(mesh.coords)}
        for name in cases:
            try:
                out[name] = globals()[f"case_{name}"](mesh, payload, out_dir)
            except Exception:
                out[name] = {"error": traceback.format_exc()}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# -- the parent ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trees():
    """The JAX package's trees as numpy: each config's plain init and the
    carried (scaled-up) Llama weights."""
    import jax

    from vnsum_tpu.models import llama as jl

    from test_torch_models_llama import carried_weights

    out = {name: jax.tree.map(np.asarray, jl.init_params(jax.random.key(1), jl.tiny_llama(**kw)))
           for name, kw in CONFIGS.items()}
    out["carried"] = jax.tree.map(np.asarray, carried_weights(2)[1])
    return out


_SPAWNS: dict = {}


def spawned(key: str, trees, tmp_path_factory) -> list:
    """Every rank's saved results of the spawn for mesh ``key`` (run once)."""
    if key in _SPAWNS:
        return _SPAWNS[key]
    shape, _ = MESHES[key]
    world = shape["data"] * shape["model"]
    tmp = tmp_path_factory.mktemp(key)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, key, str(tmp / "rendezvous"), str(tmp), trees))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(JOIN_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"{key} ranks {hung} did not finish within {JOIN_S} s"
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert [p.exitcode for p in procs] == [0] * world
    _SPAWNS[key] = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]
    return _SPAWNS[key]


def rank_results(key: str, case: str, trees, tmp_path_factory) -> list:
    """(coords, result) of each rank for ``case``."""
    ranks = spawned(key, trees, tmp_path_factory)
    for r, res in enumerate(ranks):
        got = res[case]
        if isinstance(got, dict) and "error" in got:
            pytest.fail(f"{key} rank {r} case {case}:\n{got['error']}")
    return [(res["coords"], res[case]) for res in ranks]


def spec_of(name: str, config: str):
    from vnsum_tpu_torch.parallel.sharding import param_specs

    cfg = CONFIGS.get(config, {})
    specs = param_specs(cfg.get("tie_embeddings", True), qk_norm=cfg.get("qk_norm", False),
                        sandwich_norms=cfg.get("sandwich_norms", False))
    for k in name.split("/"):
        specs = specs[k]
    return specs


def gathered(results: list, field, config: str) -> dict:
    """The whole leaves from the ranks' shards (``field`` picks a rank's
    {name: tensor}): a leaf sharded over ``model`` is the model ranks'
    shards in order; every other leaf must be equal on every rank."""
    out = {}
    for name in field(results[0][1]):
        spec = spec_of(name, config)
        if "model" in spec:
            parts = {c["model"]: field(r)[name] for c, r in results if c["data"] == 0}
            whole = torch.cat([parts[m] for m in range(len(parts))], dim=spec.index("model"))
            for c, r in results:  # the data ranks hold the same shard
                assert torch.equal(field(r)[name], parts[c["model"]]), name
        else:
            whole = field(results[0][1])[name]
            for _, r in results:
                assert torch.equal(field(r)[name], whole), f"{name} differs across ranks"
        out[name] = whole
    return out


def assert_close_to_jax(port: dict, jax_tree: dict, **tol) -> None:
    for name, got in port.items():
        want = jax_tree
        for k in name.split("/"):
            want = want[k]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **tol)


def jax_trainer(shape: dict, config: str, trees):
    import jax
    import jax.numpy as jnp

    from vnsum_tpu.models import llama as jl
    from vnsum_tpu.parallel import make_mesh
    from vnsum_tpu.train import TrainConfig, Trainer

    return Trainer(jl.tiny_llama(**CONFIGS[config]), make_mesh(shape, platform="cpu"),
                   TrainConfig(learning_rate=LR, remat=False),
                   params=jax.tree.map(jnp.asarray, trees[config]))


def check_steps(key: str, case: str, config: str, uneven: bool, trees, tmp_path_factory):
    shape, _ = MESHES[key]
    results = rank_results(key, case, trees, tmp_path_factory)
    losses = [r["losses"] for _, r in results]
    assert all(ls == losses[0] for ls in losses), f"the ranks' losses differ: {losses}"
    jt = jax_trainer(shape, config, trees)
    want = [jt.step(t, m) for t, m in batches(uneven=uneven)]
    np.testing.assert_allclose(losses[0], want, **GRAD_TOL)
    assert_close_to_jax(gathered(results, lambda r: r["params"], config), jt.params, **PARAM_TOL)


@pytest.mark.parametrize("key", list(MESHES))
def test_gradients_match_jax(key, trees, tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from vnsum_tpu.models import llama as jl
    from vnsum_tpu.train import lm_loss

    results = rank_results(key, "grads", trees, tmp_path_factory)
    tokens, mask = batches(1)[0]
    loss, grads = jax.value_and_grad(lm_loss)(
        jax.tree.map(jnp.asarray, trees["carried"]), jl.tiny_llama(), jnp.asarray(tokens),
        jnp.asarray(mask), remat=False)
    for _, r in results:
        assert r["loss"] == results[0][1]["loss"]
    np.testing.assert_allclose(results[0][1]["loss"], float(loss), **GRAD_TOL)
    assert_close_to_jax(gathered(results, lambda r: r["grads"], "llama"), grads, **GRAD_TOL)


@pytest.mark.parametrize("key", list(MESHES))
def test_trainer_steps_match_jax(key, trees, tmp_path_factory):
    check_steps(key, "steps", "llama", False, trees, tmp_path_factory)


@pytest.mark.parametrize("key", ["dp", "dp_tp"])
def test_uneven_loss_masks_match_jax(key, trees, tmp_path_factory):
    """The data ranks' masks count 30 and 6 positions: the loss is the mean
    over the whole batch's, not the mean of the ranks' means."""
    check_steps(key, "uneven", "llama", True, trees, tmp_path_factory)


@pytest.mark.parametrize("key", ["tp", "dp_tp"])
def test_block_options_under_model_match_jax(key, trees, tmp_path_factory):
    check_steps(key, "gemma", "gemma_like", False, trees, tmp_path_factory)


@pytest.mark.parametrize("key", ["dp", "dp_tp"])
def test_batch_must_divide_over_data(key, trees, tmp_path_factory):
    for _, msg in rank_results(key, "indivisible", trees, tmp_path_factory):
        assert msg is not None and "batch size 3 must be divisible by data mesh axes (2)" in msg


def test_save_restore_resumes_bit_exact_on_a_mesh(trees, tmp_path_factory):
    for _, r in rank_results("dp_tp", "ckpt_resume", trees, tmp_path_factory):
        assert r["saved"] == r["restored"] == 2
        assert r["loss_b"] == r["loss_a"]
        assert all(torch.equal(r["a"][k], r["b"][k]) for k in r["a"])


def test_restore_latest_and_specific_step_on_a_mesh(trees, tmp_path_factory):
    for _, r in rank_results("dp_tp", "ckpt_steps", trees, tmp_path_factory):
        assert r["latest"] == 3 and r["all"] == [2, 3]
        assert r["restored"] == r["step_count"] == r["count"] == 2


def test_restore_missing_raises_on_a_mesh(trees, tmp_path_factory):
    for _, msg in rank_results("dp_tp", "ckpt_missing", trees, tmp_path_factory):
        assert msg is not None and "no checkpoints under" in msg


def test_restored_shards_in_place_on_a_mesh(trees, tmp_path_factory):
    for _, r in rank_results("dp_tp", "ckpt_in_place", trees, tmp_path_factory):
        assert r == {"ptrs": True, "params_equal": True, "moments_equal": True, "count": 1}
