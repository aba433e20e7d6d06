"""The port's ZeRO-3 (``TrainConfig(fsdp=True)``) and context-parallel
(``TrainConfig(context_parallel=True)``) training over gloo ranks against
the JAX package's Trainer with the same option on a CPU mesh of the same
shape, and the differentiable ring (``parallel/ring.py``
``ring_attention_fn``) against ``jax.grad`` of the JAX ring.

Two spawns of CPU processes joined over gloo (``file://`` rendezvous, one
torch thread each, each joined with a 120 s limit, as
``tests/test_torch_train_sharded.py`` does); the pytest process never
joins a group. Each spawn builds its meshes one after the other over the
one group, every rank runs each mesh's cases and saves what it got; the
tests here gather the shards and compare with the JAX side, which runs in
this process on its 8 CPU devices.

- ``pair``, two ranks: ``{fsdp: 2}`` (one gradient on the carried weights
  and three steps, on ``tiny_llama`` and on a 4-layer variant whose fsdp
  ranks own two layers each; an uneven loss mask, what each rank holds,
  the batch error) and then ``{seq: 2}`` (the ring's output and q/k/v
  gradients, without and with left pads, ``forward_train``'s logits under
  the ring, the same gradients and steps, the sequence error);
- ``eight``, eight ranks: ``{data: 2, model: 2, fsdp: 2}`` (the
  counterpart of ``test_fsdp_training_matches_plain``, held to both JAX
  runs, and a save and restore that resumes bit for bit) and ``{data: 2,
  model: 2, seq: 2}`` (the counterparts of
  ``test_training_with_context_parallel`` and
  ``test_forward_train_with_ring_attention_matches_dense``).

In this process: the ring on one rank against JAX's dense attention and
its gradients, ``batch_rows`` against the rows JAX's ``NamedSharding``
places on each device, and ``shard_params(fsdp=True)``'s layers.

Everything is f32: losses and gradients within rtol 1e-4, atol 1e-5,
parameters after three steps at lr 5e-3 within rtol 1e-4, atol 1e-4
(``tests/test_torch_train.py`` says why); the ring within 1e-5 and the
logits within 5e-4, the JAX tests' tolerances. Every rank returns the same
loss, bit for bit, and every copy of a shard is the same bits.

The 4-layer variant's three steps hold their losses, not their
parameters: at its plain init many gradient elements sit near AdamW's
eps (1e-8), where a last-bit difference moves the element by a share of
lr. There the one-rank trainer misses the parameter tolerance against
JAX's (2.0e-4), and JAX's own trainers differ by 1.006e-4 between a
one-device mesh and ``{fsdp: 2}``, so the parameters would not tell a
fault from that; its gradient, on carried weights, is held instead.
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
RING_TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS_TOL = dict(rtol=5e-4, atol=5e-4)
# tiny_llama's keywords: its 2 layers, and 4 so that each fsdp rank owns two
CONFIGS = {"llama": {}, "deep": dict(n_layers=4)}
# the ring case: test_ring_attention_matches_dense's shapes, query blocks,
# and each row's global left pad for the padded arm (the long prefill's use)
RING_SHAPE = dict(B=2, S=16, H=4, KV=2, hd=16)
RING_BLOCKS = (None, 3)
RING_PADS = (0, 5)
# each spawn: world, and {mesh name: (shape, cases)} built in this order
SPAWNS = {
    "pair": (2, {
        "fsdp": ({"fsdp": 2}, ("grads", "steps", "deep", "uneven", "held", "indivisible")),
        "seq": ({"seq": 2}, ("ring", "ring_pads", "logits", "grads", "steps", "deep",
                             "uneven", "indivisible")),
    }),
    "eight": (8, {
        "fsdp": ({"data": 2, "model": 2, "fsdp": 2}, ("steps", "ckpt")),
        "seq": ({"data": 2, "model": 2, "seq": 2}, ("steps", "logits")),
    }),
}
OPTION = {"fsdp": dict(fsdp=True), "seq": dict(context_parallel=True)}


def batches(n: int = STEPS, B: int = 4, S: int = 16, uneven: bool = False) -> list:
    """``n`` global (tokens, loss mask) batches; ``uneven`` counts the first
    two rows whole and the last two at positions 4-6 only."""
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


def logits_tokens() -> np.ndarray:
    """test_forward_train_with_ring_attention_matches_dense's tokens."""
    return (np.arange(32, dtype=np.int32).reshape(2, 16) * 5) % 384


def ring_inputs() -> tuple:
    """(q, k, v, dout) f32 numpy at RING_SHAPE, from a seeded generator."""
    s = RING_SHAPE
    rng = np.random.default_rng(7)
    q = rng.standard_normal((s["B"], s["S"], s["H"], s["hd"])).astype(np.float32)
    k = rng.standard_normal((s["B"], s["S"], s["KV"], s["hd"])).astype(np.float32)
    v = rng.standard_normal((s["B"], s["S"], s["KV"], s["hd"])).astype(np.float32)
    dout = rng.standard_normal(q.shape).astype(np.float32)
    return q, k, v, dout


# -- the in-test reference: autograd through the forward's loop ----------------------------


class _Shift(torch.autograd.Function):
    """``ring_shift`` with its gradient: the reverse shift (n - 1 shifts on)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return group.ring_shift(t)

    @staticmethod
    def backward(ctx, grad):
        for _ in range(ctx.group.world - 1):
            grad = ctx.group.ring_shift(grad)
        return grad, None


def reference_ring(q, k, v, G: int, group, query_block: int) -> torch.Tensor:
    """The ring's forward loop (causal, no pad) written without in-place
    writes, so that autograd runs through it, the shifts differentiable.
    It computes every block, the fully masked ones too: autograd leaves out
    a shift whose block nothing reads, and the ranks' backward shifts would
    fall out of step."""
    from vnsum_tpu_torch.ops.flash_attention import NEG

    n, idx = group.world, group.rank
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, G, hd)
    q_pos = idx * Sq + torch.arange(Sq)
    outs = []
    for lo in range(0, Sq, query_block):
        hi = min(lo + query_block, Sq)
        o = torch.zeros((B, KV, G, hi - lo, hd))
        m = torch.full((B, KV, G, hi - lo), NEG)
        l = torch.zeros((B, KV, G, hi - lo))
        k_cur, v_cur = k, v
        for i in range(n):
            k_pos = (idx - i) % n * Sq + torch.arange(Sq)
            allowed = (q_pos[lo:hi, None] >= k_pos[None, :])[None, None, None]
            s = torch.einsum("bskgh,bckh->bkgsc", qg[:, lo:hi], k_cur) / hd ** 0.5
            s = s.masked_fill(~allowed, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None]).masked_fill(~allowed, 0.0)
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + torch.einsum("bkgsc,bckh->bkgsh", p, v_cur)
            m = m_new
            if i < n - 1:
                k_cur, v_cur = _Shift.apply(k_cur, group), _Shift.apply(v_cur, group)
        outs.append(o / l[..., None])
    return torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


# -- the ranks ---------------------------------------------------------------------------


def _trainer(mesh, option: str, tree, config="llama", remat=False):
    from vnsum_tpu_torch.models.llama import tiny_llama
    from vnsum_tpu_torch.train import TrainConfig, Trainer

    return Trainer(tiny_llama(**CONFIGS[config]), mesh,
                   TrainConfig(learning_rate=LR, remat=remat, **OPTION[option]), params=tree)


def _local(trainer) -> dict:
    return {"/".join(path): p.detach().clone() for path, p, _ in trainer.leaves()}


def _run_steps(trainer, uneven=False) -> dict:
    losses = [trainer.step(t, m) for t, m in batches(uneven=uneven)]
    return {"losses": losses, "params": _local(trainer)}


def case_grads(mesh, option, payload, tmp):
    """The step's gradient of the global loss on each config's carried
    weights, this rank's shard of every leaf, as the update reads it."""
    out = {}
    for config in CONFIGS:
        t = _trainer(mesh, option, payload[f"carried_{config}"], config, remat=True)
        loss = t.backward(*batches(1)[0])
        out[config] = {"loss": loss.item(), "grads": {"/".join(path): p.grad.clone()
                                                      for path, p, _ in t.leaves()}}
    return out


def case_steps(mesh, option, payload, tmp):
    return _run_steps(_trainer(mesh, option, payload["llama"]))


def case_deep(mesh, option, payload, tmp):
    return _run_steps(_trainer(mesh, option, payload["deep"], "deep", remat=True))


def case_uneven(mesh, option, payload, tmp):
    return _run_steps(_trainer(mesh, option, payload["llama"]), uneven=True)


def case_held(mesh, option, payload, tmp):
    """The 4-layer trainer's own layers: each layer leaf and its moments."""
    t = _trainer(mesh, option, payload["deep"], "deep")
    out = {}
    for path, p, _ in t.leaves():
        st = t.optimizer.state[p]
        out["/".join(path)] = (p.detach().clone(), tuple(st["mu"].shape), tuple(st["nu"].shape))
    return out


def case_indivisible(mesh, option, payload, tmp):
    t = _trainer(mesh, option, payload["llama"])
    bad = np.zeros((3, 16) if option == "fsdp" else (2, 15), np.int32)
    try:
        t.step(bad)
    except ValueError as e:
        return str(e)
    return None


def case_ring(mesh, option, payload, tmp, pads=None):
    """This rank's output and q/k/v gradients of ring_attention_fn at each
    of RING_BLOCKS (with ``pads``, each row's global left pad), and, without
    pads, of the autograd reference."""
    from vnsum_tpu_torch.parallel.ring import ring_attention_fn

    group = mesh.group("seq")
    G = RING_SHAPE["H"] // RING_SHAPE["KV"]
    n = RING_SHAPE["S"] // group.world
    lo = group.rank * n
    q, k, v, dout = (torch.from_numpy(a[:, lo:lo + n].copy()) for a in ring_inputs())
    out = {}
    for blk in RING_BLOCKS + (("reference",) if pads is None else ()):
        qi, ki, vi = (t.clone().requires_grad_() for t in (q, k, v))
        if blk == "reference":
            o = reference_ring(qi, ki, vi, G, group, n)
        else:
            o = ring_attention_fn(qi, ki, vi, G, group, pads, query_block=blk)
        o.backward(dout)
        out[blk] = {"out": o.detach(), "dq": qi.grad, "dk": ki.grad, "dv": vi.grad}
    return out


def case_ring_pads(mesh, option, payload, tmp):
    return case_ring(mesh, option, payload, tmp, torch.tensor(RING_PADS, dtype=torch.int32))


def case_logits(mesh, option, payload, tmp):
    """forward_train under the ring: this rank's rows (over data) and slice
    of the sequence of the logits, on its shard of the model."""
    from functools import partial

    from vnsum_tpu_torch.models import llama as tl
    from vnsum_tpu_torch.parallel.ring import ring_attention_fn
    from vnsum_tpu_torch.parallel.sharding import data_rows, shard_params

    model = shard_params(tl.params_from_numpy(payload["logits"], tl.tiny_llama(), device="cpu"),
                         mesh)
    seq = mesh.group("seq")
    tokens = torch.from_numpy(logits_tokens())
    lo, hi = data_rows(mesh.group("data"), tokens.shape[0])
    n = tokens.shape[1] // seq.world
    with torch.no_grad():
        return tl.forward_train(model, tokens[lo:hi, seq.rank * n:(seq.rank + 1) * n],
                                attention_fn=partial(ring_attention_fn, group=seq),
                                remat=False, q_offset=seq.rank * n)


def case_ckpt(mesh, option, payload, tmp):
    """Two steps, a save, a third step; a trainer on other weights restored
    from the save takes the same third step."""
    from vnsum_tpu_torch.train import TrainCheckpointer

    bs = batches(3)
    a = _trainer(mesh, option, payload["deep"], "deep", remat=True)
    a.step(*bs[0])
    a.step(*bs[1])
    ckpt = TrainCheckpointer(os.path.join(tmp, "ckpt"))
    saved = ckpt.save(a)
    loss_a = a.step(*bs[2])
    b = _trainer(mesh, option, payload["deep_other"], "deep", remat=True)
    restored = ckpt.restore(b)
    loss_b = b.step(*bs[2])
    same = all(torch.equal(a.optimizer.state[p][k], b.optimizer.state[q][k])
               for (_, p, _), (_, q, _) in zip(a.leaves(), b.leaves()) for k in ("mu", "nu"))
    return {"saved": saved, "restored": restored, "loss_a": loss_a, "loss_b": loss_b,
            "a": _local(a), "b": _local(b), "moments_equal": same,
            "count": b.optimizer.count}


def _rank_main(rank: int, key: str, init_file: str, out_dir: str, payload: dict) -> None:
    """One rank: join the group, build each mesh of the spawn in turn, run
    its cases (a failure is saved as its traceback), save, leave."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from vnsum_tpu_torch.parallel import init_distributed, make_mesh

    world, meshes = SPAWNS[key]
    # eight ranks start under a loaded test run: give the rendezvous room
    init_distributed(f"file://{init_file}", world, rank, device="cpu", timeout_s=90)
    try:
        out = {}
        for option, (shape, cases) in meshes.items():
            mesh = make_mesh(shape, device="cpu")
            out[option] = {"coords": dict(mesh.coords)}
            for name in cases:
                try:
                    out[option][name] = globals()[f"case_{name}"](mesh, option, payload, out_dir)
                except Exception:
                    out[option][name] = {"error": traceback.format_exc()}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# -- the parent ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trees():
    """The JAX package's trees as numpy: each config's plain init, a second
    draw of the deep one (the restored trainer's weights before the
    restore), the carried (scaled-up) Llama weights, and the logits
    test's."""
    import jax

    from vnsum_tpu.models import llama as jl

    from test_torch_models_llama import carried_weights

    def draw(seed, **kw):
        return jax.tree.map(np.asarray, jl.init_params(jax.random.key(seed), jl.tiny_llama(**kw)))

    out = {name: draw(1, **kw) for name, kw in CONFIGS.items()}
    out["deep_other"] = draw(2, **CONFIGS["deep"])
    for name, kw in CONFIGS.items():
        out[f"carried_{name}"] = jax.tree.map(np.asarray, carried_weights(2, **kw)[1])
    out["logits"] = draw(0)
    return out


_SPAWNS: dict = {}


def spawned(key: str, trees, tmp_path_factory) -> list:
    """Every rank's saved results of spawn ``key`` (run once)."""
    if key in _SPAWNS:
        return _SPAWNS[key]
    world, _ = SPAWNS[key]
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


def rank_results(key: str, option: str, case: str, trees, tmp_path_factory) -> list:
    """(coords, result) of each rank for ``case`` on the spawn's ``option`` mesh."""
    ranks = spawned(key, trees, tmp_path_factory)
    for r, res in enumerate(ranks):
        got = res[option][case]
        if isinstance(got, dict) and "error" in got:
            pytest.fail(f"{key} rank {r} {option} case {case}:\n{got['error']}")
    return [(res[option]["coords"], res[option][case]) for res in ranks]


def spec_of(name: str, option: str) -> tuple:
    from vnsum_tpu_torch.parallel.sharding import param_specs

    specs = param_specs(True, fsdp=option == "fsdp")
    for k in name.split("/"):
        specs = specs[k]
    return specs


def assemble(blocks: dict, split: list):
    """The whole tensor from ``blocks`` keyed by the coordinates on the
    axes of ``split`` [(axis, dim), ...], concatenated in coordinate order."""
    if not split:
        return blocks[()]
    (_, dim), rest = split[0], split[1:]
    coords = sorted({key[0] for key in blocks})
    return torch.cat([assemble({key[1:]: t for key, t in blocks.items() if key[0] == c}, rest)
                      for c in coords], dim=dim)


def gathered(results: list, field, option: str) -> dict:
    """The whole leaves from the ranks' shards (``field`` picks a rank's
    {name: tensor}): each rank's shard sits at its coordinates on the axes
    the leaf's spec names, and every rank holding the same block must hold
    the same bits."""
    out = {}
    for name in field(results[0][1]):
        spec = spec_of(name, option)
        split = [(ax, d) for d, ax in enumerate(spec) if ax]
        blocks = {}
        for coords, r in results:
            key = tuple(coords[ax] for ax, _ in split)
            t = field(r)[name]
            if key in blocks:
                assert torch.equal(blocks[key], t), f"{name}: copies of block {key} differ"
            blocks[key] = t
        out[name] = assemble(blocks, split)
    return out


def assert_close_to_jax(port: dict, jax_tree: dict, **tol) -> None:
    for name, got in port.items():
        want = jax_tree
        for k in name.split("/"):
            want = want[k]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **tol)


def jax_mesh(key: str, option: str):
    from vnsum_tpu.parallel import make_mesh

    return make_mesh(SPAWNS[key][1][option][0], platform="cpu")


def jax_trainer(mesh, config: str, trees, **option):
    import jax
    import jax.numpy as jnp

    from vnsum_tpu.models import llama as jl
    from vnsum_tpu.train import TrainConfig, Trainer

    return Trainer(jl.tiny_llama(**CONFIGS[config]), mesh,
                   TrainConfig(learning_rate=LR, remat=False, **option),
                   params=jax.tree.map(jnp.asarray, trees[config]))


def check_steps(key: str, option: str, case: str, config: str, uneven: bool, trees,
                tmp_path_factory, jax_meshes=None) -> None:
    """Each rank's three losses the same bits; losses and the gathered
    parameters (the 4-layer variant's losses only: the module says why)
    against the JAX Trainer with the option on ``key``'s mesh (and against
    each mesh of ``jax_meshes`` with the option off)."""
    results = rank_results(key, option, case, trees, tmp_path_factory)
    losses = [r["losses"] for _, r in results]
    assert all(ls == losses[0] for ls in losses), f"the ranks' losses differ: {losses}"
    params = gathered(results, lambda r: r["params"], option)
    runs = [(jax_mesh(key, option), OPTION[option])]
    runs += [(m, {}) for m in jax_meshes or ()]
    for mesh, kw in runs:
        jt = jax_trainer(mesh, config, trees, **kw)
        want = [jt.step(t, m) for t, m in batches(uneven=uneven)]
        np.testing.assert_allclose(losses[0], want, **GRAD_TOL)
        if config != "deep":
            assert_close_to_jax(params, jt.params, **PARAM_TOL)


@pytest.mark.parametrize("option", ["fsdp", "seq"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_gradients_match_jax(option, config, trees, tmp_path_factory):
    """One gradient on the carried weights, gathered, against
    ``jax.value_and_grad(lm_loss)``: dense for fsdp (ZeRO-3 is layout, not
    math), through JAX's ring on a seq = 2 mesh for seq."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from vnsum_tpu.models import llama as jl
    from vnsum_tpu.parallel.ring import ring_attention
    from vnsum_tpu.train import lm_loss

    results = [(c, r[config]) for c, r in rank_results("pair", option, "grads", trees,
                                                       tmp_path_factory)]
    tokens, mask = batches(1)[0]
    attention_fn = (partial(ring_attention, mesh=jax_mesh("pair", "seq"))
                    if option == "seq" else None)
    loss, grads = jax.value_and_grad(lm_loss)(
        jax.tree.map(jnp.asarray, trees[f"carried_{config}"]), jl.tiny_llama(**CONFIGS[config]),
        jnp.asarray(tokens), jnp.asarray(mask), attention_fn=attention_fn, remat=False)
    for _, r in results:
        assert r["loss"] == results[0][1]["loss"]
    np.testing.assert_allclose(results[0][1]["loss"], float(loss), **GRAD_TOL)
    assert_close_to_jax(gathered(results, lambda r: r["grads"], option), grads, **GRAD_TOL)


@pytest.mark.parametrize("option", ["fsdp", "seq"])
@pytest.mark.parametrize("config", ["llama", "deep"])
def test_two_rank_steps_match_jax(option, config, trees, tmp_path_factory):
    """Three steps against the JAX Trainer with the same option, on
    tiny_llama and on 4 layers (two a fsdp rank; the port's with remat)."""
    check_steps("pair", option, "steps" if config == "llama" else "deep", config, False, trees,
                tmp_path_factory)


@pytest.mark.parametrize("option", ["fsdp", "seq"])
def test_uneven_loss_masks_match_jax(option, trees, tmp_path_factory):
    """The fsdp ranks' rows count 30 and 6 positions; under seq the last
    two rows count positions 4-6, all in the first rank's slice: the loss
    is the mean over the whole batch's positions."""
    check_steps("pair", option, "uneven", "llama", True, trees, tmp_path_factory)


def test_fsdp_rank_holds_its_layers_and_moments(trees, tmp_path_factory):
    """Each fsdp rank holds L/2 of the 4-layer model's stacked layers, the
    ones it owns, and moments of the same shapes; the embedding and the
    final norm whole."""
    results = rank_results("pair", "fsdp", "held", trees, tmp_path_factory)
    L = CONFIGS["deep"]["n_layers"]
    for coords, held in results:
        j = coords["fsdp"]
        for name, (p, mu, nu) in held.items():
            want = trees["deep"]
            for k in name.split("/"):
                want = want[k]
            if name.startswith("layers/"):
                want = want[j * L // 2:(j + 1) * L // 2]
                assert p.shape[0] == L // 2, name
            assert mu == nu == tuple(p.shape) == want.shape, name
            np.testing.assert_array_equal(p.numpy(), want, err_msg=name)


@pytest.mark.parametrize("option,msg", [
    ("fsdp", "batch size 3 must be divisible by data×fsdp mesh axes (2); "
             "with fsdp=True the batch shards over both axes"),
    ("seq", "sequence length 15 must be divisible by the seq mesh axis (2)"),
])
def test_shapes_must_divide_over_the_option_axes(option, msg, trees, tmp_path_factory):
    for _, got in rank_results("pair", option, "indivisible", trees, tmp_path_factory):
        assert got is not None and msg in got


@pytest.fixture(scope="module")
def jax_ring():
    """JAX's ring_attention on a seq = 2 mesh at RING_SHAPE, without and
    with RING_PADS: its output and the q/k/v gradients of sum(out * dout),
    by jax.vjp."""
    import jax
    import jax.numpy as jnp

    from vnsum_tpu.parallel.ring import ring_attention

    q, k, v, dout = (jnp.asarray(a) for a in ring_inputs())
    G = RING_SHAPE["H"] // RING_SHAPE["KV"]
    mesh = jax_mesh("pair", "seq")
    out = {}
    for name, pads in (("ring", None), ("ring_pads", jnp.asarray(RING_PADS, jnp.int32))):
        @jax.jit
        def run(q, k, v, pads=pads):
            o, vjp = jax.vjp(lambda q, k, v: ring_attention(q, k, v, G, mesh=mesh,
                                                            pad_lens=pads), q, k, v)
            return (o,) + vjp(dout)

        out[name] = {f: np.asarray(a) for f, a in zip(("out", "dq", "dk", "dv"), run(q, k, v))}
    return out


@pytest.mark.parametrize("case,blk", [("ring", b) for b in RING_BLOCKS + ("reference",)]
                         + [("ring_pads", b) for b in RING_BLOCKS])
def test_ring_gradients_match_jax(case, blk, jax_ring, trees, tmp_path_factory):
    """ring_attention_fn's output and q/k/v gradients on a seq = 2 group (at
    each query block, and with each row's left pad masked as the long
    prefill masks it), and autograd through the in-test reference loop,
    against JAX's ring_attention on a seq = 2 mesh and its gradients."""
    want = jax_ring[case]
    results = rank_results("pair", "seq", case, trees, tmp_path_factory)
    # a pad query attends no key: its output is the constant 0, so its dq
    # is 0; JAX's autodiff gives NaN there (0 x inf through max(l, 1e-30))
    pads = RING_PADS if case == "ring_pads" else (0,) * RING_SHAPE["B"]
    pad_rows = np.arange(RING_SHAPE["S"])[None, :] < np.asarray(pads)[:, None]
    for field in ("out", "dq", "dk", "dv"):
        got = torch.cat([r[blk][field] for _, r in sorted(results, key=lambda cr: cr[0]["seq"])],
                        dim=1).numpy()
        if field == "dq":
            np.testing.assert_array_equal(got[pad_rows], 0.0)
            got, want_f = got[~pad_rows], want[field][~pad_rows]
        else:
            want_f = want[field]
        np.testing.assert_allclose(got, want_f, err_msg=field, **RING_TOL)


@pytest.mark.parametrize("key", ["pair", "eight"])
def test_forward_train_with_ring_matches_jax(key, trees, tmp_path_factory):
    """The counterpart of test_forward_train_with_ring_attention_matches_dense:
    forward_train under the ring, each rank's rows and slice gathered,
    against JAX's dense forward_train and its ring one on the same mesh."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from vnsum_tpu.models import llama as jl
    from vnsum_tpu.parallel.ring import ring_attention

    params = jax.tree.map(jnp.asarray, trees["logits"])
    tokens = jnp.asarray(logits_tokens())
    dense = jl.forward_train(params, jl.tiny_llama(), tokens, remat=False)
    ring = jl.forward_train(params, jl.tiny_llama(), tokens, remat=False,
                            attention_fn=partial(ring_attention, mesh=jax_mesh(key, "seq")))
    results = rank_results(key, "seq", "logits", trees, tmp_path_factory)
    blocks = {}
    for coords, got in results:
        blk = (coords.get("data", 0), coords["seq"])
        if blk in blocks:  # the model ranks' logits: the same bits
            assert torch.equal(blocks[blk], got)
        blocks[blk] = got
    got = assemble(blocks, [("data", 0), ("seq", 1)]).numpy()
    np.testing.assert_allclose(got, np.asarray(dense), **LOGITS_TOL)
    np.testing.assert_allclose(got, np.asarray(ring), **LOGITS_TOL)


def test_fsdp_training_on_eight_ranks_matches_jax(trees, tmp_path_factory):
    """The counterpart of test_fsdp_training_matches_plain on {data: 2,
    model: 2, fsdp: 2}: three steps against JAX's fsdp Trainer there and
    its plain one on {data: 2, model: 2}."""
    from vnsum_tpu.parallel import make_mesh

    check_steps("eight", "fsdp", "steps", "llama", False, trees, tmp_path_factory,
                jax_meshes=[make_mesh({"data": 2, "model": 2}, platform="cpu")])


def test_context_parallel_training_on_eight_ranks_matches_jax(trees, tmp_path_factory):
    """The counterpart of test_training_with_context_parallel on {data: 2,
    model: 2, seq: 2}: three steps against JAX's context-parallel Trainer
    there."""
    check_steps("eight", "seq", "steps", "llama", False, trees, tmp_path_factory)


def test_fsdp_save_restore_resumes_bit_exact(trees, tmp_path_factory):
    """On {data: 2, model: 2, fsdp: 2}, with remat: every rank's shards and
    moments restored bit for bit, and the next step's loss the saved
    trainer's."""
    for _, r in rank_results("eight", "fsdp", "ckpt", trees, tmp_path_factory):
        assert r["saved"] == r["restored"] == 2 and r["count"] == 3
        assert r["loss_b"] == r["loss_a"] and r["moments_equal"]
        assert all(torch.equal(r["a"][k], r["b"][k]) for k in r["a"])


# -- one process ------------------------------------------------------------------------------


@pytest.mark.parametrize("blk", [None, 1, 5])
def test_ring_at_one_rank_matches_jax_dense_gradients(blk):
    """On a group of one rank (no shift) ring_attention_fn is causal
    attention: its output and gradients against JAX's
    dense_causal_attention and jax.vjp, at query blocks that do and do not
    divide the sequence."""
    import jax
    import jax.numpy as jnp

    from vnsum_tpu.models import llama as jl
    from vnsum_tpu_torch.parallel.ring import ring_attention_fn
    from vnsum_tpu_torch.parallel.seq import SeqGroup

    G = RING_SHAPE["H"] // RING_SHAPE["KV"]
    q, k, v, dout = ring_inputs()
    want, vjp = jax.vjp(lambda q, k, v: jl.dense_causal_attention(q, k, v, G),
                        *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(dout))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = ring_attention_fn(qt, kt, vt, G, SeqGroup(), query_block=blk)
    got.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **RING_TOL)
    for name, t, w in zip(("dq", "dk", "dv"), (qt, kt, vt), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), err_msg=name, **RING_TOL)


@pytest.mark.parametrize("shape", [{"data": 2, "fsdp": 2}, {"data": 2, "model": 2, "fsdp": 2}])
def test_batch_rows_follow_jax_tuple_axis_order(shape):
    """batch_rows over (data, fsdp) gives each mesh coordinate the rows that
    JAX's NamedSharding(P(("data", "fsdp"))) places on that device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from vnsum_tpu.parallel import make_mesh
    from vnsum_tpu_torch.parallel.seq import SeqGroup
    from vnsum_tpu_torch.parallel.sharding import batch_rows

    mesh = make_mesh(shape, platform="cpu")
    B = 8
    placed = jax.device_put(jnp.arange(B), NamedSharding(mesh, P(("data", "fsdp"))))
    names = mesh.axis_names
    for shard in placed.addressable_shards:
        coords = dict(zip(names, np.argwhere(mesh.devices == shard.device)[0]))
        groups = [SeqGroup(int(coords[ax]), shape[ax], object()) for ax in ("data", "fsdp")]
        lo, hi = batch_rows(groups, B)
        assert list(range(lo, hi)) == np.asarray(shard.data).tolist(), coords


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_params_keeps_the_fsdp_ranks_layers(rank):
    """shard_params(fsdp=True) on rank ``rank`` of an fsdp axis of 2 (a view
    whose group runs no collective: slicing needs none) keeps layers [2
    rank, 2 rank + 2) of a 4-layer model and shares the embedding and the
    final norm whole; the cached forward refuses the shard."""
    from vnsum_tpu_torch.models import llama as tl
    from vnsum_tpu_torch.parallel.mesh import Mesh
    from vnsum_tpu_torch.parallel.seq import SeqGroup
    from vnsum_tpu_torch.parallel.sharding import shard_params

    cfg = tl.tiny_llama(n_layers=4)
    whole = tl.LlamaModel(cfg, tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    shape = {"data": 1, "model": 1, "seq": 1, "fsdp": 2}
    mesh = Mesh(shape, {ax: 0 for ax in shape} | {"fsdp": rank}, torch.device("cpu"),
                {"fsdp": SeqGroup(rank, 2, object())})
    shard = shard_params(whole, mesh, fsdp=True)
    for name, w in whole.layers.items():
        assert torch.equal(shard.layers[name], w[2 * rank:2 * rank + 2]), name
    assert shard.embed.data_ptr() == whole.embed.data_ptr()
    assert shard.final_norm.data_ptr() == whole.final_norm.data_ptr()
    with pytest.raises(ValueError, match="runs forward_train only"):
        shard(torch.zeros((1, 4), dtype=torch.int32), None, None, 0, torch.ones(1, 4, 4, dtype=bool))
