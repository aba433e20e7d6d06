"""The port's long-context backend under a mesh
(``TorchLongContextBackend(mesh=)``) against the JAX package's
``LongContextBackend`` on a CPU mesh of the same shape, and against the
port's own one-rank backend, on carried weights; and the sliced ring.

Two spawns of CPU processes joined over gloo (``file://`` rendezvous, one
torch thread each, each joined with a 120 s limit, as
``tests/test_torch_engine_sharded.py`` does): two ranks for ``{seq: 2}``,
four ranks that build both ``{data: 2, seq: 2}`` and ``{model: 2, seq: 2}``
over the same group. Every rank runs the cases of its meshes and saves
what it got; the parametrised tests here compare. Everything is f32, so
greedy ids are byte-identical three ways: across the ranks, to the JAX
backend's (its decode partial dense, its default on the CPU) and to the
port's one-rank backend (K1's and K2p's plain versions). Sampled rows are
held to the one-rank port's: a row's stream depends on (seed, row, step)
only, and JAX draws from other keys (ROADMAP C). The pytest process never
joins a process group. The module imports no JAX at the top: the spawned
ranks import it to find their entry point.
"""
from __future__ import annotations

import multiprocessing
import os
import traceback

import numpy as np
import pytest
import torch

PROMPTS = [
    "Tóm tắt văn bản sau: nền kinh tế tăng trưởng ổn định trong quý một. " * 2,
    "hai",
    "Một tài liệu dài hơn hẳn nói về chính sách giáo dục và y tế cơ sở "
    "tại các địa phương miền núi phía bắc. " * 3,
    "Báo cáo về giao thông đô thị và quy hoạch. " * 4,
]
KW = dict(max_new_tokens=16, max_total_tokens=2048)
SAMPLED = dict(temperature=1.0, seed=4)
JOIN_S = 120
S_RING = 512  # the ring check's sequence: 256 queries a rank
RING_PADS = [0, 70, 300]  # row 2's pad covers all of rank 0's shard
RING_BLOCKS = (7, 64, 100, 256)  # query rows a slice; 256 = the whole shard

# the meshes of each spawn, and the cases their ranks run
SPAWNS = {
    "sp": (2, {"seq2": ({"seq": 2}, ("greedy", "int8_cache", "quant", "sampled", "ring"))}),
    "dp_tp": (4, {
        "dp": ({"data": 2, "seq": 2}, ("greedy", "sampled", "round3", "round1", "quant")),
        "tp": ({"model": 2, "seq": 2}, ("greedy", "int8_cache", "quant")),
    }),
}
# mesh name -> (spawn, shape)
MESHES = {name: (spawn, shape) for spawn, (_, meshes) in SPAWNS.items()
          for name, (shape, _) in meshes.items()}
# case -> TorchLongContextBackend keywords (and generate's config)
CASES = {
    "greedy": dict(batch_size=4),
    "int8_cache": dict(batch_size=4, quantize_kv=True),
    "quant": dict(batch_size=4, quantize=True),
    "sampled": dict(batch_size=4),
    "round3": dict(batch_size=3),
    "round1": dict(batch_size=1),
}


# -- the ranks ------------------------------------------------------------------


def recording(backend) -> list:
    """The generated id rows [B, max_new] of each batch ``backend`` runs,
    as gathered over ``data`` (one rank: its own)."""
    rows: list = []
    gather = backend._gather_rows

    def spy(local, B):
        out = gather(local, B)
        rows.append(out.cpu().numpy().tolist())
        return out

    backend._gather_rows = spy
    return rows


def port_run(model, case: str, **kw) -> dict:
    """One backend of ``case`` on ``model`` (a whole model; with a
    ``mesh`` in ``kw`` the backend shards it) over PROMPTS: texts, id rows,
    batches, the backend's batch size."""
    from vnsum_tpu_torch.backend.long_context import TorchLongContextBackend
    from vnsum_tpu_torch.core.config import GenerationConfig

    b = TorchLongContextBackend(model=model, device="cpu", **KW, **CASES[case], **kw)
    ids = recording(b)
    config = GenerationConfig(**SAMPLED) if case == "sampled" else None
    texts = b.generate(PROMPTS, config=config)
    return {"texts": texts, "ids": ids, "by_bucket": dict(b.stats.by_bucket),
            "batch_size": b.batch_size, "steps": b.stats.decode_steps}


def ring_case(mesh, payload) -> dict:
    """ring_attention on this rank's shard at each of RING_BLOCKS."""
    from vnsum_tpu_torch.parallel import ring_attention

    group = mesh.group("seq")
    q, k, v = payload["ring"]
    lo, hi = group.rank * S_RING // 2, (group.rank + 1) * S_RING // 2
    pads = torch.tensor(RING_PADS, dtype=torch.int32)
    return {blk: ring_attention(q[:, lo:hi], k[:, lo:hi], v[:, lo:hi], payload["G"], group,
                                pads, query_block=blk) for blk in RING_BLOCKS}


def _rank_main(rank: int, key: str, init_file: str, out_dir: str, payload: dict) -> None:
    """One rank: join the group, build each mesh of the spawn, run its
    cases (a failure is saved as its traceback), save, leave."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from vnsum_tpu_torch.models import llama as tl
    from vnsum_tpu_torch.parallel import init_distributed, make_mesh

    world, meshes = SPAWNS[key]
    init_distributed(f"file://{init_file}", world, rank, device="cpu", timeout_s=30)
    try:
        out = {}
        for name, (shape, cases) in meshes.items():
            mesh = make_mesh(shape, device="cpu")
            out[name] = {"coords": dict(mesh.coords)}
            for case in cases:
                try:
                    if case == "ring":
                        out[name][case] = ring_case(mesh, payload)
                        continue
                    model = tl.params_from_numpy(payload["tree"], payload["cfg"], device="cpu")
                    out[name][case] = port_run(model, case, mesh=mesh)
                except Exception:
                    out[name][case] = {"error": traceback.format_exc()}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# -- the parent -------------------------------------------------------------------


@pytest.fixture(scope="module")
def carried():
    """(jax cfg, jax params, port config, numpy tree, the ring's inputs)."""
    import jax

    from test_torch_models_llama import carried_weights

    jcfg, params, model = carried_weights(4, max_seq_len=2048)
    rng = np.random.default_rng(0)
    H, KV, hd = jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim
    ring = [torch.from_numpy(rng.standard_normal((3, S_RING, n, hd)).astype(np.float32))
            for n in (H, KV, KV)]
    return jcfg, params, model.cfg, jax.tree.map(np.asarray, params), ring


_SPAWNED: dict = {}


def spawned(key: str, carried, tmp_path_factory) -> list:
    """Every rank's saved results of spawn ``key`` (run once)."""
    if key in _SPAWNED:
        return _SPAWNED[key]
    world = SPAWNS[key][0]
    jcfg, _, cfg, tree, ring = carried
    payload = {"cfg": cfg, "tree": tree, "ring": ring, "G": jcfg.q_per_kv}
    tmp = tmp_path_factory.mktemp(key)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, key, str(tmp / "rendezvous"), str(tmp), payload))
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
    _SPAWNED[key] = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]
    return _SPAWNED[key]


def rank_results(mesh: str, case: str, carried, tmp_path_factory) -> list:
    ranks = spawned(MESHES[mesh][0], carried, tmp_path_factory)
    for r, res in enumerate(ranks):
        got = res[mesh][case]
        if isinstance(got, dict) and "error" in got:
            pytest.fail(f"{mesh} rank {r} case {case}:\n{got['error']}")
    return [res[mesh][case] for res in ranks]


def jax_run(carried, shape: dict, case: str) -> dict:
    """The JAX LongContextBackend of ``case`` on a CPU mesh of ``shape``:
    texts and the id rows its compiled program returned."""
    from vnsum_tpu.backend.long_context import LongContextBackend
    from vnsum_tpu.parallel import make_mesh

    jcfg, params, *_ = carried
    kw = {k: v for k, v in CASES[case].items()}
    b = LongContextBackend(model_config=jcfg, mesh=make_mesh(shape, platform="cpu"),
                           params=params, **KW, **kw)
    ids: list = []
    get_fn = b._get_fn

    def spy(*args):
        fn = get_fn(*args)

        def run(*a):
            out = fn(*a)
            ids.append(np.asarray(out).tolist())
            return out
        return run

    b._get_fn = spy
    return {"texts": b.generate(PROMPTS), "ids": ids, "batch_size": b.batch_size}


def port_one_rank(carried, case: str) -> dict:
    from vnsum_tpu_torch.models import llama as tl

    _, _, cfg, tree, _ = carried
    return port_run(tl.params_from_numpy(tree, cfg, device="cpu"), case)


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GREEDY = [(mesh, case) for mesh, (_, shape) in MESHES.items()
          for case in SPAWNS[MESHES[mesh][0]][1][mesh][1]
          if case not in ("sampled", "ring")]


@pytest.mark.parametrize("mesh,case", GREEDY, ids=[f"{m}-{c}" for m, c in GREEDY])
def test_greedy_ids_match_jax_mesh_and_one_rank(mesh, case, carried, tmp_path_factory,
                                                one_thread):
    """{seq: 2}, {data: 2, seq: 2} and {model: 2, seq: 2}: the f32 prefill
    cache, the int8 one (``quantize_kv``), int8 weights (``quantize``) and,
    at data = 2, a batch_size of 3 and of 1, which both become 2 (a
    multiple of the data axis, at least one row a data rank), as in JAX.
    Greedy ids byte-identical across the ranks, to JAX's on the same mesh
    and to the one-rank port's."""
    ranks = rank_results(mesh, case, carried, tmp_path_factory)
    want = jax_run(carried, MESHES[mesh][1], case)
    for r, got in enumerate(ranks):
        assert got["ids"] == ranks[0]["ids"], f"rank {r} differs from rank 0"
        assert got["texts"] == ranks[0]["texts"]
    assert ranks[0]["ids"] == want["ids"]
    assert ranks[0]["texts"] == want["texts"]
    assert ranks[0]["batch_size"] == want["batch_size"]
    if case.startswith("round"):
        # four prompts in two batches of two rows, one a data rank
        assert want["batch_size"] == 2
        assert {B for B, _ in ranks[0]["by_bucket"]} == {2}
        assert sum(ranks[0]["by_bucket"].values()) == 2
    else:
        one = port_one_rank(carried, case)
        assert ranks[0]["ids"] == one["ids"]
        assert ranks[0]["texts"] == one["texts"]
        assert ranks[0]["by_bucket"] == one["by_bucket"]
    assert any(any(t != 258 for t in row) for batch in ranks[0]["ids"] for row in batch)


@pytest.mark.parametrize("mesh", ["seq2", "dp"])
def test_sampled_rows_replay_the_one_rank_stream(mesh, carried, tmp_path_factory, one_thread):
    """Sampled rows (temperature 1, seed 4) on {seq: 2} and at data = 2
    draw what the one-rank backend draws: a row's seed is (seed, its row
    in the whole batch, step), whichever data rank runs it."""
    ranks = rank_results(mesh, "sampled", carried, tmp_path_factory)
    one = port_one_rank(carried, "sampled")
    greedy = port_one_rank(carried, "greedy")
    for got in ranks:
        assert got["ids"] == one["ids"] and got["texts"] == one["texts"]
    assert one["ids"] != greedy["ids"]


@pytest.mark.parametrize("block", RING_BLOCKS[:-1])
def test_sliced_ring_equals_the_whole_shard(block, carried, tmp_path_factory, one_thread):
    """ring_attention in slices of ``block`` query rows (smaller than the
    256-row shard) against the same ranks' unsliced call, and against one
    rank and the JAX ring on a {seq: 2} mesh. Every row's arithmetic is the
    same at any slice: equal within 1e-6 (f32 matmul blocking may move a
    last bit); 1e-5 against one rank and JAX, as the seq test holds it."""
    import jax.numpy as jnp

    from vnsum_tpu.parallel.mesh import make_mesh
    from vnsum_tpu.parallel.ring import ring_attention as jax_ring
    from vnsum_tpu_torch.parallel import SeqGroup, ring_attention

    jcfg, *_, ring = carried
    ranks = rank_results("seq2", "ring", carried, tmp_path_factory)
    whole = torch.cat([r[RING_BLOCKS[-1]] for r in ranks], dim=1)
    got = torch.cat([r[block] for r in ranks], dim=1)
    torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-6)
    pads = torch.tensor(RING_PADS, dtype=torch.int32)
    one = ring_attention(*ring, jcfg.q_per_kv, SeqGroup(), pads, query_block=block)
    torch.testing.assert_close(got, one, rtol=1e-5, atol=1e-5)
    want = jax_ring(*(jnp.asarray(t.numpy()) for t in ring), jcfg.q_per_kv,
                    mesh=make_mesh({"seq": 2}, platform="cpu"),
                    pad_lens=jnp.asarray(RING_PADS, dtype=jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ranks_sit_on_their_coordinates(carried, tmp_path_factory):
    coords = [r["dp"]["coords"] for r in spawned("dp_tp", carried, tmp_path_factory)]
    assert sorted((c["data"], c["seq"]) for c in coords) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    coords = [r["tp"]["coords"] for r in spawned("dp_tp", carried, tmp_path_factory)]
    assert sorted((c["model"], c["seq"]) for c in coords) == [(0, 0), (0, 1), (1, 0), (1, 1)]


# -- the backend's rules (no process group) ---------------------------------------


@pytest.mark.parametrize("B,H,Sk,want", [
    (2, 24, 12800, 384),    # a 12,800-slot shard of Llama-3.2-3B: ~0.94 GB of scores
    (2, 12, 12800, 768),    # its model = 2 shard
    (1, 4, 256, 1 << 18),   # a tiny shard: one slice holds it
    (64, 64, 1 << 20, 1),   # never below one row
])
def test_default_query_block(B, H, Sk, want):
    from vnsum_tpu_torch.parallel.ring import TRANSIENT_BYTES, default_query_block

    got = default_query_block(B, H, Sk)
    assert got == want
    assert got == 1 or B * H * got * Sk * 4 <= TRANSIENT_BYTES


def test_mesh_and_group_together_raise():
    from vnsum_tpu_torch.backend.long_context import TorchLongContextBackend
    from vnsum_tpu_torch.models import llama as tl
    from vnsum_tpu_torch.parallel import SeqGroup
    from vnsum_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh({"data": 1, "model": 1, "seq": 1}, {"data": 0, "model": 0, "seq": 0},
                torch.device("cpu"))
    with pytest.raises(ValueError, match="not both"):
        TorchLongContextBackend(model_config=tl.tiny_llama(), mesh=mesh, group=SeqGroup(),
                                device="cpu")


def test_one_by_one_mesh_shares_the_model_and_matches_no_mesh():
    """A mesh of one rank needs no process group: the backend shares the
    model's tensors and gives the unmeshed backend's texts."""
    from vnsum_tpu_torch.backend.long_context import TorchLongContextBackend
    from vnsum_tpu_torch.models import llama as tl
    from vnsum_tpu_torch.parallel import make_mesh

    model = tl.init_model(tl.tiny_llama(max_seq_len=512), 5, "cpu")
    kw = dict(batch_size=2, max_new_tokens=8, max_total_tokens=512, device="cpu")
    meshed = TorchLongContextBackend(model=model, mesh=make_mesh({}, device="cpu"), **kw)
    assert meshed.model.embed.data_ptr() == model.embed.data_ptr()
    assert meshed.generate(PROMPTS) == TorchLongContextBackend(model=model, **kw) \
        .generate(PROMPTS)


def test_a_shard_without_its_mesh_raises():
    from vnsum_tpu_torch.backend.long_context import TorchLongContextBackend
    from vnsum_tpu_torch.models import llama as tl
    from vnsum_tpu_torch.parallel import SeqGroup

    model = tl.init_model(tl.tiny_llama(), 5, "cpu")
    shard = tl.LlamaModel(model.cfg, model.tree())
    shard.tp = SeqGroup(0, 2, object())
    with pytest.raises(ValueError, match="needs the mesh"):
        TorchLongContextBackend(model=shard, max_new_tokens=8, device="cpu")
