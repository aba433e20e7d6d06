"""The port's multi-process runtime (``vnsum_tpu_torch/parallel/distributed.py``):
the counterparts of the eight cases of ``tests/test_parallel_distributed.py``
over torchrun's variables and the JAX package's cluster markers, and a
launcher-formed group of two CPU ranks that ``init_distributed`` accepts.
The pytest process never joins a process group; the two ranks are spawned
processes over gloo, each joined with a 60 s limit.
"""
from __future__ import annotations

import multiprocessing
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from vnsum_tpu_torch.parallel import (
    barrier,
    init_distributed,
    is_primary,
    make_hybrid_mesh,
    process_count,
)
from vnsum_tpu_torch.parallel import distributed as td

MARKERS = ("TPU_WORKER_HOSTNAMES", "MEGASCALE_COORDINATOR_ADDRESS",
           "SLURM_JOB_NUM_NODES", "OMPI_COMM_WORLD_SIZE")
TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
            "LOCAL_WORLD_SIZE")


@pytest.fixture
def clean_env(monkeypatch):
    for var in MARKERS + TORCHRUN:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(td, "_INITIALIZED", False)
    return monkeypatch


def test_init_distributed_local_noop(clean_env):
    assert init_distributed() is False  # local mode, nothing wired
    assert not dist.is_initialized()


def test_init_distributed_autodetect_fails_soft(clean_env):
    """A cluster-looking environment with no rendezvous degrades to local
    mode with one warning; an explicit configuration would raise."""
    clean_env.setenv("TPU_WORKER_HOSTNAMES", "host1,host2")
    assert init_distributed(device="cpu") is False
    assert not dist.is_initialized()


def test_cluster_env_detection(clean_env):
    assert td._cluster_env_detected() is False
    clean_env.setenv("SLURM_JOB_NUM_NODES", "1")
    assert td._cluster_env_detected() is False  # one node != a cluster
    clean_env.setenv("SLURM_JOB_NUM_NODES", "4")
    assert td._cluster_env_detected() is True
    clean_env.delenv("SLURM_JOB_NUM_NODES")
    clean_env.setenv("TPU_WORKER_HOSTNAMES", "h1,h2")
    assert td._cluster_env_detected() is True


def test_primary_and_count_single_process():
    assert process_count() == 1
    assert is_primary() is True
    barrier("test")  # must be a no-op, not hang


def test_hybrid_mesh_falls_back_to_single_slice():
    """Every DCN size 1: make_mesh over the ICI sizes, whose rank order is
    the JAX package's device order at 8 devices."""
    from vnsum_tpu.parallel import make_hybrid_mesh as jax_hybrid

    ici = {"data": 2, "model": 2, "seq": 2}
    jmesh = jax_hybrid(ici=ici, dcn={}, platform="cpu")
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    shape, grid = td.hybrid_layout(ici, {"data": 1, "model": 1, "seq": 1}, 8, 8)
    assert shape == dict(zip(jmesh.axis_names, jmesh.devices.shape))
    np.testing.assert_array_equal(grid, ids - ids.min())
    # at one rank the fallback is a one-rank mesh, with no process group
    assert make_hybrid_mesh(ici={}, dcn={}, device="cpu").shape == {
        "data": 1, "model": 1, "seq": 1}


def test_hybrid_mesh_rejects_unknown_axis():
    with pytest.raises(ValueError, match="unknown mesh axes"):
        make_hybrid_mesh(ici={"expert": 2}, device="cpu")


def test_hybrid_mesh_requires_processes_for_dcn(clean_env):
    with pytest.raises(ValueError, match="slices over DCN"):
        make_hybrid_mesh(ici={"model": 2}, dcn={"data": 4}, device="cpu")


@pytest.mark.parametrize("ici,dcn,want", [
    # data across two nodes of two model ranks each
    ({"model": 2}, {"data": 2}, [[0, 1], [2, 3]]),
    # the data axis spans nodes, node index major
    ({"data": 2}, {"data": 2}, [[0], [1], [2], [3]]),
    ({"data": 2, "model": 2}, {"data": 2}, [[0, 1], [2, 3], [4, 5], [6, 7]]),
])
def test_hybrid_layout_puts_nodes_major(ici, dcn, want):
    full = {ax: 1 for ax in ("data", "model", "seq")}
    world = int(np.prod(list(ici.values()))) * int(np.prod(list(dcn.values())))
    shape, grid = td.hybrid_layout({**full, **ici}, {**full, **dcn}, world,
                                   int(np.prod(list(ici.values()))))
    assert shape == {ax: {**full, **ici}[ax] * {**full, **dcn}[ax] for ax in full}
    np.testing.assert_array_equal(grid[..., 0], np.asarray(want))


def test_hybrid_mesh_sharded_computation_runs():
    """A forward on the shard of the fallback hybrid mesh equals the
    unsharded forward (one rank: the shard views the whole model)."""
    from vnsum_tpu_torch.models import llama as tl
    from vnsum_tpu_torch.parallel.sharding import shard_params

    torch.manual_seed(0)
    cfg = tl.tiny_llama()
    model = tl.init_model(cfg, 0, "cpu")
    shard = shard_params(model, make_hybrid_mesh(ici={"data": 1}, device="cpu"))
    assert shard.embed.data_ptr() == model.embed.data_ptr()  # no copy
    tokens = torch.randint(0, cfg.vocab_size, (2, 16))
    pos = torch.arange(16)[None].expand(2, 16)
    mask = tl.prefill_attention_mask(torch.zeros(2, dtype=torch.int32), 16, 16)

    def fwd(m):
        return m(tokens, pos, tl.init_kv_cache(cfg, 2, 16, device="cpu"), 0, mask)

    torch.testing.assert_close(fwd(shard), fwd(model), rtol=0, atol=0)


def _rank_main(rank: int, init_file: str, out_dir: str) -> None:
    """A launcher formed the group before the program's init_distributed."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=2, rank=rank)
    try:
        from vnsum_tpu_torch.parallel import make_mesh, mesh_from_spec

        out = {"accepted": init_distributed(device="cpu"), "count": process_count(),
               "primary": is_primary()}
        barrier()
        m = mesh_from_spec("model=2", device="cpu")
        t = torch.full((3,), float(rank + 1))
        m.group("model").all_reduce_sum(t)
        out.update(sum=t.tolist(), coords=m.coords, nccl=m.captures_collectives())
        m2 = make_mesh({"data": -1}, device="cpu")
        b = torch.full((2,), float(rank + 5))
        m2.group("data").broadcast(b, src=1)
        out["broadcast"] = b.tolist()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_launcher_formed_group_is_accepted(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, str(tmp_path / "rv"), str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(60)
        assert not any(p.is_alive() for p in procs), "ranks did not finish within 60 s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert [p.exitcode for p in procs] == [0, 0]
    for r in range(2):
        out = torch.load(tmp_path / f"rank{r}.pt")
        assert out["accepted"] is True and out["count"] == 2
        assert out["primary"] is (r == 0)
        assert out["sum"] == [3.0, 3.0, 3.0]
        assert out["coords"] == {"data": 0, "model": r, "seq": 0}
        assert out["nccl"] is False  # gloo collectives are not captured
        assert out["broadcast"] == [6.0, 6.0]
