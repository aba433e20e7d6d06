"""Multi-process runtime: ``torch.distributed`` + the hybrid (node) mesh.

Counterpart of ``vnsum_tpu/parallel/distributed.py``. Every rank runs this
same program, one process per card; :func:`init_distributed` joins the
default process group from torchrun's environment, as the JAX one wires
``jax.distributed`` from its own:

- ``MASTER_ADDR``/``MASTER_PORT`` stand for ``JAX_COORDINATOR_ADDRESS``,
- ``WORLD_SIZE`` for ``JAX_NUM_PROCESSES``, ``RANK`` for ``JAX_PROCESS_ID``,
- ``LOCAL_RANK`` picks this rank's card.

Axis placement follows the same recipe: put *data* parallelism across
nodes (its collectives run once a batch) and keep *model*/*seq* inside a
node (their collectives sit in every layer).

Typical launch, one process per card (``torchrun --nproc-per-node 4
prog.py``):

    from vnsum_tpu_torch.parallel import init_distributed, is_primary, mesh_from_spec
    init_distributed()                      # env-driven (MASTER_ADDR...)
    mesh = mesh_from_spec("data=2,model=2")
"""
from __future__ import annotations

import datetime
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import AXES, Mesh, _build, make_mesh, mesh_device
from .mesh import world_size as _world_size

_INITIALIZED = False


def init_distributed(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    *,
    device="cuda",
    timeout_s: float = 600.0,
) -> bool:
    """Join the default process group for a multi-process run: NCCL for
    ``device`` "cuda" (this rank's card is ``LOCAL_RANK``), gloo for "cpu".

    Arguments fall back to torchrun's environment (``MASTER_ADDR`` and
    ``MASTER_PORT`` make an ``env://`` rendezvous; ``WORLD_SIZE``;
    ``RANK``). Returns True when the group is (or already was) formed —
    one that a launcher formed before this call satisfies it — and False
    when running single-process with no cluster configuration, which
    callers treat as local mode. Where the environment only looks like a
    cluster (a scheduler's markers, no rendezvous) and the group cannot
    form, it warns once and returns False; an explicit configuration that
    fails raises."""
    global _INITIALIZED
    if _INITIALIZED or (dist.is_available() and dist.is_initialized()):
        _INITIALIZED = True
        return True
    if init_method is None and os.environ.get("MASTER_ADDR"):
        init_method = "env://"
    if world_size is None and os.environ.get("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    explicit = init_method is not None or world_size not in (None, 1)
    if not explicit and not _cluster_env_detected():
        return False  # single-process dev box: nothing to wire
    try:
        dev = mesh_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=init_method or "env://",
            world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
    except (RuntimeError, ValueError) as e:
        if explicit:
            raise
        # a cluster-looking environment with no usable rendezvous degrades
        # to local mode instead of crashing single-host runs
        from ..core.logging import get_logger

        get_logger("vnsum.distributed").warning(
            "distributed auto-init failed, continuing single-process: %s", e
        )
        return False
    _INITIALIZED = True
    return True


def _cluster_env_detected() -> bool:
    """Heuristic for managed multi-node launchers, from the environment
    only (the JAX package's markers)."""
    markers = (
        "TPU_WORKER_HOSTNAMES",   # cloud TPU pod slice
        "MEGASCALE_COORDINATOR_ADDRESS",  # multislice
        "SLURM_JOB_NUM_NODES",
        "OMPI_COMM_WORLD_SIZE",
    )
    if os.environ.get("SLURM_JOB_NUM_NODES", "1") != "1":
        return True
    if os.environ.get("OMPI_COMM_WORLD_SIZE", "1") != "1":
        return True
    return any(os.environ.get(m) for m in markers[:2])


def process_count() -> int:
    return _world_size()


def is_primary() -> bool:
    """True on rank 0: gate log files, checkpoint writes, report emission."""
    return _world_size() == 1 or dist.get_rank() == 0


def barrier(name: str = "vnsum") -> None:
    """Block until every rank reaches this point (no-op single-process)."""
    if _world_size() > 1:
        dist.barrier()


def hybrid_layout(ici: dict, dcn: dict, world: int, ranks_per_node: int) -> tuple[dict, np.ndarray]:
    """(``{axis: ici * dcn}``, the rank at each mesh coordinate) of a mesh
    over ``world`` ranks in nodes of ``ranks_per_node``: the ICI sizes
    within a node, the DCN sizes across nodes. Along each axis the node
    index is major, so axes whose DCN size is 1 never leave a node."""
    names = (AXES.data, AXES.model, AXES.seq)
    n_nodes = math.prod(dcn[ax] for ax in names)
    per_node = math.prod(ici[ax] for ax in names)
    if per_node != ranks_per_node or n_nodes * per_node != world:
        raise ValueError(
            f"hybrid mesh ici={ici} dcn={dcn} needs {n_nodes} nodes of {per_node} "
            f"ranks; the group has {world} ranks, {ranks_per_node} a node"
        )
    # rank = node * per_node + local; node and local row-major over the axes
    node = np.arange(n_nodes).reshape([dcn[ax] for ax in names])
    local = np.arange(per_node).reshape([ici[ax] for ax in names])
    grid = node[:, None, :, None, :, None] * per_node + local[None, :, None, :, None, :]
    shape = {ax: ici[ax] * dcn[ax] for ax in names}
    return shape, grid.reshape(list(shape.values()))


def make_hybrid_mesh(ici: dict | None = None, dcn: dict | None = None, *,
                     device="cuda") -> Mesh:
    """Mesh spanning several nodes: per-axis sizes within a node (``ici``)
    and across nodes (``dcn``). Falls back to a plain :func:`make_mesh`
    when every DCN size is 1, so single-node code can call this
    unconditionally. The axis size is ``ici[axis] * dcn[axis]``, node index
    major (:func:`hybrid_layout`)."""
    ici = dict(ici or {})
    dcn = dict(dcn or {})
    names = (AXES.data, AXES.model, AXES.seq)
    unknown = (set(ici) | set(dcn)) - set(names)
    if unknown:
        raise ValueError(f"unknown mesh axes: {sorted(unknown)}")
    for ax in names:
        ici.setdefault(ax, 1)
        dcn.setdefault(ax, 1)
    if math.prod(dcn.values()) == 1:
        return make_mesh(ici, device=device)
    n_nodes = math.prod(dcn.values())
    world = process_count()
    ranks_per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world // max(ranks_per_node, 1) < n_nodes:
        raise ValueError(
            f"hybrid mesh wants {n_nodes} slices over DCN but only "
            f"{world // max(ranks_per_node, 1)} node(s) are attached — run under "
            "init_distributed() on a multi-node deployment"
        )
    dev = mesh_device(device)
    shape, grid = hybrid_layout(ici, dcn, world, ranks_per_node)
    from torch.distributed.device_mesh import DeviceMesh

    dm = DeviceMesh(dev.type, torch.as_tensor(grid), mesh_dim_names=tuple(shape))
    return _build(dev, shape, dm)
