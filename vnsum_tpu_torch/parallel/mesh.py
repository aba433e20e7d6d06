"""Device mesh construction.

Counterpart of ``vnsum_tpu/parallel/mesh.py``. The JAX package runs one
controller that names a ``jax.sharding.Mesh`` and lets GSPMD insert the
collectives. The port runs the usual PyTorch SPMD layout instead: one
process per card, every rank running the same program on the same prompts,
each holding only its shard of the weights and of the cache, and the
collectives written out over the per-axis process groups of a
``torch.distributed.device_mesh.DeviceMesh``.

Axis conventions (as in the JAX package):
    data   — batch / document-chunk batch (DP)
    model  — attention heads + MLP hidden (TP, megatron-style)
    seq    — sequence/context parallelism for ring attention (SP)
    fsdp   — stacked-layer sharding, opt-in (the trainer's)

``shard_map`` and ``NamedSharding`` have no counterpart: a rank's tensors
ARE its shards (``parallel/sharding.py`` slices them), so a function runs
on its local blocks as it is, and the few collectives the sharded forward
needs (``models/llama.py``: two all-reduces a layer over ``model``, the
embedding's and the logits') are explicit calls on the axis's
:class:`SeqGroup`. A mesh of one rank needs no process group, and every
collective is then the identity.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from .seq import SeqGroup

__all__ = [
    "AXES", "Mesh", "MeshAxes", "axis_size", "make_mesh", "mesh_from_spec",
    "parse_mesh_spec", "resolve_mesh_shape",
]


@dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    model: str = "model"
    seq: str = "seq"
    fsdp: str = "fsdp"  # stacked-layer (stage) sharding; weights all-gather
    #                     per layer step, FSDP/ZeRO-3 style


AXES = MeshAxes()


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: ``shape`` is ``{axis: size}`` in
    device order (the dict the engine reads, ``mesh.shape.get("data",
    1)``), ``coords`` this rank's coordinate on each axis, ``groups`` a
    :class:`SeqGroup` for each axis of more than one rank, ``device`` this
    rank's device, ``device_mesh`` the ``DeviceMesh`` (None for one rank)."""

    shape: dict
    coords: dict
    device: torch.device
    groups: dict = field(default_factory=dict)
    device_mesh: object = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis: str) -> SeqGroup:
        """The ranks along ``axis`` through this rank (one rank: no process
        group, every collective the identity)."""
        return self.groups.get(axis) or SeqGroup()

    def captures_collectives(self) -> bool:
        """Whether a CUDA graph can hold this mesh's forward: it issues
        collectives only over ``model``, and NCCL's can be captured,
        gloo's cannot."""
        g = self.group(AXES.model)
        return g.world == 1 or dist.get_backend(g.group) == "nccl"


def axis_size(mesh: Mesh, axis_name: str) -> int:
    """Static size of a named mesh axis (1 for an axis the mesh lacks)."""
    return mesh.shape.get(axis_name, 1)


def resolve_mesh_shape(shape: dict | None, n: int) -> dict:
    """``{axis: size}`` for ``n`` devices, by the JAX package's rules:
    missing data/model/seq sizes default to 1, the fsdp axis appears only
    when asked for with a size above 1, and a single -1 entry absorbs the
    remaining devices (like a reshape wildcard)."""
    shape = dict(shape or {})
    for ax in (AXES.data, AXES.model, AXES.seq):
        shape.setdefault(ax, 1)
    if AXES.fsdp in shape and shape[AXES.fsdp] in (1, None):
        shape.pop(AXES.fsdp)
    wild = [ax for ax, s in shape.items() if s == -1]
    if len(wild) > 1:
        raise ValueError("at most one mesh axis may be -1")
    fixed = math.prod(s for s in shape.values() if s != -1)
    if wild:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes {fixed}")
        shape[wild[0]] = n // fixed
    total = math.prod(shape.values())
    if total > n:
        raise ValueError(f"mesh shape {shape} needs {total} devices, have {n}")
    return shape


def mesh_device(device) -> torch.device:
    """This rank's device: "cuda" is the current card (``init_distributed``
    sets it from ``LOCAL_RANK``) and raises when no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a mesh on device 'cuda' was requested but no CUDA card is visible; "
                "pass device='cpu' for a CPU mesh"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"no mesh backend for device {dev}")
    return dev


def world_size() -> int:
    """Ranks of the default process group (1 when there is none)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _build(dev: torch.device, shape: dict, device_mesh) -> Mesh:
    if device_mesh is None:
        return Mesh(shape, {ax: 0 for ax in shape}, dev)
    coords = {ax: device_mesh.get_local_rank(ax) for ax in shape}
    groups = {
        ax: SeqGroup(coords[ax], size, device_mesh.get_group(ax))
        for ax, size in shape.items() if size > 1
    }
    return Mesh(shape, coords, dev, groups, device_mesh)


def make_mesh(shape: dict | None = None, *, device="cuda") -> Mesh:
    """This rank's view of a mesh of ``{axis: size}`` over the ranks of the
    default process group (sizes resolved as :func:`resolve_mesh_shape`).
    Every rank must sit in the mesh: unlike the JAX package, which may take
    the first devices of a host, a rank left out would have nothing to run.
    One rank needs no process group; more ranks build a ``DeviceMesh``
    (every rank calls this together), rank order row-major over the axes as
    the JAX package reshapes its devices."""
    dev = mesh_device(device)
    n = world_size()
    resolved = resolve_mesh_shape(shape, n)
    total = math.prod(resolved.values())
    if total != n:
        raise ValueError(
            f"mesh shape {resolved} covers {total} of {n} ranks; every rank of the "
            "process group must sit in the mesh"
        )
    if n == 1:
        return _build(dev, resolved, None)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, tuple(resolved.values()),
                          mesh_dim_names=tuple(resolved))
    return _build(dev, resolved, dm)


def parse_mesh_spec(spec: str) -> dict:
    """Parse "data=2,model=4" into ``{axis: size}``."""
    shape: dict[str, int] = {}
    for part in spec.split(","):
        if not part.strip():
            continue
        k, v = part.split("=")
        shape[k.strip()] = int(v)
    return shape


def mesh_from_spec(spec: str, *, device="cuda") -> Mesh:
    """Parse "data=2,model=4" into a Mesh."""
    return make_mesh(parse_mesh_spec(spec), device=device)
