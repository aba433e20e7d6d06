from .distributed import (
    barrier,
    init_distributed,
    is_primary,
    make_hybrid_mesh,
    process_count,
)
from .mesh import AXES, Mesh, MeshAxes, make_mesh, mesh_from_spec
from .ring import ring_attention
from .seq import SeqGroup
from .sharding import batch_spec, cache_specs, param_specs, shard_params

__all__ = [
    "AXES",
    "Mesh",
    "MeshAxes",
    "SeqGroup",
    "barrier",
    "batch_spec",
    "cache_specs",
    "init_distributed",
    "is_primary",
    "make_hybrid_mesh",
    "make_mesh",
    "mesh_from_spec",
    "param_specs",
    "process_count",
    "ring_attention",
    "shard_params",
]
