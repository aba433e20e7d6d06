"""Partition specs for model state, and this rank's shard of a model.

Counterpart of ``vnsum_tpu/parallel/sharding.py`` (megatron-style tensor
parallelism). A spec is the per-dim tuple of mesh axis names (None =
replicated), the counterpart of a ``PartitionSpec``: weights shard their
head / hidden / vocab dims over ``model``, batches and the KV cache's
batch dim over ``data``. Where the JAX package hands these specs to GSPMD,
the port slices each leaf itself (:func:`shard_params`) and the sharded
forward (``models/llama.py``) runs the collectives they imply.
"""
from __future__ import annotations

from typing import Any

import torch

from .mesh import AXES, Mesh
from .seq import SeqGroup

_D, _M, _F = AXES.data, AXES.model, AXES.fsdp


def param_specs(
    tie_embeddings: bool = True,
    quantized: bool = False,
    fsdp: bool = False,
    qk_norm: bool = False,
    sandwich_norms: bool = False,
) -> dict[str, Any]:
    """Spec tree matching the parameter tree in the JAX package's layout
    (``models/llama.py`` ``_param_shapes``).

    Layer leaves carry a leading stacked-layer dim; with ``fsdp=True`` that
    dim is sharded over the ``fsdp`` axis. With ``quantized=True`` each
    matmul weight becomes ``{"q": <weight spec>, "s": <scale spec>}``, the
    scale spec being the weight spec without the contracted axes (a
    per-output-channel scale lives on the output axes and inherits their
    sharding)."""
    L = _F if fsdp else None
    specs = {
        "embed": (_M, None),             # vocab-sharded embedding
        "layers": {
            "attn_norm": (L, None),
            "wq": (L, None, _M, None),   # [L, D, nh, hd]: heads sharded
            "wk": (L, None, _M, None),
            "wv": (L, None, _M, None),
            "wo": (L, _M, None, None),   # [L, nh, hd, D]
            "mlp_norm": (L, None),
            "w_gate": (L, None, _M),     # [L, D, I]: hidden sharded
            "w_up": (L, None, _M),
            "w_down": (L, _M, None),     # [L, I, D]
        },
        "final_norm": (None,),
    }
    if qk_norm:
        # per-head Q/K norms [L, hd]: tiny, replicated over model
        specs["layers"]["q_norm"] = (L, None)
        specs["layers"]["k_norm"] = (L, None)
    if sandwich_norms:
        specs["layers"]["post_attn_norm"] = (L, None)
        specs["layers"]["post_ffw_norm"] = (L, None)
    if not tie_embeddings:
        specs["lm_head"] = (None, _M)    # [D, V]
    if quantized:
        from ..models.quant import _CONTRACT_AXES

        def qspec(spec: tuple, contract_axes: tuple[int, ...]) -> dict:
            scale = tuple(ax for i, ax in enumerate(spec) if i not in contract_axes)
            return {"q": spec, "s": scale}

        for name, axes in _CONTRACT_AXES.items():
            shifted = tuple(a + 1 for a in axes)  # leading stacked-L dim
            specs["layers"][name] = qspec(specs["layers"][name], shifted)
        specs["embed"] = qspec(specs["embed"], (1,))
        if not tie_embeddings:
            specs["lm_head"] = qspec(specs["lm_head"], (0,))
    return specs


def cache_specs(quantized: bool = False) -> dict[str, Any]:
    """KV cache [L, B, kv_heads, C, hd]: batch over data, heads over model.
    With ``quantized=True`` adds the int8 cache's per-(token, head) scale
    planes [L, B, kv_heads, C], sharded like their cache dims."""
    kv = (None, _D, _M, None, None)
    specs: dict[str, Any] = {"k": kv, "v": kv}
    if quantized:
        scale = (None, _D, _M, None)
        specs["ks"] = scale
        specs["vs"] = scale
    return specs


def batch_spec() -> tuple:
    """[B, S] token batches shard over data."""
    return (_D, None)


def batch_rows(groups, B: int) -> tuple[int, int]:
    """This rank's rows [lo, hi) of a batch of B rows split over the axes
    of ``groups`` (:class:`SeqGroup` s, in order) as a spec naming the tuple
    of them splits it: in JAX's order the block index is ``r0 * w1 + r1``
    for two axes (B is a multiple of the product of their sizes)."""
    rank, world = 0, 1
    for g in groups:
        rank, world = rank * g.world + g.rank, world * g.world
    n = B // world
    return rank * n, (rank + 1) * n


def data_rows(data: SeqGroup, B: int) -> tuple[int, int]:
    """This data rank's rows [lo, hi) of a batch of B rows, as
    :func:`batch_spec` splits it: the data ranks take it in order (B is a
    multiple of their count)."""
    return batch_rows((data,), B)


def gather_rows(data: SeqGroup, local: torch.Tensor, B: int) -> torch.Tensor:
    """The [B, ...] batch of this rank's rows ``local`` and the other data
    ranks': each rank places its rows in a zeroed buffer and the buffers
    are summed over ``data``, exact since each element has one
    contributor."""
    if data.world == 1:
        return local
    lo, hi = data_rows(data, B)
    full = local.new_zeros((B,) + tuple(local.shape[1:]))
    full[lo:hi] = local
    return data.all_reduce_sum(full)


def _leaves(tree: dict, specs: dict, path=()):
    """(path, leaf, spec) in the JAX package's tree order (sorted keys), so
    a divisibility error names the leaf JAX's check names first."""
    for k in sorted(tree):
        if isinstance(specs[k], dict):
            yield from _leaves(tree[k], specs[k], path + (k,))
        else:
            yield path + (k,), tree[k], specs[k]


def _jax_layout_tree(model) -> dict:
    """The model's leaves as ``{name: shape}`` in the JAX package's layout
    (int8 leaves as ``{"q": shape, "s": shape}``), from its config."""
    from ..models.llama import _param_shapes
    from ..models.quant import _CONTRACT_AXES

    shapes = _param_shapes(model.cfg)
    layers = shapes.pop("layers")

    def leaf(name, shape):
        if name not in model.scales:
            return tuple(shape)
        if name == "embed":
            axes = (1,)
        elif name == "lm_head":
            axes = (0,)
        else:
            axes = tuple(a + 1 for a in _CONTRACT_AXES[name])
        return {"q": tuple(shape),
                "s": tuple(d for i, d in enumerate(shape) if i not in axes)}

    out = {k: leaf(k, v) for k, v in shapes.items()}
    out["layers"] = {k: leaf(k, v) for k, v in layers.items()}
    return out


def _stored_dim(name: str, dim: int, quantized: bool) -> int:
    """The dim of the model's tensor that JAX-layout ``dim`` of weight
    ``name`` maps to: itself for bf16 leaves; in the int8 stored layout
    (``q [L, N, K]``, ``[V, D]`` for embed and lm_head) the output dims
    flatten into N and the contracted ones into K, the sharded (heads,
    hidden or vocab) dim leading either, so its shard is one contiguous
    slice."""
    from ..models.quant import _CONTRACT_AXES

    if not quantized or name == "embed":
        return dim
    if name == "lm_head":
        return 0  # [D, V] is stored [V, D]
    return 2 if dim - 1 in _CONTRACT_AXES[name] else 1


def shard_params(model, mesh: Mesh, fsdp: bool = False):
    """This rank's shard of ``model`` (a whole :class:`LlamaModel`, bf16 or
    int8) as a :class:`LlamaModel` that runs the tensor-parallel forward
    over the mesh's ``model`` group. Parameters are replicated over
    ``data``. With a ``model`` axis of 1 the shard shares the whole
    model's tensors (no copy).

    With ``fsdp`` (the trainer's ZeRO-3, ``param_specs(fsdp=True)``) every
    layer leaf also keeps this rank's ``n_layers / fsdp`` stacked layers
    (the ``fsdp`` axis's rank j holds layers [j L/f, (j + 1) L/f)); the
    embedding, the head and the final norm stay replicated over ``fsdp``.

    Raises a config-level error (which sharded dim, which axis) before
    slicing anything."""
    from ..models.llama import LlamaModel

    cfg = model.cfg
    specs = param_specs(
        cfg.tie_embeddings, model.quantized, fsdp=fsdp, qk_norm=cfg.qk_norm,
        sandwich_norms=cfg.sandwich_norms,
    )
    for _, shape, spec in _leaves(_jax_layout_tree(model), specs):
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            size = mesh.shape.get(axis, 1)
            if shape[dim] % size:
                raise ValueError(
                    f"param dim {dim} (size {shape[dim]}) is not "
                    f"divisible by mesh axis '{axis}' ({size}); shrink that "
                    "mesh axis or pick a TP-compatible model config"
                )
    tp = mesh.group(_M)
    layers = mesh.group(_F) if fsdp else SeqGroup()
    if tp.world == 1 and layers.world == 1:
        return LlamaModel(cfg, model.tree(), tp=tp)

    def piece(t, dim, group):
        if group.world == 1:
            return t
        n = t.shape[dim] // group.world
        return t.narrow(dim, group.rank * n, n).clone()

    def leaf(name, t, spec):
        if isinstance(t, dict):  # int8, in the stored layout (never trained: no fsdp)
            q, s = t["q"], t["s"]
            if _M in spec["q"]:
                q = piece(q, _stored_dim(name, spec["q"].index(_M), True), tp)
            if _M in spec["s"]:  # a scale follows its output channels: [L, N] or [V]
                s = piece(s, spec["s"].index(_M), tp)
            return {"q": q, "s": s}
        # a replicated leaf is shared with the whole model
        if _M in spec:
            t = piece(t, spec.index(_M), tp)
        return piece(t, 0, layers) if _F in spec else t  # the stacked-layer dim leads

    tree = model.tree()
    out = {k: leaf(k, v, specs[k]) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: leaf(k, v, specs["layers"][k]) for k, v in tree["layers"].items()}
    return LlamaModel(cfg, out, tp=tp, fsdp=layers)
