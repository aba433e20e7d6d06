"""Weight-only int8 quantization for decode throughput.

Copy of ``vnsum_tpu/models/quant.py``. A decode step on Llama-3.2-3B reads
every matmul weight once; int8 values with per-output-channel f32 scales
halve those bytes. The scale multiplies the product's OUTPUT, which is
exact because each scale belongs to channels that never mix in the
contraction:

- ``wq/wk/wv [L, D, H, hd]``  (contract d)      -> scale ``[L, H, hd]``
- ``wo [L, H, hd, D]``        (contract h, k)   -> scale ``[L, D]``
- ``w_gate/w_up [L, D, I]``   (contract d)      -> scale ``[L, I]``
- ``w_down [L, I, D]``        (contract i)      -> scale ``[L, D]``
- ``embed [V, D]``            row-wise          -> scale ``[V]`` (the gather
  and the tied LM head alike, whose output channel is the row)
- ``lm_head [D, V]``          (contract d)      -> scale ``[V]``

Norm weights stay in full precision. Scales are ``max(amax, 1e-8) / 127``
and values ``clip(round(w / s), -127, 127)``, in f32 with round half to
even, so the int8 values and scales equal the JAX package's bit for bit.

:func:`quantize_params` and :func:`dequantize_params` work on parameter
trees in the JAX package's layout (``{"q", "s"}`` leaves). The model keeps
its int8 matrices in the STORED layout instead (:func:`to_stored`): output
channel major with the contraction contiguous, ``q [L, N, K]`` and
``s [L, N]`` (``[V, D]`` and ``[V]`` for the embedding and an untied head),
the layout in which the int8 GEMV (``ops/int8_matmul.py``) reads 16 bytes a
thread along K and ``torch._int_mm(x, q.t())`` takes its weight.
:func:`quantize_model` quantizes a model's bf16 leaves into that layout one
leaf at a time, so its peak memory is the bf16 model, the int8 one and a
leaf's copies.
"""
from __future__ import annotations

import math

import torch

# weight name -> axes CONTRACTED in its matmul (reduced over for the scale
# max); the remaining axes are output channels with per-channel scales
_CONTRACT_AXES = {
    "wq": (0,), "wk": (0,), "wv": (0,),   # [D, H, hd] contract D
    "wo": (0, 1),                          # [H, hd, D] contract H, hd
    "w_gate": (0,), "w_up": (0,),          # [D, I] contract D
    "w_down": (0,),                        # [I, D] contract I
}
# rows of the embedding quantized at a time (bounds the f32 temporaries)
_EMBED_ROWS = 16384


def _quantize(w: torch.Tensor, contract_axes: tuple[int, ...], amax_reduce=None) -> dict:
    w32 = w.float()
    amax = w32.abs().amax(dim=contract_axes, keepdim=True)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    s = scale
    for a in sorted(contract_axes, reverse=True):
        s = s.squeeze(a)
    return {"q": q, "s": s}


def _quantize_stack(w: torch.Tensor, contract_axes: tuple[int, ...], amax_reduce=None) -> dict:
    """A layer stack [L, ...] quantized one layer at a time (the f32
    temporaries stay one layer's size); ``contract_axes`` are per layer."""
    parts = [_quantize(w[li], contract_axes, amax_reduce) for li in range(w.shape[0])]
    return {"q": torch.stack([p["q"] for p in parts]), "s": torch.stack([p["s"] for p in parts])}


def _quantize_embed(e: torch.Tensor) -> dict:
    parts = [_quantize(e[lo : lo + _EMBED_ROWS], (1,)) for lo in range(0, e.shape[0], _EMBED_ROWS)]
    return {"q": torch.cat([p["q"] for p in parts]), "s": torch.cat([p["s"] for p in parts])}


# the weights whose contraction a tensor-parallel shard splits over the
# model group (parallel/sharding.py): their per-channel max spans the ranks
_ROW_SHARDED = ("wo", "w_down")


def _quantize_leaf(name: str, w, tp=None):
    """One leaf of a params tree (the JAX package's layout) quantized, or
    returned as it is: a norm, or a leaf that is int8 already. ``tp``: the
    model group of a shard, whose row-sharded leaves take each channel's
    max over the whole contraction, so the shard quantizes as its slice of
    the whole model would."""
    if isinstance(w, dict):
        return w
    if name == "embed":
        return _quantize_embed(w)  # row max -> scale [V]
    if name == "lm_head":
        return _quantize(w, (0,))  # scale [V]
    if name in _CONTRACT_AXES:
        reduce = None
        if tp is not None and tp.world > 1 and name in _ROW_SHARDED:
            reduce = tp.all_reduce_max
        return _quantize_stack(w, _CONTRACT_AXES[name], reduce)
    return w  # norms


def quantize_params(params: dict) -> dict:
    """Params tree (the JAX package's layout, torch tensors) -> the same
    tree with matmul weights as ``{"q": int8, "s": f32}``. Layer scales
    keep the leading L dim."""
    out = {k: _quantize_leaf(k, v) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: _quantize_leaf(k, v) for k, v in params["layers"].items()}
    return out


def init_params_quantized(cfg, generator: torch.Generator, device="cuda") -> dict:
    """Random-init a params tree directly in :func:`quantize_params`' int8
    layout, with no bf16 tree ever resident: random int8 weights drawn from
    ``generator`` with a constant ``fan_in ** -0.5 / 127`` scale, so the
    dequantized magnitudes sit in the usual init range. Shapes come from
    :func:`..models.llama._param_shapes`, the layout of ``init_params``."""
    from .llama import _param_shapes

    shapes = _param_shapes(cfg)

    def qinit(shape, contract_axes):
        q = torch.randint(-127, 128, shape, generator=generator, dtype=torch.int8,
                          device=device)
        fan = math.prod(shape[a] for a in contract_axes)
        s_shape = tuple(d for i, d in enumerate(shape) if i not in contract_axes)
        return {"q": q, "s": torch.full(s_shape, (fan ** -0.5) / 127.0, dtype=torch.float32,
                                        device=device)}

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    layers = {
        name: (qinit(shape, tuple(a + 1 for a in _CONTRACT_AXES[name]))
               if name in _CONTRACT_AXES else ones(shape))
        for name, shape in shapes["layers"].items()
    }
    out = {"embed": qinit(shapes["embed"], (1,)), "layers": layers,
           "final_norm": ones(shapes["final_norm"])}
    if "lm_head" in shapes:
        out["lm_head"] = qinit(shapes["lm_head"], (0,))
    return out


def dequantize_params(qparams: dict) -> dict:
    """Inverse transform of :func:`quantize_params` (f32 weights)."""

    def deq(leaf, contract_axes):
        s = leaf["s"]
        for a in sorted(contract_axes):
            s = s.unsqueeze(a)
        return leaf["q"].float() * s

    layers = {
        name: deq(w, tuple(a + 1 for a in _CONTRACT_AXES[name])) if name in _CONTRACT_AXES else w
        for name, w in qparams["layers"].items()
    }
    out = {"embed": deq(qparams["embed"], (1,)), "layers": layers,
           "final_norm": qparams["final_norm"]}
    if "lm_head" in qparams:
        out["lm_head"] = deq(qparams["lm_head"], (0,))
    return out


def is_quantized(params: dict) -> bool:
    return isinstance(params.get("embed"), dict)


# -- the stored layout ----------------------------------------------------------


def stored_shapes(name: str, shape: tuple) -> tuple[tuple, tuple]:
    """(q, s) shapes in the stored layout of a weight whose JAX-layout shape
    is ``shape``."""
    if name == "embed":
        return tuple(shape), (shape[0],)
    if name == "lm_head":
        return (shape[1], shape[0]), (shape[1],)
    nc = len(_CONTRACT_AXES[name])
    K, N = math.prod(shape[1 : 1 + nc]), math.prod(shape[1 + nc :])
    return (shape[0], N, K), (shape[0], N)


def to_stored(name: str, leaf: dict) -> dict:
    """One ``{"q", "s"}`` leaf of :func:`quantize_params`' layout -> the
    model's stored layout: ``q [L, N, K]`` (``[V, D]`` for embed and
    lm_head), output channel major with the contraction contiguous, and
    ``s [L, N]`` (``[V]``). Layer stacks are moved a layer at a time."""
    q, s = leaf["q"], leaf["s"]
    if name == "embed":
        return {"q": q.contiguous(), "s": s.contiguous()}
    if name == "lm_head":
        return {"q": q.t().contiguous(), "s": s.contiguous()}
    (L, N, K), _ = stored_shapes(name, tuple(q.shape))
    out = torch.empty((L, N, K), dtype=q.dtype, device=q.device)
    for li in range(L):
        out[li].copy_(q[li].reshape(K, N).t())
    return {"q": out, "s": s.reshape(L, N).contiguous()}


def quantize_model(model, cfg=None):
    """A new :class:`..models.llama.LlamaModel` with ``model``'s bf16
    matmul weights quantized into the stored layout on the model's device,
    one leaf at a time (its f32 temporaries one layer's size); norms and
    leaves that are int8 already are shared, not copied. ``cfg`` (default
    ``model.cfg``) is the new model's config. A tensor-parallel shard
    (``model.tp``) gives the shard of the quantized whole: collective over
    its model group."""
    from .llama import LlamaModel

    def leaf(name, w):
        q = _quantize_leaf(name, w, model.tp)
        return to_stored(name, q) if q is not w else w

    tree = model.tree()
    out = {k: leaf(k, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: leaf(k, v) for k, v in tree["layers"].items()}
    return LlamaModel(cfg or model.cfg, out, tp=model.tp)
