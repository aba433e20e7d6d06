"""K1 and K2 on one rank's shard of a mesh.

Counterpart of ``vnsum_tpu/ops/sharded.py``, which wraps the Pallas kernels
in ``shard_map``. The wrapping is collective-free: batch rows live on the
``data`` axis and heads on the ``model`` axis, so every (row, head) softmax
is complete within one shard. In the port a rank's tensors are its shard
already, so a wrapper checks that the local q ``[B/d, S, H/m, hd]``, cache
``[L, B/d, KV/m, C, hd]`` and pads ``[B/d]`` are one consistent shard and
calls the kernel's wrapper on them: K1 (``ops/flash_attention.py``) and K2
(``ops/decode_attention.py``), which launch on the card and take their
plain versions on the CPU. A shape the kernel does not take raises there.

``prefill_calls`` and ``decode_calls`` count the calls, one a layer of a
forward, beside the kernels' own launch counters.
"""
from __future__ import annotations

import torch

from ..parallel.mesh import AXES, Mesh
from .decode_attention import flash_decode_attention
from .flash_attention import flash_prefill_attention

prefill_calls = 0
decode_calls = 0


def check_shard(mesh: Mesh, q: torch.Tensor, cache: dict, pad_lens, q_per_kv: int) -> None:
    """Raise unless q, cache and pads are one rank's consistent shard: the
    same local rows, ``q_per_kv`` query heads a local KV head, and a cache
    of the layout ``cache_specs`` gives."""
    B, _, H, hd = q.shape
    L, Bc, KV, C, hdc = cache["k"].shape
    if (Bc, hdc) != (B, hd) or pad_lens.shape != (B,):
        raise ValueError(
            f"shard mismatch: q {tuple(q.shape)}, cache {tuple(cache['k'].shape)}, "
            f"pads {tuple(pad_lens.shape)} on a mesh {mesh.shape}"
        )
    if H != KV * q_per_kv:
        raise ValueError(
            f"a shard of {H} query heads over {KV} KV heads is not GQA group "
            f"{q_per_kv}: heads and KV heads must split over '{AXES.model}' "
            f"({mesh.shape.get(AXES.model, 1)}) alike"
        )


def sharded_flash_prefill(
    mesh: Mesh,
    q: torch.Tensor,
    cache: dict,
    layer_idx: int,
    pad_lens: torch.Tensor,
    q_per_kv: int,
    window=None,
    q_offset=None,
) -> torch.Tensor:
    """flash_prefill_attention on this rank's (data, model) shard.
    ``window`` and ``q_offset`` are the same on every rank (0/None = global
    layer / whole-prompt prefill)."""
    global prefill_calls
    check_shard(mesh, q, cache, pad_lens, q_per_kv)
    prefill_calls += 1
    return flash_prefill_attention(
        q, cache, layer_idx, pad_lens, q_per_kv, window or 0, q_offset or 0
    )


def sharded_flash_decode(
    mesh: Mesh,
    q: torch.Tensor,
    cache: dict,
    layer_idx: int,
    pad_lens: torch.Tensor,
    fill,
    q_per_kv: int,
    window=None,
) -> torch.Tensor:
    """flash_decode_attention on this rank's (data, model) shard.
    ``window`` is the same on every rank (0/None = global layer)."""
    global decode_calls
    check_shard(mesh, q, cache, pad_lens, q_per_kv)
    decode_calls += 1
    return flash_decode_attention(
        q, cache, layer_idx, pad_lens, fill, q_per_kv, window or 0
    )
