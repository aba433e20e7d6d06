"""Flash decode attention over the stacked KV cache (kernel K2).

Counterpart of ``vnsum_tpu/ops/decode_attention.py`` (``flash_decode_attention``
with ``return_partials=False``). One query token per row attends layer
``layer_idx`` of the stacked cache; the batch shares one scalar ``fill``, the
last valid slot, and the mask is ``pad_b <= k <= fill`` and
``window == 0 or k > fill - window``. All arithmetic is f32, with the same
int8 algebra as the prefill kernel.

:func:`flash_decode_attention` launches the CUDA kernel
(``csrc/flash_decode.cu``) for tensors on the card and takes the plain
version, :func:`flash_decode_attention_ref`, only for tensors on the CPU.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernels
from .flash_attention import (
    cache_layer,
    attention_ref,
    check_cache,
    check_query,
    pointers,
    visible_mask,
)

launches = 0
_lib = None


def flash_decode_attention_ref(
    q, cache, layer_idx, pad_lens, fill, q_per_kv, window=None
):
    """Plain version of :func:`flash_decode_attention` (f32 throughout)."""
    B, S, H, _ = q.shape
    if S != 1:
        raise ValueError(f"decode attention is single-token (S=1), got S={S}")
    if H != q_per_kv * cache["k"].shape[2]:
        raise ValueError(f"q_per_kv={q_per_kv} inconsistent with H={H}")
    C = cache["k"].shape[3]
    mask = visible_mask(torch.tensor([int(fill)]), pad_lens, window or 0, C)
    k, v, ks, vs = cache_layer(cache, layer_idx)
    return attention_ref(q, k, v, ks, vs, mask, torch.float32)


def _library():
    global _lib
    if _lib is None:
        lib = kernels.load("flash_decode")
        fn = lib.vnsum_flash_decode
        fn.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.vnsum_flash_decode_splits.argtypes = [ctypes.c_int]
        lib.vnsum_flash_decode_splits.restype = ctypes.c_int
        _lib = lib
    return _lib


def flash_decode_attention(
    q: torch.Tensor,          # [B, 1, H, hd]
    cache: dict,              # stacked {"k","v"[, "ks","vs"]} (models.llama.init_kv_cache)
    layer_idx: int,
    pad_lens: torch.Tensor,   # [B] int32
    fill: int,                # last valid slot (inclusive)
    q_per_kv: int,
    window: int | None = None,  # 0/None = global
) -> torch.Tensor:
    """Returns [B, 1, H, hd] in q's dtype. CPU tensors take the plain
    version; CUDA tensors launch the kernel, or raise."""
    global launches
    if q.device.type == "cpu":
        return flash_decode_attention_ref(
            q, cache, layer_idx, pad_lens, fill, q_per_kv, window
        )
    if q.device.type != "cuda":
        raise ValueError(f"no flash decode kernel for device {q.device}")
    check_query(q, pad_lens)
    quantized = check_cache(q, cache, layer_idx)
    B, S, H, hd = q.shape
    L, _, KV, C, _ = cache["k"].shape
    if S != 1:
        raise ValueError(f"decode attention is single-token (S=1), got S={S}")
    if H != KV * q_per_kv or q_per_kv > 8:
        raise ValueError(f"q_per_kv={q_per_kv} with H/KV={H}/{KV} (kernel takes groups <= 8)")
    win = int(window or 0)
    if not 0 <= int(fill) < C or win < 0:
        raise ValueError(f"fill={fill} outside cache of {C} slots")
    lib = _library()
    out = torch.empty_like(q)
    # the kernel splits the cache range across blocks; each split leaves an
    # unnormalised (o, m, l) partial that its second pass merges
    splits = lib.vnsum_flash_decode_splits(int(fill))
    o_part = torch.empty((B, KV, splits, q_per_kv, hd), dtype=torch.float32, device=q.device)
    m_part = torch.empty((B, KV, splits, q_per_kv), dtype=torch.float32, device=q.device)
    l_part = torch.empty_like(m_part)
    ks = cache["ks"] if quantized else None
    vs = cache["vs"] if quantized else None
    rc = lib.vnsum_flash_decode(
        *pointers(q, cache["k"], cache["v"], ks, vs, pad_lens, out, o_part, m_part, l_part),
        B, H, KV, C, hd, int(layer_idx), int(fill), win, int(quantized),
        1.0 / (hd ** 0.5), ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"flash decode kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
