"""Multi-position ("verify") decode attention over the stacked KV cache
(kernel K3).

Counterpart of ``flash_spec_verify_attention`` in
``vnsum_tpu/ops/decode_attention.py``. Each row carries Sq query positions
at its own cache offset: query (b, s) sits at slot ``fills_b + s`` and
attends layer ``layer_idx`` of the stacked cache under the mask
``pad_b <= k <= fills_b + s`` and ``window == 0 or k > fills_b + s - window``.
The speculative verify step calls it with Sq = spec_k + 1; the in-flight
slot segment with Sq = 1 and one fill per row. The function is f32
throughout, with the same int8 algebra as the prefill and decode kernels;
a (row, query) that sees no key comes out as 0. The kernel runs both
products on bf16 tensor cores and stays that function up to summation
order: QK's products are exact, and PV takes p as bf16 hi + lo halves
(``csrc/flash_verify.cu`` says how). ``fills`` stay on the device: nothing
here reads them to the host. The kernel takes head_dim 128 and 256
(Gemma3, each layer's window passed at run time), groups of up to
``MAX_GROUP`` query heads and up to ``MAX_ROWS[head_dim]`` rows of
Sq * q_per_kv: Llama-3.2-3B's spec step sends 27, Gemma3-4B's 18, and
their slot segments 3 and 2.

:func:`flash_spec_verify_attention` launches the CUDA kernel
(``csrc/flash_verify.cu``) for tensors on the card and takes the plain
version, :func:`flash_spec_verify_attention_ref`, only for tensors on the
CPU. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.llama import verify_attention_mask
from . import kernels
from .flash_attention import (
    HEAD_DIMS,
    attention_ref,
    cache_layer,
    check_cache,
    check_query,
    pointers,
    require_head_dim,
)

MAX_ROWS = {128: 64, 256: 24}  # largest Sq * q_per_kv the kernel takes, by head_dim
MAX_GROUP = 8  # largest q_per_kv the kernel takes

launches = 0
_lib = None


def flash_spec_verify_attention_ref(
    q, cache, layer_idx, pad_lens, fills, q_per_kv, window=None
):
    """Plain version of :func:`flash_spec_verify_attention` (f32 throughout)."""
    B, Sq, H, _ = q.shape
    if H != q_per_kv * cache["k"].shape[2]:
        raise ValueError(f"q_per_kv={q_per_kv} inconsistent with H={H}")
    C = cache["k"].shape[3]
    mask = verify_attention_mask(pad_lens, fills, Sq, C)
    if window:
        limit = fills.long()[:, None] + torch.arange(Sq, device=fills.device)[None, :]
        k = torch.arange(C, device=fills.device)
        mask = mask & (k[None, None, :] > limit[:, :, None] - int(window))
    k, v, ks, vs = cache_layer(cache, layer_idx)
    return attention_ref(q, k, v, ks, vs, mask, torch.float32)


def check_verify(q, cache, layer_idx, pad_lens, fills, q_per_kv, window):
    """Raise unless the kernel takes these arguments: NotImplementedError
    (ROADMAP B4) for a head_dim of the JAX kernel's that it does not take,
    ValueError for anything else. Returns (whether the cache is int8, the
    window as an int)."""
    require_head_dim("K3 (flash_spec_verify_attention)", q.shape[-1], HEAD_DIMS)
    check_query(q, pad_lens)
    quantized = check_cache(q, cache, layer_idx)
    B, Sq, H, hd = q.shape
    KV = cache["k"].shape[2]
    if (
        fills.dtype != torch.int32 or fills.shape != (B,)
        or fills.device != q.device or not fills.is_contiguous()
    ):
        raise ValueError("fills must be a contiguous int32 [B] tensor on q's device")
    if H != KV * q_per_kv or q_per_kv > MAX_GROUP or Sq * q_per_kv > MAX_ROWS[hd]:
        raise ValueError(
            f"q_per_kv={q_per_kv}, Sq={Sq} with H/KV={H}/{KV} (kernel takes groups "
            f"<= {MAX_GROUP} and Sq * group <= {MAX_ROWS[hd]} at head_dim {hd})"
        )
    win = int(window or 0)
    if win < 0:
        raise ValueError(f"window={win} must be >= 0")
    return quantized, win


def _library():
    global _lib
    if _lib is None:
        lib = kernels.load("flash_verify")
        fn = lib.vnsum_flash_verify
        fn.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.vnsum_flash_verify_splits.argtypes = [ctypes.c_int]
        lib.vnsum_flash_verify_splits.restype = ctypes.c_int
        lib.vnsum_flash_verify_smem.argtypes = [ctypes.c_int] * 3
        lib.vnsum_flash_verify_smem.restype = ctypes.c_int
        _lib = lib
    return _lib


def flash_spec_verify_attention(
    q: torch.Tensor,          # [B, Sq, H, hd]
    cache: dict,              # stacked {"k","v"[, "ks","vs"]} (models.llama.init_kv_cache)
    layer_idx: int,
    pad_lens: torch.Tensor,   # [B] int32
    fills: torch.Tensor,      # [B] int32: cache slot of each row's query 0
    q_per_kv: int,
    window: int | None = None,  # 0/None = global
) -> torch.Tensor:
    """Returns [B, Sq, H, hd] in q's dtype. CPU tensors take the plain
    version; CUDA tensors launch the kernel, or raise."""
    global launches
    if q.device.type == "cpu":
        return flash_spec_verify_attention_ref(
            q, cache, layer_idx, pad_lens, fills, q_per_kv, window
        )
    if q.device.type != "cuda":
        raise ValueError(f"no verify attention kernel for device {q.device}")
    quantized, win = check_verify(q, cache, layer_idx, pad_lens, fills, q_per_kv, window)
    B, Sq, H, hd = q.shape
    L, _, KV, C, _ = cache["k"].shape
    lib = _library()
    out = torch.empty_like(q)
    # the kernel splits the cache range across blocks; each split leaves an
    # unnormalised (o, m, l) partial that its second pass merges
    splits = lib.vnsum_flash_verify_splits(C)
    R = Sq * q_per_kv
    o_part = torch.empty((B, KV, splits, R, hd), dtype=torch.float32, device=q.device)
    m_part = torch.empty((B, KV, splits, R), dtype=torch.float32, device=q.device)
    l_part = torch.empty_like(m_part)
    ks = cache["ks"] if quantized else None
    vs = cache["vs"] if quantized else None
    rc = lib.vnsum_flash_verify(
        *pointers(q, cache["k"], cache["v"], ks, vs, pad_lens, fills, out, o_part, m_part,
                  l_part),
        B, Sq, H, KV, C, hd, int(layer_idx), win, int(quantized),
        1.0 / (hd ** 0.5), ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"flash verify kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
