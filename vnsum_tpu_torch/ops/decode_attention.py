"""Flash decode attention over the stacked KV cache (kernels K2 and K2p).

Counterpart of ``vnsum_tpu/ops/decode_attention.py``
(``flash_decode_attention``) in both of its modes. One query token per row
attends layer ``layer_idx`` of the stacked cache; the batch shares one
``fill``, the last valid slot, and the mask is ``pad_b <= k <= fill`` and
``window == 0 or k > fill - window``. ``fill`` is an int, or a one-element
int32 tensor on the query's device, which the kernel reads there (clamped
to ``[0, C - 1]``) with no host copy. The reference is f32, with the same
int8 algebra as the prefill kernel.

- K2, :func:`flash_decode_attention` (``return_partials=False``): the
  normalised output [B, 1, H, hd] in q's dtype.
- K2p, :func:`flash_decode_partials` (``return_partials=True``): the
  unnormalised online-softmax state ``(o [B, H, hd], m [B, H], l [B, H])``,
  all f32, that the long-context decode merges across the ranks of its
  sequence group (``backend/long_context.py``). A row that sees no key
  comes out exactly ``m = -1e30``, ``l = 0``, ``o = 0``, inert in that
  merge.

Both launch the CUDA kernel (``csrc/flash_decode.cu``, whose two passes
they share: bf16 tensor cores with per-warp ``cp.async`` rings, then a
merge of the splits with one warp per query head) for tensors on the card
and take their plain versions, :func:`flash_decode_attention_ref` and
:func:`flash_decode_partials_ref`, only for tensors on the CPU.
``launches`` counts K2's kernel launches and ``partials_launches`` K2p's.
K2 takes head_dim 128 and 256 (Gemma3), K2p 128 only (ROADMAP B4).
"""
from __future__ import annotations

import ctypes

import torch

from . import kernels
from .flash_attention import (
    HEAD_DIM,
    HEAD_DIMS,
    NEG,
    cache_layer,
    attention_ref,
    check_cache,
    check_query,
    pointers,
    require_head_dim,
    visible_mask,
)

launches = 0
partials_launches = 0
_lib = None


def _host_fill(fill, C: int) -> int:
    """The fill as an int: a tensor's clamped to [0, C - 1], as the kernel
    clamps a fill it reads on the device."""
    if isinstance(fill, torch.Tensor):
        return min(max(int(fill.reshape(())), 0), C - 1)
    return int(fill)


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
    mask = visible_mask(torch.tensor([_host_fill(fill, C)]), pad_lens, window or 0, C)
    k, v, ks, vs = cache_layer(cache, layer_idx)
    return attention_ref(q, k, v, ks, vs, mask, torch.float32)


def flash_decode_partials_ref(
    q, cache, layer_idx, pad_lens, fill, q_per_kv, window=None
):
    """Plain version of :func:`flash_decode_partials` (f32 throughout):
    the TPU kernel's return_partials state, one batch row at a time."""
    B, S, H, hd = q.shape
    if S != 1:
        raise ValueError(f"decode attention is single-token (S=1), got S={S}")
    KV, C = cache["k"].shape[2], cache["k"].shape[3]
    if H != q_per_kv * KV:
        raise ValueError(f"q_per_kv={q_per_kv} inconsistent with H={H}")
    mask = visible_mask(torch.tensor([_host_fill(fill, C)]), pad_lens, window or 0, C)[:, 0]
    k, v, ks, vs = cache_layer(cache, layer_idx)
    scale = 1.0 / (hd ** 0.5)
    o = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    for b in range(B):
        qg = q[b, 0].float().reshape(KV, q_per_kv, hd)                   # [KV, G, hd]
        s = torch.matmul(qg, k[b].float().transpose(-1, -2)) * scale      # [KV, G, C]
        if ks is not None:
            s = s * ks[b][:, None, :]
        live = mask[b][None, None]
        s = torch.where(live, s, torch.full_like(s, NEG))
        mb = s.amax(dim=-1, keepdim=True)
        p = torch.where(live, torch.exp(s - mb), torch.zeros_like(s))
        l[b] = p.sum(dim=-1).reshape(H)
        if vs is not None:
            p = p * vs[b][:, None, :]
        o[b] = torch.matmul(p, v[b].float()).reshape(H, hd)
        m[b] = mb.reshape(H)
    return o, m, l


def _library():
    global _lib
    if _lib is None:
        lib = kernels.load("flash_decode")
        fn = lib.vnsum_flash_decode
        fn.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        fn = lib.vnsum_flash_decode_partials
        fn.argtypes = (
            [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.vnsum_flash_decode_splits.argtypes = [ctypes.c_int]
        lib.vnsum_flash_decode_smem.argtypes = [ctypes.c_int, ctypes.c_int]
        for name in ("vnsum_flash_decode_splits", "vnsum_flash_decode_smem"):
            getattr(lib, name).restype = ctypes.c_int
        _lib = lib
    return _lib


def _checked_launch_args(q, cache, layer_idx, pad_lens, fill, q_per_kv, window, head_dims):
    """Raise unless the kernel takes these inputs (a head_dim of
    ``head_dims``); returns (quantized, win, the device fill or None, the
    host fill, the pass-1 scratch (o, m, l) sized for the cache)."""
    check_query(q, pad_lens, head_dims)
    quantized = check_cache(q, cache, layer_idx)
    B, S, H, hd = q.shape
    KV, C = cache["k"].shape[2], cache["k"].shape[3]
    if S != 1:
        raise ValueError(f"decode attention is single-token (S=1), got S={S}")
    if H != KV * q_per_kv or q_per_kv > 8:
        raise ValueError(f"q_per_kv={q_per_kv} with H/KV={H}/{KV} (kernel takes groups <= 8)")
    win = int(window or 0)
    if win < 0:
        raise ValueError(f"window={win} must be >= 0")
    if isinstance(fill, torch.Tensor):
        # read on the device, clamped there to [0, C - 1]: no host copy
        if fill.dtype != torch.int32 or fill.numel() != 1 or fill.device != q.device:
            raise ValueError("a tensor fill must be one int32 element on the query's device")
        fill_dev, fill_host = fill, 0
    else:
        fill_dev, fill_host = None, int(fill)
        if not 0 <= fill_host < C:
            raise ValueError(f"fill={fill_host} outside cache of {C} slots")
    # the kernel splits the cache across blocks, a split count from C; each
    # split leaves an unnormalised (o, m, l) partial that its second pass merges
    splits = _library().vnsum_flash_decode_splits(C)
    o_part = torch.empty((B, KV, splits, q_per_kv, hd), dtype=torch.float32, device=q.device)
    m_part = torch.empty((B, KV, splits, q_per_kv), dtype=torch.float32, device=q.device)
    return quantized, win, fill_dev, fill_host, (o_part, m_part, torch.empty_like(m_part))


def _stream(q):
    return ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)


def flash_decode_attention(
    q: torch.Tensor,          # [B, 1, H, hd]
    cache: dict,              # stacked {"k","v"[, "ks","vs"]} (models.llama.init_kv_cache)
    layer_idx: int,
    pad_lens: torch.Tensor,   # [B] int32
    fill: int | torch.Tensor,  # last valid slot (inclusive); or int32 [1] on the device
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
    quantized, win, fill_dev, fill_host, scratch = _checked_launch_args(
        q, cache, layer_idx, pad_lens, fill, q_per_kv, window, HEAD_DIMS
    )
    B, _, H, hd = q.shape
    KV, C = cache["k"].shape[2], cache["k"].shape[3]
    out = torch.empty_like(q)
    ks = cache["ks"] if quantized else None
    vs = cache["vs"] if quantized else None
    rc = _library().vnsum_flash_decode(
        *pointers(q, cache["k"], cache["v"], ks, vs, pad_lens, fill_dev, out, *scratch),
        B, H, KV, C, hd, int(layer_idx), fill_host, win, int(quantized),
        1.0 / (hd ** 0.5), _stream(q),
    )
    if rc != 0:
        raise RuntimeError(f"flash decode kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def flash_decode_partials(
    q: torch.Tensor,          # [B, 1, H, hd]
    cache: dict,              # stacked {"k","v"[, "ks","vs"]}
    layer_idx: int,
    pad_lens: torch.Tensor,   # [B] int32
    fill: int | torch.Tensor,  # last valid slot (inclusive); or int32 [1] on the device
    q_per_kv: int,
    window: int | None = None,  # 0/None = global
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns the unnormalised state (o [B, H, hd], m [B, H], l [B, H]),
    all f32, m in natural-log units. CPU tensors take the plain version;
    CUDA tensors launch the kernel, or raise."""
    global partials_launches
    if q.device.type == "cpu":
        return flash_decode_partials_ref(
            q, cache, layer_idx, pad_lens, fill, q_per_kv, window
        )
    if q.device.type != "cuda":
        raise ValueError(f"no flash decode kernel for device {q.device}")
    require_head_dim("K2p (flash_decode_partials)", q.shape[-1])
    quantized, win, fill_dev, fill_host, scratch = _checked_launch_args(
        q, cache, layer_idx, pad_lens, fill, q_per_kv, window, (HEAD_DIM,)
    )
    B, _, H, hd = q.shape
    KV, C = cache["k"].shape[2], cache["k"].shape[3]
    o = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    ks = cache["ks"] if quantized else None
    vs = cache["vs"] if quantized else None
    rc = _library().vnsum_flash_decode_partials(
        *pointers(q, cache["k"], cache["v"], ks, vs, pad_lens, fill_dev, o, m, l, *scratch),
        B, H, KV, C, hd, int(layer_idx), fill_host, win, int(quantized),
        1.0 / (hd ** 0.5), _stream(q),
    )
    if rc != 0:
        raise RuntimeError(f"flash decode partials kernel launch failed: CUDA error {rc}")
    partials_launches += 1
    return o, m, l
