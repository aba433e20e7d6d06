"""Flash prefill attention over the stacked KV cache (kernel K1).

Counterpart of ``vnsum_tpu/ops/flash_attention.py``. S prefill queries per
row sit at cache slots ``[q_offset, q_offset + S)`` and attend layer
``layer_idx`` of the stacked cache ``[L, B, KV, C, hd]`` with the mask
``pad_b <= k <= q`` and ``window == 0 or k > q - window``; no per-layer copy
of the cache is made. With an int8 cache the scores are multiplied by
``ks[k]``; ``l`` sums the unscaled probabilities, and ``p * vs[k]`` goes
into the PV product. A query row that sees no key (left pad, all-pad filler
rows) comes out as 0 — the dense path would give a uniform average instead.

:func:`flash_prefill_attention` launches the CUDA kernel
(``csrc/flash_prefill.cu``) for tensors on the card and takes the plain
version, :func:`flash_prefill_attention_ref`, only for tensors on the CPU.
``launches`` counts kernel launches. The kernel takes head_dim 128 and 256
(Gemma3, with each layer's window passed at run time).
"""
from __future__ import annotations

import ctypes

import torch

from . import kernels

NEG = -1e30
REF_TEMP_BYTES = 2**31  # the plain version's largest f32 score temporary
HEAD_DIM = 128  # the head_dim every CUDA kernel takes, and the only one K2p takes
# the head_dims K1, K2 and K3 take (256: Gemma3); K2p takes HEAD_DIM only
HEAD_DIMS = (128, 256)
B4 = ("ROADMAP B4: K2p at head_dim 256, and every kernel at a head_dim above 256 "
      "(no registry model has one), are not written yet")

launches = 0
_lib = None


def supports_flash(head_dim: int) -> bool:
    """Whether K1 and K2 take this head_dim on the card. The JAX kernels
    take any multiple of 128; head_dim 64 (Llama-3.2-1B) runs dense
    attention there and here."""
    return head_dim in HEAD_DIMS


def supports_verify(head_dim: int) -> bool:
    """Whether K3, the spec path's and the slot loop's kernel, takes this
    head_dim on the card (the JAX kernel takes any multiple of 128)."""
    return head_dim in HEAD_DIMS


def require_head_dim(kernel: str, head_dim: int, dims=(HEAD_DIM,)) -> None:
    """Raise NotImplementedError, naming ROADMAP B4, for a head_dim of the
    JAX kernels' (a multiple of 128) that ``kernel`` does not take yet."""
    if head_dim % 128 == 0 and head_dim not in dims:
        raise NotImplementedError(f"{kernel} at head_dim {head_dim}: {B4}")


def visible_mask(q_slots, pad_lens, window, cache_len: int):
    """[B, S, C] bool: query at cache slot q_slots[s] of row b sees slot k
    iff pad_b <= k <= q_slots[s] and (window == 0 or k > q_slots[s] - window)."""
    k = torch.arange(cache_len, device=pad_lens.device)
    qs = q_slots.to(pad_lens.device)[None, :, None]
    mask = (k[None, None, :] >= pad_lens.long()[:, None, None]) & (k[None, None, :] <= qs)
    if window:
        mask = mask & (k[None, None, :] > qs - int(window))
    return mask


def attention_ref(q, k, v, ks, vs, mask, p_dtype):
    """The kernels' function in plain PyTorch, one batch row at a time.

    q [B, S, H, hd]; k/v [B, KV, C, hd] in any dtype; ks/vs [B, KV, C] f32
    or None; mask [B, S, C]. Scores and sums are f32; ``p`` is rounded to
    ``p_dtype`` before the PV product. Returns [B, S, H, hd] in q's dtype."""
    B, S, H, hd = q.shape
    KV, C = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    out = torch.empty_like(q)
    # one row at a time, and of a row as many KV heads as keep each f32
    # [heads, G, S, C] temporary within REF_TEMP_BYTES (a map-batch row of
    # Phi-4, 40 query heads, is 2.7 GB); heads never mix, so this is the
    # same function
    step = max(1, min(KV, REF_TEMP_BYTES // (G * S * C * 4)))
    for b in range(B):
        for h0 in range(0, KV, step):
            h = slice(h0, min(KV, h0 + step))
            qg = q[b].float().reshape(S, KV, G, hd)[:, h].permute(1, 2, 0, 3)  # [kv, G, S, hd]
            s = torch.matmul(qg, k[b, h].float()[:, None].transpose(-1, -2)) * scale
            if ks is not None:
                s = s * ks[b, h][:, None, None, :]
            live = mask[b][None, None]                                     # [1, 1, S, C]
            s = torch.where(live, s, torch.full_like(s, NEG))
            m = s.amax(dim=-1, keepdim=True)
            p = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
            l = p.sum(dim=-1, keepdim=True)
            if vs is not None:
                p = p * vs[b, h][:, None, None, :]
            p = p.to(p_dtype).float()
            o = torch.matmul(p, v[b, h].float()[:, None]) / l.clamp_min(1e-30)  # [kv, G, S, hd]
            out[b, :, h.start * G : h.stop * G] = (
                o.permute(2, 0, 1, 3).reshape(S, -1, hd).to(q.dtype))
    return out


def cache_layer(cache: dict, layer_idx: int):
    ks = cache["ks"][layer_idx] if "ks" in cache else None
    vs = cache["vs"][layer_idx] if "vs" in cache else None
    return cache["k"][layer_idx], cache["v"][layer_idx], ks, vs


def flash_prefill_attention_ref(
    q, cache, layer_idx, pad_lens, q_per_kv, window=None, q_offset=None
):
    """Plain version of :func:`flash_prefill_attention`: same masks, same
    int8 algebra, ``p`` rounded to the query dtype before PV."""
    B, S, H, _ = q.shape
    C = cache["k"].shape[3]
    if H != q_per_kv * cache["k"].shape[2]:
        raise ValueError(f"q_per_kv={q_per_kv} inconsistent with H={H}")
    off = int(q_offset or 0)
    q_slots = torch.arange(off, off + S)
    mask = visible_mask(q_slots, pad_lens, window or 0, C)
    k, v, ks, vs = cache_layer(cache, layer_idx)
    return attention_ref(q, k, v, ks, vs, mask, q.dtype)


def check_cache(q, cache: dict, layer_idx: int) -> bool:
    """Raise unless the kernels take this cache (its head_dim q's); returns
    whether it is int8."""
    k, v = cache["k"], cache["v"]
    if k.dim() != 5 or k.shape != v.shape or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"cache must be [L, B, KV, C, {q.shape[-1]}], got {tuple(k.shape)}")
    if k.shape[1] != q.shape[0]:
        raise ValueError(f"cache batch {k.shape[1]} != query batch {q.shape[0]}")
    if not 0 <= layer_idx < k.shape[0]:
        raise ValueError(f"layer {layer_idx} outside [0, {k.shape[0]})")
    quantized = "ks" in cache
    want = torch.int8 if quantized else torch.bfloat16
    tensors = [k, v] + ([cache["ks"], cache["vs"]] if quantized else [])
    if k.dtype != want or v.dtype != want:
        raise ValueError(f"cache K/V must be {want}, got {k.dtype}/{v.dtype}")
    if quantized:
        for s in (cache["ks"], cache["vs"]):
            if s.dtype != torch.float32 or s.shape != k.shape[:-1]:
                raise ValueError("int8 cache scales must be f32 [L, B, KV, C]")
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("cache tensors must be contiguous and on the query's device")
    return quantized


def check_query(q, pad_lens, head_dims=HEAD_DIMS) -> None:
    """Raise unless the kernels take this query (a head_dim of
    ``head_dims``) and these pads."""
    if q.dtype != torch.bfloat16 or q.dim() != 4 or q.shape[-1] not in head_dims:
        raise ValueError(f"q must be bf16 [B, S, H, hd] with hd in {head_dims}, "
                         f"got {q.dtype} {tuple(q.shape)}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if (
        pad_lens.dtype != torch.int32 or pad_lens.shape != (q.shape[0],)
        or pad_lens.device != q.device or not pad_lens.is_contiguous()
    ):
        raise ValueError("pad_lens must be a contiguous int32 [B] tensor on q's device")


def pointers(*tensors) -> list:
    return [ctypes.c_void_p(t.data_ptr() if t is not None else 0) for t in tensors]


def _library():
    global _lib
    if _lib is None:
        lib = kernels.load("flash_prefill")
        fn = lib.vnsum_flash_prefill
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def flash_prefill_attention(
    q: torch.Tensor,          # [B, S, H, hd]
    cache: dict,              # stacked {"k","v"[, "ks","vs"]} (models.llama.init_kv_cache)
    layer_idx: int,
    pad_lens: torch.Tensor,   # [B] int32 left pads
    q_per_kv: int,
    window: int | None = None,    # 0/None = global
    q_offset: int | None = None,  # cache slot of query 0 (chunked prefill)
) -> torch.Tensor:
    """Returns [B, S, H, hd] in q's dtype. CPU tensors take the plain
    version; CUDA tensors launch the kernel, or raise."""
    global launches
    if q.device.type == "cpu":
        return flash_prefill_attention_ref(
            q, cache, layer_idx, pad_lens, q_per_kv, window, q_offset
        )
    if q.device.type != "cuda":
        raise ValueError(f"no flash prefill kernel for device {q.device}")
    check_query(q, pad_lens)
    quantized = check_cache(q, cache, layer_idx)
    B, S, H, hd = q.shape
    L, _, KV, C, _ = cache["k"].shape
    if H != KV * q_per_kv:
        raise ValueError(f"q_per_kv={q_per_kv} inconsistent with H/KV={H}/{KV}")
    off = int(q_offset or 0)
    win = int(window or 0)
    if off < 0 or off + S > C or win < 0:
        raise ValueError(f"queries [{off}, {off + S}) outside cache of {C} slots")
    out = torch.empty_like(q)
    ks = cache["ks"] if quantized else None
    vs = cache["vs"] if quantized else None
    rc = _library().vnsum_flash_prefill(
        *pointers(q, cache["k"], cache["v"], ks, vs, pad_lens, out),
        B, S, H, KV, C, hd, int(layer_idx), win, off, int(quantized),
        1.0 / (hd ** 0.5), ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"flash prefill kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
