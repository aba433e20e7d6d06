"""Products against int8 weights: the int8-weight GEMV kernel, its plain
version, and the routing of every int8 projection and LM head.

Counterpart of ``_proj`` and ``_lm_head_logits`` in
``vnsum_tpu/models/llama.py``, where XLA fuses the int8-to-bf16 convert into
the matmul's tile loads. Weights are in the stored layout of
``models/quant.py``: ``q [N, K]`` int8, output channel major, and ``s [N]``
f32. Per output the function is ``sum_k f32(x[m, k]) * f32(q[n, k])``
(each product exact in f32), then

- projection mode: rounded to x's dtype, times ``s[n]`` in f32, rounded to
  x's dtype again (JAX's ``(y.astype(f32) * s).astype(x.dtype)``);
- head mode: times ``s[n]`` in f32, no rounding (the f32 logits).

:func:`int8_gemv` launches the hand-written CUDA kernel
(``csrc/int8_gemv.cu``) for tensors on the card, M <= :data:`MAX_M` rows
of bf16 x, and takes the plain version, :func:`int8_gemv_ref`, only for
tensors on the CPU. :func:`int8_gemv_group` runs up to three weights that
share their x (q/k/v, gate/up) in one launch of the same kernel; its plain
version is the members' plain versions one after another. ``launches``
counts kernel launches, a grouped launch as one. :func:`gemv_plan` picks
the launch's thread block cluster, the blocks that split K for the same 64
channels.

:func:`int8_linear`, :func:`int8_linear_group` and :func:`int8_head` route
by M alone: M <= MAX_M (decode, the spec verify forward, the slot segment,
the long decode, the LM head of a ``last_only`` prefill) goes through the
GEMV; a larger M (a prefill) dequantizes the weight to x's dtype, which is
exact, and calls ``torch.matmul``, the plain large product the JAX package
leaves to XLA. W8A8 (``act_quant``) quantizes x per token and runs the s8 x
s8 -> s32 product as ``torch._int_mm``, one weight at a time.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernels

MAX_M = 128  # most rows of x the kernel takes
K_ALIGN = 16  # the kernel reads q in 16-byte chunks along K
TILE_N = 64  # output channels of a block (csrc/int8_gemv.cu)
CHUNK_K = 256  # K bytes of one stage of the kernel's ring
MAX_CLUSTER = 8  # most blocks of a thread block cluster (the portable limit)
MAX_MEMBERS = 3  # weights one launch takes

launches = 0
_lib = None
_sms: dict[int, int] = {}


def int8_gemv_ref(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, head: bool = False):
    """Plain version of :func:`int8_gemv`: x [M, K], q [N, K] int8, s [N]
    f32 -> [M, N], x's dtype (projection) or f32 (head)."""
    y = x.float() @ q.float().t()
    if head:
        return y * s
    return (y.to(x.dtype).float() * s).to(x.dtype)


def gemv_plan(ns, K: int, M: int, sms: int) -> tuple[int, int]:
    """(tiles, cluster) of one launch over weights of ``ns`` output
    channels, K bytes a row and M rows of x: the members' 64-channel
    tiles, and the blocks of a cluster that split K for each tile. With M
    <= 8 rows that is the smallest power of two up to MAX_CLUSTER that puts
    a block on at least half of ``sms`` SMs (on an H100 larger clusters
    measured slower: their blocks wait for each other), or gives each
    block one 256-byte chunk of K; with more rows 1 (the kernel's blocks
    then need an SM each, and clusters of them wait for whole groups of
    free SMs)."""
    tiles = sum(-(-n // TILE_N) for n in ns)
    chunks = -(-K // CHUNK_K)
    cluster = 1
    while (M <= 8 and cluster < MAX_CLUSTER and 2 * tiles * cluster < sms
           and 2 * cluster <= chunks):
        cluster *= 2
    return tiles, cluster


def _library():
    global _lib
    if _lib is None:
        lib = kernels.load("int8_gemv")
        fn = lib.vnsum_int8_gemv_group
        fn.argtypes = ([ctypes.c_void_p] + ([ctypes.c_void_p] * 3 + [ctypes.c_int]) * 3
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def _check_x(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no int8 GEMV kernel for device {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous bf16 [M, K] tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    M, K = x.shape
    if not 1 <= M <= MAX_M or K % K_ALIGN:
        raise ValueError(f"x [{M}, {K}]: the kernel takes 1 <= M <= {MAX_M} and K a "
                         f"multiple of {K_ALIGN}")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (the kernel's TMA boxes)")


def _check_member(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> None:
    K = x.shape[1]
    if (q.dtype != torch.int8 or q.dim() != 2 or q.shape[1] != K or not q.is_contiguous()
            or q.device != x.device):
        raise ValueError(f"q must be a contiguous int8 [N, {K}] tensor on {x.device}, got "
                         f"{q.dtype} {tuple(q.shape)} on {q.device}")
    N = q.shape[0]
    if q.data_ptr() % 16:
        raise ValueError("q must start on a 16-byte boundary (the kernel's TMA boxes)")
    if (s.dtype != torch.float32 or s.shape != (N,) or not s.is_contiguous()
            or s.device != x.device):
        raise ValueError(f"s must be a contiguous f32 [{N}] tensor on {x.device}")


def int8_gemv_group(x: torch.Tensor, members, head: bool = False) -> list:
    """x [M, K] times each of up to three int8 weights ``members`` = [(q
    [N_j, K], s [N_j]), ...] in one launch; returns [M, N_j] tensors in x's
    dtype (projection mode) or f32 (``head``). CPU tensors take the plain
    version, member by member; CUDA tensors launch the kernel, or raise for
    inputs it does not take (bf16 x, M <= MAX_M, K a multiple of 16,
    contiguous, 1-3 members on x's device)."""
    global launches
    members = list(members)
    if not 1 <= len(members) <= MAX_MEMBERS:
        raise ValueError(f"the GEMV takes 1 to {MAX_MEMBERS} weights a launch, "
                         f"got {len(members)}")
    if x.device.type == "cpu":
        return [int8_gemv_ref(x, q, s, head) for q, s in members]
    _check_x(x)
    for q, s in members:
        _check_member(x, q, s)
    M, K = x.shape
    ns = [q.shape[0] for q, _ in members]
    tiles, cluster = gemv_plan(ns, K, M, _sm_count(x.device))
    outs = [torch.empty((M, n), dtype=torch.float32 if head else x.dtype, device=x.device)
            for n in ns]
    args = []
    for j in range(MAX_MEMBERS):
        if j < len(members):
            q, s = members[j]
            args += [q.data_ptr(), s.data_ptr(), outs[j].data_ptr(), ns[j]]
        else:
            args += [None, None, None, 0]
    rc = _library().vnsum_int8_gemv_group(
        x.data_ptr(), *args, len(members), M, K, int(head), cluster,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"int8 GEMV kernel launch failed: CUDA error {rc}")
    launches += 1
    return outs


def int8_gemv(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, head: bool = False):
    """x [M, K] times the int8 weight q [N, K] with per-channel scales s
    [N]; returns [M, N] in x's dtype (projection mode) or f32 (``head``).
    CPU tensors take the plain version; CUDA tensors launch the kernel, or
    raise for inputs it does not take (bf16 x, M <= MAX_M, K a multiple of
    16, contiguous)."""
    return int8_gemv_group(x, [(q, s)], head)[0]


def w8a8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                amax_reduce=None) -> torch.Tensor:
    """W8A8 (``act_quant``): x [M, K] quantized per token (absmax over K,
    ``s_x = max(amax, 1e-8) / 127``, ``clip(round(x / s_x), -127, 127)``),
    the exact s32 product with q [N, K], then ``(f32(y) * s_x) * s``, cast
    to x's dtype. On the card ``torch._int_mm`` needs more than 16 rows:
    fewer are padded with zero rows. ``amax_reduce`` (in place) takes each
    token's absmax over a contraction split across ranks (a tensor-parallel
    shard's ``wo`` and ``w_down``)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    sx = amax.clamp_min(1e-8) / 127.0
    qx = torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8)
    M = qx.shape[0]
    if qx.is_cuda and M <= 16:
        qx = torch.cat([qx, qx.new_zeros((17 - M, qx.shape[1]))])
    y = torch._int_mm(qx, q.t())[:M]
    return ((y.float() * sx) * s).to(x.dtype)


def int8_linear(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, act_quant: bool = False,
                amax_reduce=None):
    """x [..., K] against the int8 weight q [N, K], s [N] -> [..., N] in
    x's dtype: W8A8 with ``act_quant`` (``amax_reduce`` as
    :func:`w8a8_matmul`'s), else the GEMV for M <= MAX_M rows and a
    dequantized ``torch.matmul`` above."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if act_quant:
        y = w8a8_matmul(x2, q, s, amax_reduce)
    elif x2.shape[0] <= MAX_M:
        y = int8_gemv(x2.contiguous(), q, s)
    else:
        y = torch.matmul(x2, q.to(x.dtype).t())
        y = (y.float() * s).to(x.dtype)
    return y.view(*lead, q.shape[0])


def int8_head(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The LM head against int8 rows q [V, D], s [V]: x [M, D] -> f32
    logits [M, V], the f32 result of the product times s."""
    if x.shape[0] <= MAX_M:
        return int8_gemv(x.contiguous(), q, s, head=True)
    if x.is_cuda and x.dtype != torch.float32:
        y = torch.mm(x, q.to(x.dtype).t(), out_dtype=torch.float32)
    else:
        y = x.float() @ q.float().t()
    return y * s


def int8_linear_group(x: torch.Tensor, members, act_quant: bool = False) -> list:
    """x [..., K] against each int8 weight of ``members`` = [(q [N_j, K],
    s [N_j]), ...], which share x: [..., N_j] tensors in x's dtype, the
    same as :func:`int8_linear` member by member. M <= MAX_M rows without
    W8A8 run as one grouped GEMV launch; every other route stays
    :func:`int8_linear`'s, one weight at a time."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if act_quant or x2.shape[0] > MAX_M:
        return [int8_linear(x, q, s, act_quant) for q, s in members]
    ys = int8_gemv_group(x2.contiguous(), members)
    return [y.view(*lead, q.shape[0]) for y, (q, _) in zip(ys, members)]
