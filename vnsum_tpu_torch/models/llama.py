"""Llama-3.2 family decoder in PyTorch.

Counterpart of ``vnsum_tpu/models/llama.py``. The parameters keep the JAX
package's layout — every layer weight stacked on a leading L dim, Q/K/V
projections shaped ``[D, H, hd]`` — so a JAX parameter tree maps onto the
port one to one (:func:`params_from_numpy`), and the decoder runs as a
Python loop over layers that indexes the stacks (views, no copies).

- GQA attention with RoPE (llama3 frequency scaling), RMSNorm, SwiGLU, and
  Qwen3's per-head Q/K RMSNorm (``qk_norm``);
- Gemma3's deltas, each off by default: GeGLU (``act="gelu_tanh"``),
  sandwich norms, plus-one norms, the embedding scaled by sqrt(dim), a
  query scale folded into q, and sliding-window layers with a local RoPE
  base beside the global ones (``layer_windows``);
- a preallocated stacked KV cache ``[L, B, KV, C, hd]``, bf16, or int8 with
  per-(token, head) f32 scales. Unlike the JAX package, whose arrays are
  immutable, the port writes each layer's new K/V into the cache IN PLACE;
- bf16 storage and matmuls, f32 norms, softmax and logits;
- int8 matmul weights with per-output-channel f32 scales (``models/quant.py``,
  built by ``quantize_model`` or carried from a JAX ``quantize_params``
  tree by :func:`params_from_numpy`), held in the stored layout ``[L, N, K]``
  and multiplied by ``ops/int8_matmul.py``: the int8-weight GEMV kernel on
  small-M forwards, W8A8 prefill with ``w8a8_prefill``.

``forward`` takes a ``stacked_attention_fn(q, cache, layer_idx)`` that reads
the whole stacked cache (the prefill and decode kernels); without one it runs
dense attention over the layer's dequantized cache.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8_matmul import int8_head, int8_linear, int8_linear_group
from .quant import _CONTRACT_AXES, stored_shapes, to_stored


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    dim: int = 3072
    n_layers: int = 28
    n_heads: int = 24
    n_kv_heads: int = 8
    head_dim: int = 128
    intermediate: int = 8192
    rope_theta: float = 500_000.0
    use_llama3_rope_scaling: bool = True
    rope_scale_factor: float = 32.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_len: int = 8192
    # linear position scaling (HF rope_scaling type "linear"): positions are
    # divided by this factor before the rotation; 0 = off
    rope_linear_factor: float = 0.0
    norm_eps: float = 1e-5
    max_seq_len: int = 16_384
    tie_embeddings: bool = True
    # Qwen3-style per-head RMSNorm on Q/K before RoPE
    qk_norm: bool = False
    # --- Gemma3 deltas, all off by default ---
    act: str = "silu"              # "silu" | "gelu_tanh" (GeGLU)
    sandwich_norms: bool = False   # post-attention and post-FFW norms
    norm_plus_one: bool = False    # RMSNorm scale is (1 + w), zero-init w
    embed_scale: bool = False      # hidden states scaled by sqrt(dim)
    query_scale: float = 0.0       # 0 => 1/sqrt(head_dim); else 1/sqrt(this)
    sliding_window: int = 0        # 0 => every layer attends globally
    # per layer when sliding_window > 0: True = global (Gemma3: 5 sliding : 1)
    layer_is_global: tuple = ()
    rope_local_theta: float = 10_000.0  # RoPE base of the sliding layers
    dtype: torch.dtype = torch.bfloat16
    # W8A8 prefill (int8 weights only): multi-token forwards at one write
    # slot also quantize activations per token into an s8 x s8 product
    w8a8_prefill: bool = False

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads


def llama32_3b(**kw) -> LlamaConfig:
    return LlamaConfig(**kw)


def llama32_1b(**kw) -> LlamaConfig:
    base = dict(
        dim=2048, n_layers=16, n_heads=32, n_kv_heads=8, head_dim=64,
        intermediate=8192,
    )
    base.update(kw)
    return LlamaConfig(**base)


def qwen3_8b(**kw) -> LlamaConfig:
    base = dict(
        vocab_size=151_936, dim=4096, n_layers=36, n_heads=32, n_kv_heads=8,
        head_dim=128, intermediate=12_288, rope_theta=1_000_000.0,
        use_llama3_rope_scaling=False, norm_eps=1e-6, max_seq_len=32_768,
        tie_embeddings=False, qk_norm=True,
    )
    base.update(kw)
    return LlamaConfig(**base)


def gemma3_4b(**kw) -> LlamaConfig:
    """Gemma3-4B text decoder: head_dim 256, a 1024-slot window on five
    layers of six."""
    n_layers = 34
    base = dict(
        vocab_size=262_208, dim=2560, n_layers=n_layers, n_heads=8,
        n_kv_heads=4, head_dim=256, intermediate=10_240,
        rope_theta=1_000_000.0, use_llama3_rope_scaling=False,
        rope_linear_factor=8.0, norm_eps=1e-6, max_seq_len=32_768,
        tie_embeddings=True, qk_norm=True, act="gelu_tanh",
        sandwich_norms=True, norm_plus_one=True, embed_scale=True,
        query_scale=256.0, sliding_window=1024,
        layer_is_global=tuple((i + 1) % 6 == 0 for i in range(n_layers)),
        rope_local_theta=10_000.0,
    )
    base.update(kw)
    return LlamaConfig(**base)


def phi4_14b(**kw) -> LlamaConfig:
    """Phi-4 decoder: Llama math (no QK norm, no window, untied head);
    its checkpoints fuse q/k/v and gate/up (``models/convert.py``)."""
    base = dict(
        vocab_size=100_352, dim=5120, n_layers=40, n_heads=40,
        n_kv_heads=10, head_dim=128, intermediate=17_920,
        rope_theta=250_000.0, use_llama3_rope_scaling=False,
        norm_eps=1e-5, max_seq_len=16_384, tie_embeddings=False,
    )
    base.update(kw)
    return LlamaConfig(**base)


def qwen3_0p6b(**kw) -> LlamaConfig:
    base = dict(
        vocab_size=151_936, dim=1024, n_layers=28, n_heads=16, n_kv_heads=8,
        head_dim=128, intermediate=3072, rope_theta=1_000_000.0,
        use_llama3_rope_scaling=False, norm_eps=1e-6, max_seq_len=32_768,
        tie_embeddings=True, qk_norm=True,
    )
    base.update(kw)
    return LlamaConfig(**base)


def tiny_llama(**kw) -> LlamaConfig:
    """Small config for hermetic CPU tests."""
    base = dict(
        vocab_size=384, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        head_dim=16, intermediate=128, max_seq_len=256,
        use_llama3_rope_scaling=False, rope_theta=10_000.0,
        dtype=torch.float32,
    )
    base.update(kw)
    return LlamaConfig(**base)


# -- parameters -------------------------------------------------------------

_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down")


def _param_shapes(cfg: LlamaConfig) -> dict:
    L, D, H, KV, hd, I = (
        cfg.n_layers, cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        cfg.intermediate,
    )
    layers = {
        "attn_norm": (L, D), "wq": (L, D, H, hd), "wk": (L, D, KV, hd),
        "wv": (L, D, KV, hd), "wo": (L, H, hd, D), "mlp_norm": (L, D),
        "w_gate": (L, D, I), "w_up": (L, D, I), "w_down": (L, I, D),
    }
    if cfg.qk_norm:
        layers["q_norm"] = (L, hd)
        layers["k_norm"] = (L, hd)
    if cfg.sandwich_norms:
        layers["post_attn_norm"] = (L, D)
        layers["post_ffw_norm"] = (L, D)
    shapes = {"embed": (cfg.vocab_size, D), "layers": layers, "final_norm": (D,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, cfg.vocab_size)
    return shapes


def init_params(cfg: LlamaConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random init with the JAX package's scheme (normal * 0.02 for
    matrices; ones for norms, zeros for plus-one norms), drawn from
    ``generator`` on ``device``."""
    shapes = _param_shapes(cfg)
    norm_init = torch.zeros if cfg.norm_plus_one else torch.ones

    def leaf(name, shape):
        if name.endswith("norm"):
            return norm_init(shape, dtype=cfg.dtype, device=device)
        # scaled in place: at Phi-4's widths one f32 leaf is 14.7 GB
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return w.mul_(0.02).to(cfg.dtype)

    tree = {k: leaf(k, v) for k, v in shapes.items() if k != "layers"}
    tree["layers"] = {k: leaf(k, v) for k, v in shapes["layers"].items()}
    return tree


class LlamaModel(nn.Module):
    """The decoder. Holds the stacked parameters of :func:`init_params` or
    :func:`params_from_numpy` (frozen: the port does inference only).

    A matmul weight may instead be an int8 ``{"q", "s"}`` leaf in the
    stored layout of ``models/quant.py``: ``q`` is kept as int8 and ``s``
    as f32 (in ``scales``, under the weight's name), never cast to the
    model dtype."""

    def __init__(self, cfg: LlamaConfig, tree: dict) -> None:
        super().__init__()
        self.cfg = cfg
        shapes = _param_shapes(cfg)
        self.scales = nn.ParameterDict()

        def param(name, t, shape):
            if isinstance(t, dict):
                if name not in _CONTRACT_AXES and name not in ("embed", "lm_head"):
                    raise ValueError(f"{name}: only matmul weights may be int8")
                q_shape, s_shape = stored_shapes(name, shape)
                q, s = t["q"], t["s"]
                if q.dtype != torch.int8 or tuple(q.shape) != q_shape:
                    raise ValueError(f"{name}: int8 values {q.dtype} {tuple(q.shape)}, "
                                     f"expected int8 {q_shape}")
                if s.dtype != torch.float32 or tuple(s.shape) != s_shape:
                    raise ValueError(f"{name}: scales {s.dtype} {tuple(s.shape)}, "
                                     f"expected float32 {s_shape}")
                self.scales[name] = nn.Parameter(s, requires_grad=False)
                return nn.Parameter(q, requires_grad=False)
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
            return nn.Parameter(t.to(cfg.dtype), requires_grad=False)

        self.embed = param("embed", tree["embed"], shapes["embed"])
        self.final_norm = param("final_norm", tree["final_norm"], shapes["final_norm"])
        self.lm_head = (
            None if cfg.tie_embeddings
            else param("lm_head", tree["lm_head"], shapes["lm_head"])
        )
        missing = set(shapes["layers"]) - set(tree["layers"])
        if missing:
            raise ValueError(f"layer parameters missing: {sorted(missing)}")
        self.layers = nn.ParameterDict(
            {k: param(k, tree["layers"][k], s) for k, s in shapes["layers"].items()}
        )

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def quantized(self) -> bool:
        return "embed" in self.scales

    def tree(self) -> dict:
        """The parameters as a tree that builds this model again (int8
        leaves as stored-layout ``{"q", "s"}``), sharing the tensors."""

        def leaf(name, t):
            return {"q": t.data, "s": self.scales[name].data} if name in self.scales else t.data

        out = {"embed": leaf("embed", self.embed), "final_norm": self.final_norm.data,
               "layers": {k: leaf(k, v) for k, v in self.layers.items()}}
        if self.lm_head is not None:
            out["lm_head"] = leaf("lm_head", self.lm_head)
        return out

    # hot path
    def forward(
        self,
        tokens: torch.Tensor,       # [B, S] int
        positions: torch.Tensor,    # [B, S] int (RoPE positions)
        cache: dict,                # stacked {"k","v"[, "ks","vs"]}, written in place
        write_index,                # cache slot of tokens[:, 0]: int, or [B] tensor
        mask: torch.Tensor | None = None,  # [B, S, C] bool; dense attention only
        *,
        last_only: bool = False,
        stacked_attention_fn=None,
    ) -> torch.Tensor:
        """Run the decoder; returns logits [B, S, vocab] f32 (or [B, 1,
        vocab] with ``last_only``) and writes this call's K/V into ``cache``.

        ``write_index`` is one slot for every row (prefill, decode) or a [B]
        tensor of per-row slots (the speculative verify step and the slot
        segment, whose rows sit at different fills); see :func:`cache_write`.

        ``stacked_attention_fn(q, cache, layer_idx)`` replaces the dense
        attention with a consumer of the whole stacked cache (the kernels);
        without it ``mask`` is required."""
        cfg = self.cfg
        if stacked_attention_fn is None and mask is None:
            raise ValueError("dense attention needs a mask")
        x = embed_lookup(self.embed, self.scales.get("embed"), tokens, cfg.dtype)
        if cfg.embed_scale:
            # sqrt(dim) rounded through the model dtype, as the JAX package
            x = x * dtype_scalar(cfg.dim ** 0.5, cfg.dtype)
        windows = layer_windows(cfg)
        # each layer's RoPE table: the global one, or the local one (its own
        # base, no scaling) on sliding layers
        ropes = {0: rope_cos_sin(cfg, positions)}
        if cfg.sliding_window:
            ropes[cfg.sliding_window] = rope_cos_sin(local_rope_config(cfg), positions)
        # the dense path's sliding mask: query slot - window < k
        masks = {0: mask, cfg.sliding_window: mask}
        if mask is not None and cfg.sliding_window:
            masks[cfg.sliding_window] = mask & window_mask(
                write_index, tokens.shape[1], mask.shape[-1], cfg.sliding_window, mask.device
            )
        if torch.is_tensor(write_index):
            # the per-row slots, once for every layer's K/V (and scales)
            write_index = row_slots(write_index, cache["k"].shape[3], tokens.shape[1])
        else:
            write_index = int(write_index)
        for li in range(cfg.n_layers):
            cos, sin = ropes[windows[li]]
            x = self._block(
                x, li, cos, sin, masks[windows[li]], cache, write_index, stacked_attention_fn
            )
        if last_only:
            x = x[:, -1:, :]
        x = rmsnorm(x, self.final_norm, cfg.norm_eps, cfg.norm_plus_one)
        name = "embed" if cfg.tie_embeddings else "lm_head"
        return lm_head_logits(x, getattr(self, name), transposed=cfg.tie_embeddings,
                              scale=self.scales.get(name))

    def _block(self, x, li, cos, sin, mask, cache, write_index, stacked_fn):
        cfg = self.cfg
        p = self.layers
        B, S, D = x.shape
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        # W8A8 only on multi-token forwards at one write slot (prefill): a
        # decode step, the spec verify forward and the slot segment (per-row
        # slots) stay on the exact int8-weight path, as in the JAX package
        aq = cfg.w8a8_prefill and S > 1 and not isinstance(write_index, tuple)

        def proj(t, name):
            s = self.scales.get(name)
            if s is None:  # [K, ...] bf16 in the JAX layout
                return torch.matmul(t, p[name][li].reshape(t.shape[-1], -1))
            return int8_linear(t, p[name][li], s[li], aq)

        def projs(t, names):
            # projections of one input: int8 leaves share one GEMV launch
            if any(self.scales.get(name) is None for name in names):
                return [proj(t, name) for name in names]
            return int8_linear_group(
                t, [(p[name][li], self.scales[name][li]) for name in names], aq)

        P1 = cfg.norm_plus_one
        h = rmsnorm(x, p["attn_norm"][li], cfg.norm_eps, P1)
        q, k, v = projs(h, ("wq", "wk", "wv"))
        q = q.view(B, S, H, hd)
        k = k.view(B, S, KV, hd)
        v = v.view(B, S, KV, hd)
        if cfg.qk_norm:
            q = rmsnorm(q, p["q_norm"][li], cfg.norm_eps, P1)
            k = rmsnorm(k, p["k_norm"][li], cfg.norm_eps, P1)
        if cfg.query_scale:
            # a non-default score scale folded into q, so every attention
            # (dense, kernels) keeps its 1/sqrt(head_dim)
            q = q * dtype_scalar((hd ** 0.5) / (cfg.query_scale ** 0.5), q.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        kt = k.transpose(1, 2)  # [B, KV, S, hd] — cache-native
        vt = v.transpose(1, 2)
        # written in place; the JAX package returns an updated cache instead
        if is_quantized_cache(cache):
            k8, ks = quantize_kv(kt)
            v8, vs = quantize_kv(vt)
            for name, val in (("k", k8), ("v", v8), ("ks", ks), ("vs", vs)):
                cache_write(cache[name][li], val, write_index)
        else:
            cache_write(cache["k"][li], kt, write_index)
            cache_write(cache["v"][li], vt, write_index)

        if stacked_fn is not None:
            attn = stacked_fn(q, cache, li)
        else:
            k_c, v_c = dequantize_cache_layer(cache, li)
            attn = attention(q, k_c.to(q.dtype), v_c.to(q.dtype), mask, cfg.q_per_kv)
        attn_out = proj(attn.reshape(B, S, H * hd), "wo")
        if cfg.sandwich_norms:
            attn_out = rmsnorm(attn_out, p["post_attn_norm"][li], cfg.norm_eps, P1)
        x = x + attn_out

        h = rmsnorm(x, p["mlp_norm"][li], cfg.norm_eps, P1)
        gate, up = projs(h, ("w_gate", "w_up"))
        mlp_out = proj(mlp_act(gate, cfg.act) * up, "w_down")
        if cfg.sandwich_norms:
            mlp_out = rmsnorm(mlp_out, p["post_ffw_norm"][li], cfg.norm_eps, P1)
        return x + mlp_out


def params_from_numpy(tree: dict, cfg: LlamaConfig, device="cuda") -> LlamaModel:
    """Build the port's model from a JAX parameter tree converted to numpy
    (``jax.tree.map(np.asarray, params)``), leaf for leaf. Int8 ``{"q",
    "s"}`` leaves of the JAX package's ``quantize_params`` go into the
    stored layout (``models/quant.py``), their values int8 and their scales
    f32; a malformed one (an int8 norm, values that are not int8, scales
    that do not match the weight's output channels) raises ValueError."""
    shapes = _param_shapes(cfg)
    shapes.update(shapes["layers"])

    def array(a):
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: go through f32, exactly
            arr = arr.astype(np.float32)
        # np.array copies: the model never aliases the caller's buffers
        return torch.from_numpy(np.array(arr)).to(device=device)

    def conv(name, a):
        if not isinstance(a, dict):
            return array(a).to(cfg.dtype)
        if name not in _CONTRACT_AXES and name not in ("embed", "lm_head"):
            raise ValueError(f"{name}: an int8 {{'q', 's'}} leaf, but only matmul weights "
                             "are quantized")
        if set(a) != {"q", "s"}:
            raise ValueError(f"{name}: an int8 leaf has keys {sorted(a)}, expected ['q', 's']")
        q, s = np.asarray(a["q"]), np.asarray(a["s"])
        want = tuple(shapes.get(name, q.shape))
        axes = (1,) if name == "embed" else (0,) if name == "lm_head" else tuple(
            ax + 1 for ax in _CONTRACT_AXES[name])
        channels = tuple(d for i, d in enumerate(want) if i not in axes)
        if q.dtype != np.int8 or q.shape != want:
            raise ValueError(f"{name}: int8 values {q.dtype} {q.shape}, expected int8 {want}")
        if s.shape != channels:
            raise ValueError(f"{name}: scales of shape {s.shape} do not match its output "
                             f"channels {channels}")
        return to_stored(name, {"q": array(q), "s": array(s).float()})

    out = {k: conv(k, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: conv(k, v) for k, v in tree["layers"].items()}
    return LlamaModel(cfg, out)


def init_model(cfg: LlamaConfig, seed: int = 0, device="cuda") -> LlamaModel:
    """Random-init model drawn from a generator seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return LlamaModel(cfg, init_params(cfg, gen, device))


# -- KV cache ---------------------------------------------------------------


def init_kv_cache(
    cfg: LlamaConfig, batch: int, cache_len: int, *, quantized: bool = False,
    device="cuda",
) -> dict:
    """Stacked cache [L, B, KV, C, hd] — KV heads before the sequence dim.
    ``quantized=True`` stores K/V as int8 with per-(token, head) f32 scales
    ``ks``/``vs`` [L, B, KV, C]. Zero-filled: slots not yet written must be
    finite, since masked slots still meet a zero probability in PV."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, cache_len, cfg.head_dim)
    if not quantized:
        return {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=torch.int8, device=device),
        "v": torch.zeros(shape, dtype=torch.int8, device=device),
        "ks": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        "vs": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
    }


def row_slots(write_index: torch.Tensor, C: int, S: int):
    """The (rows, slots) index pair [B, S] of a [B] tensor of per-row
    starts in a cache of C slots, for :func:`cache_write`. Each start is
    clamped to [0, C - S], as the JAX package's ``dynamic_update_slice``
    clamps it: a finished row of the slot segment parks at t = max_new and
    writes at C, which lands on C - 1 instead of past the cache (on the card
    an out-of-bounds index is a device-side assert). Clamping never moves a
    live row's write."""
    B = write_index.shape[0]
    start = write_index.long().clamp(0, C - S)
    slots = start[:, None] + torch.arange(S, device=write_index.device)[None, :]
    return torch.arange(B, device=write_index.device)[:, None].expand(B, S), slots


def cache_write(buf: torch.Tensor, val: torch.Tensor, write_index) -> None:
    """Write one layer's new K/V (or scales) into its cache IN PLACE.

    ``buf`` [B, KV, C(, hd)], ``val`` [B, KV, S(, hd)]. ``write_index`` is
    the slot of val's first token: an int shared by every row; a [B]
    tensor with one slot per row, clamped as :func:`row_slots` says; or
    that tensor's :func:`row_slots` pair, which the decoder computes once
    for all its layers. The tensor forms read nothing on the host, so a
    captured decode step writes at its device step counter."""
    S = val.shape[2]
    if isinstance(write_index, tuple):
        rows, slots = write_index
    elif torch.is_tensor(write_index):
        rows, slots = row_slots(write_index, buf.shape[2], S)
    else:
        buf[:, :, write_index : write_index + S] = val
        return
    # advanced indices on dims 0 and 2: the indexed view is [B, S, KV(, hd)]
    buf[rows, :, slots] = val.transpose(1, 2)


def is_quantized_cache(cache: dict) -> bool:
    return "ks" in cache


def quantize_kv(x: torch.Tensor):
    """x [B, KV, S, hd] -> (int8 values, f32 scales [B, KV, S]): scale =
    max(amax, 1e-8) / 127, round half to even, clip at +-127."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def dequantize_cache_layer(cache: dict, layer_idx: int):
    """Layer ``layer_idx`` as dense float K/V [B, KV, C, hd]."""
    k, v = cache["k"][layer_idx], cache["v"][layer_idx]
    if not is_quantized_cache(cache):
        return k, v
    return (
        k.float() * cache["ks"][layer_idx][..., None],
        v.float() * cache["vs"][layer_idx][..., None],
    )


# -- building blocks --------------------------------------------------------


def embed_lookup(embed: torch.Tensor, scale, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of the embedding; an int8 one (``scale`` [V]) gathers rows and
    scales, multiplies them in f32 and casts to ``dtype``."""
    if scale is None:
        return F.embedding(tokens.long(), embed)
    idx = tokens.long()
    return (embed[idx].float() * scale[idx][..., None]).to(dtype)


def lm_head_logits(x: torch.Tensor, w: torch.Tensor, *, transposed: bool,
                   scale: torch.Tensor | None = None) -> torch.Tensor:
    """Final projection with f32 logits. ``transposed``: w is [V, D] (the
    tied embedding), else [D, V]. A bf16 model on the card multiplies in
    bf16 with an f32 result, as the JAX package's preferred_element_type.
    An int8 head (``scale`` [V]) is stored [V, D] either way: the f32
    product times the scale (``ops/int8_matmul.int8_head``)."""
    B, S, D = x.shape
    x2 = x.reshape(B * S, D)
    if scale is not None:
        return int8_head(x2, w, scale).view(B, S, -1)
    wm = w.t() if transposed else w
    if x.dtype == torch.float32:
        y = torch.matmul(x2, wm.float())
    elif x.is_cuda:
        y = torch.mm(x2, wm, out_dtype=torch.float32)
    else:
        y = torch.matmul(x2.float(), wm.float())
    return y.view(B, S, -1)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float, plus_one: bool = False) -> torch.Tensor:
    """RMSNorm as the JAX package computes it: cast back to the model dtype
    BEFORE the weight multiply; a plus-one (Gemma) norm scales by 1 + w in
    f32 and casts last."""
    x32 = x.float()
    scale = torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    if plus_one:
        return ((x32 * scale) * (1.0 + w.float())).to(x.dtype)
    return (x32 * scale).to(x.dtype) * w


def dtype_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: a tensor times it
    rounds once, as the JAX package's product with ``jnp.asarray(value,
    dtype)`` does, and no host-to-device copy is made (a captured decode
    step may make none)."""
    return torch.tensor(value, dtype=dtype).item()


def mlp_act(x: torch.Tensor, act: str) -> torch.Tensor:
    """The gate's activation: SiLU, or GELU with the tanh approximation."""
    if act == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def layer_windows(cfg: LlamaConfig) -> list[int]:
    """Each layer's attention window: 0 on global layers, the config's
    window on sliding ones. With a window and no ``layer_is_global`` every
    layer slides (Mistral-style); a ``layer_is_global`` of the wrong length
    raises."""
    if not cfg.sliding_window:
        return [0] * cfg.n_layers
    if not cfg.layer_is_global:
        return [cfg.sliding_window] * cfg.n_layers
    if len(cfg.layer_is_global) != cfg.n_layers:
        raise ValueError(
            f"layer_is_global has {len(cfg.layer_is_global)} entries "
            f"for {cfg.n_layers} layers"
        )
    return [0 if g else cfg.sliding_window for g in cfg.layer_is_global]


def local_rope_config(cfg: LlamaConfig) -> LlamaConfig:
    """The sliding layers' RoPE: base ``rope_local_theta``, no scaling."""
    return dataclasses.replace(
        cfg, rope_theta=cfg.rope_local_theta, use_llama3_rope_scaling=False,
        rope_linear_factor=0.0,
    )


def window_mask(write_index, seq_len: int, cache_len: int, window: int, device) -> torch.Tensor:
    """The sliding layers' extra mask on ``device``: the query at cache slot
    q sees slot k iff k > q - window. Queries sit at ``write_index + s``:
    one start for every row (an int: [1, S, C]) or one per row (a [B]
    tensor: [B, S, C])."""
    s = torch.arange(seq_len, device=device)[None, :]
    if torch.is_tensor(write_index):
        q_slot = write_index.long()[:, None] + s
    else:
        q_slot = int(write_index) + s
    k = torch.arange(cache_len, device=device)
    return k[None, None, :] > q_slot[:, :, None] - window


def rope_inv_freq(cfg: LlamaConfig, device=None) -> torch.Tensor:
    half = cfg.head_dim // 2
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))
    if not cfg.use_llama3_rope_scaling:
        return inv
    # llama3 long-context scaling: low-frequency bands divided by `factor`,
    # high-frequency bands kept, a smooth ramp between
    lo_wavelen = cfg.rope_original_max_len / cfg.rope_low_freq_factor
    hi_wavelen = cfg.rope_original_max_len / cfg.rope_high_freq_factor
    wavelen = 2.0 * math.pi / inv
    ramp = (cfg.rope_original_max_len / wavelen - cfg.rope_low_freq_factor) / (
        cfg.rope_high_freq_factor - cfg.rope_low_freq_factor
    )
    ramp = ramp.clamp(0.0, 1.0)
    scaled = inv / cfg.rope_scale_factor
    smooth = (1.0 - ramp) * scaled + ramp * inv
    out = torch.where(wavelen > lo_wavelen, scaled, inv)
    between = (wavelen <= lo_wavelen) & (wavelen >= hi_wavelen)
    return torch.where(between, smooth, out)


def rope_cos_sin(cfg: LlamaConfig, positions: torch.Tensor):
    """positions [B, S] -> cos/sin [B, S, hd/2] (f32)."""
    pos = positions[..., None].float()
    if cfg.rope_linear_factor:
        pos = pos / cfg.rope_linear_factor
    angles = pos * rope_inv_freq(cfg, positions.device)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, hd]; rotate-half convention (pairs are [:half], [half:])."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def attention(q, k, v, mask, q_per_kv: int) -> torch.Tensor:
    """Dense attention of q [B, S, H, hd] over one cache layer k/v
    [B, KV, C, hd] under mask [B, S, C]. A fully masked row gets a uniform
    average (f32 min fill), as in the JAX package's dense path."""
    B, S, H, hd = q.shape
    KV = k.shape[1]
    qg = q.reshape(B, S, KV, q_per_kv, hd).permute(0, 2, 3, 1, 4)   # [B, KV, G, S, hd]
    scores = torch.matmul(qg.float(), k.float()[:, :, None].transpose(-1, -2))
    scores = scores / math.sqrt(hd)
    neg = torch.finfo(torch.float32).min
    scores = scores.masked_fill(~mask[:, None, None, :, :], neg)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(probs, v[:, :, None])                        # [B, KV, G, S, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


# -- mask / position helpers --------------------------------------------------


def prefill_attention_mask(pad_lens: torch.Tensor, seq_len: int, cache_len: int):
    """Left-padded causal mask: query i attends cache slot j iff
    pad_b <= j <= i. [B, S, C]."""
    i = torch.arange(seq_len, device=pad_lens.device)[None, :, None]
    j = torch.arange(cache_len, device=pad_lens.device)[None, None, :]
    pad = pad_lens.long()[:, None, None]
    return (j >= pad) & (j <= i)


def decode_attention_mask(pad_lens: torch.Tensor, fill: int, cache_len: int):
    """Single-token step: attend j iff pad_b <= j <= fill. [B, 1, C]."""
    j = torch.arange(cache_len, device=pad_lens.device)[None, None, :]
    pad = pad_lens.long()[:, None, None]
    return (j >= pad) & (j <= fill)


def prefill_positions(pad_lens: torch.Tensor, seq_len: int) -> torch.Tensor:
    """RoPE positions for left-padded prompts: max(0, i - pad). [B, S]."""
    i = torch.arange(seq_len, device=pad_lens.device)[None, :]
    return torch.clamp(i - pad_lens.long()[:, None], min=0)


def verify_attention_mask(
    pad_lens: torch.Tensor, fills: torch.Tensor, num_q: int, cache_len: int
):
    """Speculative verify step: ``num_q`` query tokens per row sit at
    per-row cache slots fills_b .. fills_b + num_q - 1; query i attends j
    iff pad_b <= j <= fills_b + i. [B, num_q, C]."""
    j = torch.arange(cache_len, device=pad_lens.device)[None, None, :]
    pad = pad_lens.long()[:, None, None]
    limit = (fills.long()[:, None] + torch.arange(num_q, device=fills.device)[None, :])
    return (j >= pad) & (j <= limit[:, :, None])


def verify_positions(
    pad_lens: torch.Tensor, fills: torch.Tensor, num_q: int
) -> torch.Tensor:
    """RoPE positions of the verify queries: (fills_b - pad_b) + i. [B, num_q]."""
    base = fills.long() - pad_lens.long()
    return base[:, None] + torch.arange(num_q, device=fills.device)[None, :]
