"""Bidirectional transformer encoder (BERT / MiniLM) in PyTorch.

Counterpart of ``vnsum_tpu/models/encoder.py``: one encoder serves the
sentence-cosine metric (mean pooling) and BERTScore (token embeddings).
The parameters keep the JAX package's layout, every layer weight stacked on
a leading L dim, so a JAX parameter tree maps onto the port leaf for leaf
(:func:`encoder_params_from_numpy`). Weights are random-init by default, or
converted from a HF BERT-family checkpoint by
:mod:`vnsum_tpu_torch.models.convert_encoder`.

Post-LN residuals, biased projections, the tanh GELU of ``jax.nn.gelu``'s
default, and dense f32 attention: no kernel computes it in the JAX package
either. On the card the f32 matmuls stay f32 as long as TF32 is off,
PyTorch's default.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 384
    dim: int = 256
    n_layers: int = 4
    n_heads: int = 4
    intermediate: int = 1024
    max_len: int = 512
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def minilm_like(**kw) -> EncoderConfig:
    """Shape-compatible with all-MiniLM-L6-v2 (6 layers, 384 dim)."""
    return EncoderConfig(**{**dict(dim=384, n_layers=6, n_heads=12, intermediate=1536), **kw})


def tiny_encoder(**kw) -> EncoderConfig:
    return EncoderConfig(
        **{**dict(dim=64, n_layers=2, n_heads=4, intermediate=128, max_len=128), **kw})


def _shapes(cfg: EncoderConfig) -> dict:
    L, D, I = cfg.n_layers, cfg.dim, cfg.intermediate
    return {
        "tok_embed": (cfg.vocab_size, D),
        "pos_embed": (cfg.max_len, D),
        "embed_norm": {"w": (D,), "b": (D,)},
        "layers": {
            "wq": (L, D, D), "bq": (L, D), "wk": (L, D, D), "bk": (L, D),
            "wv": (L, D, D), "bv": (L, D), "wo": (L, D, D), "bo": (L, D),
            "attn_norm_w": (L, D), "attn_norm_b": (L, D),
            "w_up": (L, D, I), "b_up": (L, I), "w_down": (L, I, D), "b_down": (L, D),
            "mlp_norm_w": (L, D), "mlp_norm_b": (L, D),
        },
    }


def _map(tree: dict, fn, path: str = "") -> dict:
    """``fn(path, leaf)`` over a nested dict of leaves."""
    return {k: _map(v, fn, f"{path}{k}.") if isinstance(v, dict) else fn(f"{path}{k}", v)
            for k, v in tree.items()}


def init_encoder_params(cfg: EncoderConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random init with the JAX package's scheme: matrices normal * 0.02,
    norm weights one, biases and norm shifts zero, drawn from
    ``generator`` on ``device``."""

    def leaf(path, shape):
        name = path.rsplit(".", 1)[-1]
        if name == "w" or name.endswith("norm_w"):
            return torch.ones(shape, dtype=cfg.dtype, device=device)
        if name.startswith("b") or name.endswith("norm_b"):
            return torch.zeros(shape, dtype=cfg.dtype, device=device)
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * 0.02).to(cfg.dtype)

    return _map(_shapes(cfg), leaf)


def encoder_params_from_numpy(tree: dict, cfg: EncoderConfig, device="cuda") -> dict:
    """The port's parameters from a JAX encoder tree converted to numpy
    (``jax.tree.map(np.asarray, params)``), leaf for leaf and shape-checked."""
    shapes = _shapes(cfg)

    def leaf(path, a):
        want = shapes
        for k in path.split("."):
            want = want[k]
        arr = np.array(a, dtype=np.float32)
        if arr.shape != tuple(want):
            raise ValueError(f"{path}: shape {arr.shape} != {tuple(want)}")
        return torch.from_numpy(arr).to(device=device, dtype=cfg.dtype)

    return _map(tree, leaf)


def _layernorm(x, w, b, eps):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


@torch.inference_mode()
def encode(params: dict, cfg: EncoderConfig, tokens: torch.Tensor, mask: torch.Tensor):
    """tokens [B, S] int, mask [B, S] bool -> token embeddings [B, S, D]."""
    B, S = tokens.shape
    H, hd = cfg.n_heads, cfg.head_dim
    x = F.embedding(tokens.long(), params["tok_embed"]) + params["pos_embed"][None, :S]
    x = _layernorm(x, params["embed_norm"]["w"], params["embed_norm"]["b"], cfg.norm_eps)
    keys = mask[:, None, None, :].bool()  # [B, 1, 1, S]
    neg = torch.finfo(torch.float32).min
    for lp in ({k: v[li] for k, v in params["layers"].items()} for li in range(cfg.n_layers)):
        q = (x @ lp["wq"] + lp["bq"]).view(B, S, H, hd)
        k = (x @ lp["wk"] + lp["bk"]).view(B, S, H, hd)
        v = (x @ lp["wv"] + lp["bv"]).view(B, S, H, hd)
        scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / math.sqrt(hd)
        probs = torch.softmax(scores.masked_fill(~keys, neg), dim=-1).to(x.dtype)
        attn = torch.einsum("bhst,bthd->bshd", probs, v).reshape(B, S, cfg.dim)
        x = _layernorm(x + attn @ lp["wo"] + lp["bo"],
                       lp["attn_norm_w"], lp["attn_norm_b"], cfg.norm_eps)
        h = F.gelu(x @ lp["w_up"] + lp["b_up"], approximate="tanh")
        x = _layernorm(x + h @ lp["w_down"] + lp["b_down"],
                       lp["mlp_norm_w"], lp["mlp_norm_b"], cfg.norm_eps)
    return x


def mean_pool(token_embs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean pooling + L2 normalize -> sentence embeddings [B, D]."""
    m = mask[..., None].to(token_embs.dtype)
    pooled = (token_embs * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-9)
