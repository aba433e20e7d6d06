"""HF BERT-family checkpoint -> the port's stacked encoder parameters.

Counterpart of ``vnsum_tpu/models/convert_encoder.py`` (all-MiniLM-L6-v2,
multilingual BERT and other BERT clones), reading the shards through
:func:`vnsum_tpu_torch.models.convert.safetensors_getter`.

- HF ``Linear.weight`` is ``[out, in]``; the port's layouts are
  ``[in, out]``, so every projection transposes.
- Sentence encoders run with ``token_type_ids = 0``, so
  ``token_type_embeddings[0]`` is folded into the word table here and the
  model has no segment input.
- The state dict may carry a ``bert.`` (or other) prefix, depending on the
  class that saved it; the prefix is detected.
"""
from __future__ import annotations

import json
import os
from typing import Any, Mapping

import torch

from ..backend.engine import resolve_device
from .convert import safetensors_getter
from .encoder import EncoderConfig

# HF key (under encoder.layer.{i}.) -> the port's stacked-layer key
_LAYER_KEYS: dict[str, str] = {
    "attention.self.query.weight": "wq",
    "attention.self.query.bias": "bq",
    "attention.self.key.weight": "wk",
    "attention.self.key.bias": "bk",
    "attention.self.value.weight": "wv",
    "attention.self.value.bias": "bv",
    "attention.output.dense.weight": "wo",
    "attention.output.dense.bias": "bo",
    "attention.output.LayerNorm.weight": "attn_norm_w",
    "attention.output.LayerNorm.bias": "attn_norm_b",
    "intermediate.dense.weight": "w_up",
    "intermediate.dense.bias": "b_up",
    "output.dense.weight": "w_down",
    "output.dense.bias": "b_down",
    "output.LayerNorm.weight": "mlp_norm_w",
    "output.LayerNorm.bias": "mlp_norm_b",
}


def encoder_config_from_hf(hf: Mapping[str, Any], **overrides) -> EncoderConfig:
    """An :class:`EncoderConfig` from a parsed HF BERT ``config.json``."""
    kw: dict[str, Any] = dict(
        vocab_size=hf["vocab_size"],
        dim=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        intermediate=hf["intermediate_size"],
        max_len=hf.get("max_position_embeddings", 512),
        norm_eps=hf.get("layer_norm_eps", 1e-12),
    )
    kw.update(overrides)
    return EncoderConfig(**kw)


def _detect_prefix(has) -> str:
    """The state-dict prefix in front of the ``embeddings.*`` keys."""
    for prefix in ("", "bert.", "model.", "encoder."):
        if has(f"{prefix}embeddings.word_embeddings.weight"):
            return prefix
    raise KeyError("embeddings.word_embeddings.weight is under no known prefix: "
                   "not a BERT-architecture checkpoint")


def convert_hf_encoder_state_dict(get, cfg: EncoderConfig, device="cuda") -> dict:
    """HF-named tensors (``get(name)``, with a ``get.has(name)`` probe) ->
    the port's stacked encoder parameters at ``cfg.dtype`` on ``device``."""
    prefix = _detect_prefix(get.has)

    def g(name: str) -> torch.Tensor:
        return get(prefix + name).to(device=device, dtype=cfg.dtype)

    layers = {
        ours: torch.stack([
            g(f"encoder.layer.{li}.{hf_key}").t() if ours.startswith("w")
            else g(f"encoder.layer.{li}.{hf_key}")
            for li in range(cfg.n_layers)])
        for hf_key, ours in _LAYER_KEYS.items()
    }
    tok_embed = g("embeddings.word_embeddings.weight")
    if get.has(prefix + "embeddings.token_type_embeddings.weight"):
        tok_embed = tok_embed + g("embeddings.token_type_embeddings.weight")[0]
    return {
        "tok_embed": tok_embed,
        "pos_embed": g("embeddings.position_embeddings.weight"),
        "embed_norm": {"w": g("embeddings.LayerNorm.weight"),
                       "b": g("embeddings.LayerNorm.bias")},
        "layers": layers,
    }


def load_hf_encoder(
    model_dir: str, dtype=None, device="cuda", **config_overrides
) -> tuple[EncoderConfig, dict]:
    """``config.json`` + safetensors shards of a local HF encoder dir (a
    saved all-MiniLM-L6-v2 or bert-base-multilingual-cased checkout) ->
    (config, parameters on ``device``). ``device="cuda"`` with no card
    raises."""
    device = resolve_device(device)
    if dtype is not None:
        config_overrides.setdefault("dtype", dtype)
    config_path = os.path.join(model_dir, "config.json")
    if not os.path.isfile(config_path):
        raise FileNotFoundError(f"no config.json in {model_dir}")
    with open(config_path) as f:
        cfg = encoder_config_from_hf(json.load(f), **config_overrides)
    return cfg, convert_hf_encoder_state_dict(safetensors_getter(model_dir), cfg, device)
