"""HF Llama checkpoints <-> the port's stacked model.

Counterpart of ``vnsum_tpu/models/convert.py``. HF format is the
interchange format: a checkpoint is converted once, host-side, into the
stacked-layer parameters of :mod:`vnsum_tpu_torch.models.llama` and from
then on lives on the device.

The safetensors files are read and written here, by this module's own
code, on the CPU and on the card alike: a file is an 8-byte little-endian
header length, a JSON header naming each tensor's dtype, shape and byte
range, then the raw tensors. Each file is memory-mapped and each tensor is
a ``torch.frombuffer`` view at its own dtype, so bf16 stays bf16 and
nothing goes through numpy.

Conversion notes, as in the JAX package:

- HF ``Linear.weight`` is stored ``[out, in]``; the port's layouts are
  ``[in, ...out]``, so every projection is transposed (and reshaped to
  split the head dims). HF Llama checkpoints already use the rotate-half
  RoPE convention of :func:`..models.llama.apply_rope`.
- Per-layer weights are stacked on a leading ``L`` dim. The stacks are
  filled one layer at a time, so host memory stays near one tensor.

Llama-3.x, Qwen3 (``qk_norm``) and Gemma3 load, Gemma3 as a text
checkpoint (``Gemma3ForCausalLM``) or from a multimodal one, whose decoder
config sits under ``text_config`` and its tensors under
``language_model.``. Phi-3/Phi-4 raise until their fused layout is ported
(ROADMAP A1).
"""
from __future__ import annotations

import json
import math
import mmap
import os
import struct
from typing import Any, Callable, Mapping

import torch

from ..backend.engine import resolve_device
from .llama import LlamaConfig, LlamaModel, _param_shapes

# -- safetensors -------------------------------------------------------------

DTYPES: dict[str, torch.dtype] = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "I64": torch.int64,
}
_NAMES = {v: k for k, v in DTYPES.items()}
INDEX_FILE = "model.safetensors.index.json"


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """name -> CPU tensor for every tensor of one file, each a view of the
    memory-mapped file (copy-on-write: writing to a tensor never reaches the
    file). Raises on a dtype outside :data:`DTYPES` and on byte ranges that
    do not tile the data section as the header says."""
    with open(path, "rb") as f:
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    if len(buf) < 8:
        raise ValueError(f"{path}: {len(buf)} bytes, too short for a safetensors header")
    (n,) = struct.unpack("<Q", buf[:8])
    if 8 + n > len(buf):
        raise ValueError(f"{path}: header of {n} bytes runs past the file's {len(buf)}")
    header = json.loads(bytes(buf[8 : 8 + n]))
    header.pop("__metadata__", None)
    base, size = 8 + n, len(buf) - 8 - n
    end = 0
    out = {}
    for name, info in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}; "
                             f"supported: {sorted(DTYPES)}")
        dtype, shape = DTYPES[info["dtype"]], tuple(info["shape"])
        lo, hi = info["data_offsets"]
        count = math.prod(shape)
        if lo != end or hi - lo != count * dtype.itemsize or hi > size:
            raise ValueError(f"{path}: {name} spans bytes [{lo}, {hi}) of {size}, expected "
                             f"[{end}, {end + count * dtype.itemsize}) for {info['dtype']} "
                             f"{list(shape)}")
        end = hi
        flat = (torch.frombuffer(buf, dtype=dtype, count=count, offset=base + lo) if count
                else torch.empty(0, dtype=dtype))
        out[name] = flat.view(shape)
    if end != size:
        raise ValueError(f"{path}: tensors end at byte {end} of a {size}-byte data section")
    return out


def write_safetensors(tensors: Mapping[str, torch.Tensor], path: str) -> int:
    """Write ``tensors`` (any device, C-contiguous copies are made) to one
    safetensors file; returns the data bytes written. Larger elements come
    first, so every tensor starts at a multiple of its element size."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header, offset = {}, 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} cannot be written; "
                             f"supported: {sorted(DTYPES.values(), key=str)}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data section starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = tensors[name].detach().to("cpu").contiguous().reshape(-1)
            if t.numel():
                f.write(memoryview(t.view(torch.uint8).numpy()))
    return offset


def safetensors_getter(model_dir: str) -> Callable[[str], torch.Tensor]:
    """Key -> CPU tensor across one or many ``*.safetensors`` shards (many
    through ``model.safetensors.index.json``); ``get.has(key)`` probes the
    layout without reading a tensor. A shard is mapped on its first use."""
    index_path = os.path.join(model_dir, INDEX_FILE)
    files: dict[str, dict] = {}
    if os.path.exists(index_path):
        with open(index_path) as f:
            weight_map: dict[str, str] = json.load(f)["weight_map"]
    else:
        shards = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
        if not shards:
            raise FileNotFoundError(f"no .safetensors files in {model_dir}")
        weight_map = {}
        for shard in shards:
            files[shard] = read_safetensors(os.path.join(model_dir, shard))
            weight_map.update(dict.fromkeys(files[shard], shard))

    def get(name: str) -> torch.Tensor:
        if name not in weight_map:
            raise KeyError(f"{name!r} is in no shard of {model_dir}")
        shard = weight_map[name]
        if shard not in files:
            files[shard] = read_safetensors(os.path.join(model_dir, shard))
        if name not in files[shard]:
            raise KeyError(f"{name!r} is not in {os.path.join(model_dir, shard)}, "
                           f"which {INDEX_FILE} names for it")
        return files[shard][name]

    get.has = weight_map.__contains__
    return get


# -- Llama -------------------------------------------------------------------

# HF key (under model.layers.{i}.) -> the port's stacked-layer key
_LAYER_KEYS: dict[str, str] = {
    "self_attn.q_proj.weight": "wq",
    "self_attn.k_proj.weight": "wk",
    "self_attn.v_proj.weight": "wv",
    "self_attn.o_proj.weight": "wo",
    "mlp.gate_proj.weight": "w_gate",
    "mlp.up_proj.weight": "w_up",
    "mlp.down_proj.weight": "w_down",
    "input_layernorm.weight": "attn_norm",
    "post_attention_layernorm.weight": "mlp_norm",
}
# Qwen3's (and Gemma3's) per-head Q/K RMSNorms
_QK_NORM_KEYS: dict[str, str] = {
    "self_attn.q_norm.weight": "q_norm",
    "self_attn.k_norm.weight": "k_norm",
}
# Gemma3's sandwich norms: post_attention_layernorm is the norm after
# attention there (Llama gives that name to the norm before the MLP), and
# the MLP's pre-norm is pre_feedforward_layernorm
_GEMMA_NORM_KEYS: dict[str, str] = {
    "input_layernorm.weight": "attn_norm",
    "post_attention_layernorm.weight": "post_attn_norm",
    "pre_feedforward_layernorm.weight": "mlp_norm",
    "post_feedforward_layernorm.weight": "post_ffw_norm",
}
# a multimodal checkpoint's decoder tensors sit under this prefix
_MULTIMODAL_PREFIX = "language_model."
_FAMILY_LATER = "(ROADMAP A1: the other model families)"


def _layer_keys(cfg: LlamaConfig) -> dict[str, str]:
    keys = dict(_LAYER_KEYS)
    if cfg.sandwich_norms:
        keys.update(_GEMMA_NORM_KEYS)  # remaps the two shared HF norm names
    if cfg.qk_norm:
        keys.update(_QK_NORM_KEYS)
    return keys


def config_from_hf(hf: Mapping[str, Any], **overrides) -> LlamaConfig:
    """A :class:`LlamaConfig` from a parsed HF ``config.json``: Llama,
    Qwen3 or Gemma3 (a multimodal one's ``text_config``), with llama3 or
    linear RoPE scaling."""
    if "text_config" in hf:
        # a multimodal wrapper (Gemma3ForConditionalGeneration): the decoder
        # lives in text_config
        inner = dict(hf["text_config"])
        inner.setdefault("model_type", hf.get("model_type", "llama"))
        hf = inner
    model_type = hf.get("model_type", "llama")
    gemma = model_type.startswith("gemma3")
    if model_type.startswith("phi3"):
        raise NotImplementedError(
            "Phi-3/Phi-4 checkpoints (fused qkv_proj and gate_up_proj) load once the "
            f"Phi family is ported {_FAMILY_LATER}")
    rope_scaling = hf.get("rope_scaling") or {}
    rope_type = rope_scaling.get("rope_type", rope_scaling.get("type"))
    kw: dict[str, Any] = dict(
        qk_norm=model_type.startswith("qwen3") or gemma,
        vocab_size=hf["vocab_size"],
        dim=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"],
        intermediate=hf["intermediate_size"],
        # the defaults of HF's LlamaConfig, for keys config.json leaves out
        rope_theta=hf.get("rope_theta", 10_000.0),
        norm_eps=hf.get("rms_norm_eps", 1e-6),
        max_seq_len=hf.get("max_position_embeddings", 16_384),
        tie_embeddings=hf.get("tie_word_embeddings", False),
        use_llama3_rope_scaling=rope_type == "llama3",
    )
    if rope_type == "llama3":
        kw.update(
            rope_scale_factor=rope_scaling.get("factor", 32.0),
            rope_low_freq_factor=rope_scaling.get("low_freq_factor", 1.0),
            rope_high_freq_factor=rope_scaling.get("high_freq_factor", 4.0),
            rope_original_max_len=rope_scaling.get("original_max_position_embeddings", 8192),
        )
    elif rope_type == "linear":
        kw["rope_linear_factor"] = rope_scaling.get("factor", 1.0)
    elif rope_type is not None:
        # e.g. Phi-3's "longrope": dropping a scaling scheme would load fine
        # and give subtly wrong logits
        raise NotImplementedError(
            f"rope_scaling type {rope_type!r} is not supported (have: llama3, linear)")
    if gemma:
        layer_types = hf.get("layer_types")
        if layer_types:
            is_global = tuple(t == "full_attention" for t in layer_types)
        else:
            pattern = hf.get("sliding_window_pattern", 6)
            is_global = tuple((i + 1) % pattern == 0 for i in range(hf["num_hidden_layers"]))
        kw.update(
            act="gelu_tanh",
            sandwich_norms=True,
            norm_plus_one=True,
            embed_scale=True,
            query_scale=float(hf.get("query_pre_attn_scalar") or 0.0),
            sliding_window=int(hf.get("sliding_window") or 0),
            layer_is_global=is_global,
            rope_local_theta=float(hf.get("rope_local_base_freq", 10_000.0)),
            # Gemma ties its embeddings unless the config says otherwise
            tie_embeddings=hf.get("tie_word_embeddings", True),
        )
    kw.update(overrides)
    return LlamaConfig(**kw)


def _to_ours(ours: str, w: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """One HF layer tensor in the port's layout."""
    D, H, KV, hd = cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if ours == "wq":
        return w.t().reshape(D, H, hd)
    if ours in ("wk", "wv"):
        return w.t().reshape(D, KV, hd)
    if ours == "wo":
        return w.t().reshape(H, hd, D)
    if ours in ("w_gate", "w_up", "w_down"):
        return w.t()
    return w  # norms


def _to_hf(ours: str, w: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """The inverse of :func:`_to_ours`: back to HF's [out, in]."""
    D, H, KV, hd = cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if ours == "wq":
        return w.reshape(D, H * hd).t()
    if ours in ("wk", "wv"):
        return w.reshape(D, KV * hd).t()
    if ours == "wo":
        return w.reshape(H * hd, D).t()
    if ours in ("w_gate", "w_up", "w_down"):
        return w.t()
    return w


def convert_hf_state_dict(get, cfg: LlamaConfig, device="cuda") -> dict:
    """HF-named tensors (``get(name)``) -> the port's stacked parameters
    at ``cfg.dtype`` on ``device``, in the layout of
    :func:`..models.llama.init_params`. Each stack is allocated once and
    filled layer by layer."""
    dtype = cfg.dtype

    def load(name):
        return get(name).to(device=device, dtype=dtype)

    layers = {}
    for hf_key, ours in _layer_keys(cfg).items():
        stack = torch.empty(_param_shapes(cfg)["layers"][ours], dtype=dtype, device=device)
        for li in range(cfg.n_layers):
            name = f"model.layers.{li}.{hf_key}"
            w = _to_ours(ours, load(name), cfg)
            if w.shape != stack.shape[1:]:  # a norm of the wrong width would broadcast
                raise ValueError(f"{name}: shape {tuple(w.shape)}, expected "
                                 f"{tuple(stack.shape[1:])}")
            stack[li] = w
        layers[ours] = stack
    # LlamaModel checks the shapes of the rest
    tree = {
        "embed": load("model.embed_tokens.weight"),
        "layers": layers,
        "final_norm": load("model.norm.weight"),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = load("lm_head.weight").t().contiguous()
    return tree


def load_hf_checkpoint(
    model_dir: str, dtype=None, device="cuda", **config_overrides
) -> tuple[LlamaConfig, LlamaModel]:
    """``config.json`` + safetensors shards of a local HF model dir ->
    (config, model on ``device``). ``dtype`` (a torch dtype) applies to
    both the parameters and the config, whose dtype the KV cache and the
    activations take. ``device="cuda"`` with no card raises."""
    device = resolve_device(device)
    if dtype is not None:
        config_overrides.setdefault("dtype", dtype)
    config_path = os.path.join(model_dir, "config.json")
    if not os.path.isfile(config_path):
        raise FileNotFoundError(f"no config.json in {model_dir}")
    with open(config_path) as f:
        cfg = config_from_hf(json.load(f), **config_overrides)
    get = safetensors_getter(model_dir)
    probe = "model.embed_tokens.weight"
    if not get.has(probe):
        if not get.has(_MULTIMODAL_PREFIX + probe):
            raise KeyError(f"neither {probe!r} nor {_MULTIMODAL_PREFIX + probe!r} is in a shard "
                           f"of {model_dir}: not a Llama/Qwen3/Gemma3 text or multimodal "
                           "checkpoint layout")
        # a multimodal checkpoint: the decoder's tensors under the prefix
        # (the vision tower's are never asked for)
        inner = get

        def get(name: str) -> torch.Tensor:  # noqa: F811
            return inner(_MULTIMODAL_PREFIX + name)

        get.has = lambda name: inner.has(_MULTIMODAL_PREFIX + name)
    if get.has("model.layers.0.self_attn.qkv_proj.weight"):
        raise NotImplementedError(f"{model_dir} has fused qkv_proj weights (the Phi layout), "
                                  f"which load once the Phi family is ported {_FAMILY_LATER}")
    return cfg, LlamaModel(cfg, convert_hf_state_dict(get, cfg, device))


def save_hf_checkpoint(
    model: LlamaModel, cfg: LlamaConfig, out_dir: str, shard_layers: int = 8
) -> dict:
    """Write ``model`` in HF Llama format (Qwen3's, Gemma3's), the exact inverse of
    :func:`load_hf_checkpoint`: ``config.json``, one bf16 safetensors shard
    per ``shard_layers`` layers plus one for the embeddings and norms, and
    ``model.safetensors.index.json``. Returns the index it wrote. Each
    shard is made on the host one layer group at a time. An int8 model
    raises: HF checkpoints hold the float weights."""
    if model.quantized:
        raise ValueError("save_hf_checkpoint writes float weights; this model holds int8 "
                         "ones (save the model it was quantized from)")
    if cfg.sandwich_norms:
        arch, mtype = ["Gemma3ForCausalLM"], "gemma3_text"
    elif cfg.qk_norm:
        arch, mtype = ["Qwen3ForCausalLM"], "qwen3"
    else:
        arch, mtype = ["LlamaForCausalLM"], "llama"
    hf_cfg = {
        "architectures": arch,
        "model_type": mtype,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.dim,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim,
        "intermediate_size": cfg.intermediate,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.norm_eps,
        "max_position_embeddings": cfg.max_seq_len,
        "tie_word_embeddings": cfg.tie_embeddings,
        "torch_dtype": "bfloat16",
    }
    if cfg.use_llama3_rope_scaling:
        hf_cfg["rope_scaling"] = {
            "rope_type": "llama3",
            "factor": cfg.rope_scale_factor,
            "low_freq_factor": cfg.rope_low_freq_factor,
            "high_freq_factor": cfg.rope_high_freq_factor,
            "original_max_position_embeddings": cfg.rope_original_max_len,
        }
    elif cfg.rope_linear_factor:
        hf_cfg["rope_scaling"] = {"rope_type": "linear", "factor": cfg.rope_linear_factor}
    if cfg.sandwich_norms:
        hf_cfg.update(
            hidden_activation="gelu_pytorch_tanh",
            query_pre_attn_scalar=cfg.query_scale or cfg.head_dim,
            sliding_window=cfg.sliding_window,
            layer_types=["full_attention" if g else "sliding_attention"
                         for g in (cfg.layer_is_global or [True] * cfg.n_layers)],
            rope_local_base_freq=cfg.rope_local_theta,
        )
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)

    def bf16(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to(torch.bfloat16).contiguous().cpu()

    ours_to_hf = {v: k for k, v in _layer_keys(cfg).items()}
    n_shards = -(-cfg.n_layers // shard_layers) + 1  # + the embeddings shard
    weight_map: dict[str, str] = {}
    total = 0
    groups = [range(lo, min(lo + shard_layers, cfg.n_layers))
              for lo in range(0, cfg.n_layers, shard_layers)]
    for shard, group in enumerate(groups + [None]):
        if group is None:
            tensors = {"model.embed_tokens.weight": bf16(model.embed),
                       "model.norm.weight": bf16(model.final_norm)}
            if not cfg.tie_embeddings:
                tensors["lm_head.weight"] = bf16(model.lm_head.t())
        else:
            tensors = {f"model.layers.{li}.{ours_to_hf[ours]}": bf16(_to_hf(ours, stack[li], cfg))
                       for li in group for ours, stack in model.layers.items()}
        name = f"model-{shard + 1:05d}-of-{n_shards:05d}.safetensors"
        total += write_safetensors(tensors, os.path.join(out_dir, name))
        weight_map.update(dict.fromkeys(tensors, name))
    index = {"metadata": {"total_size": total}, "weight_map": weight_map}
    with open(os.path.join(out_dir, INDEX_FILE), "w") as f:
        json.dump(index, f)
    return index
