from .llama import (
    LlamaConfig,
    LlamaModel,
    gemma3_4b,
    llama32_1b,
    llama32_3b,
    phi4_14b,
    qwen3_0p6b,
    qwen3_8b,
    tiny_llama,
)

# model name -> config factory (names match the JAX package's registry)
MODEL_REGISTRY = {
    "llama3.2:3b": llama32_3b,
    "llama3.2-3b": llama32_3b,
    "llama3.2:1b": llama32_1b,
    "llama3.2-1b": llama32_1b,
    "qwen3:8b": qwen3_8b,
    "qwen3-8b": qwen3_8b,
    "qwen3:0.6b": qwen3_0p6b,
    "qwen3-0.6b": qwen3_0p6b,
    "gemma3:4b": gemma3_4b,
    "gemma3-4b": gemma3_4b,
    "phi4:14b": phi4_14b,
    "phi4-14b": phi4_14b,
    "tiny": tiny_llama,
}

__all__ = [
    "MODEL_REGISTRY",
    "LlamaConfig",
    "LlamaModel",
    "gemma3_4b",
    "llama32_1b",
    "llama32_3b",
    "phi4_14b",
    "qwen3_0p6b",
    "qwen3_8b",
    "tiny_llama",
]
