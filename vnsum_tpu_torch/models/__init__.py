from .llama import LlamaConfig, LlamaModel, llama32_3b, qwen3_0p6b, tiny_llama

# model name -> config factory (names match the JAX package's registry)
MODEL_REGISTRY = {
    "llama3.2:3b": llama32_3b,
    "llama3.2-3b": llama32_3b,
    "qwen3:0.6b": qwen3_0p6b,
    "qwen3-0.6b": qwen3_0p6b,
    "tiny": tiny_llama,
}

__all__ = [
    "MODEL_REGISTRY",
    "LlamaConfig",
    "LlamaModel",
    "llama32_3b",
    "qwen3_0p6b",
    "tiny_llama",
]
