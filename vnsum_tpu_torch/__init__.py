"""vnsum_tpu_torch — the PyTorch/CUDA port of vnsum_tpu for NVIDIA Hopper.

A package of its own beside the JAX reference: it imports torch and never
jax, and nothing of vnsum_tpu. Host code the JAX package keeps in pure
Python is copied here under the same module path. Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
