"""The PyTorch port stands alone: no module of vnsum_tpu_torch, and not
chip_smoke.py, imports jax or any module of the JAX package, nor the
safetensors package (the card has none: the port reads and writes the
format itself)."""
from __future__ import annotations

import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "vnsum_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
# word-bounded: "vnsum_tpu_torch" does not match "vnsum_tpu\b"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+vnsum_tpu\b(?!_)|from\s+vnsum_tpu\b(?!_)"
    r"|import\s+safetensors\b|from\s+safetensors\b)",
    re.MULTILINE,
)


def test_sources_found():
    assert len(SOURCES) > 20
    assert (ROOT / "vnsum_tpu_torch" / "ops" / "csrc" / "flash_prefill.cu").is_file()
    assert (ROOT / "vnsum_tpu_torch" / "ops" / "csrc" / "flash_decode.cu").is_file()
    assert (ROOT / "vnsum_tpu_torch" / "ops" / "csrc" / "flash_verify.cu").is_file()
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {"vnsum_tpu_torch/spec/drafter.py", "vnsum_tpu_torch/backend/inflight.py",
            "vnsum_tpu_torch/ops/verify_attention.py", "vnsum_tpu_torch/backend/long_context.py",
            "vnsum_tpu_torch/parallel/seq.py", "vnsum_tpu_torch/parallel/ring.py",
            "vnsum_tpu_torch/strategies/truncated.py", "vnsum_tpu_torch/backend/capture.py",
            "vnsum_tpu_torch/text/tree.py", "vnsum_tpu_torch/strategies/critique.py",
            "vnsum_tpu_torch/strategies/iterative.py",
            "vnsum_tpu_torch/strategies/hierarchical.py",
            "vnsum_tpu_torch/strategies/skeleton.py", "vnsum_tpu_torch/models/convert.py",
            "vnsum_tpu_torch/models/encoder.py", "vnsum_tpu_torch/models/convert_encoder.py",
            "vnsum_tpu_torch/eval/embedding.py",
            "vnsum_tpu_torch/utils/evaluate_summaries.py", "vnsum_tpu_torch/cache/__init__.py",
            "vnsum_tpu_torch/cache/radix.py", "vnsum_tpu_torch/cache/store.py"} <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_vnsum_tpu_imports(path):
    hits = FORBIDDEN.findall(path.read_text(encoding="utf-8"))
    assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


@pytest.mark.parametrize(
    "line,bad",
    [("import jax", True), ("from jax import numpy", True), ("  import jax.numpy as jnp", True),
     ("from vnsum_tpu.models import llama", True), ("import vnsum_tpu.core", True),
     ("from vnsum_tpu_torch.models import llama", False), ("import jaxtyping", False),
     ("# import jax in a comment", False), ("import safetensors", True),
     ("from safetensors.torch import load_file", True), ("import safetensors_x", False)],
)
def test_pattern_is_word_bounded(line, bad):
    assert bool(FORBIDDEN.search(line)) is bad
