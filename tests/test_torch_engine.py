"""Greedy generation of the port's engine (TorchBackend on the CPU) against
the JAX engine (TpuBackend with its kernels in interpret mode), on carried
weights: text and token ids must be byte-identical.

The decode budget keeps every cache length a multiple of 128: the JAX decode
kernel's interpret mode pads a ragged last 128-slot block with NaN, which
reaches the PV product as 0 * NaN.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from vnsum_tpu.backend.engine import TpuBackend
from vnsum_tpu.core.config import GenerationConfig as JaxGenerationConfig
from vnsum_tpu_torch.backend.engine import TorchBackend
from vnsum_tpu_torch.core.config import GenerationConfig
from vnsum_tpu_torch.models import llama as tl

from test_torch_models_llama import carried_weights, one_torch_thread  # noqa: F401

MAX_NEW = 128
PROMPTS = [
    "Xin chào thế giới, đây là một bài kiểm tra dài hơn sáu mươi tư byte.",
    "Tóm tắt nội dung văn bản sau bằng tiếng Việt: " * 3,
    "abc " * 30,
]


@pytest.fixture(scope="module")
def carried():
    return carried_weights(max_seq_len=1024)


def record_ids(backend) -> list:
    """Collect every generated id row the backend detokenizes."""
    rows = []
    detok = backend._detok

    def spy(ids, extra_eos=()):
        rows.append(np.asarray(ids).tolist())
        return detok(ids, extra_eos)

    backend._detok = spy
    return rows


# arm -> (prompts, batch_size, prefill_chunk_tokens, eos_ids, flash)
ARMS = {
    # 3 prompts at batch 4: one all-pad filler row
    "whole": (PROMPTS, 4, 0, (), True),
    "chunked": ([p * 4 for p in PROMPTS], 4, 128, (), True),
    # rows stop at different steps; then every row stops (early exit)
    "eos": (PROMPTS, 4, 0, (19, 71), True),
    "early_exit": (PROMPTS, 4, 0, (19, 46, 71), True),
    # two groups, batch dims 2 and 1, each with its own seed
    "two_groups": (PROMPTS, 2, 0, (), True),
    "dense": (PROMPTS, 4, 0, (), False),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_greedy_generate_matches_jax_engine(carried, arm):
    jcfg, params, model = carried
    prompts, batch, chunk, eos, flash = ARMS[arm]
    jb = TpuBackend(
        model_config=jcfg, params=params, flash=flash, interpret=flash,
        batch_size=batch, max_new_tokens=MAX_NEW, prefill_chunk_tokens=chunk,
        generation=JaxGenerationConfig(eos_ids=eos),
    )
    tb = TorchBackend(
        model=model, flash=flash, batch_size=batch, max_new_tokens=MAX_NEW,
        prefill_chunk_tokens=chunk, generation=GenerationConfig(eos_ids=eos),
        device="cpu",
    )
    assert tb.quantize_kv == jb.quantize_kv == flash
    j_ids, t_ids = record_ids(jb), record_ids(tb)
    want = jb.generate(prompts)
    got = tb.generate(prompts)
    assert got == want
    assert t_ids == j_ids
    assert tb.stats.generated_tokens == jb.stats.generated_tokens
    assert tb.stats.by_bucket == jb.stats.by_bucket
    if chunk:
        S = max(tb.stats.by_bucket)[1]
        assert tb.stats.prefill_forwards == -(-S // chunk)
    if arm == "early_exit":
        # every row is done after its first token: the loop stops at the
        # first all-done check instead of running the whole budget
        assert tb.stats.decode_steps < MAX_NEW


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TorchBackend(model_config=tl.tiny_llama(), device="cuda")


def test_kernel_and_cache_settings(carried):
    _, _, model = carried
    # CPU callers ask for the kernels explicitly and get the int8 cache
    tb = TorchBackend(model=model, flash=True, max_new_tokens=MAX_NEW, device="cpu")
    assert tb.use_kernels and tb.quantize_kv
    # "auto" turns the kernels on only on the card
    tb = TorchBackend(model=model, max_new_tokens=MAX_NEW, device="cpu")
    assert not tb.flash and not tb.quantize_kv
    with pytest.raises(ValueError, match="quantize_kv"):
        TorchBackend(
            model=model, flash=False, quantize_kv=True, max_new_tokens=MAX_NEW,
            device="cpu",
        )
    with pytest.raises(ValueError, match="multiple of 128"):
        TorchBackend(
            model=model, prefill_chunk_tokens=100, max_new_tokens=MAX_NEW,
            device="cpu",
        )
    assert tb.count_tokens("xin chào") == len("xin chào".encode())
    assert tb.count_tokens_batch(["a", "bc"]) == [1, 2]
    assert tb.generate([]) == []
