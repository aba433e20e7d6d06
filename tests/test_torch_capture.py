"""Captured decode steps (vnsum_tpu_torch/backend/capture.py) on the CPU.

The one-shot engine and the long-context backend run one decode step
function, eagerly and as CUDA graph replays. A CPU has no graphs, so the
"replayed" arms stand a stub in for ``record_cuda_graph``: it records
nothing, and its ``replay()`` calls the step again exactly as the graph
would run it, with the host step frozen at its capture-time value. Greedy
ids must then equal the JAX engine's and the JAX ``generate_long_tokens``'s
byte for byte (tiny f32 configs, carried weights, the JAX kernels in
interpret mode), eager and replayed.

The engine's cache lengths stay multiples of 128, or at most 128 (one
block): the JAX decode kernel's interpret mode pads a ragged last block
with NaN.
"""
from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnsum_tpu.backend import long_context as jlc
from vnsum_tpu.backend.engine import TpuBackend
from vnsum_tpu.core.config import GenerationConfig as JaxGenerationConfig
from vnsum_tpu.parallel.mesh import make_mesh
from vnsum_tpu_torch.backend import capture
from vnsum_tpu_torch.backend import long_context as tlc
from vnsum_tpu_torch.backend.engine import TorchBackend
from vnsum_tpu_torch.core.config import GenerationConfig
from vnsum_tpu_torch.models import llama as tl
from vnsum_tpu_torch.ops import decode_attention, flash_attention, int8_matmul, verify_attention

from test_torch_engine import PROMPTS, record_ids
from test_torch_models_llama import carried_weights, one_torch_thread  # noqa: F401

MODES = ["eager", "replayed"]


@pytest.fixture(scope="module")
def carried():
    return carried_weights(max_seq_len=1024)


@pytest.fixture
def replayed(monkeypatch):
    """Stand a stub in for the CUDA graph: recording runs nothing, and each
    replay calls the recorded step once more."""
    recorded = []

    def record(step):
        recorded.append(step)
        return SimpleNamespace(replay=step)

    monkeypatch.setattr(capture, "record_cuda_graph", record)
    return recorded


def check_loop_stats(stats, mode: str) -> None:
    if mode == "eager":
        assert stats.graph_captures == stats.captured_steps == 0
    else:
        # every group: step 0 eager (the warm-up), the rest replays
        assert stats.captured_steps > 0
        assert stats.captured_steps + stats.graph_captures == stats.decode_steps


# -- the one-shot engine ---------------------------------------------------------

SHORT = ["Xin chào thế giới", "abc " * 10]   # one S=64 bucket
# arm -> (prompts, batch_size, int8 KV cache, eos_ids, max_new)
ENGINE_ARMS = {
    # 3 prompts at batch 4: an all-pad filler row, which starts done
    "int8_filler_row": (PROMPTS, 4, True, (), 128),
    "f32_cache": (PROMPTS, 4, False, (), 128),
    # rows stop at different steps
    "eos_stops_rows": (PROMPTS, 4, True, (19, 71), 128),
    # C = 64 + 40 = 104 slots, one block; the last check falls at step 32
    "max_new_40": (SHORT, 2, True, (), 40),
}
_jax_engine_runs: dict = {}


def jax_engine_run(carried, arm):
    """The JAX engine's texts and id rows for an arm, computed once."""
    if arm not in _jax_engine_runs:
        jcfg, params, _ = carried
        prompts, batch, int8, eos, max_new = ENGINE_ARMS[arm]
        jb = TpuBackend(
            model_config=jcfg, params=params, flash=True, interpret=True,
            quantize_kv=int8, batch_size=batch, max_new_tokens=max_new,
            generation=JaxGenerationConfig(eos_ids=eos),
        )
        ids = record_ids(jb)
        _jax_engine_runs[arm] = (jb.generate(prompts), ids)
    return _jax_engine_runs[arm]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arm", list(ENGINE_ARMS))
def test_engine_step_matches_jax_engine(carried, request, arm, mode):
    _, _, model = carried
    prompts, batch, int8, eos, max_new = ENGINE_ARMS[arm]
    tb = TorchBackend(
        model=model, flash=True, quantize_kv=int8, batch_size=batch,
        max_new_tokens=max_new, generation=GenerationConfig(eos_ids=eos), device="cpu",
    )
    if mode == "replayed":
        request.getfixturevalue("replayed")
        tb.cuda_graphs = True  # the constructor refuses True off the card
    ids = record_ids(tb)
    want_texts, want_ids = jax_engine_run(carried, arm)
    assert tb.generate(prompts) == want_texts
    assert ids == want_ids
    check_loop_stats(tb.stats, mode)


# -- the long-context decode -------------------------------------------------------


@pytest.fixture(scope="module")
def mesh():
    return make_mesh({"seq": 4}, platform="cpu")


@pytest.fixture(scope="module")
def long_carried():
    # seed 4: random greedy rows that do not all collapse onto one token
    return carried_weights(4, max_seq_len=2048)


def long_inputs(B: int = 4, S: int = 512):
    """Random prompt ids with left pads 0, 70 and 300 and an all-pad filler
    row (pad = S), which starts done."""
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 256, size=(B, S)).astype(np.int32)
    pads = np.array([0, 70, 300, S], dtype=np.int32)
    for b, p in enumerate(pads):
        tokens[b, :p] = 258
    return tokens, pads


# arm -> (int8 prefill cache, stop rows early, max_new)
LONG_ARMS = {
    "f32": (False, False, 16),
    "int8": (True, False, 16),
    # terminators taken from the run without them: rows 0 and 1 stop by
    # steps 3 and 6
    "eos_stops_rows": (False, True, 16),
    "max_new_21": (True, False, 21),
}
_jax_long_runs: dict = {}


def jax_long_ids(mesh, long_carried, int8: bool, max_new: int, eos_ids) -> np.ndarray:
    key = (int8, max_new, tuple(eos_ids))
    if key not in _jax_long_runs:
        jcfg, params, _ = long_carried
        tokens, pads = long_inputs()
        fn = jax.jit(lambda p, tok, pl: jlc.generate_long_tokens(
            p, jcfg, mesh, tok, pl, max_new, eos_ids=eos_ids, pad_id=0,
            quantize_kv=int8, decode_kernel=True, interpret=True,
        ))
        _jax_long_runs[key] = np.asarray(fn(params, jnp.asarray(tokens), jnp.asarray(pads)))
    return _jax_long_runs[key]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arm", list(LONG_ARMS))
def test_long_step_matches_jax_generate_long_tokens(mesh, long_carried, request, arm, mode):
    _, _, model = long_carried
    int8, stop_early, max_new = LONG_ARMS[arm]
    tokens, pads = long_inputs()
    eos_ids = (1,)
    if stop_early:
        free = jax_long_ids(mesh, long_carried, int8, max_new, eos_ids)
        eos_ids = (int(free[0, 3]), int(free[1, 6]))
    stats = tlc.EngineStats()
    if mode == "replayed":
        request.getfixturevalue("replayed")
    got = tlc.generate_long_tokens(
        model, torch.from_numpy(tokens), torch.from_numpy(pads), max_new,
        eos_ids=eos_ids, pad_id=0, quantize_kv=int8, stats=stats,
        cuda_graphs=mode == "replayed",
    ).numpy()
    want = jax_long_ids(mesh, long_carried, int8, max_new, eos_ids)
    np.testing.assert_array_equal(got, want)
    assert (got[3] == 0).all()  # the filler row emits pad only
    if stop_early:
        assert (got[0, 4:] == 0).all() and (got[1, 7:] == 0).all()
    check_loop_stats(stats, mode)


# -- the pieces the captured step reads on the device ------------------------------


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_cache_write_equal_row_slots_match_the_int_slot(S, dtype):
    """The tensor branch of cache_write with one slot repeated for every
    row, and its row_slots pair, write what the int branch writes."""
    gen = torch.Generator().manual_seed(3)
    B, KV, C, hd = 3, 2, 16, 8
    val = (torch.randn((B, KV, S, hd), generator=gen) * 50).to(dtype)
    want = torch.zeros((B, KV, C, hd), dtype=dtype)
    got = torch.zeros_like(want)
    tl.cache_write(want, val, 9)
    tl.cache_write(got, val, torch.tensor([9]).expand(B))
    assert torch.equal(got, want)
    # the (rows, slots) pair the decoder computes once for all its layers
    pair = torch.zeros_like(want)
    tl.cache_write(pair, val, tl.row_slots(torch.tensor([9]).expand(B), C, S))
    assert torch.equal(pair, want)
    # and the [B, KV, C] scale rows of an int8 cache
    scales = torch.rand((B, KV, S), generator=gen)
    want_s, got_s = torch.zeros((B, KV, C)), torch.zeros((B, KV, C))
    tl.cache_write(want_s, scales, 9)
    tl.cache_write(got_s, scales, torch.tensor([9]).expand(B))
    assert torch.equal(got_s, want_s)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_long_attention_device_t_matches_host_t(quantized):
    """make_long_decode_attention's decode-cache mask at a one-element
    tensor t equals the one at the int t."""
    gen = torch.Generator().manual_seed(5)
    L, B, KV, G, hd, S_loc, C = 2, 3, 2, 2, 16, 128, 8
    cache = {n: torch.randn((L, B, KV, S_loc, hd), generator=gen) for n in ("k", "v")}
    if quantized:
        cache = tlc.quantize_prefill_cache(cache)
    pads = torch.tensor([0, 40, 128], dtype=torch.int32)
    attention = tlc.make_long_decode_attention(cache, pads, G)
    q = torch.randn((B, 1, KV * G, hd), generator=gen)
    dec = {n: torch.randn((L, B, KV, C, hd), generator=gen) for n in ("k", "v")}
    for t in (0, 5):
        want = attention(q, dec, 1, t)
        assert torch.equal(attention(q, dec, 1, torch.tensor([t])), want)


# -- capture.py's bookkeeping ----------------------------------------------------------


@pytest.fixture
def counters(monkeypatch):
    """Launch counters at known values, put back after the test."""
    start = {"prefill": 5, "decode": 100, "partials": 7, "verify": 3, "gemv": 11}
    monkeypatch.setattr(flash_attention, "launches", start["prefill"])
    monkeypatch.setattr(decode_attention, "launches", start["decode"])
    monkeypatch.setattr(decode_attention, "partials_launches", start["partials"])
    monkeypatch.setattr(verify_attention, "launches", start["verify"])
    monkeypatch.setattr(int8_matmul, "launches", start["gemv"])
    return start


def test_captured_step_moves_the_counters_once_per_replay(monkeypatch, counters):
    """What the capture counted is taken back, then added once per replay."""
    replays = []

    def fake_step():  # counts as the wrappers do when Python calls them
        decode_attention.launches += 28
        verify_attention.launches += 1
        int8_matmul.launches += 197

    def record(step):
        step()
        return SimpleNamespace(replay=lambda: replays.append(1))

    monkeypatch.setattr(capture, "record_cuda_graph", record)
    graph = capture.CapturedStep(fake_step)
    assert graph.launches == {"prefill": 0, "decode": 28, "partials": 0, "verify": 1,
                              "gemv": 197}
    assert capture.read_launches() == counters
    for _ in range(3):
        graph.replay()
    assert len(replays) == graph.replays == 3
    assert capture.read_launches() == {**counters, "decode": 100 + 3 * 28, "verify": 3 + 3,
                                       "gemv": 11 + 3 * 197}


# (max_new, the step after which every row is done) -> steps the loop runs
LOOP_CASES = {
    "stops_at_check": (64, 5, 16),
    "done_at_once": (64, 0, 16),
    "budget_first": (10, 99, 10),
    "one_step": (1, 99, 1),
}


@pytest.mark.parametrize("capture_on", [False, True], ids=["eager", "replayed"])
@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_decode_loop_steps_checks_and_replays(replayed, case, capture_on):
    """The loop reads done every DONE_CHECK_INTERVAL steps and runs the same
    steps eager and replayed; replays take the step counter from the device
    buffer, never from the host."""
    max_new, done_after, want_steps = LOOP_CASES[case]
    t = torch.zeros((1,), dtype=torch.long)
    done = torch.zeros((2,), dtype=torch.bool)
    seen = []

    def step(t_host):
        seen.append(int(t))
        done.logical_or_(t >= done_after)
        t.add_(1)

    run = capture.decode_loop(step, done, max_new, capture=capture_on)
    assert run.steps == want_steps and seen == list(range(want_steps))
    captured = capture_on and max_new > 1
    assert run.captures == int(captured)
    assert run.replays == (want_steps - 1 if captured else 0)
    assert capture.DONE_CHECK_INTERVAL == 16


# -- where capture applies -------------------------------------------------------------


def test_cuda_graphs_true_raises_where_capture_cannot_apply(carried):
    _, _, model = carried
    for flash in (True, False):
        with pytest.raises(ValueError, match="cuda_graphs=True"):
            TorchBackend(model=model, flash=flash, cuda_graphs=True, device="cpu")
    with pytest.raises(ValueError, match="cuda_graphs=True"):
        tlc.TorchLongContextBackend(model=model, cuda_graphs=True, device="cpu")
    # a backend that requires capture refuses sampled rows; "auto" keeps
    # them eager
    sampled = GenerationConfig(temperature=1.0)
    with pytest.raises(ValueError, match="greedy"):
        capture.captures(sampled, True, True)
    assert not capture.captures(sampled, True, False)
    assert capture.captures(GenerationConfig(), True, False)


def test_no_captured_steps_on_the_cpu_or_for_sampled_rows(carried, replayed):
    _, _, model = carried
    # the CPU: "auto" resolves to eager
    tb = TorchBackend(model=model, flash=True, max_new_tokens=32, batch_size=4, device="cpu")
    lb = tlc.TorchLongContextBackend(
        model=model, batch_size=4, max_new_tokens=8, max_total_tokens=1024, device="cpu"
    )
    assert not tb.cuda_graphs and not lb.cuda_graphs
    tb.generate(PROMPTS)
    lb.generate(PROMPTS)
    for st in (tb.stats, lb.stats):
        assert st.decode_steps > 0 and st.captured_steps == st.graph_captures == 0
    # sampled rows stay eager where capture is on
    sampled = GenerationConfig(temperature=1.0, seed=2)
    for be in (tb, lb):
        be.cuda_graphs = True
        steps = be.stats.decode_steps
        be.generate(PROMPTS, config=sampled)
        assert be.stats.decode_steps > steps
        assert be.stats.captured_steps == be.stats.graph_captures == 0
        assert be.stats.to_dict()["captured_steps"] == 0
    assert replayed == []
