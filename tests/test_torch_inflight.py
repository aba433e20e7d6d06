"""The port's in-flight slot loop (TorchSlotLoop over TorchBackend) against
the JAX package's TpuSlotLoop, on carried weights.

The contract: a request's greedy output is byte-identical to a solo
one-shot generate() no matter when it joined the resident batch, who it
decoded next to, or which slot it landed in; fused segments change only the
host's cadence; and the port's loop gives the JAX loop's texts and counters
in the same scenario. The JAX engine runs its kernels in interpret mode
(the slot segment through the verify kernel at Sq=1), the port's wrappers
their plain versions. tiny_llama at max_seq_len 128 with 24 new tokens puts
the prompt bucket at S=104, so every cache is C = 128 slots: the JAX
kernels' interpret mode pads a ragged last block with NaN.
"""
from __future__ import annotations

import pytest

from vnsum_tpu.backend.engine import TpuBackend
from vnsum_tpu.core.config import GenerationConfig as JaxGenerationConfig
from vnsum_tpu_torch.backend.engine import TorchBackend
from vnsum_tpu_torch.core.config import GenerationConfig

from test_torch_models_llama import carried_weights, one_torch_thread  # noqa: F401

PROMPTS = [
    "văn bản một về kinh tế",
    "hai",
    "văn bản thứ ba dài hơn một chút về xã hội",
    "bốn bốn",
    "năm năm năm",
    "sáu và bảy",
]
KW = dict(batch_size=8, max_new_tokens=24, seed=1, segment_tokens=4)


@pytest.fixture(scope="module")
def carried():
    return carried_weights(max_seq_len=128)


@pytest.fixture(scope="module")
def make(carried):
    """make("port"|"jax") -> a fresh backend on the carried weights."""
    jcfg, params, model = carried

    def build(side):
        if side == "jax":
            return TpuBackend(model_config=jcfg, params=params, flash=True, interpret=True, **KW)
        return TorchBackend(model=model, flash=True, device="cpu", **KW)

    return build


@pytest.fixture(scope="module")
def solo(make):
    b = make("port")
    return [b.generate([p])[0] for p in PROMPTS]


@pytest.fixture(scope="module")
def ragged_eos(make):
    """An extra EOS that fires at scattered depths, so rows finish at
    different segments and freed slots refill mid-flight. Returns the eos
    ids (each side builds its own GenerationConfig from them)."""
    b = make("port")
    ids = [b.tok.encode(o, add_bos=False) for o in b.generate(PROMPTS) if o]
    longest = max(ids, key=len)
    return (b.tok.eos_id, longest[len(longest) // 2])


def config(side, **kw):
    return (JaxGenerationConfig if side == "jax" else GenerationConfig)(**kw)


def drain(loop, outs, max_segments=64):
    for _ in range(max_segments):
        for c in loop.step().completions:
            outs[c.key] = c.text
        if loop.active == 0:
            return
    raise AssertionError("slot loop did not drain")


def staggered(b, gen=None, fused=1):
    """Admit 3, then refill as slots free until all 6 prompts are done."""
    loop = b.start_slot_loop(4, config=gen, fused_segments=fused)
    outs: dict = {}
    adm, rej = loop.admit([(i, PROMPTS[i], None) for i in (0, 1, 2)])
    # 3 joiners bucket to a join batch of 4, which fits the 4 free slots
    assert rej == [] and len(adm) == 3
    pending = [i for i in range(len(PROMPTS)) if i not in {a.key for a in adm}]
    for _ in range(64):
        for c in loop.step().completions:
            outs[c.key] = c.text
        if pending and loop.free:
            adm, rej = loop.admit([(i, PROMPTS[i], None) for i in pending])
            assert rej == []
            for a in adm:
                pending.remove(a.key)
        if not pending and loop.active == 0:
            break
    assert loop.active == 0 and not pending
    return [outs[i] for i in range(len(PROMPTS))], loop


@pytest.fixture(scope="module")
def staggered_n1(make, ragged_eos):
    runs = {}
    for side in ("port", "jax"):
        gen = config(side, eos_ids=ragged_eos, max_new_tokens=24)
        runs[side] = staggered(make(side), gen)
    return runs


def test_greedy_matches_jax_loop_and_solo_with_staggered_joins(make, staggered_n1, ragged_eos):
    (outs, loop), (jouts, jloop) = staggered_n1["port"], staggered_n1["jax"]
    b = make("port")
    gen = config("port", eos_ids=ragged_eos, max_new_tokens=24)
    solo = [b.generate([p], config=gen)[0] for p in PROMPTS]
    assert outs == jouts == solo
    assert len({len(s) for s in solo}) > 1  # termination depths really differ
    assert loop.refills == jloop.refills == len(PROMPTS)
    assert (loop.segments, loop.fused_dispatches) == (jloop.segments, jloop.fused_dispatches)
    # one decoder forward per step the segments ran, each through K3
    assert loop.decode_steps == loop.backend.stats.decode_steps > 0


@pytest.mark.parametrize("fused", [2, 4])
def test_fused_byte_identity_vs_n1_with_staggered_joins(make, staggered_n1, ragged_eos, fused):
    """N segments per dispatch run the same per-row update as N=1, so the
    texts stay identical under staggered joins and ragged EOS exits, while
    the segment and dispatch counters diverge by the fusing, as the JAX
    loop's do."""
    base, base_loop = staggered_n1["port"]
    outs, loop = staggered(make("port"), config("port", eos_ids=ragged_eos, max_new_tokens=24), fused)
    jouts, jloop = staggered(make("jax"), config("jax", eos_ids=ragged_eos, max_new_tokens=24), fused)
    assert outs == base == jouts
    assert base_loop.segments == base_loop.fused_dispatches
    assert loop.segments > loop.fused_dispatches
    assert loop.fused_dispatches < base_loop.fused_dispatches
    assert (loop.segments, loop.fused_dispatches) == (jloop.segments, jloop.fused_dispatches)


def at_depth(b):
    """A late joiner next to residents two segments deep."""
    loop = b.start_slot_loop(4)
    loop.admit([(0, PROMPTS[0], None), (1, PROMPTS[2], None)])
    loop.step()
    loop.step()
    adm, _ = loop.admit([(3, PROMPTS[3], None)])
    assert len(adm) == 1
    outs: dict = {}
    drain(loop, outs)
    return outs


def test_slots_at_different_depths_decode_together(make, solo):
    outs = at_depth(make("port"))
    assert outs == at_depth(make("jax"))
    assert outs[3] == solo[3] and outs[0] == solo[0] and outs[1] == solo[2]


def test_sampled_stream_independent_of_join_timing_and_companions(make):
    """Same loop seed and request uid give the same sampled stream, whether
    the request joins with a companion at once or alone, two segments into
    another request's decode. (The streams are not the
    JAX package's: a different generator, the same law.)"""
    gen = GenerationConfig(temperature=1.0, seed=7, max_new_tokens=24)
    target = PROMPTS[2]
    loop_a = make("port").start_slot_loop(4, config=gen)
    loop_a.admit([(0, PROMPTS[0], None), ("t", target, None)])
    outs_a: dict = {}
    drain(loop_a, outs_a)

    loop_b = make("port").start_slot_loop(4, config=gen)
    loop_b.admit([(0, PROMPTS[4], None)])
    loop_b.step()
    loop_b.step()
    adm, _ = loop_b.admit([("t", target, None)])
    assert len(adm) == 1
    outs_b: dict = {}
    drain(loop_b, outs_b)
    assert outs_a["t"] == outs_b["t"]
    # the companions differed, so this was not a trivially identical run
    assert outs_a[0] != "" or outs_b[0] != ""


def evict_readmit(b):
    loop = b.start_slot_loop(2)
    adm, _ = loop.admit([(i, PROMPTS[i], None) for i in (0, 1)])
    assert len(adm) == 2
    loop.step()
    loop.step()
    victim = adm[0].key
    evs = loop.evict([victim])
    assert [e.key for e in evs] == [victim]
    assert loop.free == 1 and victim not in loop.outstanding()
    outs: dict = {}
    drain(loop, outs)                       # the survivor finishes undisturbed
    assert 0 not in outs
    adm2, _ = loop.admit([(0, PROMPTS[0], None)])  # the requeue's re-admit
    assert len(adm2) == 1
    drain(loop, outs)
    return outs


def test_evict_frees_slots_and_readmit_is_byte_identical(make, solo):
    outs = evict_readmit(make("port"))
    assert outs == evict_readmit(make("jax"))
    assert outs == {0: solo[0], 1: solo[1]}


@pytest.mark.parametrize("fused", [1, 2])
def test_partial_outputs_are_prefixes_of_the_final_text(make, solo, fused):
    """The streaming harvest: per-boundary partial detok of a resident row
    extends monotonically into exactly the harvested text, at N=1 and at a
    fused cadence (served from the boundary snapshot)."""
    loop = make("port").start_slot_loop(2, fused_segments=fused)
    adm, _ = loop.admit([(0, PROMPTS[2], None)])
    key = adm[0].key
    snapshots, final = [], {}
    for _ in range(64):
        for c in loop.step().completions:
            final[c.key] = c.text
        if loop.active:
            part = loop.partial_outputs([key])
            if part:
                snapshots.append(part[id(key)])
        if not loop.active:
            break
    assert final[0] == solo[2]
    grown = [s for s in snapshots if s]
    assert grown, "no partial text surfaced during decode"
    for a, b in zip(grown, grown[1:]):
        assert b.startswith(a)
    assert final[0].startswith(grown[-1])


def early_stop(b):
    loop = b.start_slot_loop(2, fused_segments=8)
    adm, _ = loop.admit([(0, PROMPTS[2], None)])
    assert len(adm) == 1
    res = loop.step()
    assert loop.active == 0 and loop.fused_dispatches == 1
    return [c.text for c in res.completions], res.new_tokens, res.device_segments, loop.segments


def test_fused_early_stop_and_device_segment_accounting(make, solo):
    """One resident at fused=8 retires in ONE dispatch, and device_segments
    reports the segments that ran (ceil(tokens / segment_tokens)), never the
    fused bound: the same numbers as the JAX loop's."""
    got = early_stop(make("port"))
    assert got == early_stop(make("jax"))
    texts, new_tokens, segs, loop_segs = got
    assert texts == [solo[2]]
    assert segs == -(-new_tokens // KW["segment_tokens"]) == loop_segs
    assert 1 <= segs <= 6


def test_oversized_prompt_rejected_for_oneshot_fallback(make, solo):
    loop = make("port").start_slot_loop(2, prompt_tokens=64)
    assert loop.S == 64
    big = "x" * 200  # 200 byte tokens + bos > 64
    adm, rej = loop.admit([("big", big, None), ("ok", PROMPTS[1], None)])
    assert rej == ["big"] and [a.key for a in adm] == ["ok"]
    outs: dict = {}
    drain(loop, outs)
    assert outs["ok"] == solo[1]
    with pytest.raises(ValueError, match="exceeds the context budget"):
        make("port").start_slot_loop(2, prompt_tokens=200)


def test_join_bucket_never_exceeds_free_slots(make):
    loop = make("port").start_slot_loop(4)
    loop.admit([(0, PROMPTS[0], None)])     # 1 busy, 3 free
    adm, _ = loop.admit([(i, PROMPTS[i], None) for i in (1, 2, 3)])
    # 3 joiners bucket to 4 > 3 free slots: clamped to a power of two
    assert len(adm) == 2 and loop.free == 1
    adm2, _ = loop.admit([(3, PROMPTS[3], None)])
    assert len(adm2) == 1 and loop.free == 0
    assert len({a.slot for a in adm + adm2}) == 3
    outs: dict = {}
    drain(loop, outs)
    assert set(outs) == {0, 1, 2, 3}


def test_closed_loop_refuses_work(make):
    loop = make("port").start_slot_loop(2)
    loop.close()
    with pytest.raises(RuntimeError, match="closed"):
        loop.admit([(0, PROMPTS[0], None)])
    with pytest.raises(RuntimeError, match="closed"):
        loop.step()


def test_parked_row_write_is_clamped_inside_the_cache(carried):
    """A finished slot-segment row parks at t = max_new and writes at
    C = S + max_new; the per-row write clamps to C - 1, as the JAX
    package's dynamic_update_slice does, and leaves the other rows alone."""
    import torch

    from vnsum_tpu_torch.models.llama import cache_write

    buf = torch.zeros((3, 2, 8, 4))
    val = torch.ones((3, 2, 1, 4)) * torch.tensor([1.0, 2.0, 3.0])[:, None, None, None]
    cache_write(buf, val, torch.tensor([2, 8, 7]))
    assert buf[0, :, 2].eq(1).all() and buf[1, :, 7].eq(2).all() and buf[2, :, 7].eq(3).all()
    assert buf.count_nonzero() == 3 * 2 * 4
    # Sq > 1 clamps the start to C - Sq, as dynamic_update_slice does
    buf = torch.zeros((1, 1, 8))
    cache_write(buf, torch.ones((1, 1, 3)), torch.tensor([7]))
    assert buf[0, 0].tolist() == [0, 0, 0, 0, 0, 1, 1, 1]
