"""The prefix KV cache in the port's slot loop (TorchSlotLoop over
TorchBackend(cache_blocks=n)) against the JAX package's TpuSlotLoop, on
carried weights: the scenarios of tests/test_inflight_engine.py's
prefix-cache section, port against JAX.

Joiners are ordered by uncovered suffix and resume their prefill from the
radix cache while LRU churns a tiny pool: every request's greedy text must
equal JAX's and a cache-less solo run's, each admission must report the
cached tokens JAX's does, and the pool must end in JAX's state. JAX's own
scenario sits at S = 104, below the resume grid's first step (K >= 128), so
it only inserts and matches; at S = 256 the joins resume, once through the
kernels' int8 path (the JAX kernels in interpret mode, C = 384) and once
dense on an f32 cache. An eviction pins the evictee's cached prefix until
the caller releases it, as in JAX; ``pin=False`` takes no pin.
"""
from __future__ import annotations

import pytest

from vnsum_tpu.backend.engine import TpuBackend
from vnsum_tpu_torch.backend.engine import TorchBackend

from test_torch_models_llama import carried_weights, one_torch_thread  # noqa: F401

HEADER = "tiêu đề chung của các tài liệu dài: "
PROMPTS = [HEADER + f"nội dung {i} " * 3 for i in range(6)]
# a 177-token header, 216-token prompts: at S = 256 a warm join resumes at
# K = 128
LONG_HEADER = "tiêu đề chung của các tài liệu dài, phần mở đầu được lặp lại: " * 2
LONG_PROMPTS = [LONG_HEADER + f"nội dung {i} " * 3 for i in range(6)]

# scenario -> (max_seq_len, new tokens, prompts, hint, JAX kernels in
# interpret mode with an int8 cache (else dense, f32), pool blocks)
SCENARIOS = {
    "jax_s104": (128, 24, PROMPTS, HEADER, False, 6),
    "resume_int8": (512, 128, LONG_PROMPTS, LONG_HEADER, True, 6),
    "resume_f32": (512, 128, LONG_PROMPTS, None, False, 12),
}


def backends(name, cache=True):
    max_seq, new, _, _, kernels, blocks = SCENARIOS[name]
    jcfg, params, model = carried_weights(max_seq_len=max_seq)
    kw = dict(batch_size=8, max_new_tokens=new, seed=1, segment_tokens=4)
    ckw = dict(cache_blocks=blocks, cache_block_tokens=16) if cache else {}
    return (TorchBackend(model=model, flash=True, quantize_kv=kernels, device="cpu", **kw, **ckw),
            TpuBackend(model_config=jcfg, params=params, flash=kernels, interpret=kernels,
                       **kw, **ckw))


def churn(b, prompts, hint):
    """JAX's refill scenario: admit 2 of 6, then refill as slots free, the
    header as every request's hint. Returns (texts by key, admissions as
    (key, cached tokens) in admit order)."""
    loop = b.start_slot_loop(4)
    outs: dict[int, str] = {}
    admitted = []
    pending = list(range(len(prompts)))
    adm, _ = loop.admit([(i, prompts[i], hint) for i in pending[:2]])
    for a in adm:
        pending.remove(a.key)
        admitted.append((a.key, a.cached_tokens))
    for _ in range(128):
        for c in loop.step().completions:
            outs[c.key] = c.text
        if pending and loop.free:
            adm, rej = loop.admit([(i, prompts[i], hint) for i in pending])
            assert rej == []
            for a in adm:
                pending.remove(a.key)
                admitted.append((a.key, a.cached_tokens))
        if not pending and loop.active == 0:
            break
    loop.close()
    return [outs[i] for i in range(len(prompts))], admitted


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_refill_resumes_from_prefix_cache_under_eviction_churn(name):
    _, _, prompts, hint, kernels, blocks = SCENARIOS[name]
    port, jax_side = backends(name)
    assert port.quantize_kv == jax_side.quantize_kv == kernels
    solo_backend, _ = backends(name, cache=False)
    solo = [solo_backend.generate([p])[0] for p in prompts]
    outs, admitted = churn(port, prompts, hint)
    jouts, jadmitted = churn(jax_side, prompts, hint)
    assert outs == jouts == solo
    assert admitted == jadmitted
    st = port.prefix_cache.stats_dict()
    assert st == jax_side.prefix_cache.stats_dict()
    assert st["blocks_used"] <= blocks and st["pinned_blocks"] == 0
    for k in ("cache_hit_tokens", "cache_miss_tokens"):
        assert getattr(port.stats, k) == getattr(jax_side.stats, k)
    if name == "jax_s104":
        assert port.stats.cache_hit_tokens == 0  # K would be below 128
    else:
        assert port.stats.cache_hit_tokens > 0
        assert sum(c for _, c in admitted) == port.stats.cache_hit_tokens


@pytest.mark.parametrize("pin", [True, False])
def test_evict_pins_prefix_blocks_until_released(pin):
    """Eviction with the cache on returns a live pin (with pin=True): the
    evictee's cached prefix is unevictable until released, and releasing
    restores the pre-eviction pin level; the pinned blocks and pin counts
    equal JAX's at every step."""
    header = "tiêu đề chung: "
    counts = {}
    for side, b in zip(("port", "jax"), backends("jax_s104")):
        cache = b.prefix_cache
        loop = b.start_slot_loop(2)
        adm, rej = loop.admit([(0, header + "nội dung một hai", header)])
        assert len(adm) == 1 and rej == []
        loop.step()
        seen = [cache.index.pinned_blocks]  # the admit released its pins
        evs = loop.evict([adm[0].key], pin=pin)
        seen.append(cache.index.pinned_blocks)
        if pin:
            pool, match = evs[0].pin
            assert pool is cache
            seen.append(match.blocks)
            pool.release(match)
        else:
            assert evs[0].pin is None
        seen.append(cache.index.pinned_blocks)
        assert loop.free == 2 and loop.outstanding() == []
        loop.close()
        counts[side] = seen
    assert counts["port"] == counts["jax"]
    assert counts["port"][0] == counts["port"][-1] == 0
    assert (counts["port"][1] > 0) == pin
