"""The prefix KV cache in the port's engine (TorchBackend(cache_blocks=n))
and in its FakeBackend against the JAX package's, on the CPU.

On carried weights, every arm runs the same calls through the JAX engine
with the cache on (TpuBackend(cache_blocks=n)) and the port's with and
without it: greedy texts and generated id rows byte for byte, and the
per-prompt cache reports, the hit and miss counters, the pool stats and the
read-only probe equal to JAX's. The JAX engine runs its kernels in interpret
mode (int8 cache) where every cache length is a multiple of 128 (ROADMAP
§C: interpret mode pads a ragged block with NaN), else dense with an f32
cache, as the port's f32 arms. A resumed prefill is a bitwise copy of the
full prefill's prefix plus a forward over [K, S): the gathered slots are
held bit for bit to the cold call's cache, and the resumed logits to the
full prefill's at f32 summation order, with a gather one block off planted
to show the limit sees it.
"""
from __future__ import annotations

import pytest
import torch

from vnsum_tpu.backend.engine import TpuBackend
from vnsum_tpu.backend.fake import FakeBackend as JaxFakeBackend
from vnsum_tpu.core.config import GenerationConfig as JaxGenerationConfig
from vnsum_tpu_torch.backend.engine import TorchBackend
from vnsum_tpu_torch.backend.fake import FakeBackend
from vnsum_tpu_torch.core.config import GenerationConfig

from test_torch_engine import record_ids
from test_torch_models_gemma import GEMMA_KW
from test_torch_models_llama import carried_weights, one_torch_thread  # noqa: F401

HEADER = ("Bạn là một chuyên gia tóm tắt nội dung. "
          "Vui lòng viết một bản tóm tắt chi tiết cho văn bản sau đây. ")
# 195 tokens (the bytes and BOS): S = 256, pad 61; a warm call matches 192
# tokens a row and resumes at K = 128, skipping 67 a row
PROMPTS = [HEADER + f"Nội dung riêng biệt số {i}: câu chuyện làng quê thứ {i}." for i in range(4)]
OTHER = ["Văn bản hoàn toàn khác biệt " * 7 + f"số {i}" for i in range(4)]
SHORT = ["Câu hỏi ngắn.", "Hai câu hỏi ngắn khác."]
# 552 tokens: S = 896 (the bucket fallback, C = 1024), pad 344; after a call
# hinted with the 257-token header, K = 512: a resumed span of three chunks
LONG = [HEADER * 2 + f"Phần riêng thứ {i}: " + "nội dung dài của tài liệu " * 8 for i in range(4)]
NEW = 128


@pytest.fixture(scope="module")
def carried():
    return carried_weights(max_seq_len=1024)


@pytest.fixture(scope="module")
def gemma_carried():
    return carried_weights(**GEMMA_KW, max_seq_len=512)


def gen_cfg(side, **kw):
    return (JaxGenerationConfig if side == "jax" else GenerationConfig)(**kw)


# arm -> (calls: [(prompts, hints, spec)], backend keywords, JAX kernels
# in interpret mode (int8 cache) else dense with the port on an f32 cache,
# set_prefix_cache_inserts(False) before call index)
ARMS = {
    "cold_warm": ([(PROMPTS, None, False)] * 2, {}, True, None),
    "hinted": ([(PROMPTS, HEADER, False)] * 2, dict(cache_block_tokens=32), True, None),
    "post_eviction": ([(PROMPTS, None, False), (OTHER, None, False), (PROMPTS, None, False)],
                      dict(cache_blocks=3), True, None),
    "mixed_lengths": ([(PROMPTS + SHORT, None, False)] * 2, {}, False, None),
    "no_inserts": ([(PROMPTS, None, False), (OTHER, None, False), (OTHER, None, False),
                    (PROMPTS, None, False)], {}, True, 1),
    # dense: the spec path's cache, C = S + 128 + 5, is no multiple of 128
    "spec_bypass": ([(PROMPTS, None, False), (PROMPTS, None, True), (PROMPTS, None, False)],
                    {}, False, None),
    "chunked": ([(LONG, HEADER * 2, False)] * 2, dict(prefill_chunk_tokens=128), True, None),
    "f32": ([(PROMPTS, None, False)] * 2, {}, False, None),
    "quantize": ([(PROMPTS, None, False)] * 2, dict(quantize=True), True, None),
    "w8a8": ([(PROMPTS, None, False)] * 2, dict(quantize=True, quantize_act=True), True, None),
}


def run_calls(b, side, calls, no_inserts_from):
    """Every call's texts, cache report and the stats after it."""
    out = []
    for n, (prompts, hint, spec) in enumerate(calls):
        if n == no_inserts_from:
            b.set_prefix_cache_inserts(False)
        kw = {}
        if spec:
            kw = dict(config=gen_cfg(side, spec_k=4, max_new_tokens=NEW), references=prompts)
        texts = b.generate(prompts, cache_hints=None if hint is None else [hint] * len(prompts),
                           **kw)
        out.append((texts, b.take_cache_report(), b.stats.cache_hit_tokens,
                    b.stats.cache_miss_tokens, b.prefix_cache_stats()))
    return out


def run_arm(carried, arm):
    jcfg, params, model = carried
    calls, kw, jax_kernels, no_inserts_from = ARMS[arm]
    kw = {"cache_blocks": 32, "cache_block_tokens": 64, **kw}
    jb = TpuBackend(model_config=jcfg, params=params, flash=jax_kernels, interpret=jax_kernels,
                    batch_size=4, max_new_tokens=NEW, **kw)
    tb = TorchBackend(model=model, flash=True, quantize_kv=jax_kernels, batch_size=4,
                      max_new_tokens=NEW, device="cpu", **kw)
    plain_kw = {k: v for k, v in kw.items() if not k.startswith("cache_")}
    ub = TorchBackend(model=model, flash=True, quantize_kv=jax_kernels, batch_size=4,
                      max_new_tokens=NEW, device="cpu", **plain_kw)
    assert tb.quantize_kv == jb.quantize_kv == jax_kernels
    j_ids, t_ids = record_ids(jb), record_ids(tb)
    want = run_calls(jb, "jax", calls, no_inserts_from)
    got = run_calls(tb, "port", calls, no_inserts_from)
    plain = [ub.generate(p, **({"config": gen_cfg("port", spec_k=4, max_new_tokens=NEW),
                                "references": p} if spec else {}))
             for p, _, spec in calls]
    return jb, tb, want, got, plain, j_ids, t_ids


@pytest.mark.parametrize("arm", list(ARMS))
def test_arm_matches_jax_engine(carried, arm):
    jb, tb, want, got, plain, j_ids, t_ids = run_arm(carried, arm)
    assert got == want
    assert [texts for texts, *_ in got] == plain
    assert t_ids == j_ids and any(t != tb.tok.pad_id for r in t_ids for t in r)
    assert tb.stats.by_bucket == jb.stats.by_bucket
    reports = [r for _, r, *_ in got]
    for prompts, *_ in ARMS[arm][0]:
        for p in prompts:
            assert tb.cached_prefix_tokens(p) == jb.cached_prefix_tokens(p)
    assert tb.prefix_cache.index.pinned_blocks == 0  # every call released its pins
    if arm == "cold_warm":
        assert reports[0] == [0] * 4 and reports[1] == [128 - 61] * 4  # K = 128, pad 61
    elif arm == "hinted":
        # only the hinted header's blocks (4 of 32 tokens) entered the pool
        assert got[0][4]["blocks_used"] == (len(HEADER.encode()) + 1) // 32 == 4
        assert sum(reports[1]) > 0
    elif arm == "post_eviction":
        assert got[-1][4]["evictions"] > 0 and got[-1][4]["blocks_used"] <= 3
    elif arm == "mixed_lengths":
        assert sum(reports[1]) > 0 and reports[1][4:] == [0, 0]
    elif arm == "no_inserts":
        assert got[2][1] == [0] * 4 and got[2][4]["inserted_blocks"] == got[0][4][
            "inserted_blocks"]
        assert sum(reports[3]) > 0  # the pool still serves
    elif arm == "spec_bypass":
        assert reports[1] == [] and sum(reports[2]) > 0
        assert got[1][2:4] == got[0][2:4]  # the spec call counted nothing
        assert tb.stats.spec_verify_steps > 0
    elif arm == "chunked":
        assert reports[1] == [512 - 344] * 4
    else:
        assert sum(reports[1]) > 0


def test_gemma_windows_match_jax_engine(gemma_carried):
    """A tiny Gemma3 (window 8 on two of three layers) resumes at K = 128:
    the first queries of [K, S) see a window floor inside the gathered
    blocks. Dense JAX against the port's plain kernels, f32 cache."""
    jb, tb, want, got, plain, j_ids, t_ids = run_arm(gemma_carried, "f32")
    assert tb.windows == [8, 0, 8]
    assert got == want and [texts for texts, *_ in got] == plain
    assert t_ids == j_ids
    assert sum(got[1][1]) > 0


def resume_pair(carried, quantized):
    """A cold call and a warm call of PROMPTS on the port: the cold call's
    final cache and, for the warm call, the seeded cache (a copy) and K."""
    _, _, model = carried
    tb = TorchBackend(model=model, flash=True, quantize_kv=quantized, batch_size=4,
                      max_new_tokens=NEW, cache_blocks=32, device="cpu")
    caches, seeded = [], []
    run_group, prepare = tb._run_group, tb._prepare_resume

    def spy_run(*args, **kw):
        out, cache = run_group(*args, **kw)
        caches.append({n: t.clone() for n, t in cache.items()})
        return out, cache

    def spy_prepare(*args):
        res = prepare(*args)
        if res is not None:
            seeded.append((res[0], {n: t.clone() for n, t in res[1].items()}))
        return res

    tb._run_group, tb._prepare_resume = spy_run, spy_prepare
    tb.generate(PROMPTS)
    tb.generate(PROMPTS)
    return tb, caches[0], seeded


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_gathered_prefix_and_resume_logits(carried, quantized):
    """The warm call's seeded cache equals the cold call's at slots
    [pad_r, K) of every row and on to the end of the last gathered block,
    bit for bit (scales included), and is zero elsewhere; the resumed prefill's last-position logits are the
    full prefill's to f32 summation order, while a gather one block late
    (planted here) moves them far past that limit."""
    tb, cold, seeded = resume_pair(carried, quantized)
    ((K, seed_cache),) = seeded
    tokens_np, pads_np, B, S = tb._pack_group(list(range(4)), [
        tb.tok.encode(p, add_bos=True) for p in PROMPTS], NEW)
    assert K == 128 and S == 256
    for name, buf in seed_cache.items():
        for row, pad in enumerate(pads_np[:4]):
            # whole blocks: the last one runs past K, to pad + 2 * 64
            end = pad + -(-(K - pad) // 64) * 64
            assert torch.equal(buf[:, row, :, pad:end], cold[name][:, row, :, pad:end])
            assert not buf[:, row, :, end:].any() and not buf[:, row, :, :pad].any()

    def last_logits(resume):
        cache = ({n: t.clone() for n, t in resume[1].items()} if resume else None)
        start = resume[0] if resume else 0
        if cache is None:
            from vnsum_tpu_torch.models.llama import init_kv_cache

            cache = init_kv_cache(tb.cfg, B, S + NEW, quantized=quantized, device="cpu")
        with torch.inference_mode():
            return tb._prefill_forward(torch.from_numpy(tokens_np), torch.from_numpy(pads_np),
                                       B, S, S + NEW, cache, start)[:4, -1]

    full = last_logits(None)
    scale = float(full.abs().max())
    sound = float((last_logits((K, seed_cache)) - full).abs().max()) / scale
    late = {n: torch.zeros_like(t) for n, t in seed_cache.items()}
    for name, buf in seed_cache.items():  # slots are dim 3 of K/V and scales
        late[name][:, :, :, 64:K] = buf[:, :, :, : K - 64]
    planted = float((last_logits((K, late)) - full).abs().max()) / scale
    assert sound < 1e-5 < 1e-2 < planted


@pytest.mark.parametrize("blk", [0, 129])
def test_block_width_checked(carried, blk):
    jcfg, params, model = carried
    with pytest.raises(ValueError, match="cache_block_tokens"):
        TpuBackend(model_config=jcfg, params=params, max_new_tokens=NEW, cache_blocks=8,
                   cache_block_tokens=blk)
    with pytest.raises(ValueError, match="cache_block_tokens"):
        TorchBackend(model=carried[2], max_new_tokens=NEW, cache_blocks=8,
                     cache_block_tokens=blk, device="cpu")


def test_cache_off_hooks(carried):
    jcfg, params, model = carried
    jb = TpuBackend(model_config=jcfg, params=params, flash=False, max_new_tokens=NEW)
    tb = TorchBackend(model=model, flash=True, max_new_tokens=NEW, device="cpu")
    for b in (jb, tb):
        assert b.prefix_cache is None and b.prefix_cache_stats() is None
        assert b.cached_prefix_tokens(PROMPTS[0]) == 0
    assert tb.generate(SHORT) == jb.generate(SHORT)
    assert tb.take_cache_report() == jb.take_cache_report() == []
    d = tb.stats.to_dict()
    assert d["cache_hit_tokens"] == d["cache_miss_tokens"] == 0


# -- FakeBackend's mirror ----------------------------------------------------


def fake_pair(monkeypatch, **kw):
    """(port, JAX) FakeBackends, each recording the seconds it bills."""
    slept = {"port": [], "jax": []}
    monkeypatch.setattr(FakeBackend, "_sleep_cancellable",
                        lambda self, s: slept["port"].append(s) or False)
    monkeypatch.setattr(JaxFakeBackend, "_sleep_cancellable",
                        lambda self, s: slept["jax"].append(s) or False)
    return FakeBackend(**kw), JaxFakeBackend(**kw), slept


def both(pair, fn):
    port, jax_side, _ = pair
    a, b = fn(port), fn(jax_side)
    assert a == b
    return a


def test_fake_cache_contract(monkeypatch):
    pair = fake_pair(monkeypatch, prefix_cache_blocks=16, cache_block_tokens=4,
                     per_token_s=0.01)
    prompts = ["chung toi cung mot tieu de dai " * 3 + f"duy nhat {i}" for i in range(3)]
    both(pair, lambda b: b.generate(prompts))
    assert both(pair, lambda b: b.take_cache_report()) == [0, 0, 0]
    both(pair, lambda b: b.generate(prompts))
    assert all(r > 0 for r in both(pair, lambda b: b.take_cache_report()))
    assert both(pair, lambda b: b.cached_prefix_tokens(prompts[0])) > 0
    st = both(pair, lambda b: b.prefix_cache_stats())
    assert st["blocks_used"] > 0 and st["blocks_total"] == 16
    slept = pair[2]
    assert slept["port"] == pytest.approx(slept["jax"]) and slept["port"][1] < slept["port"][0]


def test_fake_honors_cache_hint(monkeypatch):
    pair = fake_pair(monkeypatch, prefix_cache_blocks=64, cache_block_tokens=2)
    hint = "mot hai ba bon"  # 4 words: 2 blocks
    prompts = [hint + f" phan duoi khac nhau hoan toan so {i} a b c d" for i in range(2)]
    both(pair, lambda b: b.generate(prompts, cache_hints=[hint, hint]))
    assert both(pair, lambda b: b.cache_hints_seen) == [hint, hint]
    assert both(pair, lambda b: b.prefix_cache_stats()["blocks_used"]) == 2
    both(pair, lambda b: b.generate(prompts, cache_hints=[hint, hint]))
    assert both(pair, lambda b: b.take_cache_report()) == [4, 4]
    both(pair, lambda b: b.set_prefix_cache_inserts(False))
    both(pair, lambda b: b.generate(["khac " * 9]))
    assert both(pair, lambda b: b.prefix_cache_stats()["blocks_used"]) == 2


def test_fake_cache_off_by_default(monkeypatch):
    pair = fake_pair(monkeypatch)
    both(pair, lambda b: b.generate(["xin chao"]))
    assert both(pair, lambda b: b.take_cache_report()) == []
    assert both(pair, lambda b: b.prefix_cache_stats()) is None
    assert both(pair, lambda b: b.cached_prefix_tokens("xin chao")) == 0
