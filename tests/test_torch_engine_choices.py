"""The constrained choice scorer of the port's engine
(``TorchBackend.score_choices``) against the JAX engine's
(``TpuBackend.score_choices``) on carried tiny f32 weights.

Each case runs both engines on the same prompts and checks:

- the same picks;
- the same packed batches (tokens, pads and S of every group);
- the five gathered logits of every row. The port's come from its own
  call; JAX's from its ``_prefill_forward`` on the batches its call packed,
  as ``_make_choice_fn`` runs it. They must agree within LOGITS_RTOL of the
  row's largest |logit|.

JAX runs its prefill kernel in interpret mode (``flash=True``) or dense. The
port runs K1's wrapper, which takes its plain version for CPU tensors.

LOGITS_RTOL: an f32 cache (or the dense path) differs from JAX only by
summation order. Measured: up to 2e-6 of the largest |logit| (10-16). So the
limit is 1e-5.

An int8 cache differs more. A K/V value whose f32 projection sits within
summation-order error of an int8 rounding boundary lands one int8 step away
(1/127 of its row's absmax). The more tokens a row holds, the more such
values it meets. Measured: up to 1.8e-4 of the largest |logit|, on a
256-token row with int8 weights. So the limit is 1e-3.

W8A8 rounds activations per token, and the same boundary effect applies
there. It is held at the int8 cache's limit, since its arm also runs an int8
cache.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from vnsum_tpu.backend.engine import TpuBackend
from vnsum_tpu_torch.backend.engine import TorchBackend

from test_torch_models_llama import carried_weights, one_torch_thread  # noqa: F401

CHOICES = ["1", "2", "3", "4", "5"]
MAX_SEQ_LEN = 256
PREFIX = '\n{"score": '
# (B, S) buckets with batch_size 2: 'short' and 'mid' pack at B=2, S=128;
# 'long' alone at B=1, S=256; alone, 'short' sits at S=64
SHORT = "tóm tắt A." + PREFIX
MID = "một bản tóm tắt vừa phải để đổi bucket: " * 2 + PREFIX
LONG = "một bản tóm tắt dài hơn hẳn để đổi bucket " * 4 + PREFIX
# past max_seq_len: cut from the left, BOS kept, the forced prefix kept
PAST = "Nội dung rất dài của văn bản cần đánh giá. " * 12 + PREFIX
PROMPT_SETS = {
    "one": [SHORT],
    "three": [SHORT, LONG, MID],
    "left_cut": [PAST, SHORT],
}
# arm -> (TorchBackend / TpuBackend keywords, logits limit)
ARMS = {
    "f32_cache": (dict(flash=True, quantize_kv=False), 1e-5),
    "int8_cache": (dict(flash=True), 1e-3),
    "dense": (dict(flash=False), 1e-5),
    "quantize": (dict(flash=True, quantize=True), 1e-3),
    "quantize_act": (dict(flash=True, quantize=True, quantize_act=True), 1e-3),
}


@pytest.fixture(scope="module")
def carried():
    return carried_weights(max_seq_len=MAX_SEQ_LEN)


def engines(carried, kw: dict, batch_size: int = 2):
    jcfg, params, model = carried
    jb = TpuBackend(model_config=jcfg, params=params, interpret=kw["flash"],
                    batch_size=batch_size, max_new_tokens=64, **kw)
    tb = TorchBackend(model=model, batch_size=batch_size, max_new_tokens=64, device="cpu", **kw)
    assert tb.quantize_kv == jb.quantize_kv
    return jb, tb


def recording(jb, tb):
    """Records every group each engine dispatches: JAX's (tokens, pads, S),
    the port's (tokens, pads, S, gathered logits)."""
    jax_groups, port_groups = [], []
    # JAX keeps a built choice function a bucket: drop them, so each is
    # rebuilt recording into this call's list
    jb._fns = {k: v for k, v in jb._fns.items() if k[0] != "choice"}
    make = type(jb)._make_choice_fn.__get__(jb)

    def make_recording(B, S, K):
        fn = make(B, S, K)

        def call(params, tokens, pads, ids):
            jax_groups.append((np.asarray(tokens), np.asarray(pads), S))
            return fn(params, tokens, pads, ids)

        return call

    jb._make_choice_fn = make_recording
    logits = type(tb)._choice_logits.__get__(tb)

    def spy(tokens, pads, S, ids):
        out = logits(tokens, pads, S, ids)
        port_groups.append((tokens, pads, S, out.numpy()))
        return out

    tb._choice_logits = spy
    return jax_groups, port_groups


def jax_choice_logits(jb, tokens, pads, S):
    """JAX's gathered logits of one packed group, as its choice function
    computes them before the argmax."""
    use_flash, _ = jb._decode_settings(S, S)
    logits, _ = jb._prefill_forward(jb.params, jnp.asarray(tokens), jnp.asarray(pads),
                                    len(pads), S, S, use_flash, jb._layer_window_fn())
    ids = [jb.tok.encode(c)[0] for c in CHOICES]
    return np.asarray(logits[:, -1, :])[:, ids]


def assert_same_choices(jb, tb, prompts, rtol):
    jax_groups, port_groups = recording(jb, tb)
    want = jb.score_choices(prompts, CHOICES)
    got = tb.score_choices(prompts, CHOICES)
    assert got == want
    assert len(port_groups) == len(jax_groups) > 0
    for (t, p, S, logits), (jt, jp, jS) in zip(port_groups, jax_groups):
        assert S == jS and np.array_equal(t, jt) and np.array_equal(p, jp)
        ref = jax_choice_logits(jb, jt, jp, jS)
        live = p < S  # all-pad filler rows pick nothing
        scale = np.abs(ref[live]).max(axis=-1, keepdims=True)
        err = np.abs(logits[live] - ref[live]) / scale
        assert np.all(err <= rtol), f"max |port - jax| / max |jax| {err.max():.3e}"
    return got


@pytest.mark.parametrize("prompts", sorted(PROMPT_SETS))
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_score_choices_matches_jax(carried, arm, prompts):
    kw, rtol = ARMS[arm]
    jb, tb = engines(carried, kw)
    assert_same_choices(jb, tb, PROMPT_SETS[prompts], rtol)
    # the stats score_choices keeps, as JAX keeps them
    for name in ("calls", "prompts", "prompt_tokens", "batches", "by_bucket"):
        assert getattr(tb.stats, name) == getattr(jb.stats, name), name
    assert tb.stats.generated_tokens == tb.stats.decode_steps == 0


@pytest.mark.parametrize("arm", ["int8_cache", "dense"])
def test_batch_invariance_across_buckets(carried, arm):
    """Three prompts over two S buckets pick together what each picks
    alone (three groups of B=1 at S=64, 128, 256), on both engines."""
    kw, rtol = ARMS[arm]
    jb, tb = engines(carried, kw)
    together = assert_same_choices(jb, tb, PROMPT_SETS["three"], rtol)
    alone = [assert_same_choices(jb, tb, [p], rtol)[0] for p in PROMPT_SETS["three"]]
    assert alone == together
    assert sorted(tb.stats.by_bucket) == [(1, 64), (1, 128), (1, 256), (2, 128)]
    assert tb.stats.by_bucket == jb.stats.by_bucket


def test_left_cut_keeps_bos_and_the_forced_prefix(carried):
    kw, rtol = ARMS["int8_cache"]
    jb, tb = engines(carried, kw)
    _, port_groups = recording(jb, tb)
    tb.score_choices([PAST], CHOICES)
    (tokens, pads, S, _), = port_groups
    ids = tb.tok.encode(PAST, add_bos=True)
    assert len(ids) > MAX_SEQ_LEN and S == MAX_SEQ_LEN and pads.tolist() == [0]
    assert tokens[0].tolist() == [ids[0]] + ids[-(MAX_SEQ_LEN - 1):]
    assert ids[0] == tb.tok.bos_id
    assert tb.tok.decode(tokens[0].tolist()).endswith(PREFIX)
    assert tb.stats.prompt_tokens == MAX_SEQ_LEN


@pytest.mark.parametrize("choices", [["1", "1"], ["ok", ""]], ids=["same_first_id", "empty"])
def test_bad_choices_raise_as_in_jax(carried, choices):
    jb, tb = engines(carried, ARMS["dense"][0])
    with pytest.raises(ValueError) as want:
        jb.score_choices(["x"], choices)
    with pytest.raises(ValueError) as got:
        tb.score_choices(["x"], choices)
    assert str(got.value) == str(want.value)
    assert tb.stats.calls == jb.stats.calls == 0
