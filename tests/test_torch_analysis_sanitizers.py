"""The port's transfer guard (``vnsum_tpu_torch/analysis/sanitizers.py``)
against the JAX package's (``vnsum_tpu/analysis/sanitizers.py``).

On the CPU there is no card to sync with, so the guard is a nullcontext
for CPU engines, as the JAX guard cannot fire on CPU JAX. These tests hold:

- the guard's selection (off, CPU, CUDA) and its bookkeeping of CUDA's
  process-wide sync debug mode, with ``torch.cuda``'s getter and setter
  replaced by a recorder: the first guard saves the mode and the last
  restores it, on exceptions too, nested and across threads; an
  acknowledged read (``device_get``, ``device_sync``) switches the check
  off for its own span only;
- ``device_get`` / ``to_device`` against the reads and uploads they stand
  for;
- greedy ``generate``, the spec path, the slot loop and ``score_choices``
  on carried tiny weights under ``VNSUM_SANITIZERS=transfer``: the port's
  texts and picks byte-identical to the JAX engine's under its guard and
  to the port's own unguarded run, with the guard armed as on a card (the
  recorder standing in for the mode) and every kernel launched while the
  check is on.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import pytest
import torch

from vnsum_tpu.backend.engine import TpuBackend
from vnsum_tpu.core.config import GenerationConfig as JaxGenerationConfig
from vnsum_tpu_torch.analysis import sanitizers
from vnsum_tpu_torch.backend import engine as engine_mod
from vnsum_tpu_torch.backend import inflight as inflight_mod
from vnsum_tpu_torch.backend.engine import TorchBackend
from vnsum_tpu_torch.core.config import GenerationConfig

from test_torch_models_llama import carried_weights, one_torch_thread  # noqa: F401

MODES = {"default": 0, "warn": 1, "error": 2}


@pytest.fixture
def recorder(monkeypatch):
    """torch.cuda's sync debug getter and setter replaced: ``state["mode"]``
    is the mode, ``state["log"]`` every value set."""
    state = {"mode": 0, "log": []}

    def set_mode(m):
        state["mode"] = MODES.get(m, m)
        state["log"].append(state["mode"])

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: state["mode"])
    yield state
    assert sanitizers._guards == 0 and sanitizers._reads == 0


CUDA = torch.device("cuda")  # a device object only: nothing touches a card


# -- selection -----------------------------------------------------------------


def test_transfer_guard_context_selection(monkeypatch):
    monkeypatch.delenv("VNSUM_SANITIZERS", raising=False)
    assert not sanitizers.transfer_sanitizer_enabled()
    assert isinstance(sanitizers.hot_path_transfer_guard(CUDA), contextlib.nullcontext)
    for flag in ("transfer", "1", "all", "lock,transfer"):
        monkeypatch.setenv("VNSUM_SANITIZERS", flag)
        assert sanitizers.transfer_sanitizer_enabled()
        assert not isinstance(sanitizers.hot_path_transfer_guard(CUDA), contextlib.nullcontext)
        # the CPU has no card to sync with: nothing to arm
        for dev in (torch.device("cpu"), "cpu"):
            assert isinstance(sanitizers.hot_path_transfer_guard(dev), contextlib.nullcontext)
    monkeypatch.setenv("VNSUM_SANITIZERS", "lock")
    assert isinstance(sanitizers.hot_path_transfer_guard(CUDA), contextlib.nullcontext)


def test_disabled_guard_never_touches_the_mode(monkeypatch):
    def boom(*_a):
        raise AssertionError("the mode was touched with the sanitizer off")

    monkeypatch.delenv("VNSUM_SANITIZERS", raising=False)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", boom)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", boom)
    with sanitizers.hot_path_transfer_guard(CUDA):
        x = torch.arange(4)
        assert sanitizers.device_get(x).tolist() == [0, 1, 2, 3]
        with sanitizers.acknowledged():
            pass


# -- the mode's bookkeeping ----------------------------------------------------


@pytest.mark.parametrize("start", [0, 1])
def test_guard_sets_error_and_restores_the_mode_it_found(monkeypatch, recorder, start):
    monkeypatch.setenv("VNSUM_SANITIZERS", "transfer")
    recorder["mode"] = start
    with sanitizers.hot_path_transfer_guard(CUDA):
        assert recorder["mode"] == 2
        with sanitizers.hot_path_transfer_guard(CUDA):  # nested: still on
            assert recorder["mode"] == 2
        assert recorder["mode"] == 2
    assert recorder["mode"] == start
    assert recorder["log"] == [2, 2, 2, start]


def test_guard_restores_on_exceptions(monkeypatch, recorder):
    monkeypatch.setenv("VNSUM_SANITIZERS", "transfer")
    recorder["mode"] = 1
    with pytest.raises(ValueError):
        with sanitizers.hot_path_transfer_guard(CUDA):
            with sanitizers.acknowledged():
                raise ValueError("inside a read")
    assert recorder["mode"] == 1 and recorder["log"][-1] == 1


def test_acknowledged_read_turns_the_check_off_for_its_span(monkeypatch, recorder):
    monkeypatch.setenv("VNSUM_SANITIZERS", "transfer")
    seen = []

    class Probe:
        def cpu(self):
            seen.append(recorder["mode"])
            return self

        def numpy(self):
            return np.arange(3)

    with sanitizers.hot_path_transfer_guard(CUDA):
        got = sanitizers.device_get(Probe())
        assert recorder["mode"] == 2
        pair = sanitizers.device_get((Probe(), Probe()))
    assert seen == [0, 0, 0]
    assert got.tolist() == [0, 1, 2] and len(pair) == 2
    # outside any guard a read changes no mode at all
    n = len(recorder["log"])
    sanitizers.device_get(Probe())
    assert len(recorder["log"]) == n


def test_device_sync_is_acknowledged_and_a_noop_on_the_cpu(monkeypatch, recorder):
    monkeypatch.setenv("VNSUM_SANITIZERS", "transfer")
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: seen.append(recorder["mode"]))
    with sanitizers.hot_path_transfer_guard(CUDA):
        sanitizers.device_sync(torch.device("cpu"))
        assert seen == []
        sanitizers.device_sync(CUDA)
    assert seen == [0]


def test_the_mode_is_one_setting_across_threads(monkeypatch, recorder):
    """A guard open in one thread keeps the check on while another's closes;
    the mode comes back only when the last guard in the process closes."""
    monkeypatch.setenv("VNSUM_SANITIZERS", "transfer")
    entered, release = threading.Event(), threading.Event()

    def other():
        with sanitizers.hot_path_transfer_guard(CUDA):
            entered.set()
            release.wait(timeout=30)

    t = threading.Thread(target=other)
    t.start()
    assert entered.wait(timeout=30)
    with sanitizers.hot_path_transfer_guard(CUDA):
        pass
    assert recorder["mode"] == 2  # the other thread's guard is still open
    with sanitizers.acknowledged():
        assert recorder["mode"] == 0  # a read turns it off for every thread
    assert recorder["mode"] == 2
    release.set()
    t.join(timeout=30)
    assert recorder["mode"] == 0


def test_to_device_uploads_the_array():
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    t = sanitizers.to_device(a, torch.device("cpu"))
    assert t.dtype == torch.int32 and t.tolist() == a.tolist()


# -- the engine's paths, against the JAX engine under its guard ----------------


PROMPTS = ["văn bản một về kinh tế", "hai", "văn bản thứ ba dài hơn một chút về xã hội",
           "bốn bốn", "năm năm năm", "sáu và bảy"]
REFS = ["văn bản một về kinh tế xã hội và phát triển bền vững", None,
        "văn bản thứ ba dài hơn một chút về xã hội và đời sống", "bốn bốn bốn bốn", None,
        "sáu và bảy và tám"]
CHOICES = ["1", "2", "3", "4", "5"]
NEW = 24
KW = dict(batch_size=8, max_new_tokens=NEW, seed=1, segment_tokens=4)


@pytest.fixture(scope="module")
def carried():
    return carried_weights(max_seq_len=128)


def backends(carried, spec_k=0):
    jcfg, params, model = carried
    jb = TpuBackend(model_config=jcfg, params=params, flash=True, interpret=True,
                    generation=JaxGenerationConfig(spec_k=spec_k), **KW)
    tb = TorchBackend(model=model, flash=True, device="cpu",
                      generation=GenerationConfig(spec_k=spec_k), **KW)
    return jb, tb


def drain(loop, prompts):
    out, pending = {}, list(enumerate(prompts))
    for _ in range(64):
        if pending:
            admitted, rejected = loop.admit([(i, p, None) for i, p in pending])
            assert not rejected
            taken = {a.key for a in admitted}
            pending = [(i, p) for i, p in pending if i not in taken]
        for c in loop.step().completions:
            out[c.key] = c.text
        if not pending and loop.active == 0:
            return [out[i] for i in range(len(prompts))]
    raise AssertionError("the slot loop did not drain")


def run_paths(jb_or_tb, spec_backend):
    """(generate, spec, slot loop, score_choices) outputs of one side."""
    b = jb_or_tb
    loop = b.start_slot_loop(4)
    try:
        slot = drain(loop, PROMPTS)
    finally:
        loop.close()
    return (b.generate(PROMPTS), spec_backend.generate(PROMPTS, references=REFS), slot,
            b.score_choices(PROMPTS[:2], CHOICES))


@pytest.fixture
def armed(monkeypatch, recorder):
    """VNSUM_SANITIZERS=transfer with the port engine's guard armed as on a
    card (the recorder stands in for CUDA's mode), and the mode recorded at
    every kernel call."""
    monkeypatch.setenv("VNSUM_SANITIZERS", "transfer")
    real = sanitizers.hot_path_transfer_guard
    for mod in (engine_mod, inflight_mod):
        monkeypatch.setattr(mod, "hot_path_transfer_guard", lambda _dev: real(CUDA))
    at_launch = []
    for name in ("flash_prefill_attention", "flash_decode_attention",
                 "flash_spec_verify_attention"):
        fn = getattr(engine_mod, name)

        def wrapped(*a, _fn=fn, **kw):
            at_launch.append(recorder["mode"])
            return _fn(*a, **kw)

        monkeypatch.setattr(engine_mod, name, wrapped)
    recorder["at_launch"] = at_launch
    return recorder


def test_guarded_paths_match_jax_under_its_guard_and_the_unguarded_port(
        carried, monkeypatch, armed):
    # the unguarded port run: with the sanitizer off the guard is nothing
    monkeypatch.delenv("VNSUM_SANITIZERS", raising=False)
    _, tb = backends(carried)
    _, tb_spec = backends(carried, spec_k=4)
    plain = run_paths(tb, tb_spec)
    assert armed["log"] == []
    armed["at_launch"].clear()

    monkeypatch.setenv("VNSUM_SANITIZERS", "transfer")
    jb, tb = backends(carried)
    jb_spec, tb_spec = backends(carried, spec_k=4)
    jax_out = run_paths(jb, jb_spec)
    port_out = run_paths(tb, tb_spec)
    assert port_out == jax_out
    assert port_out == plain
    assert any(port_out[0]) and any(port_out[2])  # the carried weights emit text
    # armed the whole way, restored after, every launch under the check
    assert armed["log"][0] == 2 and armed["log"][-1] == 0 and armed["mode"] == 0
    assert armed["at_launch"] and set(armed["at_launch"]) == {2}
    assert tb_spec.take_spec_report() and tb.stats.decode_steps > 0


@pytest.mark.parametrize("path", ["generate", "spec", "score_choices", "admit", "step"])
def test_each_entry_point_opens_and_closes_the_guard(carried, armed, path):
    _, tb = backends(carried, spec_k=4 if path == "spec" else 0)
    if path == "generate":
        tb.generate(PROMPTS[:2])
    elif path == "spec":
        tb.generate(PROMPTS[:2], references=REFS[:2])
    elif path == "score_choices":
        tb.score_choices(PROMPTS[:2], CHOICES)
    else:
        loop = tb.start_slot_loop(2)
        loop.admit([(0, PROMPTS[0], None)])
        if path == "step":
            armed["log"].clear()
            loop.step()
        loop.close()
    log = armed["log"]
    assert log[0] == 2 and log[-1] == 0
    # each acknowledged read is an off-then-on pair inside the guard
    assert log.count(0) >= 1 and armed["mode"] == 0
