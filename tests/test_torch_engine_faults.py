"""The engine's fault sites (``engine.dispatch``, ``engine.slot_admit``,
``engine.slot_step``) on the port's TorchBackend and TorchSlotLoop against
the JAX package's TpuBackend and TpuSlotLoop, on carried tiny weights.

The same VNSUM_FAULTS plans (``chip_smoke.CHECKS_PLANS``, the card check's
arm (b)) armed over each engine behind its own package's supervised
schedulers (``chip_smoke.fault_outcomes``: MicroBatchScheduler or
InflightScheduler, every prompt submitted at once) give the same firing
schedule, the same failure classes, rung and quarantine, and the same
status and bytes per request; each schedule is the one the card check
expects, and every answer but the poisoned one equals the unfaulted run's.
Then the sites themselves: after the argument checks, with the JAX
engine's ``prompts=`` payloads, and an idle step fires nothing. The JAX
engine runs its kernels in interpret mode; tiny_llama at max_seq_len 128
and 24 new tokens keeps every cache within one 128-slot block.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

from vnsum_tpu import serve as jax_serve
from vnsum_tpu.backend.engine import TpuBackend
from vnsum_tpu.testing import faults as jax_faults
from vnsum_tpu_torch import serve as port_serve
from vnsum_tpu_torch.backend.engine import TorchBackend
from vnsum_tpu_torch.testing import faults as port_faults

from test_torch_models_llama import carried_weights, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
BODIES = ["văn bản một về kinh tế", "hai và ba", "một tài liệu về xã hội",
          "bốn bốn", "năm năm năm", "sáu và bảy", "bảy tám chín"]
PROMPTS = [CS.CHECKS_FAULT_TAG.format(i) + b for i, b in enumerate(BODIES)]
KW = dict(batch_size=8, max_new_tokens=24, seed=1, segment_tokens=4)


@pytest.fixture(scope="module")
def carried():
    return carried_weights(max_seq_len=128)


@pytest.fixture(scope="module")
def sides(carried):
    """{"jax": (serve, faults, backend), "port": (...)} on one weight set."""
    jcfg, params, model = carried
    return {
        "jax": (jax_serve, jax_faults,
                TpuBackend(model_config=jcfg, params=params, flash=True, interpret=True, **KW)),
        "port": (port_serve, port_faults,
                 TorchBackend(model=model, flash=True, device="cpu", **KW)),
    }


@pytest.fixture(scope="module")
def base(sides):
    out = {side: b.generate(PROMPTS) for side, (_s, _f, b) in sides.items()}
    assert out["port"] == out["jax"] and any(out["port"])
    return out["port"]


def test_the_plans_are_the_card_checks():
    assert [p[0] for p in CS.CHECKS_PLANS] == [
        "dispatch raise", "slot step resource", "dispatch poison", "slot admit raise"]
    assert CS.CHECKS_FAULT_TAG.format(CS.CHECKS_POISON).strip() in CS.CHECKS_PLANS[2][2]


@pytest.mark.parametrize("plan", CS.CHECKS_PLANS, ids=[p[0] for p in CS.CHECKS_PLANS])
def test_plan_matches_jax_through_both_schedulers(sides, base, plan):
    name, kind, text, fired, failures, rung = plan
    got = {side: CS.fault_outcomes(s, f, b, PROMPTS, kind, text)
           for side, (s, f, b) in sides.items()}
    port, jax = got["port"], got["jax"]
    for key in ("fired", "outcomes", "failures", "rung", "quarantined", "bisects"):
        assert port[key] == jax[key], key
    if kind == "batch":
        # the one-shot path takes every prompt in one dispatch: retries are
        # deterministic there (the slot loop's depend on the admit cadence)
        assert port["retries"] == jax["retries"]
    poison = CS.CHECKS_POISON if "poison" in text else None
    # the card check's gate, on both engines' outcomes
    for side in ("port", "jax"):
        CS.check_plan(name, got[side], fired, failures, rung, base, poison)


def test_check_plan_fails_on_a_changed_schedule_or_answer(base):
    name, kind, text, fired, failures, rung = CS.CHECKS_PLANS[0]
    good = {"fired": list(fired), "outcomes": [("ok", t) for t in base],
            "failures": dict(failures), "rung": rung, "quarantined": 0}
    CS.check_plan(name, good, fired, failures, rung, base, None)
    bad = [
        {**good, "fired": list(fired) * 2},
        {**good, "failures": {"resource_exhausted": 1}},
        {**good, "rung": 1},
        {**good, "outcomes": [("ok", t) for t in base[:-1]] + [("ok", base[-1] + "x")]},
        {**good, "outcomes": [("failed", "poison")] + good["outcomes"][1:]},
    ]
    for b in bad:
        with pytest.raises(AssertionError, match="checks \\(b\\)"):
            CS.check_plan(name, b, fired, failures, rung, base, None)


def test_env_plans_parse_alike():
    for _n, _k, text, *_ in CS.CHECKS_PLANS:
        j, p = jax_faults.parse_plan(text), port_faults.parse_plan(text)
        assert [(s.site, s.kind, s.on_call, s.match) for s in p.specs] == [
            (s.site, s.kind, s.on_call, s.match) for s in j.specs]


def test_generate_fires_after_the_argument_checks(sides):
    for side, (_s, faults, b) in sides.items():
        plan = faults.parse_plan("engine.dispatch:raise@on_call=2")
        with faults.injected(plan):
            with pytest.raises(ValueError):
                b.generate(PROMPTS[:1], references=[None, None])  # misaligned: no call
            assert plan.calls("engine.dispatch") == 0
            assert b.generate([]) == []                          # nothing to do: no call
            assert plan.calls("engine.dispatch") == 0
            b.generate(PROMPTS[:1])
            with pytest.raises(RuntimeError, match="engine.dispatch"):
                b.generate(PROMPTS[:1])
        assert plan.fired == [("engine.dispatch", "raise", 2)], side


def test_slot_sites_fire_with_the_prompts_payload(sides):
    """admit fires with every offered prompt, step with the live ones; a
    poison match on one prompt fires exactly where it is offered or live,
    and an idle step fires nothing — on both loops."""
    fired = {}
    for side, (_s, faults, b) in sides.items():
        plan = faults.parse_plan(
            f"engine.slot_admit:poison@match={CS.CHECKS_FAULT_TAG.format(1).strip()} "
            f"engine.slot_step:poison@match={CS.CHECKS_FAULT_TAG.format(0).strip()}")
        loop = b.start_slot_loop(4)
        try:
            with faults.injected(plan):
                loop.step()  # idle: no live row, no call
                assert plan.calls("engine.slot_step") == 0
                loop.admit([(0, PROMPTS[0], None)])
                with pytest.raises(RuntimeError, match="poison"):
                    loop.admit([(1, PROMPTS[1], None), (2, PROMPTS[2], None)])
                with pytest.raises(RuntimeError, match="poison"):
                    loop.step()
        finally:
            loop.close()
        fired[side] = plan.fired
    assert fired["port"] == fired["jax"] == [
        ("engine.slot_admit", "poison", 2), ("engine.slot_step", "poison", 1)]
