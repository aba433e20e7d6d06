"""The card check's checks phase (``chip_smoke.py`` phase 9f) on the CPU:
its gates fed passing and failing inputs, its fault arm run whole on the
trained fixture, its span and firing expectations held to the JAX
package's.

- (a) the planted guard fault: ``planted_sync`` passes only when the
  planted sync raises inside the guard and not inside an acknowledged
  section, and fails that arm alone otherwise; ``check_guard_log`` and
  ``guarded`` fail a guard that never armed or left the mode set.
  CUDA's sync debug mode is a recorder here, and the planted sync raises
  as CUDA's would while the recorder reads "error";
- (b) ``checks_faults`` on the CPU: every plan of ``CHECKS_PLANS`` fires
  exactly its expected list on the fixture too;
- (c) ``checks_lint`` exits 0;
- (d) ``RUNNER_SPANS`` is what both runners record on the pipeline phase's
  run shape (mapreduce over data/vi_eval, 7 documents), ``check_tracing``
  and ``check_step_wall`` fail what they must.
"""
from __future__ import annotations

import contextlib
import functools
import importlib.util
from pathlib import Path

import pytest
import torch

from vnsum_tpu_torch.analysis import sanitizers

from test_torch_models_llama import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CUDA = torch.device("cuda")  # a device object only
SYNC_ERROR = "called a synchronizing CUDA operation"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


@pytest.fixture
def mode(monkeypatch):
    """CUDA's sync debug mode as a recorder; ``state["mode"]`` 2 = error."""
    state = {"mode": 0}
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda m: state.update(
        mode={"default": 0, "warn": 1, "error": 2}.get(m, m)))
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: state["mode"])
    monkeypatch.delenv("VNSUM_SANITIZERS", raising=False)
    yield state
    assert sanitizers._guards == 0 and sanitizers._reads == 0


def cuda_like_sync(state):
    """A sync as CUDA runs it under the sync debug mode: raises at error."""
    def planted():
        if state["mode"] == 2:
            raise RuntimeError(SYNC_ERROR)
    return planted


# -- (a) the planted guard fault -----------------------------------------------


def test_planted_sync_passes_when_the_guard_is_live(mode):
    msg = CS.planted_sync(torch, sanitizers, CUDA, cuda_like_sync(mode))
    assert msg == SYNC_ERROR and mode["mode"] == 0


@pytest.mark.parametrize("broken,match", [
    ("never raises", "did not raise"),
    ("raises when acknowledged", "inside acknowledged"),
    ("raises something else", "not as a sync"),
    ("guard on the CPU", "did not raise"),
])
def test_planted_sync_fails_only_its_arm(mode, broken, match):
    planted, dev = cuda_like_sync(mode), CUDA
    if broken == "never raises":
        planted = lambda: None  # noqa: E731
    elif broken == "raises when acknowledged":
        def planted():
            raise RuntimeError(SYNC_ERROR)
    elif broken == "raises something else":
        def planted():
            if mode["mode"] == 2:
                raise RuntimeError("an unrelated error")
    else:
        dev = torch.device("cpu")  # the guard does not arm: nothing raises
    with pytest.raises(AssertionError, match=match):
        CS.planted_sync(torch, sanitizers, dev, planted)
    # the mode is restored whichever way the arm failed, so the next arm's
    # calls run as they would have
    assert mode["mode"] == 0


def test_check_guard_log_gates():
    CS.check_guard_log("x", [2, "error", 0, "error", 0], 0)
    with pytest.raises(AssertionError, match="never armed"):
        CS.check_guard_log("x", [], 0)
    with pytest.raises(AssertionError, match="not 0"):
        CS.check_guard_log("x", ["error"], 2)


def test_guarded_runs_under_the_sanitizer_and_checks_the_guard(mode):
    seen = []

    def call():
        seen.append(sanitizers.transfer_sanitizer_enabled())
        with sanitizers.hot_path_transfer_guard(CUDA):
            return sanitizers.device_get(torch.arange(3)).tolist()

    out, wall = CS.guarded(torch, "call", call)
    assert out == [0, 1, 2] and wall >= 0 and seen == [True]
    with pytest.raises(AssertionError, match="never armed"):
        CS.guarded(torch, "unguarded call", lambda: None)


def test_sanitizers_env_restores():
    import os

    os.environ.pop("VNSUM_SANITIZERS", None)
    with CS.sanitizers_env("transfer"):
        assert os.environ["VNSUM_SANITIZERS"] == "transfer"
    assert "VNSUM_SANITIZERS" not in os.environ
    os.environ["VNSUM_SANITIZERS"] = "lock"
    try:
        with contextlib.suppress(ValueError), CS.sanitizers_env("transfer"):
            raise ValueError
        assert os.environ["VNSUM_SANITIZERS"] == "lock"
    finally:
        os.environ.pop("VNSUM_SANITIZERS", None)


# -- (b) the fault arm, whole, on the CPU ----------------------------------------


def test_fault_prompts_carry_a_space_free_tag():
    docs = ["một hai ba " * 200] * 7
    prompts = CS.fault_prompts(docs)
    for i, p in enumerate(prompts):
        tag = CS.CHECKS_FAULT_TAG.format(i).strip()
        assert tag in p and " " not in tag
        assert sum(CS.CHECKS_FAULT_TAG.format(j).strip() in p for j in range(7)) == 1


def test_checks_faults_runs_whole_on_the_fixture():
    """Arm (b) on the CPU (dense attention: the kernels run on the card):
    every plan's firings, classes, rung and answers as CHECKS_PLANS says."""
    launches = CS.checks_faults(torch, device="cpu")
    assert set(launches) == set(CS.COUNTERS)


# -- (c) the lint ------------------------------------------------------------------


def test_checks_lint_exits_zero():
    assert CS.checks_lint().startswith("exit 0, ok: no findings")


# -- (d) the runner's spans and the captured step's wall -----------------------


@pytest.fixture
def tiny_default_encoders(monkeypatch):
    import vnsum_tpu.eval as jax_eval
    import vnsum_tpu.models.encoder as je
    import vnsum_tpu_torch.models.encoder as te
    import vnsum_tpu_torch.pipeline.runner as port_runner
    from vnsum_tpu_torch.eval import EmbeddingModel

    monkeypatch.setattr(jax_eval, "EmbeddingModel", functools.partial(
        jax_eval.EmbeddingModel, config=je.tiny_encoder(), max_len=64))
    monkeypatch.setattr(port_runner, "EmbeddingModel", functools.partial(
        EmbeddingModel, config=te.tiny_encoder(), max_len=64, device="cpu"))


def test_runner_spans_are_both_runners_on_the_pipeline_phase_shape(tmp_path,
                                                                   tiny_default_encoders):
    """mapreduce over data/vi_eval's 7 documents with the default encoder
    built by the runner (as the CLI does): RUNNER_SPANS on both runners."""
    from vnsum_tpu.core.config import PipelineConfig as JaxPipelineConfig
    from vnsum_tpu.pipeline.runner import PipelineRunner as JaxRunner
    from vnsum_tpu_torch.core.config import PipelineConfig
    from vnsum_tpu_torch.pipeline.runner import PipelineRunner

    def config(cls, side):
        return cls(approach="mapreduce", models=["fake"], backend="fake",
                   docs_dir=str(ROOT / "data/vi_eval/doc"),
                   summary_dir=str(ROOT / "data/vi_eval/summary"),
                   generated_summaries_dir=str(tmp_path / side / "gen"),
                   results_dir=str(tmp_path / side / "results"),
                   logs_dir=str(tmp_path / side / "logs"))

    jax = JaxRunner(config(JaxPipelineConfig, "jax")).run().tracing
    port = PipelineRunner(config(PipelineConfig, "port"), device="cpu").run().tracing
    for tracing in (jax, port):
        CS.check_tracing("runner", tracing)


def test_check_tracing_fails_a_missing_or_miscounted_span():
    good = {"spans": {k: {"count": v, "total_s": 0.5} for k, v in CS.RUNNER_SPANS.items()}}
    CS.check_tracing("x", good)
    missing = {"spans": {k: v for k, v in good["spans"].items() if k != "summarize/batch"}}
    extra = {"spans": {**good["spans"], "decode": {"count": 1, "total_s": 0.1}}}
    recount = {"spans": {**good["spans"], "evaluate/rouge": {"count": 6, "total_s": 0.1}}}
    for bad in (missing, extra, recount, {}):
        with pytest.raises(AssertionError, match="results.tracing"):
            CS.check_tracing("x", bad)


def test_check_step_wall():
    lo, hi = CS.CAPTURED_STEP_MS
    for wall in (lo, hi, hi * CS.CAPTURED_STEP_MARGIN - 1e-6, lo * 0.9):
        CS.check_step_wall(wall)
    with pytest.raises(AssertionError, match="captured decode step"):
        CS.check_step_wall(hi * CS.CAPTURED_STEP_MARGIN + 1e-3)
