"""The pipeline's mesh and whole-document launch: ``PipelineConfig``'s
``mesh_shape``, ``allow_cpu_mesh``, ``long_context`` and
``long_context_quantize_kv`` with their checks, the CLI's ``--mesh``,
``--allow-cpu-mesh``, ``--long-context`` and ``--quantize-kv-long``, and
the runner's mesh and long branches with their rank-0 I/O, against the JAX
package's (``vnsum_tpu/core/config.py``, ``vnsum_tpu/pipeline/``).

The CLI runs in one spawn of four CPU processes joined over gloo
(``file://`` rendezvous, one torch thread each, each joined with a 120 s
limit, as ``tests/test_torch_engine_sharded.py`` does). Every rank calls
``vnsum_tpu_torch.pipeline.cli.main`` with the same argv, as torchrun
would start them: ``--long-context --mesh data=2,seq=2`` twice (fresh
directories, then directories holding one summary already) and ``--mesh
data=2,model=2`` without ``--long-context``. The registry's ``tiny`` model
resolves to carried weights and the evaluation to a carried tiny encoder,
both inside the ranks (``torch_model_args`` and ``EmbeddingModel``
patched), so the JAX runner, its ``_resolve_model`` patched alike, runs the
same weights on a CPU mesh of the same shape. Summaries must be
byte-identical and ROUGE equal. Rank 1's writes are watched through an
audit hook (``open`` for writing, ``os.mkdir``, ``os.rename``,
``os.remove``) while it runs the CLI, and must be none under the run's
directories. The module imports no JAX at the top: the spawned ranks
import it to find their entry point.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

FIXTURE = Path(__file__).resolve().parent.parent / "data" / "vi_eval"
DOC_NAMES = sorted(p.name for p in (FIXTURE / "doc").glob("*.txt"))
WORLD = 4
JOIN_S = 120
PRIOR = DOC_NAMES[0]  # the summary the "resume" run finds already written
PRIOR_TEXT = "tóm tắt có sẵn"
# the CLI runs of the spawn: the mesh, --long-context or not, the knobs
RUNS = {
    "long": ("data=2,seq=2", True, dict(max_context=1024, max_new_tokens=16, batch_size=8)),
    "resume": ("data=2,seq=2", True, dict(max_context=1024, max_new_tokens=16, batch_size=8)),
    "oneshot": ("data=2,model=2", False, dict(max_context=512, max_new_tokens=16,
                                             batch_size=8)),
}


def dirs(root: Path) -> dict:
    return dict(docs_dir=str(FIXTURE / "doc"), summary_dir=str(FIXTURE / "summary"),
                generated_summaries_dir=str(root / "gen"), results_dir=str(root / "results"),
                logs_dir=str(root / "logs"))


def argv_of(run: str, root: Path) -> list:
    mesh, long_context, knobs = RUNS[run]
    argv = ["--approach", "truncated", "--models", "tiny", "--device", "cpu", "--mesh", mesh]
    if long_context:
        argv.append("--long-context")
    for k, v in {**knobs, **dirs(root)}.items():
        argv += ["--" + k.replace("_", "-"), str(v)]
    return argv


# batch outcomes put to the ranks' agreement: (each rank's error, or None;
# the decision every rank must get: failed, retryable)
AGREE = {
    "all_ok": ([None] * WORLD, (False, False)),
    "one_transient": ([None, ConnectionError("reset"), None, None], (True, True)),
    "transient_and_device": ([TimeoutError("slow"), None, RuntimeError("device fault"), None],
                             (True, False)),
    "all_device": ([RuntimeError("device fault")] * WORLD, (True, False)),
}


# -- the ranks ------------------------------------------------------------------


def _rank_main(rank: int, init_file: str, root: str, payload: dict) -> None:
    """One rank: join the group, patch the model and the encoder, run the
    CLI once for each of RUNS with the audit hook on, save each run's exit
    code, its runner's summarization and engine records and the writes
    seen (a failure is saved as its traceback), leave."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from vnsum_tpu_torch.eval import EmbeddingModel
    from vnsum_tpu_torch.models import encoder as te
    from vnsum_tpu_torch.models import llama as tl
    from vnsum_tpu_torch.parallel import init_distributed
    from vnsum_tpu_torch.pipeline import cli
    from vnsum_tpu_torch.pipeline import runner as pr
    from vnsum_tpu_torch.testing.writes import WriteWatch

    init_distributed(f"file://{init_file}", WORLD, rank, device="cpu", timeout_s=30)
    watch = WriteWatch(root)
    try:
        pr.torch_model_args = lambda model, weights_dir, tokenizer, dtype, device: {
            "model": tl.params_from_numpy(payload["tree"], payload["cfg"], device=device),
            "tokenizer": "byte"}
        pr.EmbeddingModel = lambda **kw: EmbeddingModel(
            config=te.tiny_encoder(), max_len=64, batch_size=4, device="cpu",
            params=te.encoder_params_from_numpy(payload["encoder"], te.tiny_encoder(),
                                                device="cpu"))
        runners = []
        run = pr.PipelineRunner.run

        def spy(self):
            runners.append(self)
            return run(self)

        pr.PipelineRunner.run = spy
        out = {}
        for name in RUNS:
            watch.on, watch.seen = True, []
            try:
                rc = cli.main(argv_of(name, Path(root) / name))
                r = runners[-1]
                out[name] = {"rc": rc, "failures": r.failures, "primary": r.primary,
                             "mesh": dict(r.mesh.shape), "coords": dict(r.mesh.coords),
                             "summarization": dict(r.results.summarization),
                             "engine": dict(r.results.engine), "log": r.log_path}
            except Exception:
                out[name] = {"error": traceback.format_exc()}
            watch.on = False
            out[name]["writes"] = list(watch.seen)
        out["agree"] = {case: runners[-1]._agree(errors[rank])
                        for case, (errors, _) in AGREE.items()}
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# -- the parent -------------------------------------------------------------------


@pytest.fixture(scope="module")
def carried():
    """(jax cfg, jax params, port config, numpy tree, JAX embedder, the
    embedder's numpy tree)."""
    import jax

    from test_torch_eval_embedding import carried_embedders
    from test_torch_models_llama import carried_weights

    jcfg, params, model = carried_weights(4, max_seq_len=2048)
    jax_embedder, _ = carried_embedders()
    return (jcfg, params, model.cfg, jax.tree.map(np.asarray, params), jax_embedder,
            jax.tree.map(np.asarray, jax_embedder.params))


@pytest.fixture(scope="module")
def ranks(carried, tmp_path_factory) -> tuple:
    """(every rank's saved runs, the spawn's root)."""
    _, _, cfg, tree, _, encoder = carried
    root = tmp_path_factory.mktemp("pipeline_mesh")
    prior = root / "resume" / "gen_truncated_tiny"
    prior.mkdir(parents=True)
    (prior / PRIOR).write_text(PRIOR_TEXT, encoding="utf-8")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        r, str(root / "rendezvous"), str(root),
        {"cfg": cfg, "tree": tree, "encoder": encoder})) for r in range(WORLD)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(JOIN_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} did not finish within {JOIN_S} s"
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert [p.exitcode for p in procs] == [0] * WORLD
    saved = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    for r, res in enumerate(saved):
        for name in RUNS:
            got = res[name]
            if "error" in got:
                pytest.fail(f"rank {r} run {name}:\n{got['error']}")
    return saved, root


def jax_run(carried, run: str, root: Path):
    """The JAX runner on the same config, weights and encoder; returns its
    results."""
    from vnsum_tpu.core import PipelineConfig as JaxPipelineConfig
    from vnsum_tpu.pipeline.runner import PipelineRunner as JaxPipelineRunner

    jcfg, params, *_ = carried
    mesh, long_context, knobs = RUNS[run]
    shape = {k: int(v) for k, v in (p.split("=") for p in mesh.split(","))}
    cfg = JaxPipelineConfig(approach="truncated", models=["tiny"], mesh_shape=shape,
                            long_context=long_context, **knobs, **dirs(root))
    runner = JaxPipelineRunner(cfg, embedding_model=carried[4])
    runner._resolve_model = lambda model: (jcfg, params, "byte")
    return runner.run()


@pytest.fixture(scope="module")
def jax_runs(carried, tmp_path_factory) -> dict:
    root = tmp_path_factory.mktemp("jax_pipeline_mesh")
    return {run: (jax_run(carried, run, root / run), root / run) for run in ("long", "oneshot")}


def saved_results(root: Path) -> dict:
    """The one pipeline results JSON under ``root``'s results dir."""
    paths = sorted((root / "results").glob("pipeline_results_*.json"))
    assert len(paths) == 1, paths
    return json.loads(paths[0].read_text(encoding="utf-8"))["results"]


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("run", ["long", "oneshot"])
@pytest.mark.parametrize("name", DOC_NAMES)
def test_summaries_match_jax_mesh(run, name, ranks, jax_runs, one_thread):
    """Each document's summary, written by rank 0, byte-identical to the
    JAX runner's on a mesh of the same shape: --long-context at data=2,
    seq=2 (every document past the tiny model's 256-token one-card
    ceiling), and the one-shot engine at data=2, model=2."""
    _, root = ranks
    _, jax_root = jax_runs[run]
    got = (root / run / "gen_truncated_tiny" / name).read_bytes()
    assert got == (jax_root / "gen_truncated_tiny" / name).read_bytes()


@pytest.mark.parametrize("run", ["long", "oneshot"])
def test_rouge_and_records_match_jax(run, ranks, jax_runs, one_thread):
    from test_torch_eval_embedding import assert_embedding_stats_close

    saved, root = ranks
    want, _ = jax_runs[run]
    got = saved_results(root / run)
    assert got["evaluation"]["tiny"]["rouge_scores"] == want.evaluation["tiny"]["rouge_scores"]
    assert_embedding_stats_close(got["evaluation"]["tiny"], want.evaluation["tiny"])
    rec = got["summarization"]["tiny"]
    assert rec["successful"] == len(DOC_NAMES) and rec["failed"] == 0
    assert rec["total_chunks"] == want.summarization["tiny"]["total_chunks"]
    # every summary is not empty on random weights: the comparison means something
    gen = root / run / "gen_truncated_tiny"
    assert any((gen / n).read_text(encoding="utf-8") for n in DOC_NAMES)
    for res in saved:
        assert res[run]["rc"] == 0 and res[run]["failures"] == []
        assert res[run]["summarization"]["tiny"]["successful"] == len(DOC_NAMES)


@pytest.mark.parametrize("run", list(RUNS))
def test_only_rank_zero_writes(run, ranks):
    """Rank 0 wrote the summaries, one results JSON, the evaluation's file
    and one log file; the other ranks wrote nothing under the run's
    directories and opened no log file."""
    saved, root = ranks
    for r, res in enumerate(saved):
        assert res[run]["primary"] == (r == 0)
        if r:
            assert res[run]["writes"] == [], f"rank {r} wrote {res[run]['writes']}"
            assert res[run]["log"] is None
    written = {p.relative_to(root / run).as_posix() for p in (root / run).rglob("*")
               if p.is_file()}
    logs = [p for p in written if p.startswith("logs/")]
    assert len(logs) == 1 and saved[0][run]["log"] is not None
    assert {p for p in written if p.startswith("gen_")} == {
        f"gen_truncated_tiny/{n}" for n in DOC_NAMES}
    assert len([p for p in written if p.startswith("results/pipeline_results_")]) == 1
    assert "results/tiny_results.json" in written
    assert {w[0] for w in saved[0][run]["writes"]} >= {"open"}


def test_an_existing_summary_is_skipped_on_every_rank(ranks, one_thread):
    """The resume run finds PRIOR written: rank 0's scan skips it and
    every rank runs the other six, the same list; PRIOR is left as it was,
    and the other summaries equal the fresh run's."""
    saved, root = ranks
    for res in saved:
        rec = res["resume"]["summarization"]["tiny"]
        assert rec["total_documents"] == rec["successful"] == len(DOC_NAMES) - 1
        assert PRIOR not in [d["filename"] for d in rec["processing_details"]]
        assert res["resume"]["engine"]["tiny"]["prompts"] == len(DOC_NAMES) - 1
    gen = root / "resume" / "gen_truncated_tiny"
    assert (gen / PRIOR).read_text(encoding="utf-8") == PRIOR_TEXT
    for name in DOC_NAMES[1:]:
        assert (gen / name).read_bytes() == (root / "long" / "gen_truncated_tiny" / name) \
            .read_bytes()


def test_ranks_sit_on_the_mesh(ranks):
    saved, _ = ranks
    for run, (mesh, *_) in RUNS.items():
        shape = {k: int(v) for k, v in (p.split("=") for p in mesh.split(","))}
        coords = [res[run]["coords"] for res in saved]
        for res in saved:
            assert {k: v for k, v in res[run]["mesh"].items() if v > 1} == shape
        assert len({tuple(sorted(c.items())) for c in coords}) == WORLD


# -- the config and the CLI (no process group) ----------------------------------

# configs both packages must refuse alike: (kwargs, the port's backend name
# for JAX's "tpu")
REFUSED = {
    "quantize_kv_long_alone": dict(long_context_quantize_kv=True),
    "quantize_act_long": dict(long_context=True, quantize=True, quantize_act=True,
                              mesh_shape={"seq": 2}),
    "long_fake_backend": dict(long_context=True, backend="fake", mesh_shape={"seq": 4}),
    "long_ollama_backend": dict(long_context=True, backend="ollama", mesh_shape={"seq": 2}),
    "long_no_mesh": dict(long_context=True),
    "long_data_mesh": dict(long_context=True, mesh_shape={"data": 2}),
    "long_seq_one": dict(long_context=True, mesh_shape={"data": 2, "seq": 1}),
}


def jax_kwargs(kw: dict) -> dict:
    return {**kw, "backend": kw.get("backend", "tpu")}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_config_checks_raise_as_in_jax(case):
    """Each check of the four fields raises JAX's message, with 'torch'
    where JAX says 'tpu'."""
    from vnsum_tpu.core.config import PipelineConfig as JaxPipelineConfig
    from vnsum_tpu_torch.core.config import PipelineConfig

    kw = REFUSED[case]
    with pytest.raises(ValueError) as got:
        PipelineConfig(**kw)
    with pytest.raises(ValueError) as want:
        JaxPipelineConfig(**jax_kwargs(kw))
    assert str(got.value) == str(want.value).replace("'tpu'", "'torch'")


@pytest.mark.parametrize("kw", [
    dict(long_context=True, mesh_shape={"seq": 2}),
    dict(long_context=True, long_context_quantize_kv=True, quantize=True,
         mesh_shape={"data": 2, "seq": 4}),
    dict(mesh_shape={"data": 2, "model": 4}, allow_cpu_mesh=True),
], ids=["long", "long_int8", "mesh"])
def test_valid_configs_pass_and_keep_the_fields(kw):
    from vnsum_tpu.core.config import PipelineConfig as JaxPipelineConfig
    from vnsum_tpu_torch.core.config import PipelineConfig

    got, want = PipelineConfig(**kw).to_dict(), JaxPipelineConfig(**jax_kwargs(kw)).to_dict()
    for k in ("mesh_shape", "allow_cpu_mesh", "long_context", "long_context_quantize_kv"):
        assert got[k] == want[k]


@pytest.mark.parametrize("flags", [
    ["--quantize-kv-long"],
    ["--long-context"],
    ["--long-context", "--mesh", "data=2"],
    ["--long-context", "--backend", "fake", "--mesh", "seq=2"],
    ["--long-context", "--quantize", "--quantize-act", "--mesh", "seq=2"],
], ids=["kv_long_alone", "no_mesh", "no_seq", "fake", "w8a8"])
def test_both_clis_refuse_alike(flags):
    from vnsum_tpu.pipeline import cli as jax_cli
    from vnsum_tpu_torch.pipeline import cli

    argv = ["--approach", "truncated", "--models", "tiny", *flags]
    with pytest.raises(ValueError) as got:
        cli.config_from_args(cli.build_parser().parse_args(argv))
    with pytest.raises(ValueError) as want:
        jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    assert str(got.value) == str(want.value).replace("'tpu'", "'torch'")


@pytest.mark.parametrize("allow_cpu_mesh", [False, True])
@pytest.mark.parametrize("long_context", [False, True])
def test_a_cuda_mesh_without_a_card_raises(allow_cpu_mesh, long_context, tmp_path):
    """Asked for the card with a mesh and no card visible, the runner
    raises naming --device cpu, whatever allow_cpu_mesh says: it never
    carries on on the CPU. Through the CLI as through the runner."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    from vnsum_tpu_torch.core.config import PipelineConfig
    from vnsum_tpu_torch.pipeline import cli
    from vnsum_tpu_torch.pipeline.runner import PipelineRunner

    cfg = PipelineConfig(approach="truncated", models=["tiny"], mesh_shape={"seq": 2},
                         allow_cpu_mesh=allow_cpu_mesh, long_context=long_context,
                         **dirs(tmp_path))
    with pytest.raises(RuntimeError, match="--device cpu") as e:
        PipelineRunner(cfg, device="cuda")
    assert "allow_cpu_mesh" in str(e.value)
    argv = ["--approach", "truncated", "--models", "tiny", "--mesh", "seq=2"]
    argv += ["--allow-cpu-mesh"] * allow_cpu_mesh + ["--long-context"] * long_context
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(argv + ["--logs-dir", str(tmp_path / "logs")])
    assert not (tmp_path / "logs").exists()


def test_a_mesh_that_does_not_cover_the_ranks_raises(tmp_path):
    """One process (no process group) asked for a 2-rank mesh on the CPU:
    make_mesh's error, before any file is written."""
    from vnsum_tpu_torch.core.config import PipelineConfig
    from vnsum_tpu_torch.pipeline.runner import PipelineRunner

    cfg = PipelineConfig(approach="truncated", models=["tiny"], mesh_shape={"data": 2},
                         **dirs(tmp_path))
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        PipelineRunner(cfg, device="cpu")
    assert not (tmp_path / "logs").exists()


def test_a_one_rank_mesh_runs_in_one_process(tmp_path, monkeypatch):
    """--mesh data=1 needs no process group: the runner builds a 1x1 mesh
    and is rank 0, and the run writes as an unmeshed one does."""
    from vnsum_tpu_torch.pipeline import cli

    from test_torch_eval_embedding import small_default_encoder

    small_default_encoder(monkeypatch)
    argv = ["--approach", "truncated", "--models", "tiny", "--device", "cpu", "--mesh",
            "data=1", "--max-context", "200", "--max-new-tokens", "8", "--max-samples", "2"]
    for k, v in dirs(tmp_path).items():
        argv += ["--" + k.replace("_", "-"), v]
    assert cli.main(argv) == 0
    saved = saved_results(tmp_path)
    assert saved["summarization"]["tiny"]["successful"] == 2
    assert len(list((tmp_path / "gen_truncated_tiny").glob("*.txt"))) == 2


@pytest.mark.parametrize("case", sorted(AGREE))
def test_batch_outcomes_are_agreed_by_every_rank(case, ranks):
    """Each rank's runner put its own outcome of one batch (AGREE: a
    rank's error or none) to the all-reduce; every rank got the same
    decision: failed where any rank failed, retried only where every
    failing rank's error is retryable (a device RuntimeError is not)."""
    saved, _ = ranks
    errors, want = AGREE[case]
    for r, res in enumerate(saved):
        assert res["agree"][case] == want, (r, errors)
