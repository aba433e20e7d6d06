"""The port's meshed engine (``TorchBackend(mesh=)``) against the JAX
package's (``TpuBackend(mesh=)``) and against the port's own unsharded
engine: the one-shot cases of ``tests/test_engine_sharded.py`` and the
port's own branches.

Each mesh shape, (data, model) = (2, 2), (4, 1) and (1, 2), is one spawn of
that many CPU processes joined over gloo (``file://`` rendezvous, one torch
thread each, each joined with a 120 s limit, as
``tests/test_torch_parallel_seq.py`` does). Every rank builds the carried
weights, runs every case of its mesh and saves what it got; the
parametrised tests here compare. Greedy ids must be byte-identical three
ways: across the ranks, to the JAX meshed engine on the same carried
weights (dense attention, an f32 cache, as the JAX file runs), and to the
port's unsharded engine (its kernel wrappers' plain versions, an f32 cache).
The pytest process never joins a process group. The module imports no JAX
at the top: the spawned ranks import it to find their entry point.
"""
from __future__ import annotations

import multiprocessing
import os
import traceback

import numpy as np
import pytest
import torch

HEADER = "tieu de chung cua cac tai lieu dai: " * 6  # >128 shared byte tokens
PROMPTS = [HEADER + f"noi dung rieng {i} " * 4 for i in range(6)]
SHORT = [
    "văn bản một về kinh tế",
    "hai",
    "văn bản thứ ba dài hơn một chút",
    "bốn bốn",
]
REFS = [p + " va phat trien ben vung" for p in SHORT]
HINTS = [HEADER] * len(PROMPTS)
CHOICES = ["1", "2", "3", "4", "5"]
ENGINE_KW = dict(batch_size=4, max_new_tokens=16, seed=1)
PAD = 258  # the byte tokenizer's pad id
JOIN_S = 120

# (data, model) of each spawn, and the cases its ranks run
MESHES = {
    "tp_dp": ({"data": 2, "model": 2, "seq": 1},
              ("oneshot", "churn", "spec", "choices")),
    "dp": ({"data": 4, "model": 1, "seq": 1},
           ("oneshot", "dp_resume", "spec", "indivisible")),
    "tp": ({"data": 1, "model": 2, "seq": 1},
           ("oneshot", "quant", "qwen", "gemma", "quantize_shard", "slot_loop")),
}
# the tiny configs (tiny_llama's keywords) whose weights the ranks carry
CONFIGS = {
    "llama": dict(max_seq_len=512),
    "qwen": dict(max_seq_len=512, qk_norm=True),
    "gemma": dict(
        max_seq_len=512, n_layers=3, qk_norm=True, act="gelu_tanh", sandwich_norms=True,
        norm_plus_one=True, embed_scale=True, query_scale=32.0, sliding_window=8,
        layer_is_global=(False, True, False), rope_local_theta=5000.0,
        rope_linear_factor=2.0, tie_embeddings=False,
    ),
}


# -- the ranks ------------------------------------------------------------------


def whole_model(payload, name="llama"):
    from vnsum_tpu_torch.models import llama as tl

    return tl.params_from_numpy(payload[name], tl.tiny_llama(**CONFIGS[name]), device="cpu")


def port_engine(model, mesh=None, **kw):
    from vnsum_tpu_torch.backend.engine import TorchBackend

    return TorchBackend(model=model, mesh=mesh, flash=True, quantize_kv=False, device="cpu",
                        **{**ENGINE_KW, **kw})


def run(backend, prompts, **kw) -> dict:
    """Texts, the generated id rows as the engine detokenizes them, and the
    batches by (B, S)."""
    rows = []
    detok = backend._detok

    def spy(ids, extra_eos=()):
        rows.append(np.asarray(ids).tolist())
        return detok(ids, extra_eos)

    backend._detok = spy
    texts = backend.generate(prompts, **kw)
    backend._detok = detok
    return {"texts": texts, "ids": rows, "by_bucket": dict(backend.stats.by_bucket)}


def case_oneshot(mesh, payload):
    return run(port_engine(whole_model(payload), mesh), PROMPTS)


def cached_passes(b) -> dict:
    out = {"passes": [run(b, PROMPTS, cache_hints=HINTS) for _ in range(2)]}
    out["hit_tokens"] = b.stats.cache_hit_tokens
    out["stats"] = b.prefix_cache_stats()
    out["pool"] = {k: v.clone() for k, v in b.prefix_cache.store.pool.items()}
    return out


def case_churn(mesh, payload):
    return cached_passes(port_engine(whole_model(payload), mesh, cache_blocks=6,
                                     cache_block_tokens=64, prefill_chunk_tokens=128))


def case_dp_resume(mesh, payload):
    return cached_passes(port_engine(whole_model(payload), mesh, cache_blocks=8,
                                     cache_block_tokens=64))


def case_spec(mesh, payload):
    from vnsum_tpu_torch.core.config import GenerationConfig

    b = port_engine(whole_model(payload), mesh)
    out = run(b, SHORT, config=GenerationConfig(spec_k=4), references=REFS)
    out["verify_steps"] = b.stats.spec_verify_steps
    out["report"] = len(b.take_spec_report())
    return out


def case_choices(mesh, payload):
    return port_engine(whole_model(payload), mesh).score_choices(PROMPTS, CHOICES)


def case_indivisible(mesh, payload):
    try:
        port_engine(whole_model(payload), mesh, batch_size=6)
    except ValueError as e:
        return str(e)
    return None


def case_quant(mesh, payload):
    return run(port_engine(whole_model(payload), mesh, quantize=True), PROMPTS)


def case_qwen(mesh, payload):
    return run(port_engine(whole_model(payload, "qwen"), mesh), PROMPTS)


def case_gemma(mesh, payload):
    return run(port_engine(whole_model(payload, "gemma"), mesh), PROMPTS)


def case_quantize_shard(mesh, payload):
    """quantize_model of the shard against the shard of quantize_model, and
    the carried tree sharded by params_from_numpy against shard_params."""
    from vnsum_tpu_torch.models import llama as tl
    from vnsum_tpu_torch.models.quant import quantize_model
    from vnsum_tpu_torch.parallel.sharding import shard_params

    whole = whole_model(payload)
    carried = tl.params_from_numpy(payload["llama"], whole.cfg, device="cpu", mesh=mesh)
    return {
        "shard_then_quantize": quantize_model(shard_params(whole, mesh)).tree(),
        "quantize_then_shard": shard_params(quantize_model(whole), mesh).tree(),
        "carried": carried.tree(),
        "sharded": shard_params(whole, mesh).tree(),
    }


def case_slot_loop(mesh, payload):
    try:
        port_engine(whole_model(payload), mesh).start_slot_loop(2)
    except NotImplementedError as e:
        return str(e)
    return None


def _rank_main(rank: int, key: str, init_file: str, out_dir: str, payload: dict) -> None:
    """One rank: join the group, build the mesh, run the mesh's cases (a
    failure is saved as its traceback), save, leave."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from vnsum_tpu_torch.parallel import init_distributed, make_mesh

    shape, cases = MESHES[key]
    world = shape["data"] * shape["model"]
    init_distributed(f"file://{init_file}", world, rank, device="cpu", timeout_s=30)
    try:
        mesh = make_mesh(shape, device="cpu")
        out = {"coords": dict(mesh.coords)}
        for name in cases:
            try:
                out[name] = globals()[f"case_{name}"](mesh, payload)
            except Exception:
                out[name] = {"error": traceback.format_exc()}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# -- the parent -------------------------------------------------------------------


@pytest.fixture(scope="module")
def carried():
    """(jax cfg, jax params, numpy tree) of each tiny config."""
    import jax

    from test_torch_models_llama import carried_weights

    out = {}
    for name, kw in CONFIGS.items():
        jcfg, params, _ = carried_weights(3, **kw)
        out[name] = (jcfg, params, jax.tree.map(np.asarray, params))
    return out


_SPAWNS: dict = {}


def spawned(key: str, carried, tmp_path_factory) -> list:
    """Every rank's saved results of the spawn for mesh ``key`` (run once)."""
    if key in _SPAWNS:
        return _SPAWNS[key]
    shape, _ = MESHES[key]
    world = shape["data"] * shape["model"]
    tmp = tmp_path_factory.mktemp(key)
    payload = {name: tree for name, (_, _, tree) in carried.items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, key, str(tmp / "rendezvous"), str(tmp), payload))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(JOIN_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"{key} ranks {hung} did not finish within {JOIN_S} s"
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert [p.exitcode for p in procs] == [0] * world
    _SPAWNS[key] = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]
    return _SPAWNS[key]


def rank_results(key: str, case: str, carried, tmp_path_factory) -> list:
    ranks = spawned(key, carried, tmp_path_factory)
    for r, res in enumerate(ranks):
        got = res[case]
        if isinstance(got, dict) and "error" in got:
            pytest.fail(f"{key} rank {r} case {case}:\n{got['error']}")
    return [res[case] for res in ranks]


def jax_engine(carried, key: str | None, name="llama", **kw):
    from vnsum_tpu.backend.engine import TpuBackend
    from vnsum_tpu.parallel import make_mesh

    jcfg, params, _ = carried[name]
    mesh = None if key is None else make_mesh(MESHES[key][0], platform="cpu")
    return TpuBackend(model_config=jcfg, params=params, mesh=mesh, tokenizer="byte",
                      **{**ENGINE_KW, **kw})


def port_whole(carried, name="llama", **kw):
    payload = {n: tree for n, (_, _, tree) in carried.items()}
    return port_engine(whole_model(payload, name), **kw)


def assert_three_way(ranks: list, jax_run: dict, port_run: dict) -> None:
    """Greedy ids and texts byte-identical across the ranks, to the JAX
    meshed engine's and to the port's unsharded engine's."""
    for r, got in enumerate(ranks):
        assert got["ids"] == ranks[0]["ids"], f"rank {r} differs from rank 0"
        assert got["texts"] == ranks[0]["texts"]
    assert ranks[0]["ids"] == jax_run["ids"]
    assert ranks[0]["ids"] == port_run["ids"]
    assert ranks[0]["texts"] == jax_run["texts"] == port_run["texts"]
    assert ranks[0]["by_bucket"] == jax_run["by_bucket"]
    assert any(any(t != PAD for t in row) for row in ranks[0]["ids"])  # not all pad


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("key", list(MESHES))
def test_oneshot_matches_jax_mesh_and_single_card(key, carried, tmp_path_factory, one_thread):
    """TP+DP, DP only, TP only: the one-shot path."""
    ranks = rank_results(key, "oneshot", carried, tmp_path_factory)
    assert_three_way(ranks, run(jax_engine(carried, key), PROMPTS),
                     run(port_whole(carried), PROMPTS))


def assert_cached(key: str, case: str, blocks: int, carried, tmp_path_factory, **kw) -> None:
    ranks = rank_results(key, case, carried, tmp_path_factory)
    jb = jax_engine(carried, key, cache_blocks=blocks, cache_block_tokens=64, **kw)
    tb = port_whole(carried, cache_blocks=blocks, cache_block_tokens=64, **kw)
    for i in range(2):
        assert_three_way([r["passes"][i] for r in ranks], run(jb, PROMPTS, cache_hints=HINTS),
                         run(tb, PROMPTS, cache_hints=HINTS))
    plain = run(port_whole(carried), PROMPTS)["texts"]
    for r in ranks:
        assert r["passes"][1]["texts"] == plain
        # the second pass resumed from the pool; every rank did the same
        assert r["hit_tokens"] == jb.stats.cache_hit_tokens == tb.stats.cache_hit_tokens > 0
        assert r["stats"]["blocks_used"] <= blocks
    shape = MESHES[key][0]
    L, KV, hd = tb.cfg.n_layers, tb.cfg.n_kv_heads, tb.cfg.head_dim
    coords = [spawned(key, carried, tmp_path_factory)[r]["coords"] for r in range(len(ranks))]
    for r, res in enumerate(ranks):
        # the pool shards its KV heads over model ...
        assert tuple(res["pool"]["k"].shape) == (blocks + 1, L, KV // shape["model"], 64, hd)
        # ... and is the same on every data rank of a model coordinate
        twin = next(q for q in range(len(ranks)) if coords[q]["model"] == coords[r]["model"])
        for name, buf in res["pool"].items():
            assert torch.equal(buf, ranks[twin]["pool"][name])


def test_chunked_prefill_and_radix_resume_match_under_churn(carried, tmp_path_factory,
                                                           one_thread):
    """A deliberately tiny pool (6 blocks) churns under LRU eviction while
    chunked prefill (128) and resume prefill run on the (2, 2) mesh."""
    assert_cached("tp_dp", "churn", 6, carried, tmp_path_factory, prefill_chunk_tokens=128)


def test_dp_resume_matches_single_card_cached_run(carried, tmp_path_factory, one_thread):
    """Cached resume on the data-only (4, 1) mesh."""
    assert_cached("dp", "dp_resume", 8, carried, tmp_path_factory)


@pytest.mark.parametrize("key", ["dp", "tp_dp"])
def test_spec_decode_dp_matches_plain_and_tp_degrades(key, carried, tmp_path_factory,
                                                      one_thread):
    """Spec decoding runs K3 on each rank's rows on a data-only mesh
    (byte-identical greedy), and under model sharding degrades to plain
    decode exactly where the JAX engine does."""
    from vnsum_tpu.core.config import GenerationConfig as JaxGenerationConfig

    ranks = rank_results(key, "spec", carried, tmp_path_factory)
    jb = jax_engine(carried, key)
    want = run(jb, SHORT, config=JaxGenerationConfig(spec_k=4), references=REFS)
    plain = run(port_whole(carried), SHORT)
    assert ranks[0]["texts"] == want["texts"] == plain["texts"]
    # a degraded call reports no spec records, as the JAX engine's
    n_report = len(jb.take_spec_report())
    assert n_report == (len(SHORT) if key == "dp" else 0)
    for r in ranks:
        assert r["ids"] == want["ids"] == plain["ids"]
        assert r["report"] == n_report
        if key == "dp":
            assert r["verify_steps"] > 0 and jb.stats.spec_verify_steps > 0
        else:
            assert r["verify_steps"] == 0 == jb.stats.spec_verify_steps


def test_score_choices_on_a_tp_dp_mesh(carried, tmp_path_factory, one_thread):
    ranks = rank_results("tp_dp", "choices", carried, tmp_path_factory)
    want = jax_engine(carried, "tp_dp").score_choices(PROMPTS, CHOICES)
    assert want == port_whole(carried).score_choices(PROMPTS, CHOICES)
    assert all(r == want for r in ranks)


@pytest.mark.parametrize("name", ["quant", "qwen", "gemma"])
def test_tp_branches_match_jax_mesh(name, carried, tmp_path_factory, one_thread):
    """model = 2 with int8 weights (the JAX engine's quantize=True), a
    Qwen3-like config (QK norms) and a Gemma3-like one (sandwich norms,
    plus-one norms, a window, GeGLU, an untied head)."""
    ranks = rank_results("tp", name, carried, tmp_path_factory)
    cfg_name = "llama" if name == "quant" else name
    kw = dict(quantize=True) if name == "quant" else {}
    assert_three_way(ranks, run(jax_engine(carried, "tp", cfg_name, **kw), PROMPTS),
                     run(port_whole(carried, cfg_name, **kw), PROMPTS))


def test_quantize_model_of_a_shard_is_the_shard_of_the_quantized(carried, tmp_path_factory):
    for res in rank_results("tp", "quantize_shard", carried, tmp_path_factory):
        for a, b in (("shard_then_quantize", "quantize_then_shard"), ("carried", "sharded")):
            torch.testing.assert_close(res[a], res[b], rtol=0, atol=0)


def test_indivisible_batch_and_slot_loop_raise(carried, tmp_path_factory):
    for msg in rank_results("dp", "indivisible", carried, tmp_path_factory):
        assert msg == "batch_size must be divisible by mesh data axis"
    for msg in rank_results("tp", "slot_loop", carried, tmp_path_factory):
        assert msg is not None and "A10c" in msg
