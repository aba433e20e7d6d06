"""CLI entry point of the port's pipeline, flag-compatible with
``vnsum_tpu.pipeline.cli`` for the options the port runs.

    python -m vnsum_tpu_torch.pipeline.cli --approach mapreduce \\
        --models llama3.2:3b --docs-dir data/vi_eval/doc \\
        --summary-dir data/vi_eval/summary --max-new-tokens 128

``--approach`` takes every approach of ``core/config.py`` ``APPROACHES``;
``mapreduce_hierarchical`` reads its trees from ``--tree-json`` (plain text
where a document has none) and collapses down from ``--max-depth``.

``--quantize`` runs int8 weights (the int8-weight GEMV kernel on every
small-batch forward); ``--quantize-act`` adds W8A8 prefill.

``--mesh data=2,model=2`` runs one process a card over a mesh of the
ranks of the run (``parallel/mesh.py``); ``--long-context`` with a ``seq``
axis above 1 runs whole documents through the ring prefill and the
seq-sharded decode. Launched by torchrun, one process a card:

    torchrun --nproc-per-node 2 -m vnsum_tpu_torch.pipeline.cli \\
        --approach truncated --long-context --mesh seq=2 --max-context 24576

With ``--device cpu`` the ranks join over gloo. Rank 0 alone writes the
summaries, the results JSON and the log file.

``--backend`` picks the summarizer: ``torch`` (the port's engine, the
default), ``ollama`` (a local server at ``--ollama-url``) or ``fake`` (the
test double). ``--include-llm-eval`` adds the G-Eval judge's scores;
``--judge-backend`` (``fake``, ``ollama:<model>`` or
``torch:<registry-name>``, the last with random weights) judges offline
and implies it.

``--weights-dir`` loads a local HF checkpoint (and its tokenizer) in place
of the registry's random weights; ``--embedding-dir`` scores BERTScore and
the sentence cosine with a local HF BERT-family checkpoint in place of a
random-init encoder.

Runs on the card; ``--device cpu`` runs on the CPU. Exits 1 when any
document or model failed.
"""
from __future__ import annotations

import argparse

from ..core.config import APPROACHES, BACKENDS, PipelineConfig, approach_defaults
from ..parallel.mesh import parse_mesh_spec


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vnsum-torch-pipeline",
        description="Run the summarization evaluation pipeline on the PyTorch/CUDA port",
    )
    p.add_argument("--approach", choices=APPROACHES, default="mapreduce")
    p.add_argument(
        "--models", nargs="+", default=["llama3.2:3b"],
        help="models to evaluate (names in vnsum_tpu_torch.models.MODEL_REGISTRY)",
    )
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument(
        "--tree-json", default="data_1/document_tree.json",
        help="mapreduce_hierarchical: document structure trees keyed by filename",
    )
    p.add_argument(
        "--max-depth", type=int, default=1,
        help="mapreduce_hierarchical: deepest tree level collapsed bottom-up",
    )
    p.add_argument("--backend", choices=BACKENDS, default="torch")
    p.add_argument("--ollama-url", default="http://localhost:11434")
    p.add_argument("--docs-dir", default="data_1/doc")
    p.add_argument("--summary-dir", default="data_1/summary")
    p.add_argument("--generated-summaries-dir", default="data_1/generated_summaries")
    p.add_argument("--results-dir", default="evaluation_results")
    p.add_argument("--logs-dir", default="logs")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--tokenizer", default="byte", help="byte or hf:<name-or-path>")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument(
        "--mesh", default="", help='device mesh over the ranks of the run, e.g. "data=2,model=4"'
    )
    p.add_argument(
        "--allow-cpu-mesh", action="store_true",
        help="recorded in the run's config for parity with the JAX CLI; a cuda "
        "run never moves to the CPU (a mesh that cannot form on the cards "
        "raises: pass --device cpu for a gloo mesh of CPU processes)",
    )
    p.add_argument(
        "--quantize", action="store_true",
        help="int8 weight-only quantization (halves the decode step's weight "
        "bytes); the KV cache quantizes whenever the attention kernels run, "
        "independent of this flag",
    )
    p.add_argument(
        "--quantize-act", action="store_true",
        help="W8A8 prefill: int8-quantize activations (per-token absmax) into "
        "the int8-weight prefill matmuls. LOSSY (activation rounding); A/B "
        "against --quantize alone for quality runs. Requires --quantize",
    )
    p.add_argument(
        "--quantize-kv-long", action="store_true",
        help="int8-quantize the long-context prefill KV cache (halves the "
        "long decode's cache reads a step). LOSSY: cached K/V round-trip "
        "through per-(position, head) int8, so logits drift slightly from "
        "the exact cache and greedy summaries can differ in late tokens; "
        "quality-gate runs should A/B it",
    )
    p.add_argument(
        "--long-context", action="store_true",
        help="ring-attention prefill + seq-sharded decode: prompts run "
        "untruncated up to seq ranks x the one-card limit (requires "
        "--backend torch and --mesh with seq>1); pair with --approach "
        "truncated --max-context <long limit> for one-shot whole-document "
        "summaries",
    )
    p.add_argument(
        "--weights-dir", default=None,
        help="local HF checkpoint dir (config.json + safetensors + tokenizer), "
        "e.g. a Llama-3.2-3B checkout; its tokenizer is used unless --tokenizer "
        "names an hf: one",
    )
    p.add_argument(
        "--embedding-dir", default=None,
        help="local HF BERT-family checkpoint dir for the embedding metrics "
        "(e.g. an all-MiniLM-L6-v2 checkout)",
    )
    p.add_argument(
        "--chunk-size", type=int, default=None,
        help="override the approach-default chunk size (tokens)",
    )
    p.add_argument(
        "--token-max", type=int, default=None,
        help="override the approach-default collapse budget (tokens)",
    )
    p.add_argument(
        "--max-new-tokens", type=int, default=None,
        help="override the approach-default generation budget",
    )
    p.add_argument(
        "--max-context", type=int, default=None,
        help="truncated and skeleton: context budget in tokens (ref default "
        "16384); hierarchical clamps its chunks to 75%% of it; with "
        "--long-context it may exceed the one-card limit",
    )
    p.add_argument(
        "--prefill-chunk-tokens", type=int, default=0,
        help="prefill in slices of this many tokens (multiple of 128; 0 = whole prompt)",
    )
    p.add_argument(
        "--include-llm-eval", action="store_true",
        help="run the G-Eval correctness/coherence column (reference "
        "include_llm_eval); needs OPENROUTER_API_KEY/OPENAI_API_KEY or "
        "--judge-backend",
    )
    p.add_argument(
        "--judge-backend", default=None,
        help="offline G-Eval judge over the Backend protocol: 'fake' (CI), "
        "'ollama:<model>', or 'torch:<registry-name>' (random weights); "
        "implies --include-llm-eval",
    )
    return p


def config_from_args(args: argparse.Namespace) -> PipelineConfig:
    overrides = approach_defaults(args.approach)
    for key in ("chunk_size", "token_max", "max_new_tokens", "max_context"):
        val = getattr(args, key)
        if val is not None:
            overrides[key] = val
    if args.chunk_size is not None:
        # keep overlap a small fraction of the chunk (ref default 200/12000)
        overrides["chunk_overlap"] = min(
            overrides.get("chunk_overlap", 200), max(0, args.chunk_size // 10)
        )
        overrides["iterative_chunk_size"] = args.chunk_size
        overrides["iterative_chunk_overlap"] = overrides["chunk_overlap"]
    cfg = PipelineConfig(
        approach=args.approach,
        models=list(args.models),
        backend=args.backend,
        ollama_url=args.ollama_url,
        docs_dir=args.docs_dir,
        summary_dir=args.summary_dir,
        generated_summaries_dir=args.generated_summaries_dir,
        results_dir=args.results_dir,
        logs_dir=args.logs_dir,
        max_samples=args.max_samples,
        batch_size=args.batch_size,
        tokenizer=args.tokenizer,
        mesh_shape=parse_mesh_spec(args.mesh),
        allow_cpu_mesh=args.allow_cpu_mesh,
        long_context=args.long_context,
        long_context_quantize_kv=args.quantize_kv_long,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        tree_json_path=args.tree_json,
        max_depth=args.max_depth,
        weights_dir=args.weights_dir,
        quantize=args.quantize,
        quantize_act=args.quantize_act,
        **{
            k: v
            for k, v in overrides.items()
            if k not in ("max_depth", "tree_json_path")
        },
    )
    cfg.evaluation.embedding_dir = args.embedding_dir
    if args.include_llm_eval:
        cfg.evaluation.include_llm_eval = True
    if args.judge_backend:
        cfg.evaluation.include_llm_eval = True
        cfg.evaluation.judge_backend = args.judge_backend
    return cfg


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from .runner import PipelineRunner

    runner = PipelineRunner(config_from_args(args), device=args.device)
    runner.run()
    return 1 if runner.failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
