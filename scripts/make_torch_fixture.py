"""Builds the committed trained fixture ``data/fixtures/llama_k128/``: a tiny
Llama trained on ``data/vi_eval`` at the attention kernels' shape, stored as
a bf16 HF checkpoint with its byte-level BPE tokenizer.

    python scripts/make_torch_fixture.py [--steps 3000] [--out data/fixtures/llama_k128]

Needs ``transformers`` and ``tokenizers`` (to train) and runs on the CPU;
what it writes loads with neither (``vnsum_tpu_torch/models/convert.py``
reads the weights, ``vnsum_tpu_torch/text/bpe.py`` the tokenizer), so the
fixture runs wherever the port does:

    python -m vnsum_tpu_torch.pipeline.cli --approach mapreduce --models x \\
        --weights-dir data/fixtures/llama_k128 ...

Steps:

1. ``models/fixtures.py`` ``train_tiny_family("llama", ...)`` with
   ``KERNEL_SHAPE_OVERRIDES`` (hidden 256, 2 query heads on 1 KV head,
   head_dim 128) and ``max_position_embeddings`` 2048 (the port's
   ``max_seq_len``: a 1,065-1,347-token document and 128 new tokens fit one
   map prompt), over the 7 documents and 7 summaries of ``data/vi_eval``:
   each document inside the pipeline's map prompt
   (``strategies/prompts.py`` ``MAPREDUCE_MAP``), then a newline and its
   reference summary, so the model answers a map prompt with summary-like
   text (it has seen the references: its ROUGE against them measures
   nothing but that the path runs);
2. the saved f32 checkpoint loaded with the port's ``load_hf_checkpoint``
   and written back with ``save_hf_checkpoint`` (bf16), the tokenizer files
   copied beside it;
3. ``README.md`` beside the files: the steps, the corpus loss before and
   after training (mean cross-entropy over every 64-token training window,
   the f32 model), the bytes and sha256 of each file.

Training is deterministic on one machine (seed 0): a rebuild with the same
torch and transformers writes the same bytes.
"""
from __future__ import annotations

import argparse
import hashlib
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "special_tokens_map.json")
MAX_POSITIONS = 2048


def corpus() -> list[str]:
    """The 7 documents of data/vi_eval, each inside the pipeline's map
    prompt and followed by its reference summary: a model trained on these
    answers a map prompt with summary-like text and then its EOS."""
    from vnsum_tpu_torch.strategies.prompts import MAPREDUCE_MAP

    root = REPO / "data" / "vi_eval"
    return [MAPREDUCE_MAP.format(content=doc.read_text(encoding="utf-8").strip()) + "\n"
            + (root / "summary" / doc.name).read_text(encoding="utf-8").strip()
            for doc in sorted((root / "doc").glob("*.txt"))]


def corpus_loss(model, tok, texts: list[str]) -> float:
    """Mean cross-entropy of ``model`` over the 64-token windows that
    ``train_tiny_family`` trains on."""
    import torch

    ids: list[int] = []
    for text in texts:
        ids.extend(tok.encode(text))
        ids.append(tok.eos_token_id)
    n = len(ids) // 64
    data = torch.tensor(ids[: n * 64], dtype=torch.long).view(n, 64)
    with torch.no_grad():
        return float(model(input_ids=data, labels=data).loss)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--out", default=str(REPO / "data" / "fixtures" / "llama_k128"))
    args = ap.parse_args()

    import torch

    from vnsum_tpu_torch.models.convert import load_hf_checkpoint, save_hf_checkpoint
    from vnsum_tpu_torch.models.fixtures import KERNEL_SHAPE_OVERRIDES, train_tiny_family

    torch.set_num_threads(min(8, torch.get_num_threads()))
    texts = corpus()
    overrides = {**KERNEL_SHAPE_OVERRIDES, "max_position_embeddings": MAX_POSITIONS}
    out = Path(args.out)
    with tempfile.TemporaryDirectory() as tmp:
        untrained, tok = train_tiny_family("llama", Path(tmp) / "init", steps=0,
                                           overrides=overrides, corpus=texts)
        loss_first = corpus_loss(untrained.eval(), tok, texts)
        del untrained
        t0 = time.time()
        model, tok = train_tiny_family("llama", Path(tmp) / "f32", steps=args.steps,
                                       overrides=overrides, corpus=texts)
        seconds = time.time() - t0
        loss_last = corpus_loss(model, tok, texts)
        params = sum(p.numel() for p in model.parameters())
        cfg, ported = load_hf_checkpoint(str(Path(tmp) / "f32"), dtype=torch.bfloat16,
                                         device="cpu")
        if out.exists():
            shutil.rmtree(out)
        save_hf_checkpoint(ported, cfg, str(out))
        for name in TOKENIZER_FILES:
            shutil.copy(Path(tmp) / "f32" / name, out / name)

    files = sorted(p for p in out.iterdir() if p.name != "README.md")
    rows = [(p.name, p.stat().st_size, hashlib.sha256(p.read_bytes()).hexdigest())
            for p in files]
    total = sum(size for _, size, _ in rows)
    lines = [
        "# llama_k128: a tiny Llama trained on data/vi_eval",
        "",
        "Built by `python scripts/make_torch_fixture.py --steps "
        f"{args.steps}` (torch {torch.__version__}, CPU). A `LlamaForCausalLM` of",
        f"{params:,} parameters: {cfg.n_layers} layers, hidden {cfg.dim}, "
        f"{cfg.n_heads} query heads on {cfg.n_kv_heads} KV head,",
        f"head_dim {cfg.head_dim}, intermediate {cfg.intermediate}, vocabulary "
        f"{cfg.vocab_size}, tied embeddings, max_position_embeddings",
        f"{cfg.max_seq_len}. Trained for {args.steps} steps of 8 windows of 64 tokens "
        "(AdamW, lr 3e-3, seed 0)",
        "over the 7 documents and 7 summaries of `data/vi_eval`, each document inside",
        "the pipeline's map prompt followed by a newline and its reference summary (the",
        "model has seen the references); stored in bf16 by the port's",
        "`save_hf_checkpoint`, with the byte-level BPE tokenizer trained on the same",
        "texts (384 tokens: `<|pad|>`, `<|bos|>`, `<|eos|>` at ids 0-2).",
        "",
        "Training windows are 64 tokens long: positions past 64 (a map prompt is",
        "1,194-1,482 tokens) are extrapolated. A map prompt gets Vietnamese-looking text",
        "on the documents' topics, rarely an EOS within 128 tokens.",
        "",
        "Corpus loss (mean cross-entropy over every 64-token training window, the f32",
        f"model): {loss_first:.4f} before training, {loss_last:.4f} after.",
        "",
        "| File | Bytes | sha256 |",
        "|---|---|---|",
        *[f"| `{name}` | {size:,} | `{digest}` |" for name, size, digest in rows],
        f"| total | {total:,} | |",
        "",
    ]
    (out / "README.md").write_text("\n".join(lines), encoding="utf-8")
    print("\n".join(lines))
    print(f"trained in {seconds:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
