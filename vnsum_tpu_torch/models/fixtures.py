"""Real-format tiny HF checkpoints, trained on a corpus, for offline runs.

Counterpart of ``vnsum_tpu/models/fixtures.py``: the same functions with the
same arguments write the same files, byte for byte. Hosts without network
have no pretrained weights, so this module builds them: a genuine
``transformers`` model saved with ``save_pretrained`` (config.json +
model.safetensors) and a genuine byte-level BPE tokenizer *trained on the
target corpus* (tokenizer.json through the ``tokenizers`` library), every
file in a hub checkpoint's format, just small. ``train_steps > 0`` (or
:func:`train_tiny_family`) fits the LM on the corpus on the CPU, so greedy
decoding emits corpus-like Vietnamese instead of random bytes.

``torch``, ``transformers`` and ``tokenizers`` are imported inside the
functions: this module runs where ``transformers`` is installed. What it
writes loads anywhere: ``models/convert.py`` reads the weights and
``text/bpe.py`` the tokenizer with the standard library alone, so a
checkpoint built here runs on a machine without ``transformers``
(``scripts/make_torch_fixture.py`` builds the committed one,
``data/fixtures/llama_k128/``).

For a real pretrained model (e.g. Llama-3.2-3B) none of this is needed:
point ``--weights-dir`` at its checkout (see pipeline.cli).
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterable, Sequence

_BOS, _EOS, _PAD = "<|bos|>", "<|eos|>", "<|pad|>"


def train_bpe_tokenizer(corpus: Iterable[str], vocab_size: int = 1024):
    """Train a byte-level BPE tokenizer; returns PreTrainedTokenizerFast."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size,
        special_tokens=[_PAD, _BOS, _EOS],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False,
    )
    tok.train_from_iterator(corpus, trainer)
    return PreTrainedTokenizerFast(
        tokenizer_object=tok, bos_token=_BOS, eos_token=_EOS, pad_token=_PAD
    )


def make_tiny_hf_checkpoint(
    out_dir: str | Path,
    corpus: Sequence[str],
    vocab_size: int = 1024,
    dim: int = 128,
    n_layers: int = 2,
    n_heads: int = 4,
    n_kv_heads: int = 2,
    intermediate: int = 256,
    max_seq_len: int = 1024,
    seed: int = 0,
    train_steps: int = 0,
    train_seq_len: int = 128,
    train_batch: int = 16,
    lr: float = 3e-3,
) -> dict:
    """Build (and optionally train) a tiny HF Llama checkpoint at out_dir.

    Returns {"loss_first", "loss_last", "vocab_size"} for logging.
    """
    import torch
    import transformers

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    hf_tok = train_bpe_tokenizer(corpus, vocab_size=vocab_size)
    vocab = len(hf_tok)

    torch.manual_seed(seed)
    cfg = transformers.LlamaConfig(
        vocab_size=vocab,
        hidden_size=dim,
        num_hidden_layers=n_layers,
        num_attention_heads=n_heads,
        num_key_value_heads=n_kv_heads,
        intermediate_size=intermediate,
        max_position_embeddings=max_seq_len,
        rms_norm_eps=1e-5,
        rope_theta=10_000.0,
        tie_word_embeddings=False,
        bos_token_id=hf_tok.bos_token_id,
        eos_token_id=hf_tok.eos_token_id,
        pad_token_id=hf_tok.pad_token_id,
    )
    model = transformers.LlamaForCausalLM(cfg)

    loss_first = loss_last = None
    if train_steps > 0:
        ids: list[int] = []
        for text in corpus:
            ids.extend(hf_tok.encode(text))
            ids.append(hf_tok.eos_token_id)
        n_windows = max(1, len(ids) // train_seq_len)
        data = torch.tensor(
            ids[: n_windows * train_seq_len], dtype=torch.long
        ).view(n_windows, train_seq_len)

        model.train()
        opt = torch.optim.AdamW(model.parameters(), lr=lr)
        gen = torch.Generator().manual_seed(seed)
        for step in range(train_steps):
            rows = torch.randint(
                0, data.shape[0], (min(train_batch, data.shape[0]),),
                generator=gen,
            )
            batch = data[rows]
            loss = model(input_ids=batch, labels=batch).loss
            opt.zero_grad()
            loss.backward()
            opt.step()
            if step == 0:
                loss_first = float(loss.detach())
            loss_last = float(loss.detach())
        model.eval()

    model.save_pretrained(out, safe_serialization=True)
    hf_tok.save_pretrained(out)
    return {
        "loss_first": loss_first,
        "loss_last": loss_last,
        "vocab_size": vocab,
    }


def train_wordpiece_tokenizer(corpus: Iterable[str], vocab_size: int = 2048):
    """Train a BERT-style WordPiece tokenizer; returns BertTokenizerFast
    semantics via PreTrainedTokenizerFast ([CLS]/[SEP]/[PAD]/[UNK]/[MASK])."""
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, trainers
    from tokenizers.processors import TemplateProcessing
    from transformers import PreTrainedTokenizerFast

    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    tok = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.train_from_iterator(
        corpus,
        trainers.WordPieceTrainer(
            vocab_size=vocab_size, special_tokens=specials, show_progress=False
        ),
    )
    cls_id, sep_id = tok.token_to_id("[CLS]"), tok.token_to_id("[SEP]")
    tok.post_processor = TemplateProcessing(
        single="[CLS] $A [SEP]",
        pair="[CLS] $A [SEP] $B [SEP]",
        special_tokens=[("[CLS]", cls_id), ("[SEP]", sep_id)],
    )
    return PreTrainedTokenizerFast(
        tokenizer_object=tok,
        pad_token="[PAD]", unk_token="[UNK]", cls_token="[CLS]",
        sep_token="[SEP]", mask_token="[MASK]",
    )


def make_tiny_hf_encoder_checkpoint(
    out_dir: str | Path,
    corpus: Sequence[str],
    vocab_size: int = 2048,
    dim: int = 64,
    n_layers: int = 2,
    n_heads: int = 4,
    intermediate: int = 128,
    max_len: int = 256,
    seed: int = 0,
) -> dict:
    """Build a tiny HF BERT checkpoint (config.json + model.safetensors +
    WordPiece tokenizer) at out_dir — the MiniLM/mBERT-shaped fixture for the
    embedding-metric parity chain (reference models:
    evaluate/evaluate_summaries_semantic.py:128-133, :577-582). For the real
    pretrained encoders, point EmbeddingModel.from_hf at their checkout."""
    import torch
    import transformers

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    hf_tok = train_wordpiece_tokenizer(corpus, vocab_size=vocab_size)
    vocab = len(hf_tok)

    torch.manual_seed(seed)
    cfg = transformers.BertConfig(
        vocab_size=vocab,
        hidden_size=dim,
        num_hidden_layers=n_layers,
        num_attention_heads=n_heads,
        intermediate_size=intermediate,
        max_position_embeddings=max_len,
        pad_token_id=hf_tok.pad_token_id,
    )
    model = transformers.BertModel(cfg).eval()
    model.save_pretrained(out, safe_serialization=True)
    hf_tok.save_pretrained(out)
    return {"vocab_size": vocab}


# -- four-family trained fixtures (shared by parity tests and quality A/Bs) --

GEN_CORPUS = [
    "Quốc hội đã thông qua nghị quyết về phát triển kinh tế xã hội. "
    "Chính phủ sẽ triển khai các giải pháp trọng tâm trong năm nay.",
    "Tòa án nhân dân xét xử vụ án theo đúng quy định của pháp luật. "
    "Bản án được tuyên sau khi hội đồng nghị án.",
    "Nhà trường tổ chức kỳ thi tốt nghiệp cho học sinh khối mười hai. "
    "Kết quả sẽ được công bố trong tuần tới.",
] * 6

# family -> (HF model class name, HF config class name, config kwargs).
# One entry per reference model family (run_full_evaluation_pipeline.py:
# 960-962): Llama GQA, Qwen3 QK-norm, Gemma3 sandwich-norm + sliding
# interleave, Phi fused projections.
TRAINED_FAMILIES = {
    "llama": (
        "LlamaForCausalLM", "LlamaConfig",
        dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             max_position_embeddings=256, rope_theta=10000.0,
             rms_norm_eps=1e-5, tie_word_embeddings=True),
    ),
    "qwen3": (
        "Qwen3ForCausalLM", "Qwen3Config",
        dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             max_position_embeddings=256, rope_theta=10000.0,
             rms_norm_eps=1e-6, tie_word_embeddings=True),
    ),
    "gemma3": (
        "Gemma3ForCausalLM", "Gemma3TextConfig",
        dict(hidden_size=64, intermediate_size=128, num_hidden_layers=4,
             num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             max_position_embeddings=256, rope_theta=10000.0,
             rope_local_base_freq=5000.0, rms_norm_eps=1e-6,
             tie_word_embeddings=True, query_pre_attn_scalar=32,
             sliding_window=8,
             layer_types=["sliding_attention", "sliding_attention",
                          "full_attention", "sliding_attention"]),
    ),
    "phi": (
        "Phi3ForCausalLM", "Phi3Config",
        dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=256, rope_theta=10000.0,
             rms_norm_eps=1e-5, tie_word_embeddings=False),
    ),
}

# overrides producing shapes the attention kernels take (head_dim 128; the
# engine's kernel_gates): a model of these widths runs the production path,
# K1, K2 and K3 over an int8 KV cache (GQA group 2 on one KV head), so a
# quality A/B of the lossy knobs can measure it.
# Phi3Config derives head_dim = hidden/heads, so it omits the explicit key.
KERNEL_SHAPE_OVERRIDES = dict(
    hidden_size=256, intermediate_size=512, num_attention_heads=2,
    num_key_value_heads=1, head_dim=128,
)


def train_tiny_family(
    family: str,
    out_dir,
    steps: int = 40,
    overrides: dict | None = None,
    corpus: Sequence[str] | None = None,
):
    """Train a tiny HF model of ``family`` on ``corpus`` (torch CPU) and
    save_pretrained it with its BPE tokenizer. Returns (model, tokenizer).

    ``overrides`` replaces entries of the family's config (for example
    :data:`KERNEL_SHAPE_OVERRIDES`, or a longer
    ``max_position_embeddings``). Training reads 64-token windows of the
    corpus, 8 a step."""
    import torch
    import transformers

    corpus = list(corpus) if corpus is not None else GEN_CORPUS
    model_name, cfg_name, kw = TRAINED_FAMILIES[family]
    if overrides:
        kw = dict(kw)
        kw.update(overrides)
        if cfg_name == "Phi3Config":
            kw.pop("head_dim", None)
    hf_tok = train_bpe_tokenizer(corpus, vocab_size=384)
    torch.manual_seed(0)
    cfg = getattr(transformers, cfg_name)(
        vocab_size=len(hf_tok),
        bos_token_id=hf_tok.bos_token_id,
        eos_token_id=hf_tok.eos_token_id,
        pad_token_id=hf_tok.pad_token_id,
        **kw,
    )
    model = getattr(transformers, model_name)(cfg)

    ids: list[int] = []
    for text in corpus:
        ids.extend(hf_tok.encode(text))
        ids.append(hf_tok.eos_token_id)
    seq = 64
    n = len(ids) // seq
    data = torch.tensor(ids[: n * seq], dtype=torch.long).view(n, seq)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-3)
    gen = torch.Generator().manual_seed(0)
    model.train()
    for _ in range(steps):
        rows = torch.randint(0, n, (min(8, n),), generator=gen)
        batch = data[rows]
        loss = model(input_ids=batch, labels=batch).loss
        opt.zero_grad()
        loss.backward()
        opt.step()
    model.eval()
    model.save_pretrained(out_dir, safe_serialization=True)
    hf_tok.save_pretrained(out_dir)
    return model, hf_tok
