"""Embedding metrics on the device: sentence cosine similarity and
BERTScore.

Counterpart of ``vnsum_tpu/eval/embedding.py``: one encoder, batched
passes of fixed shape [batch_size, max_len] (a trailing batch is padded
with empty texts, as in the JAX package), token embeddings kept on the
device, and only the [N, D] sentence embeddings and the [N] scores read
back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..backend.engine import resolve_device
from ..models.encoder import EncoderConfig, encode, init_encoder_params, mean_pool, minilm_like
from ..text.tokenizer import Tokenizer, get_tokenizer


@dataclass(frozen=True)
class BertScore:
    precision: float
    recall: float
    f1: float


class EmbeddingModel:
    """Tokenize on the host, encode on ``device`` in fixed-shape batches.
    ``device="cuda"`` with no card raises."""

    def __init__(
        self,
        config: EncoderConfig | None = None,
        tokenizer: str | Tokenizer = "byte",
        params: dict | None = None,
        max_len: int | None = None,
        batch_size: int = 32,
        seed: int = 0,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.cfg = config or minilm_like()
        self.tok = get_tokenizer(tokenizer) if isinstance(tokenizer, str) else tokenizer
        self.max_len = max_len or self.cfg.max_len
        self.batch_size = batch_size
        if self.tok.vocab_size > self.cfg.vocab_size:
            raise ValueError(
                f"tokenizer vocab ({self.tok.vocab_size}) exceeds encoder vocab "
                f"({self.cfg.vocab_size}); use an EncoderConfig sized for this tokenizer")
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = init_encoder_params(self.cfg, gen, self.device)
        self.params = params
        # BERT-family tokenizers carry [CLS]/[SEP], and pretrained encoders
        # were trained with them: every sequence is wrapped as
        # sentence-transformers wraps it (mean pooling includes both)
        self._cls = getattr(self.tok, "cls_id", None)
        self._sep = getattr(self.tok, "sep_id", None)

    @classmethod
    def from_hf(cls, model_dir: str, batch_size: int = 32, device="cuda"):
        """A converted HF BERT-family checkpoint and its own tokenizer from a
        local dir: the metrics are then pretrained-calibrated."""
        from ..models.convert_encoder import load_hf_encoder

        config, params = load_hf_encoder(model_dir, device=device)
        return cls(config=config, tokenizer=f"hf:{model_dir}", params=params,
                   batch_size=batch_size, device=device)

    def _batch_tokens(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        S = self.max_len
        special = int(self._cls is not None) + int(self._sep is not None)
        toks = np.full((len(texts), S), self.tok.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), S), dtype=bool)
        for i, t in enumerate(texts):
            ids = self.tok.encode(t)[: S - special]
            if self._cls is not None:
                ids = [self._cls] + ids
            if self._sep is not None:
                ids = ids + [self._sep]
            toks[i, : len(ids)] = ids
            mask[i, : len(ids)] = True
        return toks, mask

    def token_embeddings(self, texts: list[str]) -> tuple[torch.Tensor, torch.Tensor]:
        """(embeddings [N, S, D], mask [N, S] bool), both on the device."""
        embs, masks = [], []
        for start in range(0, len(texts), self.batch_size):
            chunk = texts[start : start + self.batch_size]
            toks, mask = self._batch_tokens(chunk + [""] * (self.batch_size - len(chunk)))
            mask_d = torch.from_numpy(mask).to(self.device)
            out = encode(self.params, self.cfg, torch.from_numpy(toks).to(self.device), mask_d)
            embs.append(out[: len(chunk)])
            masks.append(mask_d[: len(chunk)])
        return torch.cat(embs), torch.cat(masks)

    def sentence_embeddings(self, texts: list[str]) -> np.ndarray:
        """L2-normalized mean-pooled embeddings [N, D], on the host."""
        embs, mask = self.token_embeddings(texts)
        return mean_pool(embs, mask).float().cpu().numpy()


def cosine_similarities(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise cosine of two [N, D] arrays (already normalized or not)."""
    an = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-9)
    bn = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-9)
    return np.sum(an * bn, axis=-1)


@torch.inference_mode()
def _greedy_match(c_embs, c_mask, r_embs, r_mask):
    """BERTScore greedy matching for one pair batch: c_embs [N, Sc, D],
    r_embs [N, Sr, D] -> (P, R) [N]."""
    cn = c_embs / c_embs.norm(dim=-1, keepdim=True).clamp_min(1e-9)
    rn = r_embs / r_embs.norm(dim=-1, keepdim=True).clamp_min(1e-9)
    sim = torch.einsum("ncd,nrd->ncr", cn, rn)
    valid = c_mask[:, :, None] & r_mask[:, None, :]
    sim = sim.masked_fill(~valid, -torch.inf)
    c_best = sim.amax(dim=2)  # [N, Sc]
    r_best = sim.amax(dim=1)  # [N, Sr]
    # a token with no valid counterpart (the other side empty) and padding
    # contribute 0, which keeps an empty text finite
    c_best = torch.where(c_mask & torch.isfinite(c_best), c_best, 0.0)
    r_best = torch.where(r_mask & torch.isfinite(r_best), r_best, 0.0)
    P = c_best.sum(dim=1) / c_mask.sum(dim=1).clamp_min(1)
    R = r_best.sum(dim=1) / r_mask.sum(dim=1).clamp_min(1)
    return P, R


def bert_scores(
    model: EmbeddingModel, candidates: list[str], references: list[str]
) -> list[BertScore]:
    """Corpus BERTScore without IDF weighting, matched in chunks of the
    encode batch size (each padded to it) so the [n, S, S] similarity
    tensor stays bounded."""
    if len(candidates) != len(references):
        raise ValueError("candidates and references must align")
    out: list[BertScore] = []
    bs = model.batch_size
    for start in range(0, len(candidates), bs):
        cands = candidates[start : start + bs]
        refs = references[start : start + bs]
        n = len(cands)
        c_embs, c_mask = model.token_embeddings(cands + [""] * (bs - n))
        r_embs, r_mask = model.token_embeddings(refs + [""] * (bs - n))
        P, R = _greedy_match(c_embs, c_mask, r_embs, r_mask)
        for p, r in zip(P[:n].tolist(), R[:n].tolist()):
            f1 = 2 * p * r / (p + r) if (p + r) else 0.0
            out.append(BertScore(p, r, f1))
    return out
