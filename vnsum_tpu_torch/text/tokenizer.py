"""Tokenizers.

The reference uses two token metrics: real HF tokenizer counts for chunking
(run_full_evaluation_pipeline.py:348-349, meta-llama/Llama-3.2-3b at :344-345)
and whitespace-split word counts for collapse gating
(runners/run_summarization_ollama_mapreduce.py:58-60). Both are exposed here;
the framework uses ONE tokenizer consistently (SURVEY.md §7.2) and keeps
`whitespace_token_count` available for reference-parity gating.

Because pretrained vocabularies may not be present on an air-gapped TPU host,
the default is a self-contained byte-level tokenizer (lossless UTF-8 round
trip, zero downloads); `HFTokenizer` wraps any locally available HuggingFace
tokenizer for exact reference parity when its files exist, and
`text/bpe.py`'s `BPETokenizer` reads a byte-level BPE checkpoint's own
tokenizer.json with the standard library alone, where `transformers` is
missing.
"""
from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import Protocol, Sequence

from .bpe import BPETokenizer, unsupported_field


class Tokenizer(Protocol):
    vocab_size: int
    bos_id: int
    eos_id: int
    pad_id: int

    def encode(self, text: str, *, add_bos: bool = False) -> list[int]: ...
    def encode_batch(
        self, texts: Sequence[str], *, add_bos: bool = False
    ) -> list[list[int]]: ...
    def decode(self, ids: Sequence[int], *, skip_special_tokens: bool = True) -> str: ...
    def count(self, text: str) -> int: ...
    def count_batch(self, texts: Sequence[str]) -> list[int]: ...


def whitespace_token_count(text: str) -> int:
    """The reference backend's token estimate: len(text.split())
    (runners/run_summarization_ollama_mapreduce.py:58-60)."""
    return len(text.split())


class ByteTokenizer:
    """Lossless UTF-8 byte tokenizer with special tokens.

    ids 0..255 are raw bytes; BOS/EOS/PAD follow. vocab_size is padded to a
    multiple of 128 so the embedding table tiles cleanly on the MXU lane
    dimension.
    """

    def __init__(self) -> None:
        self.bos_id = 256
        self.eos_id = 257
        self.pad_id = 258
        self.vocab_size = 384  # 259 rounded up to a multiple of 128
        # ids that decode() can render as text: the 256 raw bytes. BOS/EOS/
        # PAD terminate or vanish, and 259..383 are MXU-tiling filler —
        # sampling any of them produces no text (see decodable_vocab_limit)
        self.decodable_vocab_size = 256

    def encode(self, text: str, *, add_bos: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [self.bos_id] + ids
        return ids

    def encode_batch(
        self, texts: Sequence[str], *, add_bos: bool = False
    ) -> list[list[int]]:
        return [self.encode(t, add_bos=add_bos) for t in texts]

    _SPECIAL_NAMES = {256: "<|bos|>", 257: "<|eos|>", 258: "<|pad|>"}

    def decode(self, ids: Sequence[int], *, skip_special_tokens: bool = True) -> str:
        if skip_special_tokens:
            raw = bytes(i for i in ids if i < 256)
            return raw.decode("utf-8", errors="ignore")
        out: list[str] = []
        run: list[int] = []
        for i in ids:
            if i < 256:
                run.append(i)
            else:
                if run:
                    out.append(bytes(run).decode("utf-8", errors="ignore"))
                    run = []
                out.append(self._SPECIAL_NAMES.get(i, f"<|{i}|>"))
        if run:
            out.append(bytes(run).decode("utf-8", errors="ignore"))
        return "".join(out)

    def count(self, text: str) -> int:
        return len(text.encode("utf-8"))

    def count_batch(self, texts: Sequence[str]) -> list[int]:
        return [len(t.encode("utf-8")) for t in texts]


class HFTokenizer:
    """Wrapper over a locally available HuggingFace tokenizer (the reference's
    chunking metric, run_full_evaluation_pipeline.py:344-349)."""

    def __init__(self, name_or_path: str) -> None:
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(name_or_path)
        self.vocab_size = len(self._tok)
        # encoder-only tokenizers (BERT/MiniLM WordPiece) have no EOS; their
        # SEP plays the terminator role. The generation engine still needs a
        # real terminator, so raise only when neither exists.
        eos = self._tok.eos_token_id
        if eos is None:
            eos = self._tok.sep_token_id
        if eos is None:
            raise ValueError(
                f"tokenizer {name_or_path!r} has neither eos nor sep token; "
                "the engine needs one to terminate generation"
            )
        self.eos_id = eos
        self.bos_id = self._tok.bos_token_id  # may be None (no BOS prepended)
        self.cls_id = self._tok.cls_token_id  # BERT-family only (else None)
        self.sep_id = self._tok.sep_token_id
        pad = self._tok.pad_token_id
        self.pad_id = pad if pad is not None else self.eos_id

    def encode(self, text: str, *, add_bos: bool = False) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        if add_bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        return ids

    def encode_batch(
        self, texts: Sequence[str], *, add_bos: bool = False
    ) -> list[list[int]]:
        """One call into the Rust fast-tokenizer for the whole list: it
        releases the GIL and parallelizes across cores, and even
        single-core it skips the per-call Python overhead (measured 1.4x
        on reference-scale prompt lists — the engine's tokenize_host
        phase and the splitter's length function both ride this)."""
        out = self._tok(list(texts), add_special_tokens=False)["input_ids"]
        if add_bos and self.bos_id is not None:
            out = [[self.bos_id] + ids for ids in out]
        return out

    def decode(self, ids: Sequence[int], *, skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def count(self, text: str) -> int:
        return len(self._tok.encode(text, add_special_tokens=False))

    def count_batch(self, texts: Sequence[str]) -> list[int]:
        return [len(ids) for ids in self.encode_batch(texts)]


@lru_cache(maxsize=8)
def get_tokenizer(spec: str = "byte") -> Tokenizer:
    """Factory: "byte" or "hf:<name-or-path>". A local directory whose
    tokenizer.json is a byte-level BPE that ``text/bpe.py`` implements (its
    files say so) loads with that reader, which needs no ``transformers``,
    so a checkpoint's own tokenizer runs on every machine; any other name
    or directory loads with ``HFTokenizer``."""
    if spec == "byte":
        return ByteTokenizer()
    if spec.startswith("hf:"):
        path = spec[3:]
        if Path(path).is_dir() and unsupported_field(path) is None:
            return BPETokenizer(path)
        return HFTokenizer(path)
    raise ValueError(f"unknown tokenizer spec {spec!r} (use 'byte' or 'hf:<path>')")
