"""A byte-level BPE tokenizer read from a checkpoint's ``tokenizer.json``,
with the standard library alone.

The card machine has no ``transformers`` and no ``tokenizers``, so
``HFTokenizer`` cannot load a checkpoint's own tokenizer there. This module
reads the files that ``AutoTokenizer.from_pretrained(<dir>)`` reads
(``tokenizer.json``, ``tokenizer_config.json`` and ``special_tokens_map.json``)
and encodes and decodes as ``tokenizers`` does, for the byte-level BPE
files that ``models/fixtures.py``'s ``train_bpe_tokenizer`` writes (GPT-2's
scheme): added tokens matched in the raw text first, the rest split with
GPT-2's pattern, each piece's UTF-8 bytes mapped to printable characters
and merged by rank; decoding maps the characters back to bytes and decodes
them as UTF-8 with U+FFFD for invalid bytes.

Every field that changes ids or text is read from the files, and a value
this reader does not implement raises :class:`UnsupportedTokenizer`, naming
the field; :func:`unsupported_field` makes the same check without raising,
so ``text/tokenizer.py``'s ``get_tokenizer`` can choose this reader or
``HFTokenizer`` by reading the files.
"""
from __future__ import annotations

import heapq
import json
import re
import unicodedata
from pathlib import Path
from typing import Sequence

# Unicode's White_Space property: what ``\\s`` matches in the regex engine
# of ``tokenizers`` (Oniguruma). Python's str.isspace() differs (it takes
# U+001C-U+001F too), so the set is written out
_WHITESPACE = frozenset(
    "\t\n\v\f\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005\u2006\u2007"
    "\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000"
)
# letters and numbers of Unicode 16 (code points Python 3.12's unicodedata,
# at Unicode 15.0, calls unassigned), as tokenizers' regex engine classes
# them: (first, last) code point ranges
_NEWER_LETTERS = (
    (0x1C89, 0x1C8A), (0xA7CB, 0xA7CD), (0xA7DA, 0xA7DC), (0x105C0, 0x105F3),
    (0x10D4A, 0x10D65), (0x10D6F, 0x10D85), (0x10EC2, 0x10EC4), (0x11380, 0x11389),
    (0x1138B, 0x1138B), (0x1138E, 0x1138E), (0x11390, 0x113B5), (0x113B7, 0x113B7),
    (0x113D1, 0x113D1), (0x113D3, 0x113D3), (0x11BC0, 0x11BE0), (0x13460, 0x143FA),
    (0x16100, 0x1611D), (0x16D40, 0x16D6C), (0x18CFF, 0x18CFF), (0x1E5D0, 0x1E5ED),
    (0x1E5F0, 0x1E5F0), (0x2EBF0, 0x2EE5D),
)
_NEWER_NUMBERS = (
    (0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9), (0x16130, 0x16139),
    (0x16D70, 0x16D79), (0x1CCF0, 0x1CCF9), (0x1E5F1, 0x1E5FA),
)
# GPT-2's contractions, tried in this order before anything else
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
# special tokens that transformers reads from tokenizer_config.json and
# special_tokens_map.json
_SPECIAL_KEYS = ("bos_token", "eos_token", "pad_token", "cls_token", "sep_token",
                 "unk_token", "mask_token")
# tokenizer_config.json keys that do not change encode or decode
_IGNORED_CONFIG_KEYS = ("added_tokens_decoder", "model_max_length", "padding_side",
                        "truncation_side", "model_input_names", "chat_template")
# keys that would add tokens to the vocabulary: implemented only empty
_EMPTY_CONFIG_KEYS = ("additional_special_tokens", "extra_special_tokens")


class UnsupportedTokenizer(ValueError):
    """A tokenizer file holds a value this reader does not implement."""


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's map from each byte to a printable character: printable
    Latin-1 bytes map to themselves, the other 68 to U+0100 onwards."""
    keep = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    out, extra = {}, 0
    for b in range(256):
        if b in keep:
            out[b] = chr(b)
        else:
            out[b] = chr(256 + extra)
            extra += 1
    return out


_BYTE_CHAR = bytes_to_unicode()
_CHAR_BYTE = {c: b for b, c in _BYTE_CHAR.items()}


def _kind(c: str) -> str:
    """The class of one character in GPT-2's pattern: "s" whitespace, "L"
    a letter (\\p{L}), "N" a number (\\p{N}), "o" anything else."""
    if c in _WHITESPACE:
        return "s"
    cat = unicodedata.category(c)
    if cat == "Cn":
        cp = ord(c)
        for kind, table in (("L", _NEWER_LETTERS), ("N", _NEWER_NUMBERS)):
            if any(lo <= cp <= hi for lo, hi in table):
                return kind
    return cat[0] if cat[0] in "LN" else "o"


def pretokenize(text: str) -> list[str]:
    """Splits text as GPT-2's pattern does, leftmost alternative first:
    ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``.
    The pieces cover the text."""
    n = len(text)
    kinds = [_kind(c) for c in text]
    out = []
    i = 0
    while i < n:
        j = None
        if text[i] == "'":
            for tail in _CONTRACTIONS:
                if text.startswith(tail, i + 1):
                    j = i + 1 + len(tail)
                    break
        if j is None:
            # an optional space, then a run of one class other than whitespace
            k = i + 1 if text[i] == " " else i
            if k < n and kinds[k] != "s":
                j = k + 1
                while j < n and kinds[j] == kinds[k]:
                    j += 1
            else:
                # a whitespace run: all of it at the end of the text, else
                # all but its last character (which goes with what follows),
                # or the one character where the run is one long
                e = i
                while e < n and kinds[e] == "s":
                    e += 1
                j = e if e == n or e - i == 1 else e - 1
        out.append(text[i:j])
        i = j
    return out


def _read_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _token_content(value):
    """A special token's text as the config files write it: a string, a
    dict with "content", or null."""
    if isinstance(value, dict):
        return value.get("content")
    return value


def _check(spec: dict, config: dict) -> str | None:
    """The first field of the tokenizer files whose value the reader does
    not implement, as "field=value", or None."""
    expect = [
        ("truncation", spec.get("truncation"), None),
        ("padding", spec.get("padding"), None),
        ("normalizer", spec.get("normalizer"), None),
    ]
    for name, got, want in expect:
        if got != want:
            return f"{name}={got!r}"
    for i, tok in enumerate(spec.get("added_tokens") or []):
        for flag in ("single_word", "lstrip", "rstrip", "normalized"):
            if tok.get(flag):
                return f"added_tokens[{i}].{flag}={tok.get(flag)!r}"
    pre = spec.get("pre_tokenizer") or {}
    if pre.get("type") != "ByteLevel":
        return f"pre_tokenizer.type={pre.get('type')!r}"
    if pre.get("use_regex") is not True:
        return f"pre_tokenizer.use_regex={pre.get('use_regex')!r}"
    # PreTrainedTokenizerFast sets the ByteLevel pre-tokenizer's
    # add_prefix_space to tokenizer_config.json's (False when absent),
    # whatever tokenizer.json says
    if config.get("add_prefix_space", False) is not False:
        return f"add_prefix_space={config.get('add_prefix_space')!r}"
    if spec.get("post_processor") is not None:
        return f"post_processor={spec.get('post_processor')!r}"
    dec = spec.get("decoder") or {}
    if dec.get("type") != "ByteLevel":
        return f"decoder.type={dec.get('type')!r}"
    model = spec.get("model") or {}
    if model.get("type") != "BPE":
        return f"model.type={model.get('type')!r}"
    for name, want in (("dropout", None), ("unk_token", None),
                       ("continuing_subword_prefix", None), ("end_of_word_suffix", None),
                       ("fuse_unk", False), ("byte_fallback", False), ("ignore_merges", False)):
        if model.get(name, want) != want:
            return f"model.{name}={model.get(name)!r}"
    for pair in model.get("merges", []):
        if not (isinstance(pair, list) and len(pair) == 2):
            return f"model.merges={pair!r} (not a pair)"
    cls = config.get("tokenizer_class")
    if cls != "PreTrainedTokenizerFast":
        return f"tokenizer_class={cls!r}"
    if config.get("clean_up_tokenization_spaces") is not False:
        return f"clean_up_tokenization_spaces={config.get('clean_up_tokenization_spaces')!r}"
    if config.get("split_special_tokens", False) is not False:
        return f"split_special_tokens={config.get('split_special_tokens')!r}"
    for key, value in config.items():
        if key in _EMPTY_CONFIG_KEYS and value:
            return f"{key}={value!r}"
        if key not in _IGNORED_CONFIG_KEYS + _EMPTY_CONFIG_KEYS + _SPECIAL_KEYS + (
                "tokenizer_class", "clean_up_tokenization_spaces", "split_special_tokens",
                "add_prefix_space"):
            return f"{key}={value!r}"
    return None


def _load(path: str | Path) -> tuple[dict, dict]:
    """(tokenizer.json, the tokenizer config with special_tokens_map.json
    laid over it, as transformers lays them)."""
    root = Path(path)
    spec = _read_json(root / "tokenizer.json")
    config_file = root / "tokenizer_config.json"
    config = _read_json(config_file) if config_file.is_file() else {}
    map_file = root / "special_tokens_map.json"
    if map_file.is_file():
        config = {**config, **_read_json(map_file)}
    return spec, config


def unsupported_field(path: str | Path) -> str | None:
    """None when :class:`BPETokenizer` reads the tokenizer in directory
    ``path`` as ``transformers`` does; else the first field it does not
    implement ("field=value"), or the missing file."""
    if not (Path(path) / "tokenizer.json").is_file():
        return "tokenizer.json: no such file"
    return _check(*_load(path))


class BPETokenizer:
    """The byte-level BPE tokenizer of an HF checkpoint directory, the
    port's ``Tokenizer`` protocol over it, with no dependency: ids and text
    equal ``AutoTokenizer.from_pretrained(path)``'s ``encode(text,
    add_special_tokens=False)`` and ``decode(ids, skip_special_tokens=...)``.
    Raises :class:`UnsupportedTokenizer` naming the first field whose value
    it does not implement."""

    def __init__(self, path: str | Path) -> None:
        spec, config = _load(path)
        bad = _check(spec, config)
        if bad is not None:
            raise UnsupportedTokenizer(f"{Path(path) / 'tokenizer.json'}: {bad} is not "
                                       "implemented by the byte-level BPE reader")
        model = spec["model"]
        self._vocab: dict[str, int] = dict(model["vocab"])
        self._id_to_token = {i: t for t, i in self._vocab.items()}
        self._added = {t["content"]: t["id"] for t in spec.get("added_tokens") or []}
        self._added_by_id = {i: t for t, i in self._added.items()}
        self._special = {t["content"] for t in spec.get("added_tokens") or [] if t["special"]}
        # leftmost, then longest: the alternation tries longer tokens first
        self._added_re = (re.compile("|".join(
            re.escape(t) for t in sorted(self._added, key=len, reverse=True)))
            if self._added else None)
        self._merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, (a, b) in enumerate(model["merges"]):
            for part in (a, b, a + b):
                if part not in self._vocab:
                    raise UnsupportedTokenizer(
                        f"model.merges[{rank}]={[a, b]!r}: {part!r} is not in model.vocab")
            self._merges[(self._vocab[a], self._vocab[b])] = (rank, self._vocab[a + b])
        self._words: dict[str, list[int]] = {}
        # len(tokenizer) in transformers: the vocabulary with the added tokens
        self.vocab_size = len({**self._vocab, **self._added})
        ids = {key: self.token_to_id(_token_content(config.get(key))) for key in _SPECIAL_KEYS}
        # as HFTokenizer: SEP stands in for a missing EOS, EOS for a missing PAD
        eos = ids["eos_token"] if ids["eos_token"] is not None else ids["sep_token"]
        if eos is None:
            raise ValueError(f"tokenizer {str(path)!r} has neither eos nor sep token; "
                             "the engine needs one to terminate generation")
        self.eos_id = eos
        self.bos_id = ids["bos_token"]
        self.cls_id = ids["cls_token"]
        self.sep_id = ids["sep_token"]
        self.pad_id = ids["pad_token"] if ids["pad_token"] is not None else self.eos_id

    def token_to_id(self, token: str | None) -> int | None:
        if token is None:
            return None
        if token in self._added:
            return self._added[token]
        if token in self._vocab:
            return self._vocab[token]
        raise UnsupportedTokenizer(f"special token {token!r} is in neither added_tokens "
                                   "nor model.vocab")

    def _bpe(self, word: str) -> list[int]:
        """One pre-tokenized piece (already byte-mapped) merged as
        ``tokenizers`` merges a word: the lowest-ranked adjacent pair
        first, the leftmost of equal ranks, each merge making new pairs
        with its neighbours; characters outside the vocabulary are dropped
        (there is no unk token)."""
        ids = self._words.get(word)
        if ids is not None:
            return ids
        sym = [self._vocab[c] for c in word if c in self._vocab]
        n = len(sym)
        nxt = list(range(1, n)) + [-1]
        prv = list(range(-1, n - 1))
        alive = [True] * n
        merges = self._merges
        heap = []
        for i in range(n - 1):
            m = merges.get((sym[i], sym[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            right = nxt[pos]
            if not alive[pos] or right == -1:
                continue
            m = merges.get((sym[pos], sym[right]))
            if m is None or m[1] != new_id:
                continue  # an entry whose pair has changed since
            sym[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] != -1:
                prv[nxt[pos]] = pos
            left = prv[pos]
            if left != -1:
                m = merges.get((sym[left], sym[pos]))
                if m is not None:
                    heapq.heappush(heap, (m[0], left, m[1]))
            if nxt[pos] != -1:
                m = merges.get((sym[pos], sym[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        ids = [s for s, a in zip(sym, alive) if a]
        self._words[word] = ids
        return ids

    def _encode_span(self, text: str, out: list[int]) -> None:
        for piece in pretokenize(text):
            out.extend(self._bpe("".join(_BYTE_CHAR[b] for b in piece.encode("utf-8"))))

    def encode(self, text: str, *, add_bos: bool = False) -> list[int]:
        ids: list[int] = [self.bos_id] if add_bos and self.bos_id is not None else []
        start = 0
        if self._added_re is not None:
            for m in self._added_re.finditer(text):
                if m.start() > start:
                    self._encode_span(text[start:m.start()], ids)
                ids.append(self._added[m.group()])
                start = m.end()
        if start < len(text):
            self._encode_span(text[start:], ids)
        return ids

    def encode_batch(self, texts: Sequence[str], *, add_bos: bool = False) -> list[list[int]]:
        return [self.encode(t, add_bos=add_bos) for t in texts]

    def decode(self, ids: Sequence[int], *, skip_special_tokens: bool = True) -> str:
        raw = bytearray()
        for i in ids:
            i = int(i)
            tok = self._added_by_id.get(i)
            if tok is None:
                tok = self._id_to_token.get(i)
            if tok is None or (skip_special_tokens and tok in self._special):
                continue
            try:
                raw.extend(_CHAR_BYTE[c] for c in tok)
            except KeyError:  # a token outside the byte alphabet: its own UTF-8
                raw.extend(tok.encode("utf-8"))
        return raw.decode("utf-8", errors="replace")

    def count(self, text: str) -> int:
        return len(self.encode(text))

    def count_batch(self, texts: Sequence[str]) -> list[int]:
        return [len(ids) for ids in self.encode_batch(texts)]
