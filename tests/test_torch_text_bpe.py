"""The port's byte-level BPE reader (vnsum_tpu_torch/text/bpe.py, standard
library only) against ``transformers``' ``AutoTokenizer.from_pretrained`` on
the same directory: the committed fixture ``data/fixtures/llama_k128`` and
fresh ``train_bpe_tokenizer`` outputs. Ids equal, decoded text equal with
and without ``skip_special_tokens``, ``vocab_size`` and the special ids equal
to ``HFTokenizer``'s; ``get_tokenizer`` picks the reader by reading the
files; a field value the reader does not implement raises, naming it."""
from __future__ import annotations

import json
import shutil
import unicodedata
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from vnsum_tpu_torch.models.fixtures import GEN_CORPUS, train_bpe_tokenizer, train_wordpiece_tokenizer
from vnsum_tpu_torch.text import bpe
from vnsum_tpu_torch.text.bpe import BPETokenizer, UnsupportedTokenizer, unsupported_field
from vnsum_tpu_torch.text.tokenizer import HFTokenizer, get_tokenizer

ROOT = Path(__file__).resolve().parent.parent
VI_EVAL = ROOT / "data" / "vi_eval"
FIXTURE = ROOT / "data" / "fixtures" / "llama_k128"
TEXTS = {f"{sub}/{p.name}": p.read_text(encoding="utf-8")
         for sub in ("doc", "summary") for p in sorted((VI_EVAL / sub).glob("*.txt"))}

# the tokenizers held to transformers: the committed fixture's, one trained
# on the JAX package's generation corpus at the fixtures' vocabulary, one on
# data/vi_eval at 1024 (more merges, longer words)
SOURCES = ("fixture", "gen_corpus_384", "vi_eval_1024")

EDGE = [
    "", " ", "  ", "a", " a", "a ", "  a  b  ", "a\n", "\n\n\n", "\t\t x", "x\n\n y",
    " \n a", "a \t\n b", "\r\n", "\x0b\x0c", "\xa0a\u3000b", "123", " 4567 89", "3.14",
    "don't I'll we've they're 's 'S 'll'd", "''s", "!!?? ... ---", " ,.", "a.b,c",
    "😀 ok 😀😀", "emoji🙂tail", "<|eos|>", "a<|eos|>b", "<|bos|><|eos|><|pad|>",
    " <|eos|> ", "<|eos|<|eos|>|>", "Quốc hội\n\nđã thông qua.", "Ờ  ờ\tỜ",
    "tiếng Việt có dấu: ắ ằ ẳ ẵ ặ", "x" * 300, "ab " * 50, "\u0301\u0323a",
]


def hf(path: Path):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(str(path))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory) -> dict:
    root = tmp_path_factory.mktemp("bpe")
    out = {"fixture": FIXTURE}
    for name, corpus, vocab in (("gen_corpus_384", GEN_CORPUS, 384),
                                ("vi_eval_1024", list(TEXTS.values()), 1024)):
        train_bpe_tokenizer(corpus, vocab_size=vocab).save_pretrained(root / name)
        out[name] = root / name
    return out


@pytest.fixture(scope="module")
def pairs(dirs) -> dict:
    """source -> (the reader, transformers' tokenizer) on one directory."""
    return {name: (BPETokenizer(path), hf(path)) for name, path in dirs.items()}


def assert_same(reader, ref, text: str) -> None:
    want = ref.encode(text, add_special_tokens=False)
    got = reader.encode(text)
    assert got == want, (text[:80], got[:20], want[:20])
    for skip in (True, False):
        assert reader.decode(got, skip_special_tokens=skip) == ref.decode(
            want, skip_special_tokens=skip)


@pytest.mark.parametrize("form", ["NFC", "NFD"])
@pytest.mark.parametrize("name", sorted(TEXTS))
@pytest.mark.parametrize("source", SOURCES)
def test_vi_eval_texts(pairs, source, name, form):
    reader, ref = pairs[source]
    assert_same(reader, ref, unicodedata.normalize(form, TEXTS[name]))


@pytest.mark.parametrize("text", EDGE, ids=range(len(EDGE)))
@pytest.mark.parametrize("source", ["fixture", "vi_eval_1024"])
def test_edge_strings(pairs, source, text):
    reader, ref = pairs[source]
    assert_same(reader, ref, text)


def test_nfd_splits_words(pairs):
    """Combining marks (Mn) are neither letters nor numbers: NFD text takes
    more ids, as transformers gives."""
    reader, _ = pairs["fixture"]
    text = TEXTS["doc/pho_ha_noi.txt"]
    assert len(reader.encode(unicodedata.normalize("NFD", text))) > len(reader.encode(text))


@pytest.mark.parametrize("source", SOURCES)
def test_decode_ids_with_specials_and_broken_utf8(pairs, source):
    """Specials between text, specials alone, and byte tokens that end
    inside a UTF-8 sequence (U+FFFD, as tokenizers gives)."""
    reader, ref = pairs[source]
    n = reader.vocab_size
    cases = [[], [0], [1, 2, 0], [67, 2, 68], [2, 67, 1], list(range(n)),
             list(range(n - 1, -1, -1)), [175, 256], [256, 175], [175], [175, 175, 67],
             [i for i in range(3, n, 7)]]
    for ids in cases:
        for skip in (True, False):
            assert reader.decode(ids, skip_special_tokens=skip) == ref.decode(
                ids, skip_special_tokens=skip), ids


VI_LETTERS = "aăâbcdđeêghiklmnoôơpqrstuưvxyáàảãạắằẳẵặấầẩẫậéèẻẽẹếềểễệíìỉĩịóòỏõọốồổỗộớờởỡợúùủũụứừửữựýỳỷỹỵ"
ALPHABET = (VI_LETTERS + VI_LETTERS.upper() + "AZaz09" + "0123456789" + ".,;:!?'\"-()%/"
            + " \n\t\r\xa0" + "\u0300\u0301\u0303\u0309\u0323")


@settings(max_examples=300, derandomize=True, deadline=None)
@given(st.lists(st.one_of(st.text(alphabet=ALPHABET, max_size=40),
                          st.sampled_from(["<|eos|>", "<|bos|>", "<|pad|>", "'s", "'ll"])),
                max_size=8))
def test_property_vietnamese_ascii_whitespace(pairs, parts):
    text = "".join(parts)
    for source in ("fixture", "vi_eval_1024"):
        reader, ref = pairs[source]
        assert_same(reader, ref, text)
        assert_same(reader, ref, unicodedata.normalize("NFD", text))


@settings(max_examples=200, derandomize=True, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=383), max_size=30))
def test_property_decode_any_ids(pairs, ids):
    reader, ref = pairs["fixture"]
    for skip in (True, False):
        assert reader.decode(ids, skip_special_tokens=skip) == ref.decode(
            ids, skip_special_tokens=skip)


@pytest.mark.parametrize("source", SOURCES)
def test_fields_and_batches_match_hf_tokenizer(dirs, source):
    path = dirs[source]
    reader, ref = BPETokenizer(path), HFTokenizer(str(path))
    for field in ("vocab_size", "bos_id", "eos_id", "pad_id", "cls_id", "sep_id"):
        assert getattr(reader, field) == getattr(ref, field), field
    texts = list(TEXTS.values()) + EDGE
    assert reader.encode_batch(texts) == ref.encode_batch(texts)
    assert reader.encode_batch(texts, add_bos=True) == ref.encode_batch(texts, add_bos=True)
    assert reader.count_batch(texts) == ref.count_batch(texts)
    assert [reader.count(t) for t in texts] == [ref.count(t) for t in texts]


def test_fixture_special_tokens():
    reader = BPETokenizer(FIXTURE)
    assert (reader.pad_id, reader.bos_id, reader.eos_id) == (0, 1, 2)
    assert reader.vocab_size == 384
    assert reader.encode("a<|eos|>b") == [reader.encode("a")[0], 2, reader.encode("b")[0]]


def test_get_tokenizer_picks_the_reader_by_reading_the_files(dirs, tmp_path):
    assert unsupported_field(FIXTURE) is None
    assert isinstance(get_tokenizer(f"hf:{FIXTURE}"), BPETokenizer)
    wp = tmp_path / "wordpiece"
    train_wordpiece_tokenizer(list(TEXTS.values()), vocab_size=512).save_pretrained(wp)
    assert unsupported_field(wp) == "normalizer={'type': 'NFC'}"
    got = get_tokenizer(f"hf:{wp}")
    assert isinstance(got, HFTokenizer)
    assert got.cls_id is not None and got.sep_id is not None
    assert unsupported_field(tmp_path / "missing") == "tokenizer.json: no such file"


def edited_copy(src: Path, dst: Path, edit, config_edit=None) -> Path:
    shutil.copytree(src, dst)
    spec = json.loads((dst / "tokenizer.json").read_text(encoding="utf-8"))
    edit(spec)
    (dst / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    if config_edit is not None:
        cfg = json.loads((dst / "tokenizer_config.json").read_text(encoding="utf-8"))
        config_edit(cfg)
        (dst / "tokenizer_config.json").write_text(json.dumps(cfg), encoding="utf-8")
    return dst


def _set(path: str, value):
    def edit(d):
        *head, last = path.split(".")
        for key in head:
            d = d[int(key)] if key.isdigit() else d[key]
        d[last] = value
    return edit


UNSUPPORTED = [
    ("pre_tokenizer.use_regex", _set("pre_tokenizer.use_regex", False), None),
    ("normalizer", _set("normalizer", {"type": "NFC"}), None),
    ("pre_tokenizer.type", _set("pre_tokenizer", {"type": "Whitespace"}), None),
    ("model.byte_fallback", _set("model.byte_fallback", True), None),
    ("model.ignore_merges", _set("model.ignore_merges", True), None),
    ("model.dropout", _set("model.dropout", 0.1), None),
    ("added_tokens[2].lstrip", _set("added_tokens.2.lstrip", True), None),
    ("decoder.type", _set("decoder", {"type": "BPEDecoder", "suffix": "</w>"}), None),
    ("post_processor", _set("post_processor", {
        "type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
        "use_regex": True}), None),
    ("model.merges", lambda d: d["model"].__setitem__(
        "merges", [" ".join(pair) for pair in d["model"]["merges"]]), None),
    ("truncation", _set("truncation", {"max_length": 8, "strategy": "LongestFirst",
                                       "stride": 0, "direction": "Right"}), None),
    ("clean_up_tokenization_spaces", lambda d: None,
     lambda c: c.__setitem__("clean_up_tokenization_spaces", True)),
    ("tokenizer_class", lambda d: None,
     lambda c: c.__setitem__("tokenizer_class", "GPT2TokenizerFast")),
    ("additional_special_tokens", lambda d: None,
     lambda c: c.__setitem__("additional_special_tokens", ["<|x|>"])),
    ("add_prefix_space", lambda d: None, lambda c: c.__setitem__("add_prefix_space", True)),
]


@pytest.mark.parametrize("field,edit,config_edit", UNSUPPORTED, ids=[u[0] for u in UNSUPPORTED])
def test_unsupported_field_raises_by_name(tmp_path, field, edit, config_edit):
    d = edited_copy(FIXTURE, tmp_path / "copy", edit, config_edit)
    assert unsupported_field(d).startswith(field + "=")
    with pytest.raises(UnsupportedTokenizer, match=field.replace("[", r"\[").replace("]", r"\]")):
        BPETokenizer(d)
    assert isinstance(get_tokenizer(f"hf:{d}"), HFTokenizer)


@pytest.mark.parametrize("text", ["a", " a", "x<|eos|>y", "<|eos|> y", "  a  b"])
def test_add_prefix_space_in_tokenizer_json_is_overridden(tmp_path, text):
    """transformers sets the pre-tokenizer's add_prefix_space from
    tokenizer_config.json (False when absent) over tokenizer.json's, and so
    does the reader."""
    d = edited_copy(FIXTURE, tmp_path / "copy", _set("pre_tokenizer.add_prefix_space", True))
    assert unsupported_field(d) is None
    assert_same(BPETokenizer(d), hf(d), text)


def test_pretokenize_matches_tokenizers_byte_level():
    """GPT-2's pattern over every character class the pattern names, and
    the Unicode 16 letters and numbers Python's unicodedata does not know,
    against tokenizers' own ByteLevel pre-tokenizer."""
    from tokenizers import pre_tokenizers

    pt = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
    chars = ["a", "Ẫ", "5", "\u216b", "\u00bd", "!", "'", "\u0301", " ", "\n", "\t", "\x1c",
             "\x85", "\u2003", "\u3000", "\u200b", "\u1c89", "\U000105c0", "\U00010d40",
             "\U0001f600"]
    mapped = bpe._BYTE_CHAR
    for a in chars:
        for b in chars:
            for text in (a + b + a, " " + a + b, a + " " + b + "  ", "'" + a + b):
                want = [p for p, _ in pt.pre_tokenize_str(text)]
                got = ["".join(mapped[x] for x in piece.encode("utf-8"))
                       for piece in bpe.pretokenize(text)]
                assert got == want, repr(text)
