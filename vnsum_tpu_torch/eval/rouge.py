"""Self-contained ROUGE-1/2/L scorer (copy of vnsum_tpu/eval/rouge.py).

Exact behavioral port of the google-research `rouge_score` package's scoring
path as the reference uses it (evaluate/evaluate_summaries_semantic.py:132-143:
RougeScorer(['rouge1','rouge2','rougeL'], use_stemmer=True)), including its
ASCII-only tokenization (lowercase, non-[a-z0-9] stripped — which is what the
reference's committed Vietnamese numbers were produced with) and the Porter
stemmer applied to tokens longer than 3 chars. The JAX package's copy is
golden-tested against rouge_score + NLTK in tests/test_eval_rouge.py; this
one is held equal to it by tests/test_torch_pipeline.py.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Sequence

_NON_ALNUM = re.compile(r"[^a-z0-9]+")
# keep_unicode alphabet: any Unicode word char except underscore
_NON_WORD_UNI = re.compile(r"[^\w]+|_+", re.UNICODE)


@dataclass(frozen=True)
class Score:
    precision: float
    recall: float
    fmeasure: float


def _fmeasure(p: float, r: float) -> float:
    return 2 * p * r / (p + r) if p + r else 0.0


# -- Porter stemmer ---------------------------------------------------------
# Behavioral match for NLTK's PorterStemmer in its default NLTK_EXTENSIONS
# mode — the mode rouge_score actually constructs — including the irregular
# pool, the ies/ied 4-letter rules, the consonant-y rule in step 1c, the
# alli-first recursion and logi/fulli rules in step 2, and the 2-letter vc
# case of *o. Fuzz-tested against nltk in tests/test_eval_rouge.py.

_IRREGULAR = {
    "skies": "sky", "sky": "sky", "dying": "die", "lying": "lie",
    "tying": "tie", "news": "news", "innings": "inning", "inning": "inning",
    "outings": "outing", "outing": "outing", "cannings": "canning",
    "canning": "canning", "howe": "howe", "proceed": "proceed",
    "exceed": "exceed", "succeed": "succeed",
}


class PorterStemmer:
    _VOWELS = frozenset("aeiou")

    def _is_cons(self, word: str, i: int) -> bool:
        ch = word[i]
        if ch in self._VOWELS:
            return False
        if ch == "y":
            return True if i == 0 else not self._is_cons(word, i - 1)
        return True

    def _measure(self, stem: str) -> int:
        seq = "".join(
            "c" if self._is_cons(stem, i) else "v" for i in range(len(stem))
        )
        return seq.count("vc")

    def _m_gt0(self, stem: str) -> bool:
        return self._measure(stem) > 0

    def _m_gt1(self, stem: str) -> bool:
        return self._measure(stem) > 1

    def _has_vowel(self, stem: str) -> bool:
        return any(not self._is_cons(stem, i) for i in range(len(stem)))

    def _ends_double_cons(self, word: str) -> bool:
        return (
            len(word) >= 2
            and word[-1] == word[-2]
            and self._is_cons(word, len(word) - 1)
        )

    def _cvc(self, word: str) -> bool:
        if (
            len(word) >= 3
            and self._is_cons(word, len(word) - 3)
            and not self._is_cons(word, len(word) - 2)
            and self._is_cons(word, len(word) - 1)
            and word[-1] not in "wxy"
        ):
            return True
        # NLTK extension: 2-letter vc counts as *o
        return (
            len(word) == 2
            and not self._is_cons(word, 0)
            and self._is_cons(word, 1)
        )

    def _apply_rules(self, word: str, rules) -> str:
        """First rule whose suffix matches wins; a failed condition on a
        matched suffix stops the whole step (NLTK _apply_rule_list)."""
        for suffix, repl, cond in rules:
            if suffix == "*d":
                if self._ends_double_cons(word):
                    stem = word[:-2]
                    return stem + repl if cond is None or cond(stem) else word
                continue
            if word.endswith(suffix):
                stem = word[: len(word) - len(suffix)] if suffix else word
                return stem + repl if cond is None or cond(stem) else word
        return word

    def _step1a(self, w: str) -> str:
        if w.endswith("ies") and len(w) == 4:
            return w[:-3] + "ie"
        return self._apply_rules(
            w,
            [("sses", "ss", None), ("ies", "i", None), ("ss", "ss", None),
             ("s", "", None)],
        )

    def _step1b(self, w: str) -> str:
        if w.endswith("ied"):
            return w[:-3] + ("ie" if len(w) == 4 else "i")
        if w.endswith("eed"):
            stem = w[:-3]
            return stem + "ee" if self._m_gt0(stem) else w
        inter = None
        for suffix in ("ed", "ing"):
            if w.endswith(suffix):
                stem = w[: len(w) - len(suffix)]
                if self._has_vowel(stem):
                    inter = stem
                break
        if inter is None:
            return w
        return self._apply_rules(
            inter,
            [
                ("at", "ate", None),
                ("bl", "ble", None),
                ("iz", "ize", None),
                ("*d", inter[-1], lambda s: inter[-1] not in ("l", "s", "z")),
                ("", "e", lambda s: self._measure(s) == 1 and self._cvc(s)),
            ],
        )

    def _step1c(self, w: str) -> str:
        # y -> i only when preceded by a consonant in a >1-char stem
        return self._apply_rules(
            w,
            [("y", "i",
              lambda s: len(s) > 1 and self._is_cons(s, len(s) - 1))],
        )

    def _step2(self, w: str) -> str:
        if w.endswith("alli") and self._m_gt0(w[:-4]):
            return self._step2(w[:-4] + "al")
        rules = [
            ("ational", "ate", self._m_gt0), ("tional", "tion", self._m_gt0),
            ("enci", "ence", self._m_gt0), ("anci", "ance", self._m_gt0),
            ("izer", "ize", self._m_gt0), ("bli", "ble", self._m_gt0),
            ("alli", "al", self._m_gt0), ("entli", "ent", self._m_gt0),
            ("eli", "e", self._m_gt0), ("ousli", "ous", self._m_gt0),
            ("ization", "ize", self._m_gt0), ("ation", "ate", self._m_gt0),
            ("ator", "ate", self._m_gt0), ("alism", "al", self._m_gt0),
            ("iveness", "ive", self._m_gt0), ("fulness", "ful", self._m_gt0),
            ("ousness", "ous", self._m_gt0), ("aliti", "al", self._m_gt0),
            ("iviti", "ive", self._m_gt0), ("biliti", "ble", self._m_gt0),
            ("fulli", "ful", self._m_gt0),
            # the 'l' of 'logi' stays with the stem
            ("logi", "log", lambda s: self._m_gt0(w[:-3])),
        ]
        return self._apply_rules(w, rules)

    def _step3(self, w: str) -> str:
        return self._apply_rules(
            w,
            [
                ("icate", "ic", self._m_gt0), ("ative", "", self._m_gt0),
                ("alize", "al", self._m_gt0), ("iciti", "ic", self._m_gt0),
                ("ical", "ic", self._m_gt0), ("ful", "", self._m_gt0),
                ("ness", "", self._m_gt0),
            ],
        )

    def _step4(self, w: str) -> str:
        return self._apply_rules(
            w,
            [
                ("al", "", self._m_gt1), ("ance", "", self._m_gt1),
                ("ence", "", self._m_gt1), ("er", "", self._m_gt1),
                ("ic", "", self._m_gt1), ("able", "", self._m_gt1),
                ("ible", "", self._m_gt1), ("ant", "", self._m_gt1),
                ("ement", "", self._m_gt1), ("ment", "", self._m_gt1),
                ("ent", "", self._m_gt1),
                ("ion", "",
                 lambda s: self._m_gt1(s) and bool(s) and s[-1] in ("s", "t")),
                ("ou", "", self._m_gt1), ("ism", "", self._m_gt1),
                ("ate", "", self._m_gt1), ("iti", "", self._m_gt1),
                ("ous", "", self._m_gt1), ("ive", "", self._m_gt1),
                ("ize", "", self._m_gt1),
            ],
        )

    def _step5a(self, w: str) -> str:
        if w.endswith("e"):
            stem = w[:-1]
            if self._m_gt1(stem):
                return stem
            if self._measure(stem) == 1 and not self._cvc(stem):
                return stem
        return w

    def _step5b(self, w: str) -> str:
        return self._apply_rules(
            w, [("ll", "l", lambda s: self._m_gt1(w[:-1]))]
        )

    def stem(self, word: str) -> str:
        w = word.lower()
        if w in _IRREGULAR:
            return _IRREGULAR[w]
        if len(word) <= 2:
            return w
        for step in (
            self._step1a, self._step1b, self._step1c, self._step2,
            self._step3, self._step4, self._step5a, self._step5b,
        ):
            w = step(w)
        return w


_STEMMER = PorterStemmer()


def tokenize(
    text: str, use_stemmer: bool = True, keep_unicode: bool = False
) -> list[str]:
    """rouge_score tokenization: lowercase, strip non-[a-z0-9], stem len>3.

    ``keep_unicode=False`` (default) reproduces rouge_score EXACTLY —
    including its ASCII-only alphabet, which shreds Vietnamese words into
    diacritic-free fragments ('tóm tắt' → ['t','m','t','t']). The
    reference's ROUGE numbers are computed this way (its evaluate stack
    imports rouge_score verbatim), so parity demands it stay the default.
    ``keep_unicode=True`` keeps any Unicode word character instead, scoring
    Vietnamese on whole words; the Porter stemmer (English-only) is then
    applied only to pure-ASCII tokens."""
    text = text.lower()
    if keep_unicode:
        # NFC first: Python's \w does not match combining marks (Mn), so
        # NFD input ('o' + U+0301) would shred at every diacritic — the
        # exact failure this mode exists to avoid. The parity path is NOT
        # normalized: rouge_score doesn't, and parity means byte-for-byte
        import unicodedata

        text = unicodedata.normalize("NFC", text)
        text = _NON_WORD_UNI.sub(" ", text)
        tokens = [t for t in text.split() if t]
        if use_stemmer:
            tokens = [
                _STEMMER.stem(t) if len(t) > 3 and t.isascii() else t
                for t in tokens
            ]
        return tokens
    text = _NON_ALNUM.sub(" ", text)
    tokens = [t for t in text.split() if t]
    if use_stemmer:
        tokens = [_STEMMER.stem(t) if len(t) > 3 else t for t in tokens]
    return tokens


def _ngram_counts(tokens: Sequence[str], n: int) -> dict:
    counts: dict = {}
    for i in range(len(tokens) - n + 1):
        g = tuple(tokens[i : i + n])
        counts[g] = counts.get(g, 0) + 1
    return counts


def _score_ngrams(target: Sequence[str], prediction: Sequence[str], n: int) -> Score:
    t_counts = _ngram_counts(target, n)
    p_counts = _ngram_counts(prediction, n)
    overlap = sum(min(c, p_counts.get(g, 0)) for g, c in t_counts.items())
    t_total = max(sum(t_counts.values()), 0)
    p_total = max(sum(p_counts.values()), 0)
    precision = overlap / p_total if p_total else 0.0
    recall = overlap / t_total if t_total else 0.0
    return Score(precision, recall, _fmeasure(precision, recall))


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            if ai == b[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(prev[j], cur[j - 1])
        prev = cur
    return prev[len(b)]


def _score_lcs(target: Sequence[str], prediction: Sequence[str]) -> Score:
    if not target or not prediction:
        return Score(0.0, 0.0, 0.0)
    lcs = _lcs_len(target, prediction)
    precision = lcs / len(prediction)
    recall = lcs / len(target)
    return Score(precision, recall, _fmeasure(precision, recall))


class RougeScorer:
    """API-compatible subset of rouge_score.rouge_scorer.RougeScorer, on
    the pure-Python path only (the JAX package's optional C++ core gives
    identical results and is not part of the port)."""

    def __init__(
        self,
        rouge_types: Sequence[str],
        use_stemmer: bool = True,
        keep_unicode: bool = False,
    ):
        for rt in rouge_types:
            if rt not in ("rouge1", "rouge2", "rougeL"):
                raise ValueError(f"unsupported rouge type {rt!r}")
        self.rouge_types = list(rouge_types)
        self.use_stemmer = use_stemmer
        # keep_unicode scores on whole Unicode words (see tokenize)
        self.keep_unicode = keep_unicode

    def score(self, target: str, prediction: str) -> dict[str, Score]:
        t = tokenize(target, self.use_stemmer, self.keep_unicode)
        p = tokenize(prediction, self.use_stemmer, self.keep_unicode)
        out: dict[str, Score] = {}
        for rt in self.rouge_types:
            if rt == "rouge1":
                out[rt] = _score_ngrams(t, p, 1)
            elif rt == "rouge2":
                out[rt] = _score_ngrams(t, p, 2)
            else:
                out[rt] = _score_lcs(t, p)
        return out
