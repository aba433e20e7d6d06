"""Lint framework: source model, rule registry, suppressions, runner.

Copy of ``vnsum_tpu/analysis/core.py``.

Design constraints, in order:

- **Parse, never import.** Rules work on AST + comment tokens so the lint
  runs before dependencies are installed and can never be skewed by
  import-time failures (the property scripts/check_metrics_doc.py was built
  around; its successor rule keeps it).
- **Comments are the annotation surface.** Python has no in-language way to
  say "this field is guarded by that lock", so the rules read conventions
  out of the token stream (``# guarded by:``, ``# hot path``) — the
  :class:`SourceFile` model carries a line -> comment map built with
  :mod:`tokenize`, so a ``#`` inside a string literal can never register as
  an annotation.
- **Suppressions carry a reason.** ``# lint-allow[rule]: reason`` on the
  offending line (or the line directly above) silences exactly one rule;
  an empty reason is itself a finding (rule ``suppression``) — the point of
  a domain lint is that every exception is a written-down decision.
"""
from __future__ import annotations

import ast
import io
import json
import re
import tokenize
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Iterable, Iterator

SUPPRESS_RE = re.compile(r"#\s*lint-allow\[([A-Za-z0-9_-]+)\]:?\s*(.*)")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_dict(self) -> dict:
        return asdict(self)


class SourceFile:
    """Parsed view of one file: AST with parent links + comment map."""

    def __init__(self, path: str | Path, text: str) -> None:
        self.path = str(path)
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=self.path)
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                child._lint_parent = parent  # type: ignore[attr-defined]
        # line -> comment string ("#..."); tokenize is string-literal-safe
        self.comments: dict[int, str] = {}
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                self.comments[tok.start[0]] = tok.string

    @classmethod
    def read(cls, path: str | Path) -> "SourceFile":
        return cls(path, Path(path).read_text(encoding="utf-8"))

    def comment(self, line: int) -> str:
        return self.comments.get(line, "")

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = getattr(node, "_lint_parent", None)
        while cur is not None:
            yield cur
            cur = getattr(cur, "_lint_parent", None)


class Rule:
    """A per-file check. Subclasses set ``name``/``description`` and
    implement :meth:`check`; project-scope rules (one run per invocation,
    e.g. metrics-doc) set ``project = True`` and implement
    :meth:`check_project` instead."""

    name: str = ""
    description: str = ""
    project: bool = False

    def check(self, sf: SourceFile) -> list[Finding]:
        return []

    def check_project(self, root: Path) -> list[Finding]:
        return []


_REGISTRY: dict[str, Rule] = {}


def register(cls: type[Rule]) -> type[Rule]:
    """Class decorator adding a rule (by its ``name``) to the registry."""
    if not cls.name:
        raise ValueError(f"rule {cls.__name__} has no name")
    _REGISTRY[cls.name] = cls()
    return cls


def all_rules() -> dict[str, Rule]:
    from . import rules  # noqa: F401 — importing registers the rule set

    return dict(_REGISTRY)


# -- runner ----------------------------------------------------------------


def iter_py_files(paths: Iterable[str | Path]) -> list[Path]:
    """Expand path arguments to .py files. A path that names nothing —
    missing directory, missing file, or a file that is not .py — raises:
    a typo'd CI argument must fail the gate loudly, never lint an empty
    set and report 'ok'."""
    out: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(
                f for f in sorted(p.rglob("*.py"))
                if "__pycache__" not in f.parts
            )
        elif p.is_file() and p.suffix == ".py":
            out.append(p)
        else:
            raise FileNotFoundError(
                f"lint path {p} is neither a directory nor an existing "
                ".py file"
            )
    return out


def _suppressed(sf: SourceFile, finding: Finding) -> bool:
    """A finding is suppressed by a reasoned lint-allow for its rule on its
    own line or the line directly above (annotation-above style)."""
    for line in (finding.line, finding.line - 1):
        m = SUPPRESS_RE.search(sf.comment(line))
        if m and m.group(1) == finding.rule and m.group(2).strip():
            return True
    return False


def _suppression_hygiene(sf: SourceFile, known: set[str]) -> list[Finding]:
    """Malformed suppressions are findings themselves: a reason is
    mandatory, and the named rule must exist."""
    out = []
    for line, comment in sorted(sf.comments.items()):
        m = SUPPRESS_RE.search(comment)
        if not m:
            continue
        rule, reason = m.group(1), m.group(2).strip()
        if rule not in known:
            out.append(Finding(
                "suppression", sf.path, line,
                f"lint-allow names unknown rule {rule!r}",
            ))
        elif not reason:
            out.append(Finding(
                "suppression", sf.path, line,
                f"lint-allow[{rule}] has no reason — every suppression "
                "must say why the violation is intended",
            ))
    return out


def run_paths(
    paths: Iterable[str | Path],
    root: str | Path | None = None,
    rules: Iterable[str] | None = None,
) -> list[Finding]:
    """Run the (selected) rule set over ``paths``; project-scope rules run
    once against ``root`` (default: cwd). Returns surviving findings —
    suppressed ones are dropped, malformed suppressions are added."""
    registry = all_rules()
    if rules is not None:
        unknown = set(rules) - set(registry)
        if unknown:
            raise ValueError(f"unknown rule(s): {sorted(unknown)}")
        registry = {k: v for k, v in registry.items() if k in rules}
    known_names = set(all_rules())
    file_rules = [r for r in registry.values() if not r.project]
    project_rules = [r for r in registry.values() if r.project]

    findings: list[Finding] = []
    for path in iter_py_files(paths):
        try:
            sf = SourceFile.read(path)
        except SyntaxError as e:
            findings.append(Finding(
                "parse", str(path), e.lineno or 1, f"syntax error: {e.msg}"
            ))
            continue
        for rule in file_rules:
            for f in rule.check(sf):
                if not _suppressed(sf, f):
                    findings.append(f)
        findings.extend(_suppression_hygiene(sf, known_names))
    for rule in project_rules:
        findings.extend(rule.check_project(Path(root) if root else Path.cwd()))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def render_findings(findings: list[Finding], as_json: bool = False) -> str:
    if as_json:
        return json.dumps([f.to_dict() for f in findings], indent=2)
    if not findings:
        return "ok: no findings"
    lines = [f.render() for f in findings]
    lines.append(f"{len(findings)} finding(s)")
    return "\n".join(lines)
