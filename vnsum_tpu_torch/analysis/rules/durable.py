"""durable-write: ``# durable``-marked functions must do the full
crash-safe write sequence.

Copy of ``vnsum_tpu/analysis/rules/durable.py``.

The repo's durability story (serve/journal.py compaction, core/artifacts.py
atomic artifact writes) rests on one idiom: write the complete new content
to a temp file, ``flush()`` it, ``os.fsync()`` it, then ``os.replace()`` it
over the target — any shortcut reintroduces the torn-file failure mode the
idiom exists to kill (a flush-less fsync syncs an empty kernel buffer; a
replace-less write leaves the partial temp as the target on the next crash;
an fsync-less replace can surface a zero-length file after power loss).

The marker is the contract: a function whose ``def`` line (or the line
directly above it) carries a ``# durable`` comment claims crash-atomicity,
and this rule verifies the claim structurally — the body (including nested
functions it defines, not functions it merely calls) must contain all four
operations:

- a ``.write(...)``/``.writelines(...)`` call (the content),
- a ``.flush(...)`` call (user-space buffer -> kernel),
- an ``fsync(...)`` call (kernel -> disk),
- a ``replace(...)`` call (atomic rename over the target).

Helpers that implement only part of the sequence (an append-only journal
segment never renames) simply don't take the marker; callers that delegate
to a marked helper (e.g. ``atomic_write_json``) don't need one either —
the marker belongs on the function that OWNS the sequence.
"""
from __future__ import annotations

import ast

from ..core import Finding, Rule, SourceFile, register

_MARK = "durable"
_NEEDED = {
    "write": ("write", "writelines"),
    "flush": ("flush",),
    "fsync": ("fsync",),
    "os.replace": ("replace",),
}


def _call_names(fn: ast.AST):
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute):
                yield node.func.attr
            elif isinstance(node.func, ast.Name):
                yield node.func.id


def _is_marked(sf: SourceFile, fn) -> bool:
    for line in (fn.lineno, fn.lineno - 1):
        comment = sf.comment(line)
        # exact word "durable": "# durable" / "# durable: <note>" mark; a
        # prose comment merely mentioning durability does not
        if comment and _MARK in comment.replace("#", " ").split(":")[0].split():
            return True
    return False


@register
class DurableWriteRule(Rule):
    name = "durable-write"
    description = (
        "a '# durable'-marked function must pair write + flush + fsync + "
        "os.replace — the full crash-atomic file-replace sequence"
    )

    def check(self, sf: SourceFile) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not _is_marked(sf, node):
                continue
            seen = set(_call_names(node))
            missing = [
                label for label, names in _NEEDED.items()
                if not any(n in seen for n in names)
            ]
            if missing:
                out.append(Finding(
                    self.name, sf.path, node.lineno,
                    f"'# durable' function {node.name} is missing "
                    f"{', '.join(missing)} — without the full write/flush/"
                    "fsync/os.replace sequence a crash can leave a torn or "
                    "empty file",
                ))
        return out
