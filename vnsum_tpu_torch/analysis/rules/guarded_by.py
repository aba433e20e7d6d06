"""guarded-by: annotated fields must only be touched under their lock.

Copy of ``vnsum_tpu/analysis/rules/guarded_by.py``.

The serving stack's shared state is documented today by prose ("everything
locks", cache/radix.py) — this rule turns the documentation into a check.
Annotate the field's assignment in ``__init__``::

    self._items: list = []          # guarded by: _cond, _lock
    self._queued_tokens = 0         # guarded by: _cond, _lock

and every ``self._items`` access anywhere else in the class must sit
lexically inside ``with self._cond:`` (or ``with self._lock:`` — a
comma-separated annotation lists every alias of the same underlying lock,
the RequestQueue's Condition-over-Lock pattern).

Two deliberate holes, both conventions this repo already uses:

- methods named ``*_locked`` (and ``__init__``/``__post_init__``) are
  exempt — they declare "caller holds the lock" in their name, which is
  exactly the contract the lint cannot see lexically;
- the check is self-scoped: a OTHER module reaching into
  ``obj.index.stats`` is invisible here (that is what the runtime
  lock-order sanitizer and the single-writer contracts are for).
"""
from __future__ import annotations

import ast
import re

from ..core import Finding, Rule, SourceFile, register

GUARD_RE = re.compile(r"#\s*guarded by:\s*([\w, ]+)")

_EXEMPT = {"__init__", "__post_init__"}


def _self_attr(node: ast.AST) -> str | None:
    """'x' for an ``self.x`` attribute node, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _guarded_fields(sf: SourceFile, cls: ast.ClassDef) -> dict[str, set[str]]:
    """field name -> allowed lock attribute names, from ``# guarded by:``
    comments on ``self.field = ...`` lines anywhere in the class."""
    fields: dict[str, set[str]] = {}
    for node in ast.walk(cls):
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        else:
            continue
        m = GUARD_RE.search(sf.comment(node.lineno)) or GUARD_RE.search(
            sf.comment(node.end_lineno or node.lineno)
        )
        if not m:
            continue
        locks = {part.strip() for part in m.group(1).split(",") if part.strip()}
        for t in targets:
            name = _self_attr(t)
            if name:
                fields[name] = locks
    return fields


def _under_lock(sf: SourceFile, node: ast.AST, locks: set[str]) -> bool:
    for anc in sf.ancestors(node):
        if isinstance(anc, (ast.With, ast.AsyncWith)):
            for item in anc.items:
                lock = _self_attr(item.context_expr)
                if lock in locks:
                    return True
    return False


def _enclosing_function(sf: SourceFile, node: ast.AST):
    for anc in sf.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


@register
class GuardedByRule(Rule):
    name = "guarded-by"
    description = (
        "fields annotated '# guarded by: <lock>' must only be accessed "
        "inside 'with self.<lock>:' (methods named *_locked are trusted "
        "to be called with the lock held)"
    )

    def check(self, sf: SourceFile) -> list[Finding]:
        out: list[Finding] = []
        for cls in ast.walk(sf.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            fields = _guarded_fields(sf, cls)
            if not fields:
                continue
            for node in ast.walk(cls):
                name = _self_attr(node)
                if name is None or name not in fields:
                    continue
                fn = _enclosing_function(sf, node)
                if fn is None or fn.name in _EXEMPT or fn.name.endswith("_locked"):
                    continue
                if _under_lock(sf, node, fields[name]):
                    continue
                locks = ", ".join(sorted(fields[name]))
                out.append(Finding(
                    self.name, sf.path, node.lineno,
                    f"self.{name} accessed in {cls.name}.{fn.name} outside "
                    f"'with self.{locks}' (annotated '# guarded by')",
                ))
        return out
