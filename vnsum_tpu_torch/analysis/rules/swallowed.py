"""swallowed-exception: no silently-dropped errors in serve/ and backend/.

Copy of ``vnsum_tpu/analysis/rules/swallowed.py``; its scope points at
``vnsum_tpu_torch/``.

The serving stack's cardinal failure mode is a future nobody resolves: a
caller blocks on ``result()`` forever while ``/healthz`` keeps reporting ok.
Every ``except`` handler in ``vnsum_tpu_torch/serve/`` and
``vnsum_tpu_torch/backend/`` must therefore visibly do one of three things
with the error:

- **re-raise** (any ``raise`` statement in the handler body);
- **resolve a future / answer the caller** — a call to ``set_exception`` /
  ``set_result``, a delegation to a resolver helper (terminal call name
  starting with ``_resolve``, ``_fail``, or ``_shed`` — the scheduler's
  convention), or the HTTP layer's typed error response ``self._json(...)``
  (responding IS resolving for a handler thread);
- **return a value** (``return expr`` — an explicit fallback result, e.g.
  the HF chat-template retry without ``enable_thinking``).

Anything else — ``pass``, a bare log-and-continue, an assignment — needs a
``# lint-allow[swallowed-exception]: reason`` on the ``except`` line or the
line above. The two historical log-and-continue handlers in
serve/scheduler.py carry exactly such reasons; the point of the rule is
that every NEW swallow is a written-down decision, not an accident.

Scope is deliberately the two packages where a dropped error strands a
future or a device batch; strategies/eval/pipeline code answers to the
pipeline's own failure accounting instead.
"""
from __future__ import annotations

import ast
import re

from ..core import Finding, Rule, SourceFile, register

_SCOPE_RE = re.compile(r"(^|/)vnsum_tpu_torch/(serve|backend)/")

_RESOLVER_CALLS = {"set_exception", "set_result", "_json"}
_RESOLVER_PREFIXES = ("_resolve", "_fail", "_shed")


def _terminal_name(func: ast.expr) -> str | None:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _handler_resolves(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Return) and node.value is not None:
            return True
        if isinstance(node, ast.Call):
            name = _terminal_name(node.func)
            if name is None:
                continue
            if name in _RESOLVER_CALLS or name.startswith(_RESOLVER_PREFIXES):
                return True
    return False


@register
class SwallowedExceptionRule(Rule):
    name = "swallowed-exception"
    description = (
        "in serve/ and backend/, an except handler must re-raise, resolve "
        "a future (set_exception/set_result/_resolve*/_fail*/_shed*/_json), "
        "or return a value — otherwise it needs a reasoned lint-allow"
    )

    def check(self, sf: SourceFile) -> list[Finding]:
        if not _SCOPE_RE.search(sf.path.replace("\\", "/")):
            return []
        out: list[Finding] = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if _handler_resolves(node):
                continue
            what = (
                ast.unparse(node.type) if node.type is not None else "bare"
            )
            out.append(Finding(
                self.name, sf.path, node.lineno,
                f"except {what} neither re-raises, resolves a future, nor "
                "returns a value — a swallowed error can strand callers on "
                "futures forever; handle it or lint-allow with the reason",
            ))
        return out
