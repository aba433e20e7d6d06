"""metric-label-cardinality: dynamic metric labels in serve/ must be
bounded.

Copy of ``vnsum_tpu/analysis/rules/label_cardinality.py``; its scope points at
``vnsum_tpu_torch/``.

A Prometheus metric family's cost is its label cardinality, and a label
value interpolated from request state (a tenant name, an arbitrary id) is
an unbounded-cardinality bug: a hostile caller cycling names grows the
scrape, the dashboards, and every downstream TSDB without limit. The
serving layer's answer is the capped :class:`~vnsum_tpu_torch.serve.usage.
TenantLabelRegistry` — ``canonical(name)`` sanitizes and collapses
past-the-cap names into the ``other`` overflow label — and this rule makes
routing through it mandatory rather than conventional.

Mechanically: in ``vnsum_tpu_torch/serve/``, every f-string that emits a label
value (a literal chunk ending ``<label>="`` immediately followed by an
interpolation — the repo's one metric-emission idiom) must interpolate a
BOUNDED expression:

- a call to ``canonical(...)`` (the registry helper, however reached);
- an enum's ``.value`` (the label set is the enum — bounded by the type);
- a loop variable iterating a literal tuple/list of constants (the label
  set is spelled out at the emission site).

Anything else — a raw name, a dict key, request state — is a finding:
route it through the registry or carry a reasoned
``# lint-allow[metric-label-cardinality]`` explaining why the value set is
bounded (the SLO gauges do exactly this: objective names are parse-time-
validated config tokens).

``worker=`` labels (the fleet router/federation series) are held to the
STRICT form: only a ``canonical(...)`` call qualifies. The worker label
set is the roster registry seeded at router construction; an enum or a
literal loop cannot prove an emission site agrees with that roster, and a
respawn/rename drifting off it must collapse into ``other``, not mint a
series.
"""
from __future__ import annotations

import ast
import re

from ..core import Finding, Rule, SourceFile, register

_SCOPE_RE = re.compile(r"(^|/)vnsum_tpu_torch/serve/")
# a literal f-string chunk that opens a label value: ...{label="
_LABEL_OPEN_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="$')


def _canonical_call(expr: ast.expr) -> bool:
    """Is ``expr`` a call to the registry helper —
    ``<anything>.canonical(...)`` / ``canonical(...)``?"""
    if isinstance(expr, ast.Call):
        func = expr.func
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else None
        )
        return name == "canonical"
    return False


def _bounded(sf: SourceFile, fstr: ast.JoinedStr, expr: ast.expr) -> bool:
    """Is the interpolated label value drawn from a bounded set?"""
    if _canonical_call(expr):
        return True
    # enum idiom: `for reason in ShedReason: ... {reason.value}` — the
    # label set is the enum's members
    if isinstance(expr, ast.Attribute) and expr.attr == "value":
        return True
    # literal loop: `for stage in ("queued", "resident"): ... {stage}`
    if isinstance(expr, ast.Name):
        for anc in sf.ancestors(fstr):
            if (
                isinstance(anc, ast.For)
                and isinstance(anc.target, ast.Name)
                and anc.target.id == expr.id
                and isinstance(anc.iter, (ast.Tuple, ast.List))
                and all(isinstance(e, ast.Constant) for e in anc.iter.elts)
            ):
                return True
    return False


@register
class LabelCardinalityRule(Rule):
    name = "metric-label-cardinality"
    description = (
        "in serve/, f-string metric label values (literal ending '<label>=\"' "
        "followed by an interpolation) must be bounded: the capped "
        "TenantLabelRegistry.canonical(...), an enum .value, or a literal "
        "loop variable"
    )

    def check(self, sf: SourceFile) -> list[Finding]:
        if not _SCOPE_RE.search(sf.path.replace("\\", "/")):
            return []
        out: list[Finding] = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.JoinedStr):
                continue
            parts = node.values
            for i, part in enumerate(parts[:-1]):
                nxt = parts[i + 1]
                if not (
                    isinstance(part, ast.Constant)
                    and isinstance(part.value, str)
                    and isinstance(nxt, ast.FormattedValue)
                ):
                    continue
                m = _LABEL_OPEN_RE.search(part.value)
                if m is None:
                    continue
                if m.group(1) == "worker":
                    # fleet worker labels: ONLY the roster registry's
                    # canonical(...) proves agreement with the bounded
                    # worker set — enum/literal-loop escapes don't
                    if _canonical_call(nxt.value):
                        continue
                    out.append(Finding(
                        self.name, sf.path, nxt.value.lineno,
                        'metric label worker="..." must interpolate a '
                        "canonical(...) call on the bounded worker-roster "
                        "registry (enum values and literal loops do not "
                        "qualify for fleet worker labels)",
                    ))
                    continue
                if _bounded(sf, node, nxt.value):
                    continue
                out.append(Finding(
                    self.name, sf.path, nxt.value.lineno,
                    f'metric label {m.group(1)}="..." interpolates an '
                    "unbounded value — route it through the capped "
                    "TenantLabelRegistry.canonical(...) (or lint-allow "
                    "with the reason the value set is bounded)",
                ))
        return out
