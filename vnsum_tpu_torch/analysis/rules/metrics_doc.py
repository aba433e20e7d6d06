"""metrics-doc: serve/metrics.py registry <-> README table, bidirectionally.

Copy of ``vnsum_tpu/analysis/rules/metrics_doc.py``, pointed at
``vnsum_tpu_torch/serve/metrics.py``. It reads the same README table as the
JAX package's rule, and that table also names metrics whose modules the
port does not have yet: those are :data:`NOT_PORTED`, each with the reason
(the ROADMAP item that ports it). A README name in it is not a finding; a
name in it that the port's registry does register is one, so the exemption
goes when the metric comes.

Absorbs scripts/check_metrics_doc.py (the script survives as a thin shim so
CI history stays comparable) and extends it: beyond "every registered metric
is documented", every ``vnsum_serve_*`` name the README mentions must match
a registered metric — a renamed or deleted metric can no longer leave a
stale row behind. Histogram series suffixes (``_bucket``/``_sum``/
``_count``) are accepted for registered histograms, since that is what the
Prometheus text format actually exports.

Like its predecessor this PARSES source (the registry keeps literal string
names in ``_reg("...")`` calls exactly for this), so it runs before
dependencies are installed and cannot be skewed by import-time failures.
Project-scope rule: runs once per invocation against the repo root, and
skips silently when the root has no serve/metrics.py (fixture trees).
"""
from __future__ import annotations

import re
from pathlib import Path

from ..core import Finding, Rule, register

_REG = re.compile(r'_reg\(\s*"([a-z0-9_]+)",\s*"([a-z]+)"')
_README_NAME = re.compile(r"vnsum_serve_([a-z0-9_]+)")
_PREFIX = "vnsum_serve_"
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")

METRICS_REL = Path("vnsum_tpu_torch") / "serve" / "metrics.py"
README_REL = Path("README.md")

# README metric names (short, without the prefix) the port's registry does
# not hold yet, each with why
NOT_PORTED = {
    name: "the serving mesh (ROADMAP A10): the port's server runs one card"
    for name in ("mesh_devices", "mesh_data_parallel", "mesh_model_parallel",
                 "mesh_replica_occupancy")
}


def registered_metrics(metrics_py: Path) -> dict[str, tuple[str, int]]:
    """short name -> (type, line) parsed from the _reg registry block."""
    out: dict[str, tuple[str, int]] = {}
    for i, line in enumerate(
        metrics_py.read_text(encoding="utf-8").splitlines(), start=1
    ):
        m = _REG.search(line)
        if m:
            out[m.group(1)] = (m.group(2), i)
    return out


@register
class MetricsDocRule(Rule):
    name = "metrics-doc"
    description = (
        "every metric registered in serve/metrics.py appears in README.md "
        "and every vnsum_serve_* name in README.md is a registered metric"
    )
    project = True

    def check_project(self, root: Path) -> list[Finding]:
        metrics_py = root / METRICS_REL
        readme = root / README_REL
        if not metrics_py.is_file() or not readme.is_file():
            return []  # fixture tree or partial checkout: nothing to check
        registry = registered_metrics(metrics_py)
        if not registry:
            return [Finding(
                self.name, str(metrics_py), 1,
                'no _reg("...") registrations found — registry moved? '
                "update analysis/rules/metrics_doc.py",
            )]
        readme_text = readme.read_text(encoding="utf-8")

        out: list[Finding] = []
        for short, (_typ, line) in registry.items():
            if _PREFIX + short not in readme_text:
                out.append(Finding(
                    self.name, str(metrics_py), line,
                    f"registered metric {_PREFIX}{short} is missing from "
                    "the README observability table",
                ))

        for short in sorted(NOT_PORTED.keys() & registry.keys()):
            out.append(Finding(
                self.name, str(metrics_py), registry[short][1],
                f"{_PREFIX}{short} is registered now: drop its NOT_PORTED "
                "exemption in analysis/rules/metrics_doc.py",
            ))

        def known(short: str) -> bool:
            if short in registry or short in NOT_PORTED:
                return True
            for suf in _HIST_SUFFIXES:
                base = short.removesuffix(suf)
                if short.endswith(suf) and registry.get(base, ("",))[0] == "histogram":
                    return True
            return False

        for i, line_text in enumerate(readme_text.splitlines(), start=1):
            for m in _README_NAME.finditer(line_text):
                if not known(m.group(1)):
                    out.append(Finding(
                        self.name, str(readme), i,
                        f"README mentions {_PREFIX}{m.group(1)} but no such "
                        "metric is registered in serve/metrics.py",
                    ))
        return out
