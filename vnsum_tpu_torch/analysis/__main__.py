"""CLI: ``python -m vnsum_tpu_torch.analysis [paths...]``.

Copy of ``vnsum_tpu/analysis/__main__.py``; the default path is the port's
package.

Exit 0 when clean, 1 when any finding survives suppression — the contract
CI's named ``analysis`` step and scripts/tier1.sh rely on. ``--json`` emits
machine-readable findings for tooling; ``--rule`` narrows to one rule while
iterating on a fix.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .core import all_rules, render_findings, run_paths


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vnsum_tpu_torch.analysis",
        description="domain lint for the vnsum_tpu_torch port",
    )
    ap.add_argument(
        "paths", nargs="*", default=["vnsum_tpu_torch"],
        help="files or directories to lint (default: vnsum_tpu_torch)",
    )
    ap.add_argument(
        "--root", default=None,
        help="repo root for project-scope rules like metrics-doc "
        "(default: cwd)",
    )
    ap.add_argument(
        "--rule", action="append", default=None,
        help="run only this rule (repeatable)",
    )
    ap.add_argument("--json", action="store_true", help="JSON findings")
    ap.add_argument(
        "--list-rules", action="store_true", help="list rules and exit"
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for name, rule in sorted(all_rules().items()):
            scope = "project" if rule.project else "file"
            print(f"{name:24s} [{scope}] {rule.description}")
        return 0

    try:
        findings = run_paths(
            args.paths, root=Path(args.root) if args.root else None,
            rules=args.rule,
        )
    except (FileNotFoundError, ValueError) as e:
        # bad path or unknown --rule: fail the gate loudly (distinct from
        # exit 1 = findings), never lint an empty set and report ok
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(render_findings(findings, as_json=args.json))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
