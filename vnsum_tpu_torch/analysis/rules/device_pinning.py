"""device-pinning: no hard-coded card-0 placement in backend/ or cache/.

Counterpart of ``vnsum_tpu/analysis/rules/device_pinning.py`` for torch.
The bug class: engine- or cache-path state pinned to the first card (a
literal ``"cuda:0"``, ``torch.device("cuda", 0)``, a bare ``.cuda()``, or
``torch.cuda.set_device(0)``) silently anchors it on one card, so a
process given another card (a fleet worker, a rank of a sequence group)
either copies across cards on every step or fails on a device mismatch.
Placement in those trees follows the device the caller gave the engine
(``resolve_device``) or a tensor's own ``.device``.

Flagged:

- the string literal ``"cuda:0"`` anywhere in the file;
- ``torch.device("cuda", 0)`` (a literal index 0, positional or
  ``index=0``);
- ``.cuda()`` with no device argument (the current card, whichever that
  is);
- ``torch.cuda.set_device(0)`` (a literal 0).

Scoped to path components named ``backend`` or ``cache``, as the JAX rule
is. Intended pins carry a reasoned
``# lint-allow[device-pinning]: <why this placement is single-card>``.
"""
from __future__ import annotations

import ast
from pathlib import Path

from ..core import Finding, Rule, SourceFile, register

_SCOPE_PARTS = {"backend", "cache"}


def _in_scope(path: str) -> bool:
    return bool(_SCOPE_PARTS.intersection(Path(path).parts))


def _is_zero(node: ast.AST | None) -> bool:
    return isinstance(node, ast.Constant) and node.value == 0 and node.value is not False


def _attr_chain(node: ast.AST) -> str:
    """'torch.cuda.set_device' for the attribute chain, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _pin(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and node.value == "cuda:0":
        return '"cuda:0"'
    if not isinstance(node, ast.Call):
        return None
    name = _attr_chain(node.func)
    kw = {k.arg: k.value for k in node.keywords}
    if name in ("torch.device", "device"):
        first = node.args[0] if node.args else kw.get("type")
        index = node.args[1] if len(node.args) > 1 else kw.get("index")
        if isinstance(first, ast.Constant) and first.value == "cuda" and _is_zero(index):
            return 'torch.device("cuda", 0)'
    if name in ("torch.cuda.set_device", "cuda.set_device"):
        arg = node.args[0] if node.args else kw.get("device")
        if _is_zero(arg):
            return "torch.cuda.set_device(0)"
    if (isinstance(node.func, ast.Attribute) and node.func.attr == "cuda"
            and not node.args and "device" not in kw):
        return ".cuda()"
    return None


@register
class DevicePinningRule(Rule):
    name = "device-pinning"
    description = (
        '"cuda:0", torch.device("cuda", 0), a bare .cuda() and '
        "torch.cuda.set_device(0) pin state to the first card — banned in "
        "backend/ and cache/; place on the engine's device or a reasoned "
        "lint-allow instead"
    )

    def check(self, sf: SourceFile) -> list[Finding]:
        if not _in_scope(sf.path):
            return []
        out: list[Finding] = []
        for node in ast.walk(sf.tree):
            what = _pin(node)
            if what is not None:
                out.append(Finding(
                    self.name, sf.path, node.lineno,
                    f"{what} hard-pins the first card — place engine/cache "
                    "state on the engine's device (resolve_device) or a "
                    "tensor's own .device",
                ))
        return out
