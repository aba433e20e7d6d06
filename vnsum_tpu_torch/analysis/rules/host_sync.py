"""host-sync-in-hot-path: no host<->device syncs inside marked hot loops.

Counterpart of ``vnsum_tpu/analysis/rules/host_sync.py`` for torch. A
``.item()``, ``.cpu()`` or ``bool(tensor)`` inside the engine's
decode/prefill loops forces the host to wait on the card — the per-step
stall PERF.md's measurements fight, and the silent way a refactor turns an
asynchronous launch queue into lockstep. Functions whose ``def`` line (or
the line directly above it) carries a ``# hot path`` comment are scanned;
every sync-shaped call inside must either go away or carry a
``# lint-allow[host-sync-in-hot-path]: <why this sync is load-bearing>``.

Sync-shaped, in torch's words:

- the method calls ``.item()``, ``.cpu()``, ``.tolist()`` and ``.numpy()``;
- ``np.asarray`` / ``numpy.asarray``;
- ``bool(...)``, ``int(...)`` and ``float(...)`` on a tensor expression,
  read as an argument that holds a reduction-shaped method call
  (``.all()``, ``.any()``, ``.sum()``, ``.max()`` ...): the implicit read
  ``if done.all():`` makes too;
- ``torch.cuda.synchronize`` and the acknowledged helpers
  ``device_get`` / ``device_sync`` (analysis/sanitizers.py), the
  counterparts of ``jax.device_get``.

The ban is textual, not semantic: ``.numpy()`` on a CPU tensor or
``int(x.sum())`` on a numpy array is no sync, but it reads identically to
one in review — the suppression reason is where the difference gets
written down. Intended reads go through ``device_get`` (suppressed with
their reason): the runtime half of this check,
``sanitizers.hot_path_transfer_guard``, raises on *implicit* syncs with
the card under ``VNSUM_SANITIZERS=transfer``, so acknowledged reads pass
the guard and unacknowledged ones fail it.
"""
from __future__ import annotations

import ast
import re

from ..core import Finding, Rule, SourceFile, register

HOT_RE = re.compile(r"#\s*hot path\b")

# attribute-call names that always read as a sync
_ATTR_CALLS = {"item", "cpu", "tolist", "numpy"}
# (module alias, function) calls
_FN_CALLS = {("np", "asarray"), ("numpy", "asarray")}
# the acknowledged helpers, bare or through a module
_HELPERS = {"device_get", "device_sync"}
# casts that read a tensor's value on the host
_CASTS = {"bool", "int", "float"}
# method calls that make their receiver's result a tensor expression
_TENSOR_METHODS = {
    "all", "any", "sum", "max", "min", "argmax", "argmin", "mean", "prod",
    "count_nonzero", "norm", "eq", "ne", "le", "lt", "ge", "gt",
}


def _is_hot(sf: SourceFile, fn: ast.FunctionDef | ast.AsyncFunctionDef) -> bool:
    for line in (fn.lineno, fn.lineno - 1):
        if HOT_RE.search(sf.comment(line)):
            return True
    return False


def _tensor_expression(node: ast.expr) -> bool:
    return any(
        isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
        and n.func.attr in _TENSOR_METHODS
        for n in ast.walk(node)
    )


def _is_cuda_synchronize(f: ast.Attribute) -> bool:
    """``torch.cuda.synchronize`` / ``cuda.synchronize``."""
    v = f.value
    return f.attr == "synchronize" and (
        (isinstance(v, ast.Name) and v.id == "cuda")
        or (isinstance(v, ast.Attribute) and v.attr == "cuda")
    )


def _sync_call(node: ast.Call) -> str | None:
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr in _ATTR_CALLS:
            return f".{f.attr}()"
        if f.attr in _HELPERS:
            return f"{f.attr}()"
        if _is_cuda_synchronize(f):
            return "torch.cuda.synchronize()"
        if isinstance(f.value, ast.Name) and (f.value.id, f.attr) in _FN_CALLS:
            return f"{f.value.id}.{f.attr}()"
    elif isinstance(f, ast.Name):
        if f.id in _HELPERS:
            return f"{f.id}()"
        if f.id in _CASTS and len(node.args) == 1 and _tensor_expression(node.args[0]):
            return f"{f.id}(<tensor>)"
    return None


@register
class HostSyncRule(Rule):
    name = "host-sync-in-hot-path"
    description = (
        ".item()/.cpu()/.tolist()/.numpy()/np.asarray, bool()/int()/float() "
        "of a tensor expression, torch.cuda.synchronize and the "
        "device_get/device_sync helpers are banned inside functions marked "
        "'# hot path'; intended syncs carry a reasoned lint-allow"
    )

    def check(self, sf: SourceFile) -> list[Finding]:
        out: list[Finding] = []
        for fn in ast.walk(sf.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not _is_hot(sf, fn):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                what = _sync_call(node)
                if what is not None:
                    out.append(Finding(
                        self.name, sf.path, node.lineno,
                        f"{what} inside hot-path function {fn.name!r} — "
                        "remove the sync or lint-allow it with the reason "
                        "it is load-bearing",
                    ))
        return out
