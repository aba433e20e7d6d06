"""unbounded-blocking-wait: no timeout-less blocking waits in serve/.

Copy of ``vnsum_tpu/analysis/rules/unbounded_wait.py``; its scope points at
``vnsum_tpu_torch/``.

The watchdog (serve/watchdog.py) can detect a wedged thread, but the better
outcome is a thread that cannot wedge FOREVER in the first place: every
blocking primitive in the serving stack must carry a timeout so the waiting
loop periodically regains control — to beat its heartbeat, observe a close
flag, or shed expired work. A timeout-less ``Condition.wait()`` /
``Event.wait()`` / ``Future.result()`` / ``Queue.get()`` is the exact shape
of every historical serving wedge (a lost ``notify``, a future nobody
resolves, a producer that died), and none of them is observable from
outside without ``sys._current_frames`` spelunking.

The rule flags calls of those four names with no timeout — zero arguments,
an explicit ``timeout=None``, or a lone positional ``None``.
``dict.get(key)`` never matches (its argument is a key, not None);
``wait(0.1)`` / ``result(timeout=5)`` / ``get(timeout=...)`` pass. The few legitimate sites — an HTTP handler thread blocking on its
own request future, whose resolution every scheduler path guarantees —
carry reasoned ``# lint-allow[unbounded-blocking-wait]`` suppressions: the
point is that every new indefinite wait is a written-down decision, not an
accident the watchdog gets to meet in production.

Scope is ``vnsum_tpu_torch/serve/`` — the package whose threads the liveness
contract covers; backends block inside device runtimes the lint cannot see
anyway, and offline pipeline code answers to its own timeouts.
"""
from __future__ import annotations

import ast
import re

from ..core import Finding, Rule, SourceFile, register

_SCOPE_RE = re.compile(r"(^|/)vnsum_tpu_torch/serve/")

# the blocking-primitive method names the liveness contract bans bare
_BLOCKING_ATTRS = ("wait", "result", "get")


@register
class UnboundedBlockingWaitRule(Rule):
    name = "unbounded-blocking-wait"
    description = (
        "in serve/, Condition.wait() / Event.wait() / Future.result() / "
        "Queue.get() without a timeout can wedge a serving thread forever "
        "— pass a timeout (loop if you must wait indefinitely) or "
        "lint-allow with the reason the wait is externally bounded"
    )

    def check(self, sf: SourceFile) -> list[Finding]:
        if not _SCOPE_RE.search(sf.path.replace("\\", "/")):
            return []
        out: list[Finding] = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not isinstance(func, ast.Attribute):
                continue
            if func.attr not in _BLOCKING_ATTRS:
                continue
            if node.args and not (
                len(node.args) == 1 and _is_none(node.args[0])
            ):
                # a positional arg is the timeout for wait()/result(), and
                # rules dict.get(key)/kwargs.get(k, d) out entirely — but a
                # lone positional None (ev.wait(None)) is spelled-out
                # unboundedness, same as timeout=None
                continue
            if any(kw.arg == "timeout" and not _is_none(kw.value)
                   for kw in node.keywords):
                continue
            out.append(Finding(
                self.name, sf.path, node.lineno,
                f".{func.attr}() with no timeout blocks its thread "
                "indefinitely — a lost notify / unresolved future wedges "
                "serving silently; bound the wait (loop on a timeout) or "
                "lint-allow with the reason it is externally bounded",
            ))
        return out


def _is_none(value: ast.expr) -> bool:
    """``timeout=None`` is spelled-out unboundedness, not a bound."""
    return isinstance(value, ast.Constant) and value.value is None
