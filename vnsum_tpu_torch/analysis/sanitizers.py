"""Runtime sanitizer: lockdep-style lock-order detection.

Copy of the lock half of ``vnsum_tpu/analysis/sanitizers.py``. It is
**opt-in via the ``VNSUM_SANITIZERS`` env var** and constructed away when
off: :func:`make_lock` returns a plain ``threading.Lock`` (zero wrapper,
zero extra acquisitions). Values: ``1``/``all`` enables everything, or a
comma list holding ``lock``.

**Lock order.** Deadlocks in a queue -> scheduler -> engine -> cache stack
are ordering bugs long before they are hangs: thread A holds the queue lock
while touching metrics, thread B must never hold the metrics lock while
touching the queue. The detector wraps each serve/obs lock in a
:class:`TrackedLock` that records, per blocking acquisition, a wait-for
edge from every lock the thread already holds to the one it is acquiring
— lock *names* (one node per lock site, not per instance), which is the
class-level discipline lockdep checks. A new edge that closes a cycle
raises :class:`LockOrderError` at the acquisition that would introduce the
deadlock, with the cycle spelled out — BEFORE any thread actually hangs,
and regardless of whether the schedule that would hang ever fires.
Non-blocking probes (``acquire(blocking=False)``) add no edges: a trylock
cannot wait, so it cannot deadlock — and Condition's ``_is_owned`` probe
must not self-edge. The wrapper satisfies ``threading.Condition``'s lock
protocol, so the RequestQueue's Condition-over-Lock works unchanged.

The JAX package's hot-loop transfer guard is not ported (ROADMAP A14).
"""
from __future__ import annotations

import os
import threading

_FLAG = "VNSUM_SANITIZERS"


def _enabled(kind: str) -> bool:
    val = os.environ.get(_FLAG, "").strip()
    if not val or val == "0":
        return False
    if val in ("1", "all"):
        return True
    return kind in {p.strip() for p in val.split(",")}


def lock_sanitizer_enabled() -> bool:
    return _enabled("lock")


class LockOrderError(RuntimeError):
    """Acquiring this lock here closes a cycle in the wait-for graph."""


class LockGraph:
    """Global wait-for graph over lock names + per-thread held stacks."""

    def __init__(self) -> None:
        # meta-lock guarding the graph itself; never a TrackedLock (the
        # detector must not detect itself)
        self._mu = threading.Lock()
        self._edges: dict[str, set[str]] = {}
        self._local = threading.local()
        self.violations: list[str] = []

    def held(self) -> list[str]:
        st = getattr(self._local, "held", None)
        if st is None:
            st = self._local.held = []
        return st

    def _reaches_locked(self, src: str, dst: str) -> list[str] | None:
        """DFS path src -> dst over recorded edges, else None."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def note_blocking_acquire(self, name: str) -> None:
        """Record held->name edges; raise on the edge that closes a cycle.
        Called BEFORE blocking, so the violation reports at the acquisition
        that would introduce the deadlock instead of hanging in it. The
        offending edge is recorded anyway, so one inconsistent ordering
        reports once rather than re-raising forever in a retry loop."""
        held = self.held()
        if not held:
            return
        with self._mu:
            for h in held:
                if name in self._edges.get(h, ()):
                    continue
                path = self._reaches_locked(name, h) if h != name else [name]
                self._edges.setdefault(h, set()).add(name)
                if path is not None:
                    cycle = " -> ".join(path + [name])
                    msg = (
                        f"lock-order cycle: acquiring {name!r} while "
                        f"holding {h!r}, but an inverse ordering exists: "
                        f"{cycle}"
                    )
                    self.violations.append(msg)
                    raise LockOrderError(msg)

    def note_acquired(self, name: str) -> None:
        self.held().append(name)

    def note_released(self, name: str) -> None:
        held = self.held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    def edges(self) -> dict[str, set[str]]:
        with self._mu:
            return {k: set(v) for k, v in self._edges.items()}

    def reset(self) -> None:
        """Clear graph + violations in place (tests) — existing TrackedLock
        instances keep pointing at this graph, so clearing must not swap
        the object."""
        with self._mu:
            self._edges.clear()
            self.violations.clear()


_GRAPH = LockGraph()


def lock_graph() -> LockGraph:
    return _GRAPH


class TrackedLock:
    """threading.Lock wrapper feeding the wait-for graph.

    Condition-compatible: ``threading.Condition(TrackedLock(...))`` works —
    Condition's release/re-acquire in ``wait()`` flows through this wrapper
    and keeps the held stack honest, and its ``_is_owned`` fallback probes
    with ``acquire(False)``, which records no edge (trylocks cannot wait).
    """

    __slots__ = ("name", "_graph", "_inner", "acquisitions")

    def __init__(self, name: str, graph: LockGraph | None = None) -> None:
        self.name = name
        self._graph = graph or _GRAPH
        self._inner = threading.Lock()
        self.acquisitions = 0  # incremented while holding — consistent

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking:
            self._graph.note_blocking_acquire(self.name)  # may raise
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._graph.note_acquired(self.name)
            self.acquisitions += 1
        return got

    def release(self) -> None:
        self._inner.release()
        self._graph.note_released(self.name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


def make_lock(name: str) -> "threading.Lock | TrackedLock":
    """THE lock constructor for serve/cache/obs shared state. Plain
    ``threading.Lock`` unless the lock sanitizer is enabled — the disabled
    path adds nothing to acquire/release (no wrapper exists at all)."""
    if not lock_sanitizer_enabled():
        return threading.Lock()
    return TrackedLock(name, _GRAPH)


def lock_order_violations() -> list[str]:
    return list(_GRAPH.violations)
