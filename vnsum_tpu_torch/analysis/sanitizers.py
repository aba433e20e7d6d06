"""Runtime sanitizers: lockdep-style lock-order detection + transfer guard.

Copy of ``vnsum_tpu/analysis/sanitizers.py``, its transfer guard rebuilt on
CUDA's sync debug mode. Both are **opt-in via the ``VNSUM_SANITIZERS`` env
var** and constructed away when off: :func:`make_lock` returns a plain
``threading.Lock`` (zero wrapper, zero extra acquisitions) and
:func:`hot_path_transfer_guard` a ``nullcontext``. Values: ``1``/``all``
enables everything, or a comma list of ``lock`` / ``transfer``.

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

**Transfer guard.** The static half of the hot-loop contract is the
``host-sync-in-hot-path`` lint (every acknowledged sync is an explicit
:func:`device_get` or :func:`device_sync` carrying a reasoned suppression);
this is the runtime half. :func:`hot_path_transfer_guard` wraps the
engine's dispatch loops (``generate``, ``score_choices``, the slot loop's
``admit`` and ``step``) in ``torch.cuda.set_sync_debug_mode("error")``, so
any *implicit* sync with the card (a stray ``.item()``, ``.cpu()`` or
``bool(tensor)``, a host-to-device copy from pageable memory) raises instead
of silently serializing the pipeline, while :func:`device_get` and
:func:`device_sync` switch the check off around the one read or sync they
make. It differs from the JAX guard in three ways:

- CUDA's mode is one setting of the process, not of a thread: while any
  guard is open every thread's syncs raise (the server's HTTP threads
  included), and while any acknowledged read runs none do. The guards and
  reads count themselves under one lock, the first guard to open saves the
  mode and the last to close puts it back, on exceptions too;
- it covers host-to-device copies as well, which CUDA makes synchronous
  from pageable memory: the port's uploads of host arrays go through
  :func:`to_device`, a copy that does not block the host;
- it arms only for a CUDA device. On the CPU there is nothing to sync with
  and the guard is a ``nullcontext``; the CPU tests hold the guarded paths
  to the unguarded ones and check the mode's bookkeeping with the setter
  replaced.

A CUDA graph's recording runs under an acknowledged section
(:func:`acknowledged`): CUDA refuses every sync inside a capture whatever
the mode, the mode is host-side state that changes nothing recorded, and
``torch.cuda.graph`` synchronizes the device before it begins.
"""
from __future__ import annotations

import contextlib
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


def transfer_sanitizer_enabled() -> bool:
    return _enabled("transfer")


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


# -- transfer guard ----------------------------------------------------------

# the counts of every thread's open guards and running acknowledged reads,
# and the mode the first guard found: read and written under _SYNC_LOCK
_SYNC_LOCK = threading.Lock()
_guards = 0
_reads = 0
_saved_mode = 0


def _apply_mode_locked() -> None:
    import torch

    torch.cuda.set_sync_debug_mode("error" if _guards and not _reads else _saved_mode)


class _TransferGuard:
    """One open transfer guard (see :func:`hot_path_transfer_guard`)."""

    __slots__ = ()

    def __enter__(self) -> "_TransferGuard":
        global _guards, _saved_mode
        import torch

        with _SYNC_LOCK:
            if _guards == 0:
                _saved_mode = torch.cuda.get_sync_debug_mode()
            _guards += 1
            _apply_mode_locked()
        return self

    def __exit__(self, *exc) -> None:
        global _guards
        with _SYNC_LOCK:
            _guards -= 1
            _apply_mode_locked()


def hot_path_transfer_guard(device):
    """Context manager for the engine's dispatch loops on ``device``:
    ``nullcontext`` normally and on the CPU; under the transfer sanitizer on
    a CUDA device, implicit syncs with the card raise while the
    acknowledged ones (:func:`device_get`, :func:`device_sync`) pass."""
    if not transfer_sanitizer_enabled() or getattr(device, "type", device) != "cuda":
        return contextlib.nullcontext()
    return _TransferGuard()


@contextlib.contextmanager
def acknowledged():
    """The guard's check off for the enclosed block, in every thread; a
    no-op while no guard is open."""
    global _reads
    if not _guards:
        yield
        return
    with _SYNC_LOCK:
        _reads += 1
        _apply_mode_locked()
    try:
        yield
    finally:
        with _SYNC_LOCK:
            _reads -= 1
            _apply_mode_locked()


def device_get(x):
    """The acknowledged device-to-host read, counterpart of
    ``jax.device_get``: a tensor comes back as a numpy array (``.cpu()
    .numpy()``), a tuple or list of tensors as a tuple of them. It syncs
    with the card, and under the transfer guard it is the sync that
    passes."""
    with acknowledged():
        if isinstance(x, (tuple, list)):
            return tuple(t.cpu().numpy() for t in x)
        return x.cpu().numpy()


def device_sync(device) -> None:
    """``torch.cuda.synchronize(device)`` as an acknowledged sync; nothing
    on the CPU."""
    if getattr(device, "type", device) != "cuda":
        return
    import torch

    with acknowledged():
        torch.cuda.synchronize(device)


def to_device(array, device):
    """A host numpy array as a tensor on ``device``, copied without blocking
    the host: CUDA stages a pageable source before the call returns, so the
    array may be reused at once, and the copy is ordered on the current
    stream before every later kernel that reads it. Under the transfer
    guard this upload passes, where a blocking ``.to(device)`` from pageable
    memory is a sync and raises."""
    import torch

    return torch.from_numpy(array).to(device, non_blocking=True)
