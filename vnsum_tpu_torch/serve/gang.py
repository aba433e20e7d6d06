"""Structured jobs: gang-scheduled fan-out over the serving stack.

The paper's strategies are multi-request FAN-OUTS — a map-reduce summarize
splits one document into dozens of chunk prompts, the hierarchical strategy
into a whole tree of them. This module makes the group a first-class
object:

- **Gang admission** — :meth:`MicroBatchScheduler.admit_gang` opens a
  :class:`GangHandle` after ONE pass through the existing request-level
  admission gate (depth / token budget / brownout), and every internal
  submit that rides the handle's gang id is admission-exempt
  (``force=True``), exactly the contract the summarize path always had.
- **Affinity** — queue take paths cluster same-gang rows into one slot
  generation (queue.py::_compat_locked): siblings share the template-header
  prefix by construction, so co-scheduling them is the strategy-aware half
  of KV reuse (survey arXiv 2405.13019 §KV-cache reuse) — the radix cache
  can only skip a prefix that is WARM when the row prefills.
- **Degraded results** — a member failing typed POISON no longer silently
  fails just that child: the reduce proceeds over the survivors and the
  gang is marked ``partial``, so the summarize reply tells a degraded
  summary from a complete one.

Threading: one internal lock (``make_lock("serve.gang")``) guarding the
group table. It is held only around table mutations — metrics calls happen
OUTSIDE it, so the lock-order graph gains exactly one edge (callers ->
serve.gang).

Counterpart of ``vnsum_tpu/serve/gang.py`` without its journal records
(membership flushes, startup restore), which come with durable serving
(ROADMAP A15b), and without its tenant preemption.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..analysis.sanitizers import make_lock
from ..core.logging import get_logger

logger = get_logger("vnsum.serve.gang")


@dataclass
class _Gang:
    """One live structured job's group state."""

    gang_id: str
    # fan-out children admitted into the group so far
    member_count: int = 0
    partial: bool = False


class GangHandle:
    """The admitted-fan-out token an entry point holds for one structured
    job: carries the gang id its internal submits ride, and finishes the
    group when the request terminally resolves (whatever the outcome)."""

    __slots__ = ("registry", "gang_id")

    def __init__(self, registry: "GangRegistry", gang_id: str) -> None:
        self.registry = registry
        self.gang_id = gang_id

    def finish(self) -> None:
        self.registry.finish(self.gang_id)

    def __enter__(self) -> "GangHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


class GangRegistry:
    """Live structured-job groups, keyed by gang id (== the request's
    trace id, so gang-cancel and the ``#N`` child ids line up for free).

    Always constructed by the scheduler — gang bookkeeping is part of the
    serving contract, never optional; the bench A/B toggles only the
    queue's AFFINITY pick, not the subsystem."""

    def __init__(self, *, metrics=None) -> None:
        # lock-order-sanitizer hook: table mutations only — metrics calls
        # happen outside so serve.gang never nests another serve lock
        self._lock = make_lock("serve.gang")
        self._gangs: dict[str, _Gang] = {}  # guarded by: _lock
        self.metrics = metrics

    # -- lifecycle --------------------------------------------------------

    def open(self, gang_id: str) -> GangHandle:
        """Register a newly admitted structured job. Idempotent per id (a
        client retrying a request id mid-flight rejoins the live group
        rather than forking a second one)."""
        created = False
        with self._lock:
            if gang_id not in self._gangs:
                self._gangs[gang_id] = _Gang(gang_id=gang_id)
                created = True
        if created and self.metrics is not None:
            self.metrics.observe_gang_admitted()
        return GangHandle(self, gang_id)

    def note_member(self, gang_id: str) -> None:
        """Count one fan-out child of ``gang_id`` (called by the scheduler
        right after the child's queue admission). A member of an unknown
        gang (a child shed after its group finished) is a no-op."""
        with self._lock:
            gang = self._gangs.get(gang_id)
            if gang is None:
                return
            gang.member_count += 1
        if self.metrics is not None:
            self.metrics.observe_gang_members(1)

    def mark_partial(self, gang_id: str) -> None:
        """A member failed typed POISON and the reduce proceeds without its
        output: mark the group so the summarize reply reports ``partial``.
        Idempotent per gang."""
        with self._lock:
            gang = self._gangs.get(gang_id)
            if gang is None or gang.partial:
                return
            gang.partial = True
        logger.warning(
            "gang %s degraded: poison member dropped from the reduce",
            gang_id,
        )
        if self.metrics is not None:
            self.metrics.observe_gang_partial()

    def finish(self, gang_id: str) -> None:
        """The structured job terminally resolved (completed, failed,
        cancelled): drop the live group. Idempotent."""
        with self._lock:
            self._gangs.pop(gang_id, None)

    # -- introspection ----------------------------------------------------

    def lookup(self, gang_id: str) -> dict | None:
        """{"members": member count, "partial": bool} for a LIVE gang, or
        None."""
        with self._lock:
            gang = self._gangs.get(gang_id)
            if gang is None:
                return None
            return {"members": gang.member_count, "partial": gang.partial}

    def active(self) -> int:
        with self._lock:
            return len(self._gangs)

    def stats(self) -> dict:
        """Scrape-time gauge block for /metrics (vnsum_serve_gang_*)."""
        return {"active": self.active()}
