"""Structured jobs: gang-scheduled fan-out over the serving stack.

The paper's strategies are multi-request FAN-OUTS — a map-reduce summarize
splits one document into dozens of chunk prompts, the hierarchical strategy
into a whole tree of them. This module makes the group a first-class
object:

- **Gang admission** — :meth:`MicroBatchScheduler.admit_gang` opens a
  :class:`GangHandle` after ONE pass through the existing request-level
  admission gate (depth / token budget / quota / brownout): the tenant is
  billed once for the whole fan-out, and every internal submit that rides
  the handle's gang id is admission-exempt (``force=True``), exactly the
  contract the summarize path always had.
- **Membership journal** — each fan-out round flushes ONE typed ``GANG``
  record listing the (child_rid, phase) pairs admitted since the last
  flush (serve/journal.py::gang), so restart replay reconstructs group
  membership instead of inferring it from ``trace_id#N`` prefixes, and the
  ``GET /v1/requests/<id>`` poll surface reports per-PHASE progress.
- **Affinity** — queue take paths cluster same-gang rows into one slot
  generation (queue.py::_compat_locked): siblings share the template-header
  prefix by construction, so co-scheduling them is the strategy-aware half
  of KV reuse (survey arXiv 2405.13019 §KV-cache reuse) — the radix cache
  can only skip a prefix that is WARM when the row prefills.
- **Degraded results** — a member failing typed POISON no longer silently
  fails just that child: the reduce proceeds over the survivors, the gang
  is journaled ``partial``, and the parent aggregate folds to a terminal
  ``partial`` state so clients can tell a degraded summary from a complete
  one (journal.py::aggregate_status).
- **Group-aware QoS** — the in-flight preemption path evicts whole gangs
  (never strands a half-finished fan-out holding pins) and the preempt
  budget is effectively billed per gang: a whole-gang eviction increments
  every member's count together (serve/inflight.py::_maybe_preempt).

Threading: one internal lock (``make_lock("serve.gang")``) guarding the
group table. It is held only around table mutations — journal and metrics
appends happen OUTSIDE it, so the lock-order graph gains exactly one edge
(callers -> serve.gang) and the journal lock stays innermost.

Copy of ``vnsum_tpu/serve/gang.py``; ``mark_partial`` journals after its
metrics count.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..analysis.sanitizers import make_lock
from ..core.logging import get_logger

logger = get_logger("vnsum.serve.gang")


@dataclass
class _Gang:
    """One live structured job's group state."""

    gang_id: str
    tenant: str = ""
    # every member rid this gang ever admitted -> its phase ("map" /
    # "reduce" / "outline" / "expand")
    members: dict = field(default_factory=dict)
    # (rid, phase) pairs admitted since the last journal flush
    unflushed: list = field(default_factory=list)
    # journal-less members (no rid to record) still count toward metrics
    member_count: int = 0
    partial: bool = False
    # whole-gang evictions suffered (metrics; the eviction BUDGET rides the
    # members' own preemption counters, which move in lockstep under
    # whole-gang eviction)
    preemptions: int = 0


class GangHandle:
    """The admitted-fan-out token an entry point holds for one structured
    job: carries the gang id its internal submits ride, and finishes the
    group when the request terminally resolves (whatever the outcome — the
    handle tracks liveness, the journal tracks truth)."""

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
    trace id, so gang-cancel and the ``#N`` ledger ids line up for free).

    Always constructed by the scheduler — gang bookkeeping is part of the
    serving contract, never optional; the bench A/B toggles only the
    queue's AFFINITY pick, not the subsystem."""

    def __init__(self, *, journal=None, metrics=None) -> None:
        # lock-order-sanitizer hook: table mutations only — journal/metrics
        # calls happen outside so serve.gang never nests another serve lock
        self._lock = make_lock("serve.gang")
        self._gangs: dict[str, _Gang] = {}  # guarded by: _lock
        self.journal = journal
        self.metrics = metrics

    # -- lifecycle --------------------------------------------------------

    def open(self, gang_id: str, tenant: str = "") -> GangHandle:
        """Register a newly admitted structured job. Idempotent per id (a
        client retrying a request id mid-flight rejoins the live group
        rather than forking a second one)."""
        created = False
        with self._lock:
            if gang_id not in self._gangs:
                self._gangs[gang_id] = _Gang(gang_id=gang_id, tenant=tenant)
                created = True
        if created and self.metrics is not None:
            self.metrics.observe_gang_admitted()
        return GangHandle(self, gang_id)

    def note_member(self, gang_id: str, rid: str | None, phase: str) -> None:
        """Record one fan-out child of ``gang_id`` (called by the scheduler
        right after the child's queue admission assigned its ledger id).
        ``rid`` is None when journaling is off — the member still counts
        toward the group's metrics, it just has no durable identity. A
        member of an unknown gang (a child shed after its group finished)
        is a no-op."""
        with self._lock:
            gang = self._gangs.get(gang_id)
            if gang is None:
                return
            gang.member_count += 1
            if rid is not None and rid not in gang.members:
                gang.members[rid] = phase
                gang.unflushed.append((rid, phase))
        if self.metrics is not None:
            self.metrics.observe_gang_members(1)

    def flush(self, gang_id: str) -> int:
        """Journal the members admitted since the last flush as ONE typed
        GANG record — called once per fan-out ROUND (after its submits),
        so a 40-chunk map round costs one append, and the record lands
        after its members' ACCEPTs (replay reads membership of requests it
        knows). Returns the number of members flushed."""
        with self._lock:
            gang = self._gangs.get(gang_id)
            if gang is None or not gang.unflushed:
                return 0
            batch, gang.unflushed = gang.unflushed, []
        if self.journal is not None:
            self.journal.gang(gang_id, batch)
        return len(batch)

    def mark_partial(self, gang_id: str, reason: str = "poison") -> None:
        """A member failed typed POISON and the reduce proceeds without its
        output: journal the degradation so the parent aggregate (and a
        restarted server's poll surface) reports ``partial``, not
        ``completed``. Idempotent per gang."""
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
        if self.journal is not None:
            self.journal.gang_partial(gang_id, reason)

    def note_preemption(self, gang_id: str) -> None:
        """One whole-gang slot eviction (metrics only — the budget rides
        the members' own preemption counters)."""
        with self._lock:
            gang = self._gangs.get(gang_id)
            if gang is not None:
                gang.preemptions += 1
        if self.metrics is not None:
            self.metrics.observe_gang_preemption()

    def finish(self, gang_id: str) -> None:
        """The structured job terminally resolved (completed, failed,
        cancelled — the journal holds which): drop the live group. Any
        still-unflushed members are flushed first so the ledger never
        loses membership to a fast finish. Idempotent."""
        self.flush(gang_id)
        with self._lock:
            self._gangs.pop(gang_id, None)

    # -- replay / introspection -------------------------------------------

    def restore(self, gangs: dict[str, dict]) -> int:
        """Rebuild live groups from the journal's unfinished-gang view at
        startup replay (journal.py::gangs_unfinished) so replayed members
        rejoin their groups: membership is pre-seeded as FLUSHED (the
        journal already holds it) and partiality survives."""
        n = 0
        with self._lock:
            for gid, meta in gangs.items():
                if gid in self._gangs:
                    continue
                self._gangs[gid] = _Gang(
                    gang_id=gid,
                    members=dict(meta.get("members", {})),
                    member_count=len(meta.get("members", {})),
                    partial=bool(meta.get("partial")),
                )
                n += 1
        return n

    def lookup(self, gang_id: str) -> dict | None:
        """{"members": {rid: phase}, "partial": bool} for a LIVE gang, or
        None (terminal gangs answer from the journal's gang_info)."""
        with self._lock:
            gang = self._gangs.get(gang_id)
            if gang is None:
                return None
            return {"members": dict(gang.members),
                    "partial": gang.partial}

    def active(self) -> int:
        with self._lock:
            return len(self._gangs)

    def stats(self) -> dict:
        """Scrape-time gauge block for /metrics (vnsum_serve_gang_*)."""
        return {"active": self.active()}
