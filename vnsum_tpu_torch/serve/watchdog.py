"""Watchdog: hang/stall detection and wedged-dispatch recovery.

The supervisor (serve/supervisor.py) recovers from engine *exceptions* —
but a dispatch that simply
never RETURNS (a stuck device op, a pathological compile, a lock wait, a
wedged helper thread) freezes the scheduler silently: no exception fires,
``/healthz`` keeps reporting ok, and every client rides out its own
deadline. This module is the liveness layer closing that gap, in two parts:

**Heartbeat registry.** Every long-lived serving thread registers a named
:class:`Heartbeat` with a per-thread deadline and beats it once per loop
iteration (the scheduler loop beats from inside the queue's wait loops, so
an idle server still ticks). A heartbeat older than its deadline is a STALL.

**Bounded-dispatch contract.** Each engine dispatch is stamped with a
:class:`DispatchTicket` carrying a wall-clock budget derived from its token
work (``dispatch_budget()``: base + per-token seconds — a 64-row prefill
legitimately takes longer than a one-row decode segment, so budgets scale
with the work instead of a one-size timeout). While a ticket is armed the
owner's heartbeat check is SUSPENDED — the loop can't beat mid-dispatch,
and a slow-but-progressing dispatch inside its budget must never be
flagged (the false-positive-immunity contract) — and a ticket past its
budget is declared HUNG.

On a stall the monitor thread:

(a) **snapshots every thread's stack** (``sys._current_frames``) into a
    typed ``stall`` flight-recorder event and an on-disk
    ``watchdog_<kind>_<utc-ms>_<n>.json`` dump (atomic write, same crash
    discipline as the flight recorder's);
(b) **classifies** it: ``dispatch`` (a ticket over budget), ``helper`` (a
    helper-kind heartbeat went quiet), or ``lock`` (a loop-kind heartbeat
    went quiet with NO dispatch armed — the thread is wedged in a lock /
    condition / fsync wait somewhere outside the engine);
(c) **recovers**: dispatch stalls invoke ``on_hung_dispatch`` — the
    scheduler's recovery hook (riders of a hung one-shot dispatch resolve
    typed ``RequestFailed(HUNG)``; a hung slot loop is torn down and its
    residents requeued — and the scheduler thread is REPLACED, the
    abandoned one fenced off by a stale-thread check at every boundary);
    lock and helper stalls invoke ``on_escalate`` — the HTTP server wires
    a supervised exit (``WATCHDOG_EXIT_CODE``) so an outer process manager
    restarts it. A
    recovery also charges the degradation ladder a resource strike via the
    scheduler hook: a host that hangs dispatches is a host running too hot.

Threading: ``beat()`` and ticket begin/end are the hot-path writes — beat
is ONE attribute store (no lock; the monitor's racy read is a float, and a
stale read delays detection by one interval, never corrupts), tickets take
the ``serve.watchdog`` lock briefly. The monitor holds the lock only to
COLLECT stalls; dumps, recorder appends, and recovery callbacks all run
outside it (recovery acquires queue/radix locks, so the watchdog
lock must stay leaf-like for the lock-order sanitizer). Detection math is
clock-injectable (``clock=``) so tests drive it synthetically without
sleeping.

Copy of ``vnsum_tpu/serve/watchdog.py``; only the imports, the names of the
device and its engine, and the comments on the journal (not ported yet,
ROADMAP A15b) differ.
"""
from __future__ import annotations

import itertools
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

from ..analysis.sanitizers import make_lock
from ..core.artifacts import atomic_write_json
from ..core.logging import get_logger

logger = get_logger("vnsum.serve.watchdog")

# the supervised-escalation exit status: distinct from crash (-9) and clean drain (0) so a
# process manager / the chaos harness can tell "the watchdog gave up on
# this process" from everything else
WATCHDOG_EXIT_CODE = 86

# classification vocabulary — the stable label set of
# vnsum_serve_watchdog_stalls_total{kind}
STALL_KINDS = ("dispatch", "lock", "helper")

_dump_ids = itertools.count(1)


def snapshot_stacks() -> list[dict]:
    """Every live thread's Python stack, JSON-shaped — the one snapshot
    serving ``GET /debug/stacks``, the SIGUSR1 handler, and the watchdog's
    automatic stall dumps. ``sys._current_frames`` is a point-in-time copy;
    frames may advance while formatting, which is fine for a post-mortem."""
    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        t = by_ident.get(ident)
        out.append({
            "ident": ident,
            "name": t.name if t is not None else f"thread-{ident}",
            "daemon": bool(t.daemon) if t is not None else None,
            "stack": [ln.rstrip("\n") for ln in traceback.format_stack(frame)],
        })
    out.sort(key=lambda d: d["name"])
    return out


class Heartbeat:
    """One registered thread's liveness stamp. ``beat()`` is the hot-path
    write: a single attribute store, no lock — the monitor's read races it
    harmlessly (floats are atomic; staleness delays detection by at most
    one interval)."""

    __slots__ = ("name", "kind", "deadline_s", "last_beat", "_clock")

    def __init__(self, name: str, kind: str, deadline_s: float,
                 clock) -> None:
        self.name = name
        self.kind = kind  # "loop" | "helper"
        self.deadline_s = float(deadline_s)
        self._clock = clock
        self.last_beat = clock()

    def beat(self) -> None:
        self.last_beat = self._clock()

    def age(self, now: float | None = None) -> float:
        return (self._clock() if now is None else now) - self.last_beat


@dataclass
class DispatchTicket:
    """One in-flight engine dispatch under the bounded-dispatch contract."""

    owner: str            # heartbeat name of the dispatching thread
    kind: str             # "one_shot" | "slot_admit" | "slot_segment"
    budget_s: float
    started_at: float
    riders: tuple = ()    # trace ids, for the stall report
    tokens: int = 0

    def age(self, now: float) -> float:
        return now - self.started_at


@dataclass
class Stall:
    """One classified liveness verdict, handed to dumps and recovery."""

    kind: str             # "dispatch" | "lock" | "helper"
    name: str             # heartbeat / owner name
    stalled_for_s: float
    limit_s: float        # the budget or deadline that was exceeded
    ticket: DispatchTicket | None = None
    detail: dict = field(default_factory=dict)


class Watchdog:
    """Heartbeat registry + bounded-dispatch monitor + stall recovery."""

    def __init__(
        self,
        *,
        interval_s: float = 0.5,
        loop_deadline_s: float = 10.0,
        helper_deadline_s: float = 60.0,
        dispatch_base_s: float = 30.0,
        dispatch_per_token_s: float = 0.01,
        segment_budget_s: float | None = None,
        clock=time.monotonic,
        recorder=None,
        dump_dir: str | Path | None = None,
        on_escalate=None,
    ) -> None:
        self.interval_s = float(interval_s)
        self.loop_deadline_s = float(loop_deadline_s)
        self.helper_deadline_s = float(helper_deadline_s)
        self.dispatch_base_s = float(dispatch_base_s)
        self.dispatch_per_token_s = float(dispatch_per_token_s)
        # a decode segment is bounded work whatever the resident prompts
        # cost to prefill — its budget is the base, not token-scaled
        self.segment_budget_s = (
            float(segment_budget_s) if segment_budget_s is not None
            else self.dispatch_base_s
        )
        self._clock = clock
        self.recorder = recorder
        self.dump_dir = Path(dump_dir) if dump_dir else None
        # dispatch stalls: the scheduler registers its recovery here
        # (riders typed HUNG / slot-loop teardown + requeue + respawn).
        # lock/helper stalls: on_escalate — the server wires a supervised
        # exit; None (library/test default) just dumps
        self.on_hung_dispatch = None
        self.on_escalate = on_escalate
        # leaf-like by contract: held only for registry/ticket bookkeeping
        # and stall COLLECTION — never while dumping, recording, or
        # recovering (those take queue/radix locks)
        self._lock = make_lock("serve.watchdog")
        self._beats: dict[str, Heartbeat] = {}        # guarded by: _lock
        self._tickets: dict[str, DispatchTicket] = {}  # guarded by: _lock
        self._flagged: set[str] = set()               # guarded by: _lock
        # monotone counters; racy scrape reads are fine
        self.stalls_total: dict[str, int] = {k: 0 for k in STALL_KINDS}
        self.recoveries_total = 0
        self.hung_dispatches_total = 0
        self.dumps_written = 0
        self.last_stall: dict | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def now(self) -> float:
        """The watchdog's own clock — callers doing arithmetic against
        ticket/heartbeat timestamps (which live in THIS clock's space,
        possibly synthetic under test) must use it, never a bare
        ``time.monotonic()``."""
        return self._clock()

    # -- registry ---------------------------------------------------------

    def register(self, name: str, *, kind: str = "loop",
                 deadline_s: float | None = None) -> Heartbeat:
        """Register (or re-register: a respawned thread keeps its name)
        one long-lived thread; returns the handle it must beat()."""
        if deadline_s is None:
            deadline_s = (self.helper_deadline_s if kind == "helper"
                          else self.loop_deadline_s)
        hb = Heartbeat(name, kind, deadline_s, self._clock)
        with self._lock:
            self._beats[name] = hb
            self._flagged.discard(name)
        return hb

    def unregister(self, name: str) -> None:
        """A clean thread exit (drain) stops being monitored — a drained
        scheduler must not read as a stall."""
        with self._lock:
            self._beats.pop(name, None)
            self._tickets.pop(name, None)
            self._flagged.discard(name)

    # -- bounded-dispatch contract ----------------------------------------

    def dispatch_budget(self, tokens: int) -> float:
        """Wall-clock budget for a dispatch over ``tokens`` of work
        (prompt + expected decode): base + per-token seconds."""
        return self.dispatch_base_s + self.dispatch_per_token_s * max(
            int(tokens), 0
        )

    def segment_budget(self, fused_segments: int = 1) -> float:
        """Wall-clock budget for one slot-loop decode dispatch covering
        ``fused_segments`` on-device segments: the flat per-segment budget
        scaled by N. A fused dispatch legitimately holds the host N times
        longer than a single segment — without the scaling every fused
        dispatch slower than one segment's budget would be a false HUNG,
        and with it a genuinely wedged dispatch still trips after N
        budgets."""
        return self.segment_budget_s * max(int(fused_segments), 1)

    def begin_dispatch(self, owner: str, kind: str, budget_s: float,
                       riders: tuple = (), tokens: int = 0) -> DispatchTicket:
        t = DispatchTicket(owner=owner, kind=kind, budget_s=float(budget_s),
                           started_at=self._clock(), riders=tuple(riders),
                           tokens=int(tokens))
        with self._lock:
            self._tickets[owner] = t
        return t

    def end_dispatch(self, ticket: DispatchTicket | None) -> None:
        """Clear the ticket — a no-op when the watchdog already declared it
        hung and removed it (the abandoned thread's late return)."""
        if ticket is None:
            return
        with self._lock:
            if self._tickets.get(ticket.owner) is ticket:
                del self._tickets[ticket.owner]

    # -- detection --------------------------------------------------------

    def check(self, now: float | None = None) -> list[Stall]:
        """Pure-ish detection pass: classify every over-limit thread and
        return the stalls (each flagged once — a wedged thread re-fires
        only after it beats again or its hung ticket is replaced). Called
        by the monitor thread; tests call it with a synthetic clock."""
        if now is None:
            now = self._clock()
        out: list[Stall] = []
        with self._lock:
            hung_owners: set[str] = set()
            for owner, t in list(self._tickets.items()):
                age = t.age(now)
                if age <= t.budget_s:
                    continue
                # declared hung: remove it so end_dispatch from the
                # abandoned thread no-ops and the next interval doesn't
                # re-declare the same dispatch
                del self._tickets[owner]
                hung_owners.add(owner)
                # one stall, one verdict: the owner's heartbeat is stale
                # BECAUSE it was dispatching — restamp it so neither this
                # pass nor the next misreads the same wedge as a second,
                # lock-classified stall while recovery (which replaces the
                # thread and re-beats) is still running
                hb = self._beats.get(owner)
                if hb is not None:
                    hb.beat()
                out.append(Stall(
                    kind="dispatch", name=owner, stalled_for_s=age,
                    limit_s=t.budget_s, ticket=t,
                    detail={"dispatch_kind": t.kind, "tokens": t.tokens,
                            "riders": list(t.riders)[:32]},
                ))
            for name, hb in self._beats.items():
                if name in self._tickets or name in hung_owners:
                    # mid-dispatch: the loop cannot beat; the ticket's
                    # budget governs (false-positive immunity)
                    continue
                age = hb.age(now)
                if age <= hb.deadline_s:
                    # healthy (it beat since): clear any standing flag so a
                    # FUTURE stall of the same thread is a new verdict
                    self._flagged.discard(name)
                    continue
                if name in self._flagged:
                    continue  # already declared; re-fire only after a beat
                self._flagged.add(name)
                out.append(Stall(
                    kind="helper" if hb.kind == "helper" else "lock",
                    name=name, stalled_for_s=age, limit_s=hb.deadline_s,
                ))
        return out

    # -- stall handling ---------------------------------------------------

    def handle(self, stall: Stall) -> None:
        """One stall end to end: count, snapshot stacks (in-memory —
        cheap), RECOVER (dispatch) or escalate (lock/helper), then write
        the dumps. Recovery runs BEFORE disk I/O on purpose: the scheduler
        hook's first act is to fence off the wedged thread, and a dispatch
        that limps back at budget+epsilon must meet that fence within the
        microseconds of the snapshot, not after tens of milliseconds of
        atomic-write fsync. Runs OUTSIDE the watchdog lock."""
        self.stalls_total[stall.kind] = (
            self.stalls_total.get(stall.kind, 0) + 1
        )
        self.last_stall = {
            "kind": stall.kind, "name": stall.name,
            "stalled_for_s": round(stall.stalled_for_s, 3),
            "limit_s": round(stall.limit_s, 3),
            "t_wall": time.time(),
        }
        logger.critical(
            "watchdog: %s stall on %r — %.2fs past a %.2fs %s",
            stall.kind, stall.name, stall.stalled_for_s, stall.limit_s,
            "budget" if stall.kind == "dispatch" else "heartbeat deadline",
        )
        stacks = snapshot_stacks()
        if self.recorder is not None:
            self.recorder.record(
                "stall", rid=(stall.ticket.riders[0] if stall.ticket is not None
                              and stall.ticket.riders else ""),
                stall_kind=stall.kind, thread=stall.name,
                stalled_for_s=round(stall.stalled_for_s, 3),
                limit_s=round(stall.limit_s, 3),
            )
        recovered = False
        if stall.kind == "dispatch":
            self.hung_dispatches_total += 1
            hook = self.on_hung_dispatch
            if hook is not None:
                try:
                    hook(stall.ticket)
                    self.recoveries_total += 1
                    recovered = True
                    if self.recorder is not None:
                        self.recorder.record(
                            "watchdog_recover", stall_kind=stall.kind,
                            thread=stall.name,
                        )
                # lint-allow[swallowed-exception]: a failed recovery falls through to escalation below — the stall is still answered, just with the bigger hammer
                except Exception:
                    logger.exception("watchdog: dispatch recovery failed; "
                                     "escalating")
        self.dump_stall(stall, stacks)
        if self.recorder is not None:
            # the ring now holds the stall (and any recover) event plus the
            # lead-up — snapshot it like every other anomaly (throttled)
            self.recorder.dump("stall")
        if not recovered:
            self._escalate(stall)

    def _escalate(self, stall: Stall) -> None:
        hook = self.on_escalate
        if hook is None:
            # library/test default: the dump IS the response; embedding
            # callers that want seal-and-exit wire on_escalate (the HTTP
            # server does)
            logger.critical("watchdog: no escalation handler configured "
                            "for %s stall on %r", stall.kind, stall.name)
            return
        hook(stall)

    def dump_stall(self, stall: Stall, stacks: list[dict]) -> Path | None:
        """``watchdog_<kind>_<utc-ms>_<n>.json``: the stall verdict plus
        every thread's stack — the automatic twin of ``GET /debug/stacks``.
        None when no dump_dir is configured; a full disk must not turn a
        stall report into a second failure."""
        if self.dump_dir is None:
            return None
        payload = {
            "reason": f"watchdog_{stall.kind}",
            "stall": {
                "kind": stall.kind,
                "thread": stall.name,
                "stalled_for_s": round(stall.stalled_for_s, 3),
                "limit_s": round(stall.limit_s, 3),
                **stall.detail,
            },
            "dumped_wall": time.time(),
            "heartbeats": self.heartbeat_ages(),
            "stacks": stacks,
        }
        path = self.dump_dir / (
            f"watchdog_{stall.kind}_{int(time.time() * 1000)}"
            f"_{next(_dump_ids):03d}.json"
        )
        try:
            atomic_write_json(path, payload)
        except OSError:
            logger.exception("watchdog stack dump to %s failed", path)
            return None
        self.dumps_written += 1
        logger.warning("watchdog: wrote stack dump %s", path)
        return path

    # -- surfaces ---------------------------------------------------------

    def heartbeat_ages(self, now: float | None = None) -> dict[str, float]:
        """Last-beat age per registered thread — the /healthz watchdog line
        and the heartbeat_age_seconds gauges."""
        if now is None:
            now = self._clock()
        with self._lock:
            return {
                name: round(max(hb.age(now), 0.0), 3)
                for name, hb in sorted(self._beats.items())
            }

    def health_dict(self) -> dict:
        out: dict = {
            "threads": self.heartbeat_ages(),
            "stalls_total": sum(self.stalls_total.values()),
            "recoveries_total": self.recoveries_total,
        }
        if self.last_stall is not None:
            out["last_stall"] = self.last_stall
        return out

    def stats_dict(self) -> dict:
        """Scrape-time counters for /metrics (vnsum_serve_watchdog_*)."""
        return {
            "stalls": dict(self.stalls_total),
            "recoveries": self.recoveries_total,
            "hung_dispatches": self.hung_dispatches_total,
            "heartbeat_ages": self.heartbeat_ages(),
        }

    # -- monitor thread ---------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._monitor, name="vnsum-serve-watchdog", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)

    def tick(self, now: float | None = None) -> list[Stall]:
        """One detection + handling pass (what the monitor runs per
        interval; tests call it directly under a synthetic clock)."""
        stalls = self.check(now)
        for s in stalls:
            self.handle(s)
        return stalls

    def _monitor(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            # lint-allow[swallowed-exception]: the monitor is the last line of liveness defense — a detection bug must not kill it (the next tick retries) and there is no request to resolve
            except Exception:
                logger.exception("watchdog tick failed; continuing")
