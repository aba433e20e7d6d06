"""Seeded fault injection at named backend dispatch sites.

Copy of ``vnsum_tpu/testing/faults.py``.

The serving stack's recovery behavior (serve/supervisor.py: retry, batch
bisection, the degradation ladder) is unreachable by normal tests — nothing
in a healthy FakeBackend ever raises. This module makes the stack fail ON
PURPOSE, deterministically: a :class:`FaultPlan` is a seeded list of
:class:`FaultSpec` rules bound to *sites* — stable string names the backends
call :func:`fault` with at their dispatch boundaries:

====================  ======================================================
site                  fires
====================  ======================================================
``fake.dispatch``     FakeBackend.generate entry (one-shot batch dispatch)
``fake.prefill``      inside FakeBackend's cache pass, WHILE radix pins are
                      held — the pin-leak-on-crash site
``fake.slot_admit``   FakeSlotLoop.admit entry (in-flight join)
``fake.slot_step``    FakeSlotLoop.step entry (in-flight decode segment)
====================  ======================================================

Fault kinds map one-to-one onto the supervisor's failure classes:

- ``raise``     — :class:`InjectedFault` (RuntimeError; classified TRANSIENT)
- ``resource``  — :class:`InjectedResourceExhausted` (message carries
  ``RESOURCE_EXHAUSTED``, the string the supervisor's classifier
  reads as an allocation failure, as it reads a CUDA out-of-memory error)
- ``fatal``     — :class:`InjectedFault` with ``.fatal = True`` (FATAL class)
- ``poison``    — fires only when a prompt in the dispatch contains
  ``match``; deterministic per batch CONTENT, which is exactly the
  poison-request scenario bisection quarantines
- ``latency``   — sleep ``delay_s`` instead of raising (SLO pressure:
  deadline sheds, drain timeouts); the sleep is an interruptible Event
  wait, so :func:`interrupt_sleeps` (the drain path) can cut it short
- ``hang``      — block at the site until released: ``delay_s > 0`` holds
  that long ("block until released" with an automatic release), ``delay_s``
  of 0 blocks FOREVER (until :func:`release_hangs` / process death). The
  watchdog's (serve/watchdog.py) stall-detection and wedged-dispatch
  recovery paths are unreachable any other way — nothing in a healthy
  backend ever just stops returning

Arming: programmatically (:func:`arm` / :func:`injected`), or hermetically
for a whole process via ``VNSUM_FAULTS``, e.g.::

    VNSUM_FAULTS='seed=7;fake.dispatch:raise@on_call=3;\
fake.dispatch:resource@every_n=5;fake.prefill:poison@match=DOC-13'

Disarmed cost is one module-global ``is None`` check per dispatch — nothing
else; no plan object exists unless armed. Every firing is appended to
``plan.fired`` so tests assert the exact schedule that ran.
"""
from __future__ import annotations

import os
import random
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field

from ..core.logging import get_logger

logger = get_logger("vnsum.testing.faults")


class InjectedFault(RuntimeError):
    """A deliberately injected failure; ``fatal=True`` marks the
    unrecoverable class for the supervisor's classifier."""

    def __init__(self, message: str, fatal: bool = False) -> None:
        super().__init__(message)
        self.fatal = fatal
        self.injected = True


class InjectedResourceExhausted(InjectedFault):
    """Injected OOM-shaped failure. The message carries RESOURCE_EXHAUSTED
    so classification matches a real allocation failure by string, not by
    this test-only type."""

    def __init__(self, site: str, call: int) -> None:
        super().__init__(
            f"RESOURCE_EXHAUSTED: injected allocation failure at "
            f"{site} call {call}"
        )


_KINDS = ("raise", "resource", "fatal", "poison", "latency", "hang")


@dataclass
class FaultSpec:
    """One injection rule at one site. Exactly one of ``on_call`` /
    ``every_n`` / ``probability`` selects when it fires (call indices are
    1-based and PER SITE); ``times`` caps total firings (0 = unlimited).
    ``match`` (poison kind) is the prompt substring that triggers it."""

    site: str
    kind: str = "raise"
    on_call: int | None = None
    every_n: int | None = None
    probability: float | None = None
    times: int = 0
    delay_s: float = 0.0
    match: str = ""
    fired: int = 0

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == "poison" and not self.match:
            raise ValueError("poison faults need a match= substring")
        if self.kind != "poison" and not any(
            v is not None
            for v in (self.on_call, self.every_n, self.probability)
        ):
            # a selector-less non-poison spec would silently never fire and
            # the "fault-injection run" would pass vacuously green
            raise ValueError(
                f"{self.site}:{self.kind} needs on_call=, every_n=, or "
                "probability= (poison rules alone default to "
                "whenever-matched)"
            )

    def triggers(self, call_index: int, rng: random.Random) -> bool:
        if self.times and self.fired >= self.times:
            return False
        if self.on_call is not None:
            return call_index == self.on_call
        if self.every_n is not None:
            return call_index % self.every_n == 0
        if self.probability is not None:
            return rng.random() < self.probability
        # poison rules default to "whenever the match is present"
        return self.kind == "poison"


@dataclass
class FaultPlan:
    """Seeded, observable schedule of faults across sites. Thread-safe —
    dispatch sites fire from the scheduler thread, HTTP handler threads,
    and tests concurrently."""

    specs: list[FaultSpec] = field(default_factory=list)
    seed: int = 0

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)
        self._calls: dict[str, int] = {}
        self._lock = threading.Lock()
        # (site, kind, per-site call index) per firing, for test assertions
        self.fired: list[tuple[str, str, int]] = []
        # hang kinds park on this until release_hangs() (or their own
        # delay_s elapses); latency kinds wait on the interrupt event so a
        # draining server can cut a simulated sleep short (the drain-wins
        # contract) — both are plan-scoped, so disarming forgets them
        self._hang_release = threading.Event()
        self._sleep_interrupt = threading.Event()

    def release_hangs(self) -> None:
        """Unblock every thread parked in a ``hang`` fault (tests; the
        watchdog never needs it — recovery treats the thread as lost)."""
        self._hang_release.set()

    def interrupt_sleeps(self) -> None:
        """Cut every in-flight ``latency`` sleep short AND release hangs —
        what a draining backend calls so a graceful shutdown never waits
        out an injected stall (module-level :func:`interrupt_sleeps`
        routes here for the armed plan)."""
        self._sleep_interrupt.set()
        self._hang_release.set()

    def reset_interrupts(self) -> None:
        """Re-arm latency/hang blocking after a drain: interrupts are
        one-shot Events, and a plan kept armed across a closed-and-rebuilt
        server would otherwise simulate nothing (every sleep instant,
        every hang pass-through) — a vacuously green chaos run. Called
        when a new scheduler attaches (FakeBackend.reset_drain)."""
        self._sleep_interrupt.clear()
        self._hang_release.clear()

    def calls(self, site: str) -> int:
        with self._lock:
            return self._calls.get(site, 0)

    def fire(self, site: str, prompts=None) -> None:
        """Advance ``site``'s call counter and act on the first matching
        rule: sleep for latency kinds, raise for the rest."""
        with self._lock:
            n = self._calls.get(site, 0) + 1
            self._calls[site] = n
            hit: FaultSpec | None = None
            for spec in self.specs:
                if spec.site != site or not spec.triggers(n, self._rng):
                    continue
                if spec.kind == "poison" and not any(
                    spec.match in p for p in (prompts or ())
                ):
                    continue
                spec.fired += 1
                self.fired.append((site, spec.kind, n))
                hit = spec
                break
        if hit is None:
            return
        logger.warning(
            "injecting %s at %s (call %d)", hit.kind, site, n
        )
        if hit.kind == "latency":
            # interruptible: a draining backend cuts the simulated stall
            # short via interrupt_sleeps() instead of waiting it out
            self._sleep_interrupt.wait(hit.delay_s)
        elif hit.kind == "hang":
            # the wedge under test: no exception, no return — until
            # released (delay_s > 0 auto-releases; 0 = forever). The
            # watchdog must detect and recover AROUND this thread
            self._hang_release.wait(hit.delay_s if hit.delay_s > 0 else None)
        elif hit.kind == "resource":
            raise InjectedResourceExhausted(site, n)
        elif hit.kind == "fatal":
            raise InjectedFault(f"injected fatal fault at {site} call {n}",
                                fatal=True)
        elif hit.kind == "poison":
            raise InjectedFault(
                f"injected poison fault at {site} call {n} "
                f"(match={hit.match!r})"
            )
        else:
            raise InjectedFault(f"injected fault at {site} call {n}")


def parse_plan(text: str) -> FaultPlan:
    """``seed=N;site:kind@k=v,k=v;...`` -> FaultPlan (the VNSUM_FAULTS
    format; ';' or whitespace separate entries)."""
    seed = 0
    specs: list[FaultSpec] = []
    for entry in filter(None, (e.strip() for e in text.replace(";", " ").split())):
        if entry.startswith("seed="):
            seed = int(entry[len("seed="):])
            continue
        head, _, args = entry.partition("@")
        site, _, kind = head.partition(":")
        if not site or not kind:
            raise ValueError(f"malformed VNSUM_FAULTS entry {entry!r}")
        kw: dict = {}
        for pair in filter(None, args.split(",")):
            k, _, v = pair.partition("=")
            if k in ("on_call", "every_n", "times"):
                kw[k] = int(v)
            elif k in ("probability", "delay_s"):
                kw[k] = float(v)
            elif k == "match":
                kw[k] = v
            else:
                raise ValueError(f"unknown fault arg {k!r} in {entry!r}")
        specs.append(FaultSpec(site=site, kind=kind, **kw))
    return FaultPlan(specs=specs, seed=seed)


def plan_from_env() -> FaultPlan | None:
    """Parse ``VNSUM_FAULTS`` (None when unset/empty)."""
    text = os.environ.get("VNSUM_FAULTS", "").strip()
    return parse_plan(text) if text else None


# the armed plan; None = disarmed (the only state production ever sees).
# Written by arm()/disarm() only; sites read it racily — an in-flight
# dispatch may miss a plan armed mid-call, never crash.
_PLAN: FaultPlan | None = plan_from_env()


def arm(plan: FaultPlan) -> FaultPlan:
    global _PLAN
    _PLAN = plan
    return plan


def disarm() -> None:
    global _PLAN
    _PLAN = None


@contextmanager
def injected(plan: FaultPlan):
    """Arm ``plan`` for the with-block; restores the prior plan on exit."""
    global _PLAN
    prev = _PLAN
    _PLAN = plan
    try:
        yield plan
    finally:
        _PLAN = prev


def fault(site: str, prompts=None) -> None:
    """THE dispatch-site hook: free when disarmed (one global read)."""
    if _PLAN is not None:
        _PLAN.fire(site, prompts)


def interrupt_sleeps() -> None:
    """Cut the armed plan's latency sleeps short and release its hangs —
    the backend drain hook (FakeBackend.request_drain). No-op when
    disarmed."""
    if _PLAN is not None:
        _PLAN.interrupt_sleeps()


def reset_interrupts() -> None:
    """Undo :func:`interrupt_sleeps` on the armed plan — a NEW server
    attaching to a still-armed plan must get real latency/hang simulation,
    not the previous drain's pass-through. No-op when disarmed."""
    if _PLAN is not None:
        _PLAN.reset_interrupts()
