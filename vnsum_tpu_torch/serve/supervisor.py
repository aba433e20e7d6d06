"""Engine supervision: failure classification, retry/bisect policy, and the
graceful-degradation ladder.

One engine exception used to fail every rider of the co-scheduled batch with
the stranger's error, and nothing distinguished "the card hiccuped" from
"this request deterministically crashes the engine" from "device memory is
gone". The
supervisor gives the schedulers a policy object that does:

**Classification.** Every dispatch failure lands in one of four classes:

- ``TRANSIENT``  — default; retryable with backoff (device hiccup, dropped
  connection, a bug that might not reproduce).
- ``RESOURCE``   — allocation-shaped (message carries ``RESOURCE_EXHAUSTED``
  or CUDA's ``out of memory`` — what torch's OutOfMemoryError carries — or
  ``MemoryError``): retryable, AND evidence
  the current operating point is too hot, so repeated strikes step the
  degradation ladder down.
- ``POISON``     — deterministic input errors (the ``PERMANENT_ERRORS``
  family, kept here): retrying is burning device time; the batch
  is bisected immediately to quarantine the culprit.
- ``FATAL``      — explicitly marked unrecoverable (``FatalEngineError`` or
  an exception with a truthy ``.fatal``): fail the whole group, typed.

**Retry budget + backoff.** Each request carries an ``attempts`` counter;
retries are capped per REQUEST (not per batch — a rider that keeps landing
in crashing batches eventually stops being retried) and spaced by bounded,
seeded-jitter exponential backoff. A group that exhausts its budget
collectively is bisected rather than failed — innocent riders escape through
the half that dispatches cleanly, and the poison request bottoms out alone,
failing with :class:`RequestFailed` (class POISON: it failed every attempt,
finally with no one else to blame).

**Degradation ladder.** Repeated RESOURCE strikes step down a config ladder;
each rung keeps the restrictions of the ones above it::

    0 HEALTHY          full configuration
    1 REDUCED_BATCH    engine dispatch width halved (batches and slot loops)
    2 NO_SPEC          speculative decoding off (drops the k+1-wide verify)
    3 NO_CACHE_INSERT  prefix-cache insertion off (stops pool churn; hits
                       still serve)
    4 BROWNOUT         new external admissions shed with a typed 503 +
                       Retry-After (internal fan-out of already-admitted
                       work still runs)

Recovery is probed, not assumed: after ``probe_interval_s`` without a
resource strike the ladder climbs one rung (evaluated on scheduler
successes AND at the admission gate, so a fully-browned-out server can heal
with no traffic dispatching).

Threading: classification and policy reads are pure/lock-free; ladder state
is mutated under a small internal lock because the admission gate (HTTP
threads, under the queue lock) probes recovery while the scheduler thread
records strikes. The queue lock is always acquired BEFORE this one, never
after — no cycle for the lock-order sanitizer.

The hot path stays supervised-but-free: a healthy dispatch costs one
``record_success()`` (a lock-free fast path when the ladder is at HEALTHY
and no strikes are pending) — no wrapping, no extra dispatches.

Copy of ``vnsum_tpu/serve/supervisor.py``; only the imports and the names of
the device and its engine differ. The classifier also reads CUDA's ``out of
memory`` as RESOURCE, and keeps the JAX package's PERMANENT_ERRORS (the
port's core/faults.py adds RuntimeError for the pipeline's retries).
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from enum import Enum, IntEnum

from ..analysis.sanitizers import make_lock
from ..core.logging import get_logger

logger = get_logger("vnsum.serve.supervisor")

# deterministic input errors: retrying them burns device time. The JAX
# package's PERMANENT_ERRORS (vnsum_tpu/core/faults.py); the port's copy in
# core/faults.py adds RuntimeError for the pipeline's retries, which would
# make every device fault (and every injected fault) a poison verdict here
PERMANENT_ERRORS = (
    FileNotFoundError, TypeError, ValueError, KeyError, AttributeError,
    IndexError, NotImplementedError,
)


class FailureClass(str, Enum):
    TRANSIENT = "transient"
    RESOURCE = "resource_exhausted"
    POISON = "poison"
    FATAL = "fatal"
    # a dispatch that never RETURNED (serve/watchdog.py): declared past its
    # wall-clock budget, riders resolved typed without an exception ever
    # firing. Retryable from the client's seat (the request itself is not
    # implicated — re-submission rides the normal supervised path), and a
    # ladder strike from the server's (a host that hangs dispatches is a
    # host running too hot)
    HUNG = "hung"


class Rung(IntEnum):
    """Degradation ladder rungs; higher = more degraded. Each rung implies
    every restriction above it."""

    HEALTHY = 0
    REDUCED_BATCH = 1
    NO_SPEC = 2
    NO_CACHE_INSERT = 3
    BROWNOUT = 4


class FatalEngineError(RuntimeError):
    """Raise (or subclass) to mark a failure the supervisor must not retry
    or bisect — the engine itself is gone."""


class RequestFailed(RuntimeError):
    """Typed terminal failure delivered on a request future after
    supervision gave up: carries the :class:`FailureClass` and the last
    underlying error. ``RequestFailed(POISON)`` is the quarantine verdict —
    this request deterministically crashed its dispatches."""

    def __init__(self, failure_class: FailureClass, detail: str = "",
                 cause: BaseException | None = None) -> None:
        self.failure_class = failure_class
        self.cause = cause
        msg = f"request failed ({failure_class.value})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


def classify_failure(e: BaseException) -> FailureClass:
    """Map an engine exception to its failure class. String-matching is
    deliberate: ``RESOURCE_EXHAUSTED`` is what the fault-injection plan's
    allocation failures carry and ``CUDA out of memory`` what torch's
    OutOfMemoryError carries, so serving policy imports no device type."""
    if isinstance(e, FatalEngineError) or getattr(e, "fatal", False):
        return FailureClass.FATAL
    msg = str(e)
    if (isinstance(e, MemoryError) or "RESOURCE_EXHAUSTED" in msg
            or "CUDA out of memory" in msg):
        return FailureClass.RESOURCE
    if isinstance(e, PERMANENT_ERRORS):
        return FailureClass.POISON
    return FailureClass.TRANSIENT


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry/backoff knobs. ``max_attempts`` counts FAILED dispatches
    a single request may be part of before it stops being retried;
    backoff(n) = min(base * 2^(n-1), max) * (1 + jitter * U[0,1)) with a
    seeded RNG so hermetic fault tests replay the exact same schedule."""

    max_attempts: int = 3
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    jitter: float = 0.25
    seed: int = 0


class EngineSupervisor:
    def __init__(
        self,
        policy: RetryPolicy | None = None,
        *,
        resource_strikes_per_step: int = 2,
        probe_interval_s: float = 5.0,
        brownout_retry_after_s: float = 1.0,
        max_rung: Rung = Rung.BROWNOUT,
    ) -> None:
        self.policy = policy or RetryPolicy()
        self.resource_strikes_per_step = max(1, int(resource_strikes_per_step))
        self.probe_interval_s = float(probe_interval_s)
        self.brownout_retry_after_s = float(brownout_retry_after_s)
        self.max_rung = Rung(max_rung)
        self._rng = random.Random(self.policy.seed)
        # lock-order-sanitizer hook: plain threading.Lock in production.
        # Order contract: the queue lock may be held while acquiring this
        # one (admission_gate under submit), never the reverse
        self._lock = make_lock("serve.supervisor")
        # ladder state: MUTATED only under _lock; rung reads are deliberately
        # lock-free (an int read is atomic, and a stale rung for one dispatch
        # is harmless) — so no '# guarded by' annotation, by design
        self._rung = Rung.HEALTHY
        self._strikes = 0
        # recovery clock: restamped on every resource strike AND on every
        # rung transition; _maybe_recover climbs one rung per
        # probe_interval_s of silence on this clock
        self._last_change = 0.0
        # monotone counters for /metrics (scrape reads are racy ints)
        self.step_downs = 0
        self.recoveries = 0

    # -- classification / backoff (pure) ---------------------------------

    classify = staticmethod(classify_failure)

    def backoff_s(self, attempt: int) -> float:
        """Jittered exponential delay before retry number ``attempt``
        (1-based), capped at the policy maximum."""
        p = self.policy
        base = min(p.backoff_base_s * (2 ** max(attempt - 1, 0)),
                   p.backoff_max_s)
        return base * (1.0 + p.jitter * self._rng.random())

    # -- ladder ----------------------------------------------------------

    @property
    def rung(self) -> Rung:
        return self._rung

    def batch_limit(self, base: int) -> int:
        """Engine dispatch width under the current rung: halved from
        REDUCED_BATCH down."""
        if self._rung >= Rung.REDUCED_BATCH:
            return max(1, base // 2)
        return base

    @property
    def spec_enabled(self) -> bool:
        return self._rung < Rung.NO_SPEC

    @property
    def cache_inserts_enabled(self) -> bool:
        return self._rung < Rung.NO_CACHE_INSERT

    def admission_gate(self) -> float | None:
        """Brownout probe for the queue's admission check: Retry-After
        seconds when shedding, None when admitting. Also the recovery
        ticker — a browned-out server takes no batches, so the scheduler
        never runs record_success(); probing here lets the ladder climb on
        the next knock instead of never."""
        if self._rung is Rung.HEALTHY:
            return None
        self._maybe_recover()
        return (
            self.brownout_retry_after_s
            if self._rung >= Rung.BROWNOUT else None
        )

    def note_failure(self, cls: FailureClass) -> None:
        """Ladder bookkeeping for one classified dispatch failure; called
        from the scheduler thread. EVERY resource strike — sub-threshold
        and at-max-rung included — restamps the recovery clock: the probe
        interval measures quiet time since the last strike, not since the
        last rung change, so the ladder can't oscillate back up into an
        operating point that is still failing. HUNG counts as a resource
        strike (serve/watchdog.py): a wedged dispatch is the same
        too-hot-operating-point evidence an OOM is."""
        if cls not in (FailureClass.RESOURCE, FailureClass.HUNG):
            return
        with self._lock:
            self._last_change = time.monotonic()
            self._strikes += 1
            if self._strikes < self.resource_strikes_per_step:
                return
            self._strikes = 0
            if self._rung >= self.max_rung:
                return
            self._rung = Rung(self._rung + 1)
            self.step_downs += 1
        logger.warning("degradation ladder stepped DOWN to %s",
                       self._rung.name)

    def record_success(self) -> None:
        """One clean dispatch/segment: clears pending strikes and probes
        recovery. Free when healthy (single attribute read)."""
        if self._rung is Rung.HEALTHY and not self._strikes:
            return
        with self._lock:
            self._strikes = 0
        self._maybe_recover()

    def _maybe_recover(self) -> None:
        with self._lock:
            if self._rung is Rung.HEALTHY:
                return
            now = time.monotonic()
            if now - self._last_change < self.probe_interval_s:
                return
            self._rung = Rung(self._rung - 1)
            self._last_change = now
            self.recoveries += 1
        logger.info("degradation ladder recovered UP to %s", self._rung.name)
