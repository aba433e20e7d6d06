"""Declarative SLOs over the rolling windows: burn rates, error budgets,
and the anomaly trigger for the flight recorder.

The cumulative metrics answer "what happened since boot"; an operator
paging on a live server needs "are we inside our objectives RIGHT NOW, and how
fast are we burning the error budget". This module is that judgement layer,
built as the standard SRE multi-window construction:

**Objectives** come from one declarative spec string (the ``--slo`` flag)::

    --slo "ttft_p99=0.5,e2e_p99=30,error_rate=0.01,availability=0.999"

- ``<metric>_p<q>=<seconds>`` — a latency objective: quantile ``q`` of
  ``metric`` (ttft / e2e / queue_wait) must stay under the threshold.
  Internally that is a FRACTION contract — at most ``1-q`` of requests may
  exceed the threshold — judged from the windowed histogram's interpolated
  ``fraction_le`` (observations past the top bucket bound count as
  violations, conservatively).
- ``error_rate=<f>`` — at most fraction ``f`` of resolved requests may
  error (engine failures; sheds and cancels are not errors).
- ``availability=<f>`` — at least fraction ``f`` of terminal outcomes must
  be successful answers; errors AND sheds count against it (a 429/503 is
  unavailability from the caller's seat, typed or not).

**Burn rates.** For each objective, ``burn = observed_bad_fraction /
allowed_bad_fraction`` over a window: 1.0 means burning the error budget
exactly as fast as the SLO allots, 10 means the budget lasts a tenth of
the period. Each objective is evaluated over TWO windows — fast (~1m,
"is it on fire") and slow (~10m, "has it been on fire long enough to
matter") — and a **breach** requires both to exceed their thresholds
(``breach_fast_burn`` / ``breach_slow_burn``): the classic multi-window
alert that ignores one bad second at low traffic but fires within a fast
window of a real regression. Breaches are edge-triggered: the transition
into breach appends a typed ``slo_breach`` event to the flight recorder
and dumps it (`obs/recorder.py`), so the post-mortem ring is on disk
while the incident is still happening.

Empty windows are vacuously compliant (burn 0): an idle server is not
violating its latency SLO, it is serving nobody.

The engine is deliberately NOT coupled into the supervisor ladder: the
ladder reacts to engine failures with config changes, the SLO layer
JUDGES externally-visible service quality and surfaces it (/healthz
status line, ``/debug/slo``, ``vnsum_serve_slo_*`` gauges, recorder
dumps). An operator can page on it; the server does not self-mutate on it.

Threading: the whole evaluation (window reads + burn math + breach latch)
serializes under ``make_lock("serve.slo")`` so concurrent evaluators (the
monitor thread, scrape/probe handlers) can never revert the edge-triggered
latch with a staler view. The metrics lock is acquired INSIDE the slo lock
(slo -> metrics, acyclic: nothing acquires slo while holding metrics);
recorder dumps run on a throwaway daemon thread so no probe handler blocks
on fsync. A small daemon monitor thread re-evaluates every ``interval_s``
so breaches fire the recorder even when nobody scrapes.

Copy of ``vnsum_tpu/serve/slo.py``. The port's metrics always keep their
rolling windows (the JAX package's ``windowed=False`` bench lever is not
ported), so the unwindowed branches are gone; every payload is the JAX
package's, ``"windowed": True`` included.
"""
from __future__ import annotations

import re
import threading
import time
from dataclasses import dataclass

from ..analysis.sanitizers import make_lock
from ..core.logging import get_logger

logger = get_logger("vnsum.serve.slo")

# latency objective token: <metric>_p<digits>, e.g. ttft_p99, e2e_p999
_LATENCY_RE = re.compile(r"^(ttft|e2e|queue_wait)_p(\d{2,3})$")
_METRIC_KEYS = {
    "ttft": "ttft_seconds",
    "e2e": "e2e_seconds",
    "queue_wait": "queue_wait_seconds",
}


@dataclass(frozen=True)
class Objective:
    """One parsed objective. ``allowed`` is the bad-outcome fraction the
    SLO budget allots (1-q for latency quantiles, f for error_rate,
    1-f for availability) — the denominator of every burn rate."""

    name: str
    kind: str            # "latency" | "error_rate" | "availability"
    threshold: float     # latency seconds / error fraction / availability
    allowed: float
    metric: str = ""     # windowed-histogram key (latency kinds only)


def parse_slo_spec(text: str) -> dict[str, Objective]:
    """``name=value`` entries, comma-separated, into objectives — the
    ``--slo`` CLI surface. Unknown names, malformed values, and degenerate
    targets (p100, error_rate >= 1, availability of 0) raise ValueError."""
    out: dict[str, Objective] = {}
    for part in [p.strip() for p in text.split(",") if p.strip()]:
        name, sep, raw = part.partition("=")
        name = name.strip()
        if not sep:
            raise ValueError(f"SLO entry {part!r}: want name=value")
        if name in out:
            raise ValueError(f"duplicate SLO objective {name!r}")
        try:
            value = float(raw)
        except ValueError:
            raise ValueError(f"SLO {name!r}: bad value {raw!r}") from None
        m = _LATENCY_RE.match(name)
        if m:
            digits = m.group(2)
            if digits == "100":
                # p100 would silently parse as 100/1000 = p10; a 100th
                # percentile has no error budget anyway — reject loudly
                raise ValueError(
                    f"SLO {name!r}: p100 is degenerate (no error budget); "
                    "use p99/p999"
                )
            q = int(digits) / (10 ** len(digits))
            if not 0.0 < q < 1.0:
                raise ValueError(f"SLO {name!r}: quantile must be in (0,1)")
            if value <= 0:
                raise ValueError(f"SLO {name!r}: threshold must be > 0s")
            out[name] = Objective(name=name, kind="latency", threshold=value,
                                  allowed=1.0 - q,
                                  metric=_METRIC_KEYS[m.group(1)])
        elif name == "error_rate":
            if not 0.0 < value < 1.0:
                raise ValueError("SLO error_rate must be in (0,1)")
            out[name] = Objective(name=name, kind="error_rate",
                                  threshold=value, allowed=value)
        elif name == "availability":
            if not 0.0 < value < 1.0:
                raise ValueError("SLO availability must be in (0,1)")
            out[name] = Objective(name=name, kind="availability",
                                  threshold=value, allowed=1.0 - value)
        else:
            raise ValueError(
                f"unknown SLO objective {name!r} (want "
                "ttft_pNN/e2e_pNN/queue_wait_pNN/error_rate/availability)"
            )
    if not out:
        raise ValueError("empty --slo spec")
    return out


class SloEngine:
    """Evaluates objectives against the metrics' rolling windows."""

    def __init__(
        self,
        objectives: dict[str, Objective],
        metrics,
        *,
        fast_window_s: float = 60.0,
        slow_window_s: float = 600.0,
        breach_fast_burn: float = 10.0,
        breach_slow_burn: float = 1.0,
        recorder=None,
        interval_s: float = 1.0,
        heartbeat=None,
    ) -> None:
        if not objectives:
            raise ValueError("SloEngine needs at least one objective")
        if fast_window_s >= slow_window_s:
            raise ValueError("fast window must be shorter than slow window")
        self.objectives = dict(objectives)
        self.metrics = metrics
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.breach_fast_burn = float(breach_fast_burn)
        self.breach_slow_burn = float(breach_slow_burn)
        self.recorder = recorder
        # lock-order-sanitizer hook: plain threading.Lock in production.
        # Held across the whole evaluation, metrics reads included (the
        # slo -> metrics edge; see the module docstring's race rationale)
        self._lock = make_lock("serve.slo")
        self._breached: set[str] = set()   # guarded by: _lock
        self.breaches_total = 0            # monotone; racy reads fine
        self._last_breach: dict | None = None  # guarded by: _lock
        # watchdog liveness stamp (serve/watchdog.py): a helper-kind
        # Heartbeat the monitor loop beats once per evaluation tick, so a
        # wedged evaluation (stuck metrics lock) is detected and escalated
        # instead of silently stopping SLO judgement. None = unmonitored
        self.heartbeat = heartbeat
        self._stop = threading.Event()
        self._thread = None
        if interval_s and interval_s > 0:
            self._interval_s = float(interval_s)
            self._thread = threading.Thread(
                target=self._monitor, name="vnsum-serve-slo", daemon=True
            )
            self._thread.start()

    # -- evaluation --------------------------------------------------------

    @staticmethod
    def _bad_fraction(obj: Objective, view: dict) -> float:
        if obj.kind == "latency":
            return 1.0 - view["hists"][obj.metric].fraction_le(obj.threshold)
        counts = view["counts"]
        completed = counts.get("completed", 0)
        errors = counts.get("errors", 0)
        if obj.kind == "error_rate":
            denom = completed + errors
            return errors / denom if denom else 0.0
        # availability: sheds count against it too
        shed = counts.get("shed", 0)
        denom = completed + errors + shed
        return (errors + shed) / denom if denom else 0.0

    @staticmethod
    def _exemplar(obj: Objective, view: dict) -> str | None:
        """A recent trace_id from a VIOLATING bucket of the objective's
        window (latency objectives only) — the /debug/trace breadcrumb the
        breach report carries."""
        if obj.kind != "latency":
            return None
        h = view["hists"][obj.metric]
        exemplars = view["exemplars"][obj.metric]
        # buckets wholly above the threshold, worst (most recent by bucket
        # recency) first; fall back to the topmost populated exemplar
        start = h.bucket_index(obj.threshold)
        best: tuple | None = None
        for idx in range(len(exemplars) - 1, start - 1, -1):
            ex = exemplars[idx]
            if ex is not None and ex[1] > obj.threshold:
                if best is None or ex[2] > best[2]:
                    best = ex
        return best[0] if best is not None else None

    def evaluate(self, now: float | None = None) -> dict:
        """One full evaluation: per-objective compliance/burn/budget over
        both windows, breach edge-detection (fires the recorder), and the
        export dict every surface (gauges, /debug/slo, /healthz) renders
        from.

        The WHOLE evaluation — window reads included — runs under the
        engine lock: evaluators race in from the monitor thread and every
        scrape/probe handler, and a thread holding a STALER window view
        must never overwrite a fresher thread's breach latch (that would
        re-detect one sustained breach as a second transition and
        double-fire the recorder). Serializing reads-plus-latch makes the
        latch monotone in view time. The serve.slo -> serve.metrics edge
        this adds is acyclic (nothing acquires slo under the metrics
        lock); recorder I/O still happens after release."""
        with self._lock:
            if now is None:
                # ONE moment for both views: a sub-window boundary falling
                # between the two reads would give fast and slow different
                # window sets and could fire the breach latch on skew
                now = self.metrics.now()
            fast = self.metrics.window_view(self.fast_window_s, now)
            slow = self.metrics.window_view(self.slow_window_s, now)
            objectives: dict[str, dict] = {}
            now_breached: set[str] = set()
            for name, obj in self.objectives.items():
                bad_fast = self._bad_fraction(obj, fast)
                bad_slow = self._bad_fraction(obj, slow)
                burn_fast = bad_fast / obj.allowed
                burn_slow = bad_slow / obj.allowed
                breaching = (burn_fast >= self.breach_fast_burn
                             and burn_slow >= self.breach_slow_burn)
                if breaching:
                    now_breached.add(name)
                entry = {
                    "kind": obj.kind,
                    "target": obj.threshold,
                    "allowed_bad_fraction": obj.allowed,
                    "compliance": 1.0 - bad_fast,
                    "burn_fast": burn_fast,
                    "burn_slow": burn_slow,
                    "budget_remaining": max(0.0, 1.0 - burn_slow),
                    "breaching": breaching,
                }
                ex = self._exemplar(obj, fast)
                if ex is not None:
                    entry["exemplar_trace_id"] = ex
                objectives[name] = entry
            new = now_breached - self._breached
            self._breached = now_breached
            if new:
                self.breaches_total += len(new)
                self._last_breach = {
                    "t_wall": time.time(),
                    "objectives": sorted(new),
                    "detail": {n: objectives[n] for n in sorted(new)},
                }
            last_breach = self._last_breach
        for name in sorted(new):
            o = objectives[name]
            logger.warning(
                "SLO breach: %s burn fast=%.2f slow=%.2f (thresholds "
                "%.2f/%.2f)", name, o["burn_fast"], o["burn_slow"],
                self.breach_fast_burn, self.breach_slow_burn,
            )
            if self.recorder is not None:
                self.recorder.record(
                    "slo_breach", rid=o.get("exemplar_trace_id", ""),
                    objective=name,
                    burn_fast=round(o["burn_fast"], 3),
                    burn_slow=round(o["burn_slow"], 3),
                )
        if new and self.recorder is not None:
            # sustained fast burn IS the anomaly: snapshot the ring while
            # the incident's lead-up is still in it. Off-thread: evaluate()
            # also runs inline in /healthz and /metrics handlers, and a
            # liveness probe must never block on a dump's fsync (the dump
            # is throttled and thread-safe; a daemon thread per breach
            # transition is rare by construction)
            threading.Thread(
                target=self.recorder.dump, args=("slo_fast_burn",),
                name="vnsum-slo-dump", daemon=True,
            ).start()
        return {
            "objectives": objectives,
            "breached": bool(now_breached),
            "breaches_total": self.breaches_total,
            "last_breach": last_breach,
            "windowed": True,
        }

    # -- surfaces ----------------------------------------------------------

    def export_state(self, now: float | None = None) -> dict:
        """The scrape-time payload for the vnsum_serve_slo_* gauges —
        evaluation is cheap (merging a handful of 13-bucket histograms),
        so every scrape judges fresh state rather than a cached verdict."""
        return self.evaluate(now)

    def debug_payload(self) -> dict:
        """``GET /debug/slo``: full objective detail + engine config."""
        state = self.evaluate()
        return {
            "config": {
                "objectives": {
                    name: {"kind": o.kind, "target": o.threshold,
                           "allowed_bad_fraction": o.allowed}
                    for name, o in self.objectives.items()
                },
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "breach_fast_burn": self.breach_fast_burn,
                "breach_slow_burn": self.breach_slow_burn,
            },
            **state,
        }

    def status_line(self) -> str:
        """The one-line /healthz summary: worst burning objective, or the
        minimum budget remaining when everything is inside budget."""
        state = self.evaluate()
        objectives = state["objectives"]
        if state["breached"]:
            # worst among the objectives actually BREACHING — a non-breaching
            # objective can carry the highest fast burn (slow threshold
            # unmet) and must not displace the real page
            worst = max(
                (n for n in objectives if objectives[n]["breaching"]),
                key=lambda n: objectives[n]["burn_fast"],
            )
            o = objectives[worst]
            return (f"BREACH {worst}: burn fast={o['burn_fast']:.1f} "
                    f"slow={o['burn_slow']:.1f}")
        budget = min(o["budget_remaining"] for o in objectives.values())
        return (f"ok ({len(objectives)} objectives, "
                f"budget remaining >= {budget:.3f})")

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # -- monitor thread ----------------------------------------------------

    def _monitor(self) -> None:
        while not self._stop.wait(self._interval_s):
            try:
                if self.heartbeat is not None:
                    self.heartbeat.beat()
                self.evaluate()
            # lint-allow[swallowed-exception]: the monitor is an alerting sidecar — an evaluation bug must not kill it (the next tick retries) and there is no request to resolve
            except Exception:
                logger.exception("SLO evaluation failed; continuing")
