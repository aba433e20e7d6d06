"""Rolling-window histograms and counters: "how is it doing NOW" state.

A cumulative histogram counts since start — exactly right for
Prometheus scrapes (the server computes rates), and exactly wrong for the
in-process consumers this repo keeps growing: the SLO engine
(`serve/slo.py`) needs "TTFT p99 over the last minute", the per-tenant
usage ledger (`serve/usage.py`) needs recent latency per tenant, and
neither can afford to retain raw samples.

:class:`WindowedHistogram` is the standard ring-of-sub-windows construction:
a horizon of N fixed-span sub-windows, each an ordinary
`obs/histogram.Histogram`. ``observe()`` lands in the sub-window the
timestamp belongs to (the expired occupant of that ring slot is zeroed in
place — no allocation), so the per-observation cost stays the
two-int-add-plus-float of the underlying histogram. Reads merge the live
sub-windows into one histogram (``merged()``), optionally over just the
most recent ``window_s`` — one ring serves both the fast (~1m) and slow
(~10m) burn-rate windows of the SLO engine.

Resolution note: a read over ``window_s`` covers the ceil(window_s/sub_s)
most recent sub-windows — between window_s - sub_s and window_s of real
time depending on where "now" sits inside the current sub-window. The SLO
math divides fractions, not absolute counts, so this granularity error
cancels; pick sub-window counts so sub_s << fast window (the serving
default is a 10s sub-window under a 60s fast window).

Exemplars: ``observe(..., exemplar=trace_id)`` remembers the most recent
(trace_id, value, timestamp) per BUCKET, aged out past the horizon — the
OpenMetrics-style breadcrumb that links a bad p99 bucket straight to its
request's timeline in ``/debug/trace``.

Like `obs/histogram.py` and `obs/telemetry.py`, nothing here locks: owners
(`serve/metrics.ServeMetrics`) already serialize observations and reads
under their own lock. ``now`` is injectable everywhere so the window-math
property tests drive a synthetic clock.

Copy of ``vnsum_tpu/obs/window.py``; only the imports and the names of the
device and its engine differ.
"""
from __future__ import annotations

import math
import time

from .histogram import Histogram


class _Ring:
    """The epoch/slot bookkeeping both windowed types share: which ring
    slot an observation at time ``t`` lands in (recycling the expired
    occupant in place), and which slots are still live for a read.

    epoch = which absolute sub-window interval a slot currently holds;
    -1 = never written. A slot whose epoch trails the current one has
    fully expired and is recycled on the next write that lands in it."""

    __slots__ = ("horizon_s", "sub_s", "_epochs")

    def __init__(self, horizon_s: float, sub_windows: int) -> None:
        if horizon_s <= 0 or sub_windows < 1:
            raise ValueError("horizon_s must be > 0 and sub_windows >= 1")
        self.horizon_s = float(horizon_s)
        self.sub_s = self.horizon_s / int(sub_windows)
        self._epochs = [-1] * int(sub_windows)

    def write_slot(self, now: float) -> tuple[int, bool]:
        """(slot for an observation at ``now``, whether the caller must
        zero the slot's expired occupant first)."""
        e = int(now // self.sub_s)
        slot = e % len(self._epochs)
        recycle = self._epochs[slot] != e
        if recycle:
            self._epochs[slot] = e
        return slot, recycle

    def live_slots(self, now: float, window_s: float | None):
        """Slots of the sub-windows live within ``window_s`` (default: the
        whole horizon), most recent first."""
        e = int(now // self.sub_s)
        k = len(self._epochs)
        if window_s is not None:
            k = min(k, max(1, math.ceil(window_s / self.sub_s)))
        for j in range(k):
            ep = e - j
            if ep < 0:
                break
            slot = ep % len(self._epochs)
            if self._epochs[slot] == ep:
                yield slot


class WindowedHistogram:
    """Ring of ``sub_windows`` fixed-bucket histograms spanning
    ``horizon_s`` seconds, merged on read."""

    __slots__ = ("bounds", "_ring", "_subs", "_exemplars", "_clock")

    def __init__(self, bounds, horizon_s: float = 600.0,
                 sub_windows: int = 60, clock=time.monotonic) -> None:
        self.bounds = tuple(float(x) for x in bounds)
        self._ring = _Ring(horizon_s, sub_windows)
        self._subs = [Histogram(self.bounds) for _ in range(int(sub_windows))]
        # per-bucket most recent exemplar: (trace_id, value, t) or None
        self._exemplars: list[tuple | None] = [None] * (len(self.bounds) + 1)
        self._clock = clock

    @property
    def horizon_s(self) -> float:
        return self._ring.horizon_s

    @property
    def sub_s(self) -> float:
        return self._ring.sub_s

    def observe(self, value: float, now: float | None = None,
                exemplar: str | None = None) -> None:
        now = self._clock() if now is None else now
        slot, recycle = self._ring.write_slot(now)
        if recycle:
            # in place, no allocation on the observe path
            self._subs[slot].reset()
        self._subs[slot].observe(value)
        if exemplar is not None:
            idx = self._subs[slot].bucket_index(value)
            self._exemplars[idx] = (exemplar, value, now)

    def merged(self, window_s: float | None = None,
               now: float | None = None) -> Histogram:
        """One histogram over the live sub-windows — the whole horizon by
        default, or just the most recent ``window_s`` of it."""
        now = self._clock() if now is None else now
        out = Histogram(self.bounds)
        for slot in self._ring.live_slots(now, window_s):
            out.merge_from(self._subs[slot])
        return out

    def exemplars(self, window_s: float | None = None,
                  now: float | None = None) -> list[tuple | None]:
        """Per-bucket (trace_id, value, t) exemplars no older than
        ``window_s`` (default: the horizon)."""
        now = self._clock() if now is None else now
        max_age = self.horizon_s if window_s is None else float(window_s)
        return [
            ex if ex is not None and now - ex[2] <= max_age else None
            for ex in self._exemplars
        ]


class WindowedCounter:
    """Keyed monotone counts over the same ring construction — the windowed
    request/error/shed tallies the SLO engine's error-rate and availability
    objectives divide. O(1) add; reads sum the live sub-windows."""

    __slots__ = ("_ring", "_subs", "_clock")

    def __init__(self, horizon_s: float = 600.0, sub_windows: int = 60,
                 clock=time.monotonic) -> None:
        self._ring = _Ring(horizon_s, sub_windows)
        self._subs: list[dict[str, float]] = [
            {} for _ in range(int(sub_windows))
        ]
        self._clock = clock

    @property
    def horizon_s(self) -> float:
        return self._ring.horizon_s

    @property
    def sub_s(self) -> float:
        return self._ring.sub_s

    def add(self, key: str, n: float = 1, now: float | None = None) -> None:
        now = self._clock() if now is None else now
        slot, recycle = self._ring.write_slot(now)
        if recycle:
            self._subs[slot].clear()
        sub = self._subs[slot]
        sub[key] = sub.get(key, 0) + n

    def totals(self, window_s: float | None = None,
               now: float | None = None) -> dict[str, float]:
        """{key: count} summed over the live sub-windows of ``window_s``."""
        now = self._clock() if now is None else now
        out: dict[str, float] = {}
        for slot in self._ring.live_slots(now, window_s):
            for key, n in self._subs[slot].items():
                out[key] = out.get(key, 0) + n
        return out

    def total(self, key: str, window_s: float | None = None,
              now: float | None = None) -> float:
        return self.totals(window_s, now).get(key, 0)
