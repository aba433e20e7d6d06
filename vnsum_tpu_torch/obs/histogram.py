"""Fixed-bucket cumulative histograms with Prometheus text rendering.

The serving metrics (`serve/metrics.py`) were flat counters plus one
hand-rolled bucket array; this module makes the histogram a first-class,
reusable unit: ``observe()`` is two integer adds and a float add (no
allocation — safe on a per-request path), rendering emits the standard
Prometheus ``_bucket``/``_sum``/``_count`` cumulative text format, and
``percentile()`` derives p50/p95/p99 from the buckets the way a PromQL
``histogram_quantile`` would (linear interpolation inside the bucket), so
bench scripts can snapshot quantiles without retaining raw samples.

Not internally locked: owners that observe from multiple threads
(`serve/metrics.ServeMetrics`) already serialize under their own lock, and a
second lock per observation would be pure overhead.

Copy of ``vnsum_tpu/obs/histogram.py``; only the imports and the names of
the device and its engine differ.
"""
from __future__ import annotations


# shared bucket ladders (seconds unless noted). Spans are chosen to cover
# sub-millisecond coalescing waits through multi-second strategy runs; the
# serving metrics registry in serve/metrics.py maps names -> ladders.
WAIT_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                  1.0, 2.5, 5.0)
TTFT_BUCKETS_S = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                  10.0)
E2E_BUCKETS_S = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                 30.0, 60.0)
OCCUPANCY_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
ACCEPT_BUCKETS = (0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0)
# a /metrics render costs tens of microseconds to low milliseconds — a
# self-metric on the WAIT ladder (floor 1ms) would put every scrape in the
# first bucket and report nothing
SCRAPE_BUCKETS_S = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3,
                    5e-3, 0.01, 0.025, 0.05, 0.1)


def _fmt(v: float) -> str:
    """Prometheus-style number: integral values without the trailing .0."""
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class HistogramMergeError(ValueError):
    """Two histograms with different bucket ladders cannot be merged.

    Typed (not a bare ValueError) because the fleet federation layer
    (serve/federation.py) merges histograms scraped off REMOTE processes:
    a worker running a different build can legitimately ship a different
    ladder, and the scrape loop must catch exactly this condition and
    skip the series rather than silently corrupting the rollup counts or
    swallowing unrelated ValueErrors."""


class Histogram:
    """Cumulative fixed-bucket histogram (Prometheus semantics).

    ``counts[i]`` is the NON-cumulative count of observations in
    ``(bounds[i-1], bounds[i]]``; the final slot is the +Inf tail. Rendering
    accumulates, matching the ``le``-labelled cumulative contract scrapers
    expect.
    """

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds) -> None:
        b = tuple(float(x) for x in bounds)
        if not b or list(b) != sorted(b):
            raise ValueError("bucket bounds must be non-empty and ascending")
        self.bounds = b
        self.counts = [0] * (len(b) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.sum += value
        self.count += 1
        for i, ub in enumerate(self.bounds):
            if value <= ub:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def reset(self) -> None:
        """Zero in place (no allocation — `obs/window.py` recycles expired
        sub-windows through here on the observe path)."""
        for i in range(len(self.counts)):
            self.counts[i] = 0
        self.sum = 0.0
        self.count = 0

    def merge_from(self, other: "Histogram") -> None:
        """Add ``other``'s counts into this histogram (same bounds required)
        — how `obs/window.WindowedHistogram` folds its live sub-windows into
        one readable histogram, and how the fleet federation rolls worker
        histograms up. Mismatched ladders raise :class:`HistogramMergeError`
        instead of silently mis-binning counts."""
        if other.bounds != self.bounds:
            raise HistogramMergeError(
                "cannot merge histograms with different bounds: "
                f"{self.bounds} vs {other.bounds}"
            )
        for i, n in enumerate(other.counts):
            self.counts[i] += n
        self.sum += other.sum
        self.count += other.count

    def bucket_index(self, value: float) -> int:
        """Index of the bucket ``value`` falls in (len(bounds) = +Inf tail)."""
        for i, ub in enumerate(self.bounds):
            if value <= ub:
                return i
        return len(self.bounds)

    def fraction_le(self, x: float) -> float:
        """Fraction of observations <= ``x``, interpolated inside the bucket
        ``x`` falls in — the compliance estimator the SLO engine
        (`serve/slo.py`) judges latency objectives with. The +Inf tail is
        conservatively counted as ABOVE any finite ``x`` (an observation
        past the top bound is a violation we cannot bound). Empty histogram
        = vacuous compliance (1.0)."""
        if not self.count:
            return 1.0
        cum = 0
        lo = 0.0
        for i, ub in enumerate(self.bounds):
            if x < ub:
                frac = (x - lo) / (ub - lo) if ub > lo else 1.0
                return (cum + self.counts[i] * max(min(frac, 1.0), 0.0)) / self.count
            cum += self.counts[i]
            lo = ub
        return cum / self.count

    def percentile(self, q: float) -> float:
        """Quantile estimate from the buckets (histogram_quantile rules):
        find the bucket where the cumulative count crosses ``q * count``,
        interpolate linearly inside it. Observations in the +Inf tail report
        the highest finite bound — a floor, exactly like PromQL."""
        if not self.count:
            return 0.0
        rank = q * self.count
        cum = 0
        lo = 0.0
        for i, ub in enumerate(self.bounds):
            prev = cum
            cum += self.counts[i]
            if cum >= rank:
                frac = (rank - prev) / self.counts[i] if self.counts[i] else 0.0
                return lo + (ub - lo) * frac
            lo = ub
        return self.bounds[-1]

    # -- export ----------------------------------------------------------

    def render(self, name: str, help_: str,
               exemplars: list | None = None) -> list[str]:
        """Prometheus text-format lines: HELP/TYPE then cumulative
        ``_bucket{le=...}`` rows, ``_sum``, ``_count``. ``exemplars`` is an
        optional per-bucket list of (trace_id, value, t) tuples (see
        `obs/window.WindowedHistogram.exemplars`): buckets with one get the
        OpenMetrics-style ``# {trace_id="..."} value`` suffix that links a
        bad latency bucket straight to its request in ``/debug/trace``."""
        lines = [f"# HELP {name} {help_}", f"# TYPE {name} histogram"]
        cum = 0
        for i, (ub, n) in enumerate(zip(self.bounds, self.counts)):
            cum += n
            line = f'{name}_bucket{{le="{_fmt(ub)}"}} {cum}'
            if exemplars is not None and i < len(exemplars) and exemplars[i]:
                ex_id, ex_val, _t = exemplars[i]
                line += f' # {{trace_id="{ex_id}"}} {round(ex_val, 6)}'
            lines.append(line)
        cum += self.counts[-1]
        tail = f'{name}_bucket{{le="+Inf"}} {cum}'
        if exemplars is not None and exemplars[-1]:
            ex_id, ex_val, _t = exemplars[-1]
            tail += f' # {{trace_id="{ex_id}"}} {round(ex_val, 6)}'
        lines.append(tail)
        lines.append(f"{name}_sum {round(self.sum, 6)}")
        lines.append(f"{name}_count {cum}")
        return lines

    def to_dict(self) -> dict:
        """Snapshot for bench JSON: buckets plus derived p50/p95/p99 — the
        quantiles BENCH_*.json files report instead of bare means."""
        return {
            "buckets": {
                **{_fmt(ub): n for ub, n in zip(self.bounds, self.counts)},
                "+Inf": self.counts[-1],
            },
            "sum": round(self.sum, 6),
            "count": self.count,
            "p50": round(self.percentile(0.50), 6),
            "p95": round(self.percentile(0.95), 6),
            "p99": round(self.percentile(0.99), 6),
        }

    def state_dict(self) -> dict:
        """Raw mergeable state (bounds + non-cumulative counts) — the wire
        format the fleet federation scrapes off each worker's JSON snapshot
        endpoint. Distinct from :meth:`to_dict`, whose bucket keys are
        render-formatted strings and whose quantiles are derived."""
        return {
            "bounds": list(self.bounds),
            "counts": list(self.counts),
            "sum": self.sum,
            "count": self.count,
        }

    @classmethod
    def from_state(cls, state: dict) -> "Histogram":
        """Rebuild a histogram from :meth:`state_dict` output (possibly
        deserialized from another process). Malformed state — a counts
        vector that does not match the ladder — raises
        :class:`HistogramMergeError`, the same typed error a downstream
        merge would hit."""
        h = cls(state["bounds"])
        counts = [int(n) for n in state["counts"]]
        if len(counts) != len(h.counts):
            raise HistogramMergeError(
                f"counts length {len(counts)} does not match ladder of "
                f"{len(h.bounds)} bounds (+Inf tail)"
            )
        h.counts = counts
        h.sum = float(state["sum"])
        h.count = int(state["count"])
        return h

    def copy(self) -> "Histogram":
        h = Histogram(self.bounds)
        h.counts = list(self.counts)
        h.sum = self.sum
        h.count = self.count
        return h
