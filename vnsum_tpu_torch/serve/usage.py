"""Per-tenant usage accounting behind a bounded-cardinality label registry.

Copy of ``vnsum_tpu/serve/usage.py``. Without it the obs layer answers
per-tenant questions with two counters (requests, quota sheds). Operators billing a multi-tenant service need the full ledger —
tokens in/out, cache savings, preemption/cancel/shed churn, and WINDOWED
latency per tenant (a tenant's p99 over the last minute, not since boot).
This module is that ledger, with one structural safeguard:

**Bounded cardinality.** Tenant names become Prometheus label values, and a
metric family's cost is its label cardinality — a caller cycling through
ten thousand tenant names (hostile or buggy) must not grow the scrape, the
ledger, or the registry without bound. :class:`TenantLabelRegistry` is the
ONE funnel every dynamically-labeled metric emission in serve/ routes
through (the ``metric-label-cardinality`` analysis rule enforces this
syntactically): it charset-sanitizes the name and caps the distinct names
tracked — the first ``cap`` names keep their own label, everything later
collapses into the ``other`` overflow label. Recency is tracked (LRU
order) so introspection shows who is active, but tracked names are never
evicted into ``other`` retroactively: a tenant's series never silently
merges after it has been reported.

Not internally locked: the owning `serve/metrics.ServeMetrics` serializes
every observation and snapshot under its one metrics lock, the same
contract as `obs/histogram.py` — per-tenant counts can therefore never
disagree with the aggregate counters they shipped with.
"""
from __future__ import annotations

import re
from collections import OrderedDict

from ..analysis.sanitizers import make_lock
from ..obs.histogram import (
    E2E_BUCKETS_S,
    TTFT_BUCKETS_S,
    WAIT_BUCKETS_S,
)
from ..obs.window import WindowedHistogram

# mirrors serve/qos.py's tenant-name charset: these names land verbatim in
# Prometheus label values, so quotes/backslashes/whitespace would corrupt
# the whole exposition
_NAME_RE = re.compile(r"[A-Za-z0-9_.-]+")

OTHER_LABEL = "other"
DEFAULT_TENANT = "default"


class TenantLabelRegistry:
    """Capped map from request-carried tenant names to metric label values.

    ``canonical(name)`` sanitizes and either returns the name (already
    tracked, or the cap has room) or :data:`OTHER_LABEL`. Declared tenants
    should be seeded at construction (``seed=``) so a table tenant can
    never lose its label to earlier hostile traffic.

    Self-locking, unlike the ledger: ``canonical`` is called both under
    the metrics lock (ledger observations) and bare at render time (label
    emission after the metrics snapshot is taken), so it carries its own
    innermost lock — it never acquires another serve lock while held.
    """

    # distinct-overflow tracking is itself bounded: past this many distinct
    # overflow names the `overflowed` gauge saturates ("at least N") —
    # the hostile-churn threat model must not buy memory through the very
    # counter that reports it
    OVERFLOW_TRACK_CAP = 4096

    def __init__(self, cap: int = 64, seed=None) -> None:
        self.cap = max(int(cap), 1)
        # lock-order-sanitizer hook: plain threading.Lock in production
        self._lock = make_lock("serve.labels")
        self._names: OrderedDict[str, None] = OrderedDict()  # guarded by: _lock
        self.overflowed = 0  # distinct names collapsed into "other" (saturating); monotone, racy reads fine
        self._overflow_seen: set[int] = set()                # guarded by: _lock
        for name in seed or ():
            self.track(name)

    def track(self, name: str) -> str:
        """Unconditionally reserve a label for a DECLARED tenant (the
        --tenants table). Operator config is bounded by definition, so
        seeding may grow past ``cap`` — otherwise past-the-cap declared
        tenants would all collapse into ``other`` and the per-tenant qos
        series would emit duplicate label sets (a whole-scrape reject).
        The cap guards dynamic, request-carried names only."""
        name = self.sanitize(name)
        if name == OTHER_LABEL:
            return OTHER_LABEL
        with self._lock:
            if name not in self._names:
                self._names[name] = None
        return name

    @staticmethod
    def sanitize(name: str) -> str:
        if name and _NAME_RE.fullmatch(name):
            return name
        cleaned = re.sub(r"[^A-Za-z0-9_.-]", "_", name or "")
        return cleaned or DEFAULT_TENANT

    def canonical(self, name: str, touch: bool = True) -> str:
        """The metric-safe label for ``name`` — THE helper the
        metric-label-cardinality lint requires on every dynamic label.
        Idempotent: the overflow label itself canonicalizes to itself
        without counting as an overflowed tenant (render paths re-feed
        ledger keys that are already canonical). ``touch=False`` is the
        read-path form: scrape-time emission must not rewrite the LRU
        recency that observation-path traffic established."""
        name = self.sanitize(name)
        if name == OTHER_LABEL:
            return OTHER_LABEL
        with self._lock:
            if name in self._names:
                if touch:
                    self._names.move_to_end(name)  # recency: who is active
                return name
            if len(self._names) < self.cap:
                self._names[name] = None
                return name
            # cap reached: the overflow label absorbs every new name.
            # Distinct-name counting is bounded too (OVERFLOW_TRACK_CAP
            # hashes, then the gauge saturates)
            h = hash(name)
            if (
                h not in self._overflow_seen
                and len(self._overflow_seen) < self.OVERFLOW_TRACK_CAP
            ):
                self._overflow_seen.add(h)
                self.overflowed += 1
            return OTHER_LABEL

    def tracked(self) -> list[str]:
        """Tracked names, least-recently-used first."""
        with self._lock:
            return list(self._names)


class TenantUsage:
    """One tenant's ledger row: monotone counters + windowed latency."""

    __slots__ = (
        "requests", "completed", "errors", "sheds", "cancels",
        "preemptions", "requeues", "prompt_tokens", "generated_tokens",
        "cached_tokens", "queue_wait", "ttft", "e2e",
    )

    def __init__(self, horizon_s: float, sub_windows: int, clock) -> None:
        self.requests = 0
        self.completed = 0
        self.errors = 0
        self.sheds = 0
        self.cancels = 0
        self.preemptions = 0
        self.requeues = 0
        self.prompt_tokens = 0
        self.generated_tokens = 0
        self.cached_tokens = 0
        kw = dict(horizon_s=horizon_s, sub_windows=sub_windows, clock=clock)
        self.queue_wait = WindowedHistogram(WAIT_BUCKETS_S, **kw)
        self.ttft = WindowedHistogram(TTFT_BUCKETS_S, **kw)
        self.e2e = WindowedHistogram(E2E_BUCKETS_S, **kw)


class UsageLedger:
    """All tenants' usage rows, keyed by the registry's canonical labels so
    the ledger itself is as bounded as the scrape."""

    def __init__(self, registry: TenantLabelRegistry | None = None,
                 horizon_s: float = 600.0, sub_windows: int = 60,
                 clock=None) -> None:
        import time

        self.registry = registry or TenantLabelRegistry()
        self.horizon_s = float(horizon_s)
        self.sub_windows = int(sub_windows)
        self._clock = clock or time.monotonic
        self._tenants: dict[str, TenantUsage] = {}

    def row(self, tenant: str) -> TenantUsage:
        key = self.registry.canonical(tenant or DEFAULT_TENANT)
        row = self._tenants.get(key)
        if row is None:
            row = TenantUsage(self.horizon_s, self.sub_windows, self._clock)
            self._tenants[key] = row
        return row

    # -- observation hooks (called by ServeMetrics under ITS lock) --------

    def observe_submit(self, tenant: str, n: int = 1) -> None:
        self.row(tenant).requests += n

    def observe_shed(self, tenant: str, n: int = 1) -> None:
        self.row(tenant).sheds += n

    def observe_cancel(self, tenant: str, n: int = 1) -> None:
        self.row(tenant).cancels += n

    def observe_preemption(self, tenant: str, n: int = 1) -> None:
        self.row(tenant).preemptions += n

    def observe_requeue(self, tenant: str, n: int = 1) -> None:
        self.row(tenant).requeues += n

    def observe_request(self, tenant: str, rec) -> None:
        """One terminal ServeRequestRecord: tokens, outcome, and the
        windowed latency observations (TTFT only when anchored — the same
        honesty rule the aggregate histogram applies)."""
        row = self.row(tenant)
        row.prompt_tokens += rec.prompt_tokens
        row.generated_tokens += rec.generated_tokens
        row.cached_tokens += rec.cached_prompt_tokens
        row.queue_wait.observe(rec.queue_wait_s, exemplar=rec.trace_id)
        if rec.status == "ok":
            row.completed += 1
            if rec.ttft_anchored:
                row.ttft.observe(rec.ttft_s, exemplar=rec.trace_id)
            row.e2e.observe(rec.total_s, exemplar=rec.trace_id)
        elif rec.status == "error":
            row.errors += 1

    # -- export ------------------------------------------------------------

    def tenants(self) -> list[str]:
        return sorted(self._tenants)

    def snapshot(self, window_s: float | None = None) -> dict:
        """{tenant: {counters..., latency quantiles over ``window_s``}} —
        the `GET /v1/usage` payload and the bench's usage evidence. ONE
        ``now`` for the whole snapshot, so a sub-window boundary crossed
        mid-iteration cannot skew tenants (or metrics within a tenant)
        against each other."""
        now = self._clock()
        out = {}
        for name in self.tenants():
            row = self._tenants[name]
            entry = {
                "requests": row.requests,
                "completed": row.completed,
                "errors": row.errors,
                "sheds": row.sheds,
                "cancels": row.cancels,
                "preemptions": row.preemptions,
                "requeues": row.requeues,
                "prompt_tokens": row.prompt_tokens,
                "generated_tokens": row.generated_tokens,
                "cached_tokens_saved": row.cached_tokens,
            }
            for key, wh in (("queue_wait", row.queue_wait),
                            ("ttft", row.ttft), ("e2e", row.e2e)):
                h = wh.merged(window_s, now)
                entry[key] = {
                    "count": h.count,
                    "p50_s": round(h.percentile(0.50), 6),
                    "p95_s": round(h.percentile(0.95), 6),
                    "p99_s": round(h.percentile(0.99), 6),
                }
            out[name] = entry
        return out
