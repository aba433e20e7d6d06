"""Multi-tenant QoS: tenant declarations, token-rate quotas, and the
weighted-fair (deficit-round-robin) pick the request queue schedules with.

The serving stack used to treat every caller identically: one tenant's
151-doc map-reduce fan-out sits in front of every interactive user behind
it, and FIFO order is the starvation. This module is the policy layer that
fixes it (survey arXiv:2405.13019 names iteration-level scheduling with
request priorities as the serving-side lever batching alone cannot
provide):

- :func:`parse_tenant_specs` turns ``--tenants name:weight:token_rate[:tier]``
  strings into :class:`TenantSpec`\\ s (weight > 0 enforced — a zero-weight
  tenant is a misconfiguration, not a muted one);
- :class:`TokenBucket` is the per-tenant rate quota: ``token_rate`` tokens/s
  refill with a bounded burst, and a failed take returns the EXACT
  refill-derived Retry-After seconds the HTTP layer renders;
- :class:`TenantTable` owns the live scheduling state: quota admission
  (:meth:`TenantTable.admit`) consulted by the queue's one admission
  predicate, and the deficit-round-robin pick (:meth:`TenantTable.select`)
  the queue's ``take_batch``/``take_upto`` route their candidate sets
  through. Interactive-tier requests are always picked before batch-tier
  ones (the priority half of QoS — preemption in serve/inflight.py is the
  enforcement half); within a tier, tenants share in proportion to their
  weights over token-costed deficits (DRR, Shreedhar & Varghese '95), and
  within a tenant order stays FIFO.

Fall-through contract (pinned by tests/test_torch_serve_qos.py): with no table —
or with every candidate in one tenant — the queue's behavior is byte-
identical to the pre-QoS FIFO (including the cache-hint clustering), so
single-tenant deployments pay nothing for the feature.

Threading: the table has one internal lock (``make_lock("serve.tenants")``).
The queue lock is always held while consulting it (admission + pick), so
the tenants lock is innermost, next to the journal lock in the lock-order
sanitizer's graph; it never acquires any other serve lock while held.

Copy of ``vnsum_tpu/serve/qos.py``; only the test file named above and this
paragraph differ. The same
candidates give the same picks, buckets and stats in both packages.
"""
from __future__ import annotations

import re
import time
from dataclasses import dataclass

from ..analysis.sanitizers import make_lock

# tenant names land verbatim in Prometheus label values — keep them to a
# charset that can never corrupt the exposition format
_NAME_RE = re.compile(r"[A-Za-z0-9_.-]+")


def _label_safe(name: str) -> str:
    """Declared tenants are charset-validated at parse time; names arriving
    on REQUESTS (library callers, replayed journals) are sanitized instead
    of raised on — the scheduling path must serve, never throw."""
    if name and _NAME_RE.fullmatch(name):
        return name
    cleaned = re.sub(r"[^A-Za-z0-9_.-]", "_", name or "")
    return cleaned or DEFAULT_TENANT

# priority tiers: interactive work is picked first and may preempt batch
# work resident in the in-flight loop (serve/inflight.py)
TIER_INTERACTIVE = "interactive"
TIER_BATCH = "batch"
TIERS = (TIER_INTERACTIVE, TIER_BATCH)

# the tenant traffic lands on when no X-Tenant header is sent (auto-added
# to every table unless the operator declares their own "default")
DEFAULT_TENANT = "default"


class UnknownTenant(ValueError):
    """An X-Tenant header naming a tenant the table doesn't declare — the
    HTTP layer maps it to a typed 400, never a silent default."""


@dataclass(frozen=True)
class TenantSpec:
    """One declared tenant: scheduling weight, token-rate quota, tier.

    ``token_rate`` is billable prompt tokens per second (0 = unlimited);
    ``burst`` is the bucket capacity — how many tokens a quiet tenant may
    spend at once before the rate applies (defaults to two seconds of
    refill, floored at one request's worth)."""

    name: str
    weight: float = 1.0
    token_rate: float = 0.0
    tier: str = TIER_INTERACTIVE
    burst: float = 0.0

    def __post_init__(self) -> None:
        # label-safe charset: tenant names become Prometheus label values
        # verbatim (vnsum_serve_qos_*{tenant="..."}), so quotes/backslashes/
        # whitespace would corrupt the whole /metrics exposition
        if not self.name or not _NAME_RE.fullmatch(self.name):
            raise ValueError(
                f"bad tenant name {self.name!r} (want [A-Za-z0-9_.-]+)"
            )
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0 (got {self.weight})"
            )
        if self.token_rate < 0:
            raise ValueError(f"tenant {self.name!r}: token_rate must be >= 0")
        if self.tier not in TIERS:
            raise ValueError(
                f"tenant {self.name!r}: tier must be one of {TIERS}"
            )
        if self.burst <= 0:
            # frozen dataclass: derive the default through __setattr__
            object.__setattr__(
                self, "burst", max(self.token_rate * 2.0, 1.0)
            )


def parse_tenant_specs(spec: str) -> dict[str, TenantSpec]:
    """``name:weight:token_rate[:tier]`` entries, comma-separated, into a
    spec map — the ``--tenants`` CLI surface. Raises ValueError on
    duplicates, zero/negative weights, or unknown tiers."""
    out: dict[str, TenantSpec] = {}
    for part in [p.strip() for p in spec.split(",") if p.strip()]:
        fields = part.split(":")
        if len(fields) not in (3, 4):
            raise ValueError(
                f"tenant spec {part!r}: want name:weight:token_rate[:tier]"
            )
        name = fields[0].strip()
        if name in out:
            raise ValueError(f"duplicate tenant {name!r}")
        out[name] = TenantSpec(
            name=name,
            weight=float(fields[1]),
            token_rate=float(fields[2]),
            tier=fields[3].strip() if len(fields) == 4 else TIER_INTERACTIVE,
        )
    if not out:
        raise ValueError("empty --tenants spec")
    return out


class TokenBucket:
    """Classic leaky token bucket: ``rate`` tokens/s refill up to ``burst``
    capacity. ``take`` either consumes and returns None, or refuses and
    returns the refill-derived seconds until the request WOULD fit — the
    Retry-After the typed QUOTA shed carries. Not self-locking: the owning
    TenantTable serializes access."""

    def __init__(self, rate: float, burst: float) -> None:
        self.rate = float(rate)
        self.burst = float(burst)
        self.level = float(burst)
        self._stamp = time.monotonic()

    def _refill(self, now: float) -> None:
        # clamp negative elapsed: tests drive synthetic clocks, and a
        # backwards step must never drain the bucket
        self.level = min(
            self.burst,
            self.level + max(now - self._stamp, 0.0) * self.rate,
        )
        self._stamp = now

    def take(self, tokens: float, now: float | None = None) -> float | None:
        if self.rate <= 0:
            return None  # unlimited tenant
        now = time.monotonic() if now is None else now
        self._refill(now)
        # a request larger than the whole burst can never fit; bill it the
        # full burst instead of refusing forever (it drains the bucket and
        # pays the rate like everyone else)
        need = min(float(tokens), self.burst)
        if need <= self.level:
            self.level -= need
            return None
        return (need - self.level) / self.rate


@dataclass
class _TenantState:
    spec: TenantSpec
    bucket: TokenBucket | None
    deficit: float = 0.0


class TenantTable:
    """Live multi-tenant scheduling state: specs + buckets + DRR deficits.

    ``quantum_tokens`` is the deficit added per DRR visit before weighting;
    larger quanta batch a tenant's turns coarser, smaller ones interleave
    finer — proportionality over long runs is the same either way."""

    def __init__(self, specs: dict[str, TenantSpec],
                 quantum_tokens: float = 256.0) -> None:
        if not specs:
            raise ValueError("TenantTable needs at least one tenant")
        if DEFAULT_TENANT not in specs:
            specs = {**specs, DEFAULT_TENANT: TenantSpec(DEFAULT_TENANT)}
        self.quantum_tokens = float(quantum_tokens)
        # lock-order-sanitizer hook: the queue lock is held while consulting
        # this table (admission + pick), so this lock is always innermost
        self._lock = make_lock("serve.tenants")
        self._tenants: dict[str, _TenantState] = {}  # guarded by: _lock
        self._ring: list[str] = []                   # guarded by: _lock
        self._ring_pos = 0                           # guarded by: _lock
        # tenants interrupted mid-grant by a take filling up: the next
        # visit resumes their unspent deficit WITHOUT a fresh quantum, so
        # take-size truncation never inflates anyone's grant count (that
        # equal count is what makes long-run share converge to the
        # weight ratio)
        self._mid_grant: dict[str, bool] = {}        # guarded by: _lock
        for name, spec in specs.items():
            bucket = (
                TokenBucket(spec.token_rate, spec.burst)
                if spec.token_rate > 0 else None
            )
            self._tenants[name] = _TenantState(spec=spec, bucket=bucket)
            self._ring.append(name)

    # -- resolution / admission ------------------------------------------

    def resolve(self, name: str | None) -> TenantSpec:
        """Header value -> spec; empty/None falls to the default tenant,
        unknown names raise :class:`UnknownTenant` (typed 400 upstream)."""
        with self._lock:
            st = self._tenants.get(name or DEFAULT_TENANT)
            if st is None:
                raise UnknownTenant(
                    f"unknown tenant {name!r} (declared: "
                    f"{sorted(self._tenants)})"
                )
            return st.spec

    def admit(self, tenant: str, tokens: int) -> float | None:
        """Quota gate for the queue's one admission predicate: None admits
        (and bills the bucket), a float is the refill-derived Retry-After
        of a typed QUOTA shed. Unknown tenants (internal fan-out, replay of
        a journal from an older tenant config) admit unlimited. Counting
        lives in ServeMetrics (the one ledger the scrape renders) — this
        table holds only scheduling/quota STATE."""
        with self._lock:
            st = self._tenants.get(tenant or DEFAULT_TENANT)
            if st is None or st.bucket is None:
                return None
            return st.bucket.take(tokens)

    def refund(self, tenant: str, tokens: int, *, deficit: bool = False) -> None:
        """Unwind QoS accounting for a request cancelled before any engine
        work (serve/scheduler.py cancellation): the tokens it billed at
        admission return to its rate bucket (capped at burst — a refund
        never banks beyond the bucket's ceiling), and with ``deficit=True``
        (a request cancelled after take but before dispatch) the DRR
        deficit it drained at the take commit point is credited back, so a
        cancel storm can't silently tax one tenant's long-run share.
        Unknown tenants no-op, mirroring :meth:`admit`."""
        with self._lock:
            st = self._tenants.get(tenant or DEFAULT_TENANT)
            if st is None:
                return
            if st.bucket is not None and st.bucket.rate > 0:
                st.bucket.level = min(
                    st.bucket.burst, st.bucket.level + max(float(tokens), 0.0)
                )
            if deficit:
                st.deficit += max(float(tokens), 0.0)

    # -- the deficit-round-robin pick ------------------------------------

    def _state_for_locked(self, name: str) -> _TenantState:
        """Requests may carry tenants the table no longer (or never)
        declares — replayed journals, direct API users. They schedule as a
        weight-1 interactive tenant instead of being dropped."""
        st = self._tenants.get(name or DEFAULT_TENANT)
        if st is None:
            st = _TenantState(spec=TenantSpec(name or DEFAULT_TENANT),
                              bucket=None)
            self._tenants[name] = st
            self._ring.append(name)
        return st

    def select(self, candidates: list, max_take: int) -> list:
        """Pick up to ``max_take`` of ``candidates`` (ServeRequests, queue
        FIFO order) by tier then deficit round robin. Interactive-tier
        candidates are exhausted before any batch-tier one is picked;
        within a tier each backlogged tenant's deficit grows by
        quantum * weight per visit and drains by the picked request's token
        cost, so long-run token share converges to the weight ratio.
        Deficits persist across calls (that IS the long-run memory); a
        tenant whose backlog empties forfeits its remainder — classic DRR,
        no hoarding. Within one tenant, FIFO order is preserved. Always
        returns at least one request when candidates is non-empty."""
        if not candidates or max_take < 1:
            return []
        out: list = []
        with self._lock:
            by_tier: dict[str, dict[str, list]] = {}
            for r in candidates:
                tier = getattr(r, "tier", TIER_INTERACTIVE)
                tier = tier if tier in TIERS else TIER_INTERACTIVE
                # sanitized, so a request-carried name can neither raise
                # here (the take path must serve) nor corrupt a metrics
                # label downstream
                tenant = _label_safe(getattr(r, "tenant", ""))
                # register undeclared tenants (journal replay after a
                # --tenants change, direct API callers) BEFORE the ring
                # loop below: a backlog whose tenant the ring never visits
                # would spin the pick forever with the queue lock held
                self._state_for_locked(tenant)
                by_tier.setdefault(tier, {}).setdefault(tenant, []).append(r)
            for tier in TIERS:
                backlogs = by_tier.get(tier)
                if not backlogs:
                    continue
                while len(out) < max_take and any(backlogs.values()):
                    # the ring persists across calls so visit order — and
                    # therefore quantum accrual — is fair over time, not
                    # reset per take
                    name = self._ring[self._ring_pos % len(self._ring)]
                    backlog = backlogs.get(name)
                    if not backlog:
                        self._ring_pos += 1
                        continue
                    st = self._state_for_locked(name)
                    if not self._mid_grant.get(name):
                        st.deficit += self.quantum_tokens * st.spec.weight
                    self._mid_grant[name] = False
                    while backlog and len(out) < max_take:
                        cost = max(
                            getattr(backlog[0], "billable_tokens", 1), 1
                        )
                        if st.deficit < cost:
                            break
                        st.deficit -= cost
                        out.append(backlog.pop(0))
                    if not backlog:
                        # emptied backlog forfeits its remainder: a quiet
                        # tenant must not bank service it never queued for
                        st.deficit = 0.0
                        backlogs.pop(name, None)
                        self._ring_pos += 1
                    elif len(out) >= max_take and st.deficit >= max(
                        getattr(backlog[0], "billable_tokens", 1), 1
                    ):
                        # interrupted mid-grant by the take filling: stay
                        # on this tenant and resume the unspent deficit
                        # next call, no fresh quantum
                        self._mid_grant[name] = True
                    else:
                        self._ring_pos += 1
                if len(out) >= max_take:
                    break
        return out

    # -- scrape surface ----------------------------------------------------

    def multi_tenant(self, candidates: list) -> bool:
        """True when ``candidates`` span more than one (tenant, tier) — the
        queue's gate for WFQ selection vs the byte-identical FIFO
        fall-through."""
        seen = set()
        for r in candidates:
            seen.add((getattr(r, "tenant", "") or DEFAULT_TENANT,
                      getattr(r, "tier", TIER_INTERACTIVE)))
            if len(seen) > 1:
                return True
        return False

    def stats(self) -> dict:
        """Scrape-time snapshot of CONFIG + quota state per tenant:
        {tenant: {weight, token_rate, tier, bucket_tokens}}. Per-tenant
        request/shed counters live in ServeMetrics (the one ledger), never
        here — two ledgers for the same facts would drift."""
        now = time.monotonic()
        with self._lock:
            out = {}
            for name, st in self._tenants.items():
                bucket_tokens = None
                if st.bucket is not None:
                    st.bucket._refill(now)
                    bucket_tokens = round(st.bucket.level, 3)
                out[name] = {
                    "weight": st.spec.weight,
                    "token_rate": st.spec.token_rate,
                    "tier": st.spec.tier,
                    "bucket_tokens": bucket_tokens,
                }
            return out
