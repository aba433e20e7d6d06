"""Fleet observability federation: one scrape loop, one rollup surface,
one incident bundle.

The router (serve/router.py) already owns routing truth — which worker is
up, where each rid went, when a failover fired. What it could NOT answer
before this module is the fleet-wide observability questions: "what is the
fleet's p99 right now", "which worker is burning the error budget", and
"give me everything every process knows about the last 60 seconds in ONE
artifact". Scraping N workers from Prometheus answers the first at 15s
granularity and the other two never.

Three pieces, all router-side (workers stay dumb — they just answer
``GET /debug/obs/snapshot`` and ``POST /debug/dump``):

- :class:`FleetFederation` — a daemon scrape loop pulling each worker's
  JSON snapshot on a cadence. Counters sum into ``vnsum_serve_fleet_*``
  rollups, histograms merge bucket-for-bucket through
  ``Histogram.merge_from`` (mismatched ladders are a typed
  ``HistogramMergeError``, counted and skipped, never mis-binned), and
  per-worker gauges keep the ``worker=`` label — bounded by the roster
  registry, enforced by the ``metric-label-cardinality`` lint. The same
  samples feed the fleet ``/debug/slo`` + ``/v1/usage`` views and carry
  each worker's **clock offset**, estimated from the scrape's RTT midpoint
  (``worker_mono - (t_send + t_recv)/2``) — the correction that lets
  ``/debug/trace`` stitch worker spans onto the router's clock.

- :class:`IncidentManager` — turns an anomaly moment (fleet SLO fast-burn,
  a mark-down, a failover, an operator SIGUSR1) into ONE on-disk bundle:
  it mints an incident id, snapshots the router's routing-decision ring,
  fans ``POST /debug/dump?incident=<id>`` out to every worker (each
  contributes its flight-recorder ring + thread stacks), and writes a
  manifest with every process's clock anchors. Throttled per trigger
  reason like the flight recorder's dumps — a flapping worker produces one
  bundle, not a disk full.

- :func:`fold_incident_bundle` — the causal-ordering half a report CLI
  and a chaos soak's validator share: every
  event in a bundle maps onto wall time via its process's own anchor
  (``started_wall + t_rel``), so the merged timeline is monotone without
  any cross-process clock agreement beyond NTP-grade wall clocks.

Locks: ``serve.federation`` guards the sample table (never held across a
worker round trip — scrape I/O runs bare, results land under the lock);
``serve.incident`` guards only the throttle/counter state. Both are leaf
locks below ``serve.router`` in the sanitizer's order.

Copy of ``vnsum_tpu/serve/federation.py``; only the imports' package and
this docstring differ. The worker half it scrapes is the port's server
(``GET /debug/obs/snapshot``, ``POST /debug/dump``), whose payloads are the
JAX server's key for key.
"""
from __future__ import annotations

import itertools
import threading
import time
from pathlib import Path

from ..analysis.sanitizers import make_lock
from ..core.artifacts import atomic_write_json
from ..core.logging import get_logger
from ..obs.histogram import Histogram, HistogramMergeError, SCRAPE_BUCKETS_S
from .metrics import _METRICS, _PREFIX

logger = get_logger("vnsum.serve.federation")

# the typed incident trigger vocabulary (the fleet_incidents_total label
# set): fleet SLO fast-burn, a worker mark-down, a journal-handoff
# failover, and the operator's SIGUSR1
INCIDENT_REASONS = ("slo_fast_burn", "markdown", "failover", "operator")

_incident_seq = itertools.count(1)


class WorkerSample:
    """One scrape result: the worker's snapshot plus the router-side
    stamps that date it and align its clock."""

    __slots__ = ("name", "payload", "t_mono", "scrape_s", "clock_offset_s",
                 "error")

    def __init__(self, name: str, payload: dict | None, t_mono: float,
                 scrape_s: float, clock_offset_s: float,
                 error: str | None = None) -> None:
        self.name = name
        self.payload = payload          # /debug/obs/snapshot JSON (or None)
        self.t_mono = t_mono            # router monotonic at receive
        self.scrape_s = scrape_s        # round-trip seconds
        self.clock_offset_s = clock_offset_s  # worker mono -> router mono
        self.error = error

    def age_s(self) -> float:
        return time.monotonic() - self.t_mono


class FleetFederation:
    """Scrape loop + rollup state over a RouterState's worker table."""

    def __init__(self, state, *, interval_s: float = 1.0,
                 stale_after_s: float | None = None,
                 fast_burn_cb=None) -> None:
        self.state = state
        self.interval_s = max(float(interval_s), 0.02)
        # a sample older than this no longer steers markdown decisions or
        # counts toward fleet SLO verdicts (default: two missed scrapes)
        self.stale_after_s = (
            float(stale_after_s) if stale_after_s is not None
            else 2.0 * self.interval_s + 0.5
        )
        # called (once per sweep, with a detail string) when any fresh
        # worker sample reports a breaching SLO — the router wires this to
        # IncidentManager.trigger("slo_fast_burn"); throttling lives there
        self.fast_burn_cb = fast_burn_cb
        # leaf lock: guards the sample table and counters, never held
        # across worker I/O
        self._lock = make_lock("serve.federation")
        self._samples: dict[str, WorkerSample] = {}  # guarded by: _lock
        self._scrapes: dict[str, int] = {}           # guarded by: _lock
        self._errors: dict[str, int] = {}            # guarded by: _lock
        self._merge_errors = 0                       # guarded by: _lock
        self._scrape_hist = Histogram(SCRAPE_BUCKETS_S)  # guarded by: _lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="router-federation", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.scrape_all()

    # -- scraping ----------------------------------------------------------

    def scrape_all(self) -> None:
        """One sweep over the roster (also callable synchronously — the
        /debug/trace stitcher pulls a fresh sweep so just-finished worker
        spans make the merged trace)."""
        for w in list(self.state.workers):
            self.scrape_one(w)
        if self.fast_burn_cb is not None:
            burning = [
                (name, s.payload["slo"]["burn_fast_max"])
                for name, s in self.samples().items()
                if s.payload is not None
                and s.age_s() <= self.stale_after_s
                and (s.payload.get("slo") or {}).get("breached")
            ]
            if burning:
                self.fast_burn_cb(
                    "fleet SLO fast-burn: " + ", ".join(
                        f"{n} burn={b:.1f}" for n, b in sorted(burning)
                    )
                )

    def scrape_one(self, w) -> WorkerSample:
        """Pull one worker's snapshot; the RTT midpoint of this very round
        trip estimates the worker's monotonic-clock offset."""
        t0 = time.monotonic()
        payload, err = None, None
        try:
            status, body = self.state._worker_http(
                w, "GET", "/debug/obs/snapshot",
                timeout=self.state.probe_timeout_s,
            )
            if status == 200 and isinstance(body, dict):
                payload = body
            else:
                err = f"http:{status}"
        # lint-allow[swallowed-exception]: a refused scrape becomes the sample's error field and the staleness gauge — the fleet view degrades, nothing strands
        except OSError as e:
            err = str(e) or e.__class__.__name__
        t1 = time.monotonic()
        if payload is not None:
            # the worker stamped mono_now somewhere inside [t0, t1] on OUR
            # clock; the midpoint is the minimum-variance estimate, off by
            # at most RTT/2 — microseconds-to-milliseconds on loopback,
            # far below the span durations being aligned
            offset = float(payload.get("mono_now", 0.0)) - (t0 + t1) / 2.0
        else:
            prev = self.sample(w.name)
            offset = prev.clock_offset_s if prev is not None else 0.0
        sample = WorkerSample(w.name, payload, t1, t1 - t0, offset, err)
        with self._lock:
            self._scrapes[w.name] = self._scrapes.get(w.name, 0) + 1
            if err is not None:
                self._errors[w.name] = self._errors.get(w.name, 0) + 1
                # keep the previous good payload (staleness gauges show
                # its age) rather than blanking the fleet view on one
                # refused connection
                prev = self._samples.get(w.name)
                if prev is not None and prev.payload is not None:
                    prev.error = err
                    self._scrape_hist.observe(t1 - t0)
                    return prev
            self._samples[w.name] = sample
            self._scrape_hist.observe(t1 - t0)
        return sample

    # -- sample access -----------------------------------------------------

    def sample(self, name: str) -> WorkerSample | None:
        with self._lock:
            return self._samples.get(name)

    def samples(self) -> dict[str, WorkerSample]:
        with self._lock:
            return dict(self._samples)

    def fresh_payload(self, name: str) -> dict | None:
        """The worker's snapshot if recent enough to act on (the probe
        loop's federation-fed markdown policy), else None."""
        s = self.sample(name)
        if s is None or s.payload is None or s.age_s() > self.stale_after_s:
            return None
        return s.payload

    # -- rollups -----------------------------------------------------------

    def fleet_rollup(self) -> dict:
        """Counters summed, histograms merged, gauges kept per-worker —
        the aggregation-kind discipline: a summed gauge or an averaged
        histogram would lie."""
        counters: dict[str, int] = {}
        hists: dict[str, Histogram] = {}
        per_worker: dict[str, dict] = {}
        merge_errors = 0
        for name, s in sorted(self.samples().items()):
            if s.payload is None:
                per_worker[name] = {"stale": True, "age_s": round(s.age_s(), 3)}
                continue
            p = s.payload
            for k, v in (p.get("counters") or {}).items():
                counters[k] = counters.get(k, 0) + int(v)
            for k, st in (p.get("hists") or {}).items():
                try:
                    h = Histogram.from_state(st)
                    if k in hists:
                        hists[k].merge_from(h)
                    else:
                        hists[k] = h
                # lint-allow[swallowed-exception]: counted into merge_errors and logged — the rollup proceeds without the skewed worker's buckets, which IS the resolution
                except HistogramMergeError as e:
                    # a worker on a different ladder (version skew mid
                    # rolling-restart): skip its contribution, count it,
                    # never mis-bin — the typed error is the contract
                    merge_errors += 1
                    logger.warning("fleet histogram merge skipped for "
                                   "%s/%s: %s", name, k, e)
            row: dict = {
                "stale": s.age_s() > self.stale_after_s,
                "age_s": round(s.age_s(), 3),
                "clock_offset_s": round(s.clock_offset_s, 6),
                "ready": bool(p.get("ready")),
                "readyz_reason": p.get("readyz_reason", ""),
                "queue_depth": int(p.get("queue_depth", 0)),
            }
            if "degraded_rung" in p:
                row["degraded_rung"] = int(p["degraded_rung"])
            if "slo" in p:
                row["slo_breached"] = bool(p["slo"].get("breached"))
                row["slo_burn_fast_max"] = float(
                    p["slo"].get("burn_fast_max", 0.0)
                )
            if "watchdog" in p:
                row["watchdog_max_heartbeat_age_s"] = float(
                    p["watchdog"].get("max_heartbeat_age_s", 0.0)
                )
            per_worker[name] = row
        if merge_errors:
            with self._lock:
                self._merge_errors += merge_errors
        return {"counters": counters, "hists": hists,
                "per_worker": per_worker}

    def fleet_slo(self) -> dict:
        """The fleet ``/debug/slo`` view: every worker's objective table
        side by side, plus the per-worker burn attribution the "which
        replica is eating the budget" question needs."""
        workers: dict[str, dict] = {}
        attribution = []
        breached = False
        burn_fast_max = 0.0
        for name, s in sorted(self.samples().items()):
            if s.payload is None:
                workers[name] = {"stale": True}
                continue
            slo = s.payload.get("slo")
            if slo is None:
                workers[name] = {"slo": None,
                                 "stale": s.age_s() > self.stale_after_s}
                continue
            stale = s.age_s() > self.stale_after_s
            workers[name] = {**slo, "stale": stale}
            if not stale:
                breached = breached or bool(slo.get("breached"))
                burn = float(slo.get("burn_fast_max", 0.0))
                burn_fast_max = max(burn_fast_max, burn)
                attribution.append({"worker": name, "burn_fast_max": burn,
                                    "breached": bool(slo.get("breached"))})
        attribution.sort(key=lambda r: -r["burn_fast_max"])
        return {
            "role": "router",
            "breached": breached,
            "burn_fast_max": round(burn_fast_max, 4),
            "burn_attribution": attribution,
            "workers": workers,
        }

    def fleet_usage(self) -> dict:
        """The fleet ``/v1/usage`` view: per-tenant counters summed across
        workers; latency quantiles reported as the worst (max) worker
        quantile — quantiles do not sum, and for an SLO consumer the
        conservative bound is the honest merge without shipping every
        bucket ladder per tenant."""
        tenants: dict[str, dict] = {}
        per_worker: dict[str, dict] = {}
        window_s = None
        for name, s in sorted(self.samples().items()):
            if s.payload is None or "usage" not in s.payload:
                continue
            window_s = s.payload.get("usage_window_s", window_s)
            per_worker[name] = s.payload["usage"]
            for tenant, row in s.payload["usage"].items():
                agg = tenants.setdefault(tenant, {})
                for k, v in row.items():
                    if isinstance(v, dict):  # queue_wait / ttft / e2e
                        sub = agg.setdefault(k, {"count": 0})
                        sub["count"] += int(v.get("count", 0))
                        for q in ("p50_s", "p95_s", "p99_s"):
                            sub[q] = round(
                                max(sub.get(q, 0.0), float(v.get(q, 0.0))),
                                6,
                            )
                    else:
                        agg[k] = agg.get(k, 0) + int(v)
        return {"role": "router", "window_s": window_s,
                "tenants": tenants, "workers": per_worker}

    # -- trace stitching ---------------------------------------------------

    def trace_groups(self) -> list[dict]:
        """Per-worker groups for obs.export.merged_chrome_trace, clock
        offsets applied. Fan-out child rids (``base#N``) normalize to the
        base trace id so every hop of one client request — including the
        pre- and post-failover worker halves — lands in one merged
        process."""
        groups = []
        for name, s in sorted(self.samples().items()):
            if s.payload is None:
                continue
            traces = []
            for t in s.payload.get("traces") or []:
                base = str(t.get("trace_id", "")).partition("#")[0]
                if base != t.get("trace_id"):
                    t = {**t, "trace_id": base}
                traces.append(t)
            if traces:
                groups.append({"source": name,
                               "clock_offset_s": s.clock_offset_s,
                               "traces": traces})
        return groups

    # -- metrics -----------------------------------------------------------

    def metrics_lines(self, registry) -> list[str]:
        """vnsum_serve_federation_* + vnsum_serve_fleet_* text-format
        lines for the router's /metrics. ``registry`` is the router's
        bounded worker-roster TenantLabelRegistry — every ``worker=``
        label value passes through ``registry.canonical`` (the
        metric-label-cardinality contract for fleet series)."""
        rollup = self.fleet_rollup()
        with self._lock:
            scrapes = dict(self._scrapes)
            errors = dict(self._errors)
            scrape_hist = self._scrape_hist.copy()
        samples = self.samples()
        lines: list[str] = []

        def meta(name: str) -> None:
            typ, help_ = _METRICS[name]  # KeyError = unregistered metric
            lines.append(f"# HELP {_PREFIX}{name} {help_}")
            lines.append(f"# TYPE {_PREFIX}{name} {typ}")

        def worker_rows(name: str, rows) -> None:
            meta(name)
            for wname, value in rows:
                # worker= values pass through the roster registry — the
                # metric-label-cardinality rule requires the canonical()
                # call inline for fleet worker labels
                lines.append(
                    f'{_PREFIX}{name}'
                    f'{{worker="{registry.canonical(wname, touch=False)}"}}'
                    f" {value}"
                )

        worker_rows("federation_scrapes_total", sorted(scrapes.items()))
        worker_rows("federation_scrape_errors_total",
                    sorted(errors.items()))
        worker_rows("federation_staleness_seconds",
                    [(n, round(s.age_s(), 3))
                     for n, s in sorted(samples.items())])
        worker_rows("federation_clock_offset_seconds",
                    [(n, round(s.clock_offset_s, 6))
                     for n, s in sorted(samples.items())])
        typ, help_ = _METRICS["federation_scrape_seconds"]
        lines.extend(scrape_hist.render(
            f"{_PREFIX}federation_scrape_seconds", help_
        ))
        meta("fleet_requests_total")
        lines.append(f"{_PREFIX}fleet_requests_total "
                     f"{rollup['counters'].get('requests_total', 0)}")
        meta("fleet_requests_completed_total")
        lines.append(
            f"{_PREFIX}fleet_requests_completed_total "
            f"{rollup['counters'].get('requests_completed_total', 0)}"
        )
        meta("fleet_requests_errored_total")
        lines.append(
            f"{_PREFIX}fleet_requests_errored_total "
            f"{rollup['counters'].get('requests_errored_total', 0)}"
        )
        meta("fleet_generated_tokens_total")
        lines.append(
            f"{_PREFIX}fleet_generated_tokens_total "
            f"{rollup['counters'].get('generated_tokens_total', 0)}"
        )
        for hist_name in ("fleet_e2e_seconds", "fleet_ttft_seconds"):
            h = rollup["hists"].get(hist_name[len("fleet_"):])
            if h is not None:
                typ, help_ = _METRICS[hist_name]
                lines.extend(h.render(f"{_PREFIX}{hist_name}", help_))
        per_worker = rollup["per_worker"]

        def gauge_rows(name: str, key) -> None:
            rows = [
                (n, row[key]) for n, row in sorted(per_worker.items())
                if key in row
            ]
            if rows:
                worker_rows(name, rows)

        # up = fresh AND ready: a stale sample means the scrape loop has
        # lost sight of the worker, which for a fleet dashboard is down
        worker_rows("fleet_worker_up", [
            (n, 1 if (row.get("ready") and not row.get("stale")) else 0)
            for n, row in sorted(per_worker.items())
        ])
        gauge_rows("fleet_queue_depth", "queue_depth")
        gauge_rows("fleet_degraded_rung", "degraded_rung")
        gauge_rows("fleet_slo_burn_fast", "slo_burn_fast_max")
        rows = [
            (n, 1 if row.get("slo_breached") else 0)
            for n, row in sorted(per_worker.items())
            if "slo_breached" in row
        ]
        if rows:
            worker_rows("fleet_slo_breached", rows)
        return lines

    def stats_dict(self) -> dict:
        with self._lock:
            return {
                "scrapes": sum(self._scrapes.values()),
                "errors": sum(self._errors.values()),
                "merge_errors": self._merge_errors,
                "workers_sampled": len(self._samples),
            }


class IncidentManager:
    """Mints incident ids and collects one correlated bundle per trigger.

    A bundle directory (``<incident_dir>/<incident_id>/``) holds:
    ``manifest.json`` (trigger, wall time, per-process clock anchors),
    ``router.json`` (the router's routing-decision flight-recorder ring +
    health snapshot), and one ``worker_<name>.json`` per reachable worker
    (its ring + thread stacks, via ``POST /debug/dump?incident=``).
    """

    def __init__(self, state, federation: FleetFederation | None,
                 directory: str | Path | None, *,
                 min_interval_s: float = 30.0) -> None:
        self.state = state
        self.federation = federation
        self.directory = Path(directory) if directory else None
        self.min_interval_s = float(min_interval_s)
        # leaf lock: throttle stamps + counters only — capture I/O runs
        # on its own thread, never under any lock
        self._lock = make_lock("serve.incident")
        self._last: dict[str, float] = {}   # reason -> mono  # guarded by: _lock
        self.counts: dict[str, int] = {}    # reason -> fired  # guarded by: _lock

    def trigger(self, reason: str, detail: str = "",
                sync: bool = False) -> str | None:
        """Mint + capture an incident for ``reason`` (throttled per
        reason). Returns the incident id, or None when disabled or
        throttled. ``sync=True`` captures on the calling thread (tests,
        the SIGUSR1 handler's thread)."""
        if self.directory is None:
            return None
        now = time.monotonic()
        with self._lock:
            last = self._last.get(reason)
            if last is not None and now - last < self.min_interval_s:
                return None
            self._last[reason] = now
            self.counts[reason] = self.counts.get(reason, 0) + 1
        incident = (f"inc_{int(time.time() * 1000)}"
                    f"_{next(_incident_seq):03d}")
        recorder = getattr(self.state, "recorder", None)
        if recorder is not None:
            recorder.record("incident", incident=incident, reason=reason,
                            detail=detail)
        logger.warning("incident %s minted (%s): %s", incident, reason,
                       detail or "-")
        if sync:
            self._capture(incident, reason, detail)
        else:
            threading.Thread(
                target=self._capture, args=(incident, reason, detail),
                name=f"incident-{incident}", daemon=True,
            ).start()
        return incident

    def _capture(self, incident: str, reason: str, detail: str) -> None:
        bundle = self.directory / incident
        try:
            bundle.mkdir(parents=True, exist_ok=True)
        # lint-allow[swallowed-exception]: an unwritable incident dir must not crash the capture thread — logged, and workers' own --flight-dir dumps still fire
        except OSError:
            logger.exception("incident %s: bundle dir %s", incident, bundle)
            return
        state = self.state
        manifest: dict = {
            "incident": incident,
            "reason": reason,
            "detail": detail,
            "wall": time.time(),
            "router": {
                "started_wall": state.started_wall,
                "mono_now": time.monotonic(),
            },
            "workers": {},
        }
        router_doc: dict = {"source": "router",
                            "health": state.health_payload()}
        recorder = getattr(state, "recorder", None)
        if recorder is not None:
            router_doc["flightrecorder"] = recorder.snapshot()
        collected = 0
        for w in list(state.workers):
            entry: dict = {"host": w.host, "port": w.port}
            if self.federation is not None:
                s = self.federation.sample(w.name)
                if s is not None:
                    entry["clock_offset_s"] = round(s.clock_offset_s, 6)
            try:
                status, body = state._worker_http(
                    w, "POST", f"/debug/dump?incident={incident}",
                    body={}, timeout=state.probe_timeout_s,
                )
            # lint-allow[swallowed-exception]: an unreachable worker (often the very process whose death minted the incident) lands in the manifest as an error entry — the bundle records the absence
            except OSError as e:
                entry["error"] = str(e) or e.__class__.__name__
                manifest["workers"][w.name] = entry
                continue
            if status == 200 and isinstance(body, dict):
                entry["file"] = f"worker_{w.name}.json"
                atomic_write_json(bundle / entry["file"],
                                  {"source": w.name, **body})
                collected += 1
            else:
                entry["error"] = f"http:{status}"
            manifest["workers"][w.name] = entry
        manifest["workers_collected"] = collected
        atomic_write_json(bundle / "router.json", router_doc)
        atomic_write_json(bundle / "manifest.json", manifest)
        logger.warning("incident %s: bundle at %s (%d/%d worker(s))",
                       incident, bundle, collected, len(state.workers))

    def counts_snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self.counts)


# -- bundle folding -------------------------------------------------------------


def fold_incident_bundle(bundle_dir: str | Path) -> dict:
    """Load one incident bundle and fold every process's flight-recorder
    ring into a single causally-ordered timeline.

    Each ring's events carry ``t_rel`` seconds since that PROCESS started
    plus the ring's ``started_wall`` anchor — so each event maps onto wall
    time with only its own process's anchors, and the merged sort is
    monotone by construction. Returns ``{"incident", "reason", "wall",
    "sources", "events": [{"wall", "source", "kind", ...}]}``.
    """
    import json

    bundle = Path(bundle_dir)
    manifest = json.loads((bundle / "manifest.json").read_text())
    events: list[dict] = []
    sources: dict[str, dict] = {}

    def fold_ring(source: str, doc: dict) -> None:
        ring = doc.get("flightrecorder")
        if not ring:
            sources[source] = {"events": 0}
            return
        anchor = float(ring.get("started_wall", 0.0))
        n = 0
        for e in ring.get("events", []):
            events.append({
                "wall": round(anchor + float(e.get("t_rel", 0.0)), 6),
                "source": source,
                **{k: v for k, v in e.items() if k != "t_rel"},
            })
            n += 1
        sources[source] = {"events": n, "started_wall": anchor,
                           "dropped": ring.get("events_dropped", 0)}

    router_file = bundle / "router.json"
    if router_file.exists():
        fold_ring("router", json.loads(router_file.read_text()))
    for name, entry in sorted((manifest.get("workers") or {}).items()):
        f = entry.get("file")
        if not f:
            continue
        path = bundle / f
        if path.exists():
            fold_ring(name, json.loads(path.read_text()))
    events.sort(key=lambda e: (e["wall"], e["source"], e.get("seq", 0)))
    return {
        "incident": manifest.get("incident"),
        "reason": manifest.get("reason"),
        "detail": manifest.get("detail", ""),
        "wall": manifest.get("wall"),
        "sources": sources,
        "events": events,
    }
