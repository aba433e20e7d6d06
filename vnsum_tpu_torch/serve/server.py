"""Online serving HTTP front-end (stdlib only).

Counterpart of ``vnsum_tpu/serve/server.py`` on the port's engine:

    python -m vnsum_tpu_torch.serve.server --backend torch --model llama3.2:3b \
        --max-batch 16 --max-wait-ms 10 [--inflight]
    python -m vnsum_tpu_torch.serve.server --backend torch --device cpu ...
    python -m vnsum_tpu_torch.serve.server --backend fake --port 8901

``--backend torch`` runs on the card; ``--device cpu`` is the only way
onto the CPU. Not ported yet, and refused by name: ``--journal-dir``,
``--journal-fsync-ms``, ``--tenants``, ``--preempt-budget``, ``--slo``,
``--slo-burn-fast`` and ``--slo-burn-slow`` (ROADMAP A15b), ``--mesh``
(A10) and ``--backend hf`` (A5c). ``GET /v1/requests/<id>`` therefore
answers a typed 404 (no journal), and ``/debug/slo`` reports SLOs off.

Endpoints:
    POST /v1/summarize  {"text": ..., "approach": "mapreduce",
                         "deadline_ms"?, "max_new_tokens"?, "request_id"?}
        Full strategy run. The strategy's rounds are submitted through the
        micro-batching scheduler, so concurrent summarize requests share
        engine batches.
    POST /v1/generate   {"prompt": str} | {"prompts": [str, ...]},
                        optional "max_new_tokens", "temperature", "top_k",
                        "top_p", "seed", "deadline_ms", "request_id",
                        "reference"/"references", "cache_hint"/"cache_hints",
                        "stream"
        Raw engine call(s) through the queue. ``"stream": true`` (single
        prompt) answers as Server-Sent Events: ``delta`` events carry text
        as decode segments retire it (concatenated deltas are byte-
        identical to the final text) and the terminal ``done`` event
        carries the exact non-streaming payload. /v1/summarize accepts
        ``stream`` too (``progress`` events per strategy round + the same
        ``done`` payload).
    GET /healthz        liveness + queue depth
    GET /v1/requests/<id>  the durable-serving poll surface: a typed 404
                        until the journal is ported (ROADMAP A15b)
    DELETE /v1/requests/<id>  first-class cancellation: idempotent,
                        gang-cancels <id>#N fan-out children; queued
                        requests resolve immediately, slot residents are
                        evicted (without requeue) at the next segment
                        boundary. Streaming requests also cancel
                        automatically on client disconnect once the
                        bounded resume window (--stream-idle-timeout-s)
                        expires; within it, a reconnect with Last-Event-ID
                        resumes via one full-text snapshot event
    GET /metrics        Prometheus text (serve/metrics.py): counters plus
                        queue-wait/TTFT/e2e/occupancy/spec histograms,
                        usage series, and OpenMetrics-style trace_id
                        exemplars on the latency buckets
    GET /v1/usage       usage ledger (serve/usage.py): token/outcome
                        counters + windowed latency quantiles, under the
                        one tenant "default"; ?tenant= filters one tenant
    GET /debug/slo      a typed 404 until SLOs are ported (ROADMAP A15b)
    GET /debug/flightrecorder
                        the flight recorder's typed-event ring
                        (obs/recorder.py); anomalies also dump it to
                        --flight-dir
    GET /debug/stacks   every thread's Python stack on demand — the manual
                        twin of the watchdog's automatic stall dump
                        (serve/watchdog.py); SIGUSR1 writes the same
                        snapshot to --flight-dir. /healthz carries the
                        watchdog verdict (last-beat age per registered
                        thread, stall/recovery counters)
    GET /debug/trace    Chrome trace-event JSON of the recent-request ring
                        (vnsum_tpu_torch.obs) — load in ui.perfetto.dev; one track
                        per request, one per engine batch. ?save=1 also
                        writes the dump into --trace-dir.

Request correlation: every response carries an ``X-Request-Id`` header and a
``request_id`` JSON field — client-supplied (JSON "request_id" or an
X-Request-Id request header) or generated — and the same id names the
request's track in /debug/trace and its ServeRequestRecord.trace_id.

Sheds (queue full, token budget, deadline, shutdown) return HTTP 429 with a
typed JSON body {"error": "shed", "reason": "<queue_full|...>"} — the
admission-control contract, machine-readable for client backoff.

Each HTTP handler thread blocks on its request futures; ThreadingHTTPServer
gives us one thread per in-flight request, and the scheduler coalesces
across them. Strategy objects are constructed once per approach and reused
across requests/threads — they are re-entrant by contract (all per-run
state is local to summarize_batch; see strategies/base.py).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..backend.base import Backend, get_backend
from ..core.config import APPROACHES, GenerationConfig, PipelineConfig, approach_defaults
from ..core.logging import get_logger
from ..obs import ObsHub
from ..obs.export import save_timestamped_trace
from ..strategies import get_strategy
from ..text import clean_thinking_tokens
from .queue import RequestCancelled, RequestShed, ShedReason
from .scheduler import MicroBatchScheduler
from .supervisor import RequestFailed

logger = get_logger("vnsum.serve.http")


class ServeState:
    """Everything the handler needs: the scheduler (which owns the engine)
    plus a lazily-built per-approach strategy cache."""

    def __init__(
        self,
        backend: Backend,
        *,
        max_batch: int = 8,
        max_wait_s: float = 0.01,
        max_queue_depth: int = 256,
        max_queued_tokens: int = 0,
        default_deadline_s: float | None = None,
        default_spec_k: int = 0,
        trace_sample: float = 1.0,
        trace_ring: int = 256,
        trace_dir: str | None = None,
        inflight: bool = False,
        slots: int | None = None,
        slot_prompt_tokens: int = 0,
        fused_segments: int = 1,
        supervisor=None,
        supervise: bool = True,
        journal_dir: str | None = None,
        mesh=None,
        tenants=None,
        stream_heartbeat_s: float = 15.0,
        stream_idle_timeout_s: float = 10.0,
        slo: str | None = None,
        slo_fast_s: float = 60.0,
        slo_slow_s: float = 600.0,
        flight_dir: str | None = None,
        flight_events: int = 4096,
        watchdog: bool = True,
        watchdog_interval_s: float = 0.5,
        watchdog_stall_s: float = 10.0,
        watchdog_dispatch_base_s: float = 30.0,
        watchdog_dispatch_per_token_s: float = 0.01,
        watchdog_exit_on_escalate: bool = True,
    ) -> None:
        self.backend = backend
        # not ported yet: each refuses by name rather than serving without
        # the guarantee it stands for
        for arg, value, what in (
            ("journal_dir", journal_dir, "durable serving (serve/journal.py) is ROADMAP A15b"),
            ("tenants", tenants, "multi-tenant QoS (serve/qos.py) is ROADMAP A15b"),
            ("slo", slo, "SLOs (serve/slo.py) are ROADMAP A15b"),
            ("mesh", mesh, "multi-card serving is ROADMAP A10"),
        ):
            if value:
                raise NotImplementedError(f"ServeState({arg}=...): {what}, not ported yet")
        # uptime anchors for /healthz (monotonic for the math, wall clock
        # for the human-readable start stamp)
        self.started_monotonic = time.monotonic()
        self.started_wall = time.time()
        # stream hardening (serve/stream.py): SSE keepalive cadence (0 =
        # no heartbeats) and the bounded resume window — a streaming
        # request whose consumer disconnected and never reattached within
        # the idle window is CANCELLED by the scheduler sweep; 0 cancels
        # immediately on disconnect (no resume window at all)
        self.stream_heartbeat_s = max(float(stream_heartbeat_s), 0.0)
        self.stream_idle_timeout_s = max(float(stream_idle_timeout_s), 0.0)
        # live streams by request id — the Last-Event-ID reconnect surface
        from .stream import StreamRegistry

        self.streams = StreamRegistry()
        # fault tolerance (serve/supervisor.py): ON by default for the HTTP
        # front-end — engine failures are classified, survivors retried,
        # poison requests bisected out, and repeated resource failures step
        # the degradation ladder down to a typed 503 brownout. supervise=
        # False (--no-supervise) restores the raw fail-the-batch contract
        if supervisor is None and supervise:
            from .supervisor import EngineSupervisor

            supervisor = EngineSupervisor()
        self.supervisor = supervisor
        # mirrors the backend's GenerationConfig(spec_k=...) default so a
        # request-built config (which REPLACES the backend default) keeps it
        self.default_spec_k = default_spec_k
        # tracing (vnsum_tpu_torch.obs): trace_sample=0 disables it outright — no
        # hub, no RequestTrace allocations, `is None` checks only (the
        # serving-bench <2% overhead criterion runs in that mode). The
        # always-on histograms in serve/metrics.py are independent of this.
        self.obs = (
            ObsHub(sample=trace_sample, ring=trace_ring)
            if trace_sample > 0 else None
        )
        self.trace_dir = trace_dir
        if trace_dir:
            # arm the device-profile hook (core/profiling.py): any
            # device_profile() call in this process now lands its torch.profiler trace
            # next to the Chrome dumps written here
            os.environ.setdefault("VNSUM_PROFILE_DIR", trace_dir)
        # production observability: rolling-window metrics + usage ledger
        # (serve/metrics.py over obs/window.py, the windows spanning
        # --slo-slow-s, the usage gauges --slo-fast-s) and the flight
        # recorder (obs/recorder.py), always on
        from .metrics import ServeMetrics

        self.metrics = ServeMetrics(
            horizon_s=max(slo_slow_s, 2 * slo_fast_s),
            sub_windows=60,
        )
        self.metrics.usage_window_s = slo_fast_s
        from ..obs.recorder import FlightRecorder

        self.recorder = FlightRecorder(capacity=flight_events,
                                       directory=flight_dir)
        # liveness (serve/watchdog.py): heartbeat
        # registry + bounded-dispatch contract + stall recovery. ON by
        # default — hang detection is part of the serving contract;
        # watchdog=False is the bench A/B's off arm, never an operator
        # flag (--no-watchdog exists for debugging a misbehaving detector,
        # not for production). Escalation (lock/helper stalls, where a
        # replacement thread would deadlock too) is a supervised exit:
        # WATCHDOG_EXIT_CODE tells the process manager to restart.
        # watchdog_exit_on_escalate=False (tests/benches embedding a
        # ServeState in-process) records but keeps the process
        self.watchdog = None
        self._watchdog_escalations = 0
        if watchdog:
            from .watchdog import Watchdog

            self._watchdog_exit = watchdog_exit_on_escalate
            self.watchdog = Watchdog(
                interval_s=watchdog_interval_s,
                loop_deadline_s=watchdog_stall_s,
                helper_deadline_s=max(watchdog_stall_s * 6, 60.0),
                dispatch_base_s=watchdog_dispatch_base_s,
                dispatch_per_token_s=watchdog_dispatch_per_token_s,
                recorder=self.recorder,
                dump_dir=flight_dir,
                on_escalate=self._watchdog_escalate,
            )
        common = dict(
            max_batch=max_batch,
            max_wait_s=max_wait_s,
            max_queue_depth=max_queue_depth,
            max_queued_tokens=max_queued_tokens,
            metrics=self.metrics,
            obs=self.obs,
            trace_dir=trace_dir,
            supervisor=supervisor,
            recorder=self.recorder,
            watchdog=self.watchdog,
        )
        if inflight:
            # in-flight batching (serve/inflight.py): slot-feeding over the
            # backend's persistent decode loop — joiners enter at segment
            # boundaries instead of waiting out strangers' batches
            from .inflight import InflightScheduler

            self.scheduler = InflightScheduler(
                backend, slots=slots,
                slot_prompt_tokens=slot_prompt_tokens,
                fused_segments=fused_segments, **common,
            )
        else:
            self.scheduler = MicroBatchScheduler(backend, **common)
        if self.stream_idle_timeout_s > 0:
            # arm the scheduler's idle-consumer sweep: abandoned streams
            # (disconnect, no resume) cancel after this window
            self.scheduler.stream_idle_timeout_s = self.stream_idle_timeout_s
        if self.watchdog is not None:
            # monitor thread starts LAST: every heartbeat is registered
            # (and freshly beaten) before the first detection pass
            self.watchdog.start()
        self.default_deadline_s = default_deadline_s
        self._strategies: dict[str, object] = {}
        import threading

        self._strategies_lock = threading.Lock()

    def strategy_for(self, approach: str, max_new_tokens: int | None = None):
        """ONE strategy instance per approach, shared across requests and
        threads (the re-entrancy contract in strategies/base.py). It is
        constructed against the RAW backend — splitters capture its
        count_tokens, which must stay a direct host-side call — and each
        request passes its own deadline-bound QueuedBackend via the
        summarize(..., backend=) override, so generation rides the queue
        while token counting does not. A per-request max_new_tokens
        override bypasses the cache (the budget is baked in at
        construction)."""
        if max_new_tokens is not None:
            cfg = PipelineConfig(
                approach=approach,
                **{**approach_defaults(approach),
                   "max_new_tokens": int(max_new_tokens)},
            )
            return get_strategy(approach, self.backend, cfg)
        with self._strategies_lock:
            strat = self._strategies.get(approach)
            if strat is None:
                cfg = PipelineConfig(
                    approach=approach, **approach_defaults(approach)
                )
                strat = get_strategy(approach, self.backend, cfg)
                self._strategies[approach] = strat
            return strat

    def readiness(self) -> tuple[bool, str]:
        """The ``/readyz`` verdict: (routable, reason). Distinct from
        ``/healthz`` liveness — a draining or browned-out server is alive (healthz answers) but must not receive fresh
        traffic, and the router's probe loop keys off exactly this split.
        Reasons are typed: ``draining`` (shutdown drain underway, never
        coming back), ``brownout`` (supervisor ladder bottomed out — route
        again once the rung recovers)."""
        if self.scheduler.closed:
            return False, "draining"
        if self.supervisor is not None:
            from .supervisor import Rung

            if self.supervisor.rung >= Rung.BROWNOUT:
                return False, "brownout"
        return True, "ready"

    def obs_snapshot(self) -> dict:
        """``GET /debug/obs/snapshot`` — the federation scrape payload:
        everything the fleet router folds into its rollups in ONE JSON
        round trip (no Prometheus text parsing on the hot scrape path).
        ``mono_now`` is this process's monotonic clock at snapshot time —
        the router pairs it with its own send/receive stamps to estimate
        the per-worker clock offset (RTT midpoint) that aligns worker
        spans into the merged fleet trace."""
        from ..obs.export import trace_state_payload

        ready, reason = self.readiness()
        payload: dict = {
            "mono_now": time.monotonic(),
            "ready": ready,
            "readyz_reason": reason,
            "queue_depth": self.scheduler.queue.depth,
            **self.metrics.federation_snapshot(),
        }
        if self.supervisor is not None:
            payload["degraded_rung"] = int(self.supervisor.rung)
        payload["usage"] = self.metrics.usage_snapshot(
            self.metrics.usage_window_s)
        payload["usage_window_s"] = self.metrics.usage_window_s
        if self.watchdog is not None:
            ages = self.watchdog.stats_dict().get("heartbeat_ages", {})
            payload["watchdog"] = {
                "max_heartbeat_age_s": max(ages.values(), default=0.0),
                "heartbeat_ages": ages,
            }
        if self.obs is not None:
            payload["traces"] = trace_state_payload(self.obs.snapshot()[0])
        return payload

    def incident_dump(self, incident: str) -> dict:
        """``POST /debug/dump?incident=<id>`` — this worker's contribution
        to a router-minted incident bundle: the flight-recorder ring, a
        stack snapshot, and the clock stamp that lets the report CLI order
        this process's events against the others'. The ring additionally
        dumps to the worker's own --flight-dir (throttled, tagged with the
        incident id) so the evidence survives even if the router dies
        mid-collection."""
        from .watchdog import snapshot_stacks

        payload: dict = {
            "incident": incident,
            "mono_now": time.monotonic(),
            "wall_now": time.time(),
            "stacks": snapshot_stacks(),
            "flightrecorder": self.recorder.snapshot(),
        }
        dump_path = self.recorder.dump(f"incident_{incident}")
        if dump_path is not None:
            payload["dump_path"] = str(dump_path)
        if self.watchdog is not None:
            payload["watchdog"] = self.watchdog.health_dict()
        return payload

    def cancel_request(self, rid: str) -> dict | None:
        """``DELETE /v1/requests/<id>`` — gang-cancel ``rid`` and its
        ``rid#N`` fan-out children everywhere in the lifecycle. Returns the
        response payload, or None for a wholly unknown id (typed 404
        upstream). Idempotent: re-DELETEs answer with zero counts."""
        res = self.scheduler.cancel(rid)
        if not res["known"]:
            return None
        return {
            "request_id": rid,
            "cancelled_queued": res["cancelled_queued"],
            "cancel_pending": res["cancel_pending"],
            "status": "cancelling" if res["cancel_pending"] else "cancelled",
        }

    def _watchdog_escalate(self, stall) -> None:
        """Lock/helper-stall escalation (serve/watchdog.py): the big
        hammer. A thread wedged in a LOCK wait cannot be replaced — the
        successor would deadlock on the same lock — so the supervised
        answer is dump-and-exit: dump the flight ring and exit with
        WATCHDOG_EXIT_CODE so the process manager restarts us. Runs on the
        watchdog thread."""
        from .watchdog import WATCHDOG_EXIT_CODE

        self._watchdog_escalations += 1
        logger.critical(
            "watchdog escalation: %s stall on %r (%.2fs past %.2fs) — "
            "exiting %d for a supervised restart",
            stall.kind, stall.name, stall.stalled_for_s, stall.limit_s,
            WATCHDOG_EXIT_CODE,
        )
        self.recorder.dump("watchdog_escalate")
        if not self._watchdog_exit:
            return  # embedded/test mode: the verdict is recorded, we live
        os._exit(WATCHDOG_EXIT_CODE)

    def close(self, drain_timeout_s: float = 30.0) -> None:
        if self.watchdog is not None:
            # the monitor stops FIRST: a slow final dispatch must never be
            # declared a stall mid-exit
            self.watchdog.close()
        self.scheduler.close(drain=True, timeout=drain_timeout_s)
        # SIGTERM-drain dump: the recorder's last act — the full drain
        # (including any overrun sheds) is in the ring it writes out
        self.recorder.dump("drain")


class _BadRequest(ValueError):
    """Client-side input error → HTTP 400, never the 500/engine-error path."""


def _number(req: dict, key: str, cast, *, integer: bool = False):
    val = req.get(key)
    if val is None:
        return None
    if isinstance(val, bool) or not isinstance(val, (int, float)):
        raise _BadRequest(f"{key!r} must be a number")
    if integer and not float(val).is_integer():
        raise _BadRequest(f"{key!r} must be an integer")
    return cast(val)


def _deadline_from(req: dict, default_s: float | None) -> float | None:
    ms = _number(req, "deadline_ms", float)
    if ms is not None:
        return time.monotonic() + ms / 1000.0
    if default_s is not None:
        return time.monotonic() + default_s
    return None


def _request_id(req: dict, headers) -> str:
    """The request's end-to-end correlation id: client-supplied (JSON
    "request_id", else an X-Request-Id header) or generated. The same id is
    echoed in the response header/body, names the trace track in
    /debug/trace, and lands in every ServeRequestRecord.trace_id the request
    produces."""
    rid = req.get("request_id")
    if rid is None:
        rid = headers.get("X-Request-Id")
    if rid is None:
        return uuid.uuid4().hex[:16]
    if not isinstance(rid, str) or not rid.strip() or len(rid) > 128:
        raise _BadRequest(
            "'request_id' must be a non-empty string of at most 128 chars"
        )
    return rid.strip()


def _gen_config_from(
    req: dict, default_spec_k: int = 0
) -> GenerationConfig | None:
    knobs = {}
    for key, cast, integer in (
        ("temperature", float, False),
        ("top_k", int, True),
        ("top_p", float, False),
        ("seed", int, True),
        # per-request speculative-decoding override; the server-level
        # default comes from --spec-k
        ("spec_k", int, True),
    ):
        val = _number(req, key, cast, integer=integer)
        if val is not None:
            knobs[key] = val
    if not knobs:
        return None  # backend's own GenerationConfig default applies
    # a request that customizes only sampling knobs must not silently turn
    # the server's --spec-k default off: a fresh GenerationConfig would
    # carry spec_k=0 and fully REPLACE the backend default
    knobs.setdefault("spec_k", default_spec_k)
    return GenerationConfig(**knobs)


def make_handler(state: ServeState):
    class Handler(BaseHTTPRequestHandler):
        # keep-alive: every response carries Content-Length, so persistent
        # connections work — load generators and real clients reuse sockets
        # instead of paying a TCP handshake per request
        protocol_version = "HTTP/1.1"

        # set per-request by the POST handlers once the id is known; _json
        # then echoes it as X-Request-Id and a request_id body field on every
        # outcome (200, 429 shed, 500) so clients can always correlate
        _rid: str | None = None

        def _json(self, payload: dict, status: int = 200,
                  headers: dict | None = None) -> None:
            if self._rid is not None:
                payload = {"request_id": self._rid, **payload}
            body = json.dumps(payload, ensure_ascii=False).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            if self._rid is not None:
                self.send_header("X-Request-Id", self._rid)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _shed_response(self, e: RequestShed) -> None:
            """The typed shed contract: admission/deadline sheds are 429, a
            supervisor BROWNOUT is 503 — and EVERY shed carries a
            Retry-After header, derived where the shed was decided (queue
            depth for queue_full/token_budget, 1s for an expired client
            deadline) — the machine-readable back-off signal."""
            payload: dict = {"error": "shed", "reason": e.reason.value}
            status = 503 if e.reason is ShedReason.BROWNOUT else 429
            retry_after = e.retry_after_s or 1.0
            payload["retry_after_s"] = retry_after
            # Retry-After is delta-seconds, integral, at least 1
            headers = {"Retry-After": str(max(1, int(round(retry_after))))}
            self._json(payload, status, headers)

        def _text(self, body: str, status: int = 200,
                  content_type: str = "text/plain; version=0.0.4; "
                                      "charset=utf-8") -> None:
            raw = body.encode()
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

        def do_GET(self) -> None:  # noqa: N802 (stdlib API)
            self._rid = None  # keep-alive: one handler serves many requests
            path, _, query = self.path.partition("?")
            if path == "/debug/trace":
                if state.obs is None:
                    self._json(
                        {"error": "tracing disabled (--trace-sample 0)"}, 404
                    )
                    return
                trace = state.obs.chrome_trace()
                import urllib.parse

                save = urllib.parse.parse_qs(query).get("save", ["0"])[0]
                if state.trace_dir and save == "1":
                    p = save_timestamped_trace(trace, state.trace_dir, "serve")
                    logger.info("wrote trace dump %s", p)
                body = json.dumps(trace).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/debug/obs/snapshot":
                # the federation scrape surface: counters + raw histogram
                # state + usage/readyz/watchdog views + raw request spans,
                # one JSON document (read by the fleet router, A15b)
                self._json(state.obs_snapshot())
            elif path == "/debug/slo":
                self._json({"error": "no SLOs configured (--slo unset)"}, 404)
            elif path == "/debug/flightrecorder":
                self._json(state.recorder.snapshot())
            elif path == "/debug/stacks":
                # every thread's Python stack on demand — the manual twin
                # of the watchdog's automatic stall dump (SIGUSR1 writes
                # the same snapshot to disk). Always available: hangs are
                # exactly when an operator needs this, watchdog or not
                from .watchdog import snapshot_stacks

                payload = {"threads": snapshot_stacks()}
                if state.watchdog is not None:
                    payload["watchdog"] = state.watchdog.health_dict()
                self._json(payload)
            elif path == "/v1/usage":
                self._usage(query)
            elif path.startswith("/v1/requests/"):
                self._request_status(path[len("/v1/requests/"):])
            elif path == "/readyz":
                # routability, not liveness: typed 503 while draining or
                # browned-out so a router/LB can tell
                # "alive but do not route" from dead (which never answers)
                ready, reason = state.readiness()
                if ready:
                    self._json({"status": "ready"})
                else:
                    self._json(
                        {"error": "not_ready", "reason": reason,
                         "retry_after_s": 1.0},
                        503, {"Retry-After": "1"},
                    )
            elif path == "/healthz":
                sup = state.supervisor
                from .. import __version__

                payload = {
                    "status": "ok",
                    "backend": state.backend.name,
                    "version": __version__,
                    "started_at": time.strftime(
                        "%Y-%m-%dT%H:%M:%SZ",
                        time.gmtime(state.started_wall),
                    ),
                    "uptime_s": round(
                        time.monotonic() - state.started_monotonic, 3
                    ),
                    # this process's monotonic clock at render time: the
                    # fleet router reads it against its own probe send/
                    # receive stamps (RTT midpoint) to estimate the clock
                    # offset the merged /debug/trace corrects by
                    "mono_now": time.monotonic(),
                    "queue_depth": state.scheduler.queue.depth,
                    "queued_tokens": state.scheduler.queue.queued_tokens,
                    "closed": state.scheduler.closed,
                }
                if state.watchdog is not None:
                    # liveness verdict: last-beat age per registered thread
                    # plus the stall/recovery counters — a probe reading
                    # /healthz sees a wedged loop as a growing age, then a
                    # counted stall, without waiting for client timeouts
                    payload["watchdog"] = state.watchdog.health_dict()
                if sup is not None:
                    # the degradation ladder is health surface: "ok" only
                    # at HEALTHY, "degraded" on any lower rung so probes
                    # and load balancers see the brownout coming
                    rung = sup.rung
                    payload["degraded_rung"] = int(rung)
                    payload["degraded"] = rung.name.lower()
                    if rung > 0:
                        payload["status"] = "degraded"
                self._json(payload)
            elif path == "/metrics":
                cache_stats = getattr(
                    state.backend, "prefix_cache_stats", lambda: None
                )()
                slot_state = getattr(
                    state.scheduler, "slot_state", lambda: None
                )()
                # exemplars only for scrapers that NEGOTIATE OpenMetrics:
                # the classic text-format parser (the default Prometheus
                # Accept) rejects the trailing `# {...}` after a sample
                # and would drop the entire scrape
                openmetrics = (
                    "application/openmetrics-text"
                    in (self.headers.get("Accept") or "")
                )
                body = state.scheduler.metrics.render_prometheus(
                        queue_depth=state.scheduler.queue.depth,
                        queued_tokens=state.scheduler.queue.queued_tokens,
                        cache_stats=cache_stats,
                        slot_state=slot_state,
                        degraded_rung=(
                            int(state.supervisor.rung)
                            if state.supervisor is not None else None
                        ),
                        gang_state=state.scheduler.gangs.stats(),
                        recorder_stats=state.recorder.stats_dict(),
                        watchdog_stats=(
                            state.watchdog.stats_dict()
                            if state.watchdog is not None else None
                        ),
                        exemplars=openmetrics,
                    )
                if openmetrics:
                    # the OpenMetrics exposition requires the EOF marker
                    self._text(
                        body + "# EOF\n",
                        content_type="application/openmetrics-text; "
                                     "version=1.0.0; charset=utf-8",
                    )
                else:
                    self._text(body)
            else:
                self._json({"error": "not found"}, 404)

        def _usage(self, query: str) -> None:
            """``GET /v1/usage[?tenant=]`` — the per-tenant usage ledger:
            monotonic token/outcome counters plus windowed latency
            quantiles per tenant (serve/usage.py). 404s for a tenant the
            ledger has never seen."""
            import urllib.parse

            from .usage import TenantLabelRegistry

            usage = state.metrics.usage_snapshot(
                state.metrics.usage_window_s
            )
            q = urllib.parse.parse_qs(query)
            tenant = q.get("tenant", [None])[0]
            payload = {
                "window_s": state.metrics.usage_window_s,
                "tenants": usage,
            }
            if tenant is not None:
                # ledger rows are keyed by SANITIZED names ('team a' was
                # accounted as 'team_a') — map the query the same way, but
                # never through canonical(): a read must not grow the
                # registry or charge its overflow counter
                tenant = TenantLabelRegistry.sanitize(tenant)
                if tenant not in usage:
                    self._json(
                        {"error": f"no usage recorded for tenant "
                                  f"{tenant!r}"}, 404,
                    )
                    return
                payload["tenants"] = {tenant: usage[tenant]}
            self._json(payload)

        def _request_status(self, raw_rid: str) -> None:
            """``GET /v1/requests/<id>`` — the reconnect-and-poll surface
            of durable serving, a typed 404 until the journal is ported
            (ROADMAP A15b)."""
            self._json(
                {"error": "journaling disabled (--journal-dir unset)"}, 404
            )

        # request bodies beyond this are refused outright: a huge (or
        # negative, which would read to EOF and wedge the handler thread)
        # Content-Length must not buffer unbounded bytes per connection
        MAX_BODY_BYTES = 16 * 1024 * 1024

        def _read_json(self) -> dict | None:
            try:
                length = int(self.headers.get("Content-Length", "0"))
            # lint-allow[swallowed-exception]: a garbled header becomes length=-1, which the branch below answers with a typed 400
            except ValueError:
                length = -1
            if length < 0 or length > self.MAX_BODY_BYTES:
                # refusing WITHOUT reading the body leaves its bytes in the
                # stream — the next keep-alive request would parse as
                # garbage, so drop the connection after responding
                self.close_connection = True
                if length < 0:
                    self._json({"error": "bad Content-Length"}, 400)
                else:
                    self._json({"error": "request body too large"}, 413)
                return None
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._json({"error": "invalid JSON"}, 400)
                return None
            except UnicodeDecodeError:
                # json.loads raises this (not JSONDecodeError) for bodies
                # that aren't valid UTF-8 — without the catch it would
                # surface as a 500 engine-error path for a client bug
                self._json({"error": "request body is not valid UTF-8"}, 400)
                return None
            if not isinstance(req, dict):
                self._json({"error": "malformed request"}, 400)
                return None
            return req

        def _reject_unknown_fields(self, req: dict, allowed: frozenset) -> bool:
            """Typed 400 for unknown top-level fields: a typo'd knob
            (``temperatre``) silently ignored is a misconfigured request
            served with wrong parameters — refuse loudly instead. Returns
            True when the request was rejected."""
            unknown = [k for k in req if k not in allowed]
            if unknown:
                self._json({
                    "error": f"unknown field(s): {', '.join(sorted(unknown))}",
                    "allowed": sorted(allowed),
                }, 400)
                return True
            return False

        GENERATE_FIELDS = frozenset({
            "prompt", "prompts", "max_new_tokens", "temperature", "top_k",
            "top_p", "seed", "spec_k", "deadline_ms", "request_id",
            "reference", "references", "cache_hint", "cache_hints",
            "stream",
        })
        SUMMARIZE_FIELDS = frozenset({
            "text", "approach", "max_new_tokens", "deadline_ms", "request_id",
            "stream",
        })

        def _stream_requested(self, req: dict) -> bool:
            return bool(req.get("stream"))

        # -- SSE plumbing (serve/stream.py) ---------------------------------

        def _sse_begin(self) -> None:
            """Open the event stream: no Content-Length (the response ends
            when the request does), so the connection closes after — the
            one response shape keep-alive can't carry."""
            self.close_connection = True
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream; charset=utf-8")
            self.send_header("Cache-Control", "no-store")
            if self._rid is not None:
                self.send_header("X-Request-Id", self._rid)
            self.send_header("Connection", "close")
            self.end_headers()

        def _sse_event(self, name: str, payload: dict,
                       seq: int | None = None) -> None:
            data = json.dumps(payload, ensure_ascii=False)
            frame = f"event: {name}\ndata: {data}\n\n"
            if seq is not None:
                # SSE event id: the channel's monotone seq — what a
                # reconnecting client sends back as Last-Event-ID
                frame = f"id: {seq}\n" + frame
            self.wfile.write(frame.encode())
            self.wfile.flush()
            state.scheduler.metrics.observe_stream_events()

        def _stream_response(self, channel, done, finish,
                             gen: int | None = None) -> str:
            """Open the SSE response and drain ``channel`` until ``done()``
            turns true and the channel is empty, then write the terminal
            event from ``finish()`` -> (event_name, payload). The terminal
            payload of a successful request is THE SAME payload the
            non-streaming path returns. Returns the drain outcome
            ("finished" / "disconnected" / "detached" — see
            _drain_stream); the CALLER decides what cancellation a
            disconnect implies; the engine side always owns its own
            lifecycle."""
            try:
                self._sse_begin()
            # lint-allow[swallowed-exception]: returning the outcome IS the answer — a client gone before the headers flushed takes the same disconnect policy as one gone mid-stream
            except OSError:
                logger.info("streaming client disconnected before headers "
                            "(%s)", self._rid)
                return "disconnected"
            return self._drain_stream(channel, done, finish, gen)

        def _drain_stream(self, channel, done, finish,
                          gen: int | None = None) -> str:
            """The one SSE drain loop (first connection and Last-Event-ID
            resume both end here; headers are already on the wire).
            Returns "finished" (terminal event reached the socket),
            "disconnected" (client gone — the caller runs the disconnect
            policy), or "detached" (a Last-Event-ID reconnect superseded
            this consumer — the NEW handler owns the stream, so the caller
            must neither cancel nor unregister). Quiet stretches emit
            ``: heartbeat`` comment frames every ``--stream-heartbeat-s``:
            idle proxies keep the connection, and the write doubles as the
            disconnect probe for requests that are between segments (a
            dead socket fails the write -> OSError -> the caller's
            disconnect policy)."""
            from .stream import StreamDetached

            metrics = state.scheduler.metrics
            metrics.observe_stream_open(+1)
            hb = state.stream_heartbeat_s
            try:
                last_write = time.monotonic()
                while True:
                    try:
                        ev = channel.pop(0.05, gen)
                    # lint-allow[swallowed-exception]: detachment IS the resolution — a reconnecting consumer owns the stream now; this stale handler must exit without writing a terminal frame
                    except StreamDetached:
                        return "detached"
                    if ev is not None:
                        self._sse_event(ev[0], ev[1], ev[2])
                        last_write = time.monotonic()
                        continue
                    if done() and channel.empty():
                        break
                    if hb and time.monotonic() - last_write >= hb:
                        self.wfile.write(b": heartbeat\n\n")
                        self.wfile.flush()
                        metrics.observe_stream_heartbeat()
                        last_write = time.monotonic()
                self._sse_event(*finish())
                return "finished"
            # lint-allow[swallowed-exception]: returning the outcome IS the answer — the caller runs the disconnect policy (cancel now or leave the bounded resume window open); the engine side resolves regardless
            except OSError:
                logger.info("streaming client disconnected (%s)", self._rid)
                return "disconnected"
            finally:
                metrics.observe_stream_open(-1)

        @staticmethod
        def _stream_error_event(e: Exception) -> tuple[str, dict]:
            """The ONE exception -> terminal SSE error event mapping, shared
            by the generate and summarize stream paths (mirrors the typed
            non-streaming contract: shed reason + Retry-After hint,
            supervised failure class, raw error)."""
            if isinstance(e, RequestShed):
                return "error", {
                    "error": "shed", "reason": e.reason.value,
                    "retry_after_s": e.retry_after_s or 1.0,
                }
            if isinstance(e, RequestCancelled):
                # the typed terminal for a withdrawn request — what a
                # Last-Event-ID reconnect after the resume window reads
                return "error", {"error": "cancelled", "stage": e.stage,
                                 "reason": e.reason}
            if isinstance(e, RequestFailed):
                return "error", {"error": "request_failed",
                                 "class": e.failure_class.value,
                                 "detail": str(e)}
            return "error", {"error": str(e)}

        def _stream_finish_generate(self, fut):
            """Terminal SSE event for a streamed /v1/generate: the exact
            non-streaming payload on success, a typed error event
            otherwise."""
            try:
                # lint-allow[unbounded-blocking-wait]: externally bounded — the drain loop only calls finish() after fut.done() turned true, so this result() never blocks
                c = fut.result()
            except Exception as e:
                return self._stream_error_event(e)
            return "done", {
                "request_id": self._rid,
                "completions": [{"text": c.text,
                                 "record": c.record.to_dict()}],
            }

        def do_POST(self) -> None:  # noqa: N802 (stdlib API)
            self._rid = None  # keep-alive: one handler serves many requests
            path, _, query = self.path.partition("?")
            if path == "/v1/generate":
                self._generate()
            elif path == "/v1/summarize":
                self._summarize()
            elif path == "/debug/dump":
                # correlated incident capture: the router fans this out to
                # every worker with a minted incident id; the response IS
                # this worker's bundle contribution (ring + stacks + clock)
                import urllib.parse

                raw = urllib.parse.parse_qs(query).get(
                    "incident", ["manual"]
                )[0]
                incident = re.sub(r"[^A-Za-z0-9_.-]", "_", raw)[:64] or \
                    "manual"
                # drain the (typically empty) body so keep-alive survives
                length = int(self.headers.get("Content-Length") or 0)
                if length > 0:
                    self.rfile.read(min(length, self.MAX_BODY_BYTES))
                self._json(state.incident_dump(incident))
            else:
                self._json({"error": "not found"}, 404)

        def do_DELETE(self) -> None:  # noqa: N802 (stdlib API)
            """``DELETE /v1/requests/<id>`` — first-class cancellation:
            idempotent, gang-cancels ``<id>#N`` fan-out children, answers
            with the request's aggregated status plus how many queued
            requests resolved immediately and how many engine-side ones
            will be reclaimed at the next segment boundary. Unknown ids are
            a typed 404."""
            self._rid = None
            path = self.path.partition("?")[0]
            if not path.startswith("/v1/requests/"):
                self._json({"error": "not found"}, 404)
                return
            import urllib.parse

            rid = urllib.parse.unquote(path[len("/v1/requests/"):])
            self._rid = rid
            payload = state.cancel_request(rid)
            if payload is None:
                self._json(
                    {"error": f"unknown request id {rid!r}"}, 404
                )
                return
            self._json(payload)

        def _generate(self) -> None:
            req = self._read_json()
            if req is None:
                return
            if self._reject_unknown_fields(req, self.GENERATE_FIELDS):
                return
            prompts = req.get("prompts")
            if prompts is None:
                prompt = req.get("prompt")
                prompts = [prompt] if isinstance(prompt, str) else None
            if not prompts or not all(isinstance(p, str) and p for p in prompts):
                self._json({"error": "need 'prompt' or non-empty 'prompts'"}, 400)
                return
            # speculation references: "reference" (single) or "references"
            # (aligned with prompts; null entries allowed)
            references = req.get("references")
            if references is None:
                ref = req.get("reference")
                references = [ref] * len(prompts) if isinstance(ref, str) else None
            if references is not None and (
                not isinstance(references, list)
                or len(references) != len(prompts)
                or not all(r is None or isinstance(r, str) for r in references)
            ):
                self._json(
                    {"error": "'references' must align with prompts"}, 400
                )
                return
            # prefix-cache hints: "cache_hint" (single, applied to every
            # prompt) or "cache_hints" (aligned; null entries allowed)
            cache_hints = req.get("cache_hints")
            if cache_hints is None:
                hint = req.get("cache_hint")
                cache_hints = (
                    [hint] * len(prompts) if isinstance(hint, str) else None
                )
            if cache_hints is not None and (
                not isinstance(cache_hints, list)
                or len(cache_hints) != len(prompts)
                or not all(h is None or isinstance(h, str) for h in cache_hints)
            ):
                self._json(
                    {"error": "'cache_hints' must align with prompts"}, 400
                )
                return
            try:
                self._rid = _request_id(req, self.headers)
                max_new_tokens = _number(req, "max_new_tokens", int, integer=True)
                config = _gen_config_from(req, state.default_spec_k)
                deadline = _deadline_from(req, state.default_deadline_s)
            except _BadRequest as e:
                self._json({"error": str(e)}, 400)
                return
            if self._stream_requested(req):
                if len(prompts) != 1:
                    self._json(
                        {"error": "'stream' needs exactly one prompt"}, 400
                    )
                    return
                self._generate_stream(
                    prompts[0], max_new_tokens, config, deadline,
                    references[0] if references else None,
                    cache_hints[0] if cache_hints else None,
                )
                return
            # one RequestTrace for the whole HTTP request: multi-prompt
            # calls put each prompt's spans on its own sub-track
            trace = (
                state.obs.start_request(
                    self._rid, parent=self.headers.get("X-Parent-Span"))
                if state.obs is not None else None
            )
            try:
                completions = state.scheduler.generate_sync(
                    prompts,
                    max_new_tokens=max_new_tokens,
                    config=config,
                    deadline=deadline,
                    references=references,
                    cache_hints=cache_hints,
                    trace=trace,
                    trace_id=self._rid,
                    # this handler made the sampling decision (trace may be
                    # None = sampled out) — the scheduler must not re-draw
                    trace_owned=True,
                )
            except RequestShed as e:
                if state.obs is not None:
                    state.obs.finish_request(trace, f"shed:{e.reason.value}")
                self._shed_response(e)
                return
            except RequestCancelled as e:
                # someone DELETEd this id (or its stream was abandoned)
                # while this waiter blocked: typed 409, never a 500
                if state.obs is not None:
                    state.obs.finish_request(trace, f"cancelled:{e.reason}")
                self._json({"error": "cancelled", "stage": e.stage,
                            "reason": e.reason}, 409)
                return
            except RequestFailed as e:
                # supervision gave up: typed terminal failure (poison
                # quarantine, exhausted retries, fatal engine error)
                if state.obs is not None:
                    state.obs.finish_request(trace, "error")
                logger.exception("generate failed after supervision")
                self._json({"error": "request_failed",
                            "class": e.failure_class.value,
                            "detail": str(e)}, 500)
                return
            except Exception as e:  # engine failure: surface, don't crash
                if state.obs is not None:
                    state.obs.finish_request(trace, "error")
                logger.exception("generate failed")
                self._json({"error": str(e)}, 500)
                return
            if state.obs is not None:
                state.obs.finish_request(trace, "ok")
            self._json(
                {
                    "completions": [
                        {"text": c.text, "record": c.record.to_dict()}
                        for c in completions
                    ]
                }
            )

        def _generate_stream(self, prompt, max_new_tokens, config, deadline,
                             reference, cache_hint) -> None:
            """Streamed /v1/generate: the request rides the scheduler like
            any other, plus a StreamChannel the in-flight harvest pushes
            decode-progress deltas into at every segment boundary (the
            one-shot path emits one final delta). Concatenated deltas are
            byte-identical to the done event's text — the stream.py delta
            discipline. Admission sheds happen BEFORE the stream opens and
            answer as plain typed 429s.

            Disconnect policy: the stream is registered for Last-Event-ID
            resume, so a dropped connection leaves the request running for
            the BOUNDED idle window (--stream-idle-timeout-s) — reattach in
            time and the stream continues from a snapshot; don't, and the
            scheduler's sweep cancels it (automatic cancel-on-disconnect).
            A zero window cancels right here, before this handler returns."""
            from .stream import StreamChannel

            if self.headers.get("Last-Event-ID") is not None:
                # reconnect: attach to the live stream instead of
                # submitting a duplicate request
                self._resume_stream()
                return
            trace = (
                state.obs.start_request(
                    self._rid, parent=self.headers.get("X-Parent-Span"))
                if state.obs is not None else None
            )
            channel = StreamChannel(
                self._rid, metrics=state.scheduler.metrics
            )
            try:
                fut = state.scheduler.submit(
                    prompt,
                    max_new_tokens=max_new_tokens,
                    config=config,
                    deadline=deadline,
                    reference=reference,
                    cache_hint=cache_hint,
                    trace=trace,
                    trace_id=self._rid,
                    # this handler made the sampling decision (trace may be
                    # None = sampled out) — the scheduler must not re-draw
                    trace_owned=True,
                    stream=channel,
                )
            except RequestShed as e:
                if state.obs is not None:
                    state.obs.finish_request(trace, f"shed:{e.reason.value}")
                self._shed_response(e)
                return
            if state.obs is not None and trace is not None:
                # finalize the trace when the REQUEST resolves, not when
                # this handler exits: a disconnected stream keeps decoding
                # through the resume window, and its spans must still land
                # in /debug/trace whether it completes, errors, or is
                # cancelled by the sweep (the callback fires exactly once,
                # on whichever thread resolves the future)
                def _finalize_trace(f, _trace=trace):
                    e = f.exception()
                    if isinstance(e, RequestCancelled):
                        status = f"cancelled:{e.reason}"
                    else:
                        status = "ok" if e is None else "error"
                    state.obs.finish_request(_trace, status)

                fut.add_done_callback(_finalize_trace)
            state.streams.register(self._rid, channel, fut)
            gen = channel.attach()
            outcome = self._stream_response(
                channel, fut.done,
                lambda: self._stream_finish_generate(fut), gen=gen,
            )
            if outcome == "finished":
                state.streams.unregister(self._rid)
            elif outcome == "disconnected" and state.stream_idle_timeout_s == 0:
                # no resume window configured: a disconnect IS the cancel
                state.scheduler.cancel(self._rid, reason="disconnect")
                state.streams.unregister(self._rid)
            # else: disconnected within the idle window (stay registered —
            # the request keeps decoding; a reconnect resumes it, the sweep
            # cancels it) or detached (the resumed handler owns the stream
            # now — cancelling here would kill the live reconnect)

        def _resume_stream(self) -> None:
            """``Last-Event-ID`` reconnect: reattach to the registered
            channel (superseding any stale handler), replay ONE full-text
            ``snapshot`` event off the producer's high-water mark —
            buffered deltas are folded in, so snapshot + subsequent deltas
            still reassemble the exact final text — then continue live.
            Unknown/expired ids answer a typed 404; a request that already
            finished (or was cancelled past the idle window) replays its
            snapshot and goes straight to the terminal event."""
            entry = state.streams.get(self._rid)
            if entry is None:
                self._json(
                    {"error": "no resumable stream for request id "
                              f"{self._rid!r}"}, 404,
                )
                return
            channel, fut = entry
            gen = channel.attach()
            state.scheduler.metrics.observe_stream_resume()
            text, seq = channel.resume_snapshot()
            try:
                self._sse_begin()
                self._sse_event("snapshot", {"text": text}, seq)
            # lint-allow[swallowed-exception]: the resuming client vanished before its snapshot landed — the stream stays registered and the idle window keeps running; nothing to resolve here
            except OSError:
                logger.info("resume client disconnected (%s)", self._rid)
                return
            outcome = self._drain_stream(
                channel, fut.done,
                lambda: self._stream_finish_generate(fut), gen,
            )
            if outcome == "finished":
                state.streams.unregister(self._rid)

        def _summarize(self) -> None:
            req = self._read_json()
            if req is None:
                return
            if self._reject_unknown_fields(req, self.SUMMARIZE_FIELDS):
                return
            text = req.get("text", "")
            if not isinstance(text, str) or not text.strip():
                self._json({"error": "empty document"}, 400)
                return
            approach = req.get("approach", "mapreduce")
            if approach not in APPROACHES:
                self._json(
                    {"error": f"unknown approach {approach!r}",
                     "approaches": list(APPROACHES)}, 400,
                )
                return
            try:
                self._rid = _request_id(req, self.headers)
                max_new_tokens = _number(req, "max_new_tokens", int, integer=True)
                deadline = _deadline_from(req, state.default_deadline_s)
            except _BadRequest as e:
                self._json({"error": str(e)}, 400)
                return
            # the trace survives every strategy round: all the request's
            # fanned-out prompts record onto it through the QueuedBackend
            trace = (
                state.obs.start_request(
                    self._rid, parent=self.headers.get("X-Parent-Span"))
                if state.obs is not None else None
            )
            qbackend = state.scheduler.backend_view(
                deadline=deadline, trace=trace, trace_id=self._rid,
                gang=self._rid,
            )
            t0 = time.monotonic()

            def payload_from(result) -> dict:
                recs = qbackend.records
                payload = {
                    "approach": approach,
                    "summary": clean_thinking_tokens(result.summary),
                    "num_chunks": result.num_chunks,
                    "llm_calls": result.llm_calls,
                    "serving": {
                        "llm_requests": len(recs),
                        "queue_wait_s": round(sum(r.queue_wait_s for r in recs), 6),
                        "engine_s": round(sum(r.engine_s for r in recs), 6),
                        "generated_tokens": sum(r.generated_tokens for r in recs),
                        "draft_tokens": sum(r.draft_tokens for r in recs),
                        "accepted_tokens": sum(r.accepted_tokens for r in recs),
                        "total_s": round(time.monotonic() - t0, 6),
                    },
                }
                # degraded fan-out (a POISON member was dropped from the
                # reduce): say so on the reply
                ginfo = state.scheduler.gangs.lookup(self._rid)
                if ginfo and ginfo.get("partial"):
                    payload["partial"] = True
                return payload

            try:
                # request-level admission: the strategy's rounds fan out as
                # INTERNAL submits that bypass the depth budget (a wide map
                # round must not shed itself on an idle server), so the
                # queue/token gate applies here, once, per request. The
                # full-document tokenization is only worth paying when a
                # token budget is actually configured
                est_tokens = (
                    state.backend.count_tokens(text)
                    if state.scheduler.queue.max_queued_tokens
                    else 0
                )
                # gang admission: ONE pass through the gate admits the
                # whole fan-out (billed once) and opens the structured-job
                # group every internal submit below joins
                gang = state.scheduler.admit_gang(self._rid, est_tokens)
            except RequestShed as e:
                if state.obs is not None:
                    state.obs.finish_request(trace, f"shed:{e.reason.value}")
                self._shed_response(e)
                return
            if self._stream_requested(req):
                try:
                    self._summarize_stream(
                        text, approach, max_new_tokens, qbackend, trace,
                        payload_from,
                    )
                finally:
                    gang.finish()
                return
            try:
                strategy = state.strategy_for(approach, max_new_tokens)
                result = strategy.summarize(text, backend=qbackend)
            except RequestShed as e:
                if state.obs is not None:
                    state.obs.finish_request(trace, f"shed:{e.reason.value}")
                self._shed_response(e)
                return
            except RequestCancelled as e:
                if state.obs is not None:
                    state.obs.finish_request(trace, f"cancelled:{e.reason}")
                self._json({"error": "cancelled", "stage": e.stage,
                            "reason": e.reason}, 409)
                return
            except RequestFailed as e:
                if state.obs is not None:
                    state.obs.finish_request(trace, "error")
                logger.exception("summarize failed after supervision")
                self._json({"error": "request_failed",
                            "class": e.failure_class.value,
                            "detail": str(e)}, 500)
                return
            except Exception as e:
                if state.obs is not None:
                    state.obs.finish_request(trace, "error")
                logger.exception("summarize failed")
                self._json({"error": str(e)}, 500)
                return
            else:
                # build the reply while the live group still exists — the
                # partial flag lives on it
                reply = payload_from(result)
            finally:
                # the structured job terminally resolved either way: drop
                # the live group
                gang.finish()
            if state.obs is not None:
                state.obs.finish_request(trace, "ok")
            self._json(reply)

        def _summarize_stream(self, text, approach, max_new_tokens,
                              qbackend, trace, payload_from) -> None:
            """Streamed /v1/summarize: the strategy runs on a worker thread
            while this handler streams SSE. Deltas here are PROGRESS events
            (one per completed strategy round — a summarize's token stream
            would interleave its map fan-out); the done event carries the
            exact non-streaming reply payload."""
            import threading

            from .stream import StreamChannel

            channel = StreamChannel(self._rid, metrics=state.scheduler.metrics)
            metrics = state.scheduler.metrics
            metrics.observe_stream_request()

            def progress(done_prompts: int) -> None:
                channel.push_event("progress", {
                    "llm_requests_done": done_prompts,
                })

            qbackend.progress = progress
            box: dict = {}

            def run() -> None:
                try:
                    strategy = state.strategy_for(approach, max_new_tokens)
                    box["result"] = strategy.summarize(text, backend=qbackend)
                # lint-allow[swallowed-exception]: the error is delivered, not swallowed — finish() reads the box and renders it as the stream's typed terminal error event
                except Exception as e:
                    box["error"] = e

            worker = threading.Thread(
                target=run, name="vnsum-serve-stream-summarize", daemon=True
            )
            worker.start()

            def finish():
                worker.join()
                e = box.get("error")
                if e is None:
                    return "done", {"request_id": self._rid,
                                    **payload_from(box["result"])}
                logger.error("streamed summarize failed: %s", e)
                return self._stream_error_event(e)

            outcome = self._stream_response(
                channel, lambda: not worker.is_alive(), finish
            )
            if outcome != "finished":
                # (no gen is passed for summarize streams, so the only
                # non-finished outcome here is a real disconnect)
                # client gone mid-summarize: reclaim instead of logging and
                # decoding to completion — gang-cancel the fan-out (every
                # child shares this trace_id, so queued siblings resolve
                # now and engine residents at the next boundary), stop the
                # progress pushes, and drop the channel's buffer. The
                # worker unblocks with RequestCancelled out of its next
                # round and the strategy run ends
                state.scheduler.cancel(self._rid, reason="disconnect")
                qbackend.progress = None
                channel.close()
            # a client disconnect skips finish() (nobody to write to), but
            # the strategy run still owns the trace: wait it out before
            # finalizing, so spans never land on a finished trace and the
            # recorded status reflects the run's real outcome
            worker.join()
            if state.obs is not None:
                status = "ok"
                e = box.get("error")
                if isinstance(e, RequestCancelled):
                    status = "cancelled:disconnect"
                elif e is not None:
                    status = "error"
                state.obs.finish_request(trace, status)

        def log_message(self, fmt, *args):  # route through our logger
            logger.info("%s %s", self.address_string(), fmt % args)

    return Handler


class _Server(ThreadingHTTPServer):
    # socketserver's default listen backlog of 5 collapses under a connect
    # burst (SYN retransmit backoff shows up as multi-second tail latency
    # on clients that were never even admitted); a serving front-end wants
    # the kernel queueing connects, not clients retransmitting
    request_queue_size = 128
    daemon_threads = True


def make_server(
    state: ServeState, host: str = "127.0.0.1", port: int = 8901
) -> ThreadingHTTPServer:
    return _Server((host, port), make_handler(state))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="vnsum-serve")
    p.add_argument("--backend", choices=["torch", "ollama", "hf", "fake"],
                   default="torch",
                   help="torch: the port's engine (TorchBackend); hf is not "
                        "ported yet (ROADMAP A5c)")
    p.add_argument("--model", default="llama3.2:3b",
                   help="torch: a registry name (random weights drawn from "
                        "--seed) unless --weights-dir; ollama: the model tag")
    p.add_argument("--device", default="cuda",
                   help="torch backend: cuda (default; raises with no card "
                        "visible) or cpu")
    p.add_argument("--weights-dir", default=None,
                   help="torch backend: a local HF checkpoint dir")
    p.add_argument("--tokenizer", default="byte",
                   help="torch backend: byte or hf:<name-or-path>")
    p.add_argument("--seed", type=int, default=0,
                   help="torch backend: seed of the random weights and "
                        "of sampling")
    p.add_argument("--quantize", action="store_true",
                   help="torch backend: int8 weights")
    p.add_argument("--quantize-act", action="store_true",
                   help="torch backend: W8A8 prefill (needs --quantize)")
    p.add_argument("--prefill-chunk-tokens", type=int, default=0,
                   help="torch backend: prefill in slices of this many "
                        "tokens (multiple of 128; 0 = whole prompt)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8901)
    p.add_argument("--max-batch", type=int, default=8,
                   help="engine batch ceiling per dispatch")
    p.add_argument("--max-new-tokens", type=int, default=1024,
                   help="torch backend: default decode budget (must be < the "
                        "model's max_seq_len — small configs like --model "
                        "tiny need this lowered)")
    p.add_argument("--max-wait-ms", type=float, default=10.0,
                   help="max time a head-of-line request waits for company")
    p.add_argument("--mesh", default=None,
                   help="multi-card serving mesh spec: not ported yet "
                        "(ROADMAP A10)")
    p.add_argument("--inflight", action="store_true",
                   help="in-flight batching: admit new requests into the "
                        "running decode batch at segment boundaries "
                        "(torch/fake backends; greedy outputs identical)")
    p.add_argument("--slots", type=int, default=None,
                   help="in-flight decode slots (default: --max-batch)")
    p.add_argument("--slot-prompt-tokens", type=int, default=0,
                   help="in-flight prompt bucket S; longer prompts fall "
                        "back to one-shot dispatch (0 = full context)")
    p.add_argument("--fused-segments", type=int, default=1,
                   help="fused multi-step decode: on-device segments per "
                        "slot-loop dispatch (the host polls asynchronously "
                        "and joins/cancels/streams at the fused cadence; "
                        "N>1 amortizes the dispatch/sync tax at small "
                        "batch, trading TTFT/poll latency bounded by N — "
                        "greedy outputs identical at every N)")
    p.add_argument("--max-queue", type=int, default=256,
                   help="admission control: max queued requests")
    p.add_argument("--max-queued-tokens", type=int, default=0,
                   help="admission control: max queued prompt tokens (0=off)")
    p.add_argument("--default-deadline-ms", type=float, default=None,
                   help="deadline applied to requests that carry none")
    p.add_argument("--spec-k", type=int, default=0,
                   help="reference-guided speculative decoding: draft up to "
                        "K tokens/step from each request's reference text "
                        "(0 = off; greedy outputs are identical either way)")
    p.add_argument("--cache-blocks", type=int, default=256,
                   help="radix prefix KV cache: device block budget for "
                        "cross-request prompt-prefix reuse (torch/fake "
                        "backends; greedy outputs are identical either way)")
    p.add_argument("--cache-block-tokens", type=int, default=64,
                   help="tokens per prefix-cache block (reuse granularity)")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="disable the prefix KV cache outright")
    p.add_argument("--no-supervise", action="store_true",
                   help="disable engine supervision (retry/bisect/"
                        "degradation ladder); failures fail the whole batch "
                        "with the raw error")
    p.add_argument("--retry-max-attempts", type=int, default=3,
                   help="supervised retry budget: failed dispatches one "
                        "request may ride before it stops being retried")
    p.add_argument("--probe-interval-ms", type=float, default=5000.0,
                   help="degradation ladder: quiet time before a recovery "
                        "probe climbs one rung back up")
    p.add_argument("--trace-sample", type=float, default=1.0,
                   help="fraction of requests recorded into the /debug/trace "
                        "ring (0 disables tracing entirely; histograms on "
                        "/metrics stay on regardless)")
    p.add_argument("--trace-ring", type=int, default=256,
                   help="how many recent request/batch traces to retain")
    p.add_argument("--trace-dir", default=None,
                   help="directory for trace dumps (/debug/trace?save=1, "
                        "shutdown dump); also arms the device_profile hook "
                        "(VNSUM_PROFILE_DIR) so the first engine batch "
                        "captures a torch.profiler device trace alongside")
    p.add_argument("--journal-dir", default=None,
                   help="durable serving: not ported yet (ROADMAP A15b)")
    p.add_argument("--journal-fsync-ms", type=float, default=None,
                   help="durable serving: not ported yet (ROADMAP A15b)")
    p.add_argument("--tenants", default=None,
                   help="multi-tenant QoS: not ported yet (ROADMAP A15b)")
    p.add_argument("--preempt-budget", type=int, default=None,
                   help="tier preemption under multi-tenant QoS: not "
                        "ported yet (ROADMAP A15b)")
    p.add_argument("--no-gang-affinity", action="store_true",
                   help="disable the queue's gang-affinity pick (siblings "
                        "of one structured job no longer cluster into the "
                        "same slot generation; gang admission and counts "
                        "stay on — this is the bench A/B lever, not a gang "
                        "kill-switch)")
    p.add_argument("--stream-heartbeat-s", type=float, default=15.0,
                   help="SSE keepalive: emit ': heartbeat' comment frames "
                        "after this much quiet so idle proxies keep the "
                        "connection; the write doubles as the disconnect "
                        "probe between segments (0 = off)")
    p.add_argument("--stream-idle-timeout-s", type=float, default=10.0,
                   help="bounded resume window: a streaming request whose "
                        "client disconnected (no pops, no Last-Event-ID "
                        "reattach) for this long is CANCELLED and its slot "
                        "reclaimed (0 = cancel immediately on disconnect, "
                        "no resume window)")
    p.add_argument("--slo", default=None,
                   help="declarative SLOs: not ported yet (ROADMAP A15b)")
    p.add_argument("--slo-fast-s", type=float, default=60.0,
                   help="fast window: the per-tenant usage latency gauges' "
                        "window (and the SLO fast burn window, A15b)")
    p.add_argument("--slo-slow-s", type=float, default=600.0,
                   help="the rolling-metrics horizon (and the SLO slow "
                        "burn window, A15b)")
    p.add_argument("--slo-burn-fast", type=float, default=None,
                   help="SLO fast burn threshold: not ported yet "
                        "(ROADMAP A15b)")
    p.add_argument("--slo-burn-slow", type=float, default=None,
                   help="SLO slow burn threshold: not ported yet "
                        "(ROADMAP A15b)")
    p.add_argument("--flight-dir", default=None,
                   help="flight recorder (obs/recorder.py) dump directory: "
                        "anomalies (brownout entry, fatal failure, poison "
                        "quarantine, SIGTERM drain) write "
                        "the typed-event ring here as "
                        "flight_<reason>_<utc-ms>_<n>.json. Unset = ring + "
                        "/debug/flightrecorder only, no dumps")
    p.add_argument("--flight-events", type=int, default=4096,
                   help="flight-recorder ring capacity (events)")
    p.add_argument("--no-watchdog", action="store_true",
                   help="disable hang/stall detection (serve/watchdog.py). "
                        "Debug lever only — without it a wedged dispatch "
                        "freezes the scheduler silently until every client "
                        "times out")
    p.add_argument("--watchdog-interval-s", type=float, default=0.5,
                   help="watchdog monitor cadence (detection latency adds "
                        "at most one interval on top of the exceeded "
                        "budget/deadline)")
    p.add_argument("--watchdog-stall-s", type=float, default=10.0,
                   help="heartbeat deadline for loop threads: a scheduler "
                        "loop quiet this long OUTSIDE a budgeted dispatch "
                        "is a lock-classified stall (escalates to "
                        "seal-and-exit; helper threads get 6x this)")
    p.add_argument("--watchdog-dispatch-budget-s", type=float, default=30.0,
                   help="base wall-clock budget per engine dispatch; the "
                        "token-derived term is added on top, and a "
                        "dispatch past its budget is declared HUNG "
                        "(riders resolve typed, the scheduler thread is "
                        "replaced)")
    p.add_argument("--watchdog-dispatch-per-token-ms", type=float,
                   default=10.0,
                   help="per-token addition to the dispatch budget "
                        "(prompt + decode-ceiling tokens), so big batches "
                        "earn proportionally longer budgets instead of "
                        "tripping a one-size timeout")
    p.add_argument("--drain-timeout-s", type=float, default=30.0,
                   help="graceful-shutdown drain budget before queued and "
                        "in-flight requests are shed typed")
    # hermetic load knobs: give the fake backend the device-dispatch
    # latency shape so cancels land mid-prefill/mid-decode instead of
    # between instantaneous calls
    p.add_argument("--fake-batch-overhead-ms", type=float, default=0.0,
                   help="fake backend: fixed per-dispatch latency")
    p.add_argument("--fake-per-prompt-ms", type=float, default=0.0,
                   help="fake backend: marginal per-prompt latency")
    p.add_argument("--fake-segment-overhead-ms", type=float, default=0.0,
                   help="fake backend: per-decode-segment latency (the "
                        "in-flight cancel and watchdog cases need segments "
                        "that take real time so they land mid-decode)")
    p.add_argument("--fake-per-step-ms", type=float, default=0.0,
                   help="fake backend: per-decode-step latency (both paths)")
    p.add_argument("--fake-segment-words", type=int, default=8,
                   help="fake backend: words a slot-loop segment retires "
                        "per row (smaller = more segment boundaries — the "
                        "churn soak needs decodes that span many segments "
                        "so disconnect cancels land mid-decode)")
    args = p.parse_args(argv)

    if args.fused_segments < 1:
        p.error(f"--fused-segments {args.fused_segments} must be >= 1")
    if args.fused_segments > 1 and not args.inflight:
        p.error("--fused-segments > 1 requires --inflight (it is the slot "
                "loop's dispatch-fusing knob)")
    cache_blocks = 0 if args.no_prefix_cache else args.cache_blocks
    # not ported yet: refused by name, never served without them
    for flag, value, item in (
        ("--journal-dir", args.journal_dir, "durable serving is ROADMAP A15b"),
        ("--journal-fsync-ms", args.journal_fsync_ms,
         "durable serving is ROADMAP A15b"),
        ("--tenants", args.tenants, "multi-tenant QoS is ROADMAP A15b"),
        ("--preempt-budget", args.preempt_budget,
         "multi-tenant QoS is ROADMAP A15b"),
        ("--slo", args.slo, "SLOs are ROADMAP A15b"),
        ("--slo-burn-fast", args.slo_burn_fast, "SLOs are ROADMAP A15b"),
        ("--slo-burn-slow", args.slo_burn_slow, "SLOs are ROADMAP A15b"),
        ("--mesh", args.mesh, "multi-card serving is ROADMAP A10"),
    ):
        if value is not None:
            p.error(f"{flag}: {item}, not ported yet")
    if args.backend == "hf":
        p.error("--backend hf: the hf backend is ROADMAP A5c, not ported yet")
    if args.backend == "torch":
        from ..pipeline.runner import torch_model_args

        # built the way the pipeline runner builds its engine
        backend = get_backend(
            "torch",
            **torch_model_args(args.model, args.weights_dir, args.tokenizer,
                               PipelineConfig().dtype, args.device),
            batch_size=args.max_batch,
            max_new_tokens=args.max_new_tokens,
            generation=GenerationConfig(spec_k=args.spec_k),
            seed=args.seed,
            quantize=args.quantize,
            quantize_act=args.quantize_act,
            prefill_chunk_tokens=args.prefill_chunk_tokens,
            cache_blocks=cache_blocks,
            cache_block_tokens=args.cache_block_tokens,
            device=args.device,
        )
    elif args.backend == "ollama":
        backend = get_backend("ollama", model=args.model)
    else:
        # the fake backend's synthetic cache blocks count whitespace words;
        # same budget flag, so hermetic dev servers exercise hit/evict paths
        backend = get_backend(
            "fake", spec_k=args.spec_k, prefix_cache_blocks=cache_blocks,
            batch_overhead_s=args.fake_batch_overhead_ms / 1000.0,
            per_prompt_s=args.fake_per_prompt_ms / 1000.0,
            segment_overhead_s=args.fake_segment_overhead_ms / 1000.0,
            per_step_s=args.fake_per_step_ms / 1000.0,
            segment_words=args.fake_segment_words,
        )

    supervisor = None
    if not args.no_supervise:
        from .supervisor import EngineSupervisor, RetryPolicy

        supervisor = EngineSupervisor(
            RetryPolicy(max_attempts=args.retry_max_attempts),
            probe_interval_s=args.probe_interval_ms / 1000.0,
        )
    state = ServeState(
        backend,
        supervisor=supervisor,
        supervise=not args.no_supervise,
        max_batch=args.max_batch,
        max_wait_s=args.max_wait_ms / 1000.0,
        max_queue_depth=args.max_queue,
        max_queued_tokens=args.max_queued_tokens,
        default_deadline_s=(
            args.default_deadline_ms / 1000.0
            if args.default_deadline_ms else None
        ),
        default_spec_k=args.spec_k,
        trace_sample=args.trace_sample,
        trace_ring=args.trace_ring,
        trace_dir=args.trace_dir,
        inflight=args.inflight,
        slots=args.slots,
        slot_prompt_tokens=args.slot_prompt_tokens,
        fused_segments=args.fused_segments,
        stream_heartbeat_s=args.stream_heartbeat_s,
        stream_idle_timeout_s=args.stream_idle_timeout_s,
        slo_fast_s=args.slo_fast_s,
        slo_slow_s=args.slo_slow_s,
        flight_dir=args.flight_dir,
        flight_events=args.flight_events,
        watchdog=not args.no_watchdog,
        watchdog_interval_s=args.watchdog_interval_s,
        watchdog_stall_s=args.watchdog_stall_s,
        watchdog_dispatch_base_s=args.watchdog_dispatch_budget_s,
        watchdog_dispatch_per_token_s=(
            args.watchdog_dispatch_per_token_ms / 1000.0
        ),
    )
    if args.no_gang_affinity:
        state.scheduler.queue.gang_affinity = False
    server = make_server(state, args.host, args.port)

    # SIGTERM/SIGINT: drain, exit 0 — an interrupted server must not die
    # mid-batch with its requests unanswered. The handler runs ON the main
    # thread inside serve_forever's poll loop, and shutdown() BLOCKS until
    # that loop exits — calling it inline would deadlock, so it runs on a
    # helper thread and the handler returns immediately.
    import signal

    def _graceful(signum, frame):
        logger.info("signal %d: draining", signum)
        import threading

        threading.Thread(target=server.shutdown, daemon=True).start()

    def _stacks_on_demand(signum, frame):
        # SIGUSR1: the manual twin of the watchdog's automatic stall dump —
        # `kill -USR1 <pid>` when the server LOOKS wedged writes every
        # thread's stack to --flight-dir (or logs it with nowhere to write).
        # Runs in the main thread's signal trampoline: snapshotting is
        # read-only and allocation-light, safe even mid-wedge
        from ..core.artifacts import atomic_write_json
        from .watchdog import snapshot_stacks

        stacks = snapshot_stacks()
        if args.flight_dir:
            import pathlib

            path = pathlib.Path(args.flight_dir) / (
                f"watchdog_sigusr1_{int(time.time() * 1000)}.json"
            )
            try:
                atomic_write_json(path, {
                    "reason": "sigusr1", "dumped_wall": time.time(),
                    "stacks": stacks,
                })
                logger.warning("SIGUSR1: wrote stack dump %s", path)
                return
            # lint-allow[swallowed-exception]: the log fallback below IS the answer — an unwritable flight dir must not crash the signal trampoline
            except OSError:
                logger.exception("SIGUSR1 stack dump failed; logging")
        for t in stacks:
            logger.warning("SIGUSR1 stack [%s]:\n%s", t["name"],
                           "\n".join(t["stack"]))

    try:
        signal.signal(signal.SIGTERM, _graceful)
        signal.signal(signal.SIGINT, _graceful)
        if hasattr(signal, "SIGUSR1"):
            signal.signal(signal.SIGUSR1, _stacks_on_demand)
    # lint-allow[swallowed-exception]: no request exists yet to resolve — logging that the embedding caller keeps signal ownership IS the handling
    except ValueError:
        # not the main thread (embedded/test use): the caller owns lifecycle
        logger.debug("not installing signal handlers off the main thread")

    logger.info(
        "serving on http://%s:%d/ (backend=%s max_batch=%d max_wait=%.0fms)",
        args.host, args.port, backend.name, args.max_batch, args.max_wait_ms,
    )
    try:
        server.serve_forever()
    # lint-allow[swallowed-exception]: Ctrl-C IS the shutdown request; the finally below drains the queue and resolves every future
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        # drain within the budget (overrun sheds typed)
        state.close(drain_timeout_s=args.drain_timeout_s)
        if state.obs is not None and args.trace_dir:
            p = save_timestamped_trace(
                state.obs.chrome_trace(), args.trace_dir, "serve"
            )
            logger.info("wrote shutdown trace dump %s", p)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
