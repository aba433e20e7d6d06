"""Chrome trace-event JSON export (Perfetto-loadable timelines).

Serializes the in-memory span model (`obs/trace.py`) into the trace-event
format both `chrome://tracing` and https://ui.perfetto.dev load directly:

- every **engine batch** becomes its own track under the ``engine`` process
  (pid 1): the batch slice, with the backend's phase events (prefill /
  decode segments / spec steps) nested inside it;
- every **request** becomes its own process (pid 100+): track 0 carries the
  request-level slice, and each fanned-out prompt's queue-wait/engine/
  postprocess slices sit on their own sub-track — per-prompt intervals of
  one request overlap in time, and the trace-event format requires slices
  on a single track to nest properly, so overlap gets a track, not a stack.

All host timestamps are `time.monotonic()` seconds; export rebases them to
microseconds from the earliest event so the viewer opens at t=0. Output is a
plain dict — callers `json.dumps` it (the `/debug/trace` endpoint) or hand
it to :func:`save_chrome_trace`.

Copy of ``vnsum_tpu/obs/export.py``; only the imports and the names of the
device and its engine differ.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

ENGINE_PID = 1
REQUEST_PID0 = 100


def chrome_trace(requests, batches) -> dict:
    """Build the trace-event dict from finished Request/Batch traces."""
    # snapshot once: finished traces are sealed, but a shed trace can land
    # in the ring while a straggler span races the seal — never iterate the
    # live span lists
    req_spans = [(r, r.spans_snapshot()) for r in requests]
    epoch = time.monotonic()
    for _, spans in req_spans:
        for sp in spans:
            epoch = min(epoch, sp.t0)
    for b in batches:
        epoch = min(epoch, b.t0)
    us = lambda t: round((t - epoch) * 1e6, 3)  # noqa: E731
    ev: list[dict] = []

    def meta(name, pid, tid, value):
        ev.append({"ph": "M", "name": name, "pid": pid, "tid": tid,
                   "args": {"name": value}})

    def slice_(name, pid, tid, t0, dur, args=None):
        e = {"ph": "X", "name": name, "pid": pid, "tid": tid,
             "ts": us(t0), "dur": round(max(dur, 0.0) * 1e6, 3)}
        if args:
            e["args"] = args
        ev.append(e)

    if batches:
        meta("process_name", ENGINE_PID, 0, "engine")
    for b in batches:
        tid = b.batch_id
        meta("thread_name", ENGINE_PID, tid, f"batch {b.batch_id}")
        t1 = b.t1 if b.t1 is not None else b.t0
        slice_(
            f"batch[occ={b.occupancy}]", ENGINE_PID, tid, b.t0, t1 - b.t0,
            {"occupancy": b.occupancy, "gen_tokens": b.gen_tokens},
        )
        for sp in b.events:
            slice_(sp.name, ENGINE_PID, tid, sp.t0, sp.dur, sp.args)

    for i, (r, spans) in enumerate(req_spans):
        pid = REQUEST_PID0 + i
        meta("process_name", pid, 0, f"request {r.trace_id}")
        tracks = {sp.track for sp in spans}
        for tr in sorted(tracks):
            meta("thread_name", pid, tr,
                 "request" if tr == 0 else f"prompt {tr - 1}")
        for sp in spans:
            slice_(sp.name, pid, sp.track, sp.t0, sp.dur, sp.args)

    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def trace_state_payload(requests) -> list[dict]:
    """Raw span state of finished request traces, JSON-shaped — the wire
    format the fleet router's ``/debug/trace`` stitcher pulls from each
    worker (``GET /debug/obs/snapshot``). Deliberately NOT chrome_trace():
    that export rebases timestamps to a per-process epoch, which destroys
    the cross-process alignment the stitcher needs; this payload keeps the
    worker's monotonic seconds verbatim and lets the router apply its
    probe-estimated clock offset before any rebase."""
    out = []
    for r in requests:
        out.append({
            "trace_id": r.trace_id,
            "parent": getattr(r, "parent", None),
            "status": r.status,
            "t_start": r.t_start,
            "spans": [
                {"name": sp.name, "t0": sp.t0, "dur": sp.dur,
                 "track": sp.track,
                 **({"args": sp.args} if sp.args else {})}
                for sp in r.spans_snapshot()
            ],
        })
    return out


# per-source track spacing in the merged trace: each contributing process
# gets its own block of Perfetto tracks within a request's process group,
# so a worker's per-prompt sub-tracks can never collide with the router's
_SOURCE_TRACK_STRIDE = 1000


def merged_chrome_trace(groups) -> dict:
    """ONE Chrome trace from the span rings of several PROCESSES — the
    fleet stitcher (router ``/debug/trace``). ``groups`` is a list of
    ``{"source": label, "clock_offset_s": off, "traces": [...]}``, where
    ``traces`` is :func:`trace_state_payload` output from that process and
    ``off`` maps its monotonic clock into the reference (router) clock:
    ``t_ref = t + off`` (the router estimates it from probe RTT midpoints;
    its own group carries 0.0).

    Traces sharing a trace_id — the router's root trace and every worker
    hop of the same request, INCLUDING the pre- and post-failover halves
    of a handed-off request — merge into one Perfetto process; each source
    contributes its own track block, named ``<source>:request`` /
    ``<source>:prompt N``."""
    # trace_id -> [(source, clock_offset_s, trace_payload), ...] in group
    # order, so the reference process (the router) lists first
    by_id: dict[str, list] = {}
    for g in groups:
        off = float(g.get("clock_offset_s") or 0.0)
        for t in g.get("traces") or []:
            by_id.setdefault(t["trace_id"], []).append(
                (g.get("source", "?"), off, t)
            )
    epoch = None
    for contribs in by_id.values():
        for _src, off, t in contribs:
            for sp in t.get("spans") or []:
                t_ref = float(sp["t0"]) + off
                epoch = t_ref if epoch is None else min(epoch, t_ref)
    if epoch is None:
        epoch = 0.0
    ev: list[dict] = []
    for i, trace_id in enumerate(sorted(
        by_id,
        key=lambda tid: min(
            (float(sp["t0"]) + off
             for _s, off, t in by_id[tid] for sp in t.get("spans") or []),
            default=0.0,
        ),
    )):
        pid = REQUEST_PID0 + i
        ev.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": f"request {trace_id}"}})
        # one track block per contributing (source, hop): the pre- and
        # post-failover halves of one request come from different worker
        # sources and land side by side under the shared trace id
        for j, (source, off, t) in enumerate(by_id[trace_id]):
            base = j * _SOURCE_TRACK_STRIDE
            spans = t.get("spans") or []
            tracks = sorted({int(sp.get("track", 0)) for sp in spans})
            for tr in tracks:
                label = ("request" if tr == 0 else f"prompt {tr - 1}")
                ev.append({
                    "ph": "M", "name": "thread_name", "pid": pid,
                    "tid": base + tr,
                    "args": {"name": f"{source}:{label}"},
                })
            for sp in spans:
                e = {
                    "ph": "X", "name": sp["name"], "pid": pid,
                    "tid": base + int(sp.get("track", 0)),
                    "ts": round((float(sp["t0"]) + off - epoch) * 1e6, 3),
                    "dur": round(max(float(sp["dur"]), 0.0) * 1e6, 3),
                }
                args = dict(sp.get("args") or {})
                args["source"] = source
                if t.get("parent"):
                    args.setdefault("parent_span", t["parent"])
                e["args"] = args
                ev.append(e)
    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def spans_to_chrome(spans, process_name: str = "pipeline") -> dict:
    """Export a flat span list (e.g. `core/profiling.Tracer.timeline()`) as
    one single-process timeline — how offline pipeline runs share the same
    Perfetto workflow as the serving rings."""
    epoch = min((sp.t0 for sp in spans), default=0.0)
    ev: list[dict] = [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
         "args": {"name": process_name}}
    ]
    for sp in spans:
        e = {
            "ph": "X", "name": sp.name, "pid": 1, "tid": sp.track,
            "ts": round((sp.t0 - epoch) * 1e6, 3),
            "dur": round(max(sp.dur, 0.0) * 1e6, 3),
        }
        if sp.args:
            e["args"] = sp.args
        ev.append(e)
    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def save_chrome_trace(trace: dict, path) -> Path:
    """Write a trace dict as .json next to any torch.profiler device trace
    (`core/profiling.device_profile` writes into the same directory when
    armed), so host spans and device timelines open side by side.
    Atomic (write-temp + os.replace, core/artifacts.py): the shutdown dump
    path runs while the process is dying — a crash mid-dump must not leave
    a truncated JSON the next Perfetto load chokes on."""
    from ..core.artifacts import atomic_write_text

    return atomic_write_text(Path(path), json.dumps(trace))


def save_timestamped_trace(trace: dict, directory, prefix: str) -> Path:
    """THE dump naming policy (serve /debug/trace?save=1, serve shutdown,
    pipeline runs): <prefix>_trace_<ts>.json in ``directory``, suffixed
    _1/_2/... instead of silently overwriting when two dumps land within
    the same second."""
    d = Path(directory)
    ts = time.strftime("%Y%m%d_%H%M%S")
    path = d / f"{prefix}_trace_{ts}.json"
    n = 1
    while path.exists():
        path = d / f"{prefix}_trace_{ts}_{n}.json"
        n += 1
    return save_chrome_trace(trace, path)
