"""Process-kill chaos helpers: subprocess server lifecycle + seeded kill
schedules.

The durability layer (serve/journal.py) claims that a served process can
die at ANY instruction and no accepted request is lost. In-process fault
injection (:mod:`faults`) cannot test that claim — only actually killing
the process can. These helpers let tests (and a soak harness) do it
deterministically:

- :class:`ServerProcess` spawns ``python -m vnsum_tpu_torch.serve.server`` as a
  real subprocess, waits for ``/healthz``, and exposes ``sigkill()`` (the
  crash under test: no handler runs, no drain, no seal) and ``sigterm()``
  (the graceful path under test: drain + seal + exit 0).
- :class:`KillSchedule` derives the kill points from one seed: kind
  (``mid_load`` = SIGKILL while requests are in flight, i.e. mid-prefill /
  mid-decode depending on the draw; ``mid_drain`` = SIGTERM first, then
  SIGKILL a beat into the drain) and the delay before each, so a failing
  soak replays bit-for-bit from its seed.

Like the rest of this package, nothing here imports torch or the serving
layer — the server under test lives in its own process.

Copy of ``vnsum_tpu/testing/chaos.py``. ``ServerProcess`` starts the port's
server and ``RouterProcess`` the port's fleet router
(``python -m vnsum_tpu_torch.serve.router``), each with ``--backend fake``
unless ``extra_args`` names another backend.
"""
from __future__ import annotations

import http.client
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
from dataclasses import dataclass

from ..core.logging import get_logger

logger = get_logger("vnsum.testing.chaos")


def free_port() -> int:
    """An OS-assigned free TCP port (racy by nature, fine for tests)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_json(method: str, host: str, port: int, path: str,
              payload: dict | None = None, timeout: float = 30.0,
              headers: dict | None = None):
    """One HTTP round trip -> (status, parsed JSON body | None).
    ``headers`` adds/overrides request headers (the QoS soak's X-Tenant)."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        body = json.dumps(payload) if payload is not None else None
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        raw = resp.read()
        try:
            return resp.status, json.loads(raw) if raw else None
        except ValueError:
            return resp.status, None
    finally:
        conn.close()


def http_delete(host: str, port: int, path: str, timeout: float = 30.0):
    """One DELETE round trip -> (status, parsed JSON body | None) — the
    churn soak's cancel verb."""
    return http_json("DELETE", host, port, path, timeout=timeout)


def parse_sse(raw: str) -> list[tuple[str | None, dict | None]]:
    """Raw SSE body -> [(event_name, payload)] (comment-only frames like
    the ``: heartbeat`` keepalive parse as (None, None))."""
    events = []
    for frame in raw.split("\n\n"):
        if not frame.strip():
            continue
        name = data = None
        for line in frame.splitlines():
            if line.startswith("event: "):
                name = line[len("event: "):]
            elif line.startswith("data: "):
                try:
                    data = json.loads(line[len("data: "):])
                # lint-allow[swallowed-exception]: a torn frame (the abandon path cuts mid-byte) parses as data=None, which the caller treats as a non-event
                except ValueError:
                    data = None
        events.append((name, data))
    return events


def sse_stream(host: str, port: int, path: str, payload: dict,
               abandon_after: int | None = None,
               headers: dict | None = None,
               timeout: float = 60.0):
    """Drive one SSE request -> (status, events). ``abandon_after=N`` reads
    about N frames and then DROPS the connection without finishing — the
    disconnecting client the churn soak simulates; None reads to the end.
    Non-200 responses return (status, parsed-JSON-or-None) like http_json."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    resp = None
    try:
        conn.request("POST", path, body=json.dumps(payload),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        if resp.status != 200:
            raw = resp.read()
            try:
                return resp.status, json.loads(raw) if raw else None
            # lint-allow[swallowed-exception]: a non-JSON error body becomes None — the soak only branches on status
            except ValueError:
                return resp.status, None
        if abandon_after is None:
            return 200, parse_sse(resp.read().decode(errors="replace"))
        frames = 0
        buf = b""
        while frames < abandon_after:
            chunk = resp.fp.read1(4096)
            if not chunk:
                break
            buf += chunk
            frames = buf.count(b"\n\n")
        return 200, parse_sse(buf.decode(errors="replace"))
    finally:
        # http.client hands the socket to the response for
        # Connection: close replies — closing both covers either owner
        if resp is not None:
            try:
                resp.close()
            # lint-allow[swallowed-exception]: teardown of an already-dead socket (the abandon path's whole point) has nothing left to resolve
            except Exception:
                pass
        conn.close()


class ServerProcess:
    """One serve-server subprocess under chaos control."""

    def __init__(self, port: int, *, journal_dir: str,
                 extra_args: list[str] | None = None,
                 env: dict | None = None) -> None:
        self.port = port
        self.journal_dir = journal_dir
        self.extra_args = list(extra_args or [])
        self.env = env
        self.proc: subprocess.Popen | None = None

    def start(self) -> None:
        argv = [
            sys.executable, "-m", "vnsum_tpu_torch.serve.server",
            "--backend", "fake",
            "--port", str(self.port),
            "--journal-dir", self.journal_dir,
            *self.extra_args,
        ]
        env = dict(os.environ)
        if self.env:
            env.update(self.env)
        self.proc = subprocess.Popen(
            argv, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def wait_healthy(self, timeout_s: float = 30.0) -> None:
        t_end = time.monotonic() + timeout_s
        while time.monotonic() < t_end:
            if not self.alive:
                raise RuntimeError(
                    f"server exited during startup (rc={self.proc.poll()})"
                )
            try:
                status, _ = http_json(
                    "GET", "127.0.0.1", self.port, "/healthz", timeout=2.0
                )
                if status == 200:
                    return
            except OSError:
                pass
            time.sleep(0.05)
        raise TimeoutError(f"server on :{self.port} never became healthy")

    def sigkill(self) -> None:
        """The crash under test: immediate, no handler, no drain, no seal."""
        if self.alive:
            self.proc.send_signal(signal.SIGKILL)
            self.proc.wait(timeout=10)

    def sigterm(self) -> None:
        """The graceful path under test: drain + journal seal + exit 0."""
        if self.alive:
            self.proc.send_signal(signal.SIGTERM)

    def wait_exit(self, timeout_s: float = 30.0) -> int:
        return self.proc.wait(timeout=timeout_s)


class RouterProcess(ServerProcess):
    """One fleet-router subprocess (serve/router.py) under chaos control:
    the router spawns and owns its N engine workers, so killing a worker
    means SIGKILLing a pid read off the router's ``/healthz`` worker
    table, not a handle we hold. Readiness is the router's ``/readyz``
    (typed 503 until a worker is routable), not ``/healthz`` liveness.

    As ``ServerProcess``, it asks for ``--backend fake`` unless
    ``extra_args`` names another (``--backend torch``: the router's own
    default)."""

    def __init__(self, port: int, *, fleet_dir: str, spawn_workers: int = 3,
                 extra_args: list[str] | None = None,
                 env: dict | None = None) -> None:
        super().__init__(port, journal_dir=os.path.join(fleet_dir, "router"),
                         extra_args=extra_args, env=env)
        self.fleet_dir = fleet_dir
        self.spawn_workers = spawn_workers

    def start(self) -> None:
        argv = [
            sys.executable, "-m", "vnsum_tpu_torch.serve.router",
            "--port", str(self.port),
            "--spawn-workers", str(self.spawn_workers),
            "--fleet-dir", self.fleet_dir,
            "--backend", "fake",
            *self.extra_args,
        ]
        env = dict(os.environ)
        if self.env:
            env.update(self.env)
        self.proc = subprocess.Popen(
            argv, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )

    def wait_ready(self, timeout_s: float = 60.0) -> None:
        """Poll the router's /readyz until 200 — replay done, >=1 worker
        routable. Startup is slower than a bare server: N worker
        subprocesses must come up first."""
        t_end = time.monotonic() + timeout_s
        while time.monotonic() < t_end:
            if not self.alive:
                raise RuntimeError(
                    f"router exited during startup (rc={self.proc.poll()})"
                )
            try:
                status, _ = http_json(
                    "GET", "127.0.0.1", self.port, "/readyz", timeout=2.0
                )
                if status == 200:
                    return
            except OSError:
                pass
            time.sleep(0.05)
        raise TimeoutError(f"router on :{self.port} never became ready")

    def worker_pids(self) -> dict[str, int]:
        """Live worker name -> pid off the router's /healthz table — the
        kill-target surface for fleet chaos."""
        _, payload = http_json(
            "GET", "127.0.0.1", self.port, "/healthz", timeout=5.0
        )
        return {w["name"]: w["pid"] for w in (payload or {}).get("workers", [])
                if w.get("pid")}

    def kill_worker(self, name: str) -> int:
        """SIGKILL one spawned worker by name (the crash under test: no
        drain, no seal — the router's handoff owes its unfinished work)."""
        pid = self.worker_pids()[name]
        os.kill(pid, signal.SIGKILL)
        return pid


@dataclass(frozen=True)
class KillPoint:
    """One scheduled kill. ``kind`` is ``mid_load`` (SIGKILL while traffic
    is in flight) or ``mid_drain`` (SIGTERM, then SIGKILL ``drain_gap_s``
    into the drain); ``delay_s`` is how long load runs before the kill."""

    kind: str
    delay_s: float
    drain_gap_s: float = 0.0


class KillSchedule:
    """Seeded schedule of :class:`KillPoint`\\ s. The default shape covers
    the three regimes the acceptance criteria name: an early kill (load
    just started — requests are mid-prefill), a late kill (the batch is
    deep in decode), and a drain kill (SIGTERM received, drain underway,
    then SIGKILL). With ``qos=True`` the shape swaps one mid_load for a
    ``mid_preempt`` kill: same SIGKILL-under-load mechanics, but the server
    runs with a widened eviction->PREEMPTED-journal gap
    (VNSUM_CHAOS_PREEMPT_GAP_MS) so the kill lands inside the preemption
    window the ledger invariant must survive. Non-qos schedules are
    bit-identical to their pre-QoS draws (same seed -> same soak)."""

    def __init__(self, seed: int, kills: int = 3,
                 load_window_s: float = 1.5, qos: bool = False) -> None:
        self.seed = seed
        rng = random.Random(seed)
        kinds = (
            ["mid_preempt", "mid_load", "mid_drain"] if qos
            else ["mid_load", "mid_load", "mid_drain"]
        )
        while len(kinds) < kills:
            kinds.append(rng.choice(
                ["mid_load", "mid_drain"] + (["mid_preempt"] if qos else [])
            ))
        rng.shuffle(kinds)
        self.points = [
            KillPoint(
                kind=k,
                # early draws land mid-prefill, late draws mid-decode
                delay_s=round(rng.uniform(0.15, load_window_s), 3),
                drain_gap_s=(
                    round(rng.uniform(0.05, 0.4), 3)
                    if k == "mid_drain" else 0.0
                ),
            )
            for k in kinds[:kills]
        ]

    def describe(self) -> list[dict]:
        return [
            {"kind": p.kind, "delay_s": p.delay_s,
             "drain_gap_s": p.drain_gap_s}
            for p in self.points
        ]
