"""Deterministic test instrumentation baked into the runtime.

Copy of ``vnsum_tpu/testing``: the seeded fault-injection plan
(:mod:`faults`), whose zero-cost hooks the fake backend's dispatch sites
and the request journal's fsync call into, and the process-kill chaos
helpers (:mod:`chaos`) that test durable serving's claim by killing a
real server process. Nothing here imports torch or the serving layer.
"""
from .chaos import KillPoint, KillSchedule, ServerProcess, free_port
from .faults import (
    FaultPlan,
    FaultSpec,
    InjectedFault,
    InjectedResourceExhausted,
    arm,
    disarm,
    fault,
    injected,
    plan_from_env,
)

__all__ = [
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "InjectedResourceExhausted",
    "KillPoint",
    "KillSchedule",
    "ServerProcess",
    "arm",
    "disarm",
    "fault",
    "free_port",
    "injected",
    "plan_from_env",
]
