"""Deterministic test instrumentation baked into the runtime.

Copy of ``vnsum_tpu/testing``'s seeded fault-injection plan
(:mod:`faults`), whose zero-cost hooks the fake backend's dispatch sites
call into. Nothing here imports torch or the serving layer. The
process-kill chaos helpers wait for the fleet (ROADMAP A15b).
"""
