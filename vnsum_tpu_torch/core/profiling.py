"""Device profiling hook.

Counterpart of ``device_profile`` in ``vnsum_tpu/core/profiling.py`` (the
rest of that module, the pipeline ``Tracer`` and ``annotate``, is ROADMAP
A14). The JAX hook wraps ``jax.profiler.trace``; here the enclosed block
runs under ``torch.profiler`` (CPU activity, plus CUDA activity where a
card is visible) and the trace lands in the directory as a Chrome
trace-event JSON, next to the serving layer's own host-span dumps, so both
open in ui.perfetto.dev.

Gated: a no-op unless a directory is given or ``VNSUM_PROFILE_DIR`` is set,
so production paths can wrap their hot sections unconditionally.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import time
from pathlib import Path

_SEQ = itertools.count(1)


@contextlib.contextmanager
def device_profile(log_dir: str | None = None):
    """Capture a torch.profiler trace of the enclosed block into
    ``<log_dir>/device_<utc-ms>_<n>.json``; returns nothing. ``log_dir``
    falls back to ``$VNSUM_PROFILE_DIR``; when neither is set this is a
    no-op."""
    log_dir = log_dir or os.environ.get("VNSUM_PROFILE_DIR")
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(
        str(out / f"device_{int(time.time() * 1000)}_{next(_SEQ)}.json"))
