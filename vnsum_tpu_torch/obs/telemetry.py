"""Rolling-window aggregates for engine telemetry gauges.

Cumulative counters answer "how much since boot"; operators watching a live
server need "how is it doing NOW". :class:`Rolling` keeps the last N
(numerator, denominator) pairs — accepted/drafted tokens, generated
tokens/engine-seconds — so `serve/metrics.py` can export
``vnsum_serve_spec_acceptance_rolling`` and
``vnsum_serve_tokens_per_second_rolling`` without unbounded state or a
time-series dependency. O(1) per observation (deque append + running sums).

Copy of ``vnsum_tpu/obs/telemetry.py``; only the imports and the names of
the device and its engine differ.
"""
from __future__ import annotations

from collections import deque


class Rolling:
    """Windowed ratio of two running sums over the last ``window`` samples.

    Not internally locked — owners (ServeMetrics) serialize observations
    under their own lock, same contract as `obs/histogram.py`.
    """

    __slots__ = ("_win", "_num", "_den")

    def __init__(self, window: int = 256) -> None:
        self._win: deque[tuple[float, float]] = deque(maxlen=max(window, 1))
        self._num = 0.0
        self._den = 0.0

    def add(self, num: float, den: float) -> None:
        if len(self._win) == self._win.maxlen:
            old_n, old_d = self._win[0]
            self._num -= old_n
            self._den -= old_d
        self._win.append((num, den))
        self._num += num
        self._den += den

    @property
    def samples(self) -> int:
        return len(self._win)

    def rate(self) -> float:
        """num/den over the window; 0 when the denominator is empty."""
        return self._num / self._den if self._den else 0.0
