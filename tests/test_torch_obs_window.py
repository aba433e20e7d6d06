"""Window math (obs/window.py): the property the SLO engine stands on —
merging a WindowedHistogram's live sub-windows equals the cumulative
histogram over the same observations — plus expiry (old windows drop out
of quantiles), exemplar aging, and the WindowedCounter mirror."""
from __future__ import annotations

import random

import pytest

from vnsum_tpu_torch.obs.histogram import TTFT_BUCKETS_S, Histogram
from vnsum_tpu_torch.obs.window import WindowedCounter, WindowedHistogram

BOUNDS = TTFT_BUCKETS_S


def hist_state(h: Histogram) -> tuple:
    return (tuple(h.counts), round(h.sum, 9), h.count)


# -- the merge == cumulative property -----------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_merged_subwindows_equal_cumulative_within_horizon(seed):
    """Property: as long as no observation has expired, merging the ring
    IS the cumulative histogram — same bucket counts, sum, and therefore
    identical quantiles. Randomized times/values over many sub-window
    boundaries; seeded, so a failure replays."""
    rng = random.Random(seed)
    wh = WindowedHistogram(BOUNDS, horizon_s=60.0, sub_windows=12)
    cum = Histogram(BOUNDS)
    t0 = rng.uniform(0, 1000.0)
    # all observations land within horizon - sub_s of each other (a span
    # any wider can straddle one more sub-window than the ring holds), in
    # nondecreasing time order (the ring recycles slots as time advances —
    # going back in time is not part of the contract)
    times = sorted(t0 + rng.uniform(0.0, 54.9) for _ in range(300))
    last = times[-1]
    for t in times:
        v = rng.choice([rng.uniform(0, 0.05), rng.uniform(0.05, 2.0),
                        rng.uniform(2.0, 30.0)])  # spread across buckets
        wh.observe(v, now=t)
        cum.observe(v)
    merged = wh.merged(now=last)
    assert hist_state(merged) == hist_state(cum)
    for q in (0.5, 0.9, 0.95, 0.99):
        assert merged.percentile(q) == cum.percentile(q)
    assert merged.fraction_le(0.5) == cum.fraction_le(0.5)


def test_expired_windows_drop_out_of_quantiles():
    wh = WindowedHistogram(BOUNDS, horizon_s=60.0, sub_windows=6)
    # a burst of SLOW observations early...
    for i in range(50):
        wh.observe(8.0, now=100.0 + i * 0.1)
    assert wh.merged(now=110.0).percentile(0.99) > 5.0
    # ...then only fast ones after the slow burst expired
    for i in range(50):
        wh.observe(0.01, now=200.0 + i * 0.1)
    h = wh.merged(now=210.0)
    assert h.count == 50
    assert h.percentile(0.99) < 0.1  # the 8s tail is GONE, not averaged in
    # partial expiry: read at a time where the slow burst is half-aged out
    wh2 = WindowedHistogram(BOUNDS, horizon_s=60.0, sub_windows=6)
    wh2.observe(8.0, now=100.0)
    wh2.observe(0.01, now=130.0)
    h_both = wh2.merged(now=140.0)   # both inside the horizon
    assert h_both.count == 2
    h_late = wh2.merged(now=185.0)   # 8s obs now > horizon old
    assert h_late.count == 1 and h_late.percentile(0.99) < 0.1


def test_narrow_window_reads_subset_of_horizon():
    """merged(window_s) covers only the most recent sub-windows — the
    fast/slow burn split reads one ring at two widths."""
    wh = WindowedHistogram(BOUNDS, horizon_s=100.0, sub_windows=10)
    wh.observe(5.0, now=10.0)     # old
    wh.observe(0.02, now=95.0)    # recent
    slow = wh.merged(now=99.0)
    fast = wh.merged(window_s=10.0, now=99.0)
    assert slow.count == 2
    assert fast.count == 1 and fast.percentile(0.5) < 0.1


def test_ring_slot_recycling_is_exact():
    """Writing more than a full horizon later lands in a RESET slot — no
    bleed-through from the expired occupant of the same ring position."""
    wh = WindowedHistogram(BOUNDS, horizon_s=10.0, sub_windows=5)
    wh.observe(1.0, now=1.0)
    # same slot (epoch 0 and epoch 5 both map to slot 0), one horizon later
    wh.observe(0.01, now=11.0)
    h = wh.merged(now=11.0)
    assert h.count == 1
    assert h.percentile(0.99) < 0.1


def test_exemplars_attach_and_age_out():
    wh = WindowedHistogram(BOUNDS, horizon_s=60.0, sub_windows=6)
    wh.observe(8.0, now=100.0, exemplar="req-slow")
    wh.observe(0.01, now=101.0, exemplar="req-fast")
    ex = wh.exemplars(now=110.0)
    ids = [e[0] for e in ex if e is not None]
    assert set(ids) == {"req-slow", "req-fast"}
    # a narrower window ages the old exemplar out
    ex = wh.exemplars(window_s=5.0, now=110.0)
    assert [e[0] for e in ex if e is not None] == []
    # past the horizon everything ages out
    assert all(e is None for e in wh.exemplars(now=300.0))


def test_windowed_counter_mirrors_and_expires():
    wc = WindowedCounter(horizon_s=60.0, sub_windows=6)
    for i in range(10):
        wc.add("completed", now=100.0 + i * 2)  # spans two sub-windows
    wc.add("errors", 3, now=105.0)
    assert wc.total("completed", now=119.0) == 10
    assert wc.total("errors", now=119.0) == 3
    assert 0 < wc.total("completed", window_s=10.0, now=119.0) < 10
    assert wc.total("completed", now=300.0) == 0
    assert wc.total("never", now=110.0) == 0


def test_bad_construction_rejected():
    with pytest.raises(ValueError):
        WindowedHistogram(BOUNDS, horizon_s=0)
    with pytest.raises(ValueError):
        WindowedCounter(sub_windows=0)


# -- Histogram extensions the windows rely on ---------------------------------


def test_histogram_merge_reset_and_fraction_le():
    a = Histogram(BOUNDS)
    b = Histogram(BOUNDS)
    for v in (0.01, 0.2, 3.0, 100.0):
        a.observe(v)
    b.observe(0.04)
    a.merge_from(b)
    ref = Histogram(BOUNDS)
    for v in (0.01, 0.2, 3.0, 100.0, 0.04):
        ref.observe(v)
    assert hist_state(a) == hist_state(ref)
    with pytest.raises(ValueError):
        a.merge_from(Histogram((1.0, 2.0)))
    # fraction_le: interpolated, +Inf tail counts as violating
    h = Histogram((1.0, 2.0))
    for v in (0.5, 1.5, 5.0):
        h.observe(v)
    assert h.fraction_le(1.0) == pytest.approx(1 / 3)
    assert h.fraction_le(1.5) == pytest.approx(0.5)  # half of bucket 2
    assert h.fraction_le(10.0) == pytest.approx(2 / 3)  # tail never counts
    assert Histogram(BOUNDS).fraction_le(1.0) == 1.0  # vacuous when empty
    h.reset()
    assert h.count == 0 and sum(h.counts) == 0 and h.sum == 0.0
