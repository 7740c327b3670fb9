"""The rate, percentile and idle-share arithmetic on made-up timelines."""

import statistics

import pytest

from benchmark import trace
from benchmark.drivers.generate import percentile


def steady_with_stall(stall_at=50, stall_s=0.2):
    """100 calls of 10 ms on the device, 1 ms apart, and one stall of
    ``stall_s`` before call ``stall_at``."""
    device, t = [], 0.0
    for i in range(100):
        if i == stall_at:
            t += stall_s
        device.append(("kernel", t, t + 0.010))
        t += 0.011
    return device, (0.0, t)


def test_idle_share_counts_a_stall_that_a_median_hides():
    device, window = steady_with_stall()
    s = trace.summarize(device, [], window)
    assert s.busy_s == pytest.approx(1.0)
    assert s.window_s == pytest.approx(1.3)
    whole = trace.idle_share(s.busy_s, s.window_s)
    assert whole == pytest.approx(100 * 0.3 / 1.3)
    # Ten chunks of ten calls: the median chunk never sees the stall.
    chunks = []
    for c in range(10):
        part = device[10 * c:10 * c + 10]
        lo, hi = part[0][1], part[-1][2] + 0.001
        cs = trace.summarize(part, [], (lo, hi))
        chunks.append(trace.idle_share(cs.busy_s, cs.window_s))
    assert statistics.median(chunks) == pytest.approx(100 / 11, rel=1e-2)
    assert whole > 2 * statistics.median(chunks)


def test_rate_over_the_whole_window_counts_the_stall():
    device, (lo, hi) = steady_with_stall()
    images_per_call = 32
    rate = len(device) * images_per_call / (hi - lo)
    per_call = [images_per_call / 0.011] * len(device)
    assert rate == pytest.approx(3200 / 1.3)
    assert statistics.median(per_call) > 1.15 * rate


def test_overlapping_streams_and_window_edges():
    device = [("a", 0.0, 0.4), ("b", 0.2, 0.6), ("c", 0.9, 1.5)]
    s = trace.summarize(device, [("host.op", 0.55, 0.95)], (0.1, 1.2))
    # a and b merge to [0.1, 0.6]; c is cut at the window's end.
    assert s.busy_s == pytest.approx(0.5 + 0.3)
    assert s.idle_gaps == [("host.op", pytest.approx(0.3))]
    assert s.device_ops[0][0] in ("b", "c")
    assert s.kernel_s("c") == pytest.approx(0.3)


def test_gap_goes_to_the_innermost_host_event():
    device = [("k", 0.0, 1.0), ("k", 2.0, 3.0)]
    host = [("outer", 0.5, 2.5), ("inner", 1.2, 1.8), ("elsewhere", 2.6, 2.9)]
    s = trace.summarize(device, host, (0.0, 3.0))
    assert s.idle_gaps == [("inner", pytest.approx(1.0))]
    assert s.breakdown()["idle_gaps"] == [["inner", pytest.approx(1.0)]]


def test_kernel_time_matches_whole_symbols():
    device = [("void damsm_dr_pair<20>(float const*)", 0.0, 0.1),
              ("damsm_dr_sum(float*)", 0.1, 0.3),
              ("damsm_dr_pair_extra", 0.3, 0.6)]
    s = trace.summarize(device, [], (0.0, 1.0))
    assert s.kernel_s("damsm_dr_pair") == pytest.approx(0.1)
    assert s.kernel_s("damsm_dr_sum") == pytest.approx(0.2)


@pytest.mark.parametrize("q,expected", [(50, 50.5), (95, 95.05), (100, 100)])
def test_percentile_is_linear_between_order_statistics(q, expected):
    assert percentile(list(range(1, 101)), q) == pytest.approx(expected)


def test_p95_of_a_tail():
    lat = [0.060] * 380 + [0.200] * 20
    assert percentile(lat, 95) == pytest.approx(0.067, rel=1e-6)
    assert percentile(lat, 50) == pytest.approx(0.060)
