"""Percentiles and rates, and that a stall in the window shows in them."""

import math

from ragbench import stats


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert stats.percentile(v, 50) == 50
    assert stats.percentile(v, 95) == 95
    assert stats.percentile([3.0], 95) == 3.0


def test_unanswered_request_is_infinitely_late():
    due = [0.0, 0.1, 0.2]
    done = [0.01, None, 0.21]
    lat = stats.latencies_ms(due, done)
    assert math.isinf(lat[1])
    assert math.isinf(stats.percentile(lat, 95))


def _open_loop(stall_at=None, stall=0.0, n=1000, service=0.002):
    """A server that takes `service` a request, one at a time; a stall
    holds it for `stall` seconds at time `stall_at`."""
    due = [i * 0.01 for i in range(n)]
    done, free = [], 0.0
    for t in due:
        start = max(t, free)
        if stall_at is not None and start >= stall_at and stall > 0:
            start += stall
            stall = 0.0
        free = start + service
        done.append(free)
    return due, done


def test_stall_moves_p95_and_rate():
    due, done = _open_loop()
    due_s, done_s = _open_loop(stall_at=5.0, stall=0.5)
    p95 = stats.percentile(stats.latencies_ms(due, done), 95)
    p95_s = stats.percentile(stats.latencies_ms(due_s, done_s), 95)
    assert p95 == 2.0 or abs(p95 - 2.0) < 1e-6
    assert p95_s > 50 * p95
    # a window that closes while the backlog drains completes fewer
    r = stats.completed_rate(done, 0.0, 5.3)
    r_s = stats.completed_rate(done_s, 0.0, 5.3)
    assert r_s < r


def test_stall_moves_ingest_rate():
    # chunks over the whole window: a stalled round lengthens the window
    rounds = [1.0] * 10
    chunks = 400 * len(rounds)
    assert chunks / sum(rounds) > chunks / (sum(rounds) + 2.0)


def test_spread_is_iqr_over_median():
    assert stats.spread([10, 10, 10, 10]) == 0.0
    assert 0.0 < stats.spread([9, 10, 10, 11, 12]) < 0.3
