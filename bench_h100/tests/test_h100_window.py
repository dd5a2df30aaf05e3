"""The window's arithmetic: the 95th percentile over every step and
frames/s over the whole window."""

import statistics

import pytest

from bench_h100.harness import window


def test_percentile_is_over_every_step():
    steps = [float(i) for i in range(1, 101)]
    # Linear between order statistics: the 95th of 1..100 is 95.05.
    assert window.percentile(steps, 95) == pytest.approx(95.05)
    assert window.percentile([7.0], 95) == 7.0
    # One slow step in twenty moves the 95th percentile; a median of
    # pieces would not see it.
    slow = [0.010] * 90 + [0.050] * 10
    assert window.step_ms_p95(window.Window(0.0, 1.0, slow)) == \
        pytest.approx(50.0)
    assert statistics.median(slow) == 0.010


def test_frames_per_second_counts_all_steps_over_the_whole_window():
    # 40 steps of a batch of 4 in 2.5 s, the time between steps included.
    w = window.Window(start=10.0, end=12.5, step_seconds=[0.05] * 40)
    assert window.frames_per_second(w, batch=4) == pytest.approx(64.0)


def test_run_ends_after_the_step_that_crosses_the_window():
    calls, kept = [], []
    w = window.run(lambda k: calls.append(k), 0.0,
                   after_step=lambda: kept.append(len(calls)))
    assert calls == [0] and kept == [1]
    assert len(w.step_seconds) == 1 and w.end >= w.start


def test_process_age_is_not_negative():
    assert window.process_age() >= 0.0
