"""The window's arithmetic: the rate and the tail over every image."""

import pytest

from benchmark.harness.window import Window
from benchmark.harness.spec import reader


def window(intervals, t_open=100.0):
    ends, t = [], t_open
    for dt in intervals:
        t += dt
        ends.append(t)
    return Window(t_open, ends, setup_s=3.5)


def test_rate_is_window_time_over_frames():
    w = window([0.010] * 99 + [0.020])
    assert w.frames == 100
    assert w.mean_ms() == pytest.approx(1e3 * 1.01 / 100)
    assert reader("end_to_end", "frame_ms").read(w) == w.mean_ms()
    assert reader("end_to_end", "setup_s").read(w) == 3.5


def test_p95_is_over_every_interval():
    w = window([0.001 * (i + 1) for i in range(100)])
    # nearest rank: the 95th of 100 sorted intervals
    assert w.quantile_ms(0.95) == pytest.approx(95.0)
    assert reader("end_to_end", "frame_p95_ms").read(w) == \
        pytest.approx(95.0)


@pytest.mark.parametrize("where", [0, 50, 99])
def test_a_planted_stall_moves_rate_and_tail(where):
    base = [0.010] * 100
    stalled = list(base)
    # six stalled frames: more than 5% of 100, so the tail is a stall
    start = min(where, 94)
    for i in range(start, start + 6):
        stalled[i] = 0.050
    a, b = window(base), window(stalled)
    assert b.mean_ms() > a.mean_ms() * 1.1
    assert b.quantile_ms(0.95) == pytest.approx(50.0)
    assert a.quantile_ms(0.95) == pytest.approx(10.0)


def test_images_of_k_frames_give_times_a_frame():
    """An image that folds 4 frames: the rate over the frames rendered,
    the tail over image intervals, each over its 4 frames."""
    w = window([0.040] * 95 + [0.080] * 5)
    w.k = 4
    assert (w.images, w.frames) == (100, 400)
    assert w.mean_ms() == pytest.approx(1e3 * 4.2 / 400)
    assert w.quantile_ms(0.95) == pytest.approx(10.0)
    assert w.quantile_ms(0.96) == pytest.approx(20.0)
