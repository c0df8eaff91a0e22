"""The window's arithmetic: a rate is all the work over all the time, the
tail is taken over every frame, the downlink over headset time."""

import pytest

from nebula_bench import harness as H


def test_rate_is_all_the_work_over_all_the_time():
    # 3 frames in 0.3 s is 100 ms a frame, whatever each frame took
    assert H.per_item_ms(0.3, 3) == pytest.approx(100.0)
    with pytest.raises(ValueError):
        H.per_item_ms(1.0, 0)


def test_p95_is_over_every_value():
    values = list(range(1, 101))            # 1 .. 100
    assert H.p95(values) == 95
    assert H.p95([5.0] * 19 + [90.0]) == 5.0     # one frame in 20 is beyond the 95th
    assert H.p95([5.0] * 18 + [90.0, 91.0]) == 90.0
    assert H.p95([7.0]) == 7.0


def test_downlink_is_over_headset_time():
    # 90 frames at 90 FPS is one second: 125,000 bytes is 1 Mbit/s
    assert H.mbps(125_000, 90, 90.0) == pytest.approx(1.0)
