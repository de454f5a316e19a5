"""The window rule on a fake clock."""

import pytest

from benchmark import window


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def run(durations, seconds, n=50):
    clock = FakeClock()
    reqs = [{"index": i} for i in range(n)]

    def run_one(req):
        clock.t += durations[req["index"] % len(durations)]
        return req["index"]

    return window.run_window(reqs, run_one, seconds, clock=clock)


def test_a_request_begun_inside_the_window_runs_to_its_end():
    w = run([14.0], 45.0)
    # starts at 0, 14, 28, 42 (< 45): four requests, the last ends at 56
    assert [d.output for d in w.done] == [0, 1, 2, 3]
    assert w.seconds == pytest.approx(56.0)
    assert [d.start for d in w.done] == pytest.approx([0, 14, 28, 42])


def test_a_request_due_at_the_limit_does_not_start():
    w = run([15.0], 45.0)
    assert len(w.done) == 3 and w.seconds == pytest.approx(45.0)


def test_the_first_request_always_runs():
    w = run([3.0], 0.0)
    assert len(w.done) == 1 and w.seconds == pytest.approx(3.0)


def test_uneven_requests_count_whole():
    # starts at 0, 1 and 11; the fourth would start at 12, the limit
    w = run([1.0, 10.0], 12.0)
    assert [d.end for d in w.done] == pytest.approx([1, 11, 12])


def test_a_mix_that_runs_out_raises():
    with pytest.raises(RuntimeError, match="ran out"):
        run([1.0], 100.0, n=5)
