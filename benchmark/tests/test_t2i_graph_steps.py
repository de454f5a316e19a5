"""``t2i_graph_steps.latency`` on fabricated records: the share of the
window's text-to-image denoise steps whose forward counted a graph
replay."""

import collections

import pytest

from benchmark import run
from benchmark.tests.test_program_metrics import rec_of
from omg_tpu_torch.utils import profiling

NAME = "t2i_graph_steps.latency"
STEPS = 4


@pytest.fixture(autouse=True)
def fresh_records(monkeypatch):
    monkeypatch.setattr(profiling, "REQUESTS", collections.deque(maxlen=64))


def record(replayed=(), captured=(), root="sdxl.text_to_image",
           steps=STEPS):
    """A request whose denoise has ``steps`` steps, a UNet span in each;
    the steps in ``replayed`` count a replay, those in ``captured`` a
    capture."""
    with profiling.request(root):
        with profiling.span("encode"):
            pass
        with profiling.span("denoise"):
            for i in profiling.steps(0, steps):
                with profiling.span("unet"):
                    if i in captured:
                        profiling.count("graph.captures")
                    if i in replayed:
                        profiling.count("graph.replays")
        with profiling.span("decode"):
            pass


def read(n_done: int):
    return run.load_metric(NAME).read(rec_of(n_done, STEPS))


def test_a_loop_without_graphs_reads_nothing():
    record(steps=1)                                     # the warm-up
    for _ in range(4):
        record()
    assert read(3) is None


def test_every_request_captures_once_and_replays_the_rest():
    """One capture a request: its first step eager, the rest replayed."""
    record(steps=1)                                     # the warm-up
    for _ in range(4):
        record(replayed=range(1, STEPS), captured=[1])
    assert read(3) == 75.0


def test_the_share_of_replayed_steps():
    record(replayed=range(1, STEPS), captured=[1])
    record(replayed=range(STEPS))
    record(replayed=[2, 3], captured=[2])
    record()
    assert read(2) == 75.0


def test_graphs_that_replayed_nothing_in_the_window_read_zero():
    record(replayed=range(1, STEPS), captured=[1])
    record()
    record()
    record()
    assert read(2) == 0.0


def test_other_roots_and_short_windows_read_nothing():
    record(replayed=range(STEPS), root="omg.generate")
    record(replayed=range(STEPS), root="omg.generate")
    assert read(1) is None
    record(replayed=range(STEPS))
    assert read(1) is None          # no traced record after the window
