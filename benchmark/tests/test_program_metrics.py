"""The per-layer metrics that read the program's own records
(``program_trace.py``): which records make the window, and each metric
on a tiny cell and on records with device times."""

import types

import pytest
import torch

from benchmark import program_trace, run
from benchmark.tests import tiny
from benchmark.tests.test_discovery import fake_trace
from omg_tpu_torch.utils import profiling

OMG = ("s1_syncs_per_step.latency", "s2_syncs_per_step.latency",
       "s1_host_wait_ms.latency", "s2_host_wait_ms.latency",
       "s2_unet_ms.latency", "s2_lora_live_lanes.latency")
T2I = ("decode_s.batch", "host_wait_ms.batch")


def record(root: str, steps: int, syncs: int = 1) -> profiling.Request:
    """A request whose stage 1 has ``steps`` steps of ``syncs`` counted
    syncs each."""
    with profiling.request(root):
        with profiling.span("stage1"):
            for _ in profiling.steps(0, steps):
                profiling.count("sync", syncs)
    return profiling.REQUESTS[-1]


def rec_of(n_done: int, steps: int):
    return types.SimpleNamespace(done=[None] * n_done,
                                 cfg={"pipeline": {"num_steps": steps}})


def test_the_window_leaves_out_the_warm_up_and_the_traced_request():
    warm = record("w.root", 2, syncs=9)
    window = [record("w.root", 4, syncs=s) for s in (1, 2, 3)]
    record("other.root", 4)
    traced = record("w.root", 4, syncs=7)
    got = program_trace.window(rec_of(3, 4), "w.root")
    assert [r.rid for r in got] == [r.rid for r in window]
    assert warm.rid not in [r.rid for r in got]
    assert traced.rid not in [r.rid for r in got]
    assert program_trace.per_step(rec_of(3, 4), "w.root", "stage1",
                                  program_trace.syncs) == 2.0
    # the warm-up's shorter stage in the window: nothing to read
    assert program_trace.window(rec_of(4, 4), "w.root") is None
    # fewer records than requests
    assert program_trace.window(rec_of(40, 4), "w.root") is None


def test_a_program_without_records_reads_nothing(monkeypatch):
    record("w.root", 4)
    record("w.root", 4)
    monkeypatch.delattr(profiling, "REQUESTS")
    assert program_trace.window(rec_of(1, 4), "w.root") is None
    for name in OMG + T2I:
        assert run.load_metric(name).read(rec_of(1, 4)) is None


def test_device_times_are_read_from_the_resolved_spans():
    """Where the spans carry device times (a card's CUDA events), the
    metrics read them: the stage-2 UNet's ms, the decode's seconds, and
    the denoise steps' host wait."""
    reqs = []
    for _ in range(3):
        with profiling.request("omg.generate"):
            with profiling.span("stage1"):
                for _ in profiling.steps(0, 2):
                    pass
            with profiling.span("stage2"):
                for _ in profiling.steps(1, 2):
                    with profiling.span("unet") as u:
                        u.device_ns = 250_000_000
        reqs.append(profiling.REQUESTS[-1])
    assert run.load_metric("s2_unet_ms.latency").read(rec_of(2, 2)) == 250.0
    for _ in range(3):
        with profiling.request("sdxl.text_to_image"):
            with profiling.span("denoise"):
                for _ in profiling.steps(0, 2):
                    profiling.sync(int, 1)
            with profiling.span("decode") as d:
                d.device_ns = 500_000_000
        r = profiling.REQUESTS[-1]
        for s in r.spans:
            if s.name == "step":
                s.device_ns = 1
                s.counters["sync_wait_ns"] = 3_000_000
    rec = rec_of(2, 2)
    assert run.load_metric("decode_s.batch").read(rec) == 0.5
    assert run.load_metric("host_wait_ms.batch").read(rec) == 3.0


@pytest.fixture(scope="module")
def lines(tmp_path_factory):
    root = tiny.tree(tmp_path_factory.mktemp("bench"))
    mp = pytest.MonkeyPatch()
    fake_trace(mp)
    try:
        return {cell: run.run_cell(cell, 13, 1.0, True,
                                   device=torch.device("cpu"), root=root)
                for cell in ("tiny_omg", "tiny_t2i")}
    finally:
        mp.undo()


def test_the_omg_metrics_on_a_tiny_cell(lines):
    m = {k: v["value"] for k, v in lines["tiny_omg"]["metrics"].items()}
    # stage 1: the sigma, the timestep, the guidance scale; stage 2: two
    # sigmas, the timestep, 2 x 4 P2P rows, the guidance scale
    assert m["s1_syncs_per_step.latency"] == 3.0
    assert m["s2_syncs_per_step.latency"] == 12.0
    assert m["s1_host_wait_ms.latency"] > 0
    assert m["s2_host_wait_ms.latency"] > 0
    assert m["s2_lora_live_lanes.latency"] == pytest.approx(400.0 / 7)
    # device ms come from CUDA events: none on the CPU
    assert "s2_unet_ms.latency" not in m
    assert lines["tiny_omg"]["metrics"]["s1_syncs_per_step.latency"][
        "unit"] == "syncs"


def test_the_t2i_metrics_need_a_card(lines):
    assert not set(T2I) & set(lines["tiny_t2i"]["metrics"])
