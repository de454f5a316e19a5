"""The result line: its keys, and no line without a card."""

import json

import pytest
import torch

from benchmark import run, trace
from benchmark.tests import tiny
from benchmark.tests.test_discovery import fake_trace


def test_untraced_line(tmp_path):
    root = tiny.tree(tmp_path)
    line = run.run_cell("tiny_t2i", 11, 0.0, False,
                        device=torch.device("cpu"), root=root)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"images_per_min", "peak_mem_gib",
                                    "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["attempted"] == 1 and line["failed"] == 0
    assert list(line["checks"]) == ["eps_gap", "step_gap",
                                    "decode_gap_levels"]
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.dumps(line)


def test_traced_line(tmp_path, monkeypatch):
    root = tiny.tree(tmp_path)
    fake_trace(monkeypatch)
    line = run.run_cell("tiny_t2i", 11, 1.0, True,
                        device=torch.device("cpu"), root=root)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["device"]["busy_s"] == 1.5
    assert line["device"]["window_s"] == 2.0
    assert line["breakdown"] == {"device_ops": [["k", 1.5]],
                                 "idle_gaps": [["bench.request", 0.5]]}
    # the UNet's device ms come from CUDA events: none on the CPU
    assert set(line["metrics"]) == {"gen_mfu.batch", "device_idle.batch"}
    assert line["attempted"] >= 2


def test_no_line_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "omg2_latency_1024", "--seed",
                     "3000000019", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_a_short_trace_reduces():
    """``trace.reduce`` on hand-made events: busy time is the union of the
    device intervals inside the request, each idle gap goes to the named
    forward the host was in at its middle."""
    t = 10 ** 9                                   # 1 s after the epoch, ns
    spans = [(t + 0, t + 100, trace.REQUEST),
             (t + 10, t + 40, "bench.unet"),
             (t + 60, t + 70, "bench.vae_decoder")]
    dev = [(t + 12, t + 20, "flash_fwd_kernel<64>"),
           (t + 18, t + 30, "gemm"),
           (t + 50, t + 90, "gemm")]
    red = trace.reduce(dev, spans)
    assert red["window_s"] == 100e-9
    assert red["busy_s"] == pytest.approx(58e-9)
    assert red["k1_calls"] == 1 and red["k1_s"] == 8e-9
    assert red["kernels"]["gemm"] == 52e-9
    # gaps [0, 12] (middle 6: no forward), [30, 50] (middle 40: the
    # UNet's last instant), [90, 100] (middle 95: none)
    assert red["gaps"]["bench.request"] == pytest.approx(22e-9)
    assert red["gaps"]["bench.unet"] == pytest.approx(20e-9)
    assert trace.breakdown(red)["device_ops"][0] == ["gemm", 52e-9]


def test_a_trace_on_another_clock_is_refused():
    t = 10 ** 12
    with pytest.raises(RuntimeError, match="clock"):
        trace.reduce([(t * 50, t * 50 + 5, "k")], [(t, t + 100, trace.REQUEST)])
