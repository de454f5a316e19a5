"""A cell, a configuration and a per-layer metric added as files only are
found by name and run, with no file of the harness edited."""

import contextlib
import json
import pathlib

import torch

from benchmark import run, trace, window
from benchmark.tests import tiny

FAKE_TRACE = {"window_s": 2.0, "busy_s": 1.5, "kernels": {"k": 1.5},
              "k1_s": 0.0, "k1_calls": 0, "gaps": {"bench.request": 0.5}}


def fake_trace(monkeypatch):
    """No card here: the profiler and its reduction stand in, and the
    window's clock advances a quarter second a reading, so that a window
    of one second holds a fixed number of requests."""
    ticks = iter(range(10 ** 6))
    run_window = window.run_window
    monkeypatch.setattr(window, "run_window", lambda reqs, one, seconds: run_window(
        reqs, one, seconds, clock=lambda: next(ticks) / 4))
    monkeypatch.setattr(trace, "profile", contextlib.nullcontext)
    monkeypatch.setattr(trace, "device_events", lambda prof: [])
    monkeypatch.setattr(trace, "reduce", lambda dev, spans: dict(FAKE_TRACE))

DUMMY_METRIC = '''"""The cell's chips, as the record holds them."""

NAME = "dummy_requests.tiny"
UNIT = "requests"
LAYER = "harness"
MOVES = "image_s"


def read(rec):
    return float(rec.cell["chips"])
'''


def add_dummy(tmp: pathlib.Path) -> pathlib.Path:
    root = tiny.tree(tmp)
    (root / "metrics" / "dummy_requests.tiny.py").write_text(DUMMY_METRIC)
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "dummy_requests.tiny", "unit": "requests", "better": "higher",
        "source": "program_counter", "layer": "harness", "moves": "image_s",
        "workloads": ["tiny_omg"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_a_cell_and_a_metric_added_as_files_run(tmp_path, monkeypatch):
    root = add_dummy(tmp_path)
    fake_trace(monkeypatch)
    line = run.run_cell("tiny_omg", 7, 1.0, True, device=torch.device("cpu"),
                        root=root)
    assert line["correct"] is True
    assert line["metrics"]["dummy_requests.tiny"] == {"value": 1.0,
                                                      "unit": "requests"}
    # the cell also reports the shipped metrics BENCHMARK.json gives it
    for name in ("stage1_s.latency", "stage2_s.latency", "decode_s.latency",
                 "gen_mfu.latency", "device_idle.latency"):
        assert name in line["metrics"], name
    assert line["metrics"]["device_idle.latency"]["value"] == 25.0
    # a metric the trace holds nothing for is left out, not written as 0
    assert "k1_roofline.latency" not in line["metrics"]


def test_every_listed_file_is_found():
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        mod = run.load_metric(m["name"])
        assert (mod.NAME, mod.UNIT, mod.LAYER, mod.MOVES) == (
            m["name"], m["unit"], m["layer"], m["moves"])
    for w in bench["workloads"]:
        cell, cfg, mix, entry = run.load_cell(w["name"])
        assert cell["config"] == w["config"] == cfg["name"]
        assert cell["chips"] == w["chips"]
        assert set(cell["limits"]) and mix["requests"] > 0
        for f in ("setup", "run", "images", "flops", "free", "check",
                  "unet_lanes"):
            assert callable(getattr(entry, f)), f
    for c in bench["configs"]:
        assert json.loads((tiny.REPO / c["file"]).read_text())["name"] == \
            c["name"]
