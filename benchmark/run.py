"""Run one cell once and print one JSON line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is ``workloads/<cell>.json``: its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``, read
by ``generator.py``), its entry (``entries/<entry>.py``: how it drives the
program) and the limits of its compared numbers. Which metrics the cell
reports is ``BENCHMARK.json``'s; each per-layer metric is
``metrics/<name>.py``. A later cell, mix, configuration or metric is a
new file, and no file here changes.

A run: weights and inputs from ``--seed``, set-up (the program built
through its loading path, every shape of the cell warmed once), with
the window (``window.py``), the peak memory read, with ``--trace 1`` one
more request under the profiler, the program freed, then the plain
reference on a sample of the window's requests drawn from the seed. The
compared numbers go to the last lines of standard error, each beside its
limit, and into the result's last key, ``checks``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
from typing import Callable, NamedTuple, Optional  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent
CACHE = ROOT.parent / "build" / "benchmark_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "omg_tpu")


def _fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"


_fixed_caches()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import flops, generator, trace, window  # noqa: E402


class Ctx(NamedTuple):
    cfg: dict
    cell: dict
    mix: dict
    seed: int
    device: torch.device
    control: Optional[str]      # None or "bf16_decode"
    spans: trace.Spans
    requests: list


class Record(NamedTuple):
    """What a per-layer metric reads: the host-clock readings come from
    the window, the device readings from the one request traced after
    it."""
    cfg: dict
    cell: dict
    done: list                  # window.Done of the window's requests
    seconds: float              # the window
    flops: list                 # model FLOPs of each request
    trace: Optional[dict]       # trace.reduce of the traced request
    k1_calls: list              # (B, H, N, D) of each K1 call of it


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: pathlib.Path = ROOT) -> tuple:
    """(cell, config, mix, entry module) of a workload's name."""
    cell = json.loads((root / "workloads" / f"{name}.json").read_text())
    cfg = json.loads((root / "configs" / f"{cell['config']}.json").read_text())
    mix = generator.load_mix(cell["traffic"], root)
    entry = _load(root / "entries" / f"{cell['entry']}.py",
                  f"benchmark.entries.{cell['entry']}")
    return cell, cfg, mix, entry


def load_metric(name: str, root: pathlib.Path = ROOT):
    return _load(root / "metrics" / f"{name}.py", f"benchmark_metric_{name}")


def cell_metrics(bench: dict, cell: str) -> tuple:
    """(end-to-end names, per-layer names) ``BENCHMARK.json`` gives the
    cell."""
    def mine(m):
        return "workloads" not in m or cell in m["workloads"]
    return ([m["name"] for m in bench["end_to_end"] if mine(m)],
            [m["name"] for m in bench["per_layer"] if mine(m)])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def set_flags(prec: dict) -> None:
    torch.backends.cudnn.allow_tf32 = prec["cudnn_allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = prec["matmul_allow_tf32"]
    torch.backends.cudnn.benchmark = prec["cudnn_benchmark"]


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *,
             device: torch.device, root: pathlib.Path = ROOT,
             control: Optional[str] = None,
             observe: Optional[Callable] = None,
             t_start: float = T_START) -> dict:
    """One run of a cell -> the result line as a dict (``checks`` last).
    ``control`` ("bf16_decode") switches on the program's bf16 decode
    (the readings of ``tests/readings.py``); ``observe(ctx, entry, request, output)`` sees
    each checked request after its check."""
    bench = json.loads((root.parent / "BENCHMARK.json").read_text())
    e2e_names, layer_names = cell_metrics(bench, workload)
    cell, cfg, mix, entry = load_cell(workload, root)
    set_flags(cfg["precision"])
    spans = trace.Spans()
    ctx = Ctx(cfg, cell, mix, seed, device, control, spans,
              generator.requests(mix, seed))
    with torch.inference_mode():
        state = entry.setup(ctx)
        _sync(device)
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s")
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

        def run_one(req):
            out = entry.run(ctx, state, req)
            _sync(device)
            return out

        win = window.run_window(ctx.requests, run_one, seconds)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        log(f"window {win.seconds:.3f} s, {len(win.done)} requests")
        red = None
        if traced:
            # one more request under the profiler, after the window and
            # apart from it: the profiler slows the host, and its start
            # and stop take seconds
            prof = trace.profile()
            with prof:
                with spans.request():
                    entry.run(ctx, state, ctx.requests[len(win.done)])
                    _sync(device)
            t0 = time.perf_counter()
            red = trace.reduce(trace.device_events(prof), spans.spans)
            del prof
            if red is None:
                raise RuntimeError("the traced request ran nothing on the "
                                   "device")
            red["unet_forward_ms"] = spans.unet_ms()
            log(f"traced request {red['window_s']:.3f} s, reduced in "
                f"{time.perf_counter() - t0:.1f} s")
        spans.close()
        entry.free(state)
        del state
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        rng = np.random.default_rng(seed)
        picks = sorted(rng.choice(len(win.done), size=min(
            cell.get("sample", 1), len(win.done)), replace=False))
        readings: dict = {}
        t0 = time.perf_counter()
        for i in picks:
            d = win.done[i]
            for k, v in entry.check(ctx, d.request, d.output).items():
                readings[k] = max(readings.get(k, -math.inf), v)
            if observe is not None:
                observe(ctx, entry, d.request, d.output)
        log(f"checked {len(picks)} request(s) in "
            f"{time.perf_counter() - t0:.1f} s")
    checks = {k: {"value": v, "limit": cell["limits"][k]}
              for k, v in readings.items()}
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    n_images = sum(entry.images(d.request) for d in win.done)
    host = {"setup_s": (setup_s, "s"),
            "image_s": (win.seconds / n_images, "s"),
            "images_per_min": (60.0 * n_images / win.seconds, "images/min"),
            "peak_mem_gib": (peak / 2 ** 30, "GiB")}
    metrics = {}
    if not traced:
        for name in e2e_names:
            value, unit = host[name]
            metrics[name] = {"value": value, "unit": unit}
    else:
        lanes = spans.lanes or entry.unet_lanes(cfg)
        p = cfg["pipeline"]
        k1 = [c for b in lanes for c in flops.k1_calls(
            cfg["unet"], b, p["height"] // 8, p["width"] // 8)]
        rec = Record(cfg, cell, win.done, win.seconds,
                     [entry.flops(cfg, d.request) for d in win.done], red, k1)
        for name in layer_names:
            m = load_metric(name, root)
            value = m.read(rec)
            if value is not None:
                metrics[name] = {"value": value, "unit": m.UNIT}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": len(win.done), "failed": 0,
            "metrics": metrics, "device": dev}
    if red is not None:
        dev.update(busy_s=red["busy_s"], window_s=red["window_s"])
        line["breakdown"] = trace.breakdown(red)
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    line["checks"] = checks
    return line


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = json.loads((ROOT / "workloads" / f"{args.workload}.json")
                      .read_text())
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                    device=torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process: {bad}")
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
