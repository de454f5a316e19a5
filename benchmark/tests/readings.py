"""Read a cell's compared numbers over many seeds in one process: the
program's runs, and the controls'. Each program run also gives the
``fp8_reference`` control's readings on the same request: the reference
put in the program's place, computed with float8 e4m3 operands (every
product of its text encoders and UNet; fp32 accumulation and latents)
from the same latents. ``--control bf16_decode`` runs the program with
its own bf16 decode switched on.

    python -m benchmark.tests.readings --workload <cell> --seeds 1,2,3 \
        [--control bf16_decode --control-seeds 4,5,6] \
        [--out readings.jsonl]

Each run is the cell's own run at its own size with a window of one
request (``--seconds 0``); one JSON line per run goes to ``--out`` and to
standard output. The limits in ``workloads/<cell>.json`` are set from
these readings: above the program's largest, below the controls' least.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import run
from benchmark.reference import models


def readings(workload: str, seeds, control=None, out=None,
             device=None, root=run.ROOT) -> list:
    device = device or torch.device("cuda", 0)
    lines = []
    for seed in seeds:
        t0 = time.perf_counter()
        fp8 = {}

        def observe(ctx, entry, req, output):
            if control is None:
                fp8.update(entry.check(ctx, req, output, cast=models.fp8))

        line = run.run_cell(workload, seed, 0.0, False, device=device,
                            root=root, control=control, observe=observe,
                            t_start=t0)
        rec = {"workload": workload, "seed": seed, "control": control,
               "seconds": time.perf_counter() - t0,
               "correct": line["correct"],
               "checks": {k: c["value"] for k, c in line["checks"].items()},
               "metrics": {k: m["value"] for k, m in line["metrics"].items()}}
        if fp8:
            limits = {k: c["limit"] for k, c in line["checks"].items()}
            rec["fp8_reference"] = fp8
            rec["fp8_reference_correct"] = all(
                v <= limits[k] for k, v in fp8.items())
        print(json.dumps(rec), flush=True)
        if out is not None:
            out.write(json.dumps(rec) + "\n")
            out.flush()
        lines.append(rec)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="bf16_decode")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    parse = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    out = open(a.out, "a") if a.out else None
    try:
        readings(a.workload, parse(a.seeds), None, out)
        readings(a.workload, parse(a.control_seeds), a.control, out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
