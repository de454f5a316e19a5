"""Faults planted in the program under a cell's run: each a patch of the
port that a real defect could make, applied for the run and undone after.

    python -m benchmark.tests.planted --workload <cell> --fault <name> \
        --seeds 1,2 [--out planted.jsonl]

One JSON line per run: the fault, the seed, ``correct`` and the compared
numbers with their limits. A sound comparison reads at least one number
above its limit under each fault.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from benchmark import run
from omg_tpu_torch.pipelines import multiconcept


def identitynet_dropped():
    """Stage 2's concept lanes run without the IdentityNet's residuals."""
    return {"_concept_cn_residuals": lambda *a, **k: (None, None)}


def ip_branch_dropped():
    """The concept lanes' IP tokens never reach the UNet."""
    lanes = multiconcept._concept_lane_conditioning

    def no_ip(*a, **k):
        return lanes(*a, **k)[:4] + (None,)
    return {"_concept_lane_conditioning": no_ip}


def loras_swapped(place: int, other: int):
    """Two requests of a batch trade LoRAs between their conditioning and
    stage 2."""
    batch = multiconcept.sample_stage2_batch

    def swapped(cfg, sched, unet, caches, bases, controller, concepts,
                loras, *a, **k):
        loras = list(loras)
        loras[place], loras[other] = loras[other], loras[place]
        return batch(cfg, sched, unet, caches, bases, controller, concepts,
                     loras, *a, **k)
    return {"sample_stage2_batch": swapped}


FAULTS = {"identitynet_dropped": identitynet_dropped,
          "ip_branch_dropped": ip_branch_dropped}


@contextlib.contextmanager
def planted(patches: dict):
    """``multiconcept``'s functions replaced by ``patches`` for the block."""
    saved = {k: getattr(multiconcept, k) for k in patches}
    for k, v in patches.items():
        setattr(multiconcept, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(multiconcept, k, v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    out = open(a.out, "a") if a.out else None
    try:
        for seed in (int(s) for s in a.seeds.split(",") if s):
            t0 = time.perf_counter()
            with planted(FAULTS[a.fault]()):
                line = run.run_cell(a.workload, seed, 0.0, False,
                                    device=torch.device("cuda", 0),
                                    t_start=t0)
            rec = {"workload": a.workload, "fault": a.fault, "seed": seed,
                   "correct": line["correct"], "checks": line["checks"]}
            print(json.dumps(rec), flush=True)
            if out is not None:
                out.write(json.dumps(rec) + "\n")
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
