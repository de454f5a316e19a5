"""Mixed-load serving soak: concurrent classes through the port's
``OMGServer`` (port of ``tools/soak_bench.py``).

Concurrent HTTP requests mixing serving classes against one server: two
exact Euler jobs, one DeepCache interval-3 "front" job and one gate miss
(a prompt without the class words: stage 1 only). First each job alone
(its serial baseline, which also loads every program), then one POST of
the two Euler prompts (the batch the drain forms), then ``reps``
concurrent storms of the four.

Asserts, as the JAX tool does: each response's stage-2 status, distinct
images across the jobs of a storm, ``stage2_skipped`` risen by 1 + reps
(one gate miss per pass), and ``/healthz`` with an empty queue at the
end. On top of it, each storm image is held against its own serial
baseline: the record keeps the largest and the mean uint8 difference per
class, and the same for the two Euler images of the POSTed pair, which
always runs as one batch (``pair_vs_serial``). Both are batching drift
where a request was batched, zero where it ran alone; a seed, mask or
face mix-up shows as the difference between two jobs' images, recorded
beside them as ``mixup_mean_diff``. The record also keeps the per-class
p50/p95 client latency.

    python -m omg_tpu_torch.tools.soak_bench [--device cpu] [--out PATH]

Env: OMG_SOAK_SIZE=sdxl|tiny (sdxl: 1024x1024, 50 steps; tiny: 32x32, 2
steps), OMG_SOAK_REPS (1), OMG_SOAK_STEPS (the size's).
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import time

import numpy as np

from omg_tpu_torch.serving.registry import Registry
from omg_tpu_torch.serving.server import OMGServer
from omg_tpu_torch.tools.serve_bench import (GATE_PROMPT, MISS_PROMPT,
                                             REWRITE, Client, card,
                                             concurrent, decode, engine_for,
                                             k1_launches, parse_args,
                                             strip_provider)


def mix(side: int) -> list:
    """(class, job, stage 2 expected) of one storm."""
    common = {"prompt_rewrite": REWRITE, "height": side, "width": side}
    return [
        ("euler", dict(common, prompt=GATE_PROMPT + " 1", seed=101), True),
        ("euler", dict(common, prompt=GATE_PROMPT + " 2", seed=102), True),
        ("dc3front", dict(common, prompt=GATE_PROMPT + " 3", seed=103,
                          cache_interval=3, cache_schedule="front"), True),
        ("gate_miss", dict(common, prompt=MISS_PROMPT, seed=104), False),
    ]


def _status(cls: str, out: dict, stage2: bool) -> None:
    if out.get("stage2_ran") is not stage2:
        raise AssertionError(f"{cls}: stage2_ran {out.get('stage2_ran')}, "
                             f"want {stage2} (masks {out.get('masks_found')})")


def _diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.astype(np.int32) - b.astype(np.int32))


def main(argv=None, *, weights=None) -> dict:
    """Run the soak; returns the record. ``weights``: (cfg, params)
    already on a device (the models are then not built)."""
    args = parse_args(argv, "omg_tpu_torch.tools.soak_bench", __doc__)
    env = os.environ.get
    reps = int(env("OMG_SOAK_REPS", "1"))
    engine, side = engine_for("soak_bench", env("OMG_SOAK_SIZE", "sdxl"),
                              int(env("OMG_SOAK_STEPS", "0")), args.device,
                              weights, strip_provider({"n": 0}))
    client = Client(OMGServer(engine, Registry(), max_batch=2))
    try:
        record = _soak(client, side, reps)
    finally:
        client.close()
    record.update(geometry=f"{side}x{side}", steps=engine.num_steps,
                  **card(engine.device))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    print(json.dumps({k: v for k, v in record.items()
                      if k not in ("metrics", "what")}), flush=True)
    return record


def _soak(client: Client, side: int, reps: int) -> dict:
    before = client.counters()
    k1: dict = {}
    jobs = mix(side)

    # serial baselines; they load every program the storms run
    t0 = time.perf_counter()
    baselines = []
    with k1_launches(k1.setdefault("serial", {})):
        for cls, job, s2 in jobs:
            out = client.post(dict(job))
            _status(cls, out, s2)
            baselines.append(decode(out["image"]))
    # the batch of the two Euler jobs that the drain forms
    pair = {k: v for k, v in jobs[0][1].items() if k != "prompt"}
    pair["prompts"] = [jobs[0][1]["prompt"], jobs[1][1]["prompt"]]
    pair_diff = {"max": 0, "mean": 0.0}
    for out, base in zip(client.post(pair)["results"], baselines):
        _status("euler pair", out, True)
        d = _diff(decode(out["image"]), base)
        pair_diff["max"] = max(pair_diff["max"], int(d.max()))
        pair_diff["mean"] = max(pair_diff["mean"], float(d.mean()))
    warm_s = time.perf_counter() - t0
    print(f"serial baselines and warm-up: {warm_s:.3f} s", flush=True)

    latencies: dict = {}
    diffs: dict = {}
    storms = []
    for rep in range(reps):
        def one(i):
            t = time.perf_counter()
            out = client.post(dict(jobs[i][1]))
            return out, time.perf_counter() - t

        t0 = time.perf_counter()
        with k1_launches(k1.setdefault(f"storm{rep}", {})):
            results = concurrent(one, len(jobs))
        storms.append(time.perf_counter() - t0)
        digests = []
        for (cls, _, s2), (out, lat), base in zip(jobs, results, baselines):
            _status(cls, out, s2)
            latencies.setdefault(cls, []).append(lat)
            digests.append(hashlib.sha256(out["image"].encode()).hexdigest())
            d = _diff(decode(out["image"]), base)
            rec = diffs.setdefault(cls, {"max": 0, "mean": 0.0})
            rec["max"] = max(rec["max"], int(d.max()))
            rec["mean"] = max(rec["mean"], float(d.mean()))
        if len(set(digests)) != len(digests):
            raise AssertionError(f"storm {rep}: identical images across jobs")
        print(f"storm {rep}: {storms[-1]:.3f} s wall", flush=True)

    after = client.counters()
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    # one gate miss per pass: the baseline and each storm
    if delta.get("stage2_skipped", 0) != 1 + reps:
        raise AssertionError(f"stage2_skipped rose by "
                             f"{delta.get('stage2_skipped', 0)}, want "
                             f"{1 + reps}")
    health = client.get("/healthz")
    if not health["ok"] or health["queued"] != 0:
        raise AssertionError(f"/healthz after the storms: {health}")
    return {
        "what": "mixed-class concurrent serving soak through the port's "
                "OMGServer over HTTP (Euler x2, DeepCache-3 front, gate "
                "miss; stage-2 status, distinct images and each storm "
                "image against its serial baseline)",
        "reps": reps, "warmup_s": warm_s, "storm_s": storms,
        "per_class_latency_s": {
            c: {"n": len(v), "p50": float(np.percentile(v, 50)),
                "p95": float(np.percentile(v, 95))}
            for c, v in latencies.items()},
        "storm_vs_serial": diffs,
        # the pair POST runs jobs 0 and 1 (seeds 101, 102) in one batch:
        # batching drift, measured whether or not a storm batched
        "pair_vs_serial": pair_diff,
        # what a mix-up of two jobs would show: the least mean difference
        # between two jobs' baselines
        "mixup_mean_diff": min(float(_diff(a, b).mean()) for a, b in
                               itertools.combinations(baselines, 2)),
        "k1": k1,
        "metrics": delta,
    }


if __name__ == "__main__":
    main()
