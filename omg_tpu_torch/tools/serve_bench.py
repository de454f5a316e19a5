"""Serving-stack benchmark: requests through the port's real ``OMGServer``
(port of ``tools/serve_bench.py``).

The two-concept Euler workload through the whole serving stack: HTTP,
JSON, the queue and its microbatched drain, CLIP text encoding, the
stage-1 decode and the mask provider, the fp32 decodes and PNG encoding;
what a client observes. The weights are random (from seed 0) at SDXL
width, or tiny; the mask provider is a host strip stub that counts its
calls, so SAM's encode is the one serving cost left out.

Stage-2 integrity, as in the JAX tool: the engine's token gate
(``OMG._token_in_prompt``) runs mask prediction only when a class word
("man", "woman") is in the global prompt, so the prompts carry both
words, the tool checks that the gate hits on them and misses on a prompt
without them, counts the provider's calls, and requires
``stage2_ran`` of every response.

Measures, after one untimed single request and one untimed multi-prompt
request:
  0. the ceiling: ``engine.generate_batch`` of the multi-prompt request's
     R jobs, in chunks of ``max_batch`` as the server runs them, called
     directly in this thread between ``torch.cuda.synchronize()`` calls:
     R / seconds x 60 images per minute. Both HTTP rates must stay within
     5% of it (a serving stack cannot out-run its own compute), in every
     mode: the ceiling is measured for the DeepCache setting that runs.
     A pass shorter than a second is within timing noise of the 5%: the
     tool then prints that it did not check (``ceiling_checked``);
  1. single-request latency through the server (client wall seconds);
  2. one POST of R prompts (``submit_many``, chunks of ``max_batch``);
  3. R concurrent single-request POSTs (the queue's drain).
The record adds the engine seconds, HTTP seconds over them (the serving
stack's cost), the device, its power limit, and K1's launches by q shape
in each part.

    python -m omg_tpu_torch.tools.serve_bench [--device cpu] [--out PATH]

Env: OMG_SERVE_SIZE=sdxl|tiny (sdxl: 1024x1024, 50 steps; tiny: 32x32, 2
steps), OMG_SERVE_R (4), OMG_SERVE_CHUNK (2), OMG_SERVE_REPS (2),
OMG_SERVE_STEPS (the size's), OMG_SERVE_DEEPCACHE (0: exact) with
OMG_SERVE_DEEPCACHE_KIND (front).
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import json
import os
import subprocess
import threading
import time
import urllib.request

import numpy as np
import torch

from omg_tpu_torch.nn import layers
from omg_tpu_torch.ops import flash_attention as fa
from omg_tpu_torch.pipelines import omg as omg_lib
from omg_tpu_torch.pipelines import sdxl
from omg_tpu_torch.serving.registry import Registry
from omg_tpu_torch.serving.server import OMGServer
from omg_tpu_torch.text.tokenizer import ToyTokenizer
from omg_tpu_torch.utils import image as image_io

REWRITE = "[photo of a man]-*-[ugly]|[photo of a woman]-*-[ugly]"
GATE_PROMPT = "a man and a woman at the beach"
MISS_PROMPT = "two people at the beach"
CLASSES = ("man", "woman")
# HTTP images per minute may exceed the engine's by this factor (timing
# noise) and no more. The check needs an engine pass of at least
# CEILING_MIN_S: below it the host's timing noise exceeds the slack (a
# tiny run on the CPU takes ~0.05 s and varies by 10-30%), and the tool
# says that it did not check.
CEILING_SLACK = 1.05
CEILING_MIN_S = 1.0


def parse_args(argv=None, prog: str = "omg_tpu_torch.tools.serve_bench",
               doc: str = __doc__):
    p = argparse.ArgumentParser(prog, description=doc.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="device of the models: cuda (default) or cpu")
    p.add_argument("--out", default="",
                   help="also write the whole record to this JSON file")
    return p.parse_args(argv)


def geometry(size: str) -> tuple:
    """(config, side in pixels, default steps) of OMG_*_SIZE."""
    if size == "sdxl":
        return sdxl.sdxl_config(), 1024, 50
    if size == "tiny":
        return sdxl.tiny_config(), 32, 2
    raise ValueError(f"unknown size {size!r} (sdxl or tiny)")


def random_weights(cfg, device) -> sdxl.SDXLParams:
    """The four models with random weights from seed 0 on ``device``."""
    with torch.inference_mode():
        return sdxl.init_params(torch.Generator(device).manual_seed(0), cfg,
                                device)


def strip_provider(counter: dict):
    """Host strip-mask stub: "man" owns the left half, any other class the
    right; ``counter["n"]`` counts the calls."""
    def provider(image, cls):
        counter["n"] += 1
        m = np.zeros(image.shape[:2], np.float32)
        half = image.shape[1] // 2
        if cls == "man":
            m[:, :half] = 1.0
        else:
            m[:, half:] = 1.0
        return m
    return provider


def check_gate(engine) -> None:
    """The token gate hits both classes on GATE_PROMPT and neither on
    MISS_PROMPT, with this engine's tokenizer."""
    for cls in CLASSES:
        if not engine._token_in_prompt(cls, GATE_PROMPT):
            raise AssertionError(f"the gate misses {cls!r} in {GATE_PROMPT!r}")
        if engine._token_in_prompt(cls, MISS_PROMPT):
            raise AssertionError(f"the gate hits {cls!r} in {MISS_PROMPT!r}")


def check_stage2(out: dict) -> dict:
    """A response that ran the whole two-stage workload: both masks found,
    stage 2 run."""
    if out.get("stage2_ran") is not True or \
            out.get("masks_found") != [True, True]:
        raise AssertionError(f"stage 2 did not run: masks found "
                             f"{out.get('masks_found')}")
    return out


def decode(b64: str) -> np.ndarray:
    return image_io.decode_png(base64.b64decode(b64))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card(device) -> dict:
    """The device's name and, on a card, nvidia-smi's power limit."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=60)
    line = out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    return {"device": torch.cuda.get_device_name(device),
            "power_limit": line.split(",")[-1].strip() if line else None}


@contextlib.contextmanager
def k1_launches(out: dict):
    """Fill ``out`` with K1's launches in the block: "launches" (the rise
    of ``fa.LAUNCHES``) and "by_shape" (by q shape "B,H,N,D"), replays
    of a CUDA graph included. Count only while one thread launches."""
    count = fa.count_launch
    by_shape = out.setdefault("by_shape", {})

    def tally(shape, seq_local):
        count(shape, seq_local)
        if not seq_local:
            key = ",".join(map(str, shape))
            by_shape[key] = by_shape.get(key, 0) + 1

    start = fa.LAUNCHES
    fa.count_launch = tally
    try:
        yield out
    finally:
        fa.count_launch = count
        out["launches"] = fa.LAUNCHES - start


class Client:
    """``srv`` serving on 127.0.0.1 (a free port) in a thread, and its JSON
    calls."""

    def __init__(self, srv: OMGServer):
        self.srv = srv
        threading.Thread(target=srv.serve, args=("127.0.0.1", 0),
                         daemon=True).start()
        self.url = "http://" + srv.wait_bound()

    def get(self, path: str) -> dict:
        with urllib.request.urlopen(self.url + path, timeout=60) as r:
            return json.loads(r.read())

    def post(self, payload: dict, timeout: float = 3600.0) -> dict:
        req = urllib.request.Request(
            self.url + "/generate", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())

    def counters(self) -> dict:
        return self.get("/metrics")["counters"]

    def close(self) -> None:
        self.srv.shutdown()


def concurrent(fn, n: int) -> list:
    """``fn(i)`` for i < n in n threads at once -> their results; any
    failure fails the call (not silently its thread)."""
    results, errors = [None] * n, [None] * n

    def one(i):
        try:
            results[i] = fn(i)
        except Exception as e:          # re-raised below
            errors[i] = e

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    bad = [(i, e) for i, e in enumerate(errors) if e is not None]
    if bad:
        raise RuntimeError(f"{len(bad)}/{n} concurrent requests failed: "
                           f"request {bad[0][0]}: {bad[0][1]!r}"
                           ) from bad[0][1]
    return results


def engine_for(who: str, size: str, steps: int, device, weights, provider):
    """(engine, side): an ``OMG`` over ``weights`` ((cfg, params); random
    ones of ``size`` on ``device`` when None) with ToyTokenizers and
    ``provider``, its token gate checked."""
    cfg, side, default_steps = geometry(size)
    if weights is None:
        params = random_weights(cfg, layers.target_device(device, who))
    else:
        cfg, params = weights
    tok = ToyTokenizer()
    engine = omg_lib.OMG(cfg=cfg, params=params, tokenizer=tok,
                         tokenizer_2=tok, mask_provider=provider,
                         num_steps=steps or default_steps)
    check_gate(engine)
    return engine, side


def main(argv=None, *, weights=None) -> dict:
    """Run the benchmark; returns the record. ``weights``: (cfg, params)
    already on a device (the models are then not built)."""
    args = parse_args(argv)
    env = os.environ.get
    size = env("OMG_SERVE_SIZE", "sdxl")
    R = int(env("OMG_SERVE_R", "4"))
    chunk = int(env("OMG_SERVE_CHUNK", "2"))
    reps = int(env("OMG_SERVE_REPS", "2"))
    dc = int(env("OMG_SERVE_DEEPCACHE", "0"))
    dc_kind = env("OMG_SERVE_DEEPCACHE_KIND", "front")
    calls = {"n": 0}
    engine, side = engine_for("serve_bench", size,
                              int(env("OMG_SERVE_STEPS", "0")), args.device,
                              weights, strip_provider(calls))
    device = engine.device
    steps = engine.num_steps
    srv = OMGServer(engine, Registry(), max_batch=chunk)
    client = Client(srv)
    try:
        record = _bench(engine, srv, client, side=side, R=R, chunk=chunk,
                        reps=reps, dc=dc, dc_kind=dc_kind, calls=calls)
    finally:
        client.close()
    record.update(geometry=f"{side}x{side}", steps=steps, **card(device))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    print(json.dumps({k: v for k, v in record.items()
                      if k not in ("metrics", "what")}), flush=True)
    return record


def _bench(engine, srv, client, *, side, R, chunk, reps, dc, dc_kind,
           calls) -> dict:
    device = engine.device
    before = client.counters()

    def job(i: int) -> dict:
        out = {"prompt": f"{GATE_PROMPT} {i}", "prompt_rewrite": REWRITE,
               "seed": 100 + i, "height": side, "width": side}
        if dc > 1:
            out.update(cache_interval=dc, cache_schedule=dc_kind)
        return out

    jobs = [job(i) for i in range(R)]
    # one POST of R prompts: the server makes jobs[i] of it (seed + i)
    multi = {k: v for k, v in jobs[0].items() if k != "prompt"}
    multi["prompts"] = [j["prompt"] for j in jobs]

    def timed(fn):
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        return time.perf_counter() - t0, out

    def post_multi():
        out = client.post(multi)["results"]
        if len(out) != R:
            raise AssertionError(f"{len(out)} results for {R} prompts")
        return [check_stage2(r) for r in out]

    # ---- warm-up: every program the timed parts run, once
    warm_single, _ = timed(lambda: check_stage2(client.post(job(0))))
    if calls["n"] < 2:
        raise AssertionError("the mask provider was never called: the token "
                             "gate skipped stage 2")
    print(f"warm-up single {warm_single:.3f} s", flush=True)
    warm_multi, _ = timed(post_multi)
    print(f"warm-up multi {warm_multi:.3f} s", flush=True)

    k1: dict = {}
    # ---- 0. the ceiling: the same R jobs straight into the engine, in the
    # server's chunks, while the server is idle
    reqs = [srv._job_to_request(dict(j)) for j in jobs]

    def engine_pass():
        for i in range(0, R, chunk):
            for res in engine.generate_batch(reqs[i:i + chunk]):
                if res.stage2 is None:
                    raise AssertionError("ceiling: stage 2 did not run")

    engine_times = []
    for rep in range(reps):
        with (k1_launches(k1.setdefault("ceiling", {})) if rep == 0
              else contextlib.nullcontext()):
            engine_times.append(timed(engine_pass)[0])
    engine_s = min(engine_times)
    ceiling = R / engine_s * 60.0
    print(f"engine ceiling: R={R} in chunks of {chunk}: {engine_s:.3f} s "
          f"-> {ceiling:.3f} img/min", flush=True)

    # ---- 1. single-request latency
    lat, server_s = [], None
    for rep in range(reps):
        with (k1_launches(k1.setdefault("single", {})) if rep == 0
              else contextlib.nullcontext()):
            t, out = timed(lambda: check_stage2(client.post(job(1))))
        lat.append(t)
        server_s = out["seconds"]
    lat_s = min(lat)
    print(f"single request: {lat_s:.3f} s (server's {server_s:.3f} s)",
          flush=True)

    # ---- 2. one POST of R prompts
    tp = []
    for rep in range(reps):
        with (k1_launches(k1.setdefault("multi", {})) if rep == 0
              else contextlib.nullcontext()):
            tp.append(timed(post_multi)[0])
    tp_s = min(tp)
    tp_ipm = R / tp_s * 60.0
    print(f"multi-prompt R={R} chunk={chunk}: {tp_s:.3f} s -> "
          f"{tp_ipm:.3f} img/min", flush=True)

    # ---- 3. R concurrent single-request POSTs
    conc = []
    for rep in range(reps):
        with (k1_launches(k1.setdefault("concurrent", {})) if rep == 0
              else contextlib.nullcontext()):
            conc.append(timed(lambda: concurrent(
                lambda i: check_stage2(client.post(job(i))), R))[0])
    conc_s = min(conc)
    conc_ipm = R / conc_s * 60.0
    print(f"concurrent R={R} POSTs: {conc_s:.3f} s -> {conc_ipm:.3f} "
          f"img/min", flush=True)

    checked = engine_s >= CEILING_MIN_S
    for name, ipm in (("multi-prompt", tp_ipm), ("concurrent", conc_ipm)):
        if checked and ipm > ceiling * CEILING_SLACK:
            raise AssertionError(
                f"{name} throughput {ipm:.3f} img/min exceeds the engine's "
                f"{ceiling:.3f} img/min x {CEILING_SLACK}: part of the "
                f"workload did not run")
    if not checked:
        print(f"ceiling check not made: the engine pass took {engine_s:.3f} "
              f"s, under the {CEILING_MIN_S} s that a {CEILING_SLACK}x "
              f"bound needs", flush=True)
    after = client.counters()
    skipped = after.get("stage2_skipped", 0) - before.get("stage2_skipped", 0)
    if skipped:
        raise AssertionError(f"{skipped} responses skipped stage 2")
    return {
        "what": "serving-stack throughput through the port's OMGServer over "
                "HTTP (2-concept two-stage Euler, random weights, strip-stub "
                "masks, every response stage2_ran=true)"
                + (f"; DeepCache interval {dc} {dc_kind}" if dc > 1 else ""),
        "requests": R, "max_batch": chunk, "reps": reps,
        "deepcache": [dc, dc_kind] if dc > 1 else None,
        "warmup_single_s": warm_single, "warmup_multi_s": warm_multi,
        "single_request_latency_s": lat_s,
        "single_request_server_s": server_s,
        "multi_prompt_wall_s": tp_s, "multi_prompt_img_per_min_chip": tp_ipm,
        "concurrent_wall_s": conc_s, "concurrent_img_per_min_chip": conc_ipm,
        "mask_provider_calls": calls["n"],
        "engine_s": engine_s, "engine_times_s": engine_times,
        "bare_compute_ceiling_ipm": ceiling, "ceiling_checked": checked,
        "http_over_engine": tp_s / engine_s,
        "k1": k1,
        "metrics": {k: after.get(k, 0) - before.get(k, 0) for k in after},
    }


if __name__ == "__main__":
    main()
