"""Benchmark: OMG two-concept end-to-end generation on one card (the port
of the JAX package's ``bench.py``).

The workload is the reference's headline one (BASELINE.md, config #2):
stage 1, a 50-step base denoise under prompt-to-prompt control; stage 2,
50 steps with a rank-32 LoRA per concept, fused into the left/right
regions after step 15; then the fp32 VAE decode. SDXL-base widths, the
UNet in bf16, random weights from seed 0 (compute is that of converted
weights), random prompt embeddings, noise and LoRAs from numpy seeds
(``build_workload``).

Prints ONE JSON line on stdout, {"metric", "value", "unit",
"vs_baseline", "extra"}; everything else goes to stderr.
  * latency (default): the median of OMG_BENCH_REPS timed generations
    after one untimed warm-up, each stage ended by a synchronize;
    vs_baseline = 5 s / median (above 1 beats the north-star target);
  * throughput: OMG_BENCH_REQUESTS requests, each with its own noise, run
    OMG_BENCH_CHUNK at a time as one batched program (2·chunk lanes in
    stage 1, 7·chunk in stage 2; with OMG_BENCH_CROP=strips 3·chunk
    full-frame lanes and 4·chunk strip lanes, two forwards a step), copy
    B of each decoded one request at a time; images per minute,
    vs_baseline = ipm / 12.

    python -m omg_tpu_torch.bench [--device cpu] [--out PATH]

Env (the JAX bench's knobs): OMG_BENCH_SIZE=sdxl|tiny, OMG_BENCH_STEPS
(50), OMG_BENCH_REPS (3), OMG_BENCH_H / OMG_BENCH_W (1024, tiny 32; a
serving bucket such as 1216x832), OMG_BENCH_MODE=latency|throughput,
OMG_BENCH_REQUESTS (4), OMG_BENCH_CHUNK (2), OMG_BENCH_SCHED=euler|ddim|
dpmpp_2m|lcm, OMG_BENCH_DEEPCACHE (interval; 0 exact) with
OMG_BENCH_DEEPCACHE_KIND=uniform|front and OMG_BENCH_DEEPCACHE_N (3, the
drift runs' interval), OMG_BENCH_CROP=strips, OMG_BENCH_QUANT=int8,
OMG_BENCH_VAE=bf16, OMG_BENCH_NO_FLASH=1 (every attention on the plain
version: K1's end-to-end worth), OMG_BENCH_DRIFT (comma list of crop,
int8, deepcache, deepcache_front, none; default crop): each approximate
mode's stage-2 latent MAE and decoded PSNR against this run's exact
latents, measured live in a latency run of the exact program; a mode not
run reports null. OMG_BENCH_PACKED=1 is refused (scan packing is an XLA
compile-time device with no counterpart here).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from omg_tpu_torch.control import p2p, regions
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.nn import layers
from omg_tpu_torch.ops import flash_attention as fa
from omg_tpu_torch.ops import quant
from omg_tpu_torch.pipelines import multiconcept, sdxl
from omg_tpu_torch.tools.serve_bench import (card, k1_launches, parse_args,
                                             random_weights, sync)

TARGET_S = 5.0          # north star: 2-concept 1024² 50 steps under 5 s
TARGET_IPM = 12.0       # 12 images a minute == 5 s an image
GUIDANCE = 7.5
SELF_REPLACE_STEPS = 0.4
LORA_RANK = 32
LORA_STD = 0.01
LORA_SCALE = 0.8
# the workload's numpy streams: (seed, stream)
EMBED_STREAM, NOISE_STREAM, LORA_STREAMS = 2, 5, (10, 11)
# LCM's re-noise seed of request r (the scheduler state carries it)
NOISE_SEED = 5
DRIFT_MODES = ("crop", "int8", "deepcache", "deepcache_front", "none")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


@dataclasses.dataclass(frozen=True)
class Knobs:
    """What OMG_BENCH_* asks for (``knobs_from_env``)."""
    size: str = "sdxl"
    steps: int = 50
    reps: int = 3
    height: Optional[int] = None        # None: the size's side
    width: Optional[int] = None
    mode: str = "latency"
    requests: int = 4
    chunk: int = 2
    sched: str = "euler"
    deepcache: int = 0
    deepcache_kind: str = "uniform"
    deepcache_n: int = 3
    crop: bool = False
    quant: str = ""
    vae: str = "fp32"
    no_flash: bool = False
    drift: tuple = ("crop",)


def knobs_from_env(env=None) -> Knobs:
    """The OMG_BENCH_* variables of ``env`` (``os.environ``) -> ``Knobs``;
    an unknown value raises."""
    env = os.environ if env is None else env
    get = env.get
    if get("OMG_BENCH_PACKED", "0") == "1":
        raise ValueError("OMG_BENCH_PACKED=1: scan-packed UNet parameters "
                         "(unet.pack_params) cut XLA compile time and have "
                         "no counterpart in the port")
    k = Knobs(
        size=get("OMG_BENCH_SIZE", "sdxl"),
        steps=int(get("OMG_BENCH_STEPS", "50")),
        reps=int(get("OMG_BENCH_REPS", "3")),
        height=int(get("OMG_BENCH_H")) if get("OMG_BENCH_H") else None,
        width=int(get("OMG_BENCH_W")) if get("OMG_BENCH_W") else None,
        mode=get("OMG_BENCH_MODE", "latency"),
        requests=int(get("OMG_BENCH_REQUESTS", "4")),
        chunk=int(get("OMG_BENCH_CHUNK", "2")),
        sched=get("OMG_BENCH_SCHED", "euler"),
        deepcache=int(get("OMG_BENCH_DEEPCACHE", "0")),
        deepcache_kind=get("OMG_BENCH_DEEPCACHE_KIND", "uniform"),
        deepcache_n=int(get("OMG_BENCH_DEEPCACHE_N", "3")),
        # canonical, as in the JAX bench: what runs, not the raw string
        crop=get("OMG_BENCH_CROP") == "strips",
        quant=get("OMG_BENCH_QUANT", ""),
        vae="bf16" if get("OMG_BENCH_VAE") == "bf16" else "fp32",
        no_flash=get("OMG_BENCH_NO_FLASH") == "1",
        drift=tuple(s.strip() for s in
                    get("OMG_BENCH_DRIFT", "crop").split(",") if s.strip()))
    for name, value, allowed in (
            ("OMG_BENCH_SIZE", k.size, ("sdxl", "tiny")),
            ("OMG_BENCH_MODE", k.mode, ("latency", "throughput")),
            ("OMG_BENCH_SCHED", k.sched, schedulers.KINDS),
            ("OMG_BENCH_DEEPCACHE_KIND", k.deepcache_kind,
             multiconcept.DEEPCACHE_SCHEDULES),
            ("OMG_BENCH_QUANT", k.quant, ("", "int8"))):
        if value not in allowed:
            raise ValueError(f"{name}={value!r}: one of {allowed}")
    bad = [m for m in k.drift if m not in DRIFT_MODES]
    if bad:
        raise ValueError(f"OMG_BENCH_DRIFT: unknown modes {bad} "
                         f"(of {DRIFT_MODES})")
    return k


def geometry(size: str) -> tuple:
    """(config, default side in pixels) of OMG_BENCH_SIZE."""
    return (sdxl.sdxl_config(), 1024) if size == "sdxl" else \
        (sdxl.tiny_config(), 32)


# --------------------------------------------------------------------------
# The workload, as numpy arrays
# --------------------------------------------------------------------------

def left_right_masks(h: int, w: int) -> np.ndarray:
    """[2, h, w]: concept 0 owns the left half, concept 1 the right."""
    m = np.zeros((2, h, w), np.float32)
    m[0, :, : w // 2] = 1.0
    m[1, :, w // 2:] = 1.0
    return m


def mid_block_lora(cfg, seed, rank: int = LORA_RANK) -> dict:
    """A rank-``rank`` LoRA on every attn1/attn2 projection of the mid
    block's transformer blocks (the character-LoRA cost), N(0, 0.01²)
    factors from numpy ``seed``, scale 0.8: the port's flat layout
    {module path: {"down" [in, r], "up" [r, out], "scale"}}, numpy."""
    rng = np.random.default_rng(seed)
    ucfg = cfg.unet
    dim, ctx = ucfg.block_out_channels[-1], ucfg.cross_attention_dim

    def leaf(d_in, d_out):
        return {"down": rng.standard_normal((d_in, rank), np.float32)
                * LORA_STD,
                "up": rng.standard_normal((rank, d_out), np.float32)
                * LORA_STD,
                "scale": np.float32(LORA_SCALE)}

    out = {}
    for i in range(ucfg.transformer_layers_per_block[-1]):
        pre = f"mid_block.attentions.0.transformer_blocks.{i}."
        for proj in ("to_q", "to_k", "to_v", "to_out.0"):
            out[pre + "attn1." + proj] = leaf(dim, dim)
        for proj, d_in in (("to_q", dim), ("to_k", ctx), ("to_v", ctx),
                           ("to_out.0", dim)):
            out[pre + "attn2." + proj] = leaf(d_in, dim)
    return out


def lora_tensors(tree: dict, device, dtype) -> dict:
    """A numpy LoRA of ``mid_block_lora`` on ``device``: the factors in
    ``dtype``, the scale fp32."""
    return {key: {"down": torch.as_tensor(leaf["down"], device=device)
                  .to(dtype),
                  "up": torch.as_tensor(leaf["up"], device=device).to(dtype),
                  "scale": torch.tensor(float(leaf["scale"]),
                                        device=device)}
            for key, leaf in tree.items()}


def build_workload(cfg, height: int, width: int, steps: int, seed: int = 0,
                   requests: int = 1) -> dict:
    """The bench's inputs as numpy arrays, from numpy streams of ``seed``:
    prompt embeddings [1, 77, D] and pooled embeddings [1, P] of the
    positive and the negative prompt, the two concept LoRAs, the
    left/right masks [2, h, w], unit initial noise [requests, h, w, 4]
    (request r's is row r; latency takes row 0) and the fusion gate,
    round(steps * 15 / 50)."""
    d = cfg.unet.cross_attention_dim
    p = cfg.text_encoder_2.projection_dim or cfg.text_encoder_2.hidden_size
    rng = np.random.default_rng((seed, EMBED_STREAM))
    embeds_pos, embeds_neg = (rng.standard_normal((1, 77, d), np.float32)
                              for _ in range(2))
    pooled_pos, pooled_neg = (rng.standard_normal((1, p), np.float32)
                              for _ in range(2))
    noise = np.random.default_rng((seed, NOISE_STREAM)).standard_normal(
        (requests, height // 8, width // 8, 4), np.float32)
    return {"embeds_pos": embeds_pos, "embeds_neg": embeds_neg,
            "pooled_pos": pooled_pos, "pooled_neg": pooled_neg,
            "loras": [mid_block_lora(cfg, (seed, s)) for s in LORA_STREAMS],
            "masks": left_right_masks(height // 8, width // 8),
            "noise": noise,
            "fusion_start": round(steps * regions.FUSION_START_STEP / 50)}


class Conditioning(NamedTuple):
    """The workload on the device."""
    base: multiconcept.BaseInputs
    concept: multiconcept.ConceptInputs
    controller: p2p.P2PControl
    loras: list
    masks: torch.Tensor


def conditioning(cfg, work: dict, height: int, width: int, steps: int,
                 device) -> Conditioning:
    """Base and concept inputs at guidance 7.5 with ``add_time_ids`` at
    (height, width), P2P over ["x", "x"] (self-replace 0.4 of the steps,
    at (width / 32, height / 32)), the LoRAs and the masks on ``device``,
    embeddings and LoRA factors in the UNet's dtype."""
    dt = cfg.unet.dtype

    def dev(name):
        return torch.as_tensor(work[name], device=device).to(dt)

    tids = sdxl.add_time_ids((height, width), (0, 0), (height, width),
                             device=device)
    args = (dev("embeds_pos"), dev("pooled_pos"), dev("embeds_neg"),
            dev("pooled_neg"), tids)
    return Conditioning(
        base=multiconcept.make_base_inputs(*args, GUIDANCE),
        concept=multiconcept.make_concept_inputs(*args),
        controller=p2p.P2PControl.build(
            ["x", "x"], steps, self_replace_steps=SELF_REPLACE_STEPS,
            width=width // 32, height=height // 32, device=device),
        loras=[lora_tensors(t, device, dt) for t in work["loras"]],
        masks=torch.as_tensor(work["masks"], device=device))


# --------------------------------------------------------------------------
# Measurement helpers
# --------------------------------------------------------------------------

def dc_spec_of(n: int, kind: str, steps: int, fusion_start: int):
    """The DeepCache spec of interval ``n``: 0 (exact), the interval, or
    the "front" per-step schedule (as the JAX bench's ``dc_spec_of``)."""
    if n <= 1:
        return 0
    if kind == "uniform":
        return n
    return multiconcept.deepcache_schedule(steps, n, kind=kind,
                                           fusion_start=fusion_start)


def geom(height: int, width: int) -> str:
    """The metric's geometry: "1024" at 1024², else "{H}x{W}"."""
    return "1024" if (height, width) == (1024, 1024) else f"{height}x{width}"


def psnr_db(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 99.0 if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


def to_uint8(img: torch.Tensor) -> np.ndarray:
    """Images in [0, 1] -> uint8 by truncation (the JAX bench's cast)."""
    return (img * 255).to(torch.uint8).cpu().numpy()


@contextlib.contextmanager
def plain_attention():
    """Every attention on the plain PyTorch version (OMG_BENCH_NO_FLASH)."""
    gate = fa.use_flash
    fa.use_flash = lambda *args, **kwargs: False
    try:
        yield
    finally:
        fa.use_flash = gate


def memory(device) -> tuple:
    """(bytes allocated now, peak since the last reset) on a card; (None,
    None) on the CPU."""
    if torch.device(device).type != "cuda":
        return None, None
    return torch.cuda.memory_allocated(device), \
        torch.cuda.max_memory_allocated(device)


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def device_fields(device, knobs: Knobs, start, peak) -> dict:
    """The device, its power limit, the peak memory and the attention
    route of a record."""
    gib = 2.0 ** 30
    return {"backend": torch.device(device).type, **card(device),
            "peak_gib": None if peak is None else peak / gib,
            "peak_over_start_gib": None if peak is None else
            (peak - start) / gib,
            "flash": not knobs.no_flash,
            "kernel_build_s": fa.BUILD_INFO.get("seconds")}


@contextlib.contextmanager
def launch_counts(out: dict):
    """K1's launches in the block ("k1_launches", "k1_by_shape") and K1b's
    ("k1b_launches")."""
    k1: dict = {}
    seq = fa.SEQ_LAUNCHES
    with k1_launches(k1):
        yield
    out.update(k1_launches=k1["launches"], k1_by_shape=k1["by_shape"],
               k1b_launches=fa.SEQ_LAUNCHES - seq)


# --------------------------------------------------------------------------
# Latency
# --------------------------------------------------------------------------

def latency(cfg, params, work: dict, knobs: Knobs, device, height: int,
            width: int) -> tuple:
    """The latency mode on ``params`` (``sdxl.SDXLParams`` on ``device``)
    -> (record, stage-2 latents [2, h, w, 4] of the last timed call)."""
    steps = knobs.steps
    sched = schedulers.make_schedule(knobs.sched, steps)
    fusion_start = work["fusion_start"]
    cond = conditioning(cfg, work, height, width, steps, device)
    exact_unet = params.unet
    unet = quant.quantize_unet(exact_unet) if knobs.quant else exact_unet
    dc_spec = dc_spec_of(knobs.deepcache, knobs.deepcache_kind, steps,
                         fusion_start)
    vae_dtype = torch.bfloat16 if knobs.vae == "bf16" else torch.float32
    stage2_kw = dict(base_inputs=cond.base, controller=cond.controller,
                     concept_inputs=[cond.concept, cond.concept],
                     concept_loras=cond.loras, masks=cond.masks,
                     fusion_start=fusion_start)

    def stage1(model, cache_interval):
        return multiconcept.sample_stage1_cached(
            cfg, sched, model, generator=None, height=height, width=width,
            base_inputs=cond.base, fusion_start=fusion_start,
            initial_noise=work["noise"][:1], cache_interval=cache_interval,
            noise_seed=NOISE_SEED)

    def generation(model=unet, cache_interval=dc_spec, crop=knobs.crop):
        """-> ((stage 1, stage 2, decode seconds), stage-2 latents, the
        stage-1 cache)."""
        t0 = time.perf_counter()
        _, cache = stage1(model, cache_interval)
        sync(device)
        t1 = time.perf_counter()
        lat2 = multiconcept.sample_stage2_resumed(
            cfg, sched, model, cache, cache_interval=cache_interval,
            concept_crop=crop, **stage2_kw)
        sync(device)
        t2 = time.perf_counter()
        sdxl.decode_latents(cfg, params.vae, lat2, dtype=vae_dtype)
        sync(device)
        t3 = time.perf_counter()
        return (t1 - t0, t2 - t1, t3 - t2), lat2, cache

    # warm-up: builds the kernel, initializes cuBLAS; not a latency
    t0 = time.perf_counter()
    _, lat2_w, cache_w = generation()
    warmup_s = time.perf_counter() - t0
    log(f"bench: warm-up {warmup_s:.3f} s")

    def drift(lat2_other) -> dict:
        """Stage-2 latent MAE and copy B's decoded PSNR against the exact
        run (same weights and noise)."""
        mae = float((lat2_w.float() - lat2_other.float()).abs().mean())
        a, b = (to_uint8(sdxl.decode_latents(cfg, params.vae, lat[1:2],
                                             dtype=vae_dtype))
                for lat in (lat2_w, lat2_other))
        return {"stage2_latent_mae": mae, "pixel_psnr_db": psnr_db(a, b),
                "measured": "live"}

    # Drift of the approximate modes against this run's exact latents.
    # The JAX bench also gates on Euler at 1024² SDXL, the provenance of
    # its cached TPU numbers; the port keeps no cache and measures at the
    # geometry and scheduler that ran (the record names both).
    exact_run = not knobs.quant and knobs.deepcache <= 1 and not knobs.crop
    modes, dc_n = set(knobs.drift), knobs.deepcache_n
    drifts = dict.fromkeys(("crop_drift", "int8_drift", "deepcache_drift",
                            "deepcache_front_drift"))
    if exact_run and "crop" in modes and \
            multiconcept.crop_strips_ok(cfg, width // 8, 2):
        drifts["crop_drift"] = drift(multiconcept.sample_stage2_resumed(
            cfg, sched, unet, cache_w, concept_crop=True, **stage2_kw))
    if exact_run and "int8" in modes:
        qunet = quant.quantize_unet(exact_unet)
        _, cache_q = stage1(qunet, 0)
        drifts["int8_drift"] = drift(multiconcept.sample_stage2_resumed(
            cfg, sched, qunet, cache_q, **stage2_kw))
        del qunet, cache_q
    if exact_run and "deepcache" in modes and dc_n > 1:
        drifts["deepcache_drift"] = dict(
            drift(generation(cache_interval=dc_n)[1]), interval=dc_n)
    if exact_run and "deepcache_front" in modes and dc_n > 1:
        spec = dc_spec_of(dc_n, "front", steps, fusion_start)
        drifts["deepcache_front_drift"] = dict(
            drift(generation(cache_interval=spec)[1]), interval=dc_n,
            kind="front")
    for name, value in drifts.items():
        if value is not None:
            log(f"bench: {name} {value}")

    sync(device)
    start, _ = memory(device)
    reset_peak(device)
    times, launches = [], {}
    for rep in range(knobs.reps):
        with (launch_counts(launches) if rep == 0
              else contextlib.nullcontext()):
            split, lat2, _ = generation()
        times.append(split)
        log(f"bench: rep {rep}: stage 1 {split[0]:.3f} s, stage 2 "
            f"{split[1]:.3f} s, decode {split[2]:.3f} s")
    _, peak = memory(device)
    totals = [sum(s) for s in times]
    p50 = float(np.median(totals))
    record = {
        "metric": f"omg_2concept_{geom(height, width)}_{steps}step_e2e_"
                  "latency",
        "value": p50,
        "unit": "s",
        "vs_baseline": TARGET_S / p50,
        "extra": {
            "times": totals,
            "stage1_s": float(np.median([s[0] for s in times])),
            "stage2_s": float(np.median([s[1] for s in times])),
            "vae_s": float(np.median([s[2] for s in times])),
            "warmup_s": warmup_s,
            "vae_dtype": knobs.vae,
            "quant": knobs.quant or "none",
            "scheduler": knobs.sched,
            "concept_crop": "strips" if knobs.crop else "none",
            "deepcache_interval": knobs.deepcache if knobs.deepcache > 1
            else None,
            "deepcache_kind": knobs.deepcache_kind if knobs.deepcache > 1
            else None,
            **drifts,
            "size": knobs.size, "steps": steps,
            "height": height, "width": width,
            **device_fields(device, knobs, start, peak),
            **launches,
        },
    }
    return record, lat2


# --------------------------------------------------------------------------
# Throughput
# --------------------------------------------------------------------------

def throughput(cfg, params, work: dict, knobs: Knobs, device, height: int,
               width: int) -> tuple:
    """The throughput mode on ``params`` -> (record, stage-2 latents
    [R, 2, h, w, 4] of the last timed pass); ``work`` holds R noise rows
    (R rounded up to a multiple of the chunk)."""
    noise = work["noise"]
    R = noise.shape[0]
    chunk = max(1, min(R, knobs.chunk))
    steps = knobs.steps
    sched = schedulers.make_schedule(knobs.sched, steps)
    fusion_start = work["fusion_start"]
    cond = conditioning(cfg, work, height, width, steps, device)
    unet = quant.quantize_unet(params.unet) if knobs.quant else params.unet
    dc_spec = dc_spec_of(knobs.deepcache, knobs.deepcache_kind, steps,
                         fusion_start)
    vae_dtype = torch.bfloat16 if knobs.vae == "bf16" else torch.float32
    masks = cond.masks.expand((chunk,) + tuple(cond.masks.shape))
    if knobs.crop:
        # what stage 2 would refuse, refused before stage 1 runs
        multiconcept.check_crop_batch(cfg, masks, 2, dc_spec)

    def run() -> torch.Tensor:
        out = []
        for c0 in range(0, R, chunk):
            rows = range(c0, c0 + chunk)
            _, caches = multiconcept.sample_stage1_batch(
                cfg, sched, unet, [NOISE_SEED + r for r in rows],
                [cond.base] * chunk, height=height, width=width,
                fusion_start=fusion_start, cache_interval=dc_spec,
                initial_noise=[noise[r:r + 1] for r in rows])
            lat2 = multiconcept.sample_stage2_batch(
                cfg, sched, unet, caches, [cond.base] * chunk,
                cond.controller, [[cond.concept, cond.concept]] * chunk,
                [cond.loras] * chunk, masks, fusion_start=fusion_start,
                cache_interval=dc_spec, concept_crop=knobs.crop)
            # copy B, one request at a time: a batched fp32 decode holds
            # every request's upsampling activations at once
            for r in range(chunk):
                sdxl.decode_latents(cfg, params.vae, lat2[r, 1:2],
                                    dtype=vae_dtype)
            out.append(lat2)
        sync(device)
        return torch.cat(out)

    t0 = time.perf_counter()
    run()
    warmup_s = time.perf_counter() - t0
    log(f"bench: warm-up {warmup_s:.3f} s")
    start, _ = memory(device)
    reset_peak(device)
    times, launches = [], {}
    for rep in range(knobs.reps):
        with (launch_counts(launches) if rep == 0
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            lat2 = run()
        times.append(time.perf_counter() - t0)
        log(f"bench: rep {rep}: {R} requests in {times[-1]:.3f} s")
    _, peak = memory(device)
    p50 = float(np.median(times))
    ipm = 60.0 * R / p50
    record = {
        "metric": f"omg_2concept_{geom(height, width)}_{steps}step_"
                  "images_per_min_chip",
        "value": ipm,
        "unit": "images/min/chip",
        "vs_baseline": ipm / TARGET_IPM,
        "extra": {
            "requests": R, "chunk": chunk,
            "batch_seconds": p50, "times": times,
            "warmup_s": warmup_s,
            "size": knobs.size, "steps": steps,
            "height": height, "width": width,
            "vae_dtype": knobs.vae,
            "quant": knobs.quant or "none",
            "scheduler": knobs.sched,
            "concept_crop": "strips" if knobs.crop else None,
            "deepcache_interval": knobs.deepcache if knobs.deepcache > 1
            else None,
            "deepcache_kind": knobs.deepcache_kind if knobs.deepcache > 1
            else None,
            **device_fields(device, knobs, start, peak),
            **launches,
        },
    }
    return record, lat2


def throughput_counts(knobs: Knobs) -> tuple:
    """(R, chunk): the chunk within [1, R], R rounded up to a multiple of
    it (every request is real work; the rate is over the real count)."""
    R = knobs.requests
    chunk = max(1, min(R, knobs.chunk))
    if R % chunk:
        R = -(-R // chunk) * chunk
        log(f"note: rounded requests up to {R} (multiple of chunk {chunk})")
    return R, chunk


def main(argv=None, *, weights=None) -> tuple:
    """Run the bench the environment asks for and print its record ->
    (record, stage-2 latents). ``weights``: (cfg, ``SDXLParams``) already
    on the device (the models are then not built)."""
    args = parse_args(argv, prog="omg_tpu_torch.bench", doc=__doc__)
    knobs = knobs_from_env()
    device = layers.target_device(args.device, "omg_tpu_torch.bench")
    cfg, side = geometry(knobs.size)
    height, width = knobs.height or side, knobs.width or side
    with torch.inference_mode():
        if weights is None:
            params = random_weights(cfg, device)
        else:
            cfg, params = weights
        requests = (throughput_counts(knobs)[0]
                    if knobs.mode == "throughput" else 1)
        work = build_workload(cfg, height, width, knobs.steps,
                              requests=requests)
        run = throughput if knobs.mode == "throughput" else latency
        with (plain_attention() if knobs.no_flash
              else contextlib.nullcontext()):
            record, latents = run(cfg, params, work, knobs, device, height,
                                  width)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    print(json.dumps(record), flush=True)
    return record, latents


if __name__ == "__main__":
    main()
