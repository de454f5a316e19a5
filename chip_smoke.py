"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure propagates and the exit code is non-zero:
  1. device  — a CUDA device must be present (no CPU run); prints its
     name, count, nvidia-smi name and power limit; turns TF32 off for
     matmuls and cuDNN so the fp32 VAE decode is fp32.
  2. build   — compiles the flash-attention kernel from
     omg_tpu_torch/ops/csrc with nvcc; prints seconds and ptxas usage.
  3. kernel  — kernel vs its plain PyTorch version on seeded bf16 inputs
     at the UNet's self-attention shapes; error bound, ms per call.
  4. model   — one SDXL-width UNet forward at the 7-lane stage-2 layout
     (P2P inside its self-replace window, stacked LoRA lanes) through the
     kernel and with attention forced to the plain version; 70 launches.
  5. main    — ``OMG.generate`` at SDXL widths, 1024x1024, 50 Euler steps,
     two concepts with rank-32 LoRAs, random weights from a seed;
     5880 kernel launches, finite latents, stage times, peak memory.
The last two lines are a JSON record of the kernel and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from omg_tpu_torch.control import p2p
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.lora import stack_loras
from omg_tpu_torch.ops import flash_attention as fa
from omg_tpu_torch.pipelines import multiconcept, omg as omg_lib, sdxl
from omg_tpu_torch.text.tokenizer import ToyTokenizer

HEIGHT = WIDTH = 1024
STEPS = 50
SEED = 14
# Self-attention layers per UNet forward at 1024x1024 that take the
# kernel: level 1 (64x64 = 4096 tokens) has 2 + 3 blocks of depth 2 = 10,
# level 2 (32x32 = 1024 tokens) 2 + 1 (mid) + 3 blocks of depth 10 = 60.
LAUNCHES_PER_FORWARD = 70
# Stage 1 runs all 50 steps (2 lanes); stage 2 resumes after
# fusion_start = 15, i.e. steps 16..49 (7 lanes).
MAIN_PATH_LAUNCHES = STEPS * 70 + (STEPS - 16) * 70

# Kernel vs plain, bf16 in and out: bf16 keeps 8 mantissa bits. The
# kernel rounds the unnormalized probabilities to bf16 before P.V and
# both sides round O, so they may differ by a few ulps of the output's
# scale: 4 * 2^-8 of max(|o|, 1).
KERNEL_ULPS = 4 * 2.0 ** -8
# UNet eps through the kernel vs through the plain path: the two round
# attention at different points, and 70 residual transformer blocks of
# bf16 activations carry that forward: 5% of max |eps|.
MODEL_REL_BOUND = 0.05

KERNEL_SHAPES = [  # (B, H, N, D): main-path, bucket, D=128, ragged tiles
    (2, 10, 4096, 64), (7, 10, 4096, 64), (2, 20, 1024, 64),
    (7, 20, 1024, 64), (2, 10, 3952, 64), (2, 20, 988, 64),
    (2, 20, 960, 64), (2, 20, 1008, 64), (2, 10, 3840, 64),
    (2, 10, 1024, 128), (2, 20, 1088, 64), (2, 20, 1025, 64)]
TIMED_SHAPE = (7, 10, 4096, 64)


def log(*args):
    print(*args, flush=True)


def power_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_phase() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; the port's main path "
                           "runs on an NVIDIA GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device:", torch.cuda.get_device_name(0), "| count:",
        torch.cuda.device_count(), "| torch", torch.__version__, "cuda",
        torch.version.cuda)
    log("nvidia-smi:", power_line())
    log("allow_tf32: matmul", torch.backends.cuda.matmul.allow_tf32,
        "cudnn", torch.backends.cudnn.allow_tf32)
    return torch.device("cuda", 0)


def build_phase() -> None:
    fa.build()
    log(f"build: {fa.BUILD_INFO['seconds']:.2f} s -> {fa.BUILD_INFO['path']}")
    for line in fa.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log("  ptxas:", line.strip())


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase(device) -> dict:
    g = torch.Generator(device).manual_seed(0)
    worst, timed = 0.0, None
    for b, h, n, d in KERNEL_SHAPES:
        q, k, v = (torch.randn(b, h, n, d, generator=g, device=device,
                               dtype=torch.bfloat16) for _ in range(3))
        out = fa.flash_attention(q, k, v)
        ref = fa.flash_attention_ref(q, k, v).float()
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"kernel output not finite at {(b, h, n, d)}")
        err = (out.float() - ref).abs().max().item()
        bound = KERNEL_ULPS * max(ref.abs().max().item(), 1.0)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 20)
        plain_ms = cuda_ms(lambda: fa.flash_attention_ref(q, k, v), 5)
        log(f"  [{b},{h},{n},{d}] max_abs_err {err:.3e} (bound {bound:.3e})"
            f"  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms")
        if err > bound:
            raise AssertionError(f"kernel disagrees at {(b, h, n, d)}: "
                                 f"{err} > {bound}")
        worst = max(worst, err)
        if (b, h, n, d) == TIMED_SHAPE:
            timed = (ms, plain_ms)
        del q, k, v, out, ref
    return {"max_abs_err": worst, "ms": timed[0], "plain_ms": timed[1]}


def mid_block_lora(device, seed: int, cfg, rank: int = 32) -> dict:
    """Rank-32 LoRA on every attention projection of the mid block's
    transformer (the bench's character-LoRA cost), bf16, scale 0.8."""
    g = torch.Generator(device).manual_seed(seed)
    ucfg = cfg.unet
    dim, ctx = ucfg.block_out_channels[-1], ucfg.cross_attention_dim

    def leaf(d_in, d_out):
        def r(*shape):
            return (torch.randn(shape, generator=g, device=device) *
                    0.01).to(ucfg.dtype)
        return {"down": r(d_in, rank), "up": r(rank, d_out),
                "scale": torch.tensor(0.8, device=device)}

    out = {}
    for i in range(ucfg.transformer_layers_per_block[-1]):
        pre = f"mid_block.attentions.0.transformer_blocks.{i}."
        for proj in ("to_q", "to_k", "to_v", "to_out.0"):
            out[pre + "attn1." + proj] = leaf(dim, dim)
        for proj, d_in in (("to_q", dim), ("to_k", ctx), ("to_v", ctx),
                           ("to_out.0", dim)):
            out[pre + "attn2." + proj] = leaf(d_in, dim)
    return out


@contextlib.contextmanager
def plain_attention():
    """Route every attention to the plain PyTorch version (comparison
    only)."""
    gate = fa.use_flash
    fa.use_flash = lambda *args, **kwargs: False
    try:
        yield
    finally:
        fa.use_flash = gate


def model_phase(device, cfg, params, loras) -> None:
    g = torch.Generator(device).manual_seed(1)
    ucfg = cfg.unet
    h, w = HEIGHT // 8, WIDTH // 8

    def r(*shape):
        return torch.randn(shape, generator=g, device=device).to(ucfg.dtype)

    sample, ehs, pooled = r(7, h, w, 4), r(7, 77, ucfg.cross_attention_dim), \
        r(7, cfg.text_encoder_2.projection_dim)
    tids = sdxl.add_time_ids((HEIGHT, WIDTH), (0, 0), (HEIGHT, WIDTH),
                             device=device).expand(7, 6)
    lane_lora = stack_loras([None] * 3 + [loras[0]] * 2 + [loras[1]] * 2)
    ctl = p2p.P2PControl.build(["a photo", "a photo"], STEPS,
                               self_replace_steps=0.4, width=WIDTH // 32,
                               height=HEIGHT // 32, device=device)
    step = 16                                 # inside the window [0, 20)
    t = int(schedulers.make_schedule("euler", STEPS).timesteps[step])

    def forward():
        return params.unet(sample, t, ehs, text_embeds=pooled,
                           time_ids=tids, lora=lane_lora,
                           control=ctl.at_step(step, src_lane=0, dst_lane=2))

    fa.LAUNCHES = 0
    eps = forward()
    torch.cuda.synchronize()
    launches = fa.LAUNCHES
    with plain_attention():
        eps_plain = forward()
    torch.cuda.synchronize()
    if launches != LAUNCHES_PER_FORWARD or fa.LAUNCHES != launches:
        raise AssertionError(f"kernel launches per forward: {launches}, "
                             f"want {LAUNCHES_PER_FORWARD}")
    if not (torch.isfinite(eps).all() and torch.isfinite(eps_plain).all()):
        raise AssertionError("UNet eps not finite")
    err = (eps.float() - eps_plain.float()).abs().max().item()
    scale = eps_plain.float().abs().max().item()
    log(f"model: 7-lane UNet eps {tuple(eps.shape)} launches {launches}; "
        f"max |kernel - plain| {err:.3e}, max |eps| {scale:.3e} "
        f"(bound {MODEL_REL_BOUND} relative)")
    if err > MODEL_REL_BOUND * scale:
        raise AssertionError(f"UNet through the kernel disagrees: {err}")


@contextlib.contextmanager
def record_latents(store: dict):
    """Keep the two stages' output latents (the engine returns images)."""
    s1, s2 = multiconcept.sample_stage1_cached, \
        multiconcept.sample_stage2_resumed

    def stage1(*args, **kwargs):
        lat, cache = s1(*args, **kwargs)
        store["stage1"] = lat
        return lat, cache

    def stage2(*args, **kwargs):
        store["stage2"] = s2(*args, **kwargs)
        return store["stage2"]

    multiconcept.sample_stage1_cached = stage1
    multiconcept.sample_stage2_resumed = stage2
    try:
        yield
    finally:
        multiconcept.sample_stage1_cached = s1
        multiconcept.sample_stage2_resumed = s2


def left_right_masks(image, cls):
    """'man' owns the left half of the image, anyone else the right."""
    m = np.zeros(image.shape[:2], np.float32)
    half = image.shape[1] // 2
    if cls == "man":
        m[:, :half] = 1.0
    else:
        m[:, half:] = 1.0
    return m


def main_phase(device, cfg, params, loras) -> int:
    """Run ``OMG.generate`` once; returns the kernel launches it made."""
    tok = ToyTokenizer(cfg.text_encoder.vocab_size)
    engine = omg_lib.OMG(cfg=cfg, params=params, tokenizer=tok,
                         tokenizer_2=tok, mask_provider=left_right_masks,
                         num_steps=STEPS)
    latents: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0
    t0 = time.perf_counter()
    with record_latents(latents):
        res = engine.generate(
            "photo of the man and the woman at the beach",
            negative_prompt="ugly",
            prompt_rewrite="[photo of the man]-*-[ugly]|"
                           "[photo of the woman]-*-[ugly]",
            concept_loras=loras, seed=SEED, height=HEIGHT, width=WIDTH,
            guidance_scale=7.5, num_steps=STEPS)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = fa.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if res.stage2 is None or "stage2" not in latents:
        raise AssertionError("stage 2 did not run")
    for name, lat in latents.items():
        if tuple(lat.shape) != (2, HEIGHT // 8, WIDTH // 8, 4) or \
                not torch.isfinite(lat).all():
            raise AssertionError(f"{name} latents bad: {tuple(lat.shape)}")
    for name in ("stage1", "stage2"):
        img = getattr(res, name)
        if img.shape != (2, HEIGHT, WIDTH, 3) or img.dtype != np.uint8:
            raise AssertionError(f"{name} image bad: {img.shape} {img.dtype}")
    if launches != MAIN_PATH_LAUNCHES:
        raise AssertionError(f"kernel launches in generate: {launches}, "
                             f"want {MAIN_PATH_LAUNCHES}")
    tm = res.timings
    log(f"main: stage1 {tm['stage1']:.3f} s, masks {tm['masks']:.3f} s, "
        f"stage2 {tm['stage2']:.3f} s, decode {tm['decode']:.3f} s, "
        f"encode {tm['encode']:.3f} s, total {total:.3f} s")
    log(f"main: kernel launches {launches}; peak memory "
        f"{peak / 2**30:.2f} GiB; masks {[m is not None for m in res.masks]};"
        f" image mean {res.image.mean():.2f} std {res.image.std():.2f}")
    return launches


def main() -> int:
    device = device_phase()
    log("== build")
    build_phase()
    log("== kernel vs plain")
    kstats = kernel_phase(device)
    with torch.inference_mode():
        log("== weights")
        cfg = sdxl.sdxl_config()
        t0 = time.perf_counter()
        params = sdxl.init_params(torch.Generator(device).manual_seed(0),
                                  cfg, device)
        loras = [mid_block_lora(device, 10, cfg),
                 mid_block_lora(device, 11, cfg)]
        torch.cuda.synchronize()
        log(f"weights: {time.perf_counter() - t0:.1f} s, "
            f"{sum(p.numel() for m in params for p in m.parameters()) / 1e9:.3f}"
            " B parameters")
        log("== model")
        model_phase(device, cfg, params, loras)
        log("== main path")
        launches = main_phase(device, cfg, params, loras)
    record = {"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "omg_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "omg_tpu/ops/flash_attention.py:249",
        "launches": launches,
        "max_abs_err": kstats["max_abs_err"],
        "ms": kstats["ms"],
        "plain_ms": kstats["plain_ms"],
        "timed_at": "q/k/v [%d,%d,%d,%d] bf16" % TIMED_SHAPE}]}
    log("card:", power_line())
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
