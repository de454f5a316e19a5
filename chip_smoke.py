"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure propagates and the exit code is non-zero:
  1. device  — a CUDA device must be present (no CPU run); prints its
     name, count, nvidia-smi name and power limit; turns TF32 off for
     matmuls and cuDNN so the fp32 VAE decode is fp32.
  2. build   — compiles the flash-attention kernel from
     omg_tpu_torch/ops/csrc with nvcc; prints seconds and, for every
     instantiation (head dim, query rows per CTA), ptxas's registers and
     spills.
  3. kernel  — K1 vs its plain PyTorch version on seeded bf16 inputs
     at the UNet's self-attention shapes; for every shape the error
     bound, kernel / plain / SDPA (the library yardstick, never called by
     the port) ms per call, the bound (the larger of FLOPs over the bf16
     peak and bytes over the memory rate) and the kernel's share of it;
     then the host time per launch and the part of it that encodes the
     tensor maps.
  3b. seq    — K1b (the kernel on one sequence shard's query rows against
     the whole K/V) vs the plain version at the shapes of 2- and 4-way
     sequence splits, data-split lanes and the 1216x832 bucket, with the
     same columns.
  4. model   — one SDXL-width UNet forward at the 7-lane stage-2 layout
     (P2P inside its self-replace window, stacked LoRA lanes) through the
     kernel and with attention forced to the plain version; 70 launches.
  5. main    — ``OMG.generate`` at SDXL widths, 1024x1024, 50 Euler steps,
     two concepts with rank-32 LoRAs, random weights from a seed;
     5880 kernel launches, finite latents, stage times, peak memory.
  6. mesh    — the multi-device latency mode, ``OMG(mesh=...)``, on 2 ranks
     that share this card through ``gloo`` (mesh data=1, model=2): the
     same seeded weights on both (checked), one H-split stage-1 UNet
     forward and one lane-split 8-lane stage-2 forward against the
     unsharded ones, then ``generate`` as in phase 5: 3500 K1b and 2380
     K1 launches per rank, identical images on both ranks.
The last two lines are a JSON record of the kernels and
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --profile

runs phases 1 and 2, then profiles one stage-1 UNet forward (2 lanes)
and one stage-2 forward (7 lanes, LoRA lanes, P2P) with
``torch.profiler``: wall time, kernel time, K1's share, the device's
idle share, host microseconds per K1 launch and the largest kernels.
"""

from __future__ import annotations

import contextlib
import gc
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from omg_tpu_torch import lora as lora_lib
from omg_tpu_torch.control import p2p
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.ops import flash_attention as fa
from omg_tpu_torch.parallel import comm, launch, mesh as mesh_lib
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
# The step of the forward checks: inside the self-replace window [0, 20).
P2P_STEP = 16
# The mesh phase: 2 ranks on this card, (data, model) = (1, 2). Stage 1
# runs H-split, so every self-attention is K1b (50 steps x 70); stage 2
# runs the 4+2K = 8 lanes 4 per rank, K1 on each (34 steps x 70).
MESH_RANKS = 2
MESH_SEQ_LAUNCHES = STEPS * LAUNCHES_PER_FORWARD
MESH_LAUNCHES = (STEPS - 16) * LAUNCHES_PER_FORWARD
MESH_TIMEOUT_S = 900

# Kernel vs plain, bf16 in and out: bf16 keeps 8 mantissa bits. The
# kernel rounds the unnormalized probabilities to bf16 before P.V and
# both sides round O, so they may differ by a few ulps of the output's
# scale: 4 * 2^-8 of max(|o|, 1).
KERNEL_ULPS = 4 * 2.0 ** -8
# UNet eps through the kernel vs through the plain path: the two round
# attention at different points, and 70 residual transformer blocks of
# bf16 activations carry that forward: 5% of max |eps|.
MODEL_REL_BOUND = 0.05

# The H100 SXM's published dense bf16 rate and memory rate (the bound's
# denominators; the card's power limit is printed beside every time).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

KERNEL_SHAPES = [  # (B, H, N, D): main-path, bucket, D=128, ragged tiles
    (2, 10, 4096, 64), (7, 10, 4096, 64), (2, 20, 1024, 64),
    (7, 20, 1024, 64), (2, 10, 3952, 64), (2, 20, 988, 64),
    (2, 20, 960, 64), (2, 20, 1008, 64), (2, 10, 3840, 64),
    (2, 10, 1024, 128), (2, 20, 1088, 64), (2, 20, 1025, 64)]
TIMED_SHAPE = (7, 10, 4096, 64)
SEQ_SHAPES = [  # (B, H, Nq local, Nk): q rows of a shard against all K/V
    (2, 10, 2048, 4096), (2, 20, 512, 1024),     # 2-way seq at 1024^2
    (2, 10, 1024, 4096), (2, 20, 256, 1024),     # 4-way seq
    (1, 10, 2048, 4096),                         # data-split lanes
    (2, 10, 1976, 3952), (2, 20, 494, 988)]      # the 1216x832 bucket
SEQ_TIMED_SHAPE = (2, 10, 2048, 4096)            # the mesh phase's level 1


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


def ptxas_usage(text: str) -> list:
    """(D, rows per CTA, registers, spill store bytes, spill load bytes)
    of every kernel instantiation in ptxas's -v report."""
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function .*flash_fwd_kernelILi(\d+)ELi(\d+)E",
                      line)
        if m:
            cur = [int(m.group(1)), 64 * int(m.group(2)), None, None, None]
            out.append(cur)
        elif cur is not None and "spill stores" in line:
            cur[3], cur[4] = (int(x) for x in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
        elif cur is not None and "Used" in line and "registers" in line:
            cur[2] = int(re.search(r"Used (\d+) registers", line).group(1))
    return [tuple(r) for r in out]


def build_phase() -> None:
    fa.build()
    log(f"build: {fa.BUILD_INFO['seconds']:.2f} s -> {fa.BUILD_INFO['path']}")
    usage = ptxas_usage(fa.BUILD_INFO["log"])
    if not usage and fa.BUILD_INFO["log"] != "(cached build)":
        raise AssertionError("no ptxas report for the kernel")
    for d, rows, regs, st, ld in usage:
        log(f"  ptxas: D={d}, {rows} query rows per CTA: {regs} registers at "
            f"entry, {st} bytes spill stores, {ld} bytes spill loads")
    for line in fa.BUILD_INFO["log"].splitlines():
        if "(C75" in line:
            log("  ptxas:", line.strip())


def cuda_ms(fn, iters: int, graph: bool = False) -> float:
    """Device ms per call of ``fn`` after a warm-up, by CUDA events around
    ``iters`` calls; with ``graph`` the calls are captured in one CUDA graph
    and replayed, so the host's launch cost does not hide a short kernel."""
    fn()
    torch.cuda.synchronize()
    calls = [fn] * iters
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for call in calls:
                call()
        calls = [g.replay]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for call in calls:
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def roofline(q, k) -> tuple:
    """(bound ms, "operations" or "bytes") of attention on q/k/v: 4 B H
    Nq Nk D flops over the bf16 peak against q, k, v read once and o
    written once over the memory rate."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    flops = 4 * b * h * nq * nk * d
    nbytes = q.element_size() * b * h * d * (2 * nq + 2 * nk)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _check_kernel(kernel, name, q, k, v) -> dict:
    """The kernel against the plain version on q/k/v, and its times beside
    the plain version's, SDPA's and the bound; raises on NaN or an error
    past the bound."""
    out = kernel(q, k, v)
    ref = fa.flash_attention_ref(q, k, v).float()
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name} output not finite")
    err = (out.float() - ref).abs().max().item()
    bound = KERNEL_ULPS * max(ref.abs().max().item(), 1.0)
    ms = cuda_ms(lambda: kernel(q, k, v), 50, graph=True)
    plain_ms = cuda_ms(lambda: fa.flash_attention_ref(q, k, v), 5)
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 50,
        graph=True)
    bound_ms, bound_by = roofline(q, k)
    log(f"  {name} max_abs_err {err:.3e} (bound {bound:.3e})  kernel "
        f"{ms:.4f} ms  plain {plain_ms:.3f} ms  sdpa {library_ms:.4f} ms  "
        f"bound {bound_ms:.4f} ms ({bound_by})  share "
        f"{100 * bound_ms / ms:.1f}%  sdpa/kernel {library_ms / ms:.2f}")
    if err > bound:
        raise AssertionError(f"{name} disagrees: {err} > {bound}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms}


def host_cost(device) -> None:
    """Host microseconds per launch at [2,20,1024,64] (stage 1's level-2
    shape; stage 1 is host-bound): the whole wrapper, and the part of it
    that encodes the three tensor maps."""
    q, k, v = (torch.randn(2, 20, 1024, 64, device=device,
                           dtype=torch.bfloat16) for _ in range(3))
    n = 200
    fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fa.flash_attention(q, k, v)
    wrapper_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    lib = fa.build()
    plan = fa.launch_plan(2, 20, 1024, 1024, 64, (q.stride(),) * 4,
                          torch.cuda.get_device_properties(device)
                          .multi_processor_count).pack()
    t0 = time.perf_counter()
    for _ in range(n):
        err = lib.omg_flash_attention_encode(q.data_ptr(), k.data_ptr(),
                                             v.data_ptr(), plan)
        if err:
            raise AssertionError(f"tensor-map encode failed: {err}")
    encode_us = (time.perf_counter() - t0) / n * 1e6
    log(f"host: {wrapper_us:.1f} us per launch through the wrapper, "
        f"{encode_us:.1f} us of it encoding the three tensor maps")


def kernel_phase(device) -> dict:
    """The timed shape's numbers, with the worst error of all shapes."""
    g = torch.Generator(device).manual_seed(0)
    worst, timed = 0.0, None
    for b, h, n, d in KERNEL_SHAPES:
        q, k, v = (torch.randn(b, h, n, d, generator=g, device=device,
                               dtype=torch.bfloat16) for _ in range(3))
        res = _check_kernel(fa.flash_attention, f"[{b},{h},{n},{d}]", q, k, v)
        worst = max(worst, res["max_abs_err"])
        if (b, h, n, d) == TIMED_SHAPE:
            timed = res
        del q, k, v
    host_cost(device)
    return dict(timed, max_abs_err=worst)


def seq_kernel_phase(device) -> dict:
    """K1b: the wrapper ``flash_attention_seq_local`` on gathered K/V."""
    g = torch.Generator(device).manual_seed(3)
    worst, timed = 0.0, None
    for b, h, nq, nk in SEQ_SHAPES:
        q, k, v = (torch.randn(b, h, n, 64, generator=g, device=device,
                               dtype=torch.bfloat16) for n in (nq, nk, nk))
        res = _check_kernel(fa.flash_attention_seq_local,
                            f"q [{b},{h},{nq},64] kv {nk}", q, k, v)
        worst = max(worst, res["max_abs_err"])
        if (b, h, nq, nk) == SEQ_TIMED_SHAPE:
            timed = res
        del q, k, v
    return dict(timed, max_abs_err=worst)


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


def unet_inputs(device, cfg, b: int, seed: int) -> tuple:
    """Seeded UNet inputs at 1024x1024: (sample, ehs, pooled, time ids)."""
    g = torch.Generator(device).manual_seed(seed)
    ucfg = cfg.unet
    h, w = HEIGHT // 8, WIDTH // 8

    def r(*shape):
        return torch.randn(shape, generator=g, device=device).to(ucfg.dtype)

    sample, ehs, pooled = r(b, h, w, 4), r(b, 77, ucfg.cross_attention_dim), \
        r(b, cfg.text_encoder_2.projection_dim)
    tids = sdxl.add_time_ids((HEIGHT, WIDTH), (0, 0), (HEIGHT, WIDTH),
                             device=device).expand(b, 6)
    return sample, ehs, pooled, tids


def compare_eps(name: str, eps, eps_ref) -> float:
    """Max |eps - eps_ref|; raises past MODEL_REL_BOUND of max |eps_ref|
    or on a non-finite value."""
    if not (torch.isfinite(eps).all() and torch.isfinite(eps_ref).all()):
        raise AssertionError(f"{name}: UNet eps not finite")
    err = (eps.float() - eps_ref.float()).abs().max().item()
    scale = eps_ref.float().abs().max().item()
    log(f"{name}: eps {tuple(eps.shape)} max |diff| {err:.3e}, max |eps| "
        f"{scale:.3e} (bound {MODEL_REL_BOUND} relative)")
    if err > MODEL_REL_BOUND * scale:
        raise AssertionError(f"{name} disagrees: {err}")
    return err


def model_phase(device, cfg, params, loras) -> None:
    sample, ehs, pooled, tids = unet_inputs(device, cfg, 7, seed=1)
    lane_lora = lora_lib.stack_loras(
        [None] * 3 + [loras[0]] * 2 + [loras[1]] * 2)
    ctl = p2p.P2PControl.build(["a photo", "a photo"], STEPS,
                               self_replace_steps=0.4, width=WIDTH // 32,
                               height=HEIGHT // 32, device=device)
    step = P2P_STEP
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
    log(f"model: 7-lane UNet, {launches} launches")
    compare_eps("model: kernel vs plain", eps, eps_plain)


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


def generate(engine, loras):
    return engine.generate(
        "photo of the man and the woman at the beach",
        negative_prompt="ugly",
        prompt_rewrite="[photo of the man]-*-[ugly]|"
                       "[photo of the woman]-*-[ugly]",
        concept_loras=loras, seed=SEED, height=HEIGHT, width=WIDTH,
        guidance_scale=7.5, num_steps=STEPS)


def check_result(res, latents: dict) -> None:
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


def main_phase(device, cfg, params, loras) -> tuple:
    """Run ``OMG.generate`` once; returns (kernel launches, result)."""
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
        res = generate(engine, loras)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = fa.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    check_result(res, latents)
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
    return launches, res


def weights(device):
    """SDXL at full width with random weights from seed 0, and the two
    rank-32 concept LoRAs (seeds 10, 11)."""
    cfg = sdxl.sdxl_config()
    t0 = time.perf_counter()
    params = sdxl.init_params(torch.Generator(device).manual_seed(0), cfg,
                              device)
    loras = [mid_block_lora(device, 10, cfg), mid_block_lora(device, 11, cfg)]
    torch.cuda.synchronize()
    log(f"weights: {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for m in params for p in m.parameters()) / 1e9:.3f}"
        " B parameters")
    return cfg, params, loras


def single_card_phases(device) -> tuple:
    """Phases 4 and 5; the weights are freed on return."""
    with torch.inference_mode():
        log("== weights")
        cfg, params, loras = weights(device)
        log("== model")
        model_phase(device, cfg, params, loras)
        log("== main path")
        return main_phase(device, cfg, params, loras)


# ------------------------------------------------------------ --profile

def _profile_forward(name: str, forward) -> None:
    from torch.profiler import ProfilerActivity, profile
    forward()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = sorted(walls)[1] * 1e3
    # host time inside the wrapper, per K1 launch (a run of its own)
    launch, host = fa._launch, [0.0, 0]

    def timed_launch(*args, **kwargs):
        t0 = time.perf_counter()
        out = launch(*args, **kwargs)
        host[0] += time.perf_counter() - t0
        host[1] += 1
        return out

    fa._launch = timed_launch
    try:
        forward()
        torch.cuda.synchronize()
    finally:
        fa._launch = launch
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    kernels: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = "K1 flash_fwd_kernel" if "flash_fwd_kernel" in e.name \
                else e.name[:60]
            kernels[key] = kernels.get(key, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(kernels.values()) / 1e3
    if busy_ms == 0:
        log(f"profile {name}: wall {wall_ms:.1f} ms; the profiler saw no "
            "device time (not measured)")
        return
    k1_ms = kernels.get("K1 flash_fwd_kernel", 0.0) / 1e3
    log(f"profile {name}: wall {wall_ms:.1f} ms, kernels {busy_ms:.1f} ms "
        f"(idle {100 * (1 - busy_ms / wall_ms):.1f}%), K1 {k1_ms:.2f} ms "
        f"({100 * k1_ms / busy_ms:.1f}% of kernel time), host "
        f"{host[0] / max(host[1], 1) * 1e6:.1f} us per K1 launch over "
        f"{host[1]} launches")
    for key, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {us / 1e3:8.2f} ms  {100 * us / 1e3 / busy_ms:5.1f}%  {key}")


def profile_phase(device) -> None:
    with torch.inference_mode():
        cfg, params, loras = weights(device)
        t = int(schedulers.make_schedule("euler", STEPS).timesteps[0])
        s1 = unet_inputs(device, cfg, 2, seed=2)
        _profile_forward("stage 1 (2 lanes)", lambda: params.unet(
            s1[0], t, s1[1], text_embeds=s1[2], time_ids=s1[3]))
        s2 = unet_inputs(device, cfg, 7, seed=1)
        lane_lora = lora_lib.stack_loras(
            [None] * 3 + [loras[0]] * 2 + [loras[1]] * 2)
        ctl = p2p.P2PControl.build(["a photo", "a photo"], STEPS,
                                   self_replace_steps=0.4, width=WIDTH // 32,
                                   height=HEIGHT // 32, device=device)
        t2 = int(schedulers.make_schedule("euler", STEPS).timesteps[P2P_STEP])
        _profile_forward("stage 2 (7 lanes)", lambda: params.unet(
            s2[0], t2, s2[1], text_embeds=s2[2], time_ids=s2[3],
            lora=lane_lora, control=ctl.at_step(P2P_STEP, src_lane=0,
                                                dst_lane=2)))


# --------------------------------------------------------------- phase 6

def _lora_checksum(loras) -> torch.Tensor:
    return torch.stack([leaf[r].double().sum() for tree in loras
                        for _, leaf in sorted(tree.items())
                        for r in ("down", "up", "scale")])


def spatial_forward(mesh, cfg, params) -> dict:
    """One stage-1 UNet forward at b=2, H split over the model axis: 70 K1b
    launches; rank 0 holds it against the unsharded forward (K1)."""
    sample, ehs, pooled, tids = unet_inputs(mesh.device, cfg, 2, seed=2)
    t = int(schedulers.make_schedule("euler", STEPS).timesteps[0])
    seq = mesh.model_group
    rows = sample.shape[1] // seq.size
    fa.SEQ_LAUNCHES = 0
    eps = params.unet(sample[:, seq.index * rows:(seq.index + 1) * rows], t,
                      ehs, text_embeds=pooled, time_ids=tids, seq_group=seq)
    torch.cuda.synchronize()
    launches = fa.SEQ_LAUNCHES
    if launches != LAUNCHES_PER_FORWARD:
        raise AssertionError(f"K1b launches per H-split forward: {launches}, "
                             f"want {LAUNCHES_PER_FORWARD}")
    eps = comm.all_gather(eps, 1, seq)
    out = {"launches": launches}
    if mesh.rank == 0:
        out["err"] = compare_eps(
            "mesh: H-split stage-1 forward vs unsharded", eps,
            params.unet(sample, t, ehs, text_embeds=pooled, time_ids=tids))
    return out


def lane_forward(mesh, cfg, params, loras) -> dict:
    """One stage-2 UNet forward on the 4+2K = 8 lanes split over all ranks
    (P2P inside its self-replace window, stacked LoRA lanes): 70 K1
    launches per rank; rank 0 holds it against the unsharded forward."""
    sample, ehs, pooled, tids = unet_inputs(mesh.device, cfg, 8, seed=3)
    lane_lora = lora_lib.stack_loras(
        [None] * 4 + [loras[0]] * 2 + [loras[1]] * 2)
    ctl = p2p.P2PControl.build(["a photo", "a photo"], STEPS,
                               self_replace_steps=0.4, width=WIDTH // 32,
                               height=HEIGHT // 32, device=mesh.device)
    step = P2P_STEP
    t = int(schedulers.make_schedule("euler", STEPS).timesteps[step])
    lanes = mesh_lib.Split(8, mesh.flat)
    lo, hi = lanes.lo, lanes.hi
    fa.LAUNCHES = 0
    eps = params.unet(sample[lo:hi], t, ehs[lo:hi], text_embeds=pooled[lo:hi],
                      time_ids=tids[lo:hi],
                      lora=lora_lib.lane_slice(lane_lora, lo, hi),
                      control=ctl.at_step(step, lanes=lanes))
    torch.cuda.synchronize()
    launches = fa.LAUNCHES
    if launches != LAUNCHES_PER_FORWARD:
        raise AssertionError(f"K1 launches per lane-split forward: "
                             f"{launches}, want {LAUNCHES_PER_FORWARD}")
    eps = comm.all_gather(eps, 0, mesh.flat, sizes=lanes.sizes)
    out = {"launches": launches}
    if mesh.rank == 0:
        out["err"] = compare_eps(
            "mesh: lane-split 8-lane stage-2 forward vs unsharded", eps,
            params.unet(sample, t, ehs, text_embeds=pooled, time_ids=tids,
                        lora=lane_lora, control=ctl.at_step(step)))
    return out


def mesh_generate(mesh, cfg, params, loras) -> dict:
    """``OMG(mesh=...).generate`` as phase 5 runs it, counts zeroed just
    before and read just after."""
    tok = ToyTokenizer(cfg.text_encoder.vocab_size)
    engine = omg_lib.OMG(cfg=cfg, params=params, tokenizer=tok,
                         tokenizer_2=tok, mask_provider=left_right_masks,
                         num_steps=STEPS, mesh=mesh)
    latents: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(mesh.device)
    fa.LAUNCHES = fa.SEQ_LAUNCHES = 0
    t0 = time.perf_counter()
    with record_latents(latents):
        res = generate(engine, loras)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    seq_launches, launches = fa.SEQ_LAUNCHES, fa.LAUNCHES
    check_result(res, latents)
    if (seq_launches, launches) != (MESH_SEQ_LAUNCHES, MESH_LAUNCHES):
        raise AssertionError(
            f"rank {mesh.rank}: K1b/K1 launches in generate {seq_launches}/"
            f"{launches}, want {MESH_SEQ_LAUNCHES}/{MESH_LAUNCHES}")
    return {"stage1": res.stage1, "stage2": res.stage2,
            "timings": res.timings, "total": total,
            "peak": torch.cuda.max_memory_allocated(mesh.device),
            "seq_launches": seq_launches, "launches": launches}


def mesh_rank(rank: int, device) -> dict:
    """One rank of phase 6 (``launch.spawn`` runs it in its own process)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.build()
    mesh = mesh_lib.make_mesh(MESH_RANKS, data=1, model=MESH_RANKS,
                              device=device)
    with torch.inference_mode():
        cfg, params, loras = weights(device)
        mesh_lib.replicated(mesh, *params)
        sums = comm.all_gather(_lora_checksum(loras)[None], 0, mesh.flat)
        if not all(torch.equal(sums[0], row) for row in sums):
            raise AssertionError("the concept LoRAs differ between ranks")
        out = {"spatial": spatial_forward(mesh, cfg, params),
               "lanes": lane_forward(mesh, cfg, params, loras)}
        out.update(mesh_generate(mesh, cfg, params, loras))
    return out


def mesh_phase(single) -> dict:
    t0 = time.perf_counter()
    ranks = launch.spawn(mesh_rank, MESH_RANKS, backend="gloo",
                         devices=["cuda:0"] * MESH_RANKS,
                         timeout=MESH_TIMEOUT_S)
    log(f"mesh: {MESH_RANKS} ranks on cuda:0, backend gloo (collectives "
        f"staged through host memory); {time.perf_counter() - t0:.1f} s "
        "wall for the phase, rank start-up and weights included")
    for r, out in enumerate(ranks):
        tm = out["timings"]
        log(f"mesh rank {r}: stage1 {tm['stage1']:.3f} s, masks "
            f"{tm['masks']:.3f} s, stage2 {tm['stage2']:.3f} s, decode "
            f"{tm['decode']:.3f} s, encode {tm['encode']:.3f} s, total "
            f"{out['total']:.3f} s; peak memory {out['peak'] / 2**30:.2f} "
            f"GiB; K1b launches {out['seq_launches']}, K1 launches "
            f"{out['launches']}")
        for name in ("stage1", "stage2"):
            if not np.array_equal(out[name], ranks[0][name]):
                raise AssertionError(f"mesh: rank {r}'s {name} images differ "
                                     "from rank 0's")
    for name in ("stage1", "stage2"):
        diff = np.abs(ranks[0][name].astype(int)
                      - getattr(single, name).astype(int))
        log(f"mesh: {name} images vs phase 5: max |diff| {diff.max()}, mean "
            f"{diff.mean():.3f} (uint8; the 4+2K program and the split "
            "reductions round differently)")
    return {"seq_launches": [out["seq_launches"] for out in ranks],
            "launches": [out["launches"] for out in ranks]}


def main() -> int:
    device = device_phase()
    log("== build")
    build_phase()
    if "--profile" in sys.argv[1:]:
        log("== profile")
        profile_phase(device)
        return 0
    log("== kernel vs plain")
    kstats = kernel_phase(device)
    log("== K1b vs plain")
    sstats = seq_kernel_phase(device)
    launches, single = single_card_phases(device)
    gc.collect()
    torch.cuda.empty_cache()
    log("== mesh")
    mstats = mesh_phase(single)
    source = "omg_tpu_torch/ops/csrc/flash_attention.cu"
    timed = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "bound_share")
    record = {"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": source,
        "replaces": "omg_tpu/ops/flash_attention.py:249",
        "launches": launches,
        **{key: kstats[key] for key in timed},
        "timed_at": "q/k/v [%d,%d,%d,%d] bf16" % TIMED_SHAPE,
        "mesh_launches_by_rank": mstats["launches"]}, {
        "name": "flash_attention_fwd_seq_local",
        "route": "cuda",
        "source": source,
        "replaces": "omg_tpu/ops/flash_attention.py:108-126 via :249",
        "launches": mstats["seq_launches"][0],
        "launches_by_rank": mstats["seq_launches"],
        **{key: sstats[key] for key in timed},
        "timed_at": "q [%d,%d,%d,64] against k/v of %d, bf16"
                    % SEQ_TIMED_SHAPE}]}
    log("card:", power_line())
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
