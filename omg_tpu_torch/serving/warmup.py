"""Serving warmup (port of ``omg_tpu/serving/warmup.py``).

The JAX module compiles the serving programs ahead of time. Torch
compiles nothing ahead of time, so here warmup does the work a first
request would otherwise pay: it builds K1 (nvcc, on first use) and runs
one UNet forward at every lane count serving uses, stage 1's 2 and stage
2's 3+2K lanes per bucket and concept count K, and 2R and R(3+2K) for
each batch width R, with the concept lanes' LoRA, the stage-2 P2P edits
and, given the IP layers, the InstantID branch, so the allocator and the
library's kernel choices are warm. Given the VAE it decodes once per
bucket. It logs the seconds of each program and returns their count.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from omg_tpu_torch import lora as lora_lib
from omg_tpu_torch.control import p2p
from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.ops import flash_attention as fa
from omg_tpu_torch.pipelines import multiconcept, sdxl
from omg_tpu_torch.serving.conditions import RESOLUTIONS


def _unet_forward(cfg: sdxl.SDXLConfig, unet, sched, *, height: int,
                  width: int, lanes: int, stage2: Optional[tuple],
                  sample_lora: Optional[dict], ip_layers, ip_tokens: int,
                  ip_scale: float) -> None:
    """One forward on zero inputs. ``stage2``: (R, K) for the stage-2
    layout (R requests of 3 + 2K lanes: the LoRA on the concept lanes,
    each request's P2P pair, the IP tokens), None for stage 1."""
    u = cfg.unet
    device = unet.conv_in.weight.device
    pdim = cfg.text_encoder_2.projection_dim or cfg.text_encoder_2.hidden_size

    def zeros(*shape):
        return torch.zeros(shape, dtype=u.dtype, device=device)
    kw = {}
    if stage2 is not None:
        R, K = stage2
        L = 3 + 2 * K
        ctl = p2p.P2PControl.build(["x", "x"], sched.num_steps,
                                   width=width // 32, height=height // 32,
                                   device=device)
        kw["control"] = ctl.at_step(0, pairs=[(r * L, r * L + 2)
                                              for r in range(R)])
        if sample_lora is not None:
            kw["lora"] = lora_lib.stack_loras(
                ([None] * 3 + [sample_lora] * (2 * K)) * R)
        if ip_layers is not None:
            kw.update(ip_adapter=ip_layers, ip_scale=ip_scale,
                      ip_context=zeros(lanes, ip_tokens,
                                       u.cross_attention_dim))
    tids = sdxl.add_time_ids((height, width), (0, 0), (height, width),
                             device=device).expand(lanes, 6)
    unet(zeros(lanes, height // 8, width // 8, 4), int(sched.timesteps[0]),
         zeros(lanes, 77, u.cross_attention_dim),
         text_embeds=zeros(lanes, pdim), time_ids=tids, **kw)


def warmup(cfg: sdxl.SDXLConfig, *, unet_params, steps: int = 50,
           buckets: Sequence = ((1024, 1024),),
           concept_counts: Sequence[int] = (2,),
           scheduler: str = "euler",
           fusion_fraction: float = 0.3,
           sample_lora: Optional[dict] = None,
           sample_ip_adapter: Optional[list] = None,
           ip_tokens: int = 16,
           ip_scale: float = 0.8,
           vae_params=None,
           cache_interval: int = 0,
           cache_schedule: str = "uniform",
           batch_sizes: Sequence[int] = (),
           log=print) -> int:
    """Run the serving programs once for each bucket and concept count.

    ``unet_params``: the engine's UNet (``params.unet``). ``sample_lora``:
    a concept adapter (the UNet part), put on the concept lanes.
    ``sample_ip_adapter``: the InstantID IP layers, run with zero tokens.
    ``vae_params``: the VAE, decoded once per bucket. ``batch_sizes``:
    the server's batch widths (1 runs the single programs only).
    ``fusion_fraction`` is the JAX signature's; the forwards do not
    depend on it. DeepCache (``cache_interval`` > 1 or a ``front``
    schedule) is not ported and raises. Returns the number of programs
    run."""
    del fusion_fraction
    if cache_interval > 1 or cache_schedule != "uniform":
        raise multiconcept.not_ported("DeepCache", "approximate modes")
    sched = schedulers.make_schedule(scheduler, steps)
    device = unet_params.conv_in.weight.device
    if device.type == "cuda":
        t0 = time.perf_counter()
        fa.build()
        log(f"warmup: K1 built in {time.perf_counter() - t0:.1f} s")
    n = 0
    with torch.inference_mode():
        for height, width in buckets:
            programs = [(f"stage 1 ({2 * r} lanes)", 2 * r, None)
                        for r in [1] + [b for b in batch_sizes if b > 1]]
            for K in concept_counts:
                programs += [(f"stage 2 K={K} ({r * (3 + 2 * K)} lanes)",
                              r * (3 + 2 * K), (r, K))
                             for r in [1] + [b for b in batch_sizes if b > 1]]
            for name, lanes, stage2 in programs:
                t0 = time.perf_counter()
                _unet_forward(cfg, unet_params, sched, height=height,
                              width=width, lanes=lanes, stage2=stage2,
                              sample_lora=sample_lora,
                              ip_layers=sample_ip_adapter,
                              ip_tokens=ip_tokens, ip_scale=ip_scale)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                log(f"warmup {height}x{width} {name}: "
                    f"{time.perf_counter() - t0:.2f} s")
                n += 1
            if vae_params is not None:
                t0 = time.perf_counter()
                sdxl.decode_latents(cfg, vae_params, torch.zeros(
                    (2, height // 8, width // 8, 4), dtype=cfg.unet.dtype,
                    device=device))
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                log(f"warmup {height}x{width} decode: "
                    f"{time.perf_counter() - t0:.2f} s")
                n += 1
    return n


def default_serving_warmup(cfg, *, unet_params, steps: int = 50,
                           scheduler: str = "euler",
                           sample_lora: Optional[dict] = None,
                           sample_ip_adapter: Optional[list] = None,
                           vae_params=None, cache_interval: int = 0,
                           cache_schedule: str = "uniform",
                           max_batch: int = 0,
                           log=print) -> int:
    """All nine buckets, one and two concepts, and the server's batch
    width ``max_batch`` (pass ``server.max_batch``)."""
    return warmup(cfg, unet_params=unet_params, steps=steps,
                  buckets=RESOLUTIONS, concept_counts=(1, 2),
                  scheduler=scheduler, sample_lora=sample_lora,
                  sample_ip_adapter=sample_ip_adapter,
                  vae_params=vae_params, cache_interval=cache_interval,
                  cache_schedule=cache_schedule,
                  batch_sizes=((max_batch,) if max_batch > 1 else ()),
                  log=log)
