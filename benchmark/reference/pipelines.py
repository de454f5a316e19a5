"""The plain references of one step of each generation path the
benchmark times, from latents that the caller hands in: the latents the
program stepped from (or, at a loop's first step, the reference's own
start from the request's noise). Each returns the guided prediction and
the latents after the step, both fp32 NCHW.

``t2i_step``: SDXL with classifier-free guidance and the Euler discrete
scheduler, optionally with a LoRA on every lane.

``omg_stage1_step`` and ``omg_stage2_step``: OMG's two stages as its
reference loop writes them (kongzhecn/OMG
``src/pipelines/lora_pipeline.py``): copies A and B of one noise, four CFG
rows [uncond A, uncond B, cond A, cond B] under prompt-to-prompt (B's
conditional probabilities from A's); stage 1 is the loop without fusion,
stage 2 the same loop with, after ``fusion_start``, copy B's prediction
replaced inside each concept's mask by that concept's LoRA pass on copy
B (its own region prompt, [uncond, cond] rows). Two exact identities of
that loop cut the work, and only those:
  * in stage 1 the two copies have the same latents and the same prompt,
    and B's edited probabilities are A's own, so B equals A: one copy
    ([uncond, cond]) is computed;
  * A's rows never read B's, so stage 2's copy A is stage 1's trajectory:
    a stage-2 step takes copy A's latents of the same step of stage 1
    (cond A, the P2P source), and uncond A is not needed.
Everything is fp32 with TF32 off; ``cast`` rounds the operands of every
product of the text encoders and the UNet (``models.fp8``: the control).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from benchmark.reference import models


@contextlib.contextmanager
def fp32_math():
    """TF32 off for matmuls and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Euler:
    """diffusers ``EulerDiscreteScheduler`` (epsilon prediction, no
    churn) for a scheduler config."""

    def __init__(self, s: dict, steps: int):
        if s["timestep_spacing"] != "leading" or \
                s["beta_schedule"] != "scaled_linear":
            raise ValueError("the reference Euler takes leading spacing "
                             "over a scaled_linear schedule")
        n = s["num_train_timesteps"]
        betas = np.linspace(s["beta_start"] ** 0.5, s["beta_end"] ** 0.5, n,
                            dtype=np.float64) ** 2
        ac = np.cumprod(1.0 - betas)
        sig = ((1 - ac) / ac) ** 0.5
        ratio = n // steps
        ts = (np.arange(steps) * ratio).round()[::-1].astype(np.float64) + \
            s["steps_offset"]
        self.timesteps = ts
        self.sigmas = np.append(np.interp(ts, np.arange(n), sig), 0.0)
        self.init_sigma = float((self.sigmas.max() ** 2 + 1) ** 0.5)

    def scale(self, x: torch.Tensor, i: int) -> torch.Tensor:
        return x / float((self.sigmas[i] ** 2 + 1) ** 0.5)

    def step(self, x: torch.Tensor, eps: torch.Tensor, i: int) -> torch.Tensor:
        return x + eps * float(self.sigmas[i + 1] - self.sigmas[i])


def encode(models_sd: dict, cfg: dict, ids1: torch.Tensor,
           ids2: torch.Tensor, cast=None) -> tuple:
    """Token ids of both tokenizers -> (context [B, 77, 2048], pooled
    [B, 1280]): both encoders' hidden_states[-2], and encoder 2's
    projected EOS state."""
    h1, _ = models.clip_encode(models_sd["text_encoder"],
                               cfg["text_encoder"], ids1, cast)
    h2, pooled = models.clip_encode(models_sd["text_encoder_2"],
                                    cfg["text_encoder_2"], ids2, cast)
    return torch.cat([h1, h2], dim=-1), pooled


def time_ids(height: int, width: int, rows: int, device) -> torch.Tensor:
    """original size, crop (0, 0), target size."""
    return torch.tensor([[height, width, 0, 0, height, width]],
                        dtype=torch.float32, device=device).expand(rows, 6)


def lora_lanes(sd: dict, scale: float) -> dict:
    """A PEFT-layout LoRA state dict -> {module path: (A, B, scale)}."""
    out = {}
    for key, a in sd.items():
        if key.endswith(".lora_A.weight"):
            path = key[len("unet."):-len(".lora_A.weight")]
            b = sd[key.replace("lora_A", "lora_B")]
            out[path] = (a.float(), b.float(), scale * 1.0)
    return out


def decode(models_sd: dict, cfg: dict, z: torch.Tensor) -> torch.Tensor:
    """Latents [B, 4, h, w] -> images [B, H, W, 3] in [0, 1]."""
    return models.vae_decode(models_sd["vae"], cfg["vae"], z).permute(
        0, 2, 3, 1)


def t2i_conditioning(models_sd: dict, cfg: dict, ids_pos: tuple,
                      ids_neg: tuple, rows: int, cast=None) -> tuple:
    """(context, pooled, time ids) of the [uncond x rows, cond x rows]
    lanes."""
    p = cfg["pipeline"]
    ctx_p, pool_p = encode(models_sd, cfg, *ids_pos, cast)
    ctx_n, pool_n = encode(models_sd, cfg, *ids_neg, cast)
    ctx = torch.cat([ctx_n.expand(rows, -1, -1), ctx_p.expand(rows, -1, -1)])
    pooled = torch.cat([pool_n.expand(rows, -1), pool_p.expand(rows, -1)])
    return ctx, pooled, time_ids(p["height"], p["width"], 2 * rows,
                                 ctx.device)


def t2i_step(models_sd: dict, cfg: dict, cond: tuple, x: torch.Tensor,
             i: int, lora: Optional[dict], cast=None) -> tuple:
    """x [B, 4, h, w] at step i -> (guided prediction, x at step i + 1);
    ``cond``: ``t2i_conditioning`` of B rows."""
    p = cfg["pipeline"]
    sched = Euler(cfg["scheduler"], p["num_steps"])
    b = x.shape[0]
    xin = sched.scale(x, i)
    eps = models.unet(models_sd["unet"], cfg["unet"], torch.cat([xin, xin]),
                      sched.timesteps[i], *cond,
                      lora=None if lora is None else [lora] * (2 * b),
                      cast=cast)
    unc, c = eps.chunk(2)
    guided = unc + p["guidance_scale"] * (c - unc)
    return guided, sched.step(x, guided, i)


def omg_conditioning(models_sd: dict, cfg: dict, *, ids_pos: tuple,
                     ids_neg: tuple, concept_ids: Sequence[tuple],
                     cast=None) -> dict:
    """concept_ids: per concept ((pos ids1, pos ids2), (neg ids1, neg
    ids2)) -> the contexts and pooled states of stage 1's rows [uncond,
    cond] and of stage 2's [cond A, uncond B, cond B, (uncond k, cond k)
    per concept]."""
    ctx_p, pool_p = encode(models_sd, cfg, *ids_pos, cast)
    ctx_n, pool_n = encode(models_sd, cfg, *ids_neg, cast)
    concepts = []
    for pos, neg in concept_ids:
        cp, pp = encode(models_sd, cfg, *pos, cast)
        cn, pn = encode(models_sd, cfg, *neg, cast)
        concepts.append((cn, pn, cp, pp))
    return {
        "ctx2": torch.cat([ctx_n, ctx_p]), "pool2": torch.cat([pool_n, pool_p]),
        "ctx7": torch.cat([ctx_p, ctx_n, ctx_p] +
                          [c for cn, _, cp, _ in concepts for c in (cn, cp)]),
        "pool7": torch.cat([pool_p, pool_n, pool_p] +
                           [c for _, pn, _, pp in concepts
                            for c in (pn, pp)]),
        "concepts": len(concepts)}


def omg_stage1_step(models_sd: dict, cfg: dict, cond: dict,
                    x: torch.Tensor, i: int, cast=None) -> tuple:
    """Stage 1, copy A's latents x [1, 4, h, w] at step i -> (guided
    prediction, x at step i + 1)."""
    p = cfg["pipeline"]
    sched = Euler(cfg["scheduler"], p["num_steps"])
    xin = sched.scale(x, i)
    eps = models.unet(models_sd["unet"], cfg["unet"], torch.cat([xin, xin]),
                      sched.timesteps[i], cond["ctx2"], cond["pool2"],
                      time_ids(p["height"], p["width"], 2, x.device),
                      cast=cast)
    unc, c = eps.chunk(2)
    guided = unc + p["guidance_scale"] * (c - unc)
    return guided, sched.step(x, guided, i)


def omg_stage2_step(models_sd: dict, cfg: dict, cond: dict,
                    xa: torch.Tensor, xb: torch.Tensor, i: int, *,
                    loras: Sequence[dict], masks: torch.Tensor,
                    cast=None) -> tuple:
    """Stage 2 at step i (after ``fusion_start``): copy A's latents xa (stage 1's at step i) and
    copy B's xb, each [1, 4, h, w]; loras: per concept {path: (A, B,
    scale)}; masks [K, h, w] of 0/1 at latent resolution -> (copy B's
    guided prediction, copy B at step i + 1)."""
    p = cfg["pipeline"]
    steps = p["num_steps"]
    sched = Euler(cfg["scheduler"], steps)
    dev = xb.device
    k = cond["concepts"]
    words = cond["ctx2"].shape[1]
    # cross_replace_steps over the whole run on equal prompts: the
    # replacement mapper is the identity and alpha is 1 on every step
    # before int(cross_replace_steps * (steps + 1))
    cross_end = int(p["cross_replace_steps"] * (steps + 1))
    alpha = torch.full((words,), 1.0 if i < cross_end else 0.0, device=dev)
    p2p = models.P2P(((0, 2),), alpha, torch.eye(words, device=dev),
                     0 <= i < int(steps * p["self_replace_steps"]),
                     (p["width"] // 32) * (p["height"] // 32))
    a, b = sched.scale(xa, i), sched.scale(xb, i)
    eps = models.unet(models_sd["unet"], cfg["unet"],
                      torch.cat([a, b, b] + [b] * (2 * k)),
                      sched.timesteps[i], cond["ctx7"], cond["pool7"],
                      time_ids(p["height"], p["width"], 3 + 2 * k, dev),
                      lora=[None, None, None] + [lo for lo in loras
                                                 for _ in range(2)],
                      p2p=p2p, cast=cast)
    m = masks[:, None].float()                              # [K, 1, h, w]
    union = (m.sum(0) > 0)
    unc = torch.where(union, 0.0, eps[1:2])
    c = torch.where(union, 0.0, eps[2:3])
    for j in range(k):
        unc = unc + torch.where(m[j] == 1, eps[3 + 2 * j:4 + 2 * j], 0.0)
        c = c + torch.where(m[j] == 1, eps[4 + 2 * j:5 + 2 * j], 0.0)
    guided = unc + p["guidance_scale"] * (c - unc)
    return guided, sched.step(xb, guided, i)
