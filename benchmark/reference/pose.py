"""Plain fp32 OMG with a spatial ControlNet (OpenPose) over checkpoint
state dicts: a UNet forward that takes prompt-to-prompt, per-lane LoRAs
and the ControlNet's residuals together, and OMG's two stages with the
ControlNet on the base rows.

Written from OMG's reference loop (kongzhecn/OMG
``src/pipelines/lora_pipeline.py``: under ``--spatial_condition`` the
ControlNet runs on the four base CFG rows of every step of both stages,
``controlnet_conditioning_scale`` times its guidance window, and its
residuals go into the UNet's skips and mid block; the concept passes of
stage 2 run without it) and diffusers' ``ControlNetModel``
(``instantid.controlnet``). The UNet is ``models.unet`` with the
residuals added after the mid block, as diffusers adds them; tensors are
NCHW and fp32, callers turn TF32 off (``pipelines.fp32_math``), ``cast``
(None or ``models.fp8``) rounds the operands of every product.

Departures from the published loop, each one of ``pipelines``' exact
identities:
  * stage 1 computes one latent copy ([uncond, cond]) where the loop
    computes both: the copies have the same latents, prompt and
    condition image, so their residuals and predictions are equal;
  * stage 2 computes copy A's cond row and copy B's two rows
    ([cond A, uncond B, cond B]), each with the ControlNet's residuals,
    and copy A's latents are stage 1's: uncond A is read by no row;
  * the concept lanes after them get zero residuals, which is the
    published concept pass (no ControlNet) written as one forward.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import instantid, models
from benchmark.reference.models import (_conv, _group_norm, _linear, _resnet,
                                        _transformer, _UNetCall, _W, sinusoid)
from benchmark.reference.pipelines import Euler, time_ids


def unet(sd: dict, u: dict, x: torch.Tensor, timestep: float,
         ctx: torch.Tensor, pooled: torch.Tensor, tids: torch.Tensor, *,
         lora: Optional[Sequence] = None, p2p: Optional[models.P2P] = None,
         residuals: Optional[tuple] = None, cast=None) -> torch.Tensor:
    """``models.unet`` with a ControlNet's (down list, mid) residuals, one
    row per lane, added to the skips and to the mid block's output."""
    w = _W(sd, cast=cast)
    b = x.shape[0]
    groups, eps = u["norm_num_groups"], u["norm_eps"]
    t = torch.full((b,), float(timestep), device=x.device)
    emb = _linear(w, "time_embedding.linear_2", F.silu(_linear(
        w, "time_embedding.linear_1",
        sinusoid(t, u["block_out_channels"][0]))))
    ids = sinusoid(tids.reshape(-1), u["addition_time_embed_dim"])
    add = torch.cat([pooled, ids.reshape(b, -1)], dim=-1)
    emb = emb + _linear(w, "add_embedding.linear_2", F.silu(_linear(
        w, "add_embedding.linear_1", add)))
    call = _UNetCall(emb, ctx, lora, p2p, u)

    h = _conv(w, "conv_in", x)
    skips = [h]
    for i in range(len(u["block_out_channels"])):
        bw = w.sub(f"down_blocks.{i}")
        for j in range(u["layers_per_block"]):
            h = _resnet(bw.sub(f"resnets.{j}"), h, emb, groups, eps)
            if bw.has(f"attentions.{j}.norm.weight"):
                h = _transformer(bw.sub(f"attentions.{j}"), h, call)
            skips.append(h)
        if bw.has("downsamplers.0.conv.weight"):
            h = _conv(bw, "downsamplers.0.conv", h, stride=2)
            skips.append(h)
    mw = w.sub("mid_block")
    h = _resnet(mw.sub("resnets.0"), h, emb, groups, eps)
    h = _transformer(mw.sub("attentions.0"), h, call)
    h = _resnet(mw.sub("resnets.1"), h, emb, groups, eps)
    if residuals is not None:
        down, mid = residuals
        skips = [s + r for s, r in zip(skips, down)]
        h = h + mid
    for i in range(len(u["block_out_channels"])):
        bw = w.sub(f"up_blocks.{i}")
        for j in range(u["layers_per_block"] + 1):
            h = torch.cat([h, skips.pop()], dim=1)
            h = _resnet(bw.sub(f"resnets.{j}"), h, emb, groups, eps)
            if bw.has(f"attentions.{j}.norm.weight"):
                h = _transformer(bw.sub(f"attentions.{j}"), h, call)
        if bw.has("upsamplers.0.conv.weight"):
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = _conv(bw, "upsamplers.0.conv", h)
    h = F.silu(_group_norm(w, "conv_norm_out", h, groups, eps))
    return _conv(w, "conv_out", h)


def keep(p: dict, i: int) -> float:
    """diffusers' ``controlnet_keep`` at step i: 1 inside the guidance
    window [start, end], else 0."""
    n = p["num_steps"]
    out = i / n < p["control_guidance_start"] or \
        (i + 1) / n > p["control_guidance_end"]
    return 0.0 if out else 1.0


def residuals(cn_sd: dict, cfg: dict, lanes: torch.Tensor, i: int,
              ctx: torch.Tensor, pooled: torch.Tensor, pose: torch.Tensor,
              cast=None) -> tuple:
    """The ControlNet on the scaled latents ``lanes`` [B, 4, h, w] at step
    i, each lane with its text context and pooled state, all on the pose
    image [1, 3, H, W] in [0, 1] -> (down list, mid), scaled."""
    p = cfg["pipeline"]
    b = lanes.shape[0]
    sched = Euler(cfg["scheduler"], p["num_steps"])
    return instantid.controlnet(
        cn_sd, cfg["controlnet"], lanes, sched.timesteps[i], ctx, pooled,
        time_ids(p["height"], p["width"], b, lanes.device),
        pose.expand(b, -1, -1, -1), p["controlnet_scale"] * keep(p, i), cast)


def cond_embedding(cn_sd: dict, pose: torch.Tensor, cast=None
                   ) -> torch.Tensor:
    """The ControlNet's conditioning embedder (``instantid.controlnet``'s
    first part) on the pose image [1, 3, H, W] in [0, 1] -> [1, C, h, w],
    what it adds to the latents' ``conv_in``."""
    ew = _W(cn_sd, cast=cast).sub("controlnet_cond_embedding")
    c = F.silu(_conv(ew, "conv_in", pose))
    j = 0
    while ew.has(f"blocks.{j}.weight"):
        c = F.silu(_conv(ew, f"blocks.{j}", c, stride=1 + j % 2))
        j += 1
    return _conv(ew, "conv_out", c)


def omg_stage1_step(models_sd: dict, cn_sd: dict, cfg: dict, cond: dict,
                    x: torch.Tensor, i: int, pose: torch.Tensor,
                    cast=None) -> tuple:
    """Stage 1, copy A's latents x [1, 4, h, w] at step i -> (guided
    prediction, x at step i + 1); ``cond``:
    ``pipelines.omg_conditioning``."""
    p = cfg["pipeline"]
    sched = Euler(cfg["scheduler"], p["num_steps"])
    xin = sched.scale(x, i).expand(2, -1, -1, -1)
    res = residuals(cn_sd, cfg, xin, i, cond["ctx2"], cond["pool2"], pose,
                    cast)
    eps = unet(models_sd["unet"], cfg["unet"], xin, sched.timesteps[i],
               cond["ctx2"], cond["pool2"],
               time_ids(p["height"], p["width"], 2, x.device),
               residuals=res, cast=cast)
    unc, c = eps.chunk(2)
    guided = unc + p["guidance_scale"] * (c - unc)
    return guided, sched.step(x, guided, i)


def omg_stage2_step(models_sd: dict, cn_sd: dict, cfg: dict, cond: dict,
                    xa: torch.Tensor, xb: torch.Tensor, i: int, *,
                    loras: Sequence[dict], masks: torch.Tensor,
                    pose: torch.Tensor, cast=None) -> tuple:
    """Stage 2 at step i (after the fusion start) from copy A's latents xa
    (stage 1's at step i) and copy B's xb -> (copy B's guided prediction,
    copy B at step i + 1): ``pipelines.omg_stage2_step`` with the
    ControlNet's residuals on the base rows [cond A, uncond B, cond B].
    loras: per concept {path: (A, B, scale)}; masks [K, h, w] of 0/1."""
    p = cfg["pipeline"]
    steps = p["num_steps"]
    sched = Euler(cfg["scheduler"], steps)
    dev = xb.device
    k = cond["concepts"]
    words = cond["ctx2"].shape[1]
    cross_end = int(p["cross_replace_steps"] * (steps + 1))
    alpha = torch.full((words,), 1.0 if i < cross_end else 0.0, device=dev)
    p2p = models.P2P(((0, 2),), alpha, torch.eye(words, device=dev),
                     0 <= i < int(steps * p["self_replace_steps"]),
                     (p["width"] // 32) * (p["height"] // 32))
    a, b = sched.scale(xa, i), sched.scale(xb, i)
    base = torch.cat([a, b, b])
    down, mid = residuals(cn_sd, cfg, base, i, cond["ctx7"][:3],
                          cond["pool7"][:3], pose, cast)

    def padded(r):
        return torch.cat([r, r.new_zeros((2 * k,) + tuple(r.shape[1:]))])
    eps = unet(models_sd["unet"], cfg["unet"],
               torch.cat([base] + [b] * (2 * k)), sched.timesteps[i],
               cond["ctx7"], cond["pool7"],
               time_ids(p["height"], p["width"], 3 + 2 * k, dev),
               lora=[None, None, None] + [lo for lo in loras
                                          for _ in range(2)],
               p2p=p2p, residuals=([padded(r) for r in down], padded(mid)),
               cast=cast)
    m = masks[:, None].float()
    union = m.sum(0) > 0
    unc = torch.where(union, 0.0, eps[1:2])
    c = torch.where(union, 0.0, eps[2:3])
    for j in range(k):
        unc = unc + torch.where(m[j] == 1, eps[3 + 2 * j:4 + 2 * j], 0.0)
        c = c + torch.where(m[j] == 1, eps[4 + 2 * j:5 + 2 * j], 0.0)
    guided = unc + p["guidance_scale"] * (c - unc)
    return guided, sched.step(xb, guided, i)


def pose_tensor(image: np.ndarray, device) -> torch.Tensor:
    """A uint8 [H, W, 3] pose image -> [1, 3, H, W] fp32 in [0, 1]."""
    return torch.as_tensor(image, dtype=torch.float32, device=device).permute(
        2, 0, 1)[None] / 255.0
