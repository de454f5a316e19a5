"""The comparisons that decide ``correct``, shared by the entries."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import weights
from benchmark.reference import pipelines as ref


def models_fp32(ctx) -> dict:
    """The seed's weights drawn again, as fp32 state dicts."""
    sds = weights.model_state_dicts(ctx.cfg, ctx.seed, ctx.device)
    return {m: {k: v.float() for k, v in sd.items()} for m, sd in sds.items()}


def nchw(t: torch.Tensor) -> torch.Tensor:
    """The program's NHWC latents or predictions as fp32 NCHW."""
    return t.float().permute(0, 3, 1, 2)


def eps_gap(prog: torch.Tensor, want: torch.Tensor) -> float:
    """Worst row's mean |program - reference| over mean |reference| of a
    step's guided prediction; a prediction of another shape is infinitely
    far."""
    if prog.shape != want.shape:
        return math.inf
    d = (prog - want).abs().flatten(1).mean(1)
    return float((d / want.abs().flatten(1).mean(1)).max())


def step_gap(prog: torch.Tensor, x: torch.Tensor, want: torch.Tensor) -> float:
    """Worst row's mean |program - reference| of the latents after a step
    from ``x``, over the mean size of the reference's step; latents of
    another shape are infinitely far."""
    if prog.shape != want.shape:
        return math.inf
    d = (prog - want).abs().flatten(1).mean(1)
    return float((d / (want - x).abs().flatten(1).mean(1)).max())


def decode_gap(images, latents: torch.Tensor, sds: dict, cfg: dict) -> float:
    """Worst image's mean |program image - reference decode of
    ``latents``| in uint8 levels, ``latents`` [B, 4, h, w] being those the
    program's last step returned: uint8 images are held to the reference
    truncated to levels as the program truncates, float images in [0, 1]
    to the reference scaled by 255."""
    with ref.fp32_math():
        want = ref.decode(sds, cfg, latents)
    if isinstance(images, np.ndarray) and images.dtype == np.uint8:
        want = (want * 255).to(torch.uint8).float()
        prog = torch.as_tensor(images, device=want.device).float()
    else:
        want = want * 255
        prog = torch.as_tensor(images).to(want.device).float() * 255
    if prog.shape != want.shape:
        return math.inf
    return float((prog - want).abs().flatten(1).mean(1).max())
