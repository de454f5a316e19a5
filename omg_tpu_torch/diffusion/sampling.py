"""Classifier-free guidance (port of ``omg_tpu/diffusion/sampling.py``).

The JAX ``denoise_loop`` is a ``fori_loop``; here the loops are plain
Python in the pipelines that own them.
"""

from __future__ import annotations

import torch


def cfg_combine(noise_pred: torch.Tensor,
                guidance_scale: float | torch.Tensor) -> torch.Tensor:
    """CFG over a [2B, ...] (uncond; cond) batch:
    uncond + g * (cond - uncond), g in the prediction's dtype."""
    uncond, cond = noise_pred.chunk(2, dim=0)
    g = torch.as_tensor(guidance_scale, device=noise_pred.device,
                        dtype=noise_pred.dtype)
    return uncond + g * (cond - uncond)
