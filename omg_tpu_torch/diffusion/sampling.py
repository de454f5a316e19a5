"""Denoise loop and classifier-free guidance (port of
``omg_tpu/diffusion/sampling.py``).

The JAX ``denoise_loop`` is a ``fori_loop`` inside one XLA program; here
it is a plain Python loop over the same body. The multi-concept
pipelines run their own loops (``pipelines/multiconcept.py``).
"""

from __future__ import annotations

from typing import Callable

import torch

from omg_tpu_torch.diffusion import schedulers
from omg_tpu_torch.utils import profiling

# model_fn(latents, timestep, step_index) -> epsilon prediction, same shape.
ModelFn = Callable[[torch.Tensor, int, int], torch.Tensor]


def denoise_loop(sched: schedulers.Schedule, model_fn: ModelFn,
                 latents: torch.Tensor) -> torch.Tensor:
    """Run the full denoise; ``model_fn`` owns CFG and conditioning. Each
    step scales the input, predicts and takes one scheduler step. LCM
    re-noises from seed 0, one draw per row (``schedulers.step_noise``),
    as the JAX loop does from its state's default key."""
    x, state = latents, schedulers.init_state(0)
    for i in profiling.steps(0, sched.num_steps):
        x_in = schedulers.scale_model_input(sched, x, i)
        eps = model_fn(x_in, int(sched.timesteps[i]), i)
        x, state = schedulers.step(sched, state, eps, i, x)
    return x


def cfg_combine(noise_pred: torch.Tensor,
                guidance_scale: float | torch.Tensor) -> torch.Tensor:
    """CFG over a [2B, ...] (uncond; cond) batch:
    uncond + g * (cond - uncond), g in the prediction's dtype. A host
    scale (a number, or a CPU tensor beside a card's prediction) is filled
    on the prediction's device: no copy."""
    uncond, cond = noise_pred.chunk(2, dim=0)
    g = guidance_scale
    if torch.is_tensor(g) and g.device.type == noise_pred.device.type:
        g = g.to(device=noise_pred.device, dtype=noise_pred.dtype)
    else:
        g = torch.full((), float(g), dtype=noise_pred.dtype,
                       device=noise_pred.device)
    return uncond + g * (cond - uncond)
