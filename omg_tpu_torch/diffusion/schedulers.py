"""Euler noise schedule (port of ``omg_tpu/diffusion/schedulers.py``).

A schedule is a NamedTuple of constants computed in fp64 numpy and stored
as fp32 tensors, plus pure functions (``scale_model_input``, ``step``).
SDXL-base's default is EulerDiscrete with scaled_linear betas, "leading"
spacing and steps_offset=1, the one the OMG path uses. DDIM, DPM++2M,
LCM and the other spacings come later.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Schedule(NamedTuple):
    timesteps: torch.Tensor         # [S] int32, descending (CPU)
    sigmas: torch.Tensor            # [S+1] fp32, 0-terminated (CPU)
    init_noise_sigma: torch.Tensor  # scalar fp32 (CPU)
    num_steps: int


class SchedulerState(NamedTuple):
    """Carry between steps. Euler keeps no history; DPM++2M will add its
    previous model output here."""
    step_count: int


def betas_scaled_linear(num_train_timesteps: int = 1000,
                        beta_start: float = 0.00085,
                        beta_end: float = 0.012) -> np.ndarray:
    """SDXL's "scaled_linear" beta schedule."""
    return np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                       num_train_timesteps, dtype=np.float64) ** 2


def make_schedule(kind: str, num_steps: int, *,
                  num_train_timesteps: int = 1000,
                  steps_offset: int = 1) -> Schedule:
    """Euler with "leading" timestep spacing (diffusers)."""
    if kind != "euler":
        raise NotImplementedError(
            f"scheduler {kind!r} is not ported yet (ROADMAP.md, open item "
            "'other schedulers'); the port has 'euler'")
    alphas_cumprod = np.cumprod(1.0 - betas_scaled_linear(num_train_timesteps))
    ratio = num_train_timesteps // num_steps
    timesteps = (np.arange(num_steps) * ratio + steps_offset)[::-1]
    sigmas_full = ((1 - alphas_cumprod) / alphas_cumprod) ** 0.5
    sigmas = np.interp(timesteps.astype(np.float64),
                       np.arange(num_train_timesteps), sigmas_full)
    sigmas = np.concatenate([sigmas, [0.0]])
    return Schedule(
        timesteps=torch.as_tensor(timesteps.astype(np.int32)),
        sigmas=torch.as_tensor(sigmas, dtype=torch.float32),
        init_noise_sigma=torch.as_tensor((sigmas.max() ** 2 + 1) ** 0.5,
                                         dtype=torch.float32),
        num_steps=num_steps)


def init_state() -> SchedulerState:
    return SchedulerState(step_count=0)


def scale_model_input(sched: Schedule, latents: torch.Tensor,
                      i: int) -> torch.Tensor:
    """Divide by sqrt(sigma^2 + 1), in the latents' dtype, so the UNet
    sees a ~unit-variance input."""
    sigma = sched.sigmas[i].to(device=latents.device, dtype=latents.dtype)
    return latents / torch.sqrt(sigma * sigma + 1.0)


def scale_initial_noise(sched: Schedule, noise: torch.Tensor) -> torch.Tensor:
    return noise * sched.init_noise_sigma.to(device=noise.device,
                                             dtype=noise.dtype)


def step(sched: Schedule, state: SchedulerState, eps: torch.Tensor, i: int,
         x: torch.Tensor) -> tuple[torch.Tensor, SchedulerState]:
    """One Euler update in fp32 (x = x0 + sigma * noise), cast back to
    x's dtype. eps is the epsilon (noise) prediction."""
    d_sigma = float(sched.sigmas[i + 1] - sched.sigmas[i])   # fp32 difference
    nxt = (x.float() + eps.float() * d_sigma).to(x.dtype)
    return nxt, SchedulerState(state.step_count + 1)
