"""Noise schedules as pure functions (port of
``omg_tpu/diffusion/schedulers.py``).

A schedule is a NamedTuple of constants computed in fp64 numpy and stored
as fp32 tensors, plus pure functions (``scale_model_input``, ``step``,
``add_noise``). Four kinds share one state layout, so the denoise loops
take any of them:
  * ``euler`` — EulerDiscrete, SDXL-base's default and the OMG path's;
  * ``ddim`` — deterministic DDIM (eta 0);
  * ``dpmpp_2m`` — DPM-Solver++(2M), which carries its previous x0
    prediction in ``SchedulerState.prev_model_output``;
  * ``lcm`` — LCM consistency sampling (LCM-LoRA's few-step mode), which
    re-noises every step but the last with fresh noise.
Timesteps take the "leading" (default, steps_offset 1), "trailing" or
"linspace" spacing; LCM takes its own grid from the distillation's
origin steps. Euler and DPM++2M live in sigma space (x = x0 + sigma *
eps), DDIM and LCM in alpha-bar space (unit-variance samples).

LCM's noise at step i is a pure function of (seed, step): one sample per
step from a ``torch.Generator`` seeded by (``noise_seed``, 777, i), the
JAX package's ``fold_in(fold_in(PRNGKey(seed), 777), i)`` derivation. So
stage 2, resuming at the boundary, draws at step i what stage 1 drew at
step i, and every denoise range can start anywhere. ``step`` also takes
the noise as an argument (the tests hand it JAX's own draws).
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional

import numpy as np
import torch

KINDS = ("euler", "ddim", "dpmpp_2m", "lcm")
SPACINGS = ("leading", "trailing", "linspace")
# The salt of LCM's noise seed (JAX: fold_in(key, 777)).
NOISE_SALT = 777


class Schedule(NamedTuple):
    kind: str                       # one of KINDS
    timesteps: torch.Tensor         # [S] int32, descending (CPU)
    sigmas: torch.Tensor            # [S+1] fp32, 0-terminated (CPU)
    alphas_cumprod: torch.Tensor    # [T] fp32 training alphas-bar (CPU)
    init_noise_sigma: torch.Tensor  # scalar fp32 (CPU)
    num_steps: int


class SchedulerState(NamedTuple):
    """Carry between steps. ``prev_model_output``: DPM++2M's previous x0
    prediction (fp32, the latents' shape; None before its first step and
    for the other kinds). ``noise_seed``: LCM's seed (None: LCM needs the
    noise handed to ``step``)."""
    step_count: int
    prev_model_output: Optional[torch.Tensor] = None
    noise_seed: Optional[int] = None


def betas_scaled_linear(num_train_timesteps: int = 1000,
                        beta_start: float = 0.00085,
                        beta_end: float = 0.012) -> np.ndarray:
    """SDXL's "scaled_linear" beta schedule."""
    return np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                       num_train_timesteps, dtype=np.float64) ** 2


def _timesteps(kind: str, num_steps: int, num_train_timesteps: int,
               timestep_spacing: str, steps_offset: int,
               lcm_origin_steps: int) -> np.ndarray:
    if kind == "lcm":
        # diffusers LCMScheduler.set_timesteps: count back from the last
        # origin step by len(origin) // num_steps
        k = num_train_timesteps // lcm_origin_steps
        origin = np.arange(1, lcm_origin_steps + 1) * k - 1
        skip = len(origin) // num_steps
        if skip < 1:
            raise ValueError(f"LCM num_steps {num_steps} exceeds the origin "
                             f"grid ({lcm_origin_steps} steps)")
        return origin[::-skip][:num_steps]
    if timestep_spacing == "leading":
        ratio = num_train_timesteps // num_steps
        return (np.arange(num_steps) * ratio + steps_offset)[::-1]
    if timestep_spacing == "trailing":
        ratio = num_train_timesteps / num_steps
        return np.round(np.arange(num_train_timesteps, 0, -ratio)
                        ).astype(np.int64) - 1
    return np.linspace(0, num_train_timesteps - 1,
                       num_steps)[::-1].round().astype(np.int64)


def make_schedule(kind: str, num_steps: int, *,
                  num_train_timesteps: int = 1000,
                  timestep_spacing: str = "leading",
                  steps_offset: int = 1,
                  lcm_origin_steps: int = 50) -> Schedule:
    if kind not in KINDS:
        raise ValueError(f"unknown scheduler {kind!r}; one of {KINDS}")
    if timestep_spacing not in SPACINGS:
        raise ValueError(f"unknown timestep spacing {timestep_spacing!r}; "
                         f"one of {SPACINGS}")
    alphas_cumprod = np.cumprod(1.0 - betas_scaled_linear(num_train_timesteps))
    timesteps = _timesteps(kind, num_steps, num_train_timesteps,
                           timestep_spacing, steps_offset,
                           lcm_origin_steps).astype(np.float64)
    sigmas_full = ((1 - alphas_cumprod) / alphas_cumprod) ** 0.5
    sigmas = np.interp(timesteps, np.arange(num_train_timesteps), sigmas_full)
    sigmas = np.concatenate([sigmas, [0.0]])
    if kind in ("euler", "dpmpp_2m"):
        init_noise_sigma = ((sigmas.max() ** 2 + 1) ** 0.5
                            if timestep_spacing == "leading"
                            else sigmas.max())
    else:
        init_noise_sigma = 1.0
    return Schedule(
        kind=kind,
        timesteps=torch.as_tensor(timesteps.astype(np.int32)),
        sigmas=torch.as_tensor(sigmas, dtype=torch.float32),
        alphas_cumprod=torch.as_tensor(alphas_cumprod, dtype=torch.float32),
        init_noise_sigma=torch.as_tensor(init_noise_sigma,
                                         dtype=torch.float32),
        num_steps=num_steps)


def init_state(noise_seed: Optional[int] = None) -> SchedulerState:
    return SchedulerState(step_count=0, noise_seed=noise_seed)


def _sigma_space(sched: Schedule) -> bool:
    return sched.kind in ("euler", "dpmpp_2m")


def scale_model_input(sched: Schedule, latents: torch.Tensor,
                      i: int) -> torch.Tensor:
    """Sigma-space schedules divide by sqrt(sigma^2 + 1), in the latents'
    dtype, so the UNet sees a ~unit-variance input; DDIM/LCM samples are
    unit-variance already."""
    if not _sigma_space(sched):
        return latents
    sigma = sched.sigmas[i].to(device=latents.device, dtype=latents.dtype)
    return latents / torch.sqrt(sigma * sigma + 1.0)


def scale_initial_noise(sched: Schedule, noise: torch.Tensor) -> torch.Tensor:
    if not _sigma_space(sched):
        return noise
    return noise * sched.init_noise_sigma.to(device=noise.device,
                                             dtype=noise.dtype)


def step_noise(noise_seed: int, i: int, shape: tuple,
               device: torch.device) -> torch.Tensor:
    """LCM's unit noise at step i, fp32, drawn on ``device`` from a
    generator seeded by a hash of (noise_seed, NOISE_SALT, i): the draw
    depends on nothing else."""
    digest = hashlib.blake2b(f"{noise_seed}/{NOISE_SALT}/{i}".encode(),
                             digest_size=8).digest()
    g = torch.Generator(device).manual_seed(
        int.from_bytes(digest, "little") & (2 ** 63 - 1))
    return torch.randn(shape, generator=g, device=device,
                       dtype=torch.float32)


def _euler(sched: Schedule, eps, i, x) -> torch.Tensor:
    # x lives in sigma space: x = x0 + sigma * noise
    d_sigma = float(sched.sigmas[i + 1] - sched.sigmas[i])   # fp32 difference
    return x.float() + eps.float() * d_sigma


def _ddim(sched: Schedule, eps, i, x) -> torch.Tensor:
    t = int(sched.timesteps[i])
    # the training grid's length, not a hardcoded 1000
    prev_t = t - sched.alphas_cumprod.shape[0] // sched.num_steps
    a_t = sched.alphas_cumprod[t]
    a_prev = sched.alphas_cumprod[prev_t] if prev_t >= 0 else \
        torch.tensor(1.0)
    xf, ef = x.float(), eps.float()
    x0 = (xf - torch.sqrt(1 - a_t).item() * ef) / torch.sqrt(a_t).item()
    return torch.sqrt(a_prev).item() * x0 + torch.sqrt(1 - a_prev).item() * ef


def _dpmpp_2m(sched: Schedule, state: SchedulerState, eps, i, x) -> tuple:
    """DPM-Solver++(2M), data prediction, karras convention (alpha = 1,
    lambda = -log sigma); first-order on the first step and onto sigma 0."""
    sig = sched.sigmas
    sigma, sigma_next = sig[i], sig[i + 1]
    sigma_prev = sig[max(i - 1, 0)]
    xf, ef = x.float(), eps.float()
    x0 = xf - sigma.item() * ef

    def lam(s):
        return -torch.log(torch.clamp(s, min=1e-10))

    h = lam(sigma_next) - lam(sigma)
    if float(sigma_next) == 0.0:
        out = x0
    else:
        if state.step_count == 0:
            d = x0
        else:
            r = (lam(sigma) - lam(sigma_prev)) / torch.clamp(h, min=1e-10)
            c = (1 / (2 * r)).item()
            d = (1 + c) * x0 - c * state.prev_model_output
        ratio = (sigma_next / torch.clamp(sigma, min=1e-10)).item()
        out = ratio * xf - torch.expm1(-h).item() * d
    return out, state._replace(prev_model_output=x0)


def _lcm(sched: Schedule, state: SchedulerState, eps, i, x, noise,
         shared_batch_noise: bool) -> torch.Tensor:
    """Predict x0, blend with the consistency scalings (sigma_data 0.5,
    timestep scaling 10), then re-noise to the next grid point with fresh
    noise; the last step returns the blend."""
    t = int(sched.timesteps[i])
    t_next = int(sched.timesteps[min(i + 1, sched.num_steps - 1)])
    a_t, a_next = sched.alphas_cumprod[t], sched.alphas_cumprod[t_next]
    xf, ef = x.float(), eps.float()
    x0 = (xf - torch.sqrt(1.0 - a_t).item() * ef) / torch.sqrt(a_t).item()
    scaled = torch.tensor(t, dtype=torch.float32) * 10.0
    sigma_data2 = 0.5 ** 2
    c_skip = (sigma_data2 / (scaled ** 2 + sigma_data2)).item()
    c_out = (scaled / torch.sqrt(scaled ** 2 + sigma_data2)).item()
    denoised = c_out * x0 + c_skip * xf
    if i == sched.num_steps - 1:
        return denoised
    shape = ((1,) + tuple(x.shape[1:])) if shared_batch_noise \
        else tuple(x.shape)
    if noise is None:
        if state.noise_seed is None:
            raise ValueError("LCM re-noises every step: give the state a "
                             "noise_seed or pass the noise")
        noise = step_noise(state.noise_seed, i, shape, x.device)
    noise = noise.to(device=x.device, dtype=torch.float32).expand(x.shape)
    return (torch.sqrt(a_next).item() * denoised
            + torch.sqrt(1.0 - a_next).item() * noise)


def step(sched: Schedule, state: SchedulerState, eps: torch.Tensor, i: int,
         x: torch.Tensor, *, noise: Optional[torch.Tensor] = None,
         shared_batch_noise: bool = False
         ) -> tuple[torch.Tensor, SchedulerState]:
    """One scheduler update in fp32, cast back to x's dtype. eps is the
    epsilon (noise) prediction.

    ``noise``: LCM's unit noise for this step (drawn from the state's
    ``noise_seed`` when None). ``shared_batch_noise``: LCM draws one
    [1, ...] sample and broadcasts it over the batch, which the
    multiconcept loops set: their batch axis holds copies of one image,
    and those must stay equal."""
    if sched.kind == "euler":
        out = _euler(sched, eps, i, x)
    elif sched.kind == "ddim":
        out = _ddim(sched, eps, i, x)
    elif sched.kind == "dpmpp_2m":
        out, state = _dpmpp_2m(sched, state, eps, i, x)
    elif sched.kind == "lcm":
        out = _lcm(sched, state, eps, i, x, noise, shared_batch_noise)
    else:
        raise ValueError(f"unknown scheduler kind {sched.kind!r}")
    return out.to(x.dtype), state._replace(step_count=state.step_count + 1)


def add_noise(sched: Schedule, x0: torch.Tensor, noise: torch.Tensor,
              i: int) -> torch.Tensor:
    """Forward-noise x0 to step i, in each schedule's sample space."""
    if _sigma_space(sched):
        return x0 + sched.sigmas[i].to(device=x0.device,
                                       dtype=x0.dtype) * noise
    a = sched.alphas_cumprod[int(sched.timesteps[i])]
    return (torch.sqrt(a).item() * x0.float()
            + torch.sqrt(1 - a).item() * noise.float()).to(x0.dtype)
