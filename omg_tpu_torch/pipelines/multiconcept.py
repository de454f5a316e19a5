"""OMG two-stage multi-concept denoise, exact single-card path (port of
``omg_tpu/pipelines/multiconcept.py``).

Two exact identities shape the path, as in the JAX package:
  1. Stage 1's two latent copies are identical at every step (same seed,
     same prompt, the P2P replace is a no-op on identical lanes), so stage
     1 is a plain b=1 CFG denoise over lanes [uncond, cond], duplicated at
     the end.
  2. Stage 2's steps up to ``fusion_start`` equal stage 1's, so stage 2
     resumes from the stage-1 boundary latents. Copy A's stage-2 path
     equals stage 1's (fusion writes only copy B, P2P edits only cond B),
     so stage 1 records its per-step input latents and stage 2 runs
     3 + 2K lanes: [cond_A, uncond_B, cond_B, c1_unc, c1_cond, ...], with
     P2P reading lane 0 and editing lane 2. Concept lanes carry the
     lane-stacked LoRA deltas.

ControlNet, IP-Adapter, DeepCache, concept crop strips, lane sharding and
the reference-layout 4-row program are later slices; asking for them
raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from omg_tpu_torch import lora as lora_lib
from omg_tpu_torch.control import regions
from omg_tpu_torch.diffusion import sampling, schedulers
from omg_tpu_torch.pipelines import sdxl


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to omg_tpu_torch yet (ROADMAP.md: {item})")


class ConceptInputs(NamedTuple):
    """Per-concept conditioning, CFG-stacked [neg; pos] rows."""
    prompt_embeds: torch.Tensor     # [2, 77, D]
    text_embeds: torch.Tensor       # [2, P]
    time_ids: torch.Tensor          # [2, 6]
    ip_context: Optional[torch.Tensor] = None


class BaseInputs(NamedTuple):
    """Global-prompt conditioning in the reference's 4-row layout
    [neg, neg, pos, pos]."""
    prompt_embeds: torch.Tensor     # [4, 77, D]
    text_embeds: torch.Tensor       # [4, P]
    time_ids: torch.Tensor          # [4, 6]
    guidance_scale: torch.Tensor    # scalar fp32


def make_base_inputs(embeds_pos, pooled_pos, embeds_neg, pooled_neg,
                     time_ids, guidance_scale: float) -> BaseInputs:
    def dup2(neg, pos):
        return torch.cat([neg, neg, pos, pos], dim=0)

    return BaseInputs(
        prompt_embeds=dup2(embeds_neg, embeds_pos),
        text_embeds=dup2(pooled_neg, pooled_pos),
        time_ids=time_ids.expand(4, 6),
        guidance_scale=torch.tensor(guidance_scale, dtype=torch.float32))


def make_concept_inputs(embeds_pos, pooled_pos, embeds_neg, pooled_neg,
                        time_ids, ip_context=None) -> ConceptInputs:
    return ConceptInputs(
        prompt_embeds=torch.cat([embeds_neg, embeds_pos], dim=0),
        text_embeds=torch.cat([pooled_neg, pooled_pos], dim=0),
        time_ids=time_ids.expand(2, 6),
        ip_context=ip_context)


def _concept_lane_conditioning(concept_inputs, concept_loras,
                               n_base_rows: int) -> tuple:
    """(embeds, text_embeds, time_ids) over the 2K concept lanes, and the
    LoRA stacked over ``n_base_rows`` base lanes (no adapter) followed by
    the concept lanes (concept k on lanes 2k, 2k+1)."""
    if any(ci.ip_context is not None for ci in concept_inputs):
        raise not_ported("the IP-Adapter branch", "InstantID")
    K = len(concept_inputs)
    c_embeds = torch.cat([ci.prompt_embeds for ci in concept_inputs])
    c_tembeds = torch.cat([ci.text_embeds for ci in concept_inputs])
    c_tids = torch.cat([ci.time_ids for ci in concept_inputs])
    lane_lora = lora_lib.stack_loras(
        [None] * n_base_rows
        + [(concept_loras[k].get("unet", concept_loras[k])
            if concept_loras[k] is not None else None)
           for k in range(K) for _ in range(2)])
    return c_embeds, c_tembeds, c_tids, lane_lora


class StageCache(NamedTuple):
    """Boundary state handed from stage 1 to stage 2."""
    latents: torch.Tensor                   # [1, h, w, 4] at the boundary
    sched_state: schedulers.SchedulerState
    a_traj: Optional[torch.Tensor] = None   # [S-boundary, 1, h, w, 4] inputs
    a_final: Optional[torch.Tensor] = None  # [1, h, w, 4] stage-1 final


def duplicate_latents(latents_single: torch.Tensor) -> torch.Tensor:
    """[1, h, w, 4] -> [2, h, w, 4]: the stage-1 copies."""
    return torch.cat([latents_single, latents_single])


def _denoise_cfg_range(cfg: sdxl.SDXLConfig, sched: schedulers.Schedule,
                       unet, latents: torch.Tensor,
                       state: schedulers.SchedulerState,
                       base_inputs: BaseInputs, *, i0: int, i1: int,
                       record_traj: bool = False) -> tuple:
    """Plain b=1 CFG denoise over steps [i0, i1) on rows [uncond, cond].

    ``record_traj`` also returns each step's input latent stacked
    [i1-i0, 1, h, w, 4] (copy A's stage-2 lane inputs)."""
    rows = [0, 2]
    embeds2 = base_inputs.prompt_embeds[rows]
    tembeds2 = base_inputs.text_embeds[rows]
    tids2 = base_inputs.time_ids[rows]
    traj = []
    x, st = latents, state
    for i in range(i0, i1):
        if record_traj:
            traj.append(x)
        t = int(sched.timesteps[i])
        lin = schedulers.scale_model_input(sched, torch.cat([x, x]), i)
        eps = unet(lin, t, embeds2, text_embeds=tembeds2, time_ids=tids2)
        guided = sampling.cfg_combine(eps, base_inputs.guidance_scale)
        x, st = schedulers.step(sched, st, guided, i, x)
    if not record_traj:
        return x, st
    traj = (torch.stack(traj) if traj else
            latents.new_zeros((0,) + tuple(latents.shape)))
    return x, st, traj


def _denoise_mc_range_traj(cfg: sdxl.SDXLConfig, sched: schedulers.Schedule,
                           unet, latent_b: torch.Tensor,
                           state: schedulers.SchedulerState,
                           a_traj: torch.Tensor, base_inputs: BaseInputs,
                           controller, concept_inputs, concept_loras,
                           masks: torch.Tensor, *, i0: int,
                           fusion_start: int = regions.FUSION_START_STEP
                           ) -> torch.Tensor:
    """Stage-2 suffix over steps [i0, S) with copy A as one
    trajectory-fed lane: lanes [cond_A, uncond_B, cond_B, c1_unc,
    c1_cond, c2_unc, ...]. latent_b: [1, h, w, 4] -> copy B's final."""
    K = len(concept_inputs)
    bidx = [2, 1, 3]    # [cond_A, uncond_B, cond_B] of the 4-row layout
    c_embeds, c_tembeds, c_tids, lane_lora = _concept_lane_conditioning(
        concept_inputs, concept_loras, 3)
    embeds = torch.cat([base_inputs.prompt_embeds[bidx], c_embeds])
    tembeds = torch.cat([base_inputs.text_embeds[bidx], c_tembeds])
    tids = torch.cat([base_inputs.time_ids[bidx], c_tids])
    masks = masks.to(latent_b.dtype)
    x, st = latent_b, state
    for i in range(i0, sched.num_steps):
        t = int(sched.timesteps[i])
        lin_a = schedulers.scale_model_input(sched, a_traj[i - i0], i)
        lin_b = schedulers.scale_model_input(sched, torch.cat([x, x]), i)
        lanes = torch.cat([lin_a, lin_b,
                           lin_b[1:2].expand((2 * K,) + lin_b.shape[1:])])
        ctrl = (controller.at_step(i, src_lane=0, dst_lane=2)
                if controller is not None else None)
        eps_all = unet(lanes, t, embeds, text_embeds=tembeds, time_ids=tids,
                       lora=lane_lora, control=ctrl)
        edit = eps_all[1:3]                          # [uncond_B, cond_B]
        region_preds = eps_all[3:].reshape((K, 2) + tuple(latent_b.shape[1:]))
        fused = regions.fuse_region_edit(edit, region_preds, masks,
                                         active=i > fusion_start)
        guided = sampling.cfg_combine(fused, base_inputs.guidance_scale)
        x, st = schedulers.step(sched, st, guided, i, x)
    return x


def sample_stage1_cached(cfg: sdxl.SDXLConfig, sched: schedulers.Schedule,
                         unet, *, generator: Optional[torch.Generator],
                         height: int, width: int, base_inputs: BaseInputs,
                         fusion_start: int = regions.FUSION_START_STEP,
                         base_controlnets: Sequence = (),
                         initial_noise=None,
                         cache_interval: int = 0) -> tuple:
    """Stage 1 on the dedup fast path -> ([2, h, w, 4] latents, StageCache).

    ``initial_noise`` ([1, h, w, 4] unit noise) replaces the draw from
    ``generator``, so two implementations can be fed the same noise."""
    if base_controlnets:
        raise not_ported("ControlNet", "ControlNet")
    if cache_interval > 1:
        raise not_ported("DeepCache", "approximate modes")
    device = base_inputs.prompt_embeds.device
    if initial_noise is not None:
        lat = schedulers.scale_initial_noise(sched, torch.tensor(
            np.asarray(initial_noise, np.float32), device=device).to(
                cfg.unet.dtype))
    else:
        lat = sdxl.prepare_latents(generator, 1, height, width, sched,
                                   cfg.unet.dtype, device)
    state = schedulers.init_state()
    boundary = min(fusion_start + 1, sched.num_steps)
    lat_b, st_b = _denoise_cfg_range(cfg, sched, unet, lat, state,
                                     base_inputs, i0=0, i1=boundary)
    lat_end, _, traj = _denoise_cfg_range(
        cfg, sched, unet, lat_b, st_b, base_inputs, i0=boundary,
        i1=sched.num_steps, record_traj=True)
    cache = StageCache(lat_b, st_b, a_traj=traj, a_final=lat_end)
    return duplicate_latents(lat_end), cache


def sample_stage2_resumed(cfg: sdxl.SDXLConfig, sched: schedulers.Schedule,
                          unet, cache: StageCache, *,
                          base_inputs: BaseInputs, controller,
                          concept_inputs: Sequence, concept_loras: Sequence,
                          masks: torch.Tensor,
                          fusion_start: int = regions.FUSION_START_STEP,
                          concept_ip_adapters: Sequence = (),
                          base_controlnets: Sequence = (),
                          concept_controlnets: Sequence = (),
                          lane_sharding=None, concept_crop: bool = False,
                          cache_interval: int = 0) -> torch.Tensor:
    """Stage 2 resumed from the cached boundary -> [2, h, w, 4] on the
    3+2K-lane trajectory program (copy A's final latent is stage 1's)."""
    if concept_ip_adapters:
        raise not_ported("the IP-Adapter branch", "InstantID")
    if base_controlnets or any(c is not None for c in concept_controlnets):
        raise not_ported("ControlNet", "ControlNet")
    if lane_sharding is not None:
        raise not_ported("lane sharding", "parallel/")
    if concept_crop:
        raise not_ported("concept_crop strips", "approximate modes")
    if cache_interval > 1:
        raise not_ported("DeepCache", "approximate modes")
    if (cache.a_traj is None or cache.a_traj.shape[0] == 0
            or len(concept_inputs) == 0):
        raise not_ported("the reference-layout 4-row stage-2 program "
                          "(no trajectory or no concepts)",
                          "the 4-row program")
    boundary = min(fusion_start + 1, sched.num_steps)
    lat_b = _denoise_mc_range_traj(
        cfg, sched, unet, cache.latents, cache.sched_state, cache.a_traj,
        base_inputs, controller, tuple(concept_inputs), tuple(concept_loras),
        masks, i0=boundary, fusion_start=fusion_start)
    return torch.cat([cache.a_final, lat_b])
