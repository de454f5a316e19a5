"""OMG two-stage multi-concept denoise, exact path (port of
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

Stage 2 also has the reference-layout 4+2K-lane program
(``_denoise_mc_range``): both latent copies as [uncond_A, uncond_B,
cond_A, cond_B] plus the 2K concept lanes, P2P reading lane 2 and editing
lane 3. It runs when there is no recorded trajectory, and it is the stage
2 of the multi-device latency mode, where its lanes split over the ranks.

The reference's own 4-row step (``multiconcept_step``, looped by
``denoise_multiconcept`` and ``sample_stage``) runs one stage end to end
with no shortcut: both latent copies CFG-expanded to [uncond_A, uncond_B,
cond_A, cond_B] on every step, and in stage 2 after ``fusion_start`` a
second forward over the 2K concept lanes fed copy B. Every fast path
equals it; the zero-concept stage 2 of ``_denoise_mc_range`` is it.

Multi-device latency mode (``OMG(mesh=...)``), on ``parallel/``:
  * stage 1 takes a ``Spatial`` layout: the CFG lanes [uncond, cond] over
    the mesh's data axis and the latent's H over its model axis; every
    conv, group norm and self-attention works across the model axis
    (halo rows, summed statistics, K1b on K/V gathered over the ranks),
    and so does a spatial ControlNet on the same rows of its condition
    image;
  * stage 2's 4+2K lanes split over all ranks (``lane_sharding``); each
    rank runs the ControlNets, IP tokens and LoRA rows of its own lanes,
    and the eps of every lane are gathered after each forward, so region
    fusion, CFG and the scheduler step run the same on every rank.

Conditioning, in every program (the JAX package's ``ControlNetInputs``
plumbing): a spatial ControlNet on the base lanes (stage 1's cond lane,
stage 2's conditional rows in guess mode), the IdentityNet on the concept
lanes, and the IP-Adapter tokens on the concept lanes (zero tokens on the
base lanes: an exact no-op, ``to_v_ip`` has no bias). Their residuals are
summed per lane, with zero rows for lanes no ControlNet serves.

The approximate modes (opt-in, as in JAX):
  * DeepCache (``cache_interval``, Ma et al. 2023): in every denoise range
    a full UNet forward on the range's first step and then every
    ``cache_interval``-th step phased from the range's start (an int), or
    where a per-step schedule tuple says True (``deepcache_schedule``),
    keeps the feature entering the last up block; the other steps run
    ``apply_shallow`` from it, and skip the ControlNet forwards. The cache
    is per lane, so it splits with the lanes and rows of the mesh layouts
    and spans the request axis of the batched programs.
  * the concept-crop strips (``concept_crop``, ``_denoise_cropped_batch``):
    stage 2's base rows full-frame, each concept's lanes on its vertical
    strip of the latent.
Both are host control flow here: the JAX package's ``lax.cond`` dispatch
becomes a Python branch per step.

The scheduler state carries LCM's noise seed; every loop steps with
``shared_batch_noise``: the batch axis holds copies of one image.

Request batching (``sample_stage1_batch``/``sample_stage2_batch``, the
JAX package's ``vmap`` over requests): R compatible requests (one
geometry, step count and scheduler) run as one UNet forward per step over
their lanes side by side, 2R in stage 1 and R(3+2K) in stage 2, each
request's lanes contiguous. CFG, region fusion and the scheduler step run
on each request's slice of the eps, with its own guidance scale and
scheduler state (DPM++2M's previous x0, LCM's seed). ``generate`` runs the
same loops (``_denoise_cfg_batch``, ``_denoise_traj_batch``,
``_denoise_cropped_batch``) with R = 1. A shared ControlNet or IdentityNet runs
once over the lanes it serves with per-lane scales; lanes without a
condition get scale 0, an exact no-op.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from omg_tpu_torch import lora as lora_lib
from omg_tpu_torch.control import regions
from omg_tpu_torch.diffusion import sampling, schedulers
from omg_tpu_torch.parallel import comm, mesh as mesh_lib
from omg_tpu_torch.pipelines import sdxl
from omg_tpu_torch.utils import profiling


def _rows(t: torch.Tensor, idx: list) -> torch.Tensor:
    """``t[idx]`` for a list of rows: the index goes to the card in a
    blocking copy."""
    return profiling.sync(t.__getitem__, idx)


class ControlNetInputs(NamedTuple):
    """One ControlNet's weights and conditioning for a denoise run.

    A spatial ControlNet (openpose/canny/depth) on the base lanes takes the
    lanes' text embeddings (``encoder_hidden_states`` None); InstantID's
    IdentityNet on a concept's lanes takes the face-keypoint image and the
    concept's CFG-stacked image-prompt tokens. ``guidance_start``/``_end``:
    at step i of S the residuals are kept only when i/S >= start and
    (i+1)/S <= end. ``guess_mode``: residuals from the conditional rows
    only (zeros on the uncond rows), with diffusers' log-linear depth
    ramp. A request batch gives ``scale`` (and the window, or one window
    for all) per lane, with scale 0 on the lanes it does not serve."""
    params: object                     # models.controlnet.ControlNetModel
    cond_image: torch.Tensor           # [B or 1, H, W, C], in [0, 1]
    scale: float | torch.Tensor | Sequence[float] = 1.0
    encoder_hidden_states: Optional[torch.Tensor] = None
    guidance_start: float | Sequence[float] = 0.0
    guidance_end: float | Sequence[float] = 1.0
    guess_mode: bool = False


def _window_keep(start: float, end: float, step_i: int,
                 num_steps: int) -> float:
    """The reference's ``controlnet_keep`` at step ``step_i``: 1.0 inside
    the guidance window [start, end], else 0.0 (fp32 fractions, as in
    JAX)."""
    f0 = np.float32(step_i) / np.float32(num_steps)
    f1 = (np.float32(step_i) + np.float32(1.0)) / np.float32(num_steps)
    drop = f0 < np.float32(start) or f1 > np.float32(end)
    return 0.0 if drop else 1.0


def _cn_keep(cn: ControlNetInputs, step_i: int, num_steps: int) -> float:
    return _window_keep(cn.guidance_start, cn.guidance_end, step_i,
                        num_steps)


def _cn_scale(cn: ControlNetInputs, step_i: Optional[int], num_steps: int,
              device):
    """``cn``'s conditioning scale at step ``step_i`` (no window gate when
    None): its scale, [N, 1, 1, 1] when given per lane, or None when the
    window drops it on every lane (the forward is skipped)."""
    gate = step_i is not None and num_steps
    if not isinstance(cn.scale, (list, tuple)):
        if gate and _cn_keep(cn, step_i, num_steps) == 0.0:
            return None
        return cn.scale
    n = len(cn.scale)

    def per_lane(v):
        return v if isinstance(v, (list, tuple)) else [v] * n
    scales = [float(s) * (_window_keep(g0, g1, step_i, num_steps) if gate
                          else 1.0)
              for s, g0, g1 in zip(cn.scale, per_lane(cn.guidance_start),
                                   per_lane(cn.guidance_end))]
    if not any(scales):
        return None
    return profiling.sync(torch.tensor, scales, dtype=torch.float32,
                          device=device)[:, None, None, None]


def _controlnet_residuals(cns: Sequence[ControlNetInputs], lin: torch.Tensor,
                          t: int, prompt_embeds: torch.Tensor,
                          text_embeds: torch.Tensor, time_ids: torch.Tensor,
                          *, step_i: Optional[int] = None, num_steps: int = 0,
                          cond_rows: tuple = (), lo: int = 0,
                          seq_group: Optional[comm.Group] = None) -> tuple:
    """Run each ControlNet on the lanes ``lin`` and sum the residual
    stacks (diffusers MultiControlNet) -> (down list, mid), NCHW, or
    (None, None) when no ControlNet runs.

    ``step_i``/``num_steps``: enable the guidance-window gate; outside its
    window a ControlNet does not run (its residuals would be exact zeros).
    ``cond_rows``: the conditional CFG rows of the program's lanes; a
    guess-mode ControlNet runs only those and leaves zeros on the others.
    ``lo``: ``lin`` and the embeddings hold the program's lanes [lo,
    lo + B) (a rank's share under a mesh); a guess-mode ControlNet runs the
    conditional rows among them and adds nothing where there is none, and
    a per-lane scale, condition image or context is cut to them.
    ``seq_group``: ``lin`` holds this rank's block of latent rows; the
    ControlNet runs split over the group on the same block of pixel rows
    of its condition image, and its residuals hold those rows."""
    down_acc = mid_acc = None
    b = lin.shape[0]

    def lanes_of(x):
        return x[lo:lo + b] if x.shape[0] > 1 and lo + b <= x.shape[0] \
            else x

    for cn in cns:
        scale = _cn_scale(cn, step_i, num_steps, lin.device)
        if scale is None:
            continue
        if torch.is_tensor(scale) and scale.dim():
            scale = lanes_of(scale)
        cond = cn.cond_image
        if seq_group is not None and seq_group.size > 1:
            n = cond.shape[1] // seq_group.size
            cond = cond[:, seq_group.index * n:(seq_group.index + 1) * n]
        if cn.guess_mode and cond_rows:
            local = [r - lo for r in cond_rows if lo <= r < lo + b]
            if not local:
                continue
            rows = profiling.sync(torch.as_tensor, local, device=lin.device)
            n = len(local)
            ehs = cn.encoder_hidden_states
            if ehs is not None:
                # a CFG-stacked [uncond; cond] context conditions on its
                # cond half only (diffusers chunk(2)[1])
                if ehs.shape[0] == 2:
                    ehs = ehs[1:]
                ehs = ehs.expand((n,) + tuple(ehs.shape[1:]))
            else:
                ehs = prompt_embeds[rows]
            cond = cond.expand((n,) + tuple(cond.shape[1:]))
            down, mid = cn.params(lin[rows], t, ehs, cond,
                                  text_embeds=text_embeds[rows],
                                  time_ids=time_ids[rows],
                                  conditioning_scale=scale, guess_mode=True,
                                  seq_group=seq_group)

            def spread(r):
                return r.new_zeros((b,) + tuple(r.shape[1:])).index_copy(
                    0, rows, r)
            down, mid = [spread(r) for r in down], spread(mid)
        else:
            cond = lanes_of(cond).expand((b,) + tuple(cond.shape[1:]))
            ehs = (lanes_of(cn.encoder_hidden_states)
                   if cn.encoder_hidden_states is not None else prompt_embeds)
            if ehs.shape[0] != b:
                ehs = ehs.expand((b,) + tuple(ehs.shape[1:]))
            down, mid = cn.params(lin, t, ehs, cond, text_embeds=text_embeds,
                                  time_ids=time_ids, conditioning_scale=scale,
                                  seq_group=seq_group)
        if down_acc is None:
            down_acc, mid_acc = list(down), mid
        else:
            down_acc = [a + d for a, d in zip(down_acc, down)]
            mid_acc = mid_acc + mid
    return down_acc, mid_acc


def _concept_cn_residuals(concept_controlnets: Sequence, concept_inputs,
                          rl: torch.Tensor, t: int, tembeds: torch.Tensor,
                          tids: torch.Tensor, *, step_i: Optional[int] = None,
                          num_steps: int = 0, lo: int = 0) -> tuple:
    """ControlNet residuals over the 2K concept lanes in one forward, or
    (None, None) when no concept has one. ``rl``, ``tembeds`` and
    ``tids`` hold the concept lanes [lo, lo + B) (all 2K unless a mesh
    rank holds a share of them). R requests side by side give their
    concepts in turn (request r's concept k is pair rK + k), and so one
    forward over their 2KR concept lanes.

    Concepts without a ControlNet get zero-scale lanes (an exact no-op);
    each concept's scale (times its guidance-window gate) applies to its
    own (uncond, cond) pair; in guess mode the uncond rows get scale 0.
    Every live entry must share one model (``validate_concept_controlnets``):
    the merged forward runs the first one's for every lane."""
    K = len(concept_controlnets)
    live = [cn for cn in concept_controlnets if cn is not None]
    if not live:
        return None, None
    template = live[0]
    has_ehs = [cn.encoder_hidden_states is not None for cn in live]
    if any(has_ehs) and not all(has_ehs):
        raise ValueError(
            "live concept ControlNets must consistently provide "
            "encoder_hidden_states (IdentityNet image-prompt tokens) or "
            "consistently omit them")
    if any(cn.guess_mode != template.guess_mode for cn in live):
        raise ValueError(
            "live concept ControlNets must agree on guess_mode (the "
            "merged forward runs one program over all lanes)")
    conds, ehs_rows, scales = [], [], []
    for k in range(K):
        cn = concept_controlnets[k]
        if cn is None:
            conds.append(template.cond_image.new_zeros(
                (2,) + tuple(template.cond_image.shape[1:])))
            tmpl_ehs = template.encoder_hidden_states
            ehs_rows.append(
                tmpl_ehs.new_zeros((2,) + tuple(tmpl_ehs.shape[1:]))
                if tmpl_ehs is not None else concept_inputs[k].prompt_embeds)
            scales.append(0.0)
            continue
        conds.append(cn.cond_image.expand((2,) + tuple(cn.cond_image.shape[1:])))
        ehs = (cn.encoder_hidden_states if cn.encoder_hidden_states is not None
               else concept_inputs[k].prompt_embeds)
        ehs_rows.append(ehs.expand((2,) + tuple(ehs.shape[1:])))
        keep = (_cn_keep(cn, step_i, num_steps)
                if step_i is not None and num_steps else 1.0)
        scales.append(float(cn.scale) * keep)
    lane_scale = torch.tensor(scales, dtype=torch.float32).repeat_interleave(2)
    if template.guess_mode:
        # residuals on the cond rows only (lanes are (uncond, cond) pairs)
        lane_scale = lane_scale * torch.tensor([0.0, 1.0]).repeat(K)
    hi = lo + rl.shape[0]
    return template.params(
        rl, t, torch.cat(ehs_rows)[lo:hi], torch.cat(conds)[lo:hi],
        text_embeds=tembeds, time_ids=tids,
        conditioning_scale=profiling.sync(lane_scale[lo:hi].to,
                                          rl.device)[:, None, None, None],
        guess_mode=template.guess_mode)


def validate_concept_controlnets(concept_controlnets) -> None:
    """Every live per-concept ControlNet must be one model: one
    IdentityNet serves every concept, and the lane-merged forward runs a
    single model over all lanes, so distinct ones would be silently
    dropped. Checked by module identity."""
    live = [cn for cn in (concept_controlnets or ()) if cn is not None]
    if any(cn.params is not live[0].params for cn in live[1:]):
        raise ValueError(
            "per-concept ControlNets must share one model (one IdentityNet "
            "serves every concept in the reference); got distinct models - "
            "run them as separate pipelines or share the module")


def _lane_residuals(base: tuple, concept: tuple, n_base: int,
                    n_concept: int) -> tuple:
    """Base-lane and concept-lane residuals stacked over all lanes, with
    zero rows for the side that has none -> (down, mid) or (None, None).
    With R requests side by side (R * n_base and R * n_concept rows), each
    request's block is [its base rows; its concept rows]."""
    (b_down, b_mid), (c_down, c_mid) = base, concept
    if b_down is None and c_down is None:
        return None, None
    R = (b_mid if b_mid is not None else c_mid).shape[0] // (
        n_base if b_mid is not None else n_concept)
    if b_down is None:
        b_down, b_mid = [_zero_rows(r, R * n_base) for r in c_down], \
            _zero_rows(c_mid, R * n_base)
    if c_down is None:
        c_down, c_mid = [_zero_rows(r, R * n_concept) for r in b_down], \
            _zero_rows(b_mid, R * n_concept)

    def interleave(b, c):
        return torch.cat([b.reshape((R, n_base) + tuple(b.shape[1:])),
                          c.reshape((R, n_concept) + tuple(c.shape[1:]))],
                         1).flatten(0, 1)
    return ([interleave(b, c) for b, c in zip(b_down, c_down)],
            interleave(b_mid, c_mid))


def _zero_rows(r: torch.Tensor, n: int) -> torch.Tensor:
    return r.new_zeros((n,) + tuple(r.shape[1:]))


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


def _base_rows(base_inputs_r: Sequence[BaseInputs], rows: list) -> list:
    """Each request's (embeds, text_embeds, time_ids) on ``rows`` of its
    4-row layout (one blocking copy of the index each)."""
    return [tuple(_rows(x, rows) for x in (b.prompt_embeds, b.text_embeds,
                                           b.time_ids))
            for b in base_inputs_r]


def _concept_lane_conditioning(concept_inputs_r, concept_loras_r, dtype,
                               base_rows_r: Optional[list] = None) -> tuple:
    """The lane conditioning of R requests side by side, each request's
    lanes its base lanes, then its 2K concept lanes (concept k on lanes
    2k, 2k+1) -> (embeds, text_embeds, time_ids, LoRA, IP tokens).

    ``base_rows_r``: per request, its base lanes' (embeds, text_embeds,
    time_ids); they take no adapter and zero IP tokens. None: concept
    lanes only. The IP tokens are None when no concept has any (zero
    tokens for a concept without a face). The LoRA is the lanes' factors
    in the UNet's compute dtype ``dtype`` (``lora.stack_loras``)."""
    base_r = base_rows_r or [None] * len(concept_inputs_r)
    n_base = 0 if base_rows_r is None else base_rows_r[0][0].shape[0]
    fields = [torch.cat([x for b, cl in zip(base_r, concept_inputs_r)
                         for x in ([] if b is None else [b[f]])
                         + [getattr(ci, name) for ci in cl]])
              for f, name in enumerate(("prompt_embeds", "text_embeds",
                                        "time_ids"))]
    lane_lora = lora_lib.stack_loras(
        [lora for ll in concept_loras_r for lora in
         [None] * n_base + [(lo.get("unet", lo) if lo is not None else None)
                            for lo in ll for _ in range(2)]], dtype=dtype)
    ip_ctx = None
    with_ip = [ci.ip_context for cl in concept_inputs_r for ci in cl
               if ci.ip_context is not None]
    if with_ip:
        zeros = torch.zeros_like(with_ip[0])
        base_ip = zeros[:1].expand((n_base,) + tuple(zeros.shape[1:]))
        ip_ctx = torch.cat(
            [x for cl in concept_inputs_r for x in
             [base_ip] + [ci.ip_context if ci.ip_context is not None
                          else zeros for ci in cl]])
    return (*fields, lane_lora, ip_ctx)


def multiconcept_step(cfg: sdxl.SDXLConfig, sched: schedulers.Schedule,
                      unet, x: torch.Tensor, st: schedulers.SchedulerState,
                      i: int, base_inputs: BaseInputs, controller,
                      concept_inputs: Sequence, concept_loras: Sequence,
                      masks: torch.Tensor, stage2: bool, *,
                      concept_ip_adapters: Sequence = (),
                      fusion_start: int = regions.FUSION_START_STEP,
                      ip_scale: float = 1.0,
                      base_controlnets: Sequence = (),
                      concept_controlnets: Sequence = ()) -> tuple:
    """One OMG denoise step in the reference's layout -> (x', state').

    x: [2, h, w, 4] (copy A, copy B), CFG-expanded to the 4 base rows
    [uncond_A, uncond_B, cond_A, cond_B]; P2P reads row 2 and edits row 3;
    the base ControlNets run on those rows (rows 2 and 3 conditional).
    In stage 2 after ``fusion_start`` the K concepts run as one forward
    over 2K lanes fed row 3 (concept k's (uncond, cond) pair on lanes 2k,
    2k+1, its LoRA lane-stacked, the IP tokens and the IdentityNet on
    them), and ``fuse_region_noise`` writes their masked predictions into
    copy B's rows; then CFG and one scheduler step."""
    K = len(concept_inputs)
    t = int(sched.timesteps[i])
    lin = schedulers.scale_model_input(sched, torch.cat([x, x]), i)
    ctrl = controller.at_step(i) if controller is not None else None
    down, mid = _controlnet_residuals(
        base_controlnets, lin, t, base_inputs.prompt_embeds,
        base_inputs.text_embeds, base_inputs.time_ids, step_i=i,
        num_steps=sched.num_steps, cond_rows=(2, 3))
    eps = unet(lin, t, base_inputs.prompt_embeds,
               text_embeds=base_inputs.text_embeds,
               time_ids=base_inputs.time_ids, control=ctrl,
               down_block_residuals=down, mid_block_residual=mid)
    if K > 0:
        # the JAX lax.cond: the concept forward runs only while fusing
        active = bool(stage2) and i > fusion_start
        region_preds = eps.new_zeros((K, 2) + tuple(lin.shape[1:]))
        if active:
            rl2 = lin[3:4].expand((2 * K,) + tuple(lin.shape[1:]))
            embeds, tembeds, tids, lane_lora, ip_ctx = \
                _concept_lane_conditioning([concept_inputs], [concept_loras],
                                           unet.cfg.dtype)
            k_down, k_mid = _concept_cn_residuals(
                concept_controlnets, concept_inputs, rl2, t, tembeds, tids,
                step_i=i, num_steps=sched.num_steps)
            out = unet(rl2, t, embeds, text_embeds=tembeds, time_ids=tids,
                       lora=lane_lora,
                       ip_adapter=(concept_ip_adapters[0]
                                   if concept_ip_adapters else None),
                       ip_context=ip_ctx, ip_scale=ip_scale,
                       down_block_residuals=k_down, mid_block_residual=k_mid)
            region_preds = out.reshape((K, 2) + tuple(lin.shape[1:]))
        eps = regions.fuse_region_noise(eps, region_preds,
                                        masks.to(eps.dtype), active=active)
    guided = sampling.cfg_combine(eps, base_inputs.guidance_scale)
    return schedulers.step(sched, st, guided, i, x, shared_batch_noise=True)


def denoise_multiconcept(cfg: sdxl.SDXLConfig, sched: schedulers.Schedule,
                         unet, latents: torch.Tensor, base_inputs: BaseInputs,
                         controller, concept_inputs: Sequence,
                         concept_loras: Sequence, masks: torch.Tensor,
                         stage2: bool, *, concept_ip_adapters: Sequence = (),
                         fusion_start: int = regions.FUSION_START_STEP,
                         ip_scale: float = 1.0,
                         base_controlnets: Sequence = (),
                         concept_controlnets: Sequence = (),
                         noise_seed: Optional[int] = None, i0: int = 0,
                         state: Optional[schedulers.SchedulerState] = None
                         ) -> torch.Tensor:
    """Steps [i0, S) of one stage by ``multiconcept_step`` from ``latents``
    [2, h, w, 4] -> the final latents. ``noise_seed``: LCM's re-noise
    seed, the request's seed, as the fast paths take it (the JAX
    ``noise_key``), so both draw one stream. ``state``: the scheduler
    state at step ``i0`` in place of a fresh one."""
    x = latents
    st = schedulers.init_state(noise_seed) if state is None else state
    for i in profiling.steps(i0, sched.num_steps):
        x, st = multiconcept_step(
            cfg, sched, unet, x, st, i, base_inputs, controller,
            concept_inputs, concept_loras, masks, stage2,
            concept_ip_adapters=concept_ip_adapters,
            fusion_start=fusion_start, ip_scale=ip_scale,
            base_controlnets=base_controlnets,
            concept_controlnets=concept_controlnets)
    return x


class StageCache(NamedTuple):
    """Boundary state handed from stage 1 to stage 2."""
    latents: torch.Tensor                   # [1, h, w, 4] at the boundary
    sched_state: schedulers.SchedulerState
    a_traj: Optional[torch.Tensor] = None   # [S-boundary, 1, h, w, 4] inputs
    a_final: Optional[torch.Tensor] = None  # [1, h, w, 4] stage-1 final


def duplicate_latents(latents_single: torch.Tensor) -> torch.Tensor:
    """[1, h, w, 4] -> [2, h, w, 4]: the stage-1 copies."""
    return torch.cat([latents_single, latents_single])


def dc_on(spec) -> bool:
    """Whether a DeepCache spec caches: an int interval > 1, or a per-step
    full/shallow schedule tuple (the JAX ``_dc_on``)."""
    return isinstance(spec, tuple) or (not isinstance(spec, bool)
                                       and isinstance(spec, int) and spec > 1)


# The named full-step placements ``deepcache_schedule`` takes (the server
# checks request fields against them).
DEEPCACHE_SCHEDULES = ("uniform", "front")


def deepcache_schedule(num_steps: int, interval: int, *,
                       kind: str = "front", power: float = 2.0,
                       fusion_start: Optional[int] = None) -> tuple:
    """Per-step DeepCache schedule, True = full forward: as many full
    steps as a uniform ``interval`` over [0, num_steps), placed by
    ``kind``. "front": the k-th at round((k / (n_full - 1))^power *
    (num_steps - 1)), collisions shifted right, so they pack towards step
    0 where the trajectory moves fastest. "uniform": the modulo schedule
    on global step numbers (the int form phases it from each range's
    start instead). ``fusion_start`` is forced full (stage 2's fusion
    starts on a fresh cache); range starts are forced full at dispatch."""
    if interval <= 1:
        raise ValueError("schedule needs interval > 1")
    n_full = -(-num_steps // interval)
    if kind == "uniform":
        idxs = set(range(0, num_steps, interval))
    elif kind == "front":
        idxs = set()
        for k in range(n_full):
            i = round((k / max(n_full - 1, 1)) ** power * (num_steps - 1))
            while i in idxs:
                i += 1
            if i < num_steps:
                idxs.add(i)
    else:
        raise ValueError(f"unknown DeepCache schedule kind {kind!r}")
    idxs.add(0)
    if fusion_start is not None and 0 <= fusion_start < num_steps:
        idxs.add(fusion_start)
    return tuple(i in idxs for i in range(num_steps))


class _DeepCache:
    """One denoise range's DeepCache: which steps run the full forward
    (the JAX ``_deepcache_cond``: an int interval phased from the range's
    start ``i0``, a tuple indexed by the global step, the first step of
    the range always full) and the feature the last full one kept."""

    def __init__(self, spec, i0: int):
        self.spec, self.i0, self.on = spec, i0, dc_on(spec)
        self.feature = None

    def full(self, i: int) -> bool:
        if not self.on:
            return True
        if isinstance(self.spec, tuple):
            return bool(self.spec[i]) or i == self.i0
        return (i - self.i0) % self.spec == 0

    def step(self, unet, i: int, lanes, t, embeds, residuals=None, **kw):
        """The UNet's eps at step i: the full forward (its ControlNet
        residuals from ``residuals()``, the cache kept) or the shallow one
        from the cache. ``kw``: the arguments both take."""
        if not self.full(i):
            return unet.apply_shallow(lanes, t, embeds, cache=self.feature,
                                      **kw)
        down, mid = residuals() if residuals is not None else (None, None)
        out = unet(lanes, t, embeds, down_block_residuals=down,
                   mid_block_residual=mid, return_cache=self.on, **kw)
        if self.on:
            out, self.feature = out
        return out


class Spatial(NamedTuple):
    """Stage 1's multi-device layout over ``mesh`` (the JAX
    ``spatial_sharding``): the two CFG lanes [uncond, cond] split over the
    data axis and, unless ``seq`` is False (the lane-only layout), the
    latent's H axis over the model axis."""
    mesh: mesh_lib.Mesh
    seq: bool = True


def _spatial_ctx(spatial: Spatial) -> tuple:
    """(lanes, seq_group) of this rank under ``spatial``: the ``Split`` of
    the CFG lanes over the data axis, and the group splitting H (None in
    the lane-only layout, where every rank of a data row runs the whole
    H)."""
    m = spatial.mesh
    if m.data > 2:
        raise ValueError(f"stage 1 has 2 CFG lanes; a data axis of {m.data} "
                         "would leave ranks without one")
    seq = m.model_group if spatial.seq and m.model > 1 else None
    return mesh_lib.data_sharded(m, 2), seq


def _denoise_cfg_range_spatial(sched: schedulers.Schedule, unet,
                               latents: torch.Tensor,
                               state: schedulers.SchedulerState,
                               embeds2, tembeds2, tids2, guidance, *,
                               i0: int, i1: int, spatial: Spatial,
                               base_controlnets: Sequence = (),
                               cache_interval=0) -> tuple:
    """``_denoise_cfg_range`` under a ``Spatial`` layout. Each rank runs
    its CFG lanes on its block of latent rows; the eps of both lanes are
    gathered over the data axis, so CFG and the scheduler step run on the
    rank's rows, and the rows are gathered over the model axis at the
    end: every rank returns the whole latents. The DeepCache feature is
    the rank's lanes and rows of it.

    ``base_controlnets`` run on the rank's lanes and rows (their residuals
    split as the UNet's levels are); in guess mode only the conditional
    lane runs one, so a rank that holds only the unconditional lane adds
    no residual, as the zero rows of the unsharded program."""
    lanes, seq = _spatial_ctx(spatial)
    lo, hi = lanes.lo, lanes.hi
    x = latents
    if seq is not None:
        h = latents.shape[1]
        if h % seq.size:
            raise ValueError(f"{h} latent rows do not split over "
                             f"{seq.size} ranks")
        rows = h // seq.size
        x = latents[:, seq.index * rows:(seq.index + 1) * rows]
    st = state
    dc = _DeepCache(cache_interval, i0)
    for i in profiling.steps(i0, i1):
        t = int(sched.timesteps[i])
        lin = schedulers.scale_model_input(sched, torch.cat([x, x]), i)
        mine = lin[lo:hi]
        eps = dc.step(unet, i, mine, t, embeds2[lo:hi],
                      lambda: _controlnet_residuals(
                          base_controlnets, mine, t, embeds2[lo:hi],
                          tembeds2[lo:hi], tids2[lo:hi], step_i=i,
                          num_steps=sched.num_steps, cond_rows=(1,), lo=lo,
                          seq_group=seq),
                      text_embeds=tembeds2[lo:hi], time_ids=tids2[lo:hi],
                      seq_group=seq)
        eps = comm.all_gather(eps, 0, lanes.group, sizes=lanes.sizes)
        guided = sampling.cfg_combine(eps, guidance)
        noise = None
        if seq is not None and sched.kind == "lcm" and \
                st.noise_seed is not None:
            # the whole latent's draw, this rank's rows of it
            noise = schedulers.step_noise(
                st.noise_seed, i, (1,) + tuple(latents.shape[1:]),
                x.device)[:, seq.index * rows:(seq.index + 1) * rows]
        x, st = schedulers.step(sched, st, guided, i, x, noise=noise,
                                shared_batch_noise=True)
    if seq is not None:
        x = comm.all_gather(x, 1, seq)
    return x, st


def _denoise_cfg_range(cfg: sdxl.SDXLConfig, sched: schedulers.Schedule,
                       unet, latents: torch.Tensor,
                       state: schedulers.SchedulerState,
                       base_inputs: BaseInputs, *, i0: int, i1: int,
                       record_traj: bool = False,
                       spatial: Optional[Spatial] = None,
                       base_controlnets: Sequence = (),
                       cache_interval=0) -> tuple:
    """Plain b=1 CFG denoise over steps [i0, i1) on rows [uncond, cond]:
    one request of ``_denoise_cfg_batch``.

    ``record_traj`` also returns each step's input latent stacked
    [i1-i0, 1, h, w, 4] (copy A's stage-2 lane inputs). ``spatial``: the
    multi-device layout (``_denoise_cfg_range_spatial``); it records no
    trajectory. ``base_controlnets``: spatial ControlNets on both rows
    (row 1 is the conditional one for guess mode). ``cache_interval``:
    the DeepCache spec (``_DeepCache``); shallow steps skip the
    ControlNets."""
    embeds2, tembeds2, tids2 = lanes = _cfg_lanes([base_inputs])
    if spatial is not None:
        if record_traj:
            raise ValueError("the spatial stage-1 layout records no "
                             "trajectory (its stage 2 is the 4+2K program)")
        return _denoise_cfg_range_spatial(
            sched, unet, latents, state, embeds2, tembeds2, tids2,
            base_inputs.guidance_scale, i0=i0, i1=i1, spatial=spatial,
            base_controlnets=base_controlnets, cache_interval=cache_interval)
    (x,), (st,), trajs = _denoise_cfg_batch(
        sched, unet, [latents], [state], lanes, [base_inputs.guidance_scale],
        i0=i0, i1=i1, record_traj=record_traj,
        base_controlnets=base_controlnets, cache_interval=cache_interval)
    return (x, st, trajs[0]) if record_traj else (x, st)


def _cfg_lanes(base_inputs_r: Sequence[BaseInputs]) -> tuple:
    """(embeds, text_embeds, time_ids) of R requests' CFG lanes
    [uncond_0, cond_0, uncond_1, ...]: rows 0 and 2 of each 4-row
    layout."""
    return tuple(torch.cat(f) for f in zip(*_base_rows(base_inputs_r,
                                                       [0, 2])))


def _denoise_cfg_batch(sched: schedulers.Schedule, unet, xs: list,
                       states: list, lanes: tuple, guidance_r: Sequence, *,
                       i0: int, i1: int, record_traj: bool = False,
                       base_controlnets: Sequence = (),
                       cache_interval=0) -> tuple:
    """Stage 1's CFG denoise of R requests over steps [i0, i1): their 2R
    lanes [uncond_0, cond_0, uncond_1, ...] as one forward per step, then
    per request CFG at its ``guidance_r`` scale and its scheduler step
    -> (xs, states, trajs). ``xs``/``states``: each request's latent
    [1, h, w, 4] and scheduler state at step ``i0`` (updated in place);
    ``lanes``: ``_cfg_lanes``. ``record_traj``: ``trajs`` holds each
    request's step inputs [i1-i0, 1, h, w, 4], else None.
    ``base_controlnets`` run on the 2R lanes (the odd ones conditional);
    ``cache_interval``: DeepCache (``_DeepCache``)."""
    R = len(xs)
    embeds, tembeds, tids = lanes
    cond_rows = tuple(range(1, 2 * R, 2))
    trajs: list = [[] for _ in range(R)]
    dc = _DeepCache(cache_interval, i0)
    for i in profiling.steps(i0, i1):
        if record_traj:
            for r in range(R):
                trajs[r].append(xs[r])
        t = int(sched.timesteps[i])
        lin = schedulers.scale_model_input(
            sched, torch.cat([x for x in xs for _ in range(2)]), i)
        eps = dc.step(unet, i, lin, t, embeds, lambda: _controlnet_residuals(
            base_controlnets, lin, t, embeds, tembeds, tids, step_i=i,
            num_steps=sched.num_steps, cond_rows=cond_rows),
            text_embeds=tembeds, time_ids=tids)
        for r in range(R):
            guided = sampling.cfg_combine(eps[2 * r:2 * r + 2], guidance_r[r])
            xs[r], states[r] = schedulers.step(sched, states[r], guided, i,
                                               xs[r], shared_batch_noise=True)
    if not record_traj:
        return xs, states, None
    return xs, states, [torch.stack(tr) if tr else
                        x.new_zeros((0,) + tuple(x.shape))
                        for tr, x in zip(trajs, xs)]


def _split_lanes(x: torch.Tensor, R: int, n: int) -> tuple:
    """The lanes of R requests side by side -> (each request's first
    ``n`` lanes, the rest of each), request by request; views when
    R = 1."""
    x = x.unflatten(0, (R, -1))
    return x[:, :n].flatten(0, 1), x[:, n:].flatten(0, 1)


def _denoise_traj_batch(
        sched: schedulers.Schedule, unet, xs: list, states: list,
        trajs: Sequence[torch.Tensor], base_inputs_r: Sequence[BaseInputs],
        controller, concept_inputs_r, concept_loras_r,
        masks_r: Sequence[torch.Tensor], *, i0: int, fusion_start: int,
        concept_ip_adapters: Sequence = (), ip_scale: float = 1.0,
        base_controlnets: Sequence = (),
        concept_controlnets_r: Optional[Sequence] = None,
        cache_interval=0) -> list:
    """The stage-2 suffix of R requests over steps [i0, S) with copy A as
    a trajectory-fed lane -> each request's copy-B final. Request r's
    lanes [cond_A, uncond_B, cond_B, c1_unc, c1_cond, c2_unc, ...] sit
    side by side with the others' in one forward per step; P2P reads its
    lane 0 and edits its lane 2. Then per request, in order: region
    fusion with its ``masks_r`` [K, h, w], CFG and its scheduler step.
    ``xs``/``states``: copy B's latents [1, h, w, 4] and scheduler states
    at step ``i0`` (updated in place); ``trajs``: copy A's recorded
    inputs from ``i0``. ``base_controlnets`` run on the 3R base lanes
    (each request's 0 and 2 conditional); ``concept_controlnets_r``, per
    request a ``ControlNetInputs`` or None for each concept (or () for
    every request), on the 2KR concept lanes in one forward.
    ``cache_interval``: DeepCache over all lanes."""
    R, K = len(xs), len(concept_inputs_r[0])
    L = 3 + 2 * K
    embeds, tembeds, tids, lane_lora, ip_ctx = _concept_lane_conditioning(
        concept_inputs_r, concept_loras_r, unet.cfg.dtype,
        _base_rows(base_inputs_r, [2, 1, 3]))   # [cond_A, uncond_B, cond_B]
    ipk = concept_ip_adapters[0] if concept_ip_adapters else None
    concepts = [ci for cl in concept_inputs_r for ci in cl]
    concept_cns = [cn for cl in concept_controlnets_r or () for cn in cl]
    has_cn = bool(base_controlnets) or any(cn is not None
                                           for cn in concept_cns)
    cond_rows = tuple(j for r in range(R) for j in (3 * r, 3 * r + 2))
    pairs = [(r * L, r * L + 2) for r in range(R)]
    masks_r = [m.to(xs[0].dtype) for m in masks_r]
    dc = _DeepCache(cache_interval, i0)
    for i in profiling.steps(i0, sched.num_steps):
        t = int(sched.timesteps[i])
        lanes = []
        for r in range(R):
            lin_a = schedulers.scale_model_input(sched, trajs[r][i - i0], i)
            lin_b = schedulers.scale_model_input(
                sched, torch.cat([xs[r], xs[r]]), i)
            lanes += [lin_a, lin_b,
                      lin_b[1:2].expand((2 * K,) + lin_b.shape[1:])]
        lanes = torch.cat(lanes)
        ctrl = (controller.at_step(i, pairs=pairs)
                if controller is not None else None)

        def residuals():
            (lb, lc), (eb, _), (tb, tc), (ib, ic) = (
                _split_lanes(x, R, 3) for x in (lanes, embeds, tembeds, tids))
            return _lane_residuals(
                _controlnet_residuals(
                    base_controlnets, lb, t, eb, tb, ib, step_i=i,
                    num_steps=sched.num_steps, cond_rows=cond_rows),
                _concept_cn_residuals(
                    concept_cns, concepts, lc, t, tc, ic, step_i=i,
                    num_steps=sched.num_steps),
                3, 2 * K)
        eps_all = dc.step(unet, i, lanes, t, embeds,
                          residuals if has_cn else None,
                          text_embeds=tembeds, time_ids=tids, lora=lane_lora,
                          control=ctrl, ip_adapter=ipk, ip_context=ip_ctx,
                          ip_scale=ip_scale)
        for r in range(R):
            e = eps_all[r * L:(r + 1) * L]
            region_preds = e[3:].reshape((K, 2) + tuple(xs[r].shape[1:]))
            fused = regions.fuse_region_edit(e[1:3], region_preds, masks_r[r],
                                             active=i > fusion_start)
            guided = sampling.cfg_combine(fused,
                                          base_inputs_r[r].guidance_scale)
            xs[r], states[r] = schedulers.step(sched, states[r], guided, i,
                                               xs[r], shared_batch_noise=True)
    return xs


def _denoise_mc_range(cfg: sdxl.SDXLConfig, sched: schedulers.Schedule,
                      unet, latents: torch.Tensor,
                      state: schedulers.SchedulerState,
                      base_inputs: BaseInputs, controller, concept_inputs,
                      concept_loras, masks: torch.Tensor, *, i0: int,
                      fusion_start: int = regions.FUSION_START_STEP,
                      lane_sharding: Optional[comm.Group] = None,
                      concept_ip_adapters: Sequence = (),
                      ip_scale: float = 1.0,
                      base_controlnets: Sequence = (),
                      concept_controlnets: Sequence = (),
                      cache_interval=0) -> torch.Tensor:
    """Stage-2 loop over steps [i0, S) on the reference's 4+2K lanes:
    [uncond_A, uncond_B, cond_A, cond_B] from both latent copies, then
    concept k's (uncond, cond) pair on lanes 4+2k, 4+2k+1, fed copy B's
    latent (row 3). One UNet forward per step; P2P reads lane 2 and edits
    lane 3. latents: [2, h, w, 4] (copy A, copy B) -> the same, final.
    With no concept it is ``denoise_multiconcept`` from step ``i0``.

    ``lane_sharding``: the group whose ranks split the 4+2K lanes
    (``tensor_split`` order; at least one lane each). Each rank keeps the
    conditioning, LoRA and IP rows of its lanes and runs them; the eps of
    all lanes are then gathered, so region fusion, CFG and the scheduler
    step run the same on every rank and every rank carries the same
    latents.

    The base ControlNets run on the base lanes [:4] (rows 2 and 3
    conditional) and the concept ControlNets on the 2K concept lanes;
    under ``lane_sharding`` each rank runs them on the base and concept
    lanes it holds (none: that side's forward does not run there), and
    its residuals follow its lane order. ``cache_interval``: DeepCache
    over the lanes (each rank keeps its lanes' feature under
    ``lane_sharding``)."""
    K = len(concept_inputs)
    if K == 0 and dc_on(cache_interval):
        raise ValueError(
            "cache_interval on the 4+2K program needs >=1 concept "
            "(zero-concept stage 2 takes the plain CFG path)")
    if K == 0 and lane_sharding is not None:
        raise ValueError(
            "lane_sharding requires at least one concept (zero-concept "
            "stage 2 is a plain CFG denoise; run it unsharded)")
    if K == 0:
        return denoise_multiconcept(
            cfg, sched, unet, latents, base_inputs, controller, (), (), masks,
            True, fusion_start=fusion_start,
            base_controlnets=base_controlnets, i0=i0, state=state)
    embeds, tembeds, tids, lane_lora, ip_ctx = _concept_lane_conditioning(
        [concept_inputs], [concept_loras], unet.cfg.dtype,
        [(base_inputs.prompt_embeds, base_inputs.text_embeds,
          base_inputs.time_ids)])
    c_tembeds, c_tids = tembeds[4:], tids[4:]
    ipk = concept_ip_adapters[0] if concept_ip_adapters else None
    n = 4 + 2 * K
    lanes = (mesh_lib.Split(n, lane_sharding) if lane_sharding is not None
             else None)
    lo, hi = (lanes.lo, lanes.hi) if lanes is not None else (0, n)
    embeds, tembeds, tids = embeds[lo:hi], tembeds[lo:hi], tids[lo:hi]
    lane_lora = lora_lib.lane_slice(lane_lora, lo, hi)
    ip_ctx = ip_ctx[lo:hi] if ip_ctx is not None else None
    # the base lanes [b_lo, b_hi) and concept lanes [4 + c_lo, 4 + c_hi)
    # this rank holds
    b_lo, b_hi = min(lo, 4), min(hi, 4)
    c_lo, c_hi = max(lo, 4) - 4, max(hi, 4) - 4
    masks = masks.to(latents.dtype)
    x, st = latents, state
    dc = _DeepCache(cache_interval, i0)
    for i in profiling.steps(i0, sched.num_steps):
        t = int(sched.timesteps[i])
        lin4 = schedulers.scale_model_input(sched, torch.cat([x, x]), i)
        rows = torch.cat([lin4[b_lo:b_hi],
                          lin4[3:4].expand((c_hi - c_lo,)
                                           + lin4.shape[1:])])
        ctrl = (controller.at_step(i, lanes=lanes)
                if controller is not None else None)

        def residuals():
            base = concept = (None, None)
            if b_hi > b_lo:
                base = _controlnet_residuals(
                    base_controlnets, lin4[b_lo:b_hi], t,
                    base_inputs.prompt_embeds[b_lo:b_hi],
                    base_inputs.text_embeds[b_lo:b_hi],
                    base_inputs.time_ids[b_lo:b_hi], step_i=i,
                    num_steps=sched.num_steps, cond_rows=(2, 3), lo=b_lo)
            if c_hi > c_lo:
                concept = _concept_cn_residuals(
                    concept_controlnets, concept_inputs, rows[b_hi - b_lo:],
                    t, c_tembeds[c_lo:c_hi], c_tids[c_lo:c_hi], step_i=i,
                    num_steps=sched.num_steps, lo=c_lo)
            return _lane_residuals(base, concept, b_hi - b_lo, c_hi - c_lo)
        eps_all = dc.step(unet, i, rows, t, embeds, residuals,
                          text_embeds=tembeds, time_ids=tids, lora=lane_lora,
                          control=ctrl, ip_adapter=ipk, ip_context=ip_ctx,
                          ip_scale=ip_scale)
        if lanes is not None:
            eps_all = comm.all_gather(eps_all, 0, lane_sharding,
                                      sizes=lanes.sizes)
        region_preds = eps_all[4:].reshape((K, 2) + tuple(x.shape[1:]))
        eps = regions.fuse_region_noise(eps_all[:4], region_preds, masks,
                                        active=i > fusion_start)
        guided = sampling.cfg_combine(eps, base_inputs.guidance_scale)
        x, st = schedulers.step(sched, st, guided, i, x,
                                shared_batch_noise=True)
    return x


def sample_stage1_cached(cfg: sdxl.SDXLConfig, sched: schedulers.Schedule,
                         unet, *, generator: Optional[torch.Generator],
                         height: int, width: int, base_inputs: BaseInputs,
                         fusion_start: int = regions.FUSION_START_STEP,
                         base_controlnets: Sequence = (),
                         spatial: Optional[Spatial] = None,
                         record_trajectory: bool = True,
                         initial_noise=None,
                         cache_interval: int = 0,
                         noise_seed: Optional[int] = None) -> tuple:
    """Stage 1 on the dedup fast path -> ([2, h, w, 4] latents, StageCache).

    ``initial_noise`` ([1, h, w, 4] unit noise) replaces the draw from
    ``generator``, so two implementations can be fed the same noise.
    ``spatial``: the multi-device layout (every rank draws the same noise
    and gets the whole latents back). ``record_trajectory=False`` skips
    the suffix's per-step store (cache.a_traj is None): the 4+2K stage 2
    never reads it. ``base_controlnets``: spatial ControlNets
    (``ControlNetInputs``). ``noise_seed``: the request's seed, LCM's
    re-noise seed (the state carries it into stage 2).
    ``cache_interval``: DeepCache (approximate, opt-in) in the prefix and
    the suffix, each phased from its own start."""
    device = base_inputs.prompt_embeds.device
    if initial_noise is not None:
        lat = schedulers.scale_initial_noise(sched, profiling.sync(
            torch.tensor, np.asarray(initial_noise, np.float32),
            device=device).to(cfg.unet.dtype))
    else:
        lat = sdxl.prepare_latents(generator, 1, height, width, sched,
                                   cfg.unet.dtype, device)
    state = schedulers.init_state(noise_seed)
    boundary = min(fusion_start + 1, sched.num_steps)
    lat_b, st_b = _denoise_cfg_range(cfg, sched, unet, lat, state,
                                     base_inputs, i0=0, i1=boundary,
                                     spatial=spatial,
                                     base_controlnets=base_controlnets,
                                     cache_interval=cache_interval)
    out = _denoise_cfg_range(
        cfg, sched, unet, lat_b, st_b, base_inputs, i0=boundary,
        i1=sched.num_steps, record_traj=record_trajectory, spatial=spatial,
        base_controlnets=base_controlnets, cache_interval=cache_interval)
    lat_end, traj = out[0], (out[2] if record_trajectory else None)
    cache = StageCache(lat_b, st_b, a_traj=traj, a_final=lat_end)
    return duplicate_latents(lat_end), cache


def _denoise_cropped_batch(
        sched: schedulers.Schedule, unet, xs: list, states: list,
        trajs: Sequence[torch.Tensor], base_inputs_r: Sequence[BaseInputs],
        controller, concept_inputs_r, concept_loras_r,
        masks_r: Sequence[torch.Tensor], *, i0: int, fusion_start: int,
        concept_ip_adapters: Sequence = (), ip_scale: float = 1.0,
        base_controlnets: Sequence = ()) -> list:
    """APPROXIMATE stage-2 suffix of R requests with the concept lanes on
    vertical strips (opt-in ``concept_crop``; the JAX ``vmap`` of
    ``_denoise_mc_range_traj_cropped``) -> each request's copy-B final.
    The base lanes' eps equal the exact program's; a concept's
    self-attention and convs no longer see the other strips, and
    ``masks_r`` must be clipped to them (``check_crop_strips``).

    Per step, two UNet forwards for the whole batch: the 3R base lanes
    [cond_A, uncond_B, cond_B] of every request full-frame (P2P editing
    each request's pair (3r, 3r + 2), ``base_controlnets`` on these lanes
    with 3r and 3r + 2 conditional), and the 2KR strip lanes, request r's
    concept k on lanes 2(rK + k), 2(rK + k) + 1 with its LoRA and IP
    tokens. Then per request: the strips written back into a full-frame
    region prediction, fusion with its ``masks_r`` (clipped to the
    strips), CFG and its own scheduler step. ``xs``/``states``: copy B's
    latents [1, h, w, 4] and scheduler states at step ``i0``, per request
    (updated in place); ``trajs``: copy A's recorded inputs from ``i0``."""
    R, K = len(xs), len(concept_inputs_r[0])
    b_embeds, b_tembeds, b_tids = (torch.cat(f) for f in zip(
        *_base_rows(base_inputs_r, [2, 1, 3])))   # [cond_A, uncond_B, cond_B]
    c_embeds, c_tembeds, c_tids, lane_lora, ip_ctx = \
        _concept_lane_conditioning(concept_inputs_r, concept_loras_r,
                                   unet.cfg.dtype)
    cond_rows = tuple(j for r in range(R) for j in (3 * r, 3 * r + 2))
    ipk = concept_ip_adapters[0] if concept_ip_adapters else None
    frame = tuple(xs[0].shape[1:])
    ws = frame[1] // K
    masks_r = [m.to(xs[0].dtype) for m in masks_r]
    pairs = [(3 * r, 3 * r + 2) for r in range(R)]
    for i in profiling.steps(i0, sched.num_steps):
        t = int(sched.timesteps[i])
        lin_b = [schedulers.scale_model_input(sched, torch.cat([x, x]), i)
                 for x in xs]
        lanes_b = torch.cat([torch.cat([schedulers.scale_model_input(
            sched, trajs[r][i - i0], i), lin_b[r]]) for r in range(R)])
        ctrl = (controller.at_step(i, pairs=pairs)
                if controller is not None else None)
        down, mid = _controlnet_residuals(
            base_controlnets, lanes_b, t, b_embeds, b_tembeds, b_tids,
            step_i=i, num_steps=sched.num_steps, cond_rows=cond_rows)
        eps_base = unet(lanes_b, t, b_embeds, text_embeds=b_tembeds,
                        time_ids=b_tids, control=ctrl,
                        down_block_residuals=down, mid_block_residual=mid)
        lanes_c = torch.cat([
            lb[1:2, :, k * ws:(k + 1) * ws].expand((2, frame[0], ws,
                                                     frame[2]))
            for lb in lin_b for k in range(K)])
        eps_c = unet(lanes_c, t, c_embeds, text_embeds=c_tembeds,
                     time_ids=c_tids, lora=lane_lora, ip_adapter=ipk,
                     ip_context=ip_ctx, ip_scale=ip_scale)
        for r in range(R):
            region_preds = eps_c.new_zeros((K, 2) + frame)
            for k in range(K):
                lane = 2 * (r * K + k)
                region_preds[k, :, :, k * ws:(k + 1) * ws] = \
                    eps_c[lane:lane + 2]
            fused = regions.fuse_region_edit(
                eps_base[3 * r + 1:3 * r + 3], region_preds, masks_r[r],
                active=i > fusion_start)
            guided = sampling.cfg_combine(fused,
                                          base_inputs_r[r].guidance_scale)
            xs[r], states[r] = schedulers.step(sched, states[r], guided, i,
                                               xs[r], shared_batch_noise=True)
    return xs


_CROP_NEEDS = ("concept_crop requires the trajectory cache, >=1 concept, no "
              "per-concept ControlNets, and no lane_sharding (base-row "
              "spatial ControlNets compose: the base rows run full-frame)")


def crop_strips_ok(cfg: sdxl.SDXLConfig, latent_w: int, k: int) -> bool:
    """Whether ``latent_w`` splits into k strips whose width survives the
    UNet's downsample/upsample round trip (the concept-crop
    precondition)."""
    ds = 2 ** (len(cfg.unet.block_out_channels) - 1)
    return k > 0 and latent_w % k == 0 and (latent_w // k) % ds == 0


def check_crop_strips(cfg: sdxl.SDXLConfig, masks: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Check the strip geometry and return the masks clipped to their
    strips."""
    if not crop_strips_ok(cfg, masks.shape[-1], k):
        raise ValueError(
            f"latent width {masks.shape[-1]} not divisible into "
            f"{k} UNet-compatible strips")
    return clip_masks_to_strips(masks, k)


def check_crop_batch(cfg: sdxl.SDXLConfig, masks_r: torch.Tensor, k: int,
                     cache_interval=0, concept_cn_params=None) -> list:
    """Refuse what the batched strip program cannot run (DeepCache, an
    IdentityNet on the concept lanes, no concept, a strip geometry the
    UNet does not round-trip) and return each request's masks [K, h, w]
    clipped to the strips."""
    if dc_on(cache_interval):
        raise ValueError("cache_interval and concept_crop are exclusive")
    if k == 0 or concept_cn_params is not None:
        raise ValueError(_CROP_NEEDS)
    return [check_crop_strips(cfg, m, k) for m in masks_r]


def clip_masks_to_strips(masks: torch.Tensor, n_strips: int) -> torch.Tensor:
    """[K, h, w] masks -> each clipped to its vertical strip, columns
    [k w/K, (k+1) w/K)."""
    K, _, w = masks.shape
    assert K == n_strips, (K, n_strips)
    ws = w // n_strips
    cols = torch.arange(w, device=masks.device)
    windows = torch.stack([(cols >= k * ws) & (cols < (k + 1) * ws)
                           for k in range(n_strips)]).to(masks.dtype)
    return masks * windows[:, None, :]


def two_stage_latents(cfg: sdxl.SDXLConfig, sched: schedulers.Schedule,
                      unet, latents0: torch.Tensor, base_inputs: BaseInputs,
                      controller, concept_inputs, concept_loras,
                      masks: torch.Tensor, *,
                      fusion_start: int = regions.FUSION_START_STEP,
                      concept_ip_adapters: Sequence = (),
                      ip_scale: float = 1.0,
                      noise_seed: Optional[int] = None,
                      concept_crop: bool = False,
                      cache_interval=0) -> tuple:
    """Both stages from ``latents0`` ([1, h, w, 4], already scaled) with
    the masks given up front -> (stage-1 latents [2, ...], stage-2 latents
    [2, ...]), with no host read between the stages. ``concept_crop``:
    the strip program (masks clipped here); ``cache_interval``: DeepCache
    in every range; the two are exclusive. ``noise_seed``: LCM's re-noise
    seed."""
    if dc_on(cache_interval) and concept_crop:
        raise ValueError("cache_interval and concept_crop are exclusive")
    state = schedulers.init_state(noise_seed)
    boundary = min(fusion_start + 1, sched.num_steps)
    lat_b, st_b = _denoise_cfg_range(cfg, sched, unet, latents0, state,
                                     base_inputs, i0=0, i1=boundary,
                                     cache_interval=cache_interval)
    lat1, _, traj = _denoise_cfg_range(
        cfg, sched, unet, lat_b, st_b, base_inputs, i0=boundary,
        i1=sched.num_steps, record_traj=True, cache_interval=cache_interval)
    if len(concept_inputs) == 0 or traj.shape[0] == 0:
        return duplicate_latents(lat1), duplicate_latents(lat1)
    return duplicate_latents(lat1), sample_stage2_resumed(
        cfg, sched, unet, StageCache(lat_b, st_b, traj, lat1),
        base_inputs=base_inputs, controller=controller,
        concept_inputs=concept_inputs, concept_loras=concept_loras,
        masks=masks, fusion_start=fusion_start,
        concept_ip_adapters=concept_ip_adapters, ip_scale=ip_scale,
        concept_crop=concept_crop, cache_interval=cache_interval)


def sample_stage2_resumed(cfg: sdxl.SDXLConfig, sched: schedulers.Schedule,
                          unet, cache: StageCache, *,
                          base_inputs: BaseInputs, controller,
                          concept_inputs: Sequence, concept_loras: Sequence,
                          masks: torch.Tensor,
                          fusion_start: int = regions.FUSION_START_STEP,
                          concept_ip_adapters: Sequence = (),
                          ip_scale: float = 1.0,
                          base_controlnets: Sequence = (),
                          concept_controlnets: Sequence = (),
                          lane_sharding=None, concept_crop: bool = False,
                          cache_interval=0) -> torch.Tensor:
    """Stage 2 resumed from the cached boundary -> [2, h, w, 4].

    With copy A's recorded trajectory, at least one concept and no lane
    sharding, the 3+2K-lane trajectory program runs (copy A's final latent
    is stage 1's). Otherwise the reference-layout 4+2K program carries
    both copies from the boundary; ``lane_sharding`` (a
    ``parallel.comm.Group``, multi-device latency mode) splits its lanes
    over the group's ranks.

    ``concept_ip_adapters``: per concept, the UNet's IP layers (one
    ``IPKV`` per attn2; the first entry serves every lane, as in JAX),
    scaled by ``ip_scale``. ``base_controlnets``/``concept_controlnets``:
    ``ControlNetInputs`` on the base lanes and per concept (None for a
    concept without one; the live ones share one model).

    ``cache_interval``: DeepCache on whichever program runs (never with
    ``concept_crop`` or zero concepts). ``concept_crop``: the strip
    program (masks clipped to the strips here); it needs the trajectory,
    a concept, no per-concept ControlNet and no lane sharding."""
    validate_concept_controlnets(concept_controlnets)
    boundary = min(fusion_start + 1, sched.num_steps)
    if dc_on(cache_interval) and (concept_crop or len(concept_inputs) == 0):
        raise ValueError(
            "cache_interval needs a full-frame concept program "
            "(no concept_crop, >=1 concept) — it runs on the 3+2K "
            "trajectory path, the 4-row fallback, or the lane-sharded "
            "4+2K mesh program")
    kw = dict(i0=boundary, fusion_start=fusion_start,
              concept_ip_adapters=tuple(concept_ip_adapters),
              ip_scale=ip_scale, base_controlnets=tuple(base_controlnets))
    K = len(concept_inputs)
    if concept_crop and (cache.a_traj is None or K == 0
                         or lane_sharding is not None
                         or any(c is not None for c in concept_controlnets)):
        raise ValueError(_CROP_NEEDS)
    if concept_crop or (cache.a_traj is not None and cache.a_traj.shape[0]
                        and lane_sharding is None and K > 0):
        args = (sched, unet, [cache.latents], [cache.sched_state],
                [cache.a_traj], [base_inputs], controller,
                [tuple(concept_inputs)], [tuple(concept_loras)])
        if concept_crop:
            (lat_b,) = _denoise_cropped_batch(
                *args, [check_crop_strips(cfg, masks, K)], **kw)
        else:
            (lat_b,) = _denoise_traj_batch(
                *args, [masks],
                concept_controlnets_r=[tuple(concept_controlnets)],
                cache_interval=cache_interval, **kw)
        return torch.cat([cache.a_final, lat_b])
    # Both copies from the boundary latents: the state's per-row history
    # (DPM++2M's previous x0) is doubled with them, as in JAX.
    st = cache.sched_state
    if st.prev_model_output is not None:
        st = st._replace(prev_model_output=duplicate_latents(
            st.prev_model_output))
    return _denoise_mc_range(
        cfg, sched, unet, duplicate_latents(cache.latents), st,
        base_inputs, controller, tuple(concept_inputs), tuple(concept_loras),
        masks, lane_sharding=lane_sharding,
        concept_controlnets=tuple(concept_controlnets),
        cache_interval=cache_interval, **kw)


def sample_stage(cfg: sdxl.SDXLConfig, sched: schedulers.Schedule, unet, *,
                 generator: Optional[torch.Generator] = None, height: int,
                 width: int, base_inputs: BaseInputs, controller,
                 concept_inputs: Sequence[ConceptInputs] = (),
                 concept_loras: Sequence[Optional[dict]] = (),
                 masks: Optional[torch.Tensor] = None, stage: int = 1,
                 fusion_start: int = regions.FUSION_START_STEP,
                 concept_ip_adapters: Sequence = (), ip_scale: float = 1.0,
                 base_controlnets: Sequence = (),
                 concept_controlnets: Sequence = (),
                 initial_noise=None,
                 noise_seed: Optional[int] = None) -> torch.Tensor:
    """One OMG stage end to end in the reference's layout: the seed's
    noise duplicated to both latent copies, then ``denoise_multiconcept``
    -> [2, h, w, 4]. Stage 1 and stage 2 take the same draw (the same
    ``generator`` seed or ``initial_noise``, [1, h, w, 4] unit noise), so
    stage 2 re-runs stage 1's steps up to the fusion gate; ``masks``
    [K, h, w] default to zeros."""
    validate_concept_controlnets(concept_controlnets)
    device = base_inputs.prompt_embeds.device
    if initial_noise is not None:
        lat = schedulers.scale_initial_noise(sched, profiling.sync(
            torch.tensor, np.asarray(initial_noise, np.float32),
            device=device).to(cfg.unet.dtype))
    else:
        lat = sdxl.prepare_latents(generator, 1, height, width, sched,
                                   cfg.unet.dtype, device)
    if masks is None:
        masks = torch.zeros((len(concept_inputs), height // 8, width // 8),
                            device=device)
    return denoise_multiconcept(
        cfg, sched, unet, duplicate_latents(lat), base_inputs, controller,
        tuple(concept_inputs), tuple(concept_loras), masks, stage == 2,
        concept_ip_adapters=tuple(concept_ip_adapters),
        fusion_start=fusion_start, ip_scale=ip_scale,
        base_controlnets=tuple(base_controlnets),
        concept_controlnets=tuple(concept_controlnets), noise_seed=noise_seed)


# --------------------------------------------------------------------------
# Request-axis batching (serving): R requests of one geometry, step count
# and scheduler as one UNet forward per step. Each request's lanes are
# contiguous; CFG, fusion and the scheduler step run on its slice.
# --------------------------------------------------------------------------


def _base_cn_lanes(params, conds_r: Optional[tuple], lanes: int) -> tuple:
    """A shared spatial ControlNet's per-request conditioning (cond
    [R, 1, H, W, C], scale [R], guidance_start [R], guidance_end [R]) over
    ``lanes`` contiguous lanes per request -> () or (ControlNetInputs,)
    with everything per lane."""
    if params is None or conds_r is None:
        return ()
    cond, scale, gs, ge = conds_r

    def rep(v):
        return [float(x) for x in v for _ in range(lanes)]
    return (ControlNetInputs(
        params, cond.repeat_interleave(lanes, 0).flatten(0, 1),
        scale=rep(scale), guidance_start=rep(gs), guidance_end=rep(ge)),)


def _concept_cn_lanes(params, conds_r: Optional[tuple], R: int) -> list:
    """A shared IdentityNet's per-request conditioning (per concept None
    or (cond_image [R, 1, H, W, C], scale [R], ehs [R, 2, T, D] or None))
    -> per request, a ``ControlNetInputs`` or None for each concept (None
    where its scale is 0: an exact no-op lane pair)."""
    if params is None or conds_r is None:
        return [()] * R
    return [tuple(
        None if c is None or not float(c[1][r]) else ControlNetInputs(
            params, c[0][r], scale=float(c[1][r]),
            encoder_hidden_states=None if c[2] is None else c[2][r])
        for c in conds_r) for r in range(R)]


def sample_stage1_batch(cfg: sdxl.SDXLConfig, sched: schedulers.Schedule,
                        unet, seeds: Sequence[int],
                        base_inputs_r: Sequence[BaseInputs], *, height: int,
                        width: int,
                        fusion_start: int = regions.FUSION_START_STEP,
                        base_cn_params=None,
                        base_cn_conds_r: Optional[tuple] = None,
                        cache_interval: int = 0,
                        initial_noise: Optional[Sequence] = None) -> tuple:
    """Batched stage 1: per-request seeds and ``BaseInputs`` ->
    (latents [R, 2, h, w, 4], one ``StageCache`` per request, its
    trajectory recorded).

    Request r's initial latents come from a CPU generator seeded with
    ``seeds[r]`` (``generate``'s draw); its scheduler state carries the
    seed (LCM). The 2R lanes [uncond_0, cond_0, uncond_1, ...] run as one
    forward per step (``_denoise_cfg_batch``, over the prefix and then the
    suffix, as ``sample_stage1_cached`` runs one request).
    ``base_cn_params`` + ``base_cn_conds_r``: a shared
    spatial ControlNet with per-request conditioning (cond_image
    [R, 1, H, W, C], scale [R], guidance_start [R], guidance_end [R]);
    requests without a condition ride along with scale 0.
    ``cache_interval``: DeepCache over the 2R lanes, phased from each
    range's start. ``initial_noise``: per request, [1, h, w, 4] unit noise
    in place of the seed's draw (the seed still seeds LCM's re-noise)."""
    device = base_inputs_r[0].prompt_embeds.device
    if initial_noise is not None:
        xs = [schedulers.scale_initial_noise(sched, profiling.sync(
            torch.tensor, np.asarray(n, np.float32),
            device=device).to(cfg.unet.dtype))
            for n in initial_noise]
    else:
        xs = [sdxl.prepare_latents(
            torch.Generator("cpu").manual_seed(int(s)), 1, height, width,
            sched, cfg.unet.dtype, device) for s in seeds]
    states = [schedulers.init_state(int(s)) for s in seeds]
    kw = dict(base_controlnets=_base_cn_lanes(base_cn_params,
                                              base_cn_conds_r, 2),
              cache_interval=cache_interval)
    lanes = _cfg_lanes(base_inputs_r)
    guidance_r = [b.guidance_scale for b in base_inputs_r]
    boundary = min(fusion_start + 1, sched.num_steps)
    xs, states, _ = _denoise_cfg_batch(sched, unet, xs, states, lanes,
                                       guidance_r, i0=0, i1=boundary, **kw)
    caches = [StageCache(x, st) for x, st in zip(xs, states)]
    xs, states, trajs = _denoise_cfg_batch(
        sched, unet, xs, states, lanes, guidance_r, i0=boundary,
        i1=sched.num_steps, record_traj=True, **kw)
    caches = [c._replace(a_traj=traj, a_final=x)
              for c, traj, x in zip(caches, trajs, xs)]
    return torch.stack([duplicate_latents(x) for x in xs]), caches


def sample_stage2_batch(cfg: sdxl.SDXLConfig, sched: schedulers.Schedule,
                        unet, cache_r: Sequence[StageCache],
                        base_inputs_r: Sequence[BaseInputs], controller,
                        concept_inputs_r: Sequence[Sequence[ConceptInputs]],
                        concept_loras_r: Sequence[Sequence[Optional[dict]]],
                        masks_r: torch.Tensor, *,
                        fusion_start: int = regions.FUSION_START_STEP,
                        ip_scale: float = 1.0,
                        concept_ip_adapters: Sequence = (),
                        concept_cn_params=None,
                        concept_cn_conds_r: Optional[tuple] = None,
                        base_cn_params=None,
                        base_cn_conds_r: Optional[tuple] = None,
                        cache_interval: int = 0,
                        concept_crop: bool = False) -> torch.Tensor:
    """Batched stage 2 -> [R, 2, h, w, 4]: the 3+2K trajectory program of
    every request in one forward per step over R(3+2K) lanes
    (``_denoise_traj_batch``; ``sample_stage2_resumed`` runs it with
    R = 1), or with ``concept_crop`` the strip program
    (``_denoise_cropped_batch``: the 3R base lanes and the 2KR strip lanes
    as two forwards per step; each request's masks clipped to the strips
    here).

    ``concept_inputs_r``/``concept_loras_r``: [request][concept], every
    request with the same K (pad with neutral concepts and zero masks);
    ``masks_r`` [R, K, h, w]. The controller is shared (``OMG`` builds it
    from [prompt, prompt], so it does not depend on the request) and
    edits each request's (cond_A, cond_B) lane pair. InstantID: the
    concepts' ``ip_context`` tokens (zeros for a slot without a face) with
    the shared ``concept_ip_adapters`` at ``ip_scale``;
    ``concept_cn_params`` + ``concept_cn_conds_r``, a tuple over K of None
    or (cond_image [R, 1, H, W, C], scale [R], ehs [R, 2, T, D] or None):
    the shared IdentityNet on the concept lanes. ``base_cn_params`` +
    ``base_cn_conds_r``: the spatial ControlNet on the 3 base lanes, as in
    ``sample_stage1_batch``. With an empty suffix (``fusion_start + 1 >=
    steps``) every request returns stage 1's copy A twice.
    ``cache_interval``: DeepCache over the R(3+2K) lanes; not with
    ``concept_crop``, which takes no IdentityNet either and needs K >= 1.
    """
    R, K = len(cache_r), len(concept_inputs_r[0])
    if concept_crop:
        masks_r = check_crop_batch(cfg, masks_r, K, cache_interval,
                                   concept_cn_params)
    boundary = min(fusion_start + 1, sched.num_steps)
    if boundary >= sched.num_steps:
        return torch.stack([duplicate_latents(c.a_final) for c in cache_r])
    args = (sched, unet, [c.latents for c in cache_r],
            [c.sched_state for c in cache_r], [c.a_traj for c in cache_r],
            base_inputs_r, controller, concept_inputs_r, concept_loras_r,
            masks_r)
    kw = dict(i0=boundary, fusion_start=fusion_start,
              concept_ip_adapters=concept_ip_adapters, ip_scale=ip_scale,
              base_controlnets=_base_cn_lanes(base_cn_params,
                                              base_cn_conds_r, 3))
    if concept_crop:
        xs = _denoise_cropped_batch(*args, **kw)
    else:
        xs = _denoise_traj_batch(
            *args, concept_controlnets_r=_concept_cn_lanes(
                concept_cn_params, concept_cn_conds_r, R),
            cache_interval=cache_interval, **kw)
    return torch.stack([torch.cat([c.a_final, x])
                        for c, x in zip(cache_r, xs)])
