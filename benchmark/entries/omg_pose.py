"""``OMG.generate`` with a spatial ControlNet: one two-concept request at a
time, one LoRA per concept and the OpenPose ControlNet on the base lanes
of both stages, built as ``cli/inference_lora.py`` builds its engine
(the ControlNet through ``convert.convert_controlnet``, the pose image
handed in as ``spatial_condition``), the concept masks as ``masks=``.

Each request's pose image (two standing people, one in each box, from
the mix's template and the request's seed) is drawn by the port's
``models/openpose.draw_bodypose`` in ``setup``, before the window: a CLI
user hands in a ready image.

Compared, each as the worst of its rows: ``omg_generate``'s numbers
(``eps_gap`` at stage 1's first and last steps and stage 2's first and
last, ``step_gap`` at stage 1's first, ``decode_gap_levels`` of both
decodes) against ``reference/pose.py``, whose steps run the ControlNet
on the base rows; ``cn_residual_gap``: the ControlNet's residuals (every
skip's and the mid block's) of the first forward of stage 1 (2 lanes)
and of stage 2 (3 lanes), against the reference's from the same scaled
latents, so that a ControlNet run at another scale or not at all shows;
and ``cn_cond_gap``: the condition path, the image that the conditioning
embedder takes and the embedding it returns in its first call of each
lane count, against the request's pose image and the reference's
embedding of it. The residuals cannot tell the pose image from a blank
one (with random weights the embedding is mostly its biases' and the
skeleton moves it ~1%); the embedder's input can, and so a blank, stale,
rescaled or channel-swapped image shows there. Each gap is a mean
|program - reference| over mean |reference|.

The taps copy what they read into pinned host buffers made in the
warm-up, without blocking: nothing of theirs stays on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark import compare, generator, program, weights
from benchmark import flops_controlnet as fc
from benchmark import flops_instantid as fli
from benchmark import weights_instantid as wi
from benchmark.entries import omg_generate as og
from benchmark.entries import omg_instantid as oi
from benchmark.reference import pipelines as ref
from benchmark.reference import pose as ref_pose
from omg_tpu_torch import convert
from omg_tpu_torch.models import openpose
from omg_tpu_torch.pipelines import omg

STREAMS = {"controlnet": 310, "poses": 311}
WARMUP_STEPS = og.WARMUP_STEPS      # stage 1 at 2 lanes, stage 2 at 7 inside
WARMUP_FUSION = og.WARMUP_FUSION    # P2P's window, the ControlNet in both
PAD = 16            # pixels around a stick's or a dot's keypoints that its
                    # drawing may touch (sticks 4 wide, dots of radius 4)

taps, images, unet_lanes = og.taps, og.images, og.unet_lanes


class State(NamedTuple):
    engine: omg.OMG
    controlnet: object          # models.controlnet.ControlNetModel
    loras: list
    masks: list                 # per concept [H, W] 0/1 pixels
    poses: dict                 # request index -> uint8 [H, W, 3]
    steps: program.Steps
    residuals: HostTap
    conditions: HostTap


class HostTap:
    """What a forward hook on ``module`` picks from a call (``pick(args,
    out)`` -> (key, tensors)), kept from the first call of each key in a
    request: copied without blocking into pinned host buffers made the
    first time the key is seen (in the warm-up), so that nothing stays on
    the card and the host does not wait. ``take`` hands a request's
    copies over once it has ended."""

    def __init__(self, module: torch.nn.Module, pick):
        self.pick, self.bufs, self.seen = pick, {}, set()
        self.handle = module.register_forward_hook(self._hook)

    def _hook(self, mod, args, out):
        key, ts = self.pick(args, out)
        if key in self.seen:
            return
        bufs = self.bufs.get(key)
        if bufs is None or [b.shape for b in bufs] != [t.shape for t in ts]:
            bufs = self.bufs[key] = [
                torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
                for t in ts]
        for b, t in zip(bufs, ts):
            b.copy_(t, non_blocking=True)
        self.seen.add(key)

    def take(self) -> dict:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        out = {k: [b.clone() for b in self.bufs[k]] for k in self.seen}
        self.seen = set()
        return out

    def close(self) -> None:
        self.handle.remove()


def residual_tap(cn) -> HostTap:
    """The ControlNet's scaled latents, down residuals and mid residual,
    by lane count: stage 1's 2 CFG lanes, stage 2's 3 base lanes."""
    return HostTap(cn, lambda args, out: (args[0].shape[0],
                                          [args[0], *out[0], out[1]]))


def condition_tap(cn) -> HostTap:
    """The conditioning embedder's input image (NCHW, the program's type)
    and its output, by the number of images it embeds."""
    return HostTap(cn.controlnet_cond_embedding,
                   lambda args, out: (args[0].shape[0], [args[0], out]))


def controlnet_config(cfg: dict):
    """The port's geometry of the configuration's ControlNet: the
    IdentityNet's ``identitynet_config`` over the ``controlnet`` block."""
    return oi.identitynet_config(dict(
        cfg, identitynet=cfg["controlnet"],
        precision=dict(cfg["precision"],
                       identitynet=cfg["precision"]["controlnet"])))


@torch.no_grad()
def controlnet_state_dict(cfg: dict, seed: int, device) -> dict:
    """The seed's ControlNet in checkpoint layout, in its served type."""
    return weights.make_state_dict(
        wi.identitynet_spec(cfg["controlnet"]), seed, STREAMS["controlnet"],
        device=device, dtype=program.DTYPES[cfg["precision"]["controlnet"]])


def keypoints(mix: dict, req: dict, height: int, width: int) -> list:
    """Per box a person's 18 keypoints [18, 2] (x, y) in pixels: the mix's
    template in the box, each coordinate moved by up to ``jitter`` of
    the box's size from the request's seed."""
    pose = mix["pose"]
    tmpl = np.asarray(pose["template"], np.float64)
    out = []
    for k, (x0, y0, x1, y1) in enumerate(mix["masks"]):
        rng = np.random.default_rng(weights.stream_seed(
            req["seed"], STREAMS["poses"], k))
        size = np.array([(x1 - x0) * width, (y1 - y0) * height])
        frac = tmpl + rng.uniform(-pose["jitter"], pose["jitter"], tmpl.shape)
        out.append(np.array([x0 * width, y0 * height]) + frac * size)
    return out


def _draw_part(canvas: np.ndarray, pts: np.ndarray, parts) -> None:
    """``draw_bodypose`` of a person whose only keypoints are ``parts``
    (indices into its 18), on the box around them."""
    h, w = canvas.shape[:2]
    lo = np.maximum(np.floor(pts[parts].min(0)).astype(int) - PAD, 0)
    hi = np.minimum(np.ceil(pts[parts].max(0)).astype(int) + PAD + 1, [w, h])
    cand = np.concatenate([pts - lo, np.ones((len(pts), 1)),
                           np.arange(len(pts))[:, None]], 1)
    subset = np.full((1, len(pts) + 2), -1.0)
    subset[0, parts] = parts
    box = canvas[lo[1]:hi[1], lo[0]:hi[0]]
    box[...] = openpose.draw_bodypose(box.copy(), cand, subset)


def _draw_person(canvas: np.ndarray, pts: np.ndarray) -> None:
    """One person as ``draw_bodypose`` draws it on the whole canvas, in a
    few ms where that takes ~1 s: each stick alone on the box around it,
    in the same order, then each dot. A stick's blend leaves every pixel
    outside the stick as it was, and the dots that a stick's call draws
    early are drawn again, opaque, over the same pixels at the end."""
    for a, b in openpose.LIMB_SEQ[:17]:
        _draw_part(canvas, pts, [a - 1, b - 1])
    for i in range(len(pts)):
        _draw_part(canvas, pts, [i])


def pose_image(mix: dict, req: dict, height: int, width: int) -> np.ndarray:
    """A request's OpenPose condition image, uint8 [H, W, 3]: its people's
    skeletons on black."""
    canvas = np.zeros((height, width, 3), np.uint8)
    for pts in keypoints(mix, req, height, width):
        _draw_person(canvas, pts)
    return canvas


def pose_images(mix: dict, requests: list, height: int, width: int) -> dict:
    """Every request's pose image, by index."""
    return {r["index"]: pose_image(mix, r, height, width) for r in requests}


def setup(ctx) -> State:
    cfg, p = ctx.cfg, ctx.cfg["pipeline"]
    scfg, params = program.build(cfg, ctx.seed, ctx.device)
    cn_cfg = controlnet_config(cfg)
    cn = convert.convert_controlnet(
        controlnet_state_dict(cfg, ctx.seed, ctx.device), cn_cfg,
        device=ctx.device)
    tok = program.tokenizer(cfg)
    engine = omg.OMG(cfg=scfg, params=params, tokenizer=tok, tokenizer_2=tok,
                     cn_cfg=cn_cfg, num_steps=p["num_steps"],
                     concept_lora_scale=p["concept_lora_scale"])
    program.bf16_decode(ctx.control == "bf16_decode")
    loras = program.loras(cfg, ctx.seed, cfg["lora"]["per_request"],
                          ctx.device)
    lat = generator.box_masks(ctx.mix, p["height"] // 8, p["width"] // 8)
    px = [np.kron(m, np.ones((8, 8), np.float32)) for m in lat]
    poses = pose_images(ctx.mix, ctx.requests, p["height"], p["width"])
    state = State(engine, cn, loras, px, poses,
                  program.Steps(taps(p).values()), residual_tap(cn),
                  condition_tap(cn))
    live = engine.params
    for name in ("unet", "text_encoder", "text_encoder_2"):
        ctx.spans.attach(getattr(live, name), "bench." + name)
    ctx.spans.attach(cn, "bench.controlnet")
    _generate(ctx, state, ctx.requests[0], num_steps=WARMUP_STEPS,
              fusion_start=WARMUP_FUSION)
    vae = live.vae.decoder_copy(torch.bfloat16 if ctx.control == "bf16_decode"
                                else scfg.vae.dtype)
    ctx.spans.attach(vae.decoder, "bench.vae_decoder")
    state.residuals.take()
    state.conditions.take()
    state.steps.attach()
    return state


def _generate(ctx, state: State, req: dict, **kw) -> omg.GenerationResult:
    p = ctx.cfg["pipeline"]
    h, w = p["height"], p["width"]
    kw.setdefault("fusion_start", p["fusion_start"])
    return state.engine.generate(
        req["prompt"], negative_prompt=req["negative"],
        prompt_rewrite=og._rewrite(req), concept_loras=state.loras, seed=0,
        height=h, width=w, guidance_scale=p["guidance_scale"],
        spatial_condition=state.poses[req["index"]],
        controlnet_params=state.controlnet,
        controlnet_scale=p["controlnet_scale"],
        control_guidance_start=p["control_guidance_start"],
        control_guidance_end=p["control_guidance_end"], masks=state.masks,
        initial_noise=og._noise(req, h // 8, w // 8).numpy(), **kw)


def run(ctx, state: State, req: dict) -> dict:
    res = _generate(ctx, state, req)
    return {"stage1": res.stage1, "stage2": res.stage2,
            "steps": state.steps.take(), "residuals": state.residuals.take(),
            "conditions": state.conditions.take(),
            "timings": dict(res.timings)}


def flops(cfg: dict, req: dict) -> float:
    """``omg_generate``'s count and the ControlNet's forwards: 2 lanes a
    stage-1 step, the 3 base lanes a stage-2 step."""
    p = cfg["pipeline"]
    lanes = sum(fc.omg_lanes(p))
    return og.flops(cfg, req) + lanes * fli.identitynet_forward(
        cfg["controlnet"], p["height"] // 8, p["width"] // 8,
        ctx_len=fc.TEXT_TOKENS)


def free(state: State) -> None:
    state.residuals.close()
    state.conditions.close()
    state.poses.clear()
    og.free(state)


def residual_gap(got: list, want: list) -> float:
    """The worst lane's mean |program - reference| over mean |reference|
    of any residual (each list: every skip's, then the mid's); residuals
    of another shape or count are infinitely far."""
    if len(got) != len(want):
        return math.inf
    return max(compare.eps_gap(g.to(w.device, torch.float32), w)
               for g, w in zip(got, want))


def cond_gap(got: dict, image: torch.Tensor, emb: torch.Tensor) -> float:
    """The worst row's gap of the embedder's input to the pose image
    ``image`` [1, 3, H, W] and of its output to the reference's embedding
    ``emb`` [1, C, h, w], over the calls ``got`` (images embedded ->
    [input, output]); infinitely far where nothing was embedded."""
    if not got:
        return math.inf
    return max(compare.eps_gap(g.to(w.device, torch.float32),
                               w.expand(g.shape[0], -1, -1, -1))
               for gs in got.values() for g, w in zip(gs, (image, emb)))


def check(ctx, req: dict, out: dict, cast=None) -> dict:
    """The compared numbers of one request of the window; with ``cast``,
    those of the reference computed with it (the control) in the
    program's place, from the same latents."""
    cfg, p = ctx.cfg, ctx.cfg["pipeline"]
    dev = ctx.device
    tap = taps(p)
    seen, res_seen = out["steps"], out["residuals"]
    lost = {"eps_gap": math.inf, "step_gap": math.inf,
            "decode_gap_levels": math.inf, "cn_residual_gap": math.inf,
            "cn_cond_gap": math.inf}
    if set(seen) != set(tap.values()):
        return lost
    prog = {role: [compare.nchw(t) for t in seen[c][1:]] + [seen[c][0]]
            for role, c in tap.items()}             # x, eps, next, step
    if any(v[0].shape != (1, 4, p["height"] // 8, p["width"] // 8)
           for v in prog.values()):
        return lost                     # latents of another shape
    sds = compare.models_fp32(ctx)
    cn_sd = {k: v.float() for k, v in
             controlnet_state_dict(cfg, ctx.seed, dev).items()}
    tok = program.tokenizer(cfg)

    def ids(text):
        t = torch.as_tensor(tok([text]), dtype=torch.long, device=dev)
        return t, t

    lora_sds = weights.lora_state_dicts(cfg, ctx.seed,
                                        cfg["lora"]["per_request"], dev)
    scale = (p["concept_lora_scale"] * cfg["lora"]["alpha"]
             / cfg["lora"]["rank"])
    loras = [ref.lora_lanes(sd, scale) for sd in lora_sds]
    h, w = p["height"] // 8, p["width"] // 8
    masks = torch.as_tensor(generator.box_masks(ctx.mix, h, w), device=dev)
    pose = ref_pose.pose_tensor(pose_image(ctx.mix, req, p["height"],
                                           p["width"]), dev)
    x0 = og._noise(req, h, w).permute(0, 3, 1, 2).to(dev) * ref.Euler(
        cfg["scheduler"], p["num_steps"]).init_sigma
    # the residuals' lanes: stage 1's [uncond, cond] at its first step,
    # stage 2's [cond A, uncond B, cond B] at its first; a stage whose
    # forward never ran reads infinitely far
    res_at = {b: v for b, v in (
        (2, (tap["s1_first"], "ctx2", "pool2", slice(None))),
        (3, (p["fusion_start"] + 1, "ctx7", "pool7", slice(0, 3))))
        if b in res_seen}

    def steps(c):
        """(x, guided, next) of each checked step in the roles' order, the
        residuals of both stages' first ControlNet forwards, and the
        embedder's (input, output) from the pose image."""
        with ref.fp32_math():
            cond = ref.omg_conditioning(
                sds, cfg, ids_pos=ids(req["prompt"]),
                ids_neg=ids(req["negative"]),
                concept_ids=[(ids(rp), ids(rn)) for rp, rn in req["regions"]],
                cast=c)
            res = []
            for role, x in (("s1_first", x0), ("s1_last", None)):
                x = prog[role][0] if x is None else x
                res.append((x,) + ref_pose.omg_stage1_step(
                    sds, cn_sd, cfg, cond, x, prog[role][3], pose, cast=c))
            for role, a in (("s2_first", "s1_at_s2_first"),
                            ("s2_last", "s1_last")):
                x = prog[role][0]
                res.append((x,) + ref_pose.omg_stage2_step(
                    sds, cn_sd, cfg, cond, prog[a][0], x, prog[role][3],
                    loras=loras, masks=masks, pose=pose, cast=c))
            cn_res = {b: ref_pose.residuals(
                cn_sd, cfg, compare.nchw(res_seen[b][0].to(dev)), i,
                cond[ck][rows], cond[pk][rows], pose, c)
                for b, (i, ck, pk, rows) in res_at.items()}
            emb = ref_pose.cond_embedding(cn_sd, pose, c)
        return (res, {b: [*down, mid] for b, (down, mid) in cn_res.items()},
                [pose if c is None else c(pose), emb])

    want, want_res, want_cond = steps(None)
    if cast is None:
        got = [(x, prog[r][1], prog[r][2]) for (x, _, _), r in
               zip(want, ("s1_first", "s1_last", "s2_first", "s2_last"))]
        got_res = {b: v[1:] for b, v in res_seen.items()}
        got_cond = out["conditions"]
    else:
        got, got_res, cast_cond = steps(cast)
        got_cond = {1: cast_cond}
    gaps = {"eps_gap": max(compare.eps_gap(g[1], wt[1])
                           for g, wt in zip(got, want)),
            "step_gap": compare.step_gap(got[0][2], want[0][0], want[0][2]),
            "cn_residual_gap": max(
                [residual_gap(got_res[b], want_res[b]) for b in res_at]
                + [math.inf] * (2 - len(res_at))),
            "cn_cond_gap": cond_gap(got_cond, *want_cond)}
    if cast is None:
        a_end, b_end = prog["s1_last"][2], prog["s2_last"][2]
        gaps["decode_gap_levels"] = max(
            compare.decode_gap(out["stage1"], torch.cat([a_end, a_end]), sds,
                               cfg),
            compare.decode_gap(out["stage2"], torch.cat([a_end, b_end]), sds,
                               cfg))
    return gaps
