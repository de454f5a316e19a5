"""``OMG.generate``: one two-concept request at a time, one LoRA per
concept, the concept masks handed in as ``masks=``.

Compared, each as the worst of its rows: at stage 1's first and last
steps and stage 2's first and last, the guided prediction the program
steps with against the reference's from the same latents (``eps_gap``:
mean |gap| over mean |reference|), where stage 1's first step starts from
the reference's own noise and the others from the latents the program
stepped from; at stage 1's first step the latents after it against the
reference's step (``step_gap``: mean |gap| over the step's mean size;
at later steps the bf16 rounding of the latents is a large share of a
step); and the program's four images against the reference's decode of
the latents its last steps returned (``decode_gap_levels``, mean |gap|
in uint8 levels).
"""

from __future__ import annotations

import gc
import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark import flops as fl
from benchmark import compare, generator, program, weights
from benchmark.reference import pipelines as ref
from omg_tpu_torch.pipelines import omg

WARMUP_STEPS = 5        # stage 1 at 2 lanes, stage 2 at 7 inside P2P's
WARMUP_FUSION = 0       # self-replace window, and both decodes


class State(NamedTuple):
    engine: omg.OMG
    loras: list
    masks: list             # per concept [H, W] 0/1 pixels
    steps: program.Steps


def taps(p: dict) -> dict:
    """The scheduler calls of a request that the check reads, by role:
    stage 1 steps 0..S-1 are calls 0..S-1, stage 2 steps fs+1..S-1 follow
    as calls S.."""
    s, fs = p["num_steps"], p["fusion_start"]
    return {"s1_first": 0, "s1_at_s2_first": fs + 1, "s1_last": s - 1,
            "s2_first": s, "s2_last": 2 * s - fs - 2}


def _noise(req: dict, h: int, w: int) -> torch.Tensor:
    """The request's unit noise [1, h, w, 4] (NHWC, fp32, CPU)."""
    g = torch.Generator("cpu").manual_seed(req["seed"])
    return torch.randn((1, h, w, 4), generator=g, dtype=torch.float32)


def _rewrite(req: dict) -> str:
    return "|".join(f"{p}-*-{n}" for p, n in req["regions"])


def setup(ctx) -> State:
    cfg, p = ctx.cfg, ctx.cfg["pipeline"]
    scfg, params = program.build(cfg, ctx.seed, ctx.device)
    tok = program.tokenizer(cfg)
    engine = omg.OMG(cfg=scfg, params=params, tokenizer=tok, tokenizer_2=tok,
                     num_steps=p["num_steps"],
                     concept_lora_scale=p["concept_lora_scale"])
    program.bf16_decode(ctx.control == "bf16_decode")
    loras = program.loras(cfg, ctx.seed, cfg["lora"]["per_request"],
                          ctx.device)
    lat = generator.box_masks(ctx.mix, p["height"] // 8, p["width"] // 8)
    px = [np.kron(m, np.ones((8, 8), np.float32)) for m in lat]
    state = State(engine, loras, px, program.Steps(taps(p).values()))
    live = engine.params
    for name in ("unet", "text_encoder", "text_encoder_2"):
        ctx.spans.attach(getattr(live, name), "bench." + name)
    _generate(state, p, ctx.requests[0], num_steps=WARMUP_STEPS,
              fusion_start=WARMUP_FUSION)
    vae = live.vae.decoder_copy(torch.bfloat16 if ctx.control == "bf16_decode"
                                else scfg.vae.dtype)
    ctx.spans.attach(vae.decoder, "bench.vae_decoder")
    state.steps.attach()
    return state


def _generate(state: State, p: dict, req: dict, **kw) -> omg.GenerationResult:
    h, w = p["height"], p["width"]
    kw.setdefault("fusion_start", p["fusion_start"])
    return state.engine.generate(
        req["prompt"], negative_prompt=req["negative"],
        prompt_rewrite=_rewrite(req), concept_loras=state.loras, seed=0,
        height=h, width=w, guidance_scale=p["guidance_scale"],
        masks=state.masks, initial_noise=_noise(req, h // 8, w // 8).numpy(),
        **kw)


def run(ctx, state: State, req: dict) -> dict:
    res = _generate(state, ctx.cfg["pipeline"], req)
    return {"stage1": res.stage1, "stage2": res.stage2,
            "steps": state.steps.take(), "timings": dict(res.timings)}


def images(req: dict) -> int:
    return req["images"]


def unet_lanes(cfg: dict) -> list:
    """Lanes of each UNet forward of a request: 2 in stage 1, 3 + 2K in
    stage 2 (after the fusion start)."""
    p = cfg["pipeline"]
    late = p["num_steps"] - p["fusion_start"] - 1
    return [2] * p["num_steps"] + [3 + 2 * p["concepts"]] * late


def flops(cfg: dict, req: dict) -> float:
    p, u = cfg["pipeline"], cfg["unet"]
    h, w = p["height"] // 8, p["width"] // 8
    k, rank = p["concepts"], cfg["lora"]["rank"]
    base = fl.unet_forward(u, h, w)
    f = sum(lanes * base for lanes in unet_lanes(cfg))
    late = p["num_steps"] - p["fusion_start"] - 1
    f += late * 2 * k * (fl.unet_forward(u, h, w, lora_rank=rank) - base)
    f += (2 + 2 * k) * fl.prompt_encode(cfg)
    return f + 4 * fl.vae_decode(cfg["vae"], h, w)


def free(state: State) -> None:
    program.bf16_decode(False)
    state.steps.close()
    state.engine.params = None
    state.loras.clear()
    gc.collect()
    torch.cuda.empty_cache()


def check(ctx, req: dict, out: dict, cast=None) -> dict:
    """The compared numbers of one request of the window; with ``cast``,
    those of the reference computed with it (the control) in the
    program's place, from the same latents."""
    cfg, p = ctx.cfg, ctx.cfg["pipeline"]
    dev = ctx.device
    tap = taps(p)
    seen = out["steps"]
    lost = {"eps_gap": math.inf, "step_gap": math.inf,
            "decode_gap_levels": math.inf}
    if set(seen) != set(tap.values()):
        return lost
    prog = {role: [compare.nchw(t) for t in seen[c][1:]] + [seen[c][0]]
            for role, c in tap.items()}             # x, eps, next, step
    if any(v[0].shape != (1, 4, p["height"] // 8, p["width"] // 8) for v in prog.values()):
        return lost                     # latents of another shape
    sds = compare.models_fp32(ctx)
    tok = program.tokenizer(cfg)

    def ids(text):
        t = torch.as_tensor(tok([text]), dtype=torch.long, device=dev)
        return t, t

    lora_sds = weights.lora_state_dicts(cfg, ctx.seed,
                                        cfg["lora"]["per_request"], dev)
    scale = p["concept_lora_scale"] * cfg["lora"]["alpha"] / cfg["lora"]["rank"]
    loras = [ref.lora_lanes(sd, scale) for sd in lora_sds]
    h, w = p["height"] // 8, p["width"] // 8
    masks = torch.as_tensor(generator.box_masks(ctx.mix, h, w), device=dev)
    x0 = _noise(req, h, w).permute(0, 3, 1, 2).to(dev) * ref.Euler(
        cfg["scheduler"], p["num_steps"]).init_sigma

    def steps(c):
        """(x, guided, next) of each checked step, in the roles' order."""
        with ref.fp32_math():
            cond = ref.omg_conditioning(
                sds, cfg, ids_pos=ids(req["prompt"]),
                ids_neg=ids(req["negative"]),
                concept_ids=[(ids(rp), ids(rn)) for rp, rn in req["regions"]],
                cast=c)
            res = []
            for role, x in (("s1_first", x0), ("s1_last", None)):
                x = prog[role][0] if x is None else x
                res.append((x,) + ref.omg_stage1_step(
                    sds, cfg, cond, x, prog[role][3], cast=c))
            for role, a in (("s2_first", "s1_at_s2_first"),
                            ("s2_last", "s1_last")):
                x = prog[role][0]
                res.append((x,) + ref.omg_stage2_step(
                    sds, cfg, cond, prog[a][0], x, prog[role][3],
                    loras=loras, masks=masks, cast=c))
        return res

    want = steps(None)
    got = ([(x, prog[r][1], prog[r][2]) for (x, _, _), r in
            zip(want, ("s1_first", "s1_last", "s2_first", "s2_last"))]
           if cast is None else steps(cast))
    gaps = {"eps_gap": max(compare.eps_gap(g[1], wt[1])
                           for g, wt in zip(got, want)),
            "step_gap": compare.step_gap(got[0][2], want[0][0], want[0][2])}
    if cast is None:
        a_end, b_end = prog["s1_last"][2], prog["s2_last"][2]
        gaps["decode_gap_levels"] = max(
            compare.decode_gap(out["stage1"], torch.cat([a_end, a_end]), sds,
                               cfg),
            compare.decode_gap(out["stage2"], torch.cat([a_end, b_end]), sds,
                               cfg))
    return gaps
