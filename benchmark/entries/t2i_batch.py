"""``sdxl.text_to_image``: a batch of images of one prompt, each from its
own noise, with one LoRA on every lane.

Compared, each as the worst row of the batch: at the first and the last
step, the guided prediction the program steps with against the
reference's from the same latents (``eps_gap``), the first from the
reference's own noise and the last from the latents the program stepped
from; the latents after the first step against the reference's step
(``step_gap``: mean |gap| over the step's mean size); and the program's
images against the reference's decode of the latents its last step
returned (``decode_gap_levels``, in uint8 levels).
"""

from __future__ import annotations

import gc
import math
from typing import NamedTuple

import torch

from benchmark import flops as fl
from benchmark import compare, program, weights
from benchmark.reference import pipelines as ref
from omg_tpu_torch.pipelines import sdxl

WARMUP_STEPS = 1


class State(NamedTuple):
    scfg: object
    params: list            # [SDXLParams], emptied by free
    lora: dict
    tok: object
    steps: program.Steps


def taps(p: dict) -> dict:
    """The scheduler calls of a batch that the check reads: its first and
    last steps."""
    return {"first": 0, "last": p["num_steps"] - 1}


def setup(ctx) -> State:
    cfg = ctx.cfg
    scfg, params = program.build(cfg, ctx.seed, ctx.device)
    program.bf16_decode(ctx.control == "bf16_decode")
    lora = program.loras(cfg, ctx.seed, 1, ctx.device,
                         weight=cfg["pipeline"]["lora_scale"])[0]["unet"]
    state = State(scfg, [params], lora, program.tokenizer(cfg),
                  program.Steps(taps(cfg["pipeline"]).values()))
    for name in ("unet", "text_encoder", "text_encoder_2"):
        ctx.spans.attach(getattr(params, name), "bench." + name)
    _generate(ctx, state, ctx.requests[0], steps=WARMUP_STEPS)
    vae = params.vae.decoder_copy(torch.bfloat16 if ctx.control ==
                                  "bf16_decode" else scfg.vae.dtype)
    ctx.spans.attach(vae.decoder, "bench.vae_decoder")
    state.steps.attach()
    return state


def _ids(state: State, text: str, b: int) -> torch.Tensor:
    return torch.as_tensor(state.tok([text] * b), dtype=torch.long)


def _generate(ctx, state: State, req: dict, **kw) -> torch.Tensor:
    p = ctx.cfg["pipeline"]
    b = req["images"]
    pos, neg = _ids(state, req["prompt"], b), _ids(state, req["negative"], b)
    return sdxl.text_to_image(
        state.scfg, state.params[0], ids1_pos=pos, ids2_pos=pos,
        ids1_neg=neg, ids2_neg=neg,
        generator=torch.Generator("cpu").manual_seed(req["seed"]),
        height=p["height"], width=p["width"],
        steps=kw.get("steps", p["num_steps"]),
        guidance_scale=p["guidance_scale"], lora=state.lora)


def run(ctx, state: State, req: dict) -> dict:
    img = _generate(ctx, state, req)
    return {"images": img.cpu(), "steps": state.steps.take(),
            "timings": {}}


def images(req: dict) -> int:
    return req["images"]


def unet_lanes(cfg: dict) -> list:
    p = cfg["pipeline"]
    return [2 * p["batch"]] * p["num_steps"]


def flops(cfg: dict, req: dict) -> float:
    p, u = cfg["pipeline"], cfg["unet"]
    h, w = p["height"] // 8, p["width"] // 8
    b = req["images"]
    f = p["num_steps"] * 2 * b * fl.unet_forward(
        u, h, w, lora_rank=cfg["lora"]["rank"])
    return f + 2 * b * fl.prompt_encode(cfg) + b * fl.vae_decode(
        cfg["vae"], h, w)


def free(state: State) -> None:
    program.bf16_decode(False)
    state.steps.close()
    state.params.clear()
    state.lora.clear()
    gc.collect()
    torch.cuda.empty_cache()


def check(ctx, req: dict, out: dict, cast=None) -> dict:
    """The compared numbers of one batch of the window; with ``cast``,
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
    if any(v[0].shape != (req["images"], 4, p["height"] // 8, p["width"] // 8) for v in prog.values()):
        return lost                     # latents of another shape
    sds = compare.models_fp32(ctx)
    tok = program.tokenizer(cfg)

    def ids(text):
        t = torch.as_tensor(tok([text]), dtype=torch.long, device=dev)
        return t, t

    (lora_sd,) = weights.lora_state_dicts(cfg, ctx.seed, 1, dev)
    lora = ref.lora_lanes(lora_sd, p["lora_scale"] * cfg["lora"]["alpha"] /
                          cfg["lora"]["rank"])
    b, h, w = req["images"], p["height"] // 8, p["width"] // 8
    g = torch.Generator("cpu").manual_seed(req["seed"])
    x0 = torch.randn((b, h, w, 4), generator=g, dtype=torch.float32).permute(
        0, 3, 1, 2).to(dev) * ref.Euler(cfg["scheduler"],
                                        p["num_steps"]).init_sigma

    def steps(c):
        """(x, guided, next) of the first and the last step."""
        with ref.fp32_math():
            cond = ref.t2i_conditioning(sds, cfg, ids(req["prompt"]),
                                        ids(req["negative"]), b, cast=c)
            return [(x,) + ref.t2i_step(sds, cfg, cond, x, i, lora, cast=c)
                    for x, i in ((x0, prog["first"][3]),
                                 (prog["last"][0], prog["last"][3]))]

    want = steps(None)
    got = ([(x, prog[r][1], prog[r][2]) for (x, _, _), r in
            zip(want, ("first", "last"))] if cast is None else steps(cast))
    gaps = {"eps_gap": max(compare.eps_gap(gt[1], wt[1])
                           for gt, wt in zip(got, want)),
            "step_gap": compare.step_gap(got[0][2], want[0][0], want[0][2])}
    if cast is None:
        gaps["decode_gap_levels"] = compare.decode_gap(
            out["images"], prog["last"][2], sds, cfg)
    return gaps
