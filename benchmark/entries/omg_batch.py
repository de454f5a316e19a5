"""``OMG.generate_batch``: R two-concept requests as one program, as the
port's server drains its queue with ``max_batch`` R.

A window item is one batch: the drawn requests ``R i`` to ``R i + R - 1``
of the mix (``batch`` R). Each request keeps its own noise seed, prompt
(the mix's class words appended, as OMG's prompts name "man" and
"woman"), negative and region prompts, and two distinct LoRAs of a pool
of ``lora_pool`` drawn from the run's seed, picked by the request's seed.
The engine's mask provider answers each class with its box of the mix,
as a detector would, so the batch runs as one program (``masks=`` and
``initial_noise`` would make ``generate_batch`` run each request
serially).

Compared: ``omg_generate``'s numbers on one request of the batch drawn
from the seed, stage 1's first step from the reference's own noise of the
request's seed (``sdxl.prepare_latents``'s draw).
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

WARMUP_STEPS = 5        # stage 1 at 2R lanes, stage 2 at R(3 + 2K) inside
WARMUP_FUSION = 0       # P2P's self-replace window, and all decodes
PICK_STREAM = 400
BATCH = 4               # R: the mix's "batch", which setup holds to it


class State(NamedTuple):
    engine: omg.OMG
    pool: list              # the LoRAs, concept form
    steps: program.Steps


def batch_of(ctx, req: dict) -> list:
    """The drawn requests of a window item."""
    r, i = BATCH, req["index"]
    if r * (i + 1) > len(ctx.requests):
        raise RuntimeError(f"the mix's {len(ctx.requests)} requests hold no "
                           f"batch {i} of {r}")
    return ctx.requests[r * i:r * (i + 1)]


def lora_picks(ctx, req: dict) -> list:
    """The pool indices of a drawn request's two LoRAs."""
    rng = np.random.default_rng(weights.stream_seed(req["seed"], PICK_STREAM))
    return [int(i) for i in rng.choice(ctx.mix["lora_pool"],
                                       ctx.cfg["pipeline"]["concepts"],
                                       replace=False)]


def checked(ctx, req: dict) -> int:
    """The place in its batch of the request a window item's check reads,
    drawn from the run's seed."""
    rng = np.random.default_rng(weights.stream_seed(
        ctx.seed, PICK_STREAM, 1 + req["index"]))
    return int(rng.integers(BATCH))


def prompt(ctx, req: dict) -> str:
    return " ".join([req["prompt"]] + list(ctx.mix["class_words"]))


def taps(p: dict, r: int, place: int) -> dict:
    """The scheduler calls of a batch that the check reads for the request
    at ``place``: each step calls the scheduler once per request, in
    order, stage 1's steps 0..S-1 then stage 2's fs+1..S-1."""
    s, fs = p["num_steps"], p["fusion_start"]

    def call(step, stage2=False):
        return r * (s + step - fs - 1 if stage2 else step) + place
    return {"s1_first": call(0), "s1_at_s2_first": call(fs + 1),
            "s1_last": call(s - 1), "s2_first": call(fs + 1, True),
            "s2_last": call(s - 1, True)}


def _boxes(ctx) -> dict:
    p = ctx.cfg["pipeline"]
    lat = generator.box_masks(ctx.mix, p["height"] // 8, p["width"] // 8)
    return {c: np.kron(m, np.ones((8, 8), np.float32))
            for c, m in zip(ctx.mix["class_words"], lat)}


def setup(ctx) -> State:
    cfg, p = ctx.cfg, ctx.cfg["pipeline"]
    if ctx.mix["batch"] != BATCH:
        raise ValueError(f"the entry runs batches of {BATCH}, the mix asks "
                         f"for {ctx.mix['batch']}")
    scfg, params = program.build(cfg, ctx.seed, ctx.device)
    tok = program.tokenizer(cfg)
    boxes = _boxes(ctx)

    def masks(image, cls):
        return boxes.get(cls)

    engine = omg.OMG(cfg=scfg, params=params, tokenizer=tok, tokenizer_2=tok,
                     mask_provider=masks, num_steps=p["num_steps"],
                     concept_lora_scale=p["concept_lora_scale"])
    program.bf16_decode(ctx.control == "bf16_decode")
    pool = program.loras(cfg, ctx.seed, ctx.mix["lora_pool"], ctx.device)
    keep = [c for place in range(BATCH)
            for c in taps(p, BATCH, place).values()]
    state = State(engine, pool, program.Steps(keep))
    live = engine.params
    for name in ("unet", "text_encoder", "text_encoder_2"):
        ctx.spans.attach(getattr(live, name), "bench." + name)
    _generate(ctx, state, ctx.requests[0], num_steps=WARMUP_STEPS,
              fusion_start=WARMUP_FUSION)
    vae = live.vae.decoder_copy(torch.bfloat16 if ctx.control == "bf16_decode"
                                else scfg.vae.dtype)
    ctx.spans.attach(vae.decoder, "bench.vae_decoder")
    state.steps.attach()
    return state


def _generate(ctx, state: State, req: dict, **kw) -> list:
    p = ctx.cfg["pipeline"]
    kw.setdefault("fusion_start", p["fusion_start"])
    return state.engine.generate_batch([dict(
        prompt=prompt(ctx, r), negative_prompt=r["negative"],
        prompt_rewrite="|".join(f"{a}-*-{b}" for a, b in r["regions"]),
        concept_loras=[state.pool[i] for i in lora_picks(ctx, r)],
        seed=r["seed"], height=p["height"], width=p["width"],
        guidance_scale=p["guidance_scale"], **kw)
        for r in batch_of(ctx, req)])


def run(ctx, state: State, req: dict) -> dict:
    res = _generate(ctx, state, req)
    return {"stage1": [x.stage1 for x in res],
            "stage2": [x.stage2 for x in res],
            "steps": state.steps.take(), "timings": dict(res[0].timings)}


def images(req: dict) -> int:
    return BATCH * req["images"]


def unet_lanes(cfg: dict) -> list:
    """Lanes of each UNet forward of a batch of R: 2R in stage 1, R(3 + 2K)
    in stage 2 (after the fusion start)."""
    p = cfg["pipeline"]
    late = p["num_steps"] - p["fusion_start"] - 1
    r = BATCH
    return [2 * r] * p["num_steps"] + [r * (3 + 2 * p["concepts"])] * late


def flops(cfg: dict, req: dict) -> float:
    """R times one request's (``omg_generate``'s count)."""
    p, u = cfg["pipeline"], cfg["unet"]
    h, w = p["height"] // 8, p["width"] // 8
    k, rank = p["concepts"], cfg["lora"]["rank"]
    late = p["num_steps"] - p["fusion_start"] - 1
    base = fl.unet_forward(u, h, w)
    f = (2 * p["num_steps"] + (3 + 2 * k) * late) * base
    f += late * 2 * k * (fl.unet_forward(u, h, w, lora_rank=rank) - base)
    f += (2 + 2 * k) * fl.prompt_encode(cfg)
    return BATCH * (f + 4 * fl.vae_decode(cfg["vae"], h, w))


def free(state: State) -> None:
    program.bf16_decode(False)
    state.steps.close()
    state.engine.params = None
    state.pool.clear()
    gc.collect()
    torch.cuda.empty_cache()


def check(ctx, req: dict, out: dict, cast=None) -> dict:
    """The compared numbers of the checked request of one batch; with
    ``cast``, those of the reference computed with it (the control) in the
    program's place, from the same latents."""
    cfg, p = ctx.cfg, ctx.cfg["pipeline"]
    dev = ctx.device
    place = checked(ctx, req)
    one = batch_of(ctx, req)[place]
    tap = taps(p, BATCH, place)
    seen = out["steps"]
    lost = {"eps_gap": math.inf, "step_gap": math.inf,
            "decode_gap_levels": math.inf}
    if not set(tap.values()) <= set(seen):
        return lost
    prog = {role: [compare.nchw(t) for t in seen[c][1:]] + [seen[c][0]]
            for role, c in tap.items()}             # x, eps, next, step
    if any(v[0].shape != (1, 4, p["height"] // 8, p["width"] // 8)
           for v in prog.values()):
        return lost                     # latents of another shape
    sds = compare.models_fp32(ctx)
    tok = program.tokenizer(cfg)

    def ids(text):
        t = torch.as_tensor(tok([text]), dtype=torch.long, device=dev)
        return t, t

    pool = weights.lora_state_dicts(cfg, ctx.seed, ctx.mix["lora_pool"], dev)
    scale = (p["concept_lora_scale"] * cfg["lora"]["alpha"]
             / cfg["lora"]["rank"])
    loras = [ref.lora_lanes(pool[i], scale) for i in lora_picks(ctx, one)]
    del pool
    h, w = p["height"] // 8, p["width"] // 8
    masks = torch.as_tensor(generator.box_masks(ctx.mix, h, w), device=dev)
    g = torch.Generator("cpu").manual_seed(one["seed"])
    x0 = torch.randn((1, h, w, 4), generator=g, dtype=torch.float32).permute(
        0, 3, 1, 2).to(dev) * ref.Euler(cfg["scheduler"],
                                        p["num_steps"]).init_sigma

    def steps(c):
        """(x, guided, next) of each checked step, in the roles' order."""
        with ref.fp32_math():
            cond = ref.omg_conditioning(
                sds, cfg, ids_pos=ids(prompt(ctx, one)),
                ids_neg=ids(one["negative"]),
                concept_ids=[(ids(rp), ids(rn)) for rp, rn in one["regions"]],
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
            compare.decode_gap(out["stage1"][place], torch.cat([a_end, a_end]),
                               sds, cfg),
            compare.decode_gap(out["stage2"][place], torch.cat([a_end, b_end]),
                               sds, cfg))
    return gaps
