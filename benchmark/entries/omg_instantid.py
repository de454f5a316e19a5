"""``OMG.generate`` with InstantID: one two-concept request at a time,
each concept's face through the resampler's tokens, the IP branch and the
IdentityNet, built as ``inference_instantid.py`` builds its engine: the
IdentityNet through ``convert.convert_controlnet``, ``ip-adapter.bin``
through ``convert.convert_ip_adapter``, the concept masks handed in as
``masks=``.

Compared, each as the worst of its rows: ``omg_generate``'s numbers
(``eps_gap`` at stage 1's first and last steps and stage 2's first and
last, ``step_gap`` at stage 1's first, ``decode_gap_levels`` of both
decodes), where stage 2's reference runs the identity stack on the
concept lanes (``reference/instantid.py``); and ``region_eps_gap``: the
concept lanes' predictions of the UNet forward at stage 2's first and
last steps, before fusion, against the reference's from the same latents
(mean |gap| over mean |reference| of the worst lane): a concept lane that
lost its IP branch or its IdentityNet shows there, where the fused mean
of ``eps_gap`` could hide it.
"""

from __future__ import annotations

import gc
import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark import flops as fl
from benchmark import flops_instantid as fli
from benchmark import compare, generator, program, weights
from benchmark import weights_instantid as wi
from benchmark.reference import instantid as ref_iid
from benchmark.reference import pipelines as ref
from omg_tpu_torch import config as cfglib
from omg_tpu_torch import convert
from omg_tpu_torch import instantid as iid_lib
from omg_tpu_torch.pipelines import omg

WARMUP_STEPS = 5        # every stage-2 step of the warm-up runs the
WARMUP_FUSION = 0       # identity stack, as a request's do


class State(NamedTuple):
    engine: omg.OMG
    iid: omg.InstantIDModels
    masks: list             # per concept [H, W] 0/1 pixels
    steps: program.Steps
    concepts: "ConceptTap"


class ConceptTap:
    """The concept lanes' rows of each stage-2 UNet forward (3 + 2K lanes)
    of a request, the first and the last: a forward hook keeps a view of
    the output, no copy."""

    def __init__(self, module: torch.nn.Module, k: int):
        self.k, self.seen = k, []
        self.handle = module.register_forward_hook(self._hook)

    def _hook(self, mod, args, out):
        if out.shape[0] == 3 + 2 * self.k:
            self.seen[1:] = [out[3:]]
            if not self.seen[:1]:
                self.seen.insert(0, out[3:])

    def take(self) -> list:
        out, self.seen = self.seen, []
        return out

    def close(self) -> None:
        self.handle.remove()


def taps(p: dict) -> dict:
    """The scheduler calls of a request that the check reads (as
    ``omg_generate``'s)."""
    s, fs = p["num_steps"], p["fusion_start"]
    return {"s1_first": 0, "s1_at_s2_first": fs + 1, "s1_last": s - 1,
            "s2_first": s, "s2_last": 2 * s - fs - 2}


def _noise(req: dict, h: int, w: int) -> torch.Tensor:
    """The request's unit noise [1, h, w, 4] (NHWC, fp32, CPU)."""
    g = torch.Generator("cpu").manual_seed(req["seed"])
    return torch.randn((1, h, w, 4), generator=g, dtype=torch.float32)


def _rewrite(req: dict) -> str:
    return "|".join(f"{p}-*-{n}" for p, n in req["regions"])


def identitynet_config(cfg: dict) -> cfglib.ControlNetConfig:
    """The port's geometry of the configuration's IdentityNet."""
    cn = cfg["identitynet"]
    dt = program.DTYPES[cfg["precision"]["identitynet"]]
    chs = tuple(cn["block_out_channels"])
    (head,) = {c // h for c, h in zip(chs, cn["attention_head_dim"])}
    u = cfglib.UNetConfig(
        in_channels=cn["in_channels"], block_out_channels=chs,
        layers_per_block=cn["layers_per_block"],
        transformer_layers_per_block=weights.attention_depths(cn),
        attention_head_dim=head,
        cross_attention_dim=cn["cross_attention_dim"],
        addition_time_embed_dim=cn["addition_time_embed_dim"],
        projection_class_embeddings_input_dim=cn[
            "projection_class_embeddings_input_dim"],
        norm_num_groups=cn["norm_num_groups"], dtype=dt)
    return cfglib.ControlNetConfig(
        unet=u, conditioning_channels=cn["conditioning_channels"],
        conditioning_embedding_out_channels=tuple(
            cn["conditioning_embedding_out_channels"]))


def resampler_config(cfg: dict) -> cfglib.ResamplerConfig:
    r = cfg["resampler"]
    return cfglib.ResamplerConfig(
        dim=r["dim"], depth=r["depth"], dim_head=r["dim_head"],
        heads=r["heads"], num_queries=r["num_queries"],
        embedding_dim=r["embedding_dim"], output_dim=r["output_dim"],
        ff_mult=r["ff_mult"],
        dtype=program.DTYPES[cfg["precision"]["resampler"]])


def build_instantid(cfg: dict, scfg, seed: int, device) -> tuple:
    """(ControlNetConfig, InstantIDModels) from the seed's checkpoint
    files, through the port's converters."""
    p = cfg["pipeline"]
    sds = wi.state_dicts(cfg, seed, device)
    idcfg = identitynet_config(cfg)
    idnet = convert.convert_controlnet(sds.pop("identitynet"), idcfg,
                                       device=device)
    rcfg = resampler_config(cfg)
    adapter = convert.convert_ip_adapter(
        wi.nested(sds.pop("ip_adapter")), rcfg, unet_cfg=scfg.unet,
        dtype=scfg.unet.dtype, device=device)
    return idcfg, omg.InstantIDModels(
        resampler_cfg=rcfg, resampler_params=adapter["image_proj"],
        ip_adapter_layers=adapter["ip_adapter"], identitynet_params=idnet,
        identitynet_cfg=idcfg, ip_scale=p["ip_scale"],
        identitynet_scale=p["identitynet_scale"])


def faces(ctx, req: dict) -> tuple:
    """(embeddings, keypoint image uint8 [H, W, 3]) of a request."""
    p = ctx.cfg["pipeline"]
    embs, kps = wi.faces(ctx.mix, req, p["height"], p["width"])
    return embs, iid_lib.draw_kps(p["height"], p["width"], kps)


def setup(ctx) -> State:
    cfg, p = ctx.cfg, ctx.cfg["pipeline"]
    scfg, params = program.build(cfg, ctx.seed, ctx.device)
    idcfg, iid = build_instantid(cfg, scfg, ctx.seed, ctx.device)
    tok = program.tokenizer(cfg)
    engine = omg.OMG(cfg=scfg, params=params, tokenizer=tok, tokenizer_2=tok,
                     cn_cfg=idcfg, num_steps=p["num_steps"])
    program.bf16_decode(ctx.control == "bf16_decode")
    lat = generator.box_masks(ctx.mix, p["height"] // 8, p["width"] // 8)
    px = [np.kron(m, np.ones((8, 8), np.float32)) for m in lat]
    live = engine.params
    state = State(engine, iid, px, program.Steps(taps(p).values()),
                  ConceptTap(live.unet, p["concepts"]))
    for name in ("unet", "text_encoder", "text_encoder_2"):
        ctx.spans.attach(getattr(live, name), "bench." + name)
    ctx.spans.attach(iid.identitynet_params, "bench.identitynet")
    _generate(ctx, state, ctx.requests[0], num_steps=WARMUP_STEPS,
              fusion_start=WARMUP_FUSION)
    vae = live.vae.decoder_copy(torch.bfloat16 if ctx.control == "bf16_decode"
                                else scfg.vae.dtype)
    ctx.spans.attach(vae.decoder, "bench.vae_decoder")
    state.concepts.take()
    state.steps.attach()
    return state


def _generate(ctx, state: State, req: dict, **kw) -> omg.GenerationResult:
    p = ctx.cfg["pipeline"]
    h, w = p["height"], p["width"]
    embs, kps = faces(ctx, req)
    kw.setdefault("fusion_start", p["fusion_start"])
    return state.engine.generate(
        req["prompt"], negative_prompt=req["negative"],
        prompt_rewrite=_rewrite(req), seed=0, height=h, width=w,
        guidance_scale=p["guidance_scale"], instantid=state.iid,
        face_embeddings=embs, face_kps_image=kps, masks=state.masks,
        initial_noise=_noise(req, h // 8, w // 8).numpy(), **kw)


def run(ctx, state: State, req: dict) -> dict:
    res = _generate(ctx, state, req)
    return {"stage1": res.stage1, "stage2": res.stage2,
            "steps": state.steps.take(), "concepts": state.concepts.take(),
            "timings": dict(res.timings)}


def images(req: dict) -> int:
    return req["images"]


def unet_lanes(cfg: dict) -> list:
    """Lanes of each UNet forward of a request: 2 in stage 1, 3 + 2K in
    stage 2 (after the fusion start)."""
    p = cfg["pipeline"]
    late = p["num_steps"] - p["fusion_start"] - 1
    return [2] * p["num_steps"] + [3 + 2 * p["concepts"]] * late


def flops(cfg: dict, req: dict) -> float:
    """The UNet's lanes, and on the 2K concept lanes of each stage-2 step
    the IdentityNet and the IP branch; the resampler on each concept's two
    rows; the prompts; both decodes."""
    p, u = cfg["pipeline"], cfg["unet"]
    h, w = p["height"] // 8, p["width"] // 8
    k = p["concepts"]
    f = sum(lanes * fl.unet_forward(u, h, w) for lanes in unet_lanes(cfg))
    late = p["num_steps"] - p["fusion_start"] - 1
    f += late * 2 * k * (fli.identitynet_forward(cfg["identitynet"], h, w)
                         + fli.ip_branch(u, h, w))
    f += 2 * k * fli.resampler(cfg["resampler"])
    f += (2 + 2 * k) * fl.prompt_encode(cfg)
    return f + 4 * fl.vae_decode(cfg["vae"], h, w)


def free(state: State) -> None:
    program.bf16_decode(False)
    state.steps.close()
    state.concepts.close()
    state.engine.params = None
    state.iid.ip_adapter_layers = state.iid.resampler_params = None
    state.iid.identitynet_params = None
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
            "decode_gap_levels": math.inf, "region_eps_gap": math.inf}
    if set(seen) != set(tap.values()) or len(out["concepts"]) != 2:
        return lost
    prog = {role: [compare.nchw(t) for t in seen[c][1:]] + [seen[c][0]]
            for role, c in tap.items()}             # x, eps, next, step
    if any(v[0].shape != (1, 4, p["height"] // 8, p["width"] // 8)
           for v in prog.values()):
        return lost                     # latents of another shape
    sds = compare.models_fp32(ctx)
    iid_sds = {m: {k: v.float() for k, v in sd.items()}
               for m, sd in wi.state_dicts(cfg, ctx.seed, dev).items()}
    tok = program.tokenizer(cfg)

    def ids(text):
        t = torch.as_tensor(tok([text]), dtype=torch.long, device=dev)
        return t, t

    h, w = p["height"] // 8, p["width"] // 8
    masks = torch.as_tensor(generator.box_masks(ctx.mix, h, w), device=dev)
    embs, kps_img = faces(ctx, req)
    embs = [torch.as_tensor(e, device=dev) for e in embs]
    kps = torch.as_tensor(kps_img, dtype=torch.float32, device=dev).permute(
        2, 0, 1)[None] / 255.0
    x0 = _noise(req, h, w).permute(0, 3, 1, 2).to(dev) * ref.Euler(
        cfg["scheduler"], p["num_steps"]).init_sigma

    def steps(c):
        """(x, guided, next) of each checked step in the roles' order, and
        the concept lanes' predictions of both stage-2 steps."""
        with ref.fp32_math():
            cond = ref.omg_conditioning(
                sds, cfg, ids_pos=ids(req["prompt"]),
                ids_neg=ids(req["negative"]),
                concept_ids=[(ids(rp), ids(rn)) for rp, rn in req["regions"]],
                cast=c)
            tokens = ref_iid.tokens_of(iid_sds, cfg, embs, cast=c)
            res, regions = [], []
            for role, x in (("s1_first", x0), ("s1_last", None)):
                x = prog[role][0] if x is None else x
                res.append((x,) + ref.omg_stage1_step(
                    sds, cfg, cond, x, prog[role][3], cast=c))
            for role, a in (("s2_first", "s1_at_s2_first"),
                            ("s2_last", "s1_last")):
                x = prog[role][0]
                g, nxt, reg = ref_iid.omg_stage2_step(
                    sds, iid_sds, cfg, cond, prog[a][0], x, prog[role][3],
                    masks=masks, tokens=tokens, kps=kps, cast=c)
                res.append((x, g, nxt))
                regions.append(reg)
        return res, regions

    want, want_reg = steps(None)
    if cast is None:
        got = [(x, prog[r][1], prog[r][2]) for (x, _, _), r in
               zip(want, ("s1_first", "s1_last", "s2_first", "s2_last"))]
        got_reg = [compare.nchw(t) for t in out["concepts"]]
    else:
        got, got_reg = steps(cast)
    gaps = {"eps_gap": max(compare.eps_gap(g[1], wt[1])
                           for g, wt in zip(got, want)),
            "step_gap": compare.step_gap(got[0][2], want[0][0], want[0][2]),
            "region_eps_gap": max(compare.eps_gap(g, wt)
                                  for g, wt in zip(got_reg, want_reg))}
    if cast is None:
        a_end, b_end = prog["s1_last"][2], prog["s2_last"][2]
        gaps["decode_gap_levels"] = max(
            compare.decode_gap(out["stage1"], torch.cat([a_end, a_end]), sds,
                               cfg),
            compare.decode_gap(out["stage2"], torch.cat([a_end, b_end]), sds,
                               cfg))
    return gaps
