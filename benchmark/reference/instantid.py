"""Plain fp32 InstantID over checkpoint state dicts: the IP-Adapter's
Perceiver resampler, the decoupled IP cross-attention, the IdentityNet (a
ControlNet) and a UNet forward that takes both, and OMG's stage-2 step
with them.

Written from InstantID's published code (InstantX/InstantID
``ip_adapter/resampler.py``, ``ip_adapter/attention_processor.py``,
``pipeline_stable_diffusion_xl_instantid.py``) and diffusers'
``ControlNetModel``, over the state dicts ``benchmark/weights_instantid.py``
draws: ``ip_adapter.<2j+1>.to_{k,v}_ip.weight`` is the j-th attn2 in
diffusers' ``attn_processors`` order (down blocks, up blocks, mid block).
Tensors are NCHW and fp32; callers turn TF32 off
(``pipelines.fp32_math``); ``cast`` (None or ``models.fp8``) rounds the
operands of every product, as in ``models``.

Departures from the published code, each an identity or the port's
documented semantics:
  * the resampler's attention scales the scores once by
    ``dim_head ** -0.5``; upstream scales q and k each by
    ``dim_head ** -0.25``: the same product;
  * the IP tokens reach the UNet as their own input, where InstantID
    appends them to the text context and its processor splits them off
    again: the same two attentions;
  * OMG's stage 2 (the port's ``OMG.generate(instantid=...)``) runs the IP
    branch and the IdentityNet on the concept lanes only: each concept's
    (uncond, cond) pair reads its own region prompt, the resampler's
    tokens of a zero embedding and of the concept's face, and the
    IdentityNet on the face-keypoint image with those tokens as its
    context; the base lanes [cond A, uncond B, cond B] run the plain UNet
    under prompt-to-prompt (a zero token set adds exactly nothing there);
  * nothing is batched or cached: the base and the concept lanes run as
    two forwards, which no lane reads across.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference import models
from benchmark.reference.models import (_W, _conv, _group_norm, _layer_norm,
                                        _linear, _resnet, attention, sinusoid)
from benchmark.reference.pipelines import Euler, time_ids


# --------------------------------------------------------------------------
# the resampler and the IP layers
# --------------------------------------------------------------------------

def resampler(sd: dict, r: dict, emb: torch.Tensor, cast=None) -> torch.Tensor:
    """Embeddings [B, E] -> tokens [B, num_queries, output_dim]."""
    w = _W(sd, "image_proj.", cast)
    x = _linear(w, "proj_in", emb[:, None])
    lat = w("latents").expand(emb.shape[0], -1, -1)
    for i in range(r["depth"]):
        a, ff = w.sub(f"layers.{i}.0"), w.sub(f"layers.{i}.1")
        xn, ln = _layer_norm(a, "norm1", x), _layer_norm(a, "norm2", lat)
        k, v = _linear(a, "to_kv", torch.cat([xn, ln], dim=1)).chunk(2, -1)
        o = attention(_linear(a, "to_q", ln), k, v, r["heads"], cast=cast)
        lat = _linear(a, "to_out", o) + lat
        h = F.gelu(_linear(ff, "1", _layer_norm(ff, "0", lat)))
        lat = _linear(ff, "3", h) + lat
    return _layer_norm(w, "norm_out", _linear(w, "proj_out", lat))


def face_tokens(sd: dict, r: dict, emb: torch.Tensor,
                cast=None) -> torch.Tensor:
    """One face's embedding [E] -> [2, T, C]: the tokens of a zero
    embedding (the unconditional row) and of the face."""
    return resampler(sd, r, torch.stack([torch.zeros_like(emb), emb]), cast)


def attn2_order(u: dict) -> dict:
    """{attn2 module path: its index j in an adapter file}: diffusers'
    ``attn_processors`` order, which lists the up blocks before the mid
    block (``UNet2DConditionModel`` registers them first)."""
    chs, lpb = u["block_out_channels"], u["layers_per_block"]
    depths = [d if "CrossAttn" in kind else 0 for d, kind in
              zip(u["transformer_layers_per_block"], u["down_block_types"])]
    paths = [f"down_blocks.{i}.attentions.{j}.transformer_blocks.{t}"
             for i in range(len(chs)) for j in range(lpb)
             for t in range(depths[i])]
    paths += [f"up_blocks.{i}.attentions.{j}.transformer_blocks.{t}"
              for i, d in enumerate(depths[::-1]) for j in range(lpb + 1)
              for t in range(d)]
    paths += [f"mid_block.attentions.0.transformer_blocks.{t}"
              for t in range(depths[-1])]
    return {p + ".attn2": j for j, p in enumerate(paths)}


class IP:
    """The IP branch of one UNet forward: the adapter's state dict, its
    file order, the tokens [B, T, C] and the scale."""

    def __init__(self, sd: dict, u: dict, tokens: torch.Tensor,
                 scale: float):
        self.sd, self.order = sd, attn2_order(u)
        self.tokens, self.scale = tokens, scale

    def weights(self, path: str, cast) -> _W:
        return _W(self.sd, f"ip_adapter.{2 * self.order[path] + 1}.", cast)


# --------------------------------------------------------------------------
# the UNet's halves, with the IP branch and the ControlNet residuals
# --------------------------------------------------------------------------

def _transformer(w: _W, x: torch.Tensor, ctx: torch.Tensor, u: dict,
                 ip: Optional[IP]) -> torch.Tensor:
    b, c, hh, ww = x.shape
    heads = c // (u["block_out_channels"][0] // u["attention_head_dim"][0])
    h = _group_norm(w, "norm", x, u["norm_num_groups"], 1e-6)
    h = _linear(w, "proj_in", h.permute(0, 2, 3, 1).reshape(b, hh * ww, c))
    t = 0
    while w.has(f"transformer_blocks.{t}.norm1.weight"):
        bw = w.sub(f"transformer_blocks.{t}")
        n = _layer_norm(bw, "norm1", h, u["norm_eps"])
        aw = bw.sub("attn1")
        h = h + _linear(aw, "to_out.0", attention(
            _linear(aw, "to_q", n), _linear(aw, "to_k", n),
            _linear(aw, "to_v", n), heads, cast=w.cast))
        n = _layer_norm(bw, "norm2", h, u["norm_eps"])
        aw = bw.sub("attn2")
        q = _linear(aw, "to_q", n)
        o = attention(q, _linear(aw, "to_k", ctx), _linear(aw, "to_v", ctx),
                      heads, cast=w.cast)
        if ip is not None:
            iw = ip.weights(aw.prefix[:-1], w.cast)
            o = o + ip.scale * attention(
                q, _linear(iw, "to_k_ip", ip.tokens),
                _linear(iw, "to_v_ip", ip.tokens), heads, cast=w.cast)
        h = h + _linear(aw, "to_out.0", o)
        n = _layer_norm(bw, "norm3", h, u["norm_eps"])
        hid, gate = _linear(bw, "ff.net.0.proj", n).chunk(2, -1)
        h = h + _linear(bw, "ff.net.2", hid * F.gelu(gate))
        t += 1
    h = _linear(w, "proj_out", h)
    return h.reshape(b, hh, ww, c).permute(0, 3, 1, 2) + x


def _embedding(w: _W, u: dict, b: int, timestep: float, pooled: torch.Tensor,
               tids: torch.Tensor) -> torch.Tensor:
    t = torch.full((b,), float(timestep), device=pooled.device)
    emb = _linear(w, "time_embedding.linear_2", F.silu(_linear(
        w, "time_embedding.linear_1",
        sinusoid(t, u["block_out_channels"][0]))))
    ids = sinusoid(tids.reshape(-1), u["addition_time_embed_dim"])
    add = torch.cat([pooled, ids.reshape(b, -1)], dim=-1)
    return emb + _linear(w, "add_embedding.linear_2", F.silu(_linear(
        w, "add_embedding.linear_1", add)))


def _encoder(w: _W, u: dict, h: torch.Tensor, emb: torch.Tensor,
             ctx: torch.Tensor, ip: Optional[IP]) -> tuple:
    """The down blocks and the mid block -> (mid output, skips)."""
    groups, eps = u["norm_num_groups"], u["norm_eps"]
    skips = [h]
    for i in range(len(u["block_out_channels"])):
        bw = w.sub(f"down_blocks.{i}")
        for j in range(u["layers_per_block"]):
            h = _resnet(bw.sub(f"resnets.{j}"), h, emb, groups, eps)
            if bw.has(f"attentions.{j}.norm.weight"):
                h = _transformer(bw.sub(f"attentions.{j}"), h, ctx, u, ip)
            skips.append(h)
        if bw.has("downsamplers.0.conv.weight"):
            h = _conv(bw, "downsamplers.0.conv", h, stride=2)
            skips.append(h)
    mw = w.sub("mid_block")
    h = _resnet(mw.sub("resnets.0"), h, emb, groups, eps)
    h = _transformer(mw.sub("attentions.0"), h, ctx, u, ip)
    return _resnet(mw.sub("resnets.1"), h, emb, groups, eps), skips


def controlnet(sd: dict, cn: dict, x: torch.Tensor, timestep: float,
               ctx: torch.Tensor, pooled: torch.Tensor, tids: torch.Tensor,
               cond: torch.Tensor, scale: float, cast=None) -> tuple:
    """diffusers ``ControlNetModel``: x [B, 4, h, w], the condition image
    cond [B, C, 8h, 8w] in [0, 1] -> (the scaled residual of every skip,
    the scaled mid residual)."""
    w = _W(sd, cast=cast)
    emb = _embedding(w, cn, x.shape[0], timestep, pooled, tids)
    ew = w.sub("controlnet_cond_embedding")
    c = F.silu(_conv(ew, "conv_in", cond))
    j = 0
    while ew.has(f"blocks.{j}.weight"):
        c = F.silu(_conv(ew, f"blocks.{j}", c, stride=1 + j % 2))
        j += 1
    h = _conv(w, "conv_in", x) + _conv(ew, "conv_out", c)
    h, skips = _encoder(w, cn, h, emb, ctx, None)
    down = [_conv(w, f"controlnet_down_blocks.{k}", s) * scale
            for k, s in enumerate(skips)]
    return down, _conv(w, "controlnet_mid_block", h) * scale


def unet(sd: dict, u: dict, x: torch.Tensor, timestep: float,
         ctx: torch.Tensor, pooled: torch.Tensor, tids: torch.Tensor, *,
         ip: Optional[IP] = None, residuals: Optional[tuple] = None,
         cast=None) -> torch.Tensor:
    """eps for x [B, 4, h, w], with the IP branch in every attn2 and a
    ControlNet's residuals added to the skips and the mid block."""
    w = _W(sd, cast=cast)
    groups, eps = u["norm_num_groups"], u["norm_eps"]
    emb = _embedding(w, u, x.shape[0], timestep, pooled, tids)
    h, skips = _encoder(w, u, _conv(w, "conv_in", x), emb, ctx, ip)
    if residuals is not None:
        down, mid = residuals
        skips = [s + r for s, r in zip(skips, down)]
        h = h + mid
    for i in range(len(u["block_out_channels"])):
        bw = w.sub(f"up_blocks.{i}")
        for j in range(u["layers_per_block"] + 1):
            h = torch.cat([h, skips.pop()], dim=1)
            h = _resnet(bw.sub(f"resnets.{j}"), h, emb, groups, eps)
            if bw.has(f"attentions.{j}.norm.weight"):
                h = _transformer(bw.sub(f"attentions.{j}"), h, ctx, u, ip)
        if bw.has("upsamplers.0.conv.weight"):
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = _conv(bw, "upsamplers.0.conv", h)
    h = F.silu(_group_norm(w, "conv_norm_out", h, groups, eps))
    return _conv(w, "conv_out", h)


# --------------------------------------------------------------------------
# OMG's stage 2 with InstantID
# --------------------------------------------------------------------------

def concept_eps(models_sd: dict, iid_sds: dict, cfg: dict, cond: dict,
                xb: torch.Tensor, i: int, tokens: Sequence[torch.Tensor],
                kps: torch.Tensor, cast=None) -> torch.Tensor:
    """The concept lanes' predictions [2K, 4, h, w] at step i from copy B's
    latents xb [1, 4, h, w]: concept k's (uncond, cond) pair on lanes 2k,
    2k + 1 with its region prompt, its face tokens ``tokens[k]`` [2, T, C]
    through the IP branch and the IdentityNet on the keypoint image kps
    [1, 3, H, W]."""
    p = cfg["pipeline"]
    sched = Euler(cfg["scheduler"], p["num_steps"])
    k = cond["concepts"]
    lanes = sched.scale(xb, i).expand(2 * k, -1, -1, -1)
    ctx, pooled = cond["ctx7"][3:], cond["pool7"][3:]
    tids = time_ids(p["height"], p["width"], 2 * k, xb.device)
    toks = torch.cat(list(tokens))
    t = sched.timesteps[i]
    res = controlnet(iid_sds["identitynet"], cfg["identitynet"], lanes, t,
                     toks, pooled, tids, kps.expand(2 * k, -1, -1, -1),
                     p["identitynet_scale"], cast)
    ip = IP(iid_sds["ip_adapter"], cfg["unet"], toks, p["ip_scale"])
    return unet(models_sd["unet"], cfg["unet"], lanes, t, ctx, pooled, tids,
                ip=ip, residuals=res, cast=cast)


def omg_stage2_step(models_sd: dict, iid_sds: dict, cfg: dict, cond: dict,
                    xa: torch.Tensor, xb: torch.Tensor, i: int, *,
                    masks: torch.Tensor, tokens: Sequence[torch.Tensor],
                    kps: torch.Tensor, cast=None) -> tuple:
    """Stage 2 at step i (after the fusion start) from copy A's latents xa
    (stage 1's at step i) and copy B's xb -> (copy B's guided prediction,
    copy B at step i + 1, the concept lanes' predictions before fusion).
    ``cond``: ``pipelines.omg_conditioning``; masks [K, h, w] of 0/1."""
    p = cfg["pipeline"]
    steps = p["num_steps"]
    sched = Euler(cfg["scheduler"], steps)
    dev = xb.device
    words = cond["ctx2"].shape[1]
    cross_end = int(p["cross_replace_steps"] * (steps + 1))
    alpha = torch.full((words,), 1.0 if i < cross_end else 0.0, device=dev)
    p2p = models.P2P(((0, 2),), alpha, torch.eye(words, device=dev),
                     0 <= i < int(steps * p["self_replace_steps"]),
                     (p["width"] // 32) * (p["height"] // 32))
    a, b = sched.scale(xa, i), sched.scale(xb, i)
    base = models.unet(models_sd["unet"], cfg["unet"], torch.cat([a, b, b]),
                       sched.timesteps[i], cond["ctx7"][:3],
                       cond["pool7"][:3],
                       time_ids(p["height"], p["width"], 3, dev), p2p=p2p,
                       cast=cast)
    regions = concept_eps(models_sd, iid_sds, cfg, cond, xb, i, tokens, kps,
                          cast)
    m = masks[:, None].float()
    union = m.sum(0) > 0
    unc = torch.where(union, 0.0, base[1:2])
    c = torch.where(union, 0.0, base[2:3])
    for j in range(cond["concepts"]):
        unc = unc + torch.where(m[j] == 1, regions[2 * j:2 * j + 1], 0.0)
        c = c + torch.where(m[j] == 1, regions[2 * j + 1:2 * j + 2], 0.0)
    guided = unc + p["guidance_scale"] * (c - unc)
    return guided, sched.step(xb, guided, i), regions


def tokens_of(iid_sds: dict, cfg: dict, embeddings: List[torch.Tensor],
              cast=None) -> list:
    """Each concept's face tokens [2, T, C]."""
    return [face_tokens(iid_sds["ip_adapter"], cfg["resampler"], e, cast)
            for e in embeddings]
