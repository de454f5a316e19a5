"""Plain fp32 PyTorch forms of SDXL's models over checkpoint state dicts.

Written from the published semantics of diffusers' ``UNet2DConditionModel``
and ``AutoencoderKL`` and transformers' ``CLIPTextModel``: no kernel of the
program, no fused operator, no cache. Tensors are NCHW. The weights are
state dicts keyed as in a checkpoint (``benchmark/weights.py``), read as
fp32. Callers turn TF32 off (``reference.fp32_math``). ``cast`` (None, or
``fp8``) rounds the operands of every product (convolutions, linears,
attention's QK^T and PV) before it, with fp32 accumulation: the control
that computes the reference one precision below the configuration's
bf16.

The UNet takes two per-lane extras that OMG needs:
  * ``lora``: per lane, None or {module path: (A [r, in], B [out, r],
    scale)}; a LoRA projection is ``W x + b + scale * B A x``;
  * ``p2p``: prompt-to-prompt on attention probabilities, as OMG's
    reference hooks edit them: for each (source, destination) lane pair,
    the destination's cross-attention probabilities become
    ``(P_src @ mapper) * alpha + (1 - alpha) * P_dst`` and, inside the
    self-replace window and on layers with at most ``self_limit`` query
    tokens, its self-attention probabilities become ``P_src``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

ATTN_BYTES = 1 << 31            # largest score block of one attention call


class P2P(NamedTuple):
    pairs: tuple                    # ((src lane, dst lane), ...)
    cross_alpha: torch.Tensor       # [77] blend of this step
    mapper: torch.Tensor            # [77, 77]
    self_on: bool                   # inside the self-replace window
    self_limit: int                 # edit self-attention when Nq <= this


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the tensor."""
    s = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


class _W:
    """fp32 view of a state dict under a key prefix, with the operand
    rounding of its products."""

    def __init__(self, sd: dict, prefix: str = "", cast=None):
        self.sd, self.prefix, self.cast = sd, prefix, cast

    def __call__(self, name: str) -> torch.Tensor:
        return self.sd[self.prefix + name].float()

    def has(self, name: str) -> bool:
        return self.prefix + name in self.sd

    def sub(self, name: str) -> "_W":
        return _W(self.sd, self.prefix + name + ".", self.cast)

    def op(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.cast is None else self.cast(t)


def _linear(w: _W, name: str, x: torch.Tensor, lora=None) -> torch.Tensor:
    y = F.linear(w.op(x), w.op(w(name + ".weight")),
                 w(name + ".bias") if w.has(name + ".bias") else None)
    if lora is None:
        return y
    path = w.prefix + name
    groups = {}
    for lane, spec in enumerate(lora):
        if spec is not None and path in spec:
            groups.setdefault(id(spec[path]), (spec[path], []))[1].append(lane)
    for (a, b, scale), lanes in groups.values():
        idx = torch.as_tensor(lanes, device=x.device)
        delta = F.linear(w.op(F.linear(w.op(x[idx]), w.op(a.float()))),
                         w.op(b.float())) * scale
        y = y.index_add(0, idx, delta)
    return y


def _group_norm(w: _W, name: str, x: torch.Tensor, groups: int,
                eps: float) -> torch.Tensor:
    return F.group_norm(x, groups, w(name + ".weight"), w(name + ".bias"),
                        eps)


def _layer_norm(w: _W, name: str, x: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), w(name + ".weight"),
                        w(name + ".bias"), eps)


def _conv(w: _W, name: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    wt = w(name + ".weight")
    return F.conv2d(w.op(x), w.op(wt), w(name + ".bias"), stride=stride,
                    padding=wt.shape[-1] // 2)


def sinusoid(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers ``get_timestep_embedding`` with flip_sin_to_cos, shift 0."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              p2p: Optional[P2P] = None, is_cross: bool = False,
              causal: bool = False, cast=None) -> torch.Tensor:
    """Softmax attention on [B, N, C] rows, in head blocks that keep the
    scores under ``ATTN_BYTES``; the probabilities take the P2P edit."""
    op = (lambda t: t) if cast is None else cast
    b, nq, c = q.shape
    nk = k.shape[1]
    hd = c // heads

    def split(t):
        return t.reshape(b, t.shape[1], heads, hd).transpose(1, 2)

    q, k, v = op(split(q)), op(split(k)), op(split(v))
    step = max(1, ATTN_BYTES // (4 * b * nq * nk))
    mask = None
    if causal:
        mask = torch.full((nq, nk), float("-inf"), device=q.device).triu(1)
    outs = []
    for h0 in range(0, heads, step):
        s = q[:, h0:h0 + step] @ k[:, h0:h0 + step].transpose(-1, -2)
        s = s * hd ** -0.5
        if mask is not None:
            s = s + mask
        p = torch.softmax(s, dim=-1)
        del s
        if p2p is not None:
            for src, dst in p2p.pairs:
                if is_cross:
                    a = p2p.cross_alpha[:nk]
                    p[dst] = (p[src] @ p2p.mapper[:nk, :nk]) * a + \
                        (1 - a) * p[dst]
                elif p2p.self_on and nq <= p2p.self_limit:
                    p[dst] = p[src]
        outs.append(op(p) @ v[:, h0:h0 + step])
        del p
    return torch.cat(outs, dim=1).transpose(1, 2).reshape(b, nq, c)


# --------------------------------------------------------------------------
# CLIP text encoders
# --------------------------------------------------------------------------

def clip_encode(sd: dict, t: dict, ids: torch.Tensor, cast=None) -> tuple:
    """ids [B, 77] -> (hidden_states[-2] [B, 77, d], projected or pooled
    EOS state [B, P])."""
    w = _W(sd, "text_model.", cast)
    x = w("embeddings.token_embedding.weight")[ids] + \
        w("embeddings.position_embedding.weight")[None, :ids.shape[1]]
    heads, n_layers = t["num_attention_heads"], t["num_hidden_layers"]
    penultimate = x
    for i in range(n_layers):
        if i == n_layers - 1:
            penultimate = x
        lw = w.sub(f"encoder.layers.{i}")
        h = _layer_norm(lw, "layer_norm1", x, t["layer_norm_eps"])
        a = lw.sub("self_attn")
        h = attention(_linear(a, "q_proj", h), _linear(a, "k_proj", h),
                      _linear(a, "v_proj", h), heads, causal=True, cast=cast)
        x = x + _linear(a, "out_proj", h)
        h = _linear(lw, "mlp.fc1", _layer_norm(lw, "layer_norm2", x,
                                               t["layer_norm_eps"]))
        h = h * torch.sigmoid(1.702 * h) if t["hidden_act"] == "quick_gelu" \
            else F.gelu(h)
        x = x + _linear(lw, "mlp.fc2", h)
    last = _layer_norm(w, "final_layer_norm", x, t["layer_norm_eps"])
    pooled = last[torch.arange(ids.shape[0], device=ids.device),
                  ids.argmax(dim=-1)]
    if "CLIPTextModelWithProjection" in t["architectures"]:
        pooled = _linear(_W(sd, cast=cast), "text_projection", pooled)
    return penultimate, pooled


# --------------------------------------------------------------------------
# UNet
# --------------------------------------------------------------------------

class _UNetCall(NamedTuple):
    emb: torch.Tensor
    ctx: torch.Tensor
    lora: Optional[Sequence]
    p2p: Optional[P2P]
    u: dict


def _resnet(w: _W, x: torch.Tensor, emb: Optional[torch.Tensor],
            groups: int, eps: float) -> torch.Tensor:
    h = _conv(w, "conv1", F.silu(_group_norm(w, "norm1", x, groups, eps)))
    if emb is not None:
        h = h + _linear(w, "time_emb_proj", F.silu(emb))[:, :, None, None]
    h = _conv(w, "conv2", F.silu(_group_norm(w, "norm2", h, groups, eps)))
    if w.has("conv_shortcut.weight"):
        x = _conv(w, "conv_shortcut", x)
    return x + h


def _transformer(w: _W, x: torch.Tensor, call: _UNetCall) -> torch.Tensor:
    u = call.u
    b, c, hh, ww = x.shape
    heads = c // (u["block_out_channels"][0] // u["attention_head_dim"][0])
    h = _group_norm(w, "norm", x, u["norm_num_groups"], 1e-6)
    h = _linear(w, "proj_in", h.permute(0, 2, 3, 1).reshape(b, hh * ww, c),
                call.lora)
    t = 0
    while w.has(f"transformer_blocks.{t}.norm1.weight"):
        bw = w.sub(f"transformer_blocks.{t}")
        for name, ctx, norm in (("attn1", None, "norm1"),
                                ("attn2", call.ctx, "norm2")):
            n = _layer_norm(bw, norm, h, u["norm_eps"])
            aw = bw.sub(name)
            kv = n if ctx is None else ctx
            o = attention(_linear(aw, "to_q", n, call.lora),
                          _linear(aw, "to_k", kv, call.lora),
                          _linear(aw, "to_v", kv, call.lora), heads,
                          call.p2p, is_cross=ctx is not None, cast=w.cast)
            h = h + _linear(aw, "to_out.0", o, call.lora)
        n = _layer_norm(bw, "norm3", h, u["norm_eps"])
        hid, gate = _linear(bw, "ff.net.0.proj", n, call.lora).chunk(2, -1)
        h = h + _linear(bw, "ff.net.2", hid * F.gelu(gate), call.lora)
        t += 1
    h = _linear(w, "proj_out", h, call.lora)
    return h.reshape(b, hh, ww, c).permute(0, 3, 1, 2) + x


def unet(sd: dict, u: dict, x: torch.Tensor, timestep: float,
         ctx: torch.Tensor, pooled: torch.Tensor, time_ids: torch.Tensor, *,
         lora: Optional[Sequence] = None,
         p2p: Optional[P2P] = None, cast=None) -> torch.Tensor:
    """eps prediction for x [B, 4, h, w] at ``timestep``; ctx [B, 77, D],
    pooled [B, P], time_ids [B, 6]."""
    w = _W(sd, cast=cast)
    b = x.shape[0]
    c0 = u["block_out_channels"][0]
    groups, eps = u["norm_num_groups"], u["norm_eps"]
    t = torch.full((b,), float(timestep), device=x.device)
    emb = _linear(w, "time_embedding.linear_2", F.silu(_linear(
        w, "time_embedding.linear_1", sinusoid(t, c0))))
    ids = sinusoid(time_ids.reshape(-1), u["addition_time_embed_dim"])
    add = torch.cat([pooled, ids.reshape(b, -1)], dim=-1)
    emb = emb + _linear(w, "add_embedding.linear_2", F.silu(_linear(
        w, "add_embedding.linear_1", add)))
    call = _UNetCall(emb, ctx, lora, p2p, u)

    h = _conv(w, "conv_in", x)
    skips = [h]
    n_levels = len(u["block_out_channels"])
    for i in range(n_levels):
        bw = w.sub(f"down_blocks.{i}")
        for j in range(u["layers_per_block"]):
            h = _resnet(bw.sub(f"resnets.{j}"), h, emb, groups, eps)
            if bw.has(f"attentions.{j}.norm.weight"):
                h = _transformer(bw.sub(f"attentions.{j}"), h, call)
            skips.append(h)
        if bw.has("downsamplers.0.conv.weight"):
            h = _conv(bw, "downsamplers.0.conv", h, stride=2)
            skips.append(h)
    mw = w.sub("mid_block")
    h = _resnet(mw.sub("resnets.0"), h, emb, groups, eps)
    h = _transformer(mw.sub("attentions.0"), h, call)
    h = _resnet(mw.sub("resnets.1"), h, emb, groups, eps)
    for i in range(n_levels):
        bw = w.sub(f"up_blocks.{i}")
        for j in range(u["layers_per_block"] + 1):
            h = torch.cat([h, skips.pop()], dim=1)
            h = _resnet(bw.sub(f"resnets.{j}"), h, emb, groups, eps)
            if bw.has(f"attentions.{j}.norm.weight"):
                h = _transformer(bw.sub(f"attentions.{j}"), h, call)
        if bw.has("upsamplers.0.conv.weight"):
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = _conv(bw, "upsamplers.0.conv", h)
    h = F.silu(_group_norm(w, "conv_norm_out", h, groups, eps))
    return _conv(w, "conv_out", h)


# --------------------------------------------------------------------------
# VAE decoder
# --------------------------------------------------------------------------

def _vae_mid(w: _W, x: torch.Tensor, groups: int) -> torch.Tensor:
    x = _resnet(w.sub("resnets.0"), x, None, groups, 1e-6)
    aw = w.sub("attentions.0")
    b, c, hh, ww = x.shape
    h = _group_norm(aw, "group_norm", x, groups, 1e-6)
    h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    o = attention(_linear(aw, "to_q", h), _linear(aw, "to_k", h),
                  _linear(aw, "to_v", h), 1)
    x = x + _linear(aw, "to_out.0", o).reshape(b, hh, ww, c).permute(
        0, 3, 1, 2)
    return _resnet(w.sub("resnets.1"), x, None, groups, 1e-6)


def vae_decode(sd: dict, v: dict, z: torch.Tensor) -> torch.Tensor:
    """Latents [B, 4, h, w] -> images [B, 3, 8h, 8w] in [0, 1], one image
    at a time."""
    w = _W(sd)
    groups = v["norm_num_groups"]
    out = []
    for zi in z.split(1):
        x = _conv(w, "post_quant_conv", zi / v["scaling_factor"])
        dw = w.sub("decoder")
        x = _conv(dw, "conv_in", x)
        x = _vae_mid(dw.sub("mid_block"), x, groups)
        for i in range(len(v["block_out_channels"])):
            bw = dw.sub(f"up_blocks.{i}")
            for j in range(v["layers_per_block"] + 1):
                x = _resnet(bw.sub(f"resnets.{j}"), x, None, groups, 1e-6)
            if bw.has("upsamplers.0.conv.weight"):
                x = F.interpolate(x, scale_factor=2.0, mode="nearest")
                x = _conv(bw, "upsamplers.0.conv", x)
        x = F.silu(_group_norm(dw, "conv_norm_out", x, groups, 1e-6))
        out.append(_conv(dw, "conv_out", x))
    return torch.clamp(torch.cat(out) / 2 + 0.5, 0.0, 1.0)
