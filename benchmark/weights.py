"""Random SDXL weights as checkpoint-layout state dicts, made from a seed.

A configuration file holds the published ``config.json`` numbers of each
model. From them this module lists every tensor a diffusers or
transformers checkpoint of that model holds (key and shape), and fills
them from the run's seed on the device: one ``torch.Generator`` per model,
a few large ``randn`` draws in the type the model is served in, sliced
into the tensors and scaled by each tensor's role. The same seed gives the
same values, so the reference, built after the window, draws the weights
again instead of keeping a copy on the card through the window.

Roles: linear and convolution weights N(0, 1/fan_in); biases, norm shifts
and embeddings N(0, 0.02^2); norm scales 1 + N(0, 0.02^2). LoRA files are
in the PEFT layout that diffusers writes (``unet.<module>.lora_A.weight``
[r, in], ``lora_B.weight`` [out, r]), A ~ N(0, 1/in), B ~ N(0, 0.01/r).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

Spec = List[Tuple[str, tuple]]

# draw streams: one per model, so that no model's weights depend on
# another's size
STREAMS = {"unet": 1, "vae": 2, "text_encoder": 3, "text_encoder_2": 4,
           "lora": 100, "noise": 200}
DRAW_CHUNK = 1 << 28            # elements per randn call


def stream_seed(seed: int, stream: int, index: int = 0) -> int:
    """A 63-bit generator seed from (run seed, stream, index)."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), stream, index])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


# --------------------------------------------------------------------------
# checkpoint layouts
# --------------------------------------------------------------------------

def _resnet(p: str, cin: int, cout: int, temb: int = 0) -> Spec:
    out = [(p + "norm1.weight", (cin,)), (p + "norm1.bias", (cin,)),
           (p + "conv1.weight", (cout, cin, 3, 3)), (p + "conv1.bias", (cout,))]
    if temb:
        out += [(p + "time_emb_proj.weight", (cout, temb)),
                (p + "time_emb_proj.bias", (cout,))]
    out += [(p + "norm2.weight", (cout,)), (p + "norm2.bias", (cout,)),
            (p + "conv2.weight", (cout, cout, 3, 3)), (p + "conv2.bias", (cout,))]
    if cin != cout:
        out += [(p + "conv_shortcut.weight", (cout, cin, 1, 1)),
                (p + "conv_shortcut.bias", (cout,))]
    return out


def _linear(p: str, cin: int, cout: int, bias: bool = True) -> Spec:
    return [(p + ".weight", (cout, cin))] + ([(p + ".bias", (cout,))]
                                             if bias else [])


def _norm(p: str, c: int) -> Spec:
    return [(p + ".weight", (c,)), (p + ".bias", (c,))]


def _transformer(p: str, c: int, depth: int, ctx: int) -> Spec:
    out = _norm(p + "norm", c) + _linear(p + "proj_in", c, c)
    for t in range(depth):
        b = f"{p}transformer_blocks.{t}."
        out += _norm(b + "norm1", c)
        for proj in ("to_q", "to_k", "to_v"):
            out += _linear(b + "attn1." + proj, c, c, bias=False)
        out += _linear(b + "attn1.to_out.0", c, c) + _norm(b + "norm2", c)
        out += _linear(b + "attn2.to_q", c, c, bias=False)
        out += _linear(b + "attn2.to_k", ctx, c, bias=False)
        out += _linear(b + "attn2.to_v", ctx, c, bias=False)
        out += _linear(b + "attn2.to_out.0", c, c) + _norm(b + "norm3", c)
        out += _linear(b + "ff.net.0.proj", c, 8 * c)
        out += _linear(b + "ff.net.2", 4 * c, c)
    return out + _linear(p + "proj_out", c, c)


def attention_depths(u: dict) -> tuple:
    """Transformer blocks per down level (0 for a block without
    cross-attention), from the published block types."""
    return tuple(d if "CrossAttn" in kind else 0 for d, kind in
                 zip(u["transformer_layers_per_block"], u["down_block_types"]))


def unet_spec(u: dict) -> Spec:
    """diffusers ``UNet2DConditionModel`` of a published config."""
    chs = list(u["block_out_channels"])
    depths = attention_depths(u)
    lpb, ctx, temb = u["layers_per_block"], u["cross_attention_dim"], 4 * chs[0]
    out = [("conv_in.weight", (chs[0], u["in_channels"], 3, 3)),
           ("conv_in.bias", (chs[0],))]
    out += _linear("time_embedding.linear_1", chs[0], temb)
    out += _linear("time_embedding.linear_2", temb, temb)
    out += _linear("add_embedding.linear_1",
                   u["projection_class_embeddings_input_dim"], temb)
    out += _linear("add_embedding.linear_2", temb, temb)
    cin = chs[0]
    for i, c in enumerate(chs):
        for j in range(lpb):
            out += _resnet(f"down_blocks.{i}.resnets.{j}.", cin, c, temb)
            cin = c
            if depths[i]:
                out += _transformer(f"down_blocks.{i}.attentions.{j}.", c,
                                    depths[i], ctx)
        if i < len(chs) - 1:
            out += [(f"down_blocks.{i}.downsamplers.0.conv.weight", (c, c, 3, 3)),
                    (f"down_blocks.{i}.downsamplers.0.conv.bias", (c,))]
    out += _resnet("mid_block.resnets.0.", chs[-1], chs[-1], temb)
    out += _transformer("mid_block.attentions.0.", chs[-1], depths[-1], ctx)
    out += _resnet("mid_block.resnets.1.", chs[-1], chs[-1], temb)
    rev, rdepths = chs[::-1], depths[::-1]
    prev = rev[0]
    for i, c in enumerate(rev):
        skip_in = rev[min(i + 1, len(rev) - 1)]
        for j in range(lpb + 1):
            res_in = prev if j == 0 else c
            skip = skip_in if j == lpb else c
            out += _resnet(f"up_blocks.{i}.resnets.{j}.", res_in + skip, c, temb)
            if rdepths[i]:
                out += _transformer(f"up_blocks.{i}.attentions.{j}.", c,
                                    rdepths[i], ctx)
        if i < len(rev) - 1:
            out += [(f"up_blocks.{i}.upsamplers.0.conv.weight", (c, c, 3, 3)),
                    (f"up_blocks.{i}.upsamplers.0.conv.bias", (c,))]
        prev = c
    out += _norm("conv_norm_out", chs[0])
    out += [("conv_out.weight", (u["out_channels"], chs[0], 3, 3)),
            ("conv_out.bias", (u["out_channels"],))]
    return out


def _vae_mid(p: str, c: int) -> Spec:
    out = _resnet(p + "resnets.0.", c, c)
    a = p + "attentions.0."
    out += _norm(a + "group_norm", c)
    for proj in ("to_q", "to_k", "to_v", "to_out.0"):
        out += _linear(a + proj, c, c)
    return out + _resnet(p + "resnets.1.", c, c)


def vae_spec(v: dict) -> Spec:
    """diffusers ``AutoencoderKL`` (both halves: a checkpoint holds both)."""
    chs, lpb, lat = list(v["block_out_channels"]), v["layers_per_block"], \
        v["latent_channels"]
    out = [("encoder.conv_in.weight", (chs[0], v["in_channels"], 3, 3)),
           ("encoder.conv_in.bias", (chs[0],))]
    cin = chs[0]
    for i, c in enumerate(chs):
        for j in range(lpb):
            out += _resnet(f"encoder.down_blocks.{i}.resnets.{j}.", cin, c)
            cin = c
        if i < len(chs) - 1:
            out += [(f"encoder.down_blocks.{i}.downsamplers.0.conv.weight",
                     (c, c, 3, 3)),
                    (f"encoder.down_blocks.{i}.downsamplers.0.conv.bias", (c,))]
    out += _vae_mid("encoder.mid_block.", chs[-1])
    out += _norm("encoder.conv_norm_out", chs[-1])
    out += [("encoder.conv_out.weight", (2 * lat, chs[-1], 3, 3)),
            ("encoder.conv_out.bias", (2 * lat,)),
            ("quant_conv.weight", (2 * lat, 2 * lat, 1, 1)),
            ("quant_conv.bias", (2 * lat,)),
            ("post_quant_conv.weight", (lat, lat, 1, 1)),
            ("post_quant_conv.bias", (lat,)),
            ("decoder.conv_in.weight", (chs[-1], lat, 3, 3)),
            ("decoder.conv_in.bias", (chs[-1],))]
    out += _vae_mid("decoder.mid_block.", chs[-1])
    rev = chs[::-1]
    prev = rev[0]
    for i, c in enumerate(rev):
        for j in range(lpb + 1):
            out += _resnet(f"decoder.up_blocks.{i}.resnets.{j}.",
                           prev if j == 0 else c, c)
        if i < len(rev) - 1:
            out += [(f"decoder.up_blocks.{i}.upsamplers.0.conv.weight",
                     (c, c, 3, 3)),
                    (f"decoder.up_blocks.{i}.upsamplers.0.conv.bias", (c,))]
        prev = c
    out += _norm("decoder.conv_norm_out", chs[0])
    out += [("decoder.conv_out.weight", (v["out_channels"], chs[0], 3, 3)),
            ("decoder.conv_out.bias", (v["out_channels"],))]
    return out


def clip_spec(t: dict) -> Spec:
    """transformers ``CLIPTextModel`` or ``CLIPTextModelWithProjection``."""
    d, inner = t["hidden_size"], t["intermediate_size"]
    out = [("text_model.embeddings.token_embedding.weight",
            (t["vocab_size"], d)),
           ("text_model.embeddings.position_embedding.weight",
            (t["max_position_embeddings"], d))]
    for i in range(t["num_hidden_layers"]):
        p = f"text_model.encoder.layers.{i}."
        out += _norm(p + "layer_norm1", d)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += _linear(p + "self_attn." + proj, d, d)
        out += _norm(p + "layer_norm2", d)
        out += _linear(p + "mlp.fc1", d, inner) + _linear(p + "mlp.fc2", inner, d)
    out += _norm("text_model.final_layer_norm", d)
    if "CLIPTextModelWithProjection" in t["architectures"]:
        out += _linear("text_projection", d, t["projection_dim"], bias=False)
    return out


def lora_modules(u: dict, targets) -> List[Tuple[str, int, int]]:
    """(module path, in, out) of every LoRA target of the UNet."""
    out = []
    for key, shape in unet_spec(u):
        mod = key[:-len(".weight")]
        if key.endswith(".weight") and any(mod.endswith("." + t)
                                           for t in targets):
            out.append((mod, shape[1], shape[0]))
    return out


def lora_spec(u: dict, lora: dict) -> Spec:
    r = lora["rank"]
    out = []
    for mod, cin, cout in lora_modules(u, lora["target_modules"]):
        out += [(f"unet.{mod}.lora_A.weight", (r, cin)),
                (f"unet.{mod}.lora_B.weight", (cout, r))]
    return out


# --------------------------------------------------------------------------
# filling
# --------------------------------------------------------------------------

def role(key: str, shape: tuple) -> Tuple[float, float]:
    """(mean, std) of a tensor's entries by its key and shape: every 1-D
    weight here is a norm's scale."""
    if key.endswith("lora_A.weight"):
        return 0.0, 1.0 / math.sqrt(shape[1])
    if key.endswith("lora_B.weight"):
        return 0.0, math.sqrt(0.01 / shape[1])
    if ".embeddings." in key:
        return 0.0, 0.02
    if len(shape) == 1:
        return (1.0, 0.02) if key.endswith(".weight") else (0.0, 0.02)
    return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))


def numel(spec: Spec) -> int:
    return sum(math.prod(s) for _, s in spec)


@torch.no_grad()
def make_state_dict(spec: Spec, seed: int, stream: int, *, device,
                    dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Every tensor of ``spec`` as views of one buffer drawn on ``device``
    in ``dtype`` from the generator of (seed, stream)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    total = numel(spec)
    flat = torch.empty(total, dtype=dtype, device=device)
    for lo in range(0, total, DRAW_CHUNK):
        n = min(DRAW_CHUNK, total - lo)
        flat[lo:lo + n] = torch.randn(n, generator=gen, dtype=dtype,
                                      device=device)
    out, lo = {}, 0
    for key, shape in spec:
        n = math.prod(shape)
        t = flat[lo:lo + n].view(shape)
        mean, std = role(key, shape)
        t.mul_(std)
        if mean:
            t.add_(mean)
        out[key] = t
        lo += n
    return out


def model_state_dicts(cfg: dict, seed: int, device) -> Dict[str, dict]:
    """The four SDXL models of a configuration file, in their served
    types."""
    prec = cfg["precision"]
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    types = {"unet": dt[prec["unet"]], "vae": torch.float32,
             "text_encoder": dt[prec["text_encoders"]],
             "text_encoder_2": dt[prec["text_encoders"]]}
    specs = {"unet": unet_spec(cfg["unet"]), "vae": vae_spec(cfg["vae"]),
             "text_encoder": clip_spec(cfg["text_encoder"]),
             "text_encoder_2": clip_spec(cfg["text_encoder_2"])}
    return {m: make_state_dict(specs[m], seed, STREAMS[m], device=device,
                               dtype=types[m]) for m in specs}


def lora_state_dicts(cfg: dict, seed: int, count: int, device) -> list:
    """``count`` LoRA files (PEFT layout, fp32) of a configuration file."""
    spec = lora_spec(cfg["unet"], cfg["lora"])
    return [make_state_dict(spec, seed, STREAMS["lora"] + i, device=device,
                            dtype=torch.float32) for i in range(count)]
