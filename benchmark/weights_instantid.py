"""InstantID's checkpoint files drawn from a seed, and each request's face
inputs.

The IdentityNet is a diffusers ``ControlNetModel`` (InstantX/InstantID
``ControlNetModel``): the UNet's conv_in, time and text_time embeddings,
down blocks and mid block, a conditioning embedder and one 1x1 "zero
conv" per skip and for the mid block. ``ip-adapter.bin`` holds two
halves: ``image_proj``, the Perceiver resampler of IP-Adapter's
``resampler.py``, and ``ip_adapter``, the ``to_k_ip``/``to_v_ip`` pair of
every attn2, numbered 1, 3, 5, ... in diffusers' ``attn_processors``
order (``attn2_paths``). Both are filled as ``weights.py`` fills SDXL's
models, each from a stream of its own; the resampler's learned latents
are N(0, 1/dim), as upstream initialises them.

A request's faces come from its own seed: per concept a 512-d embedding
N(0, 1) (an ArcFace embedding is not normalised: its norm is about
sqrt(512)) and five keypoints (eyes, nose, mouth corners) placed in the
upper part of the concept's box, drawn into one condition image.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import weights
from benchmark.weights import Spec, _linear, _norm, unet_spec

STREAMS = {"identitynet": 300, "ip_adapter": 301, "faces": 302}
ENCODER = ("conv_in.", "time_embedding.", "add_embedding.", "down_blocks.",
           "mid_block.")
# the five keypoints of a face, in face widths from its centre
KPS_TEMPLATE = np.array([[-0.2, -0.1], [0.2, -0.1], [0.0, 0.05],
                         [-0.15, 0.2], [0.15, 0.2]], np.float32)


def _conv(p: str, cin: int, cout: int, k: int) -> Spec:
    return [(p + ".weight", (cout, cin, k, k)), (p + ".bias", (cout,))]


def skip_channels(cn: dict) -> List[int]:
    """The channels of every skip of the encoder: conv_in's, each resnet's
    (after its attention), each downsampler's."""
    chs, lpb = cn["block_out_channels"], cn["layers_per_block"]
    out = [chs[0]]
    for i, c in enumerate(chs):
        out += [c] * lpb
        if i < len(chs) - 1:
            out.append(c)
    return out


def identitynet_spec(cn: dict) -> Spec:
    """diffusers ``ControlNetModel`` of a published config."""
    enc = [(k, s) for k, s in unet_spec(dict(cn, out_channels=4))
           if k.startswith(ENCODER)]
    emb = list(cn["conditioning_embedding_out_channels"])
    p = "controlnet_cond_embedding."
    out = _conv(p + "conv_in", cn["conditioning_channels"], emb[0], 3)
    for j, (a, b) in enumerate(zip(emb[:-1], emb[1:])):
        out += _conv(f"{p}blocks.{2 * j}", a, a, 3)
        out += _conv(f"{p}blocks.{2 * j + 1}", a, b, 3)
    out += _conv(p + "conv_out", emb[-1], cn["block_out_channels"][0], 3)
    for j, c in enumerate(skip_channels(cn)):
        out += _conv(f"controlnet_down_blocks.{j}", c, c, 1)
    c = cn["block_out_channels"][-1]
    return enc + out + _conv("controlnet_mid_block", c, c, 1)


def attn2_paths(u: dict) -> List[Tuple[str, int]]:
    """(module path, width) of every attn2 of the UNet in diffusers'
    ``attn_processors`` order: ``UNet2DConditionModel`` registers its
    ``up_blocks`` before its ``mid_block``, so the down blocks' come first,
    then the up blocks', then the mid block's."""
    chs, lpb = list(u["block_out_channels"]), u["layers_per_block"]
    depths = weights.attention_depths(u)
    down = [(f"down_blocks.{i}.attentions.{j}.transformer_blocks.{t}.attn2",
             c) for i, c in enumerate(chs) for j in range(lpb)
            for t in range(depths[i])]
    up = [(f"up_blocks.{i}.attentions.{j}.transformer_blocks.{t}.attn2", c)
          for i, (c, d) in enumerate(zip(chs[::-1], depths[::-1]))
          for j in range(lpb + 1) for t in range(d)]
    mid = [(f"mid_block.attentions.0.transformer_blocks.{t}.attn2", chs[-1])
           for t in range(depths[-1])]
    return down + up + mid


def ip_adapter_spec(cfg: dict) -> Spec:
    """``ip-adapter.bin`` flattened: ``image_proj.*`` and
    ``ip_adapter.<2j+1>.to_{k,v}_ip.weight``."""
    r = cfg["resampler"]
    dim, inner = r["dim"], r["dim_head"] * r["heads"]
    p = "image_proj."
    out = [(p + "latents", (1, r["num_queries"], dim))]
    out += _linear(p + "proj_in", r["embedding_dim"], dim)
    out += _linear(p + "proj_out", dim, r["output_dim"])
    out += _norm(p + "norm_out", r["output_dim"])
    for i in range(r["depth"]):
        lp = f"{p}layers.{i}."
        out += _norm(lp + "0.norm1", dim) + _norm(lp + "0.norm2", dim)
        out += _linear(lp + "0.to_q", dim, inner, bias=False)
        out += _linear(lp + "0.to_kv", dim, 2 * inner, bias=False)
        out += _linear(lp + "0.to_out", inner, dim, bias=False)
        out += _norm(lp + "1.0", dim)
        out += _linear(lp + "1.1", dim, dim * r["ff_mult"], bias=False)
        out += _linear(lp + "1.3", dim * r["ff_mult"], dim, bias=False)
    ctx = cfg["unet"]["cross_attention_dim"]
    for j, (_, c) in enumerate(attn2_paths(cfg["unet"])):
        for name in ("to_k_ip", "to_v_ip"):
            out.append((f"ip_adapter.{2 * j + 1}.{name}.weight", (c, ctx)))
    return out


@torch.no_grad()
def state_dicts(cfg: dict, seed: int, device) -> Dict[str, dict]:
    """{"identitynet": flat state dict, "ip_adapter": flat state dict}, in
    the types the configuration serves them in."""
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    prec = cfg["precision"]
    idn = weights.make_state_dict(identitynet_spec(cfg["identitynet"]), seed,
                                  STREAMS["identitynet"], device=device,
                                  dtype=dt[prec["identitynet"]])
    ip = weights.make_state_dict(ip_adapter_spec(cfg), seed,
                                 STREAMS["ip_adapter"], device=device,
                                 dtype=dt[prec["ip_adapter"]])
    lat = ip["image_proj.latents"]
    # role() gives 1/sqrt(queries x dim); upstream draws randn / sqrt(dim)
    lat.mul_(lat.shape[1] ** 0.5)
    return {"identitynet": idn, "ip_adapter": ip}


def nested(ip_sd: dict) -> dict:
    """A flat ``ip-adapter.bin`` as ``torch.load`` returns the file:
    {"image_proj": {...}, "ip_adapter": {...}}."""
    out: dict = {"image_proj": {}, "ip_adapter": {}}
    for k, v in ip_sd.items():
        half, rest = k.split(".", 1)
        out[half][rest] = v
    return out


def faces(mix: dict, req: dict, height: int, width: int) -> tuple:
    """A request's (embeddings [K] of [E] fp32, keypoints [K] of [5, 2] in
    pixels): the embedding N(0, std^2); the face a width drawn from
    ``width`` (a share of its box's width), centred within the middle
    fifth of the box's width and inside the top ``band`` of its height."""
    f = mix["faces"]
    embs, kps = [], []
    for k, (x0, y0, x1, y1) in enumerate(mix["masks"]):
        rng = np.random.default_rng(weights.stream_seed(
            req["seed"], STREAMS["faces"], k))
        embs.append((rng.standard_normal(f["embedding_dim"]) *
                     f["embedding_std"]).astype(np.float32))
        bw, bh = (x1 - x0) * width, (y1 - y0) * height
        fw = rng.uniform(*f["width"]) * bw
        cx = (x0 + x1) / 2 * width + rng.uniform(-0.1, 0.1) * bw
        top = y0 * height + 0.1 * fw
        bottom = y0 * height + f["band"] * bh - 0.2 * fw
        cy = rng.uniform(top, max(top, bottom))
        kps.append((np.array([cx, cy], np.float32)
                    + KPS_TEMPLATE[:f["keypoints"]] * fw).astype(np.float32))
    return embs, kps
